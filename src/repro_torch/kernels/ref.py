"""Plain PyTorch oracles for the ported kernels (the allclose references).

Float32 accumulation, the reference package's signatures.  ``wkv6_ref``
arrives with its kernel.
"""
from __future__ import annotations

from typing import Optional

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: Optional[float] = None,
                  causal: bool = False) -> torch.Tensor:
    """Dense softmax attention.  q: (BH, Sq, d), k/v: (BH, Skv, d)."""
    d = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * sm_scale
    if causal:
        Sq, Skv = s.shape[-2], s.shape[-1]
        qi = torch.arange(Sq, device=s.device)[:, None]
        ki = torch.arange(Skv, device=s.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, float("-inf")))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q: (BH, 1, d)."""
    return attention_ref(q, k, v, sm_scale=sm_scale, causal=False)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-expert GEMM.  x: (E, cap, d_in), w: (E, d_in, d_out)."""
    out_dtype = out_dtype or x.dtype
    return torch.einsum("eci,eio->eco", x.float(), w.float()).to(out_dtype)
