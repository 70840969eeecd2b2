"""Plain PyTorch oracles for the ported kernels (the allclose references).

Float32 accumulation, the reference package's signatures.
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


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """Token-level RWKV6 recurrence (the chunked kernel's oracle).

    o_t = r_t . (S_{t-1} + u (.) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    r/k/v/log_w: (BH, T, d); u: (BH, d).
    """
    BH, T, d = r.shape
    w = torch.exp(torch.clamp(log_w.float(), -1e9, 0.0))
    rf, kf, vf, uf = r.float(), k.float(), v.float(), u.float()
    S = torch.zeros((BH, d, d), dtype=torch.float32, device=r.device)
    out = []
    for t in range(T):
        kv = kf[:, t, :, None] * vf[:, t, None, :]                 # (BH, d, d)
        out.append(torch.einsum("bi,bij->bj", rf[:, t], S + uf[:, :, None] * kv))
        S = w[:, t, :, None] * S + kv
    o = torch.stack(out, dim=1) if out else torch.zeros_like(rf)
    return o.to(r.dtype)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-expert GEMM.  x: (E, cap, d_in), w: (E, d_in, d_out)."""
    out_dtype = out_dtype or x.dtype
    return torch.einsum("eci,eio->eco", x.float(), w.float()).to(out_dtype)
