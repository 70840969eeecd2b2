"""Grouped (per-expert) GEMM for MoE layers: wrapper, launch counter and plain
version.

Counterpart of ``repro/kernels/moe_gmm.py``.  Capacity-based routing packs
each expert's tokens into a dense (E, cap, d_in) buffer, and the expert FFN
is one GEMM per expert.  The CUDA kernel (``csrc/grouped_gemm.cuh``) is the
GEMM kernel's tile loop with the expert as ``blockIdx.z``; it takes the same
compiled tile shapes (:data:`repro_torch.kernels.gemm.COMPILED_TILES`).  A
tensor on the CPU goes to :func:`grouped_matmul_plain`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .gemm import COMPILED_TILES, DEFAULT_BLOCK

launches = 0                        # kernel launches made by grouped_matmul()


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                         block: Optional[Tuple[int, int, int]] = None,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x[e] @ w[e]`` for every expert in plain PyTorch with float32
    accumulation; ``block`` is accepted for the kernel's signature and
    changes nothing."""
    out_dtype = out_dtype or x.dtype
    return torch.einsum("eci,eio->eco", x.float(), w.float()).to(out_dtype)


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul wants (E, cap, d_in) @ (E, d_in, d_out), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped_matmul takes float32 or bfloat16 operands of one type, "
                        f"got {x.dtype} and {w.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped_matmul writes float32 or bfloat16, not {out_dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on different devices: {x.device}, {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul takes contiguous row-major operands")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   block: Tuple[int, int, int] = DEFAULT_BLOCK,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (E, cap, d_in), w: (E, d_in, d_out) -> (E, cap, d_out).

    ``block`` = (rows of cap, columns of d_out, depth of d_in) must be one of
    the compiled tiles on a CUDA tensor; shapes it does not divide are
    masked inside the kernel."""
    global launches
    out_dtype = out_dtype or x.dtype
    _check(x, w, out_dtype)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, block=block, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda tensors, not {x.device}")
    bm, bn, bk = (int(b) for b in block)
    if (bm, bn, bk) not in COMPILED_TILES:
        raise ValueError(f"tile {(bm, bn, bk)} is not compiled; choose from "
                         f"{COMPILED_TILES}")
    E, cap, d_in = x.shape
    d_out = w.shape[2]
    out = torch.empty((E, cap, d_out), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = 16 // x.element_size()
    vec_ok = int(d_in % vec == 0 and d_out % vec == 0 and x.data_ptr() % 16 == 0
                 and w.data_ptr() % 16 == 0)
    fn = (_build.lib().repro_grouped_gemm_bf16 if x.dtype == torch.bfloat16
          else _build.lib().repro_grouped_gemm_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, cap, d_out, d_in,
                  int(out_dtype == torch.bfloat16), bm, bn, bk, vec_ok, stream)
    _build.check(code, f"grouped_matmul E={E} cap={cap} {d_in}->{d_out} tile "
                       f"{(bm, bn, bk)}")
    launches += 1
    return out
