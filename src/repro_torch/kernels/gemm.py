"""Planner-blocked GEMM: wrapper, launch counter and plain version.

Counterpart of ``repro/kernels/gemm.py``.  The CUDA kernel
(``csrc/gemm.cuh``) runs the K loop inside one thread block per (bm, bn)
output tile; its tile shapes are compiled in, and the planner
(``core/lower_torch.py``) chooses among exactly :data:`COMPILED_TILES`.  A
tensor on the CPU goes to :func:`gemm_plain`; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build

TILE_M = (64, 128)
TILE_N = (64, 128)
TILE_K = (16, 32)
COMPILED_TILES = tuple((bm, bn, bk) for bm in TILE_M for bn in TILE_N for bk in TILE_K)
DEFAULT_BLOCK = (128, 128, 32)
MAX_STATIC_SMEM = 48 * 1024         # the kernel's shared memory is static
_THREADS = 256

launches = 0                        # kernel launches made by gemm()


def gemm_smem_bytes(bm: int, bn: int, bk: int, elem_size: int) -> int:
    """Shared memory one block of the kernel takes (mirrors
    ``gemm_smem_bytes`` in ``csrc/gemm.cuh``): the padded A and B tiles (two
    stages of them for bf16, which double-buffers with ``cp.async``), and for
    bf16 one 16 x 16 float staging tile per warp for the epilogue."""
    pad = 16 // elem_size
    ab = (bm * (bk + pad) + bk * (bn + pad)) * elem_size
    if elem_size == 2:
        return 2 * ab + (_THREADS // 32) * 256 * 4
    return ab


def snap_tile(b: int, options: Sequence[int]) -> int:
    """The largest compiled size that does not exceed ``b`` (the smallest
    one when ``b`` is below all of them; the kernel masks the edge)."""
    fits = [o for o in options if o <= b]
    return max(fits) if fits else min(options)


def gemm_plain(a: torch.Tensor, b: torch.Tensor, *,
               block: Optional[Tuple[int, int, int]] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` in plain PyTorch with float32 accumulation; ``block`` is
    accepted for the kernel's signature and changes nothing."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm wants (M, K) @ (K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm takes float32 or bfloat16 operands of one type, got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm writes float32 or bfloat16, not {out_dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm takes contiguous row-major operands")


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         block: Tuple[int, int, int] = DEFAULT_BLOCK,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` with an explicit tile shape.  a: (M, K), b: (K, N) -> (M, N).

    ``block`` must be one of :data:`COMPILED_TILES` on a CUDA tensor; shapes
    that the tile does not divide are masked inside the kernel."""
    global launches
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.device.type == "cpu":
        return gemm_plain(a, b, block=block, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on cpu or cuda tensors, not {a.device}")
    bm, bn, bk = (int(x) for x in block)
    if (bm, bn, bk) not in COMPILED_TILES:
        raise ValueError(f"tile {(bm, bn, bk)} is not compiled; choose from "
                         f"{COMPILED_TILES}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    vec = 16 // a.element_size()
    vec_ok = int(K % vec == 0 and N % vec == 0 and a.data_ptr() % 16 == 0
                 and b.data_ptr() % 16 == 0)
    fn = (_build.lib().repro_gemm_bf16 if a.dtype == torch.bfloat16
          else _build.lib().repro_gemm_f32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                  int(out_dtype == torch.bfloat16), bm, bn, bk, vec_ok, stream)
    _build.check(code, f"gemm {M}x{N}x{K} tile {(bm, bn, bk)}")
    launches += 1
    return out
