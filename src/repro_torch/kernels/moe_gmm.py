"""Grouped (per-expert) GEMM for MoE layers: wrapper, launch counter and plain
version.

Counterpart of ``repro/kernels/moe_gmm.py``.  Capacity-based routing packs
each expert's tokens into a dense (E, cap, d_in) buffer, and the expert FFN
is one GEMM per expert.  The CUDA kernels are the GEMM's two bodies with the
expert as ``blockIdx.z``: the TMA + ``wgmma`` core for bf16
(``csrc/gemm_sm90.cuh``: 3-D tensor maps so each expert's zero-fill stops
at its own capacity, the row tiles of one weight slice adjacent in launch
order) and the staged body (``csrc/grouped_gemm.cuh``) for float32 and
unaligned bf16; the body is chosen as
:func:`repro_torch.kernels.gemm.gemm_body` chooses it, and the tiles are the
GEMM's (:data:`repro_torch.kernels.gemm.COMPILED_TILES`).  A
tensor on the CPU goes to :func:`grouped_matmul_plain`; a CUDA tensor
launches a kernel or raises.

Either operand may also come as the transpose of a contiguous tensor
(``t.transpose(1, 2)``), as the backward hands them over: dX = dY W^T takes
``w.transpose(1, 2)`` and dW = X^T dY takes ``x.transpose(1, 2)``.  The TMA
body reads such an operand as it is stored (:func:`operand_layouts`); the
staged body copies it to row-major first.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from . import work as _work
from .gemm import BODIES, COMPILED_TILES, DEFAULT_BLOCK, gemm_body, nearest_tile, \
    stored_transposed

launches = 0                        # kernel launches made by grouped_matmul()
launches_by_body = {b: 0 for b in BODIES}


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                         block: Optional[Tuple[int, int, int]] = None,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x[e] @ w[e]`` for every expert in plain PyTorch with float32
    accumulation; ``block`` is accepted for the kernel's signature and
    changes nothing."""
    out_dtype = out_dtype or x.dtype
    return torch.einsum("eci,eio->eco", x.float(), w.float()).to(out_dtype)


def operand_layouts(x: torch.Tensor, w: torch.Tensor) -> Tuple[bool, bool]:
    """(a_t, b_t): whether ``x`` is stored (E, d_in, cap) and ``w`` (E, d_out,
    d_in), each the transpose of a contiguous tensor, rather than row-major."""
    return stored_transposed(x, "grouped_matmul"), stored_transposed(w, "grouped_matmul")


def grouped_body(x: torch.Tensor, w: torch.Tensor) -> str:
    """The body that computes ``x @ w`` from these operands as they lie:
    ``"tma"`` for bf16 whose rows as stored are whole 16-byte pieces (d_in
    and d_out multiples of 8, and cap too when ``x`` is stored transposed)
    at 16-byte-aligned bases, else ``"staged"``.  At most one operand may be
    stored transposed on the TMA body: K1's rule (``gemm.gemm_body``) for one
    expert's (cap, d_in) @ (d_in, d_out) product."""
    a_t, b_t = operand_layouts(x, w)
    return gemm_body(x.dtype, x.shape[2], w.shape[2], x.data_ptr(), w.data_ptr(),
                     M=x.shape[1], a_t=a_t, b_t=b_t)


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
    operand_layouts(x, w)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   block: Tuple[int, int, int] = DEFAULT_BLOCK,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (E, cap, d_in), w: (E, d_in, d_out) -> (E, cap, d_out).

    ``block`` = (rows of cap, columns of d_out, depth of d_in) must be one of
    the compiled tiles; the body comes from :func:`grouped_body` and runs at
    its tile nearest ``block``.  Shapes the tile does not divide are masked
    inside the kernel."""
    out_dtype = out_dtype or x.dtype
    _check(x, w, out_dtype)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, block=block, out_dtype=out_dtype)
    return grouped_matmul_on_body(x, w, grouped_body(x, w), block=block, out_dtype=out_dtype)


def grouped_matmul_on_body(x: torch.Tensor, w: torch.Tensor, body: str, *,
                           block: Tuple[int, int, int] = DEFAULT_BLOCK,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`grouped_matmul` on the body named, at its tile nearest
    ``block``: the way to time the two bodies on one product.  The TMA body
    refuses operands :func:`grouped_body` would not give it; the staged body
    copies a transposed operand to row-major first."""
    global launches
    out_dtype = out_dtype or x.dtype
    _check(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs its kernels on cuda tensors, not {x.device}")
    if tuple(int(b) for b in block) not in COMPILED_TILES:
        raise ValueError(f"tile {tuple(block)} is not compiled; choose from "
                         f"{COMPILED_TILES}")
    E, cap, d_in = x.shape
    d_out = w.shape[2]
    if body == "tma" and grouped_body(x, w) != "tma":
        raise ValueError(f"the TMA body takes bf16 with d_in, d_out (and cap for a "
                         f"transposed x) multiples of 8, at most one transposed operand and "
                         f"16-byte aligned bases; got {x.dtype} cap={cap} {d_in}->{d_out}")
    bm, bn, bk = nearest_tile(block, body)
    out = torch.empty((E, cap, d_out), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    out_bf16 = int(out_dtype == torch.bfloat16)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body == "tma":
            a_t, b_t = operand_layouts(x, w)
            code = lib.repro_grouped_gemm_tma_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                                   E, cap, d_out, d_in, out_bf16, bm, bn,
                                                   int(a_t), int(b_t), stream)
        else:
            x, w = x.contiguous(), w.contiguous()
            vec = 16 // x.element_size()
            vec_ok = int(d_in % vec == 0 and d_out % vec == 0 and x.data_ptr() % 16 == 0
                         and w.data_ptr() % 16 == 0)
            fn = (lib.repro_grouped_gemm_bf16 if x.dtype == torch.bfloat16
                  else lib.repro_grouped_gemm_f32)
            code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, cap, d_out, d_in,
                      out_bf16, bm, bn, bk, vec_ok, stream)
    _build.check(code, f"grouped_matmul E={E} cap={cap} {d_in}->{d_out} {body} tile "
                       f"{(bm, bn, bk)}")
    launches += 1
    launches_by_body[body] += 1
    _work.add("grouped_matmul", _work.gemm_flops(cap, d_out, d_in, E), _work.nbytes(x, w, out))
    return out
