"""Public wrappers around the Hopper kernels.

Responsibilities:
* fit shapes to legal block sizes (largest power-of-two divisor, as the
  reference does) and snap them to the tile shapes the kernels are
  compiled for; the TMA GEMM body masks ragged edges itself and takes the
  planner's tile as it is (:func:`gemm_launch_block`);
* pick block shapes via the TileLoom planner when not given
  (``core/lower_torch.py`` sizes them against the H100 description);
* send a tensor that lies on the CPU to the kernel's plain PyTorch version
  and a CUDA tensor to the kernel.  Nothing else decides: there is no
  interpret flag, and on a CUDA tensor a kernel launches or raises.

Model code calls these through ``repro_torch.models.layers`` (and
``models/rwkv6.py`` for ``wkv6``) with ``cfg.kernels == "cuda"``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as _fa
from . import flash_decode as _fd
from . import gemm as _gemm
from . import moe_gmm as _moe
from . import ref as ref
from . import rwkv6 as _rwkv


def fit_block(n: int, desired: int, minimum: int = 8) -> int:
    """Largest power-of-two divisor of ``n`` that is <= desired (>= minimum
    when possible)."""
    b = 1
    while b * 2 <= desired and n % (b * 2) == 0:
        b *= 2
    return max(b, min(n, 1)) if b >= 1 else 1


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           block: Optional[Tuple[int, int, int]] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Planner-blocked GEMM.  Fits blocks to the shape when not given."""
    M, K = a.shape
    _, N = b.shape
    if block is None:
        from repro_torch.core.lower_torch import plan_gemm_blocks
        block = plan_gemm_blocks(M, N, K, a.dtype)
    return _gemm.gemm(a, b, block=gemm_launch_block(M, N, K, a.dtype, block),
                      out_dtype=out_dtype)


def gemm_launch_block(M: int, N: int, K: int, dtype: torch.dtype,
                      block: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The compiled tile a (M, K) @ (K, N) product of ``dtype`` launches at
    for a requested ``block``.  Where the TMA body takes the shape, it is the
    nearest TMA tile: that body masks ragged edges itself, so the row tile is
    not cut to a power-of-two divisor of M (cap 160 keeps BM 128).  The
    staged body keeps the reference's ``fit_block`` rule, snapped to its
    tiles; ``gemm`` moves a tile to the staged body's nearest if the
    operands' addresses send a TMA-shaped product there."""
    if _gemm.shape_body(dtype, K, N) == "tma":
        return _gemm.nearest_tile(block, "tma")
    return (_gemm.snap_tile(fit_block(M, block[0]), _gemm.TILE_M),
            _gemm.snap_tile(fit_block(N, block[1]), _gemm.TILE_N),
            _gemm.snap_tile(fit_block(K, block[2]), _gemm.TILE_K))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: Optional[float] = None, causal: bool = False,
              block_q: Optional[int] = None, block_kv: Optional[int] = None,
              q_per_kv: int = 1) -> torch.Tensor:
    """FlashAttention fwd.  q: (BH, Sq, d); k/v: (BH, Skv, d), or with
    ``q_per_kv`` > 1 the un-repeated (BH / q_per_kv, Skv, d) or a strided
    (batch, kv_heads, Skv, d) view."""
    BH, Sq, d = q.shape
    Skv = k.shape[-2]
    if block_q is None or block_kv is None:
        from repro_torch.core.lower_torch import plan_flash_blocks
        pq, pkv = plan_flash_blocks(Sq, Skv, d, q.dtype)
        block_q = block_q or pq
        block_kv = block_kv or pkv
    bq = _gemm.snap_tile(fit_block(Sq, block_q), _fa.TILE_Q)
    bkv = _gemm.snap_tile(fit_block(Skv, block_kv), _fa.TILE_KV)
    legal = _fa.legal_tiles(d, q.element_size())
    if legal and (bq, bkv) not in legal:
        # the requested tile does not fit a block's shared memory for this
        # head dimension and type: take the largest legal one below it
        under = [t for t in legal if t[0] <= bq and t[1] <= bkv]
        bq, bkv = max(under or legal, key=lambda t: (t[0] * t[1], t[0]))
    scale = sm_scale if sm_scale is not None else d ** -0.5
    return _fa.flash_attention(q, k, v, sm_scale=scale, causal=causal, block_q=bq,
                               block_kv=bkv, q_per_kv=q_per_kv)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 sm_scale: Optional[float] = None, kv_splits: Optional[int] = None,
                 kv_valid_len: Optional[int] = None,
                 q_per_kv: int = 1) -> torch.Tensor:
    """Decode attention: q: (BH, 1, d) vs. k/v: (BH, Skv, d) (or un-repeated /
    strided as in :func:`attention`), of which the first ``kv_valid_len`` keys
    count (``None``: all).  One launch computes the splits and their
    combine; the split count comes from the valid length when ``kv_splits``
    is not given, at most the cluster's 8.  The reference's ``block_kv`` has
    no counterpart: the kernel's inner tile is fixed."""
    BH, _, d = q.shape
    Skv = k.shape[-2]
    valid = Skv if kv_valid_len is None else int(kv_valid_len)
    if kv_splits is None:
        kv_splits = _fd.choose_splits(valid, max(1, BH // q_per_kv),
                                       _fd.sm_count(q.device), _fd.MAX_CLUSTER_SPLITS)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    return _fd.flash_decode(q, k, v, kv_splits=kv_splits, sm_scale=scale,
                            kv_valid_len=kv_valid_len, q_per_kv=q_per_kv)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   block: Optional[Tuple[int, int, int]] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-expert GEMM.  x: (E, cap, d_in), w: (E, d_in, d_out).  Blocks are
    planned for one expert's (cap, d_out, d_in) product, as the reference
    does, and moved to a compiled tile by :func:`gemm_launch_block`."""
    _, cap, d_in = x.shape
    d_out = w.shape[-1]
    if block is None:
        from repro_torch.core.lower_torch import plan_gemm_blocks
        block = plan_gemm_blocks(cap, d_out, d_in, x.dtype)
    block = gemm_launch_block(cap, d_out, d_in, x.dtype, block)
    return _moe.grouped_matmul(x, w, block=block, out_dtype=out_dtype)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
         u: torch.Tensor, *, chunk: int = _rwkv.DEFAULT_CHUNK
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 WKV scan.  r/k/v/log_w: (BH, T, d); u: (BH, d) -> (o, final
    state (BH, d, d) float32).

    The chunk is the largest power of two that divides T and is at most
    ``chunk``, as in the reference, and at most the kernel's longest chunk;
    nothing pads, so a prompt of odd length runs at chunk 1."""
    c = fit_block(r.shape[1], min(chunk, _rwkv.MAX_CHUNK))
    return _rwkv.wkv6(r, k, v, log_w, u, chunk=c)
