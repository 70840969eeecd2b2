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
  interpret flag, and on a CUDA tensor a kernel launches or raises;
* expose K3's partials kernel (:func:`flash_decode_partials`) for a cache
  split over ranks, whose partials ``flash_decode.combine_partials`` (K3')
  folds across them;
* give :func:`attention`, :func:`matmul`, :func:`grouped_matmul` and
  :func:`wkv6` a gradient.  Where autograd records (grad mode on and an
  operand that requires a gradient) each is a ``torch.autograd.Function``
  whose backward runs kernels too: K2's backward (``flash_attention_bwd``)
  from the log-sum-exp the forward kept, K1's and K4's as products of the
  same kernel that read the forward's operands as they are stored, and K5's backward
  (``rwkv6_bwd.wkv6_bwd``) from the forward's operands, its initial state
  and the final state's gradient.  Otherwise
  (serving runs under ``torch.no_grad``) the forward launches exactly as
  before.  On CPU tensors forward and backward are the plain versions.

Model code calls these through ``repro_torch.models.layers`` (and
``models/rwkv6.py`` for ``wkv6``) with ``cfg.kernels == "cuda"``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as _fa
from . import flash_attention_bwd as _fab
from . import flash_decode as _fd
from . import gemm as _gemm
from . import moe_gmm as _moe
from . import ref as ref
from . import rwkv6 as _rwkv
from . import rwkv6_bwd as _rwkvb


def fit_block(n: int, desired: int, minimum: int = 8) -> int:
    """Largest power-of-two divisor of ``n`` that is <= desired (>= minimum
    when possible)."""
    b = 1
    while b * 2 <= desired and n % (b * 2) == 0:
        b *= 2
    return max(b, min(n, 1)) if b >= 1 else 1


def _records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these operands."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           block: Optional[Tuple[int, int, int]] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Planner-blocked GEMM.  Fits blocks to the shape when not given.
    Differentiable: dA = dC B^T and dB = A^T dC, each a planner-blocked
    :func:`matmul` that hands ``b`` and ``a`` over as ``.t()`` views: the TMA
    body reads them as they are stored, with no transposing copy."""
    if _records(a, b):
        return _Matmul.apply(a, b, block, out_dtype)
    return _matmul(a, b, block, out_dtype)


def _matmul(a, b, block, out_dtype) -> torch.Tensor:
    M, K = a.shape
    _, N = b.shape
    if block is None:
        from repro_torch.core.lower_torch import plan_gemm_blocks
        block = plan_gemm_blocks(M, N, K, a.dtype)
    return _gemm.gemm(a, b, block=gemm_launch_block(M, N, K, a.dtype, block),
                      out_dtype=out_dtype)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, block, out_dtype):
        ctx.save_for_backward(a, b)
        return _matmul(a, b, block, out_dtype)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.to(a.dtype).contiguous()
        da = _matmul(dc, b.t(), None, a.dtype) if ctx.needs_input_grad[0] else None
        db = _matmul(a.t(), dc, None, b.dtype) if ctx.needs_input_grad[1] else None
        return da, db, None, None


def gemm_launch_block(M: int, N: int, K: int, dtype: torch.dtype,
                      block: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The compiled tile a (M, K) @ (K, N) product of ``dtype`` launches at
    for a requested ``block``.  Where the TMA body takes the shape, it is the
    nearest TMA tile: that body masks ragged edges itself, so the row tile is
    not cut to a power-of-two divisor of M (cap 160 keeps BM 128).  The
    staged body keeps the reference's ``fit_block`` rule, snapped to its
    tiles; ``gemm`` moves a tile to the staged body's nearest if the
    operands' addresses or layouts send a TMA-shaped product there."""
    if _gemm.shape_body(dtype, K, N) == "tma":
        return _gemm.nearest_tile(block, "tma")
    return (_gemm.snap_tile(fit_block(M, block[0]), _gemm.TILE_M),
            _gemm.snap_tile(fit_block(N, block[1]), _gemm.TILE_N),
            _gemm.snap_tile(fit_block(K, block[2]), _gemm.TILE_K))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: Optional[float] = None, causal: bool = False,
              block_q: Optional[int] = None, block_kv: Optional[int] = None,
              q_per_kv: int = 1, q_offset: int = 0, return_lse: bool = False):
    """FlashAttention fwd.  q: (BH, Sq, d); k/v: (BH, Skv, d), or with
    ``q_per_kv`` > 1 the un-repeated (BH / q_per_kv, Skv, d) or a strided
    (batch, kv_heads, Skv, d) view; ``q_offset``: the causal position of
    query row 0.  Differentiable: where autograd records, the forward also
    keeps its log-sum-exp and the backward is K2-bwd (with the same
    offset).  With ``return_lse`` (not differentiable) also each row's
    float32 log-sum-exp, (BH, Sq): what a fold of key blocks held by other
    ranks weighs this block's output by."""
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
    if _records(q, k, v):
        if return_lse:
            raise ValueError("attention(..., return_lse=True) is not differentiable")
        return _Attention.apply(q, k, v, scale, causal, bq, bkv, q_per_kv, q_offset)
    return _fa.flash_attention(q, k, v, sm_scale=scale, causal=causal, block_q=bq,
                               block_kv=bkv, q_per_kv=q_per_kv, q_offset=q_offset,
                               return_lse=return_lse)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, bq, bkv, q_per_kv, q_offset):
        out, lse = _fa.flash_attention(q, k, v, sm_scale=scale, causal=causal, block_q=bq,
                                       block_kv=bkv, q_per_kv=q_per_kv, return_lse=True,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, q_per_kv, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, q_per_kv, q_offset = ctx.args
        dq, dk, dv = _fab.flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                              sm_scale=scale, causal=causal,
                                              q_per_kv=q_per_kv, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None, None


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


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          sm_scale: Optional[float] = None, kv_splits: Optional[int] = None,
                          kv_valid_len: Optional[int] = None, q_per_kv: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's partials kernel with :func:`flash_decode`'s arguments: the
    float32 (m, l, acc) of each split of the first ``kv_valid_len`` keys,
    shaped (BH, splits, 1, 1), (BH, splits, 1, 1), (BH, splits, 1, d), for
    ``flash_decode.combine_partials`` to fold, possibly with other ranks' partials
    of other keys.  A split with no valid key (``kv_valid_len`` 0 makes
    every split such) gives (-1e30, 0, 0), which the combine ignores.  The
    split count comes from the valid length when ``kv_splits`` is not given.
    Partials that other ranks' partials join must come in one shape on
    every rank: pass ``kv_splits``."""
    BH, _, d = q.shape
    Skv = k.shape[-2]
    valid = Skv if kv_valid_len is None else int(kv_valid_len)
    if kv_splits is None:
        kv_splits = _fd.choose_splits(valid, max(1, BH // q_per_kv),
                                       _fd.sm_count(q.device))
    scale = sm_scale if sm_scale is not None else d ** -0.5
    return _fd.flash_decode_partials(q, k, v, kv_splits=kv_splits, sm_scale=scale,
                                     kv_valid_len=kv_valid_len, q_per_kv=q_per_kv)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   block: Optional[Tuple[int, int, int]] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-expert GEMM.  x: (E, cap, d_in), w: (E, d_in, d_out).  Blocks are
    planned for one expert's (cap, d_out, d_in) product, as the reference
    does, and moved to a compiled tile by :func:`gemm_launch_block`.
    Differentiable: dX_e = dY_e W_e^T and dW_e = X_e^T dY_e, each a
    :func:`grouped_matmul` that accumulates in float32 and rounds once to
    its operand's dtype.  It hands ``w`` and ``x`` over as transposed views:
    the TMA body reads them as they are stored, with no transposing copy."""
    if _records(x, w):
        return _GroupedMatmul.apply(x, w, block, out_dtype)
    return _grouped_matmul(x, w, block, out_dtype)


def _grouped_matmul(x, w, block, out_dtype) -> torch.Tensor:
    _, cap, d_in = x.shape
    d_out = w.shape[-1]
    if block is None:
        from repro_torch.core.lower_torch import plan_gemm_blocks
        block = plan_gemm_blocks(cap, d_out, d_in, x.dtype)
    block = gemm_launch_block(cap, d_out, d_in, x.dtype, block)
    return _moe.grouped_matmul(x, w, block=block, out_dtype=out_dtype)


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, block, out_dtype):
        ctx.save_for_backward(x, w)
        return _grouped_matmul(x, w, block, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped_matmul(dy, w.transpose(1, 2), None, x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _grouped_matmul(x.transpose(1, 2), dy, None, w.dtype)
        return dx, dw, None, None


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
         u: torch.Tensor, *, chunk: int = _rwkv.DEFAULT_CHUNK,
         state0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 WKV scan.  r/k/v/log_w: (BH, T, d); u: (BH, d); state0: the
    float32 initial state (BH, d, d), None for zero -> (o, final state (BH,
    d, d) float32).

    The chunk is the largest power of two that divides T and is at most
    ``chunk``, as in the reference, and at most the kernel's longest chunk;
    nothing pads, so a prompt of odd length runs at chunk 1.
    Differentiable in r, k, v, log_w, u and state0, through o and the final
    state: where autograd records, the backward is K5-bwd at the same chunk
    (from the final state's gradient where the caller reads the state, and
    giving the initial state's where one was passed)."""
    c = fit_block(r.shape[1], min(chunk, _rwkv.MAX_CHUNK))
    if _records(r, k, v, log_w, u, *(() if state0 is None else (state0,))):
        return _Wkv6.apply(r, k, v, log_w, u, state0, c)
    return _rwkv.wkv6(r, k, v, log_w, u, chunk=c, **_given(state0=state0))


def _given(**kw):
    """The keyword arguments that are not None (a call without a state keeps
    the zero-state signature)."""
    return {k: x for k, x in kw.items() if x is not None}


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, log_w, u, state0, chunk):
        # an output no one reads gets no gradient (None), not a tensor of zeros:
        # the backward then passes K5-bwd no final-state gradient at all
        ctx.set_materialize_grads(False)
        o, state = _rwkv.wkv6(r, k, v, log_w, u, chunk=chunk, **_given(state0=state0))
        ctx.save_for_backward(r, k, v, log_w, u, state0)
        ctx.chunk = chunk
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, log_w, u, state0 = ctx.saved_tensors
        do = torch.zeros_like(r) if do is None else do.to(r.dtype).contiguous()
        grads = _rwkvb.wkv6_bwd(r, k, v, log_w, u, do, chunk=ctx.chunk,
                                **_given(state0=state0, dstate=dstate))
        return (*grads[:5], grads[5] if state0 is not None else None, None)
