"""Shared model building blocks (plain functions on tensors).

Every block takes ``(params, x, cfg, ...)``.  Attention has two kernel
paths: ``cfg.kernels == "cuda"`` sends it through the hand-written kernels
of ``repro_torch.kernels`` (FlashAttention for a prompt, flash-decode with a
valid length for a cached step; on CPU tensors those wrappers run their
plain versions), anything else takes the dense plain path below.
Projections, the MLP and the LM head are ``torch.einsum``, as the reference
leaves them to XLA.  Training adds the losses (:func:`softmax_xent`,
:func:`fused_head_xent`) and :func:`remat`, the port's ``jax.checkpoint``
with ``nothing_saveable`` around a block.  Weights are cast to the activation dtype at every use,
as in the reference; a caller that holds its weights in the compute dtype
already (``launch.serve.load_params`` draws them in it) pays nothing for
it.

Under a plan-sharded step with a local axis (``parallel/spmd.py``), a
weight whose heads, ffn columns or vocabulary the step left split
(``spmd.local_of``) is computed in parts, megatron style: attention over
this rank's query heads and the kv heads they read, the MLP over its ffn
columns, each entered through ``spmd.enter`` and summed by ``spmd.psum``
after the row-parallel product; the embedding as a masked lookup into the
local rows of the table; the LM head's logits over the local vocabulary,
which :func:`softmax_xent` and :func:`fused_head_xent` reduce over the
axis and :func:`whole_vocab` gathers for serving.

Cross-attention takes the same head-local rule (:func:`_cross_local`).

Under a plan-sharded step with a sequence axis (``spmd.Step.seq_axis``:
``tp2d``, ``zero3_sp``, ``sequence_parallel``) the activations hold the
rank's block of the tokens, ``[o, o + S)``.  Self-attention applies RoPE
at those positions, gathers K and V over the axis (the first ``o + S``
keys: ``spmd.gather_seq``) and runs K2 with the query offset ``o``
(context parallelism); a prompt pass writes the rank's block of the
serving cache.  Under ``tp2d`` the ``embed`` dim of the activations and of
every weight is the rank's block too (``spmd.embed_of``): a product over
``embed`` is summed over that axis (``spmd.psum``), a product into
``embed`` takes its input through ``spmd.enter``, and the RMS norm sums its
squares over the axis.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import fit_block
from repro_torch.parallel import spmd
from .param import LeafSpec

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# ------------------------------------------------------------------ norms
def rmsnorm_spec(d: int) -> Params:
    return {"scale": LeafSpec((d,), ("embed",), init="ones")}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last dim; over the ranks' blocks of it where the
    step split ``embed`` (the squares summed over the axis)."""
    dt = x.dtype
    x32 = x.float()
    axis = spmd.embed_of(p["scale"])
    if axis is None:
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    else:
        n = x.shape[-1] * spmd.current().mesh.shape[axis]
        # each rank's block of the normalised row is its own: the sum's
        # gradient is summed over the axis too
        sq = spmd.enter(torch.sum(torch.square(x32), dim=-1, keepdim=True), axis)
        var = spmd.psum(sq, axis) / n
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(dt)


# ------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    angles = positions.float()[..., None] * freq          # (..., S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D) with D even; cos/sin: (S, D/2).  Split-half layout."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention
def attention_spec(cfg: ModelConfig, cross: bool = False) -> Params:
    d, hd = cfg.d_model, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    spec: Params = {
        "wq": LeafSpec((d, nh, hd), ("embed", "q_heads", "head_dim")),
        "wk": LeafSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": LeafSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": LeafSpec((nh, hd, d), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = LeafSpec((nh, hd), ("q_heads", "head_dim"), init="zeros")
        spec["bk"] = LeafSpec((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = LeafSpec((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _proj_in(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` contracting ``embed``: summed over the ranks'
    blocks where the step split it."""
    y = torch.einsum(eq, x, w.to(x.dtype))
    axis = spmd.embed_of(w)
    return y if axis is None else _sum_partials(y, axis)


def _sum_partials(y: torch.Tensor, axis: str) -> torch.Tensor:
    """The partial product ``y``, a temporary no one else holds, summed over
    the ranks along ``axis``: in place where autograd does not record (a
    prompt pass keeps no copy of a product as large as the logits)."""
    if torch.is_grad_enabled() and y.requires_grad:
        return spmd.psum(y, axis)
    return spmd.all_reduce(y, spmd.current().mesh.group((axis,)), (axis,), inplace=True)


def _proj_out(eq: str, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, h, w)`` into ``embed``: the rank's block of it where the
    step split it (``h``, whole on every rank, gets the blocks' gradients
    summed)."""
    axis = spmd.embed_of(w)
    if axis is not None:
        h = spmd.enter(h, axis)
    return torch.einsum(eq, h, w.to(h.dtype))


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 kv_input: Optional[torch.Tensor] = None):
    kv_x = x if kv_input is None else kv_input
    q = _proj_in("bsd,dhk->bshk", x, p["wq"])
    k = _proj_in("bsd,dhk->bshk", kv_x, p["wk"])
    v = _proj_in("bsd,dhk->bshk", kv_x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _repeat_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    if q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, q_per_kv, dim=2)


def _sdpa_plain_dense(q, k, v, causal: bool, sm_scale: float,
                      kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,T,H,D) -> (B,S,H,D)."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * sm_scale
    S, T = s.shape[-2], s.shape[-1]
    neg = torch.full_like(s, float("-inf"))
    if causal:
        qi = torch.arange(S, device=s.device)[:, None] + (T - S)   # align ends
        ki = torch.arange(T, device=s.device)[None, :]
        s = torch.where(qi >= ki, s, neg)
    if kv_valid_len is not None:
        ki = torch.arange(T, device=s.device)
        s = torch.where((ki < kv_valid_len)[None, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    return out.to(q.dtype)


CHUNKED_ATTN_THRESHOLD = 8192     # dense S x T scores above this use chunking


def _sdpa_plain_chunked(q, k, v, causal: bool, sm_scale: float,
                        kv_block: int = 1024) -> torch.Tensor:
    """The reference's ``_sdpa_xla_chunked``: online-softmax attention in
    plain PyTorch, a loop over KV blocks, so the scores held at once are
    (B, S, kv_block, H) instead of (B, H, S, T).  q: (B,S,H,D), k/v:
    (B,T,H,D) -> (B,S,H,D).  The queries are not blocked, as in the
    reference; a T without a power-of-two block of at least 8 goes dense."""
    B, S, H, D = q.shape
    T = k.shape[1]
    kb = fit_block(T, min(kv_block, T))
    if kb < 8:
        return _sdpa_plain_dense(q, k, v, causal, sm_scale)
    qf = q.float()
    m = torch.full((B, S, H), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)     # align ends
    for t0 in range(0, T, kb):
        s = torch.einsum("bqhd,bthd->bqth", qf, k[:, t0:t0 + kb].float()) * sm_scale
        if causal:
            kpos = t0 + torch.arange(kb, device=q.device)[None, :]
            s = torch.where((qpos >= kpos)[None, :, :, None], s,
                            torch.full((), -1e30, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=2))
        p = torch.exp(s - m_new[:, :, None, :])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=2)
        acc = acc * alpha[..., None] + torch.einsum("bqth,bthd->bqhd", p,
                                                    v[:, t0:t0 + kb].float())
        m = m_new
    l = torch.where(l == 0.0, torch.ones((), device=q.device), l)
    return (acc / l[..., None]).to(q.dtype)


def _sdpa_plain(q, k, v, causal: bool, sm_scale: float,
                kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """The reference's ``_sdpa_xla`` dispatch: dense scores, or the chunked
    form for a multi-token pass over all keys whose S x T exceeds
    :data:`CHUNKED_ATTN_THRESHOLD` squared, with the reference's adaptive
    kv block (the (B, S, kv_block, H) float32 scores kept under 64 GB)."""
    B, S, H = q.shape[:3]
    T = k.shape[1]
    if S > 1 and kv_valid_len is None and S * T > CHUNKED_ATTN_THRESHOLD ** 2:
        row = B * S * H * 4
        kb = 1024
        while kb > 8 and row * kb > 64e9:
            kb //= 2
        return _sdpa_plain_chunked(q, k, v, causal, sm_scale, kv_block=kb)
    return _sdpa_plain_dense(q, k, v, causal, sm_scale, kv_valid_len=kv_valid_len)


def _sdpa_kernel(q, k, v, causal: bool, sm_scale: float, q_per_kv: int,
                 kv_valid_len: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """Attention through the kernels of ``repro_torch.kernels.ops``.

    q: (B,S,H,D); k/v: (B,T,Hkv,D), *not* repeated: the kernels map query
    head h to kv head h // q_per_kv themselves and read k/v through a
    strided (B,Hkv,T,D) view, so a serving cache is neither repeated nor
    transposed.  S == 1 goes to flash-decode over the first ``kv_valid_len``
    keys, anything else to the FlashAttention kernel over all T keys, its
    causal mask placing query row 0 at ``q_offset``.
    """
    from repro_torch.kernels import ops
    B, S, H, D = q.shape
    # with one sequence the reshape is a view of the permuted q: the kernels
    # take q contiguous
    qf = q.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()
    kf = k.permute(0, 2, 1, 3)
    vf = v.permute(0, 2, 1, 3)
    if S == 1:
        out = ops.flash_decode(qf, kf, vf, sm_scale=sm_scale,
                               kv_valid_len=kv_valid_len, q_per_kv=q_per_kv)
    else:
        out = ops.attention(qf, kf, vf, sm_scale=sm_scale, causal=causal,
                            q_per_kv=q_per_kv, q_offset=q_offset)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)


def _attend(q, k, v, causal: bool, cfg: ModelConfig,
            kv_valid_len: Optional[int] = None, q_per_kv: Optional[int] = None,
            q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,H,D) against k/v: (B,T,Hkv,D), not repeated (``q_per_kv``
    query heads a kv head, the config's by default): through the kernels
    when ``cfg.kernels == "cuda"``, else the plain path (dense, or chunked
    over the keys for long sequences, as the reference's XLA path).  A
    causal ``q_offset`` (the position of query row 0) must be ``T - S``:
    the queries are the last of the keys' positions, which is what the
    plain path's end-aligned mask assumes."""
    sm_scale = cfg.head_dim_ ** -0.5
    g = cfg.q_per_kv if q_per_kv is None else q_per_kv
    if causal and q_offset and k.shape[1] - q.shape[1] != q_offset:
        raise ValueError(f"a causal query offset of {q_offset} over {k.shape[1]} keys for "
                         f"{q.shape[1]} queries: the queries must be the last positions")
    if cfg.kernels == "cuda":
        if q.dtype != k.dtype:
            k, v = k.to(q.dtype), v.to(q.dtype)
        return _sdpa_kernel(q, k, v, causal, sm_scale, g, kv_valid_len=kv_valid_len,
                            q_offset=q_offset)
    kr = _repeat_kv(k, g)
    vr = _repeat_kv(v, g)
    return _sdpa_plain(q, kr, vr, causal, sm_scale, kv_valid_len=kv_valid_len)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_index: Optional[int] = None,
              kv_input: Optional[torch.Tensor] = None,
              precomputed_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              use_rope: bool = True):
    """GQA attention.  Returns (out, new_kv_cache | None).

    * train/prefill without a cache: ``kv_cache is None``: full causal
      self-attention (or bidirectional with ``causal=False``).
    * cached: ``kv_cache=(k, v)`` of shape (B, T, nkv, hd); the S new tokens'
      k/v are written at ``cache_index`` **in place** and the same tensors
      are returned.  With S == 1 this is a decode step over the
      ``cache_index + 1`` valid keys.  With S > 1 it is a prompt pass, or a
      chunk of one at ``cache_index`` > 0 (chunked prefill): the tokens
      attend over the cache's first ``cache_index + S`` keys in its dtype,
      causally with the query offset ``cache_index`` (which is what feeding
      them one by one computes).
    * cross-attention, over all keys of another sequence, with no RoPE:
      ``kv_input`` (B, T, d) is projected to k/v here; ``precomputed_kv``
      hands over projected (k, v) of shape (B, T, nkv, hd), cast to the
      activations' dtype (a cached encoder memory).  Neither takes a cache.
      On the kernel path a prompt goes through FlashAttention without a
      mask and one token through flash-decode over every key; the reference
      sends ``precomputed_kv`` through its plain path even with its kernels
      on.
    * under a step that splits the sequence (``spmd.seq_axis``), ``x`` is
      the rank's token block ``[o, o + S)``: self-attention attends over the
      keys gathered along the axis with K2's query offset ``o``
      (:func:`_context_parallel`); a prompt pass writes the rank's block of
      the cache (:func:`_prompt_into_split`), as does a prompt pass of the
      whole sequence into a cache the plan splits.  Cross-attention's
      ``kv_input`` is then the rank's block of the memory: its K and V are
      gathered over the axis (``spmd.gather_seq``), so the queries see every
      memory position.
    """
    B, S, d = x.shape
    hd = cfg.head_dim_
    axis = spmd.local_of(p["wq"])
    if axis is not None and kv_input is None and precomputed_kv is None:
        return _attention_local(p, x, cfg, axis, causal=causal, positions=positions,
                                kv_cache=kv_cache, cache_index=cache_index,
                                use_rope=use_rope)
    if axis is not None:
        if kv_cache is not None:
            raise ValueError("cross-attention (kv_input, precomputed_kv) takes no cache")
        return _cross_local(p, x, cfg, axis, kv_input, precomputed_kv), None
    if kv_input is not None or precomputed_kv is not None:
        if kv_cache is not None:
            raise ValueError("cross-attention (kv_input, precomputed_kv) takes no cache")
        if precomputed_kv is not None:
            q = _proj_in("bsd,dhk->bshk", x, p["wq"])
            if "bq" in p:
                q = q + p["bq"].to(x.dtype)
            split = spmd.cache_split(precomputed_kv[0])
            if split is not None and split.split_dims():
                if S == 1:
                    out = _decode_split(q, None, None, *precomputed_kv, None, split, cfg)
                    return _proj_out("bshk,hkd->bsd", out, p["wo"]), None
                # a prompt given the cross K/V as the plan splits it: whole again
                precomputed_kv = _gather_split(precomputed_kv, split)
            k, v = (t.to(x.dtype) for t in precomputed_kv)
        else:
            q, k, v = _project_qkv(p, x, cfg, kv_input)
            # the memory is the rank's block where the step splits the
            # sequence: every query attends over all of it
            k, v = spmd.gather_seq(k, 1), spmd.gather_seq(v, 1)
        out = _attend(q, k, v, False, cfg)
        return _proj_out("bshk,hkd->bsd", out, p["wo"]), None
    q, k, v = _project_qkv(p, x, cfg)
    cached = kv_cache is not None and cache_index is not None
    o = spmd.seq_range(S)[0]                 # the position of this rank's first token
    if use_rope:
        if cached:
            pos = cache_index + o + torch.arange(S, device=x.device)
        else:
            pos = positions if positions is not None \
                else o + torch.arange(S, device=x.device)
        cos, sin = rope_frequencies(hd, cfg.rope_theta, pos)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if kv_cache is None and spmd.seq_axis() is not None:
        out = _context_parallel(q, k, v, o, causal, cfg)
        return _proj_out("bshk,hkd->bsd", out, p["wo"]), None
    new_cache = None
    valid, offset = None, 0
    is_causal = causal and kv_cache is None
    if kv_cache is not None:
        ck, cv = kv_cache
        split = spmd.cache_split(ck) if cached else None
        splits = split is not None and bool(split.split_dims())
        if cached and S > 1 and (splits or spmd.seq_axis() is not None):
            out = _prompt_into_split(q, k, v, ck, cv, cache_index, split, causal, cfg)
            return _proj_out("bshk,hkd->bsd", out, p["wo"]), (ck, cv)
        if splits:
            out = _decode_split(q, k, v, ck, cv, cache_index, split, cfg)
            return _proj_out("bshk,hkd->bsd", out, p["wo"]), (ck, cv)
        if cached:
            ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
            valid = cache_index + S
        # attend over the cache, in its dtype, as the reference does
        k, v = ck, cv
        if cached and S > 1:
            # a prompt pass or a later chunk: the S tokens see the keys ahead
            # of them and each other causally, which is what feeding them
            # one by one computes
            k, v = ck[:, :valid], cv[:, :valid]
            valid = None
            is_causal = causal
            offset = cache_index if causal else 0
        new_cache = (ck, cv)
    out = _attend(q, k, v, is_causal, cfg, kv_valid_len=valid, q_offset=offset)
    return _proj_out("bshk,hkd->bsd", out, p["wo"]), new_cache


def _context_parallel(q, k, v, o: int, causal: bool, cfg: ModelConfig) -> torch.Tensor:
    """Attention of this rank's queries, positions ``[o, o + S)`` of a
    sequence the step splits, over the keys of every rank along the axis
    (the all-gather form of context parallelism): causally only the first
    ``o + S`` keys are gathered and K2 masks with the query offset ``o``.
    The gather's backward hands each rank's keys the gradient of every
    later rank's queries."""
    S = q.shape[1]
    keep = o + S if causal else None
    k, v = (spmd.gather_seq(t, 1, keep=keep) for t in (k, v))
    return _attend(q, k, v, causal, cfg, q_offset=o if causal else 0)


def _prompt_into_split(q, k, v, ck, cv, cache_index: int, split, causal: bool,
                       cfg: ModelConfig) -> torch.Tensor:
    """A prompt pass (S > 1 tokens at ``cache_index``) into this rank's
    ``ck``/``cv``, which the serving step's plan may split over ``kv_seq``
    and ``kv_heads`` (``split``: their ``spmd.CacheSplit``, or None for a
    whole cache).  The chunk's keys and values are whole on every rank
    (gathered over the sequence axis where the step splits the tokens);
    the rank writes the positions and heads of its cache block that the
    chunk covers.

    * From index 0 the rank's queries attend causally over the prompt's
      keys in the cache's dtype (as the unsplit prompt pass reads them
      back), with the query offset of its token block.
    * A later chunk (chunked prefill), its tokens whole on every rank,
      needs the keys ahead of it, which the ranks along ``kv_seq`` hold in
      blocks: each rank attends with every chunk row over its own block
      (K2 with its log-sum-exp, at the query offset of the chunk within the
      block), and K3' folds the ranks' (output, log-sum-exp) pairs
      (:func:`_chunk_over_ranks`).  No cache block is gathered.  A later
      chunk under a step that splits its tokens, or into a cache split
      over ``kv_heads`` too, raises ``NotImplementedError``: the serving
      step splits the tokens only from index 0, and no plan splits both.

    The decode steps that follow run :func:`_decode_split`."""
    S = q.shape[1]
    o = spmd.seq_range(S)[0]
    k_all, v_all = (spmd.gather_seq(t, 1) for t in (k, v))
    T = k_all.shape[1]
    off, t_local, h0, hn = 0, ck.shape[1], 0, ck.shape[2]
    kv_axes = heads = ()
    if split is not None:
        kv_axes, heads = split.mesh_axes_of("kv_seq"), split.mesh_axes_of("kv_heads")
        if kv_axes:
            off, t_local = split.block("kv_seq")
        if heads:
            h0, hn = split.block("kv_heads")
    if cache_index and (not kv_axes or heads or spmd.seq_axis() is not None):
        raise NotImplementedError(
            f"a chunk at cache index {cache_index} into a cache split over "
            f"{split.split_dims() if split is not None else 'nothing'}"
            f"{' under a step that splits its tokens' if spmd.seq_axis() else ''}: a "
            f"later chunk goes into a cache split over kv_seq alone, its tokens whole "
            f"(ROADMAP Queue 1, item 2c)")
    # the chunk's positions [cache_index, cache_index + T) that the block holds
    lo, hi = max(cache_index, off), min(cache_index + T, off + t_local)
    if hi > lo:
        ck[:, lo - off:hi - off] = k_all[:, lo - cache_index:hi - cache_index,
                                         h0:h0 + hn].to(ck.dtype)
        cv[:, lo - off:hi - off] = v_all[:, lo - cache_index:hi - cache_index,
                                         h0:h0 + hn].to(cv.dtype)
    if cache_index == 0:
        keep = o + S if causal else T
        kk, vv = (t[:, :keep].to(ck.dtype) for t in (k_all, v_all))
        return _attend(q, kk, vv, causal, cfg, q_offset=o if causal else 0)
    if not causal:
        raise ValueError(f"a chunk at cache index {cache_index} attends causally")
    return _chunk_over_ranks(q, ck, cv, cache_index - off, kv_axes, cfg)


def _block_partials(q, ck, cv, q_offset: int, cfg: ModelConfig):
    """Every chunk row's attention over one block of the cache, as the
    partials of one split: q (B, S, H, D), row r at position ``q_offset + r``
    relative to the block's first key; ck/cv (B, T_block, Hkv, D).  Returns
    float32 (m, l, acc) of shapes (B·H·S, 1, 1, 1), (B·H·S, 1, 1, 1),
    (B·H·S, 1, 1, D) in (batch, head, row) order: m the row's log-sum-exp,
    l 1 and acc its output, or for a row that sees none of the block's keys
    the empty split's (-1e30, 0, 0) that K3's partials kernel writes.  Rows
    ahead of the block (a negative position) are not handed to K2, which
    takes no negative offset; a row K2 finds wholly masked (its
    log-sum-exp :data:`~repro_torch.kernels.flash_attention.LSE_MASKED`)
    becomes the empty split too, or its zero output would take the weight of
    the others.  Through K2 with ``return_lse`` when ``cfg.kernels ==
    "cuda"``, else its plain version."""
    from repro_torch.kernels import flash_attention as FA, ops
    B, S, H, D = q.shape
    g = H // ck.shape[2]
    r0 = min(max(-q_offset, 0), S)
    out = torch.zeros((B * H, S, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B * H, S), FA.LSE_MASKED, dtype=torch.float32, device=q.device)
    if r0 < S:
        qf = q[:, r0:].permute(0, 2, 1, 3).reshape(B * H, S - r0, D).contiguous()
        kf, vf = ck.permute(0, 2, 1, 3), cv.permute(0, 2, 1, 3)
        kw = dict(sm_scale=cfg.head_dim_ ** -0.5, causal=True, q_per_kv=g,
                  q_offset=q_offset + r0, return_lse=True)
        if cfg.kernels == "cuda":
            if kf.dtype != qf.dtype:
                kf, vf = kf.to(qf.dtype), vf.to(qf.dtype)
            o_r, lse_r = ops.attention(qf, kf, vf, **kw)
        else:
            o_r, lse_r = FA.flash_attention_plain(qf, kf, vf, **kw)
        out[:, r0:] = o_r.float()
        lse[:, r0:] = lse_r
    empty = lse >= 0.5 * FA.LSE_MASKED       # such a row's output is 0
    m = torch.where(empty, torch.full_like(lse, FA.NEG_INF), lse)
    l = (~empty).float()
    return m.reshape(-1, 1, 1, 1), l.reshape(-1, 1, 1, 1), out.reshape(-1, 1, 1, D)


def _chunk_over_ranks(q, ck, cv, q_offset: int, kv_axes, cfg: ModelConfig) -> torch.Tensor:
    """q: (B, S, H, D), every row of a chunk, against this rank's block of
    a cache split along ``kv_axes`` (``q_offset``: the chunk's first
    position relative to the block's first key): the
    rank's :func:`_block_partials`, gathered along the split dim in rank
    order and folded by one log-sum-exp combine (K3' when ``cfg.kernels ==
    "cuda"``, else its plain version) into q's dtype."""
    from repro_torch.kernels import flash_decode as FD
    B, S, H, D = q.shape
    m, l, acc = (spmd.gather_over(t, kv_axes, 1).contiguous()
                 for t in _block_partials(q, ck, cv, q_offset, cfg))
    combine = FD.combine_partials if cfg.kernels == "cuda" else FD.combine_partials_plain
    out = combine(m, l, acc, out_dtype=q.dtype)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)


def _gather_split(kv, split) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (k, v) pair the serving step's plan splits over ``kv_seq`` and
    ``kv_heads`` (``split``), whole again: each split dim gathered over its
    mesh axes in block order."""
    k, v = kv
    for logical, dim in (("kv_seq", 1), ("kv_heads", 2)):
        axes = split.mesh_axes_of(logical)
        if axes:
            k, v = spmd.gather_over(k, axes, dim), spmd.gather_over(v, axes, dim)
    return k, v


def _local_kv_heads(h0: int, hl: int, G: int):
    """The kv heads query heads ``[h0, h0 + hl)`` read (head h reads h // G):
    ``(lo, hi, index, q_per_kv)`` with ``index`` None when every kv head of
    ``[lo, hi)`` serves ``q_per_kv`` consecutive query heads, else the kv
    head of each query head in turn (``q_per_kv`` 1)."""
    lo, hi = h0 // G, (h0 + hl - 1) // G + 1
    if h0 % G == 0 and hl % G == 0:
        return lo, hi, None, G
    if hi - lo == 1:
        return lo, hi, None, hl
    return lo, hi, [(h0 + j) // G - lo for j in range(hl)], 1


def _attention_local(p: Params, x: torch.Tensor, cfg: ModelConfig, axis: str, *,
                     causal: bool, positions, kv_cache, cache_index, use_rope: bool):
    """:func:`attention` (self-attention) over this rank's query heads, whose
    ``wq``/``bq``/``wo`` the step left split over ``axis``.

    ``wk``/``wv`` are split alike when the plan could split ``kv_heads``
    (this rank's kv heads are those its query heads read); otherwise they
    are whole (GQA with fewer kv heads than ranks) and the rank projects
    only the kv heads its query heads read (every kv head where a whole
    cache must be filled), their gradient summed over ``axis``.  A cache
    must be whole or split over ``kv_heads`` on ``axis``; its rank's heads
    are written, at any index (a chunk at ``cache_index`` > 0 attends
    causally over the keys ahead of it too).  The output of the
    row-parallel ``wo`` product is summed over ``axis``."""
    B, S, _ = x.shape
    G = cfg.q_per_kv
    x = spmd.enter(x, axis)
    hl = p["wq"].shape[1]
    h0 = spmd.axis_index(axis) * hl
    ck = cv = None
    if kv_cache is not None:
        ck, cv = kv_cache
        split = spmd.cache_split(ck)
        dims = split.split_dims() if split is not None else ()
        if set(dims) - {"kv_heads"} or (dims and split.mesh_axes_of("kv_heads") != (axis,)):
            raise NotImplementedError(
                f"head-local attention into a cache split over {dims} "
                f"({split.sharding.spec}): only a split of kv_heads over {axis!r}")
        if cache_index is None:
            raise NotImplementedError("head-local attention into a cache takes its index")
    p = dict(p)
    if spmd.local_of(p["wk"]) is not None:
        # the plan split kv_heads too: the rank's kv heads are its query heads'
        sel, index, g = slice(None), None, G
    else:
        lo, hi, index, g = _local_kv_heads(h0, hl, G)
        kv_leaves = [n for n in ("wk", "wv", "bk", "bv") if n in p]
        p.update({n: spmd.enter(p[n], axis) for n in kv_leaves})
        if ck is not None and ck.shape[2] == cfg.n_kv_heads:
            sel = slice(lo, hi)           # a whole cache: project every kv head
        else:
            sel = slice(None)
            p.update({n: p[n][:, lo:hi] if n[0] == "w" else p[n][lo:hi] for n in kv_leaves})
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        pos = (cache_index + torch.arange(S, device=x.device) if ck is not None
               else positions if positions is not None else torch.arange(S, device=x.device))
        cos, sin = rope_frequencies(cfg.head_dim_, cfg.rope_theta, pos)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    valid, is_causal, offset = None, causal, 0
    if ck is not None:
        if ck.shape[2] != k.shape[2]:
            raise ValueError(f"cache of {ck.shape[2]} kv heads for {k.shape[2]} projected")
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
        if S > 1:
            # a prompt pass or a later chunk, causal over the keys ahead of it
            k, v = ck[:, :cache_index + S], cv[:, :cache_index + S]
            offset = cache_index if causal else 0
        else:
            k, v, valid, is_causal = ck, cv, cache_index + 1, False
    k, v = k[:, :, sel], v[:, :, sel]
    if index is not None:
        k, v = k[:, :, index], v[:, :, index]
    out = _attend(q, k, v, is_causal, cfg, kv_valid_len=valid, q_per_kv=g, q_offset=offset)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return spmd.psum(out, axis), kv_cache


def _cross_local(p: Params, x: torch.Tensor, cfg: ModelConfig, axis: str,
                 kv_input: Optional[torch.Tensor], precomputed_kv) -> torch.Tensor:
    """Cross-attention (over every key, no RoPE) over this rank's query
    heads, whose ``wq``/``bq``/``wo`` the step left split over ``axis``:
    ``kv_input`` (the encoder memory, entered: its gradient summed over the
    axis) projected to the kv heads those query heads read (``wk``/``wv``
    split alike, or whole and sliced as :func:`_attention_local` does), or
    ``precomputed_kv`` holding every kv head or this rank's (a cache the
    serving plan splits over ``kv_heads`` on the axis).  The output of the
    row-parallel ``wo`` product is summed over ``axis``."""
    G = cfg.q_per_kv
    x = spmd.enter(x, axis)
    hl = p["wq"].shape[1]
    h0 = spmd.axis_index(axis) * hl
    lo, hi, index, g = _local_kv_heads(h0, hl, G)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if precomputed_kv is not None:
        k, v = (t.to(x.dtype) for t in precomputed_kv)
        if k.shape[2] == cfg.n_kv_heads and hi - lo != cfg.n_kv_heads:
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    else:
        mem = spmd.enter(kv_input, axis)
        kv = {}
        for n in ("wk", "wv", "bk", "bv"):
            if n in p:
                w = p[n]
                if spmd.local_of(w) is None:          # whole: this rank's kv heads
                    w = spmd.enter(w, axis)
                    w = w[:, lo:hi] if n[0] == "w" else w[lo:hi]
                kv[n] = w
        k = torch.einsum("bsd,dhk->bshk", mem, kv["wk"].to(mem.dtype))
        v = torch.einsum("bsd,dhk->bshk", mem, kv["wv"].to(mem.dtype))
        if "bk" in kv:
            k, v = k + kv["bk"].to(mem.dtype), v + kv["bv"].to(mem.dtype)
    if k.shape[2] != hi - lo:
        raise ValueError(f"{k.shape[2]} kv heads for the {hi - lo} query heads "
                         f"[{h0}, {h0 + hl}) read")
    if index is not None:
        k, v = k[:, :, index], v[:, :, index]
    out = _attend(q, k, v, False, cfg, q_per_kv=g)
    return spmd.psum(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), axis)


def _decode_split(q, k, v, ck, cv, cache_index: Optional[int], split, cfg: ModelConfig
                  ) -> torch.Tensor:
    """One decode token against a cache leaf the serving step's plan splits
    (``split``: its ``spmd.CacheSplit``).  q: (B, 1, H, D) over every head;
    k/v: the token's (B, 1, nkv, D), or None for cross-attention, whose keys
    are all valid; ck/cv: this rank's (B, T_local, nkv_local, D).

    * Split over ``kv_heads``: only the query heads of the local kv heads
      are decoded here, and their outputs are gathered over that axis.
    * The new token's k/v go only to the rank whose block holds global
      position ``cache_index``; the local valid length is
      ``clamp(cache_index + 1 - offset, 0, T_local)``, possibly 0.
    * Split over ``kv_seq``: each rank's partials of its own keys (K3's
      partials kernel), gathered over the kv_seq axes, folded by K3'.  Not
      split: the one-launch K3 over the local heads.
    No cache leaf is gathered."""
    heads = split.mesh_axes_of("kv_heads")
    kv_axes = split.mesh_axes_of("kv_seq")
    G = cfg.q_per_kv
    if heads:
        h0, hn = split.block("kv_heads")
        q = q[:, :, h0 * G:(h0 + hn) * G]
        if k is not None:
            k, v = k[:, :, h0:h0 + hn], v[:, :, h0:h0 + hn]
    off, t_local = split.block("kv_seq")
    if k is None:
        valid = t_local
    else:
        at = cache_index - off
        if 0 <= at < t_local:
            ck[:, at] = k[:, 0].to(ck.dtype)
            cv[:, at] = v[:, 0].to(cv.dtype)
        valid = min(max(cache_index + 1 - off, 0), t_local)
    if kv_axes:
        out = _partials_over_ranks(q, ck, cv, valid, kv_axes, cfg)
    else:
        out = _attend(q, ck, cv, False, cfg, kv_valid_len=valid)
    return spmd.gather_over(out, heads, 2) if heads else out


def _partials_over_ranks(q, k, v, valid: int, kv_axes, cfg: ModelConfig) -> torch.Tensor:
    """q: (B, 1, H, D) against this rank's keys k/v: (B, T_local, Hkv, D),
    the first ``valid`` of them, combined with the other ranks' along
    ``kv_axes``: the partials of the local keys, gathered along the split
    dim in rank order, then one log-sum-exp combine in q's dtype.  The split
    count follows the local buffer's length, not the valid length, so every
    rank gathers partials of one shape; at most MAX_SPLITS / ranks, so the
    combine takes at most MAX_SPLITS.  Through K3's partials kernel and K3'
    when ``cfg.kernels == "cuda"``, else their plain versions."""
    from repro_torch.kernels import flash_decode as FD, ops
    B, S, H, D = q.shape
    sm_scale = cfg.head_dim_ ** -0.5
    g = H // k.shape[2]
    ranks = math.prod(spmd.current().mesh.shape[a] for a in kv_axes)
    if ranks > FD.MAX_SPLITS:
        raise ValueError(f"{ranks} ranks along {kv_axes} exceed the combine's "
                         f"{FD.MAX_SPLITS} splits")
    qf = q.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()
    if cfg.kernels == "cuda" and k.dtype != q.dtype:
        k, v = k.to(q.dtype), v.to(q.dtype)
    # the split rule of the body the call runs (the plain path: the mma.sync
    # body's)
    body = FD.body_for(qf, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), g) \
        if cfg.kernels == "cuda" else "mma"
    splits = FD.choose_splits(k.shape[1], B * k.shape[2], FD.sm_count(q.device),
                              FD.MAX_SPLITS // ranks, body)
    if cfg.kernels == "cuda":
        m, l, acc = ops.flash_decode_partials(
            qf, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), sm_scale=sm_scale,
            kv_splits=splits, kv_valid_len=valid, q_per_kv=g)
        combine = FD.combine_partials
    else:
        m, l, acc = FD.flash_decode_partials_plain(
            qf, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), kv_splits=splits,
            sm_scale=sm_scale, kv_valid_len=valid, q_per_kv=g)
        combine = FD.combine_partials_plain
    m, l, acc = (spmd.gather_over(t, kv_axes, 1) for t in (m, l, acc))
    out = combine(m, l, acc, out_dtype=q.dtype)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)


# -------------------------------------------------------------------- MLP
def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": LeafSpec((d, f), ("embed", "ffn")),
        "w_up": LeafSpec((d, f), ("embed", "ffn")),
        "w_down": LeafSpec((f, d), ("ffn", "embed")),
    }


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated MLP; over this rank's ffn columns where the step left them
    split (column-parallel gate and up, row-parallel down, summed); over
    the ranks' ``embed`` blocks where the step split that (gate and up
    summed, down into the rank's block)."""
    axis = spmd.local_of(p["w_gate"])
    if axis is not None:
        x = spmd.enter(x, axis)
    g = _proj_in("bsd,df->bsf", x, p["w_gate"])
    u = _proj_in("bsd,df->bsf", x, p["w_up"])
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if cfg.mlp_activation == "gelu" else F.silu(g)
    out = _proj_out("bsf,fd->bsd", act * u, p["w_down"])
    return out if axis is None else spmd.psum(out, axis)


# -------------------------------------------------------------- embeddings
def embedding_spec(cfg: ModelConfig) -> Params:
    return {"table": LeafSpec((cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed"), scale=1.0)}


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rows of the table; where the step left its vocabulary split, each
    rank looks up the ids its rows hold (zeros elsewhere) and the ranks'
    lookups are summed."""
    table = p["table"]
    axis = spmd.local_of(table)
    if axis is None:
        return F.embedding(tokens, table).to(cdtype(cfg))
    n = table.shape[0]
    at = tokens - spmd.axis_index(axis) * n
    mine = ((at >= 0) & (at < n))[..., None]
    x = F.embedding(at.clamp(0, n - 1), table).to(cdtype(cfg))
    return spmd.psum(torch.where(mine, x, torch.zeros_like(x)), axis)


def lm_head_spec(cfg: ModelConfig) -> Params:
    if cfg.tie_embeddings:
        return {}
    return {"w": LeafSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))}


def lm_head(p: Params, x: torch.Tensor, cfg: ModelConfig,
            embed_params: Optional[Params] = None) -> torch.Tensor:
    """Logits (B, S, V); over this rank's vocabulary block where the step
    left the head's (or the tied table's) vocabulary split, marked so that
    :func:`softmax_xent` reduces over the axis and :func:`whole_vocab`
    gathers."""
    src = embed_params["table"] if cfg.tie_embeddings else p["w"]
    axis = spmd.local_of(src)
    if axis is not None:
        x = spmd.enter(x, axis)
    w = src.to(x.dtype).T if cfg.tie_embeddings else src.to(x.dtype)
    logits = torch.einsum("bsd,dv->bsv", x, w)
    if spmd.embed_of(src) is not None:
        logits = _sum_partials(logits, spmd.embed_of(src))
    return logits if axis is None else spmd.mark_local(logits, axis)


def whole_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocabulary: ``logits`` itself, or the ranks'
    blocks of a vocabulary-local head gathered in order."""
    axis = spmd.local_of(logits)
    return logits if axis is None else spmd.gather_over(logits, axis, logits.dim() - 1)


# ------------------------------------------------------------------ losses
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 total: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy, numerically stable in float32; over the
    ranks' vocabulary blocks of a vocabulary-local head
    (``spmd.vocab_xent_sum``).  With ``total``: the positions are this
    rank's part of ``total`` that the ranks along a split sequence hold in
    unequal parts, and the loss is its share of their mean
    (``spmd.seq_share``)."""
    axis = spmd.local_of(logits)
    if axis is not None:
        s = spmd.vocab_xent_sum(logits, labels, axis)
        return s / labels.numel() if total is None else spmd.seq_share(s, total)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    if total is not None:
        return spmd.seq_share(torch.sum(logz - gold), total)
    return torch.mean(logz - gold)


# tokens x vocab above this fuses head+loss.  Disabled by default, as in the
# reference (its measurement found the fused form worse); opt in by lowering
# it.
FUSED_XENT_THRESHOLD = 1 << 60


def _chunk_xent_sum(xs: torch.Tensor, w: torch.Tensor, ls: torch.Tensor,
                    eq: str) -> torch.Tensor:
    axis = spmd.local_of(w)
    if axis is not None:
        return spmd.vocab_xent_sum(torch.einsum(eq, xs, w.to(xs.dtype)), ls, axis)
    logits = _proj_in(eq, xs, w).float()
    gold = torch.gather(logits, -1, ls[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def fused_head_xent(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
                    chunk: int = 2048, w_is_vd: bool = False) -> torch.Tensor:
    """LM head + cross-entropy over sequence chunks: each chunk's float32
    logits exist only inside its own step (recomputed in the backward, as
    the reference's scan step is), so (tokens x vocab) float32 logits are
    never held whole.

    x: (B, S, d); w: (d, V), or (V, d) with ``w_is_vd``; labels: (B, S) ->
    scalar mean xent.  A sequence that ``chunk`` does not divide takes the
    unfused path, as in the reference."""
    B, S, _ = x.shape
    eq = "bsd,vd->bsv" if w_is_vd else "bsd,dv->bsv"
    axis = spmd.local_of(w)
    if axis is not None:
        x = spmd.enter(x, axis)            # each rank's vocabulary block: part of dx
    c = min(chunk, S)
    if S % c:
        logits = torch.einsum(eq, x, w.to(x.dtype)) if axis is not None else _proj_in(eq, x, w)
        return softmax_xent(logits if axis is None else spmd.mark_local(logits, axis), labels)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        xs, ls = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        total = total + remat(True, _chunk_xent_sum, xs, w, ls, eq)
    return total / (B * S)


# -------------------------------------------------------------------- remat
def remat(enabled: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its activations recomputed in the backward
    instead of kept when ``enabled`` and autograd records
    (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``jax.checkpoint`` with ``nothing_saveable``).  Every kernel ``fn``
    launches runs twice a training step.  Under a plan-sharded step the
    parameters among ``args`` are gathered for the call; ``kwargs`` (a
    decode step's cache slices) go in as they are."""
    step = spmd.current()
    if enabled and torch.is_grad_enabled():
        return checkpoint(_gathered, step, fn, *args, use_reentrant=False, **kwargs)
    return _gathered(step, fn, *args, **kwargs)


def _gathered(step, fn, *args, **kwargs):
    """``fn`` on its arguments as the plan-sharded ``step`` uses them (None:
    outside one): each sharded parameter gathered (``parallel.spmd.
    for_use``).  Inside ``remat``'s checkpoint, so the recomputation, which
    the autograd engine may run on another thread, enters the step again
    and gathers again instead of keeping the gathered weights."""
    with spmd.step_context(step):
        return fn(*spmd.for_use(args), **kwargs)
