"""RWKV6 "Finch" (attention-free, data-dependent decay): rwkv6-3b.

Counterpart of ``repro/models/rwkv6.py``.  Block = time-mix (token shift ->
r/k/v/g projections + the RWKV6 signature *data-dependent decay*
``w = exp(-exp(w0 + tanh(x A) B))`` via a LoRA -> WKV linear-recurrence core
-> group-norm -> gated output) followed by channel-mix (token shift ->
squared-ReLU FFN gated by sigmoid receptance).

The WKV core of a multi-token pass runs chunked: through
``kernels.ops.wkv6`` (the CUDA kernel on the card, K5, and its backward
K5-bwd when autograd records) with ``cfg.kernels == "cuda"``, through
:func:`wkv6_chunked` (the same chunked math in plain PyTorch, differentiated
by autograd) otherwise.  Decode carries the per-layer state (S, shift buffers)
instead of a KV cache, and a single token goes through the plain
recurrence, as in the reference.  The cache is updated **in place**.

Simplification vs. the released checkpoints (the reference's, kept):
token-shift interpolation uses per-channel static mixes (RWKV5-style) rather
than the full 5-way data-dependent lerp; the decay LoRA is kept faithful.

Under a plan-sharded step with a local axis the time mix computes the
rank's heads and the channel mix its ffn columns (:func:`time_mix`,
:func:`channel_mix`); under one that splits the sequence the rank computes
its token block, its scan started from the state the earlier blocks leave
(:func:`_scan_split`) and its token shifts fed the previous rank's last
row; under ``tp2d`` it also holds a block of the residual's channels.

The reference has no multi-token prefill for this family (its serve loop
feeds the prompt token by token); :func:`prefill` is the port's, and equals
that loop.  :func:`loss_fn` is the reference's: the mean cross-entropy of
:func:`forward`, whose blocks are recomputed in the backward when
``cfg.remat`` (so K5 runs twice a layer a training step, K5-bwd once).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, rwkv6 as _rwkv
from repro_torch.parallel import spmd
from . import layers as L
from . import transformer
from .param import LeafSpec, stack_specs

Params = Dict[str, Any]
LORA_DIM = 64
# chunk x decay-floor must stay below log(f32_max)/2 ~ 44 per side:
# 16 * 4 / 2 = 32 -> every pairwise score exponent <= 64 < 88 (finite).
WKV_CHUNK = 16


def _head_dim(cfg: ModelConfig) -> int:
    return cfg.head_dim or 64


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // _head_dim(cfg)


def time_mix_spec(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    H, hd = _n_heads(cfg), _head_dim(cfg)
    lora = min(LORA_DIM, d)
    return {
        "mix_r": LeafSpec((d,), ("embed",), init="zeros"),
        "mix_k": LeafSpec((d,), ("embed",), init="zeros"),
        "mix_v": LeafSpec((d,), ("embed",), init="zeros"),
        "mix_w": LeafSpec((d,), ("embed",), init="zeros"),
        "mix_g": LeafSpec((d,), ("embed",), init="zeros"),
        "wr": LeafSpec((d, d), ("embed", "q_heads")),
        "wk": LeafSpec((d, d), ("embed", "q_heads")),
        "wv": LeafSpec((d, d), ("embed", "q_heads")),
        "wg": LeafSpec((d, d), ("embed", "q_heads")),
        "wo": LeafSpec((d, d), ("q_heads", "embed")),
        # data-dependent decay LoRA (RWKV6 signature)
        "w0": LeafSpec((d,), ("embed",), init="scaled", scale=0.5),
        "wA": LeafSpec((d, lora), ("embed", None)),
        "wB": LeafSpec((lora, d), (None, "embed")),
        "u": LeafSpec((H, hd), ("q_heads", "head_dim"), init="scaled", scale=0.5),
        "ln_x": LeafSpec((d,), ("embed",), init="ones"),
    }


def channel_mix_spec(cfg: ModelConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": LeafSpec((d,), ("embed",), init="zeros"),
        "mix_r": LeafSpec((d,), ("embed",), init="zeros"),
        "wk": LeafSpec((d, f), ("embed", "ffn")),
        "wv": LeafSpec((f, d), ("ffn", "embed")),
        "wr": LeafSpec((d, d), ("embed", "q_heads")),
    }


def block_spec(cfg: ModelConfig) -> Params:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "tm": time_mix_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "cm": channel_mix_spec(cfg),
    }


def rwkv6_spec(cfg: ModelConfig) -> Params:
    return {
        "embed": L.embedding_spec(cfg),
        "blocks": stack_specs(block_spec(cfg), cfg.n_layers),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "lm_head": L.lm_head_spec(cfg),
    }


# ------------------------------------------------------------- WKV core
def wkv6_chunked(r, k, v, log_w, u, chunk: int = WKV_CHUNK, state0=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``wkv6_chunked_jnp``: the kernel's chunked math in plain
    PyTorch, returning (o, final state), from ``state0`` (zero when None).
    Shapes as in ``kernels.rwkv6.wkv6``; like the reference, ``min(chunk,
    T)`` must divide T."""
    kw = {} if state0 is None else {"state0": state0}
    return _rwkv.wkv6_plain(r, k, v, log_w, u, chunk=chunk, **kw)


def _scan(r, k, v, lw, u, cfg: ModelConfig, state0=None):
    """The chunked WKV scan of one pass: K5 (``ops.wkv6``) with
    ``cfg.kernels == "cuda"`` on the decay and bonus rounded to the compute
    dtype, as the reference's kernel path casts them (mirrored, not fixed);
    else the plain chunked math."""
    kw = {} if state0 is None else {"state0": state0}
    if cfg.kernels == "cuda":
        return ops.wkv6(r, k, v, lw.to(r.dtype), u.to(r.dtype), chunk=WKV_CHUNK, **kw)
    return wkv6_chunked(r, k, v, lw, u, **kw)


def _scan_split(r, k, v, lw, u, cfg: ModelConfig):
    """The scan of this rank's token block of a sequence the step splits,
    from the state the earlier ranks' blocks leave: the block scanned from
    zero gives its own final state, whose (state, summed log-decay) pairs
    are gathered over the sequence axis and folded in rank order
    (``spmd.carry_states``), and the block is scanned again from the state
    entering it, two K5 launches a layer on the kernel path.  The decays
    summed are the ones the scan reads (rounded to the compute dtype on the
    kernel path).  Returns (o, the state after the whole sequence)."""
    _, own = _scan(r, k, v, lw, u, cfg)
    read = lw.to(r.dtype) if cfg.kernels == "cuda" else lw
    entering, final = spmd.carry_states(own, read.float().sum(dim=1)[..., None])
    o, _ = _scan(r, k, v, lw, u, cfg, state0=entering)
    return o, final


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift sequence right by one; ``prev`` supplies the carry for decode
    (and the previous rank's last row under a sequence split)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _shifted(x: torch.Tensor, shift_prev=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` shifted right by one and the row a cache keeps for the next
    token: under a sequence split the previous rank's last row comes in
    across the block boundary, and the row kept is the sequence's last
    (the last rank's, on every rank)."""
    if spmd.seq_axis() is None:
        return _token_shift(x, shift_prev), x[:, -1]
    prev, last = spmd.seq_edges(x, 1)
    return _token_shift(x, prev[:, 0]), last[:, 0]


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("btd,df->btf", x, w.to(x.dtype))


def _mm_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` contracting ``embed``: the ranks' partial products summed
    where the step split it (``tp2d``)."""
    return L._proj_in("btd,df->btf", x, w)


def _mm_out(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` into ``embed``: the rank's block of it where the step
    split it (``h`` whole, its gradient summed over the ranks)."""
    return L._proj_out("btf,fd->btd", h, w)


# the dims the plan may leave split for local compute
_TM_SPLIT = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "u": 0}
_CM_SPLIT = {"wk": 1, "wv": 0, "wr": 1}


def _heads_fit(p: Params, hd: int, axis: str) -> bool:
    """Whether the time mix's split lines up with whole heads: r/k/v/g's
    columns, ``wo``'s rows and ``u``'s heads all split over ``axis`` into
    the same whole heads (else the layer runs whole)."""
    n = p["wr"].shape[1]
    return (n % hd == 0 and all(spmd.local_of(p[k]) == axis for k in _TM_SPLIT)
            and all(p[k].shape[1] == n for k in ("wk", "wv", "wg"))
            and p["wo"].shape[0] == n and p["u"].shape[0] * hd == n)


# whole leaves a local time mix uses on every rank: their gradients are
# summed over the axis; the last three index the heads' channels
_TM_WHOLE = ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "wA", "w0", "wB", "ln_x")


def time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *, shift_prev=None, state=None):
    """Returns (out, (new_shift, new_state)).  ``state``: (B,H,hd,hd) for
    single-token decode; None for a chunked pass from a zero state, whose
    final state is returned (the reference returns None there).

    Under a step that left ``wr`` split over its local axis (heads-local, as
    GSPMD places the reference's activations) the rank computes its heads:
    r/k/v/g column-parallel, ``u`` its rows, K5 and the group norm over its
    B x hn rows, ``wo`` row-parallel and summed over the axis.  ``w0``,
    ``wB``'s output and ``ln_x`` are named ``embed`` but index the heads'
    channels: they stay whole and the rank takes its heads' slice after
    ``spmd.enter`` (whose backward sums the gradient over the axis), as it
    does for the other whole leaves it uses and for ``x``; its new state is
    its heads'.  A split that cuts a head runs the layer whole
    (``spmd.unsplit``).  Under a step that splits the sequence the rank scans its
    token block from the state the earlier blocks leave (:func:`_scan_split`)
    and returns the sequence's final state and last row.
    Under ``tp2d`` (the step split ``embed`` too) ``x`` is the rank's block
    of channels: r/k/v/g and the decay LoRA's ``wA`` are contracted over it
    and summed, leaving whole heads; ``w0``, ``wB`` and ``ln_x`` (which
    index the heads' channels) are gathered whole (``spmd.gather_alike``:
    every rank computes the same heads, so its gradient is its own block of
    theirs); ``wo`` produces the rank's block."""
    B, T, d = x.shape
    H, hd = _n_heads(cfg), _head_dim(cfg)
    axis = spmd.local_of(p["wr"]) if state is None else None
    if axis is not None and not _heads_fit(p, hd, axis):
        p, axis = spmd.unsplit(p, _TM_SPLIT), None
    hn = H
    if axis is not None:
        x = spmd.enter(x, axis)
        hn = p["wr"].shape[1] // hd
        cols = slice(spmd.axis_index(axis) * hn * hd, (spmd.axis_index(axis) + 1) * hn * hd)
        p = dict(p, **{n: spmd.enter(p[n], axis) for n in _TM_WHOLE})
        p.update(w0=p["w0"][cols], wB=p["wB"][:, cols], ln_x=p["ln_x"][cols])
    e_ax = spmd.embed_of(p["wr"])
    if e_ax is not None:
        # named embed, these index the heads' channels, which are whole here
        p = dict(p, w0=spmd.gather_alike(p["w0"], e_ax, 0),
                 wB=spmd.gather_alike(p["wB"], e_ax, 1), ln_x=spmd.gather_alike(p["ln_x"], e_ax, 0))
    xp, last = _shifted(x, shift_prev)

    def mixed(name):
        return x + (xp - x) * p[f"mix_{name}"].to(x.dtype)

    xr, xk, xv, xw, xg = (mixed(n) for n in "rkvwg")
    r, k, v, g = (_mm_in(t, p[n]) for t, n in ((xr, "wr"), (xk, "wk"), (xv, "wv"), (xg, "wg")))
    lora = xw.float() @ p["wA"].float()
    if e_ax is not None:
        lora = L._sum_partials(lora, e_ax)
    lw = -torch.exp(p["w0"].float() + torch.tanh(lora) @ p["wB"].float())
    # decay floor: keeps the chunked kernels' midpoint-offset factors in f32
    # range; applied at the source so every WKV path sees the same decays
    lw = torch.clamp(lw, min=-4.0)

    def to_heads(t):                    # (B,T,n hd) -> (B*n, T, hd), contiguous
        n = t.shape[-1] // hd
        return t.reshape(B, T, n, hd).transpose(1, 2).reshape(B * n, T, hd).contiguous()

    u = p["u"].float()[None].expand(B, hn, hd).reshape(B * hn, hd)
    if state is None:
        heads = [to_heads(t) for t in (r, k, v, lw)]
        if spmd.seq_axis() is not None:
            o, S = _scan_split(*heads, u, cfg)
        else:
            o, S = _scan(*heads, u, cfg)
        new_state = S.reshape(B, hn, hd, hd)
    else:
        # single-token recurrence (decode): T == 1, float32 decay and state;
        # a state the serving plan splits over heads runs its own heads, and
        # their outputs are gathered before the group norm
        heads, h0, hn = _state_heads(state, H)

        def local(t):                   # (B*H, hd) -> this rank's (B*hn, hd)
            return t.reshape(B, H, -1)[:, h0:h0 + hn].reshape(B * hn, -1)

        rh, kh, vh = (local(to_heads(t)[:, 0].float()) for t in (r, k, v))
        wh = local(torch.exp(to_heads(lw)[:, 0]))
        S = state.reshape(B * hn, hd, hd)
        kv = kh[:, :, None] * vh[:, None, :]
        o = torch.einsum("bi,bij->bj", rh, S + local(u)[:, :, None] * kv)[:, None, :]
        new_state = (wh[:, :, None] * S + kv).reshape(B, hn, hd, hd)
        o = o.to(x.dtype).reshape(B, hn, T, hd)
        if heads:
            o = spmd.gather_over(o, heads, 1)
        hn = H
    o = o.reshape(B, hn, T, hd).transpose(1, 2)
    # per-head group norm, population variance
    oh = o.float()
    mean = oh.mean(dim=-1, keepdim=True)
    var = oh.var(dim=-1, keepdim=True, unbiased=False)
    oh = (oh - mean) * torch.rsqrt(var + 64e-5)
    o = (oh.reshape(B, T, hn * hd) * p["ln_x"].float()).to(x.dtype)
    o = o * F.silu(g)
    out = _mm_out(o, p["wo"])
    return (out if axis is None else spmd.psum(out, axis)), (last, new_state)


def _state_heads(state: torch.Tensor, H: int):
    """(mesh axes, first head, heads) of the recurrent state this rank
    holds: all H heads, or under a serving plan that splits the state over
    ``q_heads`` its block of them."""
    split = spmd.cache_split(state)
    if split is None or not split.split_dims():
        return (), 0, H
    if set(split.split_dims()) != {"q_heads"}:
        raise NotImplementedError(
            f"a recurrent state split over {split.split_dims()} is not decoded: only a "
            f"split over q_heads is")
    h0, hn = split.block("q_heads")
    return split.mesh_axes_of("q_heads"), h0, hn


def channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *, shift_prev=None):
    """Returns (out, new_shift).  Under a step that left ``wk`` split over
    its local axis: ``wk`` column-parallel over the rank's ffn columns and
    ``wv`` row-parallel.  ``wr`` is named ``("embed", "q_heads")`` but its
    output gates ``wv``'s embed output elementwise, so the rank's ``wr``
    columns are a block of embed channels: the partial ``wv`` products are
    reduce-scattered to that block, gated there and the product gathered
    (the bytes of one all-reduce).  Under ``tp2d`` ``x`` is the rank's block
    of channels: ``wk`` is contracted over it and summed, ``wv`` produces
    the rank's block, and ``wr``'s partial products are reduce-scattered to
    that block to gate it."""
    axis = spmd.local_of(p["wk"])
    if axis is not None and not (spmd.local_of(p["wv"]) == axis == spmd.local_of(p["wr"])):
        p, axis = spmd.unsplit(p, _CM_SPLIT), None
    if axis is not None:
        x = spmd.enter(x, axis)
        p = dict(p, mix_k=spmd.enter(p["mix_k"], axis), mix_r=spmd.enter(p["mix_r"], axis))
    xp, last = _shifted(x, shift_prev)
    xk = x + (xp - x) * p["mix_k"].to(x.dtype)
    xr = x + (xp - x) * p["mix_r"].to(x.dtype)
    kk = torch.square(F.relu(_mm_in(xk, p["wk"])))
    e_ax = spmd.embed_of(p["wr"])
    if e_ax is not None:
        # wr's output gates the rank's embed block of wv's: the partial
        # products reduce-scattered to that block
        gate = torch.sigmoid(spmd.scatter_sum(_mm(xr, p["wr"]), e_ax, 2))
        return gate * _mm_out(kk, p["wv"]), last
    gate = torch.sigmoid(_mm(xr, p["wr"]))
    if axis is None:
        return gate * _mm(kk, p["wv"]), last
    out = gate * spmd.scatter_sum(_mm(kk, p["wv"]), axis, 2)
    return spmd.gather_alike(out, axis, 2), last


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                shift_tm=None, state=None, shift_cm=None):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    o, (new_shift_tm, new_state) = time_mix(p["tm"], h, cfg, shift_prev=shift_tm,
                                            state=state)
    x = x + o
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    o, new_shift_cm = channel_mix(p["cm"], h, cfg, shift_prev=shift_cm)
    return x + o, (new_shift_tm, new_state, new_shift_cm)


# ------------------------------------------------------------------- model
def _block_out(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return block_apply(p, x, cfg)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V); each block recomputed in the
    backward when ``cfg.remat`` (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``)."""
    x = L.embed(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = L.remat(cfg.remat, _block_out, transformer._layer(params, i), x, cfg)
    return transformer._head(params, x, cfg)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]``, as the reference's ``loss_fn``."""
    loss = L.softmax_xent(forward(params, batch["tokens"], cfg), batch["labels"])
    return loss, {"loss": loss}


# ----------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, Any]:
    """An empty recurrent cache: float32 state, shifts in the compute dtype
    (``max_len`` and ``dtype`` are taken for the API's signature and, as in
    the reference, change nothing).  ``index`` is a Python int."""
    H, hd = _n_heads(cfg), _head_dim(cfg)
    Lh, cdt = cfg.n_layers, L.cdtype(cfg)
    return {
        "state": torch.zeros((Lh, batch, H, hd, hd), dtype=torch.float32, device=device),
        "shift_tm": torch.zeros((Lh, batch, cfg.d_model), dtype=cdt, device=device),
        "shift_cm": torch.zeros((Lh, batch, cfg.d_model), dtype=cdt, device=device),
        "index": 0,
    }


def cache_logical_axes() -> Dict[str, Tuple]:
    """Logical axes of :func:`init_cache`'s leaves (the reference's)."""
    return {
        "state": ("layers", "batch", "q_heads", "head_dim", None),
        "shift_tm": ("layers", "batch", "embed"),
        "shift_cm": ("layers", "batch", "embed"),
        "index": (),
    }


def _store(cache: Dict[str, Any], i: int, carry) -> None:
    """Write layer ``i``'s (shift_tm, state, shift_cm) into the cache (the
    state's heads all, or this rank's: ``spmd.store``)."""
    shift_tm, state, shift_cm = carry
    spmd.store(cache["state"][i], state, "q_heads", 1)
    cache["shift_tm"][i] = shift_tm
    cache["shift_cm"][i] = shift_cm


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """O(1)-per-token decode: no KV cache, just the recurrent state, updated
    in place.  tokens: (B, 1)."""
    if tokens.shape[1] != 1:
        raise ValueError("decode_step takes one token per sequence; use prefill "
                         "for a prompt")
    spmd.require_whole(cache, ("shift_tm", "shift_cm"), cfg.name)
    x = L.embed(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        x, carry = L.remat(False, block_apply, transformer._layer(params, i), x, cfg,
                           shift_tm=cache["shift_tm"][i], state=cache["state"][i],
                           shift_cm=cache["shift_cm"][i])
        _store(cache, i, carry)
    return transformer._head(params, x, cfg), dict(cache, index=int(cache["index"]) + 1)


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Fill an empty cache with a whole prompt in one chunked pass per layer
    and return the last token's logits (B, 1, V).

    Each layer's state is the WKV scan's final state; its shifts are the last
    row of each sublayer's normalised input; the index is the prompt length.
    This equals feeding the prompt to :func:`decode_step` token by token, the
    reference's serving prefill (same state, shifts and last logits).  Under
    a serving step that splits the prompt, ``tokens`` are this rank's block
    and every rank stores the whole prompt's states and last rows."""
    if int(cache["index"]) != 0:
        raise ValueError(f"prefill fills an empty cache; this one holds "
                         f"{int(cache['index'])} tokens: the reference decodes rwkv6 one "
                         f"token at a time from its state (decode_step), with no "
                         f"multi-token pass into a state that holds tokens")
    x = L.embed(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        x, carry = L.remat(False, block_apply, transformer._layer(params, i), x, cfg)
        _store(cache, i, carry)
    return (L.whole_vocab(transformer._head(params, spmd.last_token(x), cfg)),
            dict(cache, index=spmd.seq_length(tokens.shape[1])))
