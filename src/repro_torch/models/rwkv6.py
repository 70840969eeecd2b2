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
def wkv6_chunked(r, k, v, log_w, u, chunk: int = WKV_CHUNK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``wkv6_chunked_jnp``: the kernel's chunked math in plain
    PyTorch, returning (o, final state).  Shapes as in ``kernels.rwkv6.wkv6``;
    like the reference, ``min(chunk, T)`` must divide T."""
    return _rwkv.wkv6_plain(r, k, v, log_w, u, chunk=chunk)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift sequence right by one; ``prev`` supplies the carry for decode."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("btd,df->btf", x, w.to(x.dtype))


def time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *, shift_prev=None, state=None):
    """Returns (out, (new_shift, new_state)).  ``state``: (B,H,hd,hd) for
    single-token decode; None for a chunked pass from a zero state, whose
    final state is returned (the reference returns None there)."""
    B, T, d = x.shape
    H, hd = _n_heads(cfg), _head_dim(cfg)
    xp = _token_shift(x, shift_prev)

    def mixed(name):
        return x + (xp - x) * p[f"mix_{name}"].to(x.dtype)

    xr, xk, xv, xw, xg = (mixed(n) for n in "rkvwg")
    r, k, v, g = _mm(xr, p["wr"]), _mm(xk, p["wk"]), _mm(xv, p["wv"]), _mm(xg, p["wg"])
    lw = -torch.exp(p["w0"].float()
                    + torch.tanh(xw.float() @ p["wA"].float()) @ p["wB"].float())
    # decay floor: keeps the chunked kernels' midpoint-offset factors in f32
    # range; applied at the source so every WKV path sees the same decays
    lw = torch.clamp(lw, min=-4.0)

    def to_heads(t):                    # (B,T,d) -> (B*H, T, hd), contiguous
        return t.reshape(B, T, H, hd).transpose(1, 2).reshape(B * H, T, hd).contiguous()

    u = p["u"].float()[None].expand(B, H, hd).reshape(B * H, hd)
    if state is None:
        if cfg.kernels == "cuda":
            # the reference's kernel path casts the decay and the bonus to the
            # compute dtype before the kernel; mirrored, not fixed
            o, S = ops.wkv6(to_heads(r), to_heads(k), to_heads(v),
                            to_heads(lw.to(x.dtype)), u.to(x.dtype),
                            chunk=WKV_CHUNK)
        else:
            o, S = wkv6_chunked(to_heads(r), to_heads(k), to_heads(v), to_heads(lw), u)
        new_state = S.reshape(B, H, hd, hd)
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
    o = o.reshape(B, H, T, hd).transpose(1, 2)
    # per-head group norm, population variance
    oh = o.float()
    mean = oh.mean(dim=-1, keepdim=True)
    var = oh.var(dim=-1, keepdim=True, unbiased=False)
    oh = (oh - mean) * torch.rsqrt(var + 64e-5)
    o = (oh.reshape(B, T, d) * p["ln_x"].float()).to(x.dtype)
    o = o * F.silu(g)
    return _mm(o, p["wo"]), (x[:, -1], new_state)


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
    xp = _token_shift(x, shift_prev)
    xk = x + (xp - x) * p["mix_k"].to(x.dtype)
    xr = x + (xp - x) * p["mix_r"].to(x.dtype)
    kk = torch.square(F.relu(_mm(xk, p["wk"])))
    return torch.sigmoid(_mm(xr, p["wr"])) * _mm(kk, p["wv"]), x[:, -1]


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
    """Write layer ``i``'s (shift_tm, state, shift_cm) into the cache."""
    shift_tm, state, shift_cm = carry
    cache["state"][i] = state
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
    reference's serving prefill (same state, shifts and last logits)."""
    if int(cache["index"]) != 0:
        raise ValueError(f"prefill fills an empty cache; this one holds "
                         f"{int(cache['index'])} tokens")
    x = L.embed(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        x, carry = block_apply(transformer._layer(params, i), x, cfg)
        _store(cache, i, carry)
    return transformer._head(params, x[:, -1:], cfg), dict(cache, index=tokens.shape[1])
