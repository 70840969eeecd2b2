"""seamless-m4t-medium backbone: an encoder-decoder transformer with a stubbed
audio frontend.

Counterpart of ``repro/models/encdec.py``.  The modality frontend is a stub:
the caller hands over precomputed frame embeddings (B, F, frontend_dim) and
a linear adapter projects them into the encoder's width.  Encoder blocks are
bidirectional; decoder blocks are causal self-attention, cross-attention to
the encoder memory and an MLP.  Serving projects the memory's cross K/V once
per request (:func:`prepare_cross`) and keeps them in the cache beside the
decoder's self-attention KV.  The cache is updated **in place**.  With
``cfg.remat`` every encoder and decoder block is recomputed in the backward.

Under a plan-sharded step that splits the sequence, the frames and the
decoder's tokens are both split over the one axis: the adapter, the norms
and the MLPs run on the rank's block, the encoder's bidirectional
self-attention and the decoder's cross-attention gather K and V over the
axis (every frame), the decoder's self-attention is causal with the rank's
query offset, and a prompt pass writes the rank's blocks of the caches.
Under ``tp2d`` every activation also holds the rank's block of ``embed``
(the adapter writes it, the K/V projections sum their partial products over
the blocks).  A prompt may go in as chunks: the first carries the frames,
the later ones run the decoder over the cross K/V the first cached.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import spmd
from . import layers as L
from .param import LeafSpec, stack_specs
from .transformer import _layer

Params = Dict[str, Any]


def enc_block_spec(cfg: ModelConfig) -> Params:
    return {
        "attn_norm": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "mlp_norm": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def dec_block_spec(cfg: ModelConfig) -> Params:
    return {
        "self_norm": L.rmsnorm_spec(cfg.d_model),
        "self_attn": L.attention_spec(cfg),
        "cross_norm": L.rmsnorm_spec(cfg.d_model),
        "cross_attn": L.attention_spec(cfg),
        "mlp_norm": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def encdec_spec(cfg: ModelConfig) -> Params:
    n_enc = cfg.n_encoder_layers or cfg.n_layers
    return {
        "frontend": {
            "w": LeafSpec((cfg.frontend_dim, cfg.d_model), ("frames", "embed")),
            "b": LeafSpec((cfg.d_model,), ("embed",), init="zeros"),
        },
        "embed": L.embedding_spec(cfg),                 # decoder text embed
        "enc_blocks": stack_specs(enc_block_spec(cfg), n_enc),
        "enc_norm": L.rmsnorm_spec(cfg.d_model),
        "dec_blocks": stack_specs(dec_block_spec(cfg), cfg.n_layers),
        "dec_norm": L.rmsnorm_spec(cfg.d_model),
        "lm_head": L.lm_head_spec(cfg),
    }


def _blocks(params: Params, name: str, i: int) -> Params:
    return _layer({"blocks": params[name]}, i)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, F, frontend_dim) -> encoder memory (B, F, d)."""
    dt = L.cdtype(cfg)
    x = frames.to(dt) @ params["frontend"]["w"].to(dt) + params["frontend"]["b"].to(dt)
    for i in range(cfg.n_encoder_layers or cfg.n_layers):
        x = L.remat(cfg.remat, _enc_block, _blocks(params, "enc_blocks", i), x, cfg)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _enc_block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    o, _ = L.attention(p["attn"], L.rmsnorm(p["attn_norm"], x, cfg.norm_eps), cfg,
                       causal=False)
    x = x + o
    return x + L.mlp(p["mlp"], L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)


def _dec_block(p: Params, x: torch.Tensor, memory: Optional[torch.Tensor],
               cfg: ModelConfig, *, kv_cache=None, cache_index=None, cross_kv=None):
    hn = L.rmsnorm(p["self_norm"], x, cfg.norm_eps)
    o, new_cache = L.attention(p["self_attn"], hn, cfg, causal=True,
                               kv_cache=kv_cache, cache_index=cache_index)
    x = x + o
    hn = L.rmsnorm(p["cross_norm"], x, cfg.norm_eps)
    if cross_kv is not None:
        o, _ = L.attention(p["cross_attn"], hn, cfg, precomputed_kv=cross_kv)
    else:
        o, _ = L.attention(p["cross_attn"], hn, cfg, kv_input=memory, causal=False)
    x = x + o
    hn = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], hn, cfg), new_cache


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return L.lm_head(params.get("lm_head", {}), x, cfg, embed_params=params["embed"])


def decode(params: Params, tokens: torch.Tensor, memory: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = L.remat(cfg.remat, _dec_block_out, _blocks(params, "dec_blocks", i), x, memory,
                    cfg)
    return _head(params, x, cfg)


def _dec_block_out(p: Params, x: torch.Tensor, memory: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    return _dec_block(p, x, memory, cfg)[0]


def forward(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, F, frontend_dim), tokens: (B, S) -> logits (B, S, V)."""
    return decode(params, tokens, encode(params, frames, cfg), cfg)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    logits = forward(params, batch["frames"], batch["tokens"], cfg)
    loss = L.softmax_xent(logits, batch["labels"])
    return loss, {"loss": loss}


# ----------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               memory_len: Optional[int] = None, device="cuda") -> Dict[str, Any]:
    """An empty cache: the decoder's self-attention KV of ``max_len`` keys
    and the cross K/V of ``memory_len`` memory positions (default the
    frontend's length) per layer; ``index`` is a Python int."""
    ml = memory_len or cfg.frontend_len or 1024
    self_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    cross_shape = (cfg.n_layers, batch, ml, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(self_shape, dtype=dtype, device=device),
        "v": torch.zeros(self_shape, dtype=dtype, device=device),
        "cross_k": torch.zeros(cross_shape, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross_shape, dtype=dtype, device=device),
        "index": 0,
    }


def prepare_cross(params: Params, memory: torch.Tensor, cfg: ModelConfig,
                  cache: Dict[str, Any]) -> Dict[str, Any]:
    """Project the encoder memory into every layer's cross K/V once per
    request, written into the cache in place (as the reference's, without
    the projection's bias).  Under a serving step whose plan splits the
    cross K/V (over ``kv_seq``, ``kv_heads``) the cache holds this rank's
    block of it."""
    return _project_cross(params, memory, cfg, cache)[0]


def _project_cross(params: Params, memory: torch.Tensor, cfg: ModelConfig,
                   cache: Dict[str, Any]) -> Tuple[Dict[str, Any], Optional[list]]:
    """:func:`prepare_cross`, and where the serving step's plan splits the
    cross K/V, every layer's whole (k, v) in the cache's dtype for the
    prompt pass that follows (None where the cache holds them whole, or
    where the step computes the rank's kv heads: the prompt pass then reads
    the cache, through the head-local cross-attention)."""
    length = spmd.cache_length(cache["cross_k"], 2)
    if spmd.seq_length(memory.shape[1]) != length:
        raise ValueError(f"a memory of {spmd.seq_length(memory.shape[1])} positions does not "
                         f"fit a cache made for {length}")
    split = spmd.cache_split(cache["cross_k"])
    blocks = {}
    if split is not None:
        for logical, dim in (("kv_seq", 1), ("kv_heads", 2)):
            if split.mesh_axes_of(logical):
                off, n = split.block(logical)
                blocks[dim] = slice(off, off + n)
    whole = [] if blocks else None
    for i in range(cfg.n_layers):
        p = spmd.for_use(_blocks(params, "dec_blocks", i)["cross_attn"])
        if spmd.local_of(p["wk"]) is not None:
            # head-local: the rank's kv heads, into the rank's block of a cache
            # split over kv_heads on the axis or gathered into a whole one; the
            # prompt pass reads the cache
            if 1 in blocks:
                raise NotImplementedError("a head-local prompt pass into a cross K/V cache "
                                          "split over kv_seq")
            for name, w in (("cross_k", p["wk"]), ("cross_v", p["wv"])):
                x = torch.einsum("bsd,dhk->bshk", memory, w.to(memory.dtype))
                spmd.store(cache[name][i], x, "kv_heads", 2)
            whole = None
            continue
        kv = []
        for name, w in (("cross_k", p["wk"]), ("cross_v", p["wv"])):
            # under a step that splits the sequence the memory is the rank's
            # block: its K/V gathered, whole for the prompt pass (under tp2d
            # the product over its embed block summed first)
            x = spmd.gather_seq(L._proj_in("bsd,dhk->bshk", memory, w), 1)
            if blocks:
                kv.append(x.to(cache[name].dtype))
                x = x[:, blocks.get(1, slice(None)), blocks.get(2, slice(None))]
            cache[name][i] = x
        if whole is not None:
            whole.append(tuple(kv))
    return dict(cache), whole


def _cached_pass(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                 cfg: ModelConfig, last_only: bool, cross: Optional[list] = None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The decoder over ``tokens`` against the cache; ``cross``: every
    layer's whole cross (k, v) where the cache holds only this rank's block
    (:func:`_project_cross`)."""
    idx, n = int(cache["index"]), spmd.seq_length(tokens.shape[1])
    length = spmd.cache_length(cache["k"], 2)
    if idx + n > length:
        raise ValueError(f"cache of {length} keys cannot take {n} more at index {idx}")
    x = L.embed(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        x, _ = L.remat(False, _dec_block, _blocks(params, "dec_blocks", i), x, None, cfg,
                       kv_cache=(cache["k"][i], cache["v"][i]), cache_index=idx,
                       cross_kv=(cache["cross_k"][i], cache["cross_v"][i]) if cross is None
                       else cross[i])
    if last_only:
        x = spmd.last_token(x)
    return L.whole_vocab(_head(params, x, cfg)), dict(cache, index=idx + n)


def cache_logical_axes() -> Dict[str, Tuple]:
    """Logical axes of :func:`init_cache`'s leaves (the reference's)."""
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax, "cross_k": ax, "cross_v": ax, "index": ()}


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder step against the cached self-attention KV and cross K/V.
    tokens: (B, 1); the cache is written in place."""
    if tokens.shape[1] != 1:
        raise ValueError("decode_step takes one token per sequence; use prefill "
                         "for a prompt")
    return _cached_pass(params, tokens, cache, cfg, last_only=False)


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig, *, frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode ``frames``, project the memory's cross K/V into the empty cache
    and run the decoder's causal prompt pass over ``tokens`` (self-attention
    written into the cache, cross-attention over the cached memory K/V).
    Returns the last token's logits (B, 1, V): with a float32 cache they
    equal the reference's ``forward`` at the last position.  A later chunk
    of the prompt (the cache's index > 0, no frames) runs the decoder only,
    over the cross K/V the first pass cached."""
    if int(cache["index"]) != 0:
        if frames is not None:
            raise ValueError(f"the frames go into an empty cache only, with the first pass; "
                             f"this one holds {int(cache['index'])} tokens (a later chunk "
                             f"runs the decoder alone)")
        return _cached_pass(params, tokens, cache, cfg, last_only=True)
    if frames is None:
        raise ValueError("the first pass into an empty cache carries the frames")
    cache, cross = _project_cross(params, encode(params, frames, cfg), cfg, cache)
    return _cached_pass(params, tokens, cache, cfg, last_only=True, cross=cross)
