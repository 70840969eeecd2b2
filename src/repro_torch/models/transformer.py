"""Dense decoder-only transformer (gemma-7b, qwen2.5-3b, llama3-405b,
deepseek-67b).

Pre-norm blocks, GQA + RoPE attention, SwiGLU/GeGLU MLP.  Layer parameters
are stacked along a leading ``layers`` dimension, as in the reference, and
executed by a Python loop over that dimension (the reference's
``jax.lax.scan``).  The serving cache is updated **in place**: ``decode_step``
and ``prefill`` write into the tensors of the cache they are given and return
a dict that shares them.  ``loss_fn`` arrives with training.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import layers as L
from .param import stack_specs, tree_map

Params = Dict[str, Any]


def block_spec(cfg: ModelConfig) -> Params:
    return {
        "attn_norm": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "mlp_norm": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def transformer_spec(cfg: ModelConfig) -> Params:
    spec: Params = {
        "embed": L.embedding_spec(cfg),
        "blocks": stack_specs(block_spec(cfg), cfg.n_layers),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    spec.update({"lm_head": L.lm_head_spec(cfg)})
    return spec


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                kv_cache=None, cache_index=None, causal: bool = True):
    h = L.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    attn_out, new_cache = L.attention(p["attn"], h, cfg, causal=causal,
                                      kv_cache=kv_cache,
                                      cache_index=cache_index)
    x = x + attn_out
    h = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    x = x + L.mlp(p["mlp"], h, cfg)
    return x, new_cache


def _layer(params: Params, i: int) -> Params:
    """Layer ``i`` of the stacked block parameters (views, no copy)."""
    return tree_map(lambda w: w[i], params["blocks"],
                    is_leaf=lambda x: isinstance(x, torch.Tensor))


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, cfg)
    if cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)        # gemma embedding scaling
    return x


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(params.get("lm_head", {}), x, cfg,
                     embed_params=params["embed"])


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V)."""
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x, _ = block_apply(_layer(params, i), x, cfg)
    return _head(params, x, cfg)


# ----------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """An empty KV cache.  ``index`` is a Python int (the number of valid
    keys), so reading it never waits for the device."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def _cached_pass(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                 cfg: ModelConfig, last_only: bool, block=block_apply
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run ``tokens`` through every layer's ``block`` against the cache,
    writing their keys and values at its index.  ``block`` is
    :func:`block_apply`'s signature and returns ``(x, new_kv)``."""
    x = _embed(params, tokens, cfg)
    idx = int(cache["index"])
    if idx + tokens.shape[1] > cache["k"].shape[2]:
        raise ValueError(f"cache of {cache['k'].shape[2]} keys cannot take "
                         f"{tokens.shape[1]} more at index {idx}")
    for i in range(cfg.n_layers):
        x, _ = block(_layer(params, i), x, cfg,
                     kv_cache=(cache["k"][i], cache["v"][i]), cache_index=idx)
    if last_only:
        x = x[:, -1:]
    logits = _head(params, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "index": idx + tokens.shape[1]}


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1); cache k/v: (L, B, T, nkv, hd),
    written in place."""
    if tokens.shape[1] != 1:
        raise ValueError("decode_step takes one token per sequence; use prefill "
                         "for a prompt")
    return _cached_pass(params, tokens, cache, cfg, last_only=False)


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Fill an empty cache with a full prompt in one causal pass and return
    the last token's logits (B, 1, V).

    This equals feeding the prompt to :func:`decode_step` token by token
    (same cache contents, same last-token logits).  It deliberately does
    *not* copy the reference's ``prefill``, which is not causal inside the
    prompt."""
    return _cached_pass(params, tokens, cache, cfg, last_only=True)
