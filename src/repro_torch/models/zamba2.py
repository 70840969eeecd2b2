"""Zamba2 hybrid: a Mamba2 backbone with a *shared* attention block applied
after every ``attn_every`` SSM layers (zamba2-1.2b).

Counterpart of ``repro/models/zamba2.py``.  One attention block's parameters
are reused at every application site, never copied per site; the Mamba2
layers are stacked ``(G, A, ...)`` (G groups of ``attn_every`` layers, one
site after each group) and walked by a Python loop.  During decode each site
has its own KV slot ``(G, B, T, nkv, hd)``.  The serving cache is updated
**in place**, as the other families' are.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import spmd
from . import layers as L
from .mamba2 import dims as mamba_dims, mamba2_apply, mamba2_spec
from .param import stack_specs, tree_map
from .transformer import _head

Params = Dict[str, Any]


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    a = cfg.attn_every or cfg.n_layers
    if cfg.n_layers % a:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} must be divisible by "
                         f"attn_every={a}")
    return cfg.n_layers // a, a


def zamba2_spec(cfg: ModelConfig) -> Params:
    G, A = _groups(cfg)
    mamba_block = {
        "norm": L.rmsnorm_spec(cfg.d_model),
        "mamba": mamba2_spec(cfg),
    }
    return {
        "embed": L.embedding_spec(cfg),
        # stacked (G, A, ...), as the reference's nested scan reads them
        "blocks": stack_specs(stack_specs(mamba_block, A, "layers"), G, "layers"),
        "shared_attn": {
            "norm": L.rmsnorm_spec(cfg.d_model),
            "attn": L.attention_spec(cfg),
            "mlp_norm": L.rmsnorm_spec(cfg.d_model),
            "mlp": L.mlp_spec(cfg),
        },
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "lm_head": L.lm_head_spec(cfg),
    }


def _shared_attn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                       kv_cache=None, cache_index=None):
    h = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    o, new_cache = L.attention(p["attn"], h, cfg, causal=True,
                               kv_cache=kv_cache, cache_index=cache_index)
    x = x + o
    h = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg), new_cache


def _mamba_layer(params: Params, g: int, a: int) -> Params:
    """Mamba2 layer ``a`` of group ``g`` (views, no copy)."""
    return tree_map(lambda w: w[g, a], params["blocks"],
                    is_leaf=lambda x: isinstance(x, torch.Tensor))


def _mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig, **state):
    o, new_state = mamba2_apply(p["mamba"], L.rmsnorm(p["norm"], x, cfg.norm_eps), cfg,
                                **state)
    return x + o, new_state


def _group(params: Params, g: int, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Group ``g``: its Mamba2 layers, then the shared attention block."""
    for a in range(_groups(cfg)[1]):
        x, _ = _mamba_block(_mamba_layer(params, g, a), x, cfg)
    return _shared_attn_apply(params["shared_attn"], x, cfg)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V).  With ``cfg.remat`` each group is
    recomputed in the backward, as the reference checkpoints its group
    body."""
    x = L.embed(params["embed"], tokens, cfg)
    for g in range(_groups(cfg)[0]):
        x = L.remat(cfg.remat, _group, params, g, x, cfg)
    return _head(params, x, cfg)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    loss = L.softmax_xent(forward(params, batch["tokens"], cfg), batch["labels"])
    return loss, {"loss": loss}


# ----------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, Any]:
    """An empty cache: the SSD states in float32, the conv states and one KV
    slot per attention site in ``dtype``; ``index`` is a Python int."""
    G, A = _groups(cfg)
    d_inner, H, dh, ds = mamba_dims(cfg)
    conv_dim = d_inner + 2 * ds
    kv = (G, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "ssd": torch.zeros((G, A, batch, H, dh, ds), dtype=torch.float32, device=device),
        "conv": torch.zeros((G, A, batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype,
                            device=device),
        "attn_k": torch.zeros(kv, dtype=dtype, device=device),
        "attn_v": torch.zeros(kv, dtype=dtype, device=device),
        "index": 0,
    }


def _cached_pass(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                 cfg: ModelConfig, prompt: bool) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Every layer against the cache, its states and KV slots written in
    place.  A prompt pass runs each Mamba2 layer's chunked scan from zero
    and stores the pair it ends with; a decode step runs the single-token
    recurrence from the stored pair."""
    G, A = _groups(cfg)
    idx, n = int(cache["index"]), spmd.seq_length(tokens.shape[1])
    length = spmd.cache_length(cache["attn_k"], 2)
    if idx + n > length:
        raise ValueError(f"cache of {length} keys cannot take {n} more at index {idx}")
    x = L.embed(params["embed"], tokens, cfg)
    for g in range(G):
        for a in range(A):
            state = {"carry": True} if prompt else {"ssd_state": cache["ssd"][g, a],
                                                    "conv_state": cache["conv"][g, a]}
            x, (ssd, conv) = L.remat(False, _mamba_block, _mamba_layer(params, g, a), x,
                                     cfg, **state)
            spmd.store(cache["ssd"][g, a], ssd, "ssm_heads", 1)
            spmd.store(cache["conv"][g, a], conv, "ffn", 2)
        x, _ = L.remat(False, _shared_attn_apply, params["shared_attn"], x, cfg,
                       kv_cache=(cache["attn_k"][g], cache["attn_v"][g]), cache_index=idx)
    if prompt:
        x = spmd.last_token(x)
    return L.whole_vocab(_head(params, x, cfg)), dict(cache, index=idx + n)


def cache_logical_axes() -> Dict[str, Tuple]:
    """Logical axes of :func:`init_cache`'s leaves (the reference's)."""
    return {
        "ssd": ("layers", None, "batch", "ssm_heads", None, None),
        "conv": ("layers", None, "batch", None, "ffn"),
        "attn_k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "attn_v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "index": (),
    }


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1); the cache is written in place."""
    if tokens.shape[1] != 1:
        raise ValueError("decode_step takes one token per sequence; use prefill "
                         "for a prompt")
    return _cached_pass(params, tokens, cache, cfg, prompt=False)


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Fill an empty cache with a whole prompt in one pass and return the
    last token's logits (B, 1, V).

    Every Mamba2 layer runs the chunked scan and stores its final (ssd,
    conv) pair; every attention site writes its own KV slot through the
    cached prompt pass.  This equals feeding the prompt to
    :func:`decode_step` token by token, the reference's serving prefill
    (same states, KV contents and last logits).  The prompt's length must be
    a multiple of the scan's chunk (32) or at most 32, as the reference's
    ``ssd_chunked`` requires; under a serving step that splits the prompt,
    so must each rank's block of it, and every rank stores the whole
    prompt's states."""
    if int(cache["index"]) != 0:
        raise ValueError(f"prefill fills an empty cache; this one holds "
                         f"{int(cache['index'])} tokens: the reference decodes zamba2 one "
                         f"token at a time from its state (decode_step), with no "
                         f"multi-token pass into a state that holds tokens")
    return _cached_pass(params, tokens, cache, cfg, prompt=True)
