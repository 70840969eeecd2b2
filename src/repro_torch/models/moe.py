"""Mixture-of-Experts transformer (qwen3-moe-30b-a3b, deepseek-moe-16b).

Sort-based capacity dispatch, as in the reference:

1. router softmax -> top-k experts/weights per token;
2. flatten (token, slot) pairs, sort them by expert id (stably);
3. rank-in-expert via sorted position minus group offset; drop beyond
   capacity;
4. write the kept rows into the dense (E, cap, d) buffer, run the grouped
   expert FFN (``kernels.ops.grouped_matmul`` with ``cfg.kernels ==
   "cuda"``, einsum otherwise), sum each token's rows back with the gate
   weights.

Nothing here reads a device value back to the host (counts come from a
fixed-length ``scatter_add_``, never from ``torch.bincount``), and no
floating-point sum depends on the order of atomics, so a run on the card is
deterministic.  The serving cache is the dense family's
(``transformer.init_cache``).  DeepSeekMoE's
``n_shared_experts`` dense experts and the Switch-style load-balancing loss
are honoured.

Capacity depends on how many tokens go through together
(:func:`_capacity`), so a pass over a whole prompt can drop tokens that the
same prompt fed token by token would keep.  :func:`prefill` is defined as the
reference's ``moe.forward`` over the prompt, not as the token-by-token loop.

Only the single-device path is ported.  The reference's expert-parallel
``shard_map`` branch (``_ep_axes``) waits for ``parallel/sharding``
(ROADMAP.md, Queue 1); :func:`_dispatch_ffn_combine` keeps its expert-slice
arguments for it.  ``loss_fn`` arrives with training.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import moe_gmm, ops
from . import layers as L
from . import transformer
from .param import LeafSpec, stack_specs

Params = Dict[str, Any]


def moe_mlp_spec(cfg: ModelConfig) -> Params:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    spec: Params = {
        "router": LeafSpec((d, E), ("embed", "experts")),
        "w_gate": LeafSpec((E, d, f), ("experts", "embed", "ffn")),
        "w_up": LeafSpec((E, d, f), ("experts", "embed", "ffn")),
        "w_down": LeafSpec((E, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.n_shared_experts:
        spec["shared"] = L.mlp_spec(cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return spec


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(math.ceil(tokens * cfg.experts_per_token * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)      # round up to a multiple of 8


def _dispatch_ffn_combine(xf: torch.Tensor, p_gate, p_up, p_down,
                          gate_vals: torch.Tensor, expert_idx: torch.Tensor,
                          cfg: ModelConfig, e_lo: int, n_local: int,
                          cap: int) -> torch.Tensor:
    """Sort-based dispatch -> grouped FFN -> weighted combine, for the expert
    slice ``[e_lo, e_lo + n_local)`` over tokens ``xf`` (T, d)."""
    T, d = xf.shape
    k = expert_idx.shape[-1]
    dev = xf.device
    e_flat = expert_idx.reshape(T * k).long()
    w_flat = gate_vals.reshape(T * k)
    tok_flat = torch.arange(T * k, device=dev) // k
    local = e_flat - e_lo                                     # local slot id
    in_range = (local >= 0) & (local < n_local)
    local_c = torch.where(in_range, local, n_local)           # park OOR at end
    order = torch.argsort(local_c, stable=True)
    se = local_c[order]
    st = tok_flat[order]
    sw = w_flat[order]
    counts = torch.zeros(n_local + 1, dtype=torch.long, device=dev).scatter_add_(
        0, local_c, torch.ones_like(local_c))[:n_local]
    starts = torch.cumsum(counts, 0) - counts                 # (n_local,)
    se_c = torch.clamp(se, max=n_local - 1)
    rank = torch.arange(T * k, device=dev) - starts[se_c]
    keep = (se < n_local) & (rank >= 0) & (rank < cap)
    rank_c = torch.where(keep, rank, 0)

    # The kept (expert, rank) pairs are unique, so writing them is the
    # reference's scatter-add; every dropped row goes to one spare row that
    # is cut off again.
    slot = torch.where(keep, se_c * cap + rank_c, n_local * cap)
    buf = torch.zeros(n_local * cap + 1, d, dtype=xf.dtype, device=dev)
    buf[slot] = xf[st]
    xe = buf[:-1].view(n_local, cap, d)

    act = (lambda g: F.gelu(g, approximate="tanh")) if cfg.mlp_activation == "gelu" \
        else F.silu
    wg, wu, wd = (w.to(xf.dtype) for w in (p_gate, p_up, p_down))
    # the plain products are float32 sums rounded once to the compute dtype,
    # as XLA's default precision does for the reference (cuBLAS may reduce
    # bf16 partial sums in bf16)
    mm = ops.grouped_matmul if cfg.kernels == "cuda" else moe_gmm.grouped_matmul_plain
    g = mm(xe, wg)
    u = mm(xe, wu)
    ye = mm(act(g) * u, wd)

    # The combine: each token's k weighted expert rows, put back in (token,
    # slot) order and summed.  The reference scatter-adds them in the compute
    # dtype; this is the same sum without atomics, so it does not change from
    # run to run on the card.
    gathered = ye[se_c, rank_c] * torch.where(keep, sw, 0.0)[:, None].to(xf.dtype)
    per_slot = torch.empty_like(gathered)
    per_slot[order] = gathered
    return per_slot.view(T, k, d).sum(dim=1)


def _router(xf: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    logits = torch.einsum("td,de->te", xf, router_w.to(xf.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    # load-balancing auxiliary loss (Switch-style)
    E = cfg.n_experts
    me = torch.mean(probs, dim=0)
    chosen = torch.zeros_like(probs).scatter_add_(1, expert_idx,
                                                  torch.ones_like(gate_vals))
    ce = torch.mean(chosen, dim=0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_weight
    return gate_vals, expert_idx, aux


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss), all B * S tokens dispatched together
    with capacity ``_capacity(B * S)``."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gate_vals, expert_idx, aux = _router(xf, p["router"], cfg)
    yf = _dispatch_ffn_combine(xf, p["w_gate"], p["w_up"], p["w_down"], gate_vals,
                               expert_idx, cfg, 0, cfg.n_experts,
                               _capacity(B * S, cfg))
    y = yf.reshape(B, S, d)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x, cfg)
    return y, aux


# ------------------------------------------------------------------- model
def moe_block_spec(cfg: ModelConfig) -> Params:
    return {
        "attn_norm": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "mlp_norm": L.rmsnorm_spec(cfg.d_model),
        "moe": moe_mlp_spec(cfg),
    }


def moe_spec(cfg: ModelConfig) -> Params:
    return {
        "embed": L.embedding_spec(cfg),
        "blocks": stack_specs(moe_block_spec(cfg), cfg.n_layers),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "lm_head": L.lm_head_spec(cfg),
    }


def _moe_block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     kv_cache=None, cache_index=None):
    h = L.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    attn_out, new_cache = L.attention(p["attn"], h, cfg, causal=True,
                                      kv_cache=kv_cache, cache_index=cache_index)
    x = x + attn_out
    h = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    y, aux = moe_mlp(p["moe"], h, cfg)
    return x + y, aux, new_cache


def _serve_block(p: Params, x: torch.Tensor, cfg: ModelConfig, **cache_args):
    """:func:`_moe_block_apply` without the aux loss, for the cached passes."""
    x, _, new_cache = _moe_block_apply(p, x, cfg, **cache_args)
    return x, new_cache


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V), total aux loss)."""
    x = L.embed(params["embed"], tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a, _ = _moe_block_apply(transformer._layer(params, i), x, cfg)
        aux = aux + a
    return transformer._head(params, x, cfg), aux


# ----------------------------------------------------------------- serving
def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1); cache k/v: (L, B, T, nkv, hd),
    written in place.  The B tokens are dispatched together with capacity
    ``_capacity(B)``."""
    if tokens.shape[1] != 1:
        raise ValueError("decode_step takes one token per sequence; use prefill "
                         "for a prompt")
    return transformer._cached_pass(params, tokens, cache, cfg, last_only=False,
                                    block=_serve_block)


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Fill an empty cache with a full prompt in one causal pass and return
    the last token's logits (B, 1, V).

    Every layer dispatches all B * S prompt tokens together, with capacity
    ``_capacity(B * S)``, exactly as the reference's ``moe.forward`` does, so
    the logits equal ``forward(tokens)[0][:, -1:]``.  Where that capacity
    drops tokens, they differ from feeding the prompt to :func:`decode_step`
    token by token (capacity ``_capacity(B)``, which drops nothing at
    B <= 8)."""
    return transformer._cached_pass(params, tokens, cache, cfg, last_only=True,
                                    block=_serve_block)
