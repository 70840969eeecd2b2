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

Two execution paths, as in the reference's ``moe_mlp``:

* **expert-parallel** (a plan-sharded train step whose plan maps
  ``experts`` to one mesh axis, :func:`_ep_axes`): each rank holds only its
  ``E / ep`` experts (the step keeps the grouped expert weights sharded along
  that axis), routes its own tokens with capacity ``_capacity`` of the local
  token count, runs :func:`_dispatch_ffn_combine` for its expert slice and
  sums the partial outputs over the expert axis (``spmd.psum``); the
  load-balancing loss is averaged over it (``spmd.pmean``).  Its average
  over the batch axes is the step's: each rank's loss is its local mean,
  and the step averages losses and gradients over the batch shards.  Where
  the step also splits the sequence over the expert axis (``zero3_sp``),
  the rank gathers its data shard's whole sequence first, as the
  reference's ``shard_map`` sees it, and reduce-scatters the summed output
  back to its block;
* **single-shard** (serving, tests, a step whose plan does not map the
  experts): the same dispatch over all ``E`` experts, on the global batch
  as the reference computes it.  A plan-sharded step whose ranks hold
  blocks of the tokens (over the batch axes, the sequence axis or both)
  gathers no token: each rank routes its own, the ranks exchange their
  per-row, per-expert pair counts (``spmd.gather_counts``), and each pair's
  position in its expert's global queue (the reference's one stable sort
  in ``b * S + s`` order) is its rank among the block's own pairs plus the
  pairs of every earlier row and of the earlier blocks of its own row
  (:func:`_queue_offsets`).  The rank runs K4 on a buffer of
  ``min(cap, tokens)`` rows an expert and combines its own tokens; the
  load-balancing loss takes the global means (:func:`_balance_loss`).

:func:`loss_fn` is the reference's: cross-entropy plus the
load-balancing loss, which reaches the router only through the mean router
probabilities (the chosen-expert share is a count).  With ``cfg.remat`` each
block is recomputed in the backward, its router and expert products too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import moe_gmm, ops
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import constrain
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
                          cap: int, base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sort-based dispatch -> grouped FFN -> weighted combine, for the expert
    slice ``[e_lo, e_lo + n_local)`` over tokens ``xf`` (T, d).

    ``base`` (T * k pairs, in (token, slot) order): where these tokens are
    a block of a larger dispatch (:func:`_queue_offsets`), each pair's
    number of pairs of its expert ahead of the block's own in the global
    queue; a pair is kept when that plus its rank among the block's own is
    below ``cap``, and the buffer holds ``min(cap, T)`` rows an expert (a
    token sends at most one pair to an expert, and the kept pairs of an
    expert are the first of the block's)."""
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
    rows = cap if base is None else min(cap, T)
    pos = rank if base is None else rank + base[order]
    keep = (se < n_local) & (rank >= 0) & (rank < rows) & (pos < cap)
    rank_c = torch.where(keep, rank, 0)
    if DISPATCH_TRACE is not None:
        kept = torch.zeros(n_local + 1, dtype=torch.long, device=dev).scatter_add_(
            0, torch.where(keep, se_c, n_local), torch.ones_like(se_c))[:n_local]
        pairs = torch.empty_like(keep)
        pairs[order] = keep
        DISPATCH_TRACE.append({"routed": counts, "kept": kept, "buffer": (n_local, rows, d),
                               "keep": pairs.view(T, k)})

    # The kept (expert, rank) pairs are unique, so writing them is the
    # reference's scatter-add; every dropped row goes to one spare row that
    # is cut off again.
    slot = torch.where(keep, se_c * rows + rank_c, n_local * rows)
    buf = torch.zeros(n_local * rows + 1, d, dtype=xf.dtype, device=dev)
    buf[slot] = xf[st]
    xe = buf[:-1].view(n_local, rows, d)

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
    chosen = torch.zeros_like(probs).scatter_add_(1, expert_idx,
                                                  torch.ones_like(gate_vals))
    return gate_vals, expert_idx, _balance_loss(probs, chosen, cfg)


def _balance_loss(probs: torch.Tensor, chosen: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The Switch-style load-balancing loss ``E sum_e me_e ce_e`` of the mean
    router probability and the mean chosen share of each expert.  Where the
    single-shard dispatch of a plan-sharded step takes a block of the
    tokens (:func:`_shared_axes`), the means are the global batch's: each
    rank's sums (and token count) are summed over the ranks that hold the
    other blocks before the product, and every rank adds the same loss to
    its share of the step's (``spmd.psum_shared``: each rank's
    probabilities get the gradient of every rank's share)."""
    E = cfg.n_experts
    axes = _shared_axes(cfg)
    if axes is None:
        me, ce = torch.mean(probs, dim=0), torch.mean(chosen, dim=0)
    else:
        sums = spmd.psum_shared(torch.stack([probs.sum(dim=0), chosen.sum(dim=0)]), axes)
        me, ce = sums / (probs.shape[0] * spmd.current().loss_shards)
    return E * torch.sum(me * ce) * cfg.router_aux_weight


# (e_lo, n_local) of every expert-parallel dispatch, in call order, when a
# caller sets it to a list (the tests and chip_smoke.py's mesh_train read it)
EP_TRACE = None
# for every dispatch, in call order, when a caller sets it to a list: the
# pairs routed to and kept by each expert of its slice, the buffer's shape and
# which (token, slot) pairs were kept
DISPATCH_TRACE = None


def _ep_axes(cfg: ModelConfig):
    """The expert mesh axis of the running plan-sharded step, when the
    expert-parallel path applies to ``cfg`` (the plan maps ``experts`` to
    one axis of the mesh that divides ``n_experts``, and the batch is split
    over the plan's batch axes), else None."""
    step = spmd.current()
    if step is None or step.expert_axis is None:
        return None
    if cfg.n_experts % step.mesh.shape[step.expert_axis]:
        return None
    return step.expert_axis


def _shared_axes(cfg: ModelConfig):
    """The mesh axes over which the single-shard dispatch of the running
    plan-sharded step holds only a block of the tokens (the batch's and
    the sequence's), when it takes that path for ``cfg`` and they hold more
    than one rank; else None."""
    step = spmd.current()
    if step is None or step.reduce_group is None or _ep_axes(cfg) is not None:
        return None
    return step.reduce_axes


def _queue_offsets(expert_idx: torch.Tensor, rows: int, cfg: ModelConfig) -> torch.Tensor:
    """For this rank's tokens, ``rows`` rows of a block of the sequence
    each, the offset of each (token, slot) pair's position in its expert's
    queue of the global dispatch over its position among this block's own
    pairs of that expert: every rank counts, per row and expert, the pairs
    it routed there (``scatter_add_``, so the host never waits), the counts
    are gathered over the batch and sequence axes
    (``spmd.gather_counts``), and the pairs ahead of this block's in the
    global order (``b * S + s``) are those of every earlier row and of the
    earlier ranks' blocks of its own row.  The counts come from ``T * k``
    ints, never the tokens."""
    E, T = cfg.n_experts, expert_idx.shape[0]
    e = expert_idx.long()
    row = (torch.arange(T, device=e.device) // (T // rows))[:, None].expand_as(e)
    flat = (row * E + e).reshape(-1)
    counts = torch.zeros(rows * E, dtype=torch.int32, device=e.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32)).view(rows, E)
    every = spmd.gather_counts(counts).long()                 # (B_g, R, E)
    r = spmd.axis_index(spmd.seq_axis()) if spmd.seq_axis() else 0
    per_row = every.sum(dim=1)
    ahead = torch.cumsum(per_row, 0) - per_row                # earlier rows, every rank
    g0 = spmd.batch_row0(rows)
    ahead = ahead[g0:g0 + rows] + (every[g0:g0 + rows, :r].sum(dim=1))
    own = counts.long()
    ahead = ahead - (torch.cumsum(own, 0) - own)              # what the local sort counts
    return ahead.view(-1)[flat]


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Outside the expert-parallel path all
    B * S tokens are dispatched together with capacity ``_capacity(B * S)``;
    under a plan-sharded step whose ranks hold blocks of the batch or of the
    sequence, with the global batch's capacity, queue order and
    load-balancing loss (:func:`_queue_offsets`, :func:`_balance_loss`).

    The expert-parallel path under a step that splits the sequence over the
    expert axis (``zero3_sp``) gathers the rank's data shard's whole
    sequence (``spmd.gather_seq``: its backward reduce-scatters), routes it
    as the reference's ``shard_map`` does, and reduce-scatters the partial
    outputs back to the rank's block (``spmd.scatter_sum``)."""
    B, S, d = x.shape
    e_ax = _ep_axes(cfg)
    if e_ax is not None:
        step = spmd.current()
        seq = step.seq_axis
        if seq is not None and seq != e_ax:
            raise NotImplementedError(f"the sequence split over {seq!r} and the experts over "
                                      f"{e_ax!r}: only one axis for both")
        ep = step.mesh.shape[e_ax]
        n_local = cfg.n_experts // ep
        e_lo = step.mesh.coords()[e_ax] * n_local
        if EP_TRACE is not None:
            EP_TRACE.append((e_lo, n_local))
        if seq is not None:
            # the data shard's whole sequence: the ranks' gradients of it are
            # summed by the gather's backward, the router's by the step's
            xs = spmd.gather_seq(x, 1)
            xf, router_w = xs.reshape(-1, d), p["router"]
        else:
            xs = x
            xf, router_w = spmd.enter(x.reshape(B * S, d), e_ax), spmd.enter(p["router"], e_ax)
        gate_vals, expert_idx, aux = _router(xf, router_w, cfg)
        yf = _dispatch_ffn_combine(xf, p["w_gate"], p["w_up"], p["w_down"], gate_vals,
                                   expert_idx, cfg, e_lo, n_local, _capacity(xf.shape[0], cfg))
        if seq is not None:
            y = spmd.scatter_sum(yf.view(xs.shape), e_ax, 1)
            # every rank along the axis adds the same aux to its share
            aux = spmd.psum_shared(aux, (e_ax,), 1.0 / ep)
        else:
            y = spmd.psum(yf, e_ax).reshape(B, S, d)
            aux = spmd.pmean(aux, e_ax)
    else:
        xf = x.reshape(B * S, d)
        gate_vals, expert_idx, aux = _router(xf, p["router"], cfg)
        base = None
        if _shared_axes(cfg) is not None:
            base = _queue_offsets(expert_idx, B, cfg)
        tokens = B * spmd.current().loss_shards * S if base is not None else B * S
        yf = _dispatch_ffn_combine(xf, p["w_gate"], p["w_up"], p["w_down"], gate_vals,
                                   expert_idx, cfg, 0, cfg.n_experts,
                                   _capacity(tokens, cfg), base)
        y = yf.reshape(B, S, d)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x, cfg)
    return constrain(y, ("batch", "seq", "embed")), aux


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


def _train_block(p: Params, x: torch.Tensor, cfg: ModelConfig):
    x, aux, _ = _moe_block_apply(p, x, cfg)
    return x, aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V), total aux loss)."""
    x = L.embed(params["embed"], tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = L.remat(cfg.remat, _train_block, transformer._layer(params, i), x, cfg)
        aux = aux + a
    return transformer._head(params, x, cfg), aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy + the load-balancing loss; the metrics hold both."""
    logits, aux = forward(params, batch["tokens"], cfg)
    xent = L.softmax_xent(logits, batch["labels"])
    return xent + aux, {"loss": xent, "aux_loss": aux}


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
