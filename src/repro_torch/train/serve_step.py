"""Serve-step builder: batched single-token decode with a sharded KV cache
(or recurrent state).

Counterpart of ``repro/train/serve_step.py``, with its names and arguments:
:func:`make_serve_step`, :func:`param_shardings`, :func:`cache_shardings`
and :func:`jit_serve_step`, the object the dry run's ``decode_*`` cells
run.  The reference hands the step to ``jax.jit`` with plan-derived
shardings and cache donation.  The port compiles nothing: every rank runs
the same eager step on its own part of the parameters, the tokens and the
cache (``parallel/spmd.py``):

* each parameter is gathered where its layer runs, as in a plan-sharded
  train step;
* a cache leaf split over ``kv_seq`` is decoded by its own ranks over
  their own keys (K3's partials kernel), the partials gathered over those
  ranks and folded by K3' (``models/layers.py``); only the rank that holds
  the new position writes the new key and value;
* a cache leaf split over heads (``kv_heads``; rwkv6's state over
  ``q_heads``, zamba2's SSD state over ``ssm_heads``) is decoded over the
  local heads and the heads' outputs are gathered; zamba2's conv state
  split over its channels (``ffn``) convolves the local channels and
  gathers the result; no cache leaf is ever gathered whole;
* the logits come back whole on every rank (the reference's
  ``out_shardings=(None, c_sh)``) and the cache as this rank's slice,
  updated in place (the donation); its ``index`` is one Python int on
  every rank;
* a call with more than one token a row, or with a frontend input
  (patches, frames), is a prompt pass (``api.prefill``; the last token's
  logits): each rank computes its heads, ffn columns and vocabulary block
  under a plan with a local axis (``spmd.Step(local=True)``), writing its
  kv heads (and recurrent states' heads) into a cache split over them on
  that axis (or every head into a whole one); under a plan that splits the
  sequence (``sequence_parallel``, ``tp2d``; there the residual's
  ``embed`` too) each rank computes its block of the prompt's tokens (K2
  with the rank's query offset over the keys gathered along the sequence;
  rwkv6's and Mamba2's scans from the state the earlier blocks leave; the
  MoE's dispatch from exchanged counts, or, with the experts on the
  sequence's axis, over its data shard's gathered sequence; the VLM's
  block of [patches; prompt], from both given whole; the encoder-decoder's
  blocks of the frames and of the prompt), every rank stores the whole
  prompt's recurrent states and last rows, and the last token's logits
  come from the rank that holds it;
* a prompt pass from index 0 writes into the rank's block of a cache split
  over ``kv_seq`` (and ``kv_heads``) the positions it covers, from the
  prompt's keys and values, whole or gathered (``models/layers.py``), and
  the encoder-decoder stores its block of the cross K/V;
* a later chunk of a prompt (chunked prefill: the cache's index > 0) is
  computed whole on every rank, or over its heads where the cache is split
  over ``kv_heads``: K2 at the query offset of the cache's index over the
  keys ahead of it; into a cache split over ``kv_seq`` each rank runs K2
  with its log-sum-exp over its own block and K3' folds the ranks'
  results (``models/layers.py``).  rwkv6's and zamba2's states take no
  later chunk: the reference decodes them one token at a time
  (``ValueError``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.api import ModelAPI
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import P, Mesh, Sharding, ShardingPlan, tree_map_axes


def make_serve_step(api: ModelAPI, plan: Optional[ShardingPlan] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``serve_step(params, tokens, cache) -> (logits, cache)``.  The
    step runs without autograd and updates the cache in place.  With
    ``plan`` and ``mesh`` it is one rank's part of the plan-sharded step, as
    :func:`jit_serve_step` with the cache's and the tokens' global shapes
    read from the first call, which must then pass the cache and the tokens
    whole."""
    if plan is not None and mesh is not None:
        return _planned_serve_step(api, plan, mesh, None, None)

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        return api.decode_step(params, tokens, cache)

    return serve_step


def cache_shardings(api: ModelAPI, cache_abstract: Dict[str, Any],
                    plan: ShardingPlan, mesh: Mesh) -> Dict[str, Any]:
    """The plan's Sharding of every cache leaf (``cache_abstract``: the
    cache's tensors, ``meta`` or real; its ``index`` a Python int)."""
    def one(ax, shaped):
        shape = tuple(getattr(shaped, "shape", ()))
        if len(ax) != len(shape):
            return Sharding(mesh, P())
        return Sharding(mesh, plan.spec(ax, shape, mesh))

    axes = api.cache_axes()
    return {k: one(axes[k], v) for k, v in cache_abstract.items()}


def param_shardings(api: ModelAPI, plan: ShardingPlan, mesh: Mesh):
    """The plan's Sharding of every parameter."""
    return tree_map_axes(
        lambda ax, shaped: Sharding(mesh, plan.spec(ax, tuple(shaped.shape), mesh)),
        api.param_axes(), api.abstract_params())


def token_sharding(plan: ShardingPlan, mesh: Mesh,
                   tokens_shape: Optional[Tuple[int, int]]) -> Sharding:
    """The tokens' Sharding: rows over the plan's batch axes."""
    return Sharding(mesh, plan.spec(("batch", None), tokens_shape, mesh))


def jit_serve_step(api: ModelAPI, plan: ShardingPlan, mesh: Mesh,
                   cache_abstract: Dict[str, Any],
                   tokens_shape: Optional[Tuple[int, int]] = None) -> Callable:
    """The reference's jitted serve step with in/out shardings and cache
    donation, run eagerly (nothing is compiled): ``step(params, tokens,
    cache) -> (logits, cache)`` takes each of its three inputs whole (and
    slices it) or as this rank's part: the parameters under
    :func:`param_shardings`, the tokens' rows under :func:`token_sharding`
    of ``tokens_shape`` (None: the tokens come whole), the cache under
    :func:`cache_shardings` of ``cache_abstract`` (its global shapes).  It
    runs under ``torch.no_grad()``, returns the logits whole on every rank
    and the cache as this rank's slice, written in place."""
    return _planned_serve_step(api, plan, mesh, cache_abstract, tokens_shape)


def _planned_serve_step(api: ModelAPI, plan: ShardingPlan, mesh: Mesh,
                        cache_abstract: Optional[Dict[str, Any]],
                        tokens_shape: Optional[Tuple[int, int]]) -> Callable:
    from repro_torch.train.train_step import (param_placements, place_leaf, place_tree,
                                              seq_split_axis)
    placements = param_placements(api, plan, mesh)
    p_sh = param_shardings(api, plan, mesh)
    abstract = api.abstract_params()
    axes = api.param_axes()
    cache_axes = api.cache_axes()
    known = {"tokens": None if tokens_shape is None else tuple(tokens_shape)}

    def learn_cache(cache):
        known["cache"] = {k: tuple(v.shape) for k, v in cache.items()
                          if isinstance(v, torch.Tensor)}
        known["c_sh"] = cache_shardings(api, cache, plan, mesh)

    if cache_abstract is not None:
        learn_cache(cache_abstract)

    @torch.no_grad()
    def serve_step(params, tokens, cache, **inputs):
        if "cache" not in known:
            learn_cache(cache)
        if known["tokens"] is None:
            known["tokens"] = tuple(tokens.shape)
        shapes, c_sh = known["cache"], known["c_sh"]
        params = place_tree(params, p_sh, abstract)
        t_sh = token_sharding(plan, mesh, known["tokens"])
        prompt = tokens.shape[1] > 1 or bool(inputs)
        tokens = place_leaf(tokens, t_sh, (known["tokens"][0], tokens.shape[1]))
        # a prompt from index 0 may be split over the sequence; a later chunk
        # runs whole (or over the heads of a cache split over them)
        seq = seq_split_axis(api, plan, mesh, tokens.shape[1]) \
            if prompt and int(cache["index"]) == 0 else None
        # a prompt's frontend input (patches, frames) has the tokens' rows
        rows = Sharding(mesh, P(t_sh.spec[0] if len(t_sh.spec) else None))
        inputs = {k: place_leaf(v, rows, (known["tokens"][0],) + tuple(v.shape[1:]))
                  for k, v in inputs.items()}
        if seq is not None and api.block_inputs:
            # the rank's block of the prompt (and of the frames), as a batch
            # split over the sequence holds it (train_step.local_batch)
            block = Sharding(mesh, P(None, seq))
            tokens = block.local(tokens)
            inputs = {k: block.local(v) for k, v in inputs.items()}
        local = dict(cache)
        splits = {}
        for k, shape in shapes.items():
            local[k] = place_leaf(cache[k], c_sh[k], shape)
            splits[k] = (local[k], spmd.CacheSplit(c_sh[k], shape, tuple(cache_axes[k])))
        batch_part = t_sh.spec[0] if len(t_sh.spec) else None
        step = spmd.Step(plan, mesh, batch_part, tokens.shape[0], cache=splits,
                         local=prompt, seq_axis=seq)
        with spmd.step_context(step):
            model_params = spmd.serving_params(params, axes, placements)
            if prompt:
                logits, new_cache = api.prefill(model_params, tokens, local, **inputs)
            else:
                logits, new_cache = api.decode_step(model_params, tokens, local)
            whole = (known["tokens"][0],) + tuple(logits.shape[1:])
            logits = spmd.gather_blocks(logits, mesh, P(batch_part), whole, step.batch_axes)
        return logits, new_cache

    return serve_step
