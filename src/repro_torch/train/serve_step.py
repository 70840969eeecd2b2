"""Serve-step factory: batched single-token decode with a KV cache.

Counterpart of ``repro/train/serve_step.py``.  The reference's placement
functions are here (:func:`param_shardings`, :func:`cache_shardings`: the
plan's specs of every parameter and cache leaf).  Executing the decode step
over a mesh (``jit_serve_step``, the cache split over ``kv_seq`` and decoded
through K3's partials and a cross-rank combine) is ROADMAP.md Queue 1 item
5b; :func:`make_serve_step` runs on one device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models.api import ModelAPI
from repro_torch.parallel.sharding import P, Mesh, Sharding, ShardingPlan, tree_map_axes


def make_serve_step(api: ModelAPI) -> Callable:
    """Returns ``serve_step(params, tokens, cache) -> (logits, cache)``.  The
    step runs without autograd and updates the cache in place."""

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
