"""Serve-step factory: batched single-token decode with a KV cache.

Counterpart of ``repro/train/serve_step.py``.  On one device there is no
sharding plan to apply; the sharding helpers of the reference arrive with
``parallel/sharding``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.api import ModelAPI


def make_serve_step(api: ModelAPI) -> Callable:
    """Returns ``serve_step(params, tokens, cache) -> (logits, cache)``.  The
    step runs without autograd and updates the cache in place."""

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        return api.decode_step(params, tokens, cache)

    return serve_step
