"""Int8 error-feedback gradient compression.

Counterpart of ``repro/train/grad_compress.py``: each gradient plus its
residual is quantised to int8 with one float32 scale per tensor, and what the
quantisation lost is carried to the next step.  ``roundtrip`` is the exact
arithmetic a compressed all-reduce applies to its summands; on one device it
is applied at the gradient boundary, as in the reference.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.param import tree_map

Params = Any


class CompressedGrads(NamedTuple):
    q: Params            # int8 payload
    scale: Params        # per-tensor float32 scale
    residual: Params     # error-feedback carry (float32)


def _map(fn, tree, *rest):
    return tree_map(fn, tree, *rest, is_leaf=lambda x: isinstance(x, torch.Tensor))


def init_residual(params: Params) -> Params:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress(grads: Params, residual: Params, placements: Optional[Params] = None
             ) -> Tuple[CompressedGrads, Params]:
    """Quantise grads + residual to int8; return the compressed gradients and
    the new residual.  In a plan-sharded step ``placements`` (a tree of
    ``spmd.Placement`` like ``grads``) makes each scale the whole leaf's:
    ``max |g + r|`` all-reduced (max) over the axes that split the leaf.  The
    residual stays this rank's."""
    def one(g, r, pl=None):
        g32 = g.float() + r
        peak = torch.max(torch.abs(g32))
        if pl is not None:
            from repro_torch.parallel import spmd
            peak = spmd.reduce_over(peak, pl.sharding.mesh, pl.sharding.mesh_axes(), "max")
        scale = torch.clamp(peak, min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return q, scale, g32 - q.float() * scale

    out = _map(one, grads, residual) if placements is None else \
        _map(one, grads, residual, placements)
    pick = lambda i: tree_map(lambda t: t[i], out, is_leaf=lambda t: isinstance(t, tuple))
    new_res = pick(2)
    return CompressedGrads(pick(0), pick(1), new_res), new_res


def decompress(c: CompressedGrads) -> Params:
    return _map(lambda q, s: q.float() * s, c.q, c.scale)


def roundtrip(grads: Params, residual: Params, placements: Optional[Params] = None
              ) -> Tuple[Params, Params]:
    """compress -> decompress, carrying the error-feedback residual."""
    c, new_res = compress(grads, residual, placements)
    return decompress(c), new_res
