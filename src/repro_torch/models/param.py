"""Parameter-spec infrastructure for the model zoo.

Every module declares its parameters once as a nested dict of
:class:`LeafSpec` (shape + init + *logical sharding axes*); from that single
source of truth we derive:

* ``materialize(generator, spec, device)`` — real initialized params
* ``abstract(spec)``            — meta tensors (**no allocation**)
* ``axes_of(spec)``             — a matching tree of logical-axis tuples
* ``count_params(spec)``        — exact parameter counts.

Parameter trees are plain nested dicts of tensors with the reference
package's keys and shapes, which is what makes carrying weights across
trivial (``models/convert.py``).  ``layers`` is the stacked leading
dimension the layer loop walks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

Axes = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class LeafSpec:
    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"          # "normal" | "zeros" | "ones" | "scaled"
    scale: float = 1.0
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_leaf_spec(x) -> bool:
    return isinstance(x, LeafSpec)


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = is_leaf_spec):
    """Map ``fn`` over the leaves of nested dicts (keys kept, order kept)."""
    if is_leaf(tree) or not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
            for k, v in tree.items()}


def tree_leaves(tree, is_leaf: Callable = is_leaf_spec) -> list:
    if is_leaf(tree) or not isinstance(tree, dict):
        return [tree]
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v, is_leaf=is_leaf))
    return out


def _init_leaf(generator: torch.Generator, spec: LeafSpec, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        # fan-in = first non-stacked dim (stacked "layers" dims are batch-like)
        dims = [s for s, a in zip(spec.shape, spec.axes) if a != "layers"]
        fan_in = dims[0] if len(dims) >= 2 else max(dims[-1] if dims else 1, 1)
        std = spec.scale / math.sqrt(max(fan_in, 1))
    elif spec.init == "scaled":
        std = spec.scale
    else:
        raise ValueError(spec.init)
    # drawn directly in the leaf's dtype: a float32 staging copy of a large
    # leaf would double its peak memory
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    return out.normal_(0.0, std, generator=generator)


def materialize(generator: torch.Generator, spec, device="cuda") -> Any:
    """Initialise every leaf on ``device`` from ``generator`` (which must
    live on the same device)."""
    return tree_map(lambda s: _init_leaf(generator, s, device), spec)


def abstract(spec) -> Any:
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), spec)


def axes_of(spec) -> Any:
    return tree_map(lambda s: s.axes, spec)


def count_params(spec) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec))


def cast_spec_dtype(spec, dtype) -> Any:
    return tree_map(lambda s: LeafSpec(s.shape, s.axes, s.init, s.scale, dtype), spec)


def stack_specs(spec, n: int, axis_name: str = "layers") -> Any:
    """Prepend a stacked dimension to every leaf."""
    return tree_map(
        lambda s: LeafSpec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                           s.scale, s.dtype), spec)
