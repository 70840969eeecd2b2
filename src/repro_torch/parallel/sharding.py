"""Logical-axis sharding: the bridge between model code and the mesh.

Counterpart of ``repro/parallel/sharding.py``.  Parameters carry *logical*
axes from their LeafSpecs; a :class:`ShardingPlan` maps logical axes -> mesh
axes; the TileLoom planner bridge (``planner_bridge.py``) *produces* these
plans by planning the model's dominant tile programs on the cluster's df
description, and the fixed plans (pure-DP, megatron-TP, ...) are the
vendor-style baselines.

Divisibility-safe: a mesh axis that does not divide the corresponding dim is
dropped from the spec, exactly as the reference drops it.

The port's own types stand where the reference uses jax's:

* :class:`P` is a tuple of per-dim mesh axes, equal element by element to a
  ``PartitionSpec`` with the same parts;
* :class:`Mesh` names the axes and their sizes, and holds a
  ``torch.distributed`` ``DeviceMesh`` only when one was built
  (``launch/mesh.py``): :meth:`ShardingPlan.spec` and the planner need no
  process group;
* :class:`Sharding` is ``NamedSharding``'s counterpart: the slice of a
  global shape each mesh coordinate holds (row-major over the mesh axes of
  one dim, in the spec's order, as ``NamedSharding`` places them), and the
  DTensor placements where those can express it.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MeshAxes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, a mesh axis
    name, or a tuple of mesh axis names (the dim split over all of them,
    row-major in that order)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes with their sizes, row-major over ranks: rank
    ``r``'s coordinates are ``np.unravel_index(r, sizes)``.  ``device_mesh``
    is the ``DeviceMesh`` over an initialised process group, or None for a
    mesh that is only planned against.  ``groups`` maps a tuple of axis
    names (in mesh order) to the process group of this rank's peers along
    exactly those axes, for every such tuple whose group has more than one
    rank."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_mesh: Any = field(default=None, compare=False, repr=False)
    rank: int = 0
    groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict, compare=False,
                                               repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        r = self.rank if rank is None else rank
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(r, self.sizes))))

    def peers(self, axes: Sequence[str], rank: Optional[int] = None) -> Tuple[int, ...]:
        """The ranks that differ from ``rank`` only along ``axes``, in rank
        order (row-major over ``axes`` in mesh order)."""
        me = self.coords(rank)
        free = [a for a in self.axis_names if a in axes]
        out = []
        for vals in itertools.product(*(range(self.shape[a]) for a in free)):
            c = dict(me, **dict(zip(free, vals)))
            out.append(int(np.ravel_multi_index([c[a] for a in self.axis_names],
                                                self.sizes)))
        return tuple(out)

    def group(self, axes: Sequence[str]):
        """This rank's process group along ``axes`` (mesh order), or None
        when it holds one rank only."""
        key = tuple(a for a in self.axis_names if a in axes)
        if math.prod(self.shape[a] for a in key) <= 1:
            return None
        return self.groups[key]


@dataclass(frozen=True)
class Sharding:
    """``NamedSharding(mesh, spec)``: which slice of a global shape each
    mesh coordinate holds."""
    mesh: Mesh
    spec: P

    def shard_counts(self, ndim: int) -> Tuple[int, ...]:
        return tuple(self._dim_size(i) for i in range(ndim))

    def _dim_size(self, i: int) -> int:
        part = self.spec[i] if i < len(self.spec) else None
        return math.prod(self.mesh.shape[a] for a in part_axes(part))

    def mesh_axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec splits over, in mesh order."""
        used = {a for part in self.spec for a in part_axes(part)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def index(self, shape: Sequence[int], rank: Optional[int] = None
              ) -> Tuple[slice, ...]:
        """The slice of a tensor of global ``shape`` that ``rank`` (default
        this mesh's rank) holds: along a dim split over axes (a1, a2, ...)
        the block index is row-major over them in the spec's order."""
        coords = self.mesh.coords(rank)
        out = []
        for i, n in enumerate(shape):
            part = self.spec[i] if i < len(self.spec) else None
            axes = part_axes(part)
            k = math.prod(self.mesh.shape[a] for a in axes)
            if n % k:
                raise ValueError(f"dim {i} of {tuple(shape)} is not divisible by the "
                                 f"{k} shards of {part!r}")
            block = 0
            for a in axes:
                block = block * self.mesh.shape[a] + coords[a]
            step = n // k
            out.append(slice(block * step, (block + 1) * step))
        return tuple(out)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n // self._dim_size(i) for i, n in enumerate(shape))

    def local(self, x: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """``rank``'s slice of the global tensor ``x`` (a view)."""
        return x[self.index(x.shape, rank)]

    def placements(self):
        """DTensor placements over ``mesh.device_mesh``'s dims (``Shard(d)``
        or ``Replicate()`` per mesh axis), or None where a dim split over
        several mesh axes lists them in another order than the mesh's:
        DTensor always splits a dim over its mesh dims in mesh order."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * len(self.mesh.axis_names)
        for d, part in enumerate(self.spec):
            axes = part_axes(part)
            order = [self.mesh.axis_names.index(a) for a in axes]
            if order != sorted(order):
                return None
            for j in order:
                out[j] = Shard(d)
        return tuple(out)


def part_axes(part) -> Tuple[str, ...]:
    """The mesh axes of one entry of a spec, as a tuple."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


@dataclass(frozen=True)
class ShardingPlan:
    """logical axis -> mesh axis (or axes) mapping + plan metadata."""
    name: str
    rules: Tuple[Tuple[str, MeshAxes], ...]
    description: str = ""

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def with_rule(self, logical: str, axes: MeshAxes) -> "ShardingPlan":
        rules = tuple((k, v) for k, v in self.rules if k != logical)
        return replace(self, rules=rules + ((logical, axes),))

    def spec(self, axes: Sequence[Optional[str]],
             shape: Optional[Tuple[int, ...]] = None,
             mesh: Optional[Mesh] = None) -> P:
        """Partition spec for a tensor with the given logical axes; drops mesh
        axes that do not divide the dim or are already used."""
        used: set = set()
        parts = []
        for i, ax in enumerate(axes):
            m = self.mesh_axes(ax)
            if m is None:
                parts.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms if a not in used)
            if mesh is not None:
                ok = []
                size = 1
                for a in ms:
                    if a not in mesh.shape:
                        continue
                    size *= mesh.shape[a]
                    ok.append(a)
                ms = tuple(ok)
                if shape is not None and ms:
                    total = int(np.prod([mesh.shape[a] for a in ms]))
                    if shape[i] % total != 0:
                        # try the prefix that divides
                        ms2 = []
                        tot = 1
                        for a in ms:
                            if shape[i] % (tot * mesh.shape[a]) == 0:
                                ms2.append(a)
                                tot *= mesh.shape[a]
                        ms = tuple(ms2)
            if not ms:
                parts.append(None)
            else:
                used.update(ms)
                parts.append(ms[0] if len(ms) == 1 else ms)
        return P(*parts)


# ---------------------------------------------------------------- context
class _Ctx(threading.local):
    def __init__(self):
        self.plan: Optional[ShardingPlan] = None
        self.mesh: Optional[Mesh] = None
        self.local_batch: Optional[int] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_plan(plan: ShardingPlan, mesh: Mesh, local_batch: Optional[int] = None):
    """The plan and mesh model code runs under; ``local_batch`` is the
    batch rows this rank holds (what :func:`constrain` checks)."""
    prev = (_CTX.plan, _CTX.mesh, _CTX.local_batch)
    _CTX.plan, _CTX.mesh, _CTX.local_batch = plan, mesh, local_batch
    try:
        yield
    finally:
        _CTX.plan, _CTX.mesh, _CTX.local_batch = prev


def current_plan() -> Optional[ShardingPlan]:
    return _CTX.plan


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """No-op outside a plan.  Inside one, activations are computed whole on
    each rank except along the batch, which the step splits over the plan's
    batch axes (``parallel/spmd.py``): a tensor whose ``batch`` dim does not
    hold this rank's rows raises.  Returns ``x``."""
    if _CTX.plan is None or _CTX.mesh is None or len(axes) != x.dim():
        return x
    if "batch" in axes and _CTX.local_batch is not None:
        n = x.shape[list(axes).index("batch")]
        if n != _CTX.local_batch:
            raise ValueError(f"constrain: batch dim of {tuple(x.shape)} is {n}, this "
                             f"rank holds {_CTX.local_batch} rows under {_CTX.plan.name}")
    return x


# -------------------------------------------------------- pytree helpers
def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_map_axes(fn, axes_tree: Any, *rest: Any, is_leaf=None) -> Any:
    """``fn(axes, *leaves)`` over a tree of logical-axis tuples and trees of
    the same structure (nested dicts, NamedTuples, dataclasses; None is a
    leaf).  ``is_leaf`` decides the first tree's leaves instead (a tree of
    :class:`Sharding`, say)."""
    import dataclasses
    leaf = is_leaf or (lambda x: x is None or _is_axes(x))
    if leaf(axes_tree):
        return fn(axes_tree, *rest)

    def sub(x, *r):
        return tree_map_axes(fn, x, *r, is_leaf=is_leaf)
    if isinstance(axes_tree, dict):
        return {k: sub(v, *(r[k] for r in rest)) for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(sub(getattr(axes_tree, f), *(getattr(r, f) for r in rest))
                                 for f in axes_tree._fields))
    if dataclasses.is_dataclass(axes_tree):
        return type(axes_tree)(**{
            f.name: sub(getattr(axes_tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(axes_tree)})
    raise TypeError(f"not an axes tree: {type(axes_tree).__name__}")


def is_sharding_leaf(x) -> bool:
    return x is None or isinstance(x, Sharding)


def tree_shardings(axes_tree: Any, shapes_tree: Any, plan: ShardingPlan,
                   mesh: Mesh) -> Any:
    """Sharding tree for params/opt-state given their logical axes."""
    return tree_map_axes(
        lambda axes, shaped: Sharding(mesh, plan.spec(axes, tuple(shaped.shape), mesh)),
        axes_tree, shapes_tree)


# ------------------------------------------------------------ fixed plans
def pure_dp_plan() -> ShardingPlan:
    """Everything replicated, batch over all mesh axes — the 'TT-1D-like'
    trivial baseline at mesh level."""
    return ShardingPlan(
        name="pure_dp",
        rules=(("batch", ("pod", "data", "model")),),
        description="data parallel only; parameters replicated")


def megatron_tp_plan() -> ShardingPlan:
    """The fixed vendor-style template: DP over (pod,data), megatron TP over
    'model' for heads/ffn/vocab/experts."""
    return ShardingPlan(
        name="megatron_tp",
        rules=(
            ("batch", ("pod", "data")),
            ("q_heads", "model"),
            ("kv_heads", "model"),
            ("ffn", "model"),
            ("vocab", "model"),
            ("experts", "model"),
            ("ssm_heads", "model"),
        ),
        description="DP x megatron-TP template")


def sequence_parallel_plan() -> ShardingPlan:
    """Long-context plan: sequence sharded over 'model' (ring-attention
    style), used for 32k prefill / 500k decode when batch is tiny."""
    return ShardingPlan(
        name="sequence_parallel",
        rules=(
            ("batch", ("pod", "data")),
            ("seq", "model"),
            ("kv_seq", "model"),
            ("ffn", None),
            ("q_heads", None),
        ),
        description="DP x sequence-parallel (ring) template")


def expert_parallel_plan() -> ShardingPlan:
    """MoE plan: experts over 'model', batch over (pod,data); dense layers
    megatron-TP."""
    return ShardingPlan(
        name="expert_parallel",
        rules=(
            ("batch", ("pod", "data")),
            ("experts", "model"),
            ("q_heads", "model"),
            ("kv_heads", "model"),
            ("ffn", "model"),
            ("vocab", "model"),
        ),
        description="DP x EP(+TP) template")


FIXED_PLANS = {
    "pure_dp": pure_dp_plan,
    "megatron_tp": megatron_tp_plan,
    "sequence_parallel": sequence_parallel_plan,
    "expert_parallel": expert_parallel_plan,
}
