"""Local-shard SPMD execution of a plan-sharded train step.

The reference hands its step to ``jax.jit`` with plan-derived in/out
shardings and lets GSPMD decide every layout.  The port compiles nothing:
each rank runs the same eager PyTorch program on its own shards, the way
``shard_map`` runs a function, with ``torch.distributed`` collectives on the
process groups of :class:`~repro_torch.parallel.sharding.Mesh`.

* **Storage.** A sharded leaf of the train state is the rank's local slice,
  a plain tensor (the kernels take raw pointers; fused AdamW, the gradient
  buffers and the checkpoint writer all take plain tensors), placed by the
  plan (``train_step.state_shardings``).
* **Batch.** The batch is split over the plan's ``batch`` mesh axes
  (:attr:`Step.batch_axes`); an input split over any other axis (``seq``
  under ``zero3_sp`` / ``tp2d``) is gathered for use.
* **Gather for use.** A parameter is all-gathered where the model uses it:
  a layer's parameters inside ``layers.remat``, so again in the
  recomputation, the others once a step (:func:`for_use`).  Activations are
  computed whole on every rank.  The gather's backward turns the gradient
  of the whole parameter into this rank's shard: it is **summed over the
  batch axes** (their ranks saw other rows) and only **sliced** over the
  others (their ranks saw the same rows and computed the same gradient).
  Each rank back-propagates its local mean loss divided by the batch
  shards, so the sum is the gradient of the global mean.
* **Expert parallelism.** Under a plan that maps ``experts`` to one mesh
  axis, the grouped expert weights keep that axis sharded (each rank runs
  only its experts; ``models.moe``), and the rank's partial outputs are
  summed over it (:func:`psum`); :func:`enter` marks the inputs whose
  gradients the ranks along the axis hold in parts.
* **Clip norm and metrics.** The clip norm is the global gradient's, each
  element counted once (:meth:`Step.global_norm`); the loss and metrics are
  means over the global batch (:meth:`Step.batch_mean`).

A collective over a group of one rank is skipped, so on a 1x1 mesh the step
runs the unsharded step's arithmetic exactly.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from .sharding import P, Mesh, Sharding, ShardingPlan, part_axes, use_plan


# ---------------------------------------------------------------- collectives
def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (a new tensor), or ``x`` itself when the
    group is None (one rank)."""
    if group is None:
        return x
    import torch.distributed as dist
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def gather_blocks(local: torch.Tensor, mesh: Mesh, spec: P, shape: Sequence[int],
                  axes: Tuple[str, ...]) -> torch.Tensor:
    """The tensor of ``shape`` whose blocks under ``spec`` are ``local`` on
    each rank along ``axes`` (``spec`` splits over no other axis)."""
    group = mesh.group(axes)
    if group is None:
        return local
    import torch.distributed as dist
    peers = mesh.peers(axes)
    parts = [torch.empty_like(local) for _ in peers]
    dist.all_gather(parts, local.contiguous(), group=group)
    full = local.new_empty(tuple(shape))
    sh = Sharding(mesh, spec)
    for r, part in zip(peers, parts):
        full[sh.index(shape, r)] = part
    return full


# ----------------------------------------------------------------- placement
@dataclass(frozen=True)
class Placement:
    """Where one parameter leaf lives: its sharding, global shape and
    logical axes (per layer: without the stacked ``layers`` dims)."""
    sharding: Sharding
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]

    def replication(self) -> int:
        """Ranks that hold each element."""
        return self.sharding.mesh.size // math.prod(
            self.sharding.mesh.shape[a] for a in self.sharding.mesh_axes())

    def split(self) -> bool:
        return any(n > 1 for n in self.sharding.shard_counts(len(self.shape)))

    def per_layer(self, lead: int) -> "Placement":
        if any(p is not None for p in self.sharding.spec[:lead]):
            raise ValueError(f"a stacked layers dim is sharded: {self.sharding.spec}")
        return Placement(Sharding(self.sharding.mesh, P(*self.sharding.spec[lead:])),
                         self.shape[lead:], self.axes[lead:])


class _ForUse(torch.autograd.Function):
    """Forward: the parameter as the model uses it, gathered over ``axes``.
    Backward: the gradient summed over the batch group, then this rank's
    block."""

    @staticmethod
    def forward(ctx, local, mesh, spec, shape, axes, batch_group):
        ctx.mesh, ctx.spec, ctx.shape, ctx.batch_group = mesh, spec, shape, batch_group
        full = gather_blocks(local, mesh, spec, shape, axes)
        return full.view_as(full) if full is local else full

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad, ctx.batch_group)
        return (grad[Sharding(ctx.mesh, ctx.spec).index(ctx.shape)].contiguous(),
                None, None, None, None, None)


# -------------------------------------------------------- expert parallelism
class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``: the
    ranks along it each hold part of it (each ran its own experts)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _Psum(torch.autograd.Function):
    """Sum over ``group`` of partial results that replicated code consumes:
    each rank's part gets the (replicated) gradient of the sum as it is."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        out = all_reduce(x, group)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, grad):
        return (grad * ctx.scale if ctx.scale != 1.0 else grad), None, None


def gather_batch(x: torch.Tensor):
    """``x``'s rows from every rank along the batch axes (dim 0), for code
    the reference runs on the global batch, and the function that takes
    this rank's rows back out of a result on the global batch.  The rows'
    gradient comes back summed over those ranks.  Outside a step with a
    split batch: ``x`` and the identity."""
    step = current()
    if step is None or step.batch_group is None:
        return x, lambda y: y
    spec = P(step.batch_part)
    shape = (x.shape[0] * step.batch_shards,) + tuple(x.shape[1:])
    rows = Sharding(step.mesh, spec).index(shape)[0]
    full = _ForUse.apply(x, step.mesh, spec, shape, step.batch_axes, step.batch_group)
    return full, lambda y: y[rows]


def enter(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` entering code whose ranks along ``axis`` compute different
    parts of its gradient (the reference's replicated ``shard_map`` input)."""
    group = current().mesh.group((axis,))
    return x if group is None else _Enter.apply(x, group)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.psum(x, axis)`` of per-rank partial results."""
    group = current().mesh.group((axis,))
    return x if group is None else _Psum.apply(x, group, 1.0)


def pmean(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.pmean(x, axis)`` of a value every rank along ``axis``
    computed alike."""
    mesh = current().mesh
    group = mesh.group((axis,))
    return x if group is None else _Psum.apply(x, group, 1.0 / mesh.shape[axis])


# -------------------------------------------------------------- step context
class Step:
    """One rank's view of a plan-sharded step: the plan, the mesh, the mesh
    axes the batch is split over and the expert axis, if any."""

    def __init__(self, plan: ShardingPlan, mesh: Mesh, batch_part, local_batch: int):
        """``batch_part``: the batch dim's entry of the batch's spec (None,
        an axis, or axes in the order the rows are blocked);
        ``local_batch``: the rows this rank holds."""
        self.plan, self.mesh, self.batch_part = plan, mesh, batch_part
        self.local_batch = local_batch
        batch_axes = part_axes(batch_part)
        self.batch_axes = tuple(a for a in mesh.axis_names if a in batch_axes)
        self.batch_shards = math.prod(mesh.shape[a] for a in self.batch_axes)
        self.batch_group = mesh.group(self.batch_axes)
        e_ax = plan.mesh_axes("experts")
        b_ax = plan.mesh_axes("batch")
        plan_batch = tuple(a for a in part_axes(b_ax) if a in mesh.shape)
        # the reference's _ep_axes and its batch-divisibility condition: the
        # batch split over exactly the plan's batch axes present in the mesh
        self.expert_axis = (e_ax if isinstance(e_ax, str) and e_ax in mesh.shape
                            and set(plan_batch) == set(self.batch_axes) else None)

    def for_use(self, leaf: torch.Tensor, placement: Placement) -> torch.Tensor:
        """``leaf`` (this rank's shard) gathered over every mesh axis its
        placement splits it over, but a grouped expert weight's ``experts``
        dim under expert parallelism."""
        keep = set()
        if self.expert_axis is not None and placement.axes[:1] == ("experts",) \
                and placement.sharding.spec[0] == self.expert_axis:
            keep.add(0)          # a grouped expert weight keeps its experts local
        spec = P(*(None if i in keep else part
                   for i, part in enumerate(placement.sharding.spec)))
        shape = tuple(leaf.shape[i] if i in keep else n
                      for i, n in enumerate(placement.shape))
        axes = Sharding(self.mesh, spec).mesh_axes()
        if self.mesh.group(axes) is None and self.batch_group is None:
            return leaf
        return _ForUse.apply(leaf, self.mesh, spec, shape, axes, self.batch_group)

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the batch shards of a per-rank mean."""
        if self.batch_group is None:
            return x
        return all_reduce(x.detach().float(), self.batch_group) / self.batch_shards

    def global_norm(self, grads, placements) -> torch.Tensor:
        """The unsharded gradient's global norm from every rank's shards:
        each leaf's sum of squares over the ranks that hold each element
        once, summed over all ranks."""
        from repro_torch.train import optimizer as opt
        if self.mesh.size == 1:
            return opt.global_norm(grads)
        leaves = opt._leaves(grads)
        reps = [p.replication() for p in placement_leaves(placements)]
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 / r
              for g, r in zip(leaves, reps)]
        total = all_reduce(torch.stack(sq).sum(), self.mesh.group(self.mesh.axis_names))
        return torch.sqrt(total)


def placement_leaves(tree) -> list:
    """The Placements of a tree, in the parameters' leaf order."""
    from repro_torch.models.param import tree_leaves
    return tree_leaves(tree, is_leaf=lambda x: isinstance(x, Placement))


class _Ctx(threading.local):
    step: Optional[Step] = None


_CTX = _Ctx()


def current() -> Optional[Step]:
    return _CTX.step


@contextlib.contextmanager
def step_context(step: Optional[Step]):
    """Run under ``step`` (nothing changes for None).  The context is the
    thread's: the autograd engine recomputes a checkpointed block on its own
    thread on the card, so ``layers.remat`` enters the forward's step again
    there."""
    if step is None:
        yield None
        return
    prev = _CTX.step
    _CTX.step = step
    try:
        with use_plan(step.plan, step.mesh, step.local_batch):
            yield step
    finally:
        _CTX.step = prev


# ------------------------------------------------------------ for-use trees
_PLACEMENT = "_spmd_placement"


def tag(leaf: torch.Tensor, placement: Placement) -> torch.Tensor:
    """Mark a local parameter leaf: :func:`for_use` gathers it."""
    setattr(leaf, _PLACEMENT, placement)
    return leaf


def for_use(tree: Any) -> Any:
    """``tree`` with every tagged leaf gathered for use under the current
    step (and every object with a ``for_use`` method replaced by what it
    returns); ``tree`` itself outside a step."""
    step = _CTX.step
    if step is None:
        return tree
    return _map_for_use(step, tree)


def _map_for_use(step: Step, x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        p = getattr(x, _PLACEMENT, None)
        return x if p is None else step.for_use(x, p)
    if isinstance(x, dict):
        return {k: _map_for_use(step, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_map_for_use(step, v) for v in x)
    if hasattr(x, "for_use"):
        return x.for_use()
    return x
