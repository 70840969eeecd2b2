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
  (:attr:`Step.batch_axes`); an input split over any other axis is gathered
  for use, but the sequence of a step with a :attr:`Step.seq_axis`.
* **Gather for use.** A parameter is all-gathered where the model uses it:
  a layer's parameters inside ``layers.remat``, so again in the
  recomputation, the others once a step (:func:`for_use`).  The gather's
  backward turns the gradient of the whole parameter into this rank's
  shard: it is **summed over the batch axes** (their ranks saw other rows)
  and only **sliced** over the others (their ranks saw the same rows and
  computed the same gradient).
  Each rank back-propagates its local mean loss divided by the batch
  shards, so the sum is the gradient of the global mean.
* **Head-, ffn- and vocab-local compute** (megatron style, what GSPMD does
  under the reference's logical-axis constraints).  A step built with
  ``local=True`` under a plan that maps ``q_heads``, ``ffn`` and
  ``vocab`` to one mesh axis that splits neither the batch nor the
  sequence (``megatron_tp``, ``zero3``, ``expert_parallel``) has a
  :attr:`Step.local_axis`.  :func:`for_use` then leaves a leaf's
  ``q_heads`` / ``kv_heads`` / ``ffn`` / ``vocab`` dim split where the plan
  splits it over that axis (it still gathers every other axis, such as
  zero3's ``embed`` over ``data``) and marks the tensor (:func:`local_of`).
  ``models/layers.py`` computes this rank's heads, ffn columns and
  vocabulary slice: the input enters through :func:`enter` (its gradient
  summed over the axis), the row-parallel product leaves through
  :func:`psum`, the embedding is a masked lookup summed over the axis and
  the cross-entropy reduces its log-sum-exp and label logit over it
  (:func:`vocab_xent_sum`).  Such a leaf's gradient is the rank's own
  block, summed over the batch axes only.  Activations outside those
  layers (norms, residuals) stay whole on every rank.  Every family has
  such rules: attention (self and cross), the MLP, the embedding and the
  head in ``models/layers.py``, rwkv6's time and channel mix
  (``models/rwkv6.py``) and the Mamba2 block (``models/mamba2.py``, which
  also keeps ``ssm_heads`` split; a leaf it uses whole, split by the plan,
  comes in through :func:`gather_used`).  Without a local axis,
  activations are computed whole on every rank.
* **Sequence-split compute** (context parallelism, what GSPMD does under
  ``tp2d``, ``zero3_sp`` and ``sequence_parallel``: ``seq`` and ``kv_seq``
  claim ``model`` before the heads, ffn and vocabulary, which stay whole).
  A step built with ``seq=True`` whose plan maps ``seq`` and ``kv_seq`` to
  one mesh axis of more than one rank that splits no batch has a
  :attr:`Step.seq_axis` (:func:`seq_axis_of`): each rank computes its block
  of the tokens (:func:`seq_range`).  Attention gathers K and V over the
  axis (:func:`gather_seq`, whose backward reduce-scatters) and runs K2
  with the rank's query offset.  A recurrent layer (rwkv6's WKV scan,
  Mamba2's SSD scan) starts its block from the state the earlier ranks'
  blocks leave, folded from every rank's own final state
  (:func:`carry_states`), and its token shifts and causal convolution read
  the previous rank's last rows (:func:`seq_edges`).  The ranks along the
  axis saw different tokens, so a parameter's gradient is **summed over
  it** as over a batch axis (:attr:`Step.reduce_axes`), and so are the
  loss and metrics.  Under
  ``tp2d`` the residual's ``embed`` is also split, over
  :attr:`Step.embed_axis`: :func:`for_use` leaves every leaf's ``embed``
  dim split over it (marked: :func:`embed_of`) and gathers the rest, and
  ``models/layers.py`` multiplies the rank's ``embed`` block by the
  weight's, summing the partial products over the axis (:func:`psum`);
  the products whose output is the ``embed`` dim need no sum.
* **Expert parallelism.** Under a plan that maps ``experts`` to one mesh
  axis, the grouped expert weights keep that axis sharded (each rank runs
  only its experts; ``models.moe``), and the rank's partial outputs are
  summed over it (:func:`psum`); :func:`enter` marks the inputs whose
  gradients the ranks along the axis hold in parts.  Without an expert
  axis, the MoE's ranks that hold blocks of the tokens exchange per-row,
  per-expert pair counts (:func:`gather_counts`) instead of the tokens, and
  sum the load-balancing loss's means with :func:`psum_shared`, whose
  backward sums too: each rank adds the result to its own share of the
  loss.
* **Clip norm and metrics.** The clip norm is the global gradient's, each
  element counted once (:meth:`Step.global_norm`); the loss and metrics are
  means over the global batch (:meth:`Step.batch_mean`).

* **Serving.** A serve step's :class:`Step` also knows its cache leaves
  (:class:`CacheSplit`: each leaf's Sharding, global shape and logical
  axes), which ``models/layers.py`` looks up by storage
  (:func:`cache_split`) to decode a cache split over ``kv_seq`` or
  ``kv_heads`` without gathering it; :func:`serving_params` hands the model
  its parameters to be gathered a layer at a time; :func:`gather_over`
  concatenates every rank's piece along one dim in :class:`Sharding`'s
  block order.
* **Accounting.** Every collective issued here records its kind (the
  reference's names: all-gather, all-reduce, ...) and its output bytes on
  each mesh axis it ran over in the open :class:`CollectiveTally`
  (:func:`counting_collectives`; ``launch/dryrun.py`` reads it).

A collective over a group of one rank is skipped and records nothing, so
on a 1x1 mesh the step runs the unsharded step's arithmetic exactly.
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
# the reference's names for the collectives (``launch/roofline.py``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


class CollectiveTally:
    """What the collectives issued while it is open moved: per kind, the
    output bytes on each mesh axis the collective ran over (a collective over
    two axes counts its bytes on both), and how many of each kind ran."""

    def __init__(self):
        self.bytes = {k: {} for k in KINDS}
        self.counts = {k: 0 for k in KINDS}

    def add(self, kind: str, out_bytes: int, axes: Sequence[str]) -> None:
        self.counts[kind] += 1
        for a in axes:
            self.bytes[kind][a] = self.bytes[kind].get(a, 0.0) + float(out_bytes)

    def by_kind(self) -> dict:
        """Bytes per kind, summed over the axes."""
        return {k: sum(v.values()) for k, v in self.bytes.items()}

    def by_axis(self) -> dict:
        """Bytes per mesh axis, summed over the kinds."""
        out: dict = {}
        for per in self.bytes.values():
            for a, b in per.items():
                out[a] = out.get(a, 0.0) + b
        return out


_TALLY: Optional[CollectiveTally] = None


@contextlib.contextmanager
def counting_collectives():
    """A :class:`CollectiveTally` of every collective issued inside."""
    global _TALLY
    prev, _TALLY = _TALLY, CollectiveTally()
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def _record(kind: str, out: torch.Tensor, axes: Sequence[str]) -> None:
    if _TALLY is not None:
        _TALLY.add(kind, out.numel() * out.element_size(), axes)


def all_reduce(x: torch.Tensor, group, axes: Sequence[str] = (), op: str = "sum",
               inplace: bool = False) -> torch.Tensor:
    """Sum (or ``op="max"``) of ``x`` over ``group``, the ranks along mesh
    ``axes`` (a new tensor, or ``x`` itself summed in place with
    ``inplace`` and a contiguous ``x``), or ``x`` itself when the group is
    None (one rank)."""
    if group is None:
        return x
    import torch.distributed as dist
    if not (inplace and x.is_contiguous()):
        x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    _record("all-reduce", x, axes)
    return x


def reduce_over(x: torch.Tensor, mesh: Mesh, axes: Sequence[str], op: str = "sum"
                ) -> torch.Tensor:
    """:func:`all_reduce` over this rank's peers along ``axes`` of ``mesh``."""
    key = tuple(a for a in mesh.axis_names if a in axes)
    return all_reduce(x, mesh.group(key), key, op)


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
    _record("all-gather", full, tuple(a for a in mesh.axis_names if a in axes))
    sh = Sharding(mesh, spec)
    for r, part in zip(peers, parts):
        full[sh.index(shape, r)] = part
    return full


def gather_over(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along mesh ``axes`` (a name or names, in the order
    a spec lists them) concatenated along ``dim``, in the block order
    :class:`Sharding` gives a dim split over those axes (row-major over
    ``axes``), under the current step's mesh.  ``x`` itself where the axes
    hold one rank."""
    mesh = current().mesh
    axes = part_axes(axes)
    if mesh.group(axes) is None:
        return x
    spec = P(*([None] * dim + [axes if len(axes) > 1 else axes[0]]))
    shape = list(x.shape)
    shape[dim] *= math.prod(mesh.shape[a] for a in axes)
    return gather_blocks(x, mesh, spec, shape, tuple(a for a in mesh.axis_names if a in axes))


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, of which this rank
    keeps its block along ``dim`` (``x.shape[dim]`` divided by the ranks,
    in rank order).  ``x`` itself on one rank."""
    group = mesh.group((axis,))
    if group is None:
        return x
    import torch.distributed as dist
    n = mesh.shape[axis]
    parts = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    _record("reduce-scatter", out, (axis,))
    return out


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
    Backward: the gradient summed over ``batch_axes`` (the step's batch and
    sequence axes: their ranks saw other tokens), then this rank's block."""

    @staticmethod
    def forward(ctx, local, mesh, spec, shape, axes, batch_axes):
        ctx.mesh, ctx.spec, ctx.shape, ctx.batch_axes = mesh, spec, shape, batch_axes
        full = gather_blocks(local, mesh, spec, shape, axes)
        return full.view_as(full) if full is local else full

    @staticmethod
    def backward(ctx, grad):
        grad = reduce_over(grad, ctx.mesh, ctx.batch_axes)
        return (grad[Sharding(ctx.mesh, ctx.spec).index(ctx.shape)].contiguous(),
                None, None, None, None, None)


# -------------------------------------------------------- expert parallelism
class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``: the
    ranks along it each hold part of it (each ran its own experts)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group, (ctx.axis,)), None, None


class _Psum(torch.autograd.Function):
    """Sum over ``group`` of partial results that replicated code consumes:
    each rank's part gets the (replicated) gradient of the sum as it is."""

    @staticmethod
    def forward(ctx, x, group, axis, scale):
        ctx.scale = scale
        out = all_reduce(x, group, (axis,))
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, grad):
        return (grad * ctx.scale if ctx.scale != 1.0 else grad), None, None, None


def enter(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` entering code whose ranks along ``axis`` compute different
    parts of its gradient (the reference's replicated ``shard_map`` input)."""
    group = current().mesh.group((axis,))
    return x if group is None else _Enter.apply(x, group, axis)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.psum(x, axis)`` of per-rank partial results."""
    group = current().mesh.group((axis,))
    return x if group is None else _Psum.apply(x, group, axis, 1.0)


def pmean(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.pmean(x, axis)`` of a value every rank along ``axis``
    computed alike."""
    mesh = current().mesh
    group = mesh.group((axis,))
    return x if group is None else _Psum.apply(x, group, axis, 1.0 / mesh.shape[axis])


class _PsumShared(torch.autograd.Function):
    """Sum over mesh ``axes`` of per-rank results that every rank then
    adds to its own share of a loss the step sums over those ranks: the
    backward sums the gradient over them too (the transpose of an
    all-reduce), times ``scale`` both ways."""

    @staticmethod
    def forward(ctx, x, mesh, axes, scale):
        ctx.mesh, ctx.axes, ctx.scale = mesh, axes, scale
        out = all_reduce(x, mesh.group(axes), axes)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, grad):
        grad = reduce_over(grad, ctx.mesh, ctx.axes)
        return (grad * ctx.scale if ctx.scale != 1.0 else grad), None, None, None


def psum_shared(x: torch.Tensor, axes: Sequence[str], scale: float = 1.0) -> torch.Tensor:
    """``scale`` times the sum of ``x`` over the current step's ranks along
    mesh ``axes``, for a value every one of those ranks adds to its share of
    the loss (the step sums the shares over them): unlike :func:`psum`,
    whose consumers are replicated code counted once, each rank's ``x``
    gets the gradient summed over the ranks.  ``x`` (times ``scale``) where
    the axes hold one rank."""
    mesh = current().mesh
    key = tuple(a for a in mesh.axis_names if a in axes)
    if mesh.group(key) is None:
        return x * scale if scale != 1.0 else x
    return _PsumShared.apply(x, mesh, key, scale)


def gather_counts(counts: torch.Tensor) -> torch.Tensor:
    """Every rank's (rows, n) counts along the step's batch axes and its
    sequence axis: (global rows, sequence ranks, n), the rows in the
    batch's global order and, for each, the ranks' blocks of its sequence
    in order (one rank's counts of its own rows without a split)."""
    step = current()
    seq = step.seq_axis
    shape = (counts.shape[0] * step.batch_shards, step.mesh.shape[seq] if seq else 1,
             counts.shape[1])
    return gather_blocks(counts[:, None].contiguous(), step.mesh,
                         P(step.batch_part, seq, None), shape, step.reduce_axes)


def batch_row0(rows: int) -> int:
    """The global index of this rank's first batch row under the current
    step, which holds ``rows`` of them (0 without a split batch)."""
    step = current()
    if step is None or step.batch_group is None:
        return 0
    shape = (rows * step.batch_shards,)
    return Sharding(step.mesh, P(step.batch_part)).index(shape)[0].start


# --------------------------------------------------------- sequence-split compute
_EMBED = "_spmd_embed_axis"


_WHOLE = False


@contextlib.contextmanager
def whole_activations():
    """For tests only: every step built inside computes whole activations,
    the layout the split paths are held against.  No step then has a local
    axis (:func:`local_axis_of`) or a sequence axis (:func:`seq_axis_of`),
    so every head, ffn and vocabulary leaf is gathered for use and the
    sequence stays whole on every rank."""
    global _WHOLE
    prev, _WHOLE = _WHOLE, True
    try:
        yield
    finally:
        _WHOLE = prev


def seq_axis_of(plan: ShardingPlan, mesh: Mesh, seq_len: Optional[int] = None
                ) -> Optional[str]:
    """The mesh axis a step splits the sequence over: the one axis the plan
    maps ``seq`` and ``kv_seq`` to, when the mesh gives it more than one
    rank, the plan's batch does not take it and (given ``seq_len``) it
    divides the sequence, as :meth:`ShardingPlan.spec` would place it.
    None otherwise, and inside :func:`whole_activations`."""
    if _WHOLE:
        return None
    ax = plan.mesh_axes("seq")
    if isinstance(ax, tuple) and len(ax) == 1:
        ax = ax[0]
    if not isinstance(ax, str) or mesh.shape.get(ax, 1) <= 1:
        return None
    if part_axes(plan.mesh_axes("kv_seq")) != (ax,) or ax in part_axes(plan.mesh_axes("batch")):
        return None
    if seq_len is not None and seq_len % mesh.shape[ax]:
        return None
    return ax


def embed_axis_of(plan: ShardingPlan, mesh: Mesh, seq_axis: Optional[str]) -> Optional[str]:
    """The mesh axis that splits the residual's ``embed`` dim in a step
    that splits the sequence over ``seq_axis`` (``tp2d``: ``data``): the
    plan's ``embed`` axis when it has more than one rank and neither the
    batch nor the sequence takes it.  None otherwise."""
    ax = plan.mesh_axes("embed")
    if seq_axis is None or not isinstance(ax, str) or mesh.shape.get(ax, 1) <= 1:
        return None
    if ax == seq_axis or ax in part_axes(plan.mesh_axes("batch")):
        return None
    return ax


def seq_axis() -> Optional[str]:
    """The current step's sequence axis (None outside a step or without one)."""
    step = current()
    return None if step is None else step.seq_axis


def seq_range(n_local: int) -> Tuple[int, int]:
    """This rank's token block ``[o, o + n_local)`` of a sequence split
    over the step's :attr:`Step.seq_axis` in :class:`Sharding`'s block order
    (``(0, n_local)`` without one)."""
    ax = seq_axis()
    return (0 if ax is None else axis_index(ax) * n_local), n_local


def seq_length(n_local: int) -> int:
    """The global length of a sequence of which this rank holds ``n_local``
    tokens."""
    ax = seq_axis()
    return n_local if ax is None else n_local * current().mesh.shape[ax]


def seq_block(total: int) -> Tuple[int, int]:
    """:func:`seq_range` of this rank's share of a sequence of ``total``
    positions: the VLM's patches and prompt are one such sequence."""
    return seq_range(total // seq_length(1))


def seq_share(total_sum: torch.Tensor, count: int) -> torch.Tensor:
    """A loss summed over this rank's part of ``count`` positions that the
    ranks along the step's sequence axis hold in unequal parts (the VLM's
    text), as the per-rank value the step averages: the rank's share
    ``total_sum / count`` times the ranks along the axis, so that the mean
    over them (:meth:`Step.batch_mean`, and the gradient's
    ``1 / loss_shards``) is the sum of the shares, the global mean."""
    ax = seq_axis()
    ranks = 1 if ax is None else current().mesh.shape[ax]
    return total_sum * (ranks / count)


class _GatherSum(torch.autograd.Function):
    """Forward: every rank's block along ``dim``, gathered over mesh
    ``axis`` in rank order, of which the first ``keep`` positions are kept.
    Backward: the gradient padded with zeros to the whole, summed over the
    axis and cut to this rank's block (a reduce-scatter): every rank used
    the whole, so each block's gradient is the sum of theirs (a rank's keys
    get the gradient of every later rank's queries)."""

    @staticmethod
    def forward(ctx, x, axis, dim, keep):
        # the mesh is kept: on the card the autograd engine runs the backward
        # on its own thread, outside the step's context
        ctx.mesh, ctx.axis, ctx.dim = current().mesh, axis, dim
        full = gather_over(x, axis, dim)
        ctx.total = full.shape[dim]
        return full if keep >= ctx.total else full.narrow(dim, 0, keep)

    @staticmethod
    def backward(ctx, grad):
        if grad.shape[ctx.dim] < ctx.total:
            pad = list(grad.shape)
            pad[ctx.dim] = ctx.total - grad.shape[ctx.dim]
            grad = torch.cat([grad, grad.new_zeros(pad)], dim=ctx.dim)
        return reduce_scatter(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def gather_seq(x: torch.Tensor, dim: int, keep: Optional[int] = None) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim`` over the step's sequence
    axis, in order, cut to its first ``keep`` positions (default all): the
    keys and values a rank's queries see.  Differentiable: the backward
    reduce-scatters.  ``x`` itself without a sequence axis."""
    ax = seq_axis()
    if ax is None:
        return x if keep is None else x.narrow(dim, 0, keep)
    total = x.shape[dim] * current().mesh.shape[ax]
    return _GatherSum.apply(x, ax, dim, total if keep is None else keep)


def gather_used(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim`` over mesh ``axis``, in
    order, for code every rank runs on the whole but whose gradient each
    rank holds in part: the backward sums the gradient over the axis and
    keeps this rank's block (a reduce-scatter).  ``x`` itself on one rank."""
    if current().mesh.group((axis,)) is None:
        return x
    return _GatherSum.apply(x, axis, dim, x.shape[dim] * current().mesh.shape[axis])


def seq_edges(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For a (B, S, ...) activation the step splits along the sequence: the
    last ``n`` positions (dim 1) of the previous rank's block, the halo a
    token shift or a causal convolution reads across the block boundary
    (zeros on the first rank), and the last ``n`` of the whole sequence
    (the last rank's, on every rank: what a prompt pass leaves in a
    recurrent cache).  One gather of every rank's last ``n`` rows;
    differentiable: a row's gradient goes back to the rank that sent it, and
    every rank, the first too, takes part in the backward."""
    ax = seq_axis()
    zeros = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    if x.shape[1] < n:
        raise ValueError(f"a block of {x.shape[1]} positions cannot hand on the last {n}")
    tails = gather_seq(x[:, x.shape[1] - n:], 1)          # (B, R n, ...)
    padded = torch.cat([zeros, tails], dim=1)
    return padded.narrow(1, axis_index(ax) * n, n), tails[:, tails.shape[1] - n:]


def _gather_dim(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along mesh ``axis`` concatenated along ``dim`` in
    rank order (``mesh`` given: a backward runs outside the step's context)."""
    shape = list(x.shape)
    shape[dim] *= mesh.shape[axis]
    return gather_blocks(x, mesh, P(*([None] * dim + [axis])), shape, (axis,))


class _ScatterSum(torch.autograd.Function):
    """Forward: the sum over ``axis`` of which this rank keeps its block
    along ``dim`` (a reduce-scatter).  Backward: the blocks' gradients
    gathered (every rank's part fed every block)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = current().mesh, axis, dim
        return reduce_scatter(x, ctx.mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None


class _GatherOwn(torch.autograd.Function):
    """Forward: every rank's block along ``dim`` gathered over ``axis``, for
    code every rank runs alike on the whole.  Backward: this rank's block of
    the (alike) gradient."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = current().mesh, axis, dim, x.shape[dim]
        return _gather_dim(x, ctx.mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        at = ctx.mesh.coords()[ctx.axis] * ctx.n
        return grad.narrow(ctx.dim, at, ctx.n).contiguous(), None, None


def scatter_sum(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over mesh ``axis`` of the
    ranks' partial results ``x`` (a reduce-scatter, differentiable); ``x``
    itself on one rank."""
    if current().mesh.group((axis,)) is None:
        return x
    return _ScatterSum.apply(x, axis, dim)


def gather_alike(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Every rank's block ``x`` along ``dim`` over mesh ``axis``, in order,
    for code every rank then runs alike (differentiable: each block gets its
    own part of the gradient back); ``x`` itself on one rank."""
    if current().mesh.group((axis,)) is None:
        return x
    return _GatherOwn.apply(x, axis, dim)


def unsplit(params: dict, dims: dict) -> dict:
    """``params`` with every leaf named in ``dims`` that the step left split
    for local compute (:func:`local_of`) gathered along its dim ``dims[name]``
    (:func:`gather_alike`): for a layer whose local rule does not fit this
    split (a block of columns that cuts a head), which then runs whole on
    every rank."""
    return {n: gather_alike(t, local_of(t), dims[n]) if n in dims and local_of(t) else t
            for n, t in params.items()}


def store(slot: torch.Tensor, value: torch.Tensor, logical: str, dim: int) -> None:
    """Write a recurrent state into its serving-cache slot (a view of a
    cache leaf: all of it, or this rank's block under the serving plan):
    ``value`` holds all of the ``logical`` dim (``dim`` of the slot), or
    this rank's block of it over the step's :attr:`Step.local_axis` (then
    gathered where the slot holds more).  Outside a step: a copy."""
    step = current()
    split = cache_split(slot) if step is not None else None
    whole = slot.shape[dim] if split is None else split.shape[split.axes.index(logical)]
    if value.shape[dim] not in (whole, slot.shape[dim]):
        value = gather_over(value, step.local_axis, dim)
    if value.shape[dim] != slot.shape[dim]:
        off, n = split.block(logical)
        value = value.narrow(dim, off, n)
    slot.copy_(value)


def carry_states(state: torch.Tensor, log_decay: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrent state entering this rank's token block, and the state
    after the last rank's, for a linear recurrence ``h_t = a_t h_{t-1} +
    x_t`` whose sequence the step splits: ``state`` is this rank's block
    scanned from zero (its own final state) and ``log_decay`` the block's
    summed log-decay, broadcastable against it.  Both are gathered over the
    sequence axis (differentiable: the backward reduce-scatters) and folded
    in rank order in float32, ``H(r + 1) = exp(L_r) H(r) + S_r`` from
    ``H(0) = 0``, the same on every rank."""
    s, ld = state.float(), log_decay.float()
    ss = gather_seq(s[None], 0)                          # (R, ...) in rank order
    lds = gather_seq(ld[None], 0)
    h = [torch.zeros_like(s)]
    for j in range(ss.shape[0]):
        h.append(torch.exp(lds[j]) * h[-1] + ss[j])
    # every rank's graph holds every gathered block (the first rank's too),
    # so the backward's reduce-scatter runs on all of them
    hs = torch.stack(h)
    return hs[axis_index(seq_axis())], hs[-1]


def last_token(x: torch.Tensor) -> torch.Tensor:
    """The last position of a (B, S, ...) activation whose sequence the
    step splits: the last rank's, on every rank (``x[:, -1:]`` without a
    sequence axis)."""
    ax = seq_axis()
    last = x[:, -1:]
    return last if ax is None else gather_over(last, ax, 1)[:, -1:]


def mark_embed(t: torch.Tensor, axis: str) -> torch.Tensor:
    """Mark ``t`` as holding this rank's block of its ``embed`` dim along
    ``axis``; returns ``t``."""
    setattr(t, _EMBED, axis)
    return t


def embed_of(t: torch.Tensor) -> Optional[str]:
    """The mesh axis ``t``'s ``embed`` dim is split over, as
    :meth:`Step.for_use` left it under ``tp2d``; None for a whole one."""
    return getattr(t, _EMBED, None)


# ------------------------------------------------ head-, ffn-, vocab-local compute
# the logical axes a layer with a local rule computes in parts
LOCAL_AXES = ("q_heads", "kv_heads", "ffn", "vocab", "ssm_heads")
_LOCAL = "_spmd_local_axis"


def local_axis_of(plan: ShardingPlan, mesh: Mesh, batch_axes: Sequence[str]) -> Optional[str]:
    """The mesh axis a step computes heads, ffn columns and vocabulary
    slices over: the one axis the plan maps ``q_heads``, ``ffn`` and
    ``vocab`` to, when it has more than one rank, does not split the batch
    and the plan splits no sequence over the mesh (``tp2d``, ``zero3_sp``,
    ``sequence_parallel``: ``seq`` claims that axis first, so heads, ffn and
    vocabulary are whole in the reference's layout; :func:`seq_axis_of`).
    None otherwise, and inside :func:`whole_activations`."""
    if _WHOLE:
        return None
    parts = {plan.mesh_axes(a) for a in ("q_heads", "ffn", "vocab")}
    if len(parts) != 1:
        return None
    ax = parts.pop()
    if not isinstance(ax, str) or mesh.shape.get(ax, 1) <= 1 or ax in batch_axes:
        return None
    if any(a in mesh.shape for a in part_axes(plan.mesh_axes("seq"))):
        return None
    return ax


def mark_local(t: torch.Tensor, axis: str) -> torch.Tensor:
    """Mark ``t`` as computed over this rank's block along ``axis`` (the
    logits of a vocabulary-local head); returns ``t``."""
    setattr(t, _LOCAL, axis)
    return t


def local_of(t: torch.Tensor) -> Optional[str]:
    """The mesh axis ``t``'s head / ffn / vocab dim is split over, as
    :meth:`Step.for_use` left it for local compute; None for a whole one."""
    return getattr(t, _LOCAL, None)


def axis_index(axis: str) -> int:
    """This rank's coordinate along mesh ``axis`` of the current step."""
    return current().mesh.coords()[axis]


def vocab_xent_sum(logits: torch.Tensor, labels: torch.Tensor, axis: str) -> torch.Tensor:
    """Summed token cross-entropy of logits split over ``axis`` along the
    vocabulary (this rank's block, in rank order): the max and the sum of
    exponentials, and the label's logit (on the rank that holds it), reduced
    over the axis.  ``logits`` (..., V_local); labels (...) global ids."""
    lf = logits.float()
    n = lf.shape[-1]
    v0 = axis_index(axis) * n
    mx = reduce_over(lf.detach().amax(dim=-1), current().mesh, (axis,), op="max")
    sumexp = psum(torch.exp(lf - mx[..., None]).sum(dim=-1), axis)
    at = labels.long() - v0
    mine = (at >= 0) & (at < n)
    gold = torch.gather(lf, -1, at.clamp(0, n - 1)[..., None])[..., 0]
    gold = psum(torch.where(mine, gold, torch.zeros_like(gold)), axis)
    return torch.sum(torch.log(sumexp) + mx - gold)


# -------------------------------------------------------------- step context
class Step:
    """One rank's view of a plan-sharded step: the plan, the mesh, the mesh
    axes the batch is split over, the expert axis, the local axis and the
    sequence and embed axes, if any."""

    def __init__(self, plan: ShardingPlan, mesh: Mesh, batch_part, local_batch: int,
                 cache: Optional[dict] = None, local: bool = False,
                 seq_axis: Optional[str] = None):
        """``batch_part``: the batch dim's entry of the batch's spec (None,
        an axis, or axes in the order the rows are blocked);
        ``local_batch``: the rows this rank holds; ``cache``: a serving
        step's cache leaves (name -> (this rank's tensor, its
        :class:`CacheSplit`)); ``local``: compute heads, ffn columns and
        vocabulary locally where the plan allows it (:attr:`local_axis`);
        ``seq_axis``: the mesh axis the rank's tokens are a block of
        (:func:`seq_axis_of`), None for a whole sequence."""
        self.plan, self.mesh, self.batch_part = plan, mesh, batch_part
        self.local_batch = local_batch
        self._cache = {t.untyped_storage().data_ptr(): split
                       for t, split in (cache or {}).values()}
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
        self.local_axis = local_axis_of(plan, mesh, self.batch_axes) if local else None
        if seq_axis is not None and (seq_axis in self.batch_axes
                                     or mesh.shape.get(seq_axis, 1) <= 1):
            raise ValueError(f"{seq_axis!r} cannot split the sequence on {mesh.shape} with the "
                             f"batch over {self.batch_axes}")
        self.seq_axis = seq_axis
        self.embed_axis = embed_axis_of(plan, mesh, seq_axis)
        # the ranks whose tokens differ: a gradient and a mean are summed over them
        reduce = set(self.batch_axes) | ({seq_axis} if seq_axis else set())
        self.reduce_axes = tuple(a for a in mesh.axis_names if a in reduce)
        self.reduce_group = mesh.group(self.reduce_axes)
        self.loss_shards = math.prod(mesh.shape[a] for a in self.reduce_axes)

    def for_use(self, leaf: torch.Tensor, placement: Placement) -> torch.Tensor:
        """``leaf`` (this rank's shard) gathered over every mesh axis its
        placement splits it over, but a grouped expert weight's ``experts``
        dim under expert parallelism, a head / ffn / vocab dim split over
        :attr:`local_axis` (the result is then marked: :func:`local_of`) and
        an ``embed`` dim under :attr:`embed_axis` (marked: :func:`embed_of`).
        Its gradient is summed over :attr:`reduce_axes` (a grouped expert
        weight's not over the expert axis: its rank saw every token its
        experts took)."""
        keep = set()
        reduce = self.reduce_axes
        if self.expert_axis is not None and placement.axes[:1] == ("experts",) \
                and placement.sharding.spec[0] == self.expert_axis:
            keep.add(0)          # a grouped expert weight keeps its experts local
            # the expert's whole gradient is on its own rank, even where the
            # sequence is split over the expert axis (the tokens are gathered)
            reduce = tuple(a for a in reduce if a != self.expert_axis)
        spec = placement.sharding.spec
        local = {i for i, ax in enumerate(placement.axes)
                 if self.local_axis is not None and ax in LOCAL_AXES
                 and i < len(spec) and spec[i] == self.local_axis}
        keep |= local
        embed = set()
        if self.embed_axis is not None:
            embed = {i for i, ax in enumerate(placement.axes) if ax == "embed"}
            if any(i >= len(spec) or spec[i] != self.embed_axis for i in embed):
                raise ValueError(f"a leaf of {placement.shape} over {placement.axes} does not "
                                 f"split its embed dim over {self.embed_axis!r} ({spec}): "
                                 f"the step splits the residual's")
            keep |= embed
        spec = P(*(None if i in keep else part for i, part in enumerate(spec)))
        shape = tuple(leaf.shape[i] if i in keep else n
                      for i, n in enumerate(placement.shape))
        axes = Sharding(self.mesh, spec).mesh_axes()
        if self.mesh.group(axes) is None and self.mesh.group(reduce) is None:
            out = leaf
        else:
            out = _ForUse.apply(leaf, self.mesh, spec, shape, axes, reduce)
        if embed:
            mark_embed(out, self.embed_axis)
        return mark_local(out, self.local_axis) if local else out

    def cache_split(self, t: torch.Tensor) -> Optional["CacheSplit"]:
        """The :class:`CacheSplit` of the serving cache leaf ``t`` is (a view
        of), or None."""
        return self._cache.get(t.untyped_storage().data_ptr()) if self._cache else None

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the batch (and sequence) shards of a per-rank mean."""
        if self.reduce_group is None:
            return x
        return all_reduce(x.detach().float(), self.reduce_group, self.reduce_axes) \
            / self.loss_shards

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
        total = reduce_over(torch.stack(sq).sum(), self.mesh, self.mesh.axis_names)
        return torch.sqrt(total)


# ---------------------------------------------------------- serving cache
@dataclass(frozen=True)
class CacheSplit:
    """How this rank holds one leaf of a plan-sharded serving cache: its
    Sharding, global shape and logical axes."""
    sharding: Sharding
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]

    def mesh_axes_of(self, logical: str) -> Tuple[str, ...]:
        """The mesh axes that split the leaf's ``logical`` dim, in the order
        its spec lists them (() when that dim is whole or absent)."""
        if logical not in self.axes:
            return ()
        part = self.sharding.spec[self.axes.index(logical)] \
            if self.axes.index(logical) < len(self.sharding.spec) else None
        return tuple(a for a in part_axes(part) if self.sharding.mesh.shape[a] > 1)

    def block(self, logical: str) -> Tuple[int, int]:
        """(offset, length) of this rank's block along ``logical``."""
        i = self.axes.index(logical)
        sl = self.sharding.index(self.shape)[i]
        return sl.start, sl.stop - sl.start

    def split_dims(self) -> Tuple[Optional[str], ...]:
        """The logical axes of the dims this rank holds only a part of, but
        the batch (the step's rows are split the same way)."""
        counts = self.sharding.shard_counts(len(self.shape))
        return tuple(a for a, n in zip(self.axes, counts) if n > 1 and a != "batch")


def cache_split(t: torch.Tensor) -> Optional[CacheSplit]:
    """The current serving step's split of the cache leaf ``t`` (or a view
    of it), None outside one."""
    step = current()
    return None if step is None else step.cache_split(t)


def cache_length(t: torch.Tensor, dim: int) -> int:
    """The global length of dim ``dim`` of the cache leaf ``t``: its own
    outside a serving step or where the leaf is whole along it."""
    split = cache_split(t)
    return t.shape[dim] if split is None else split.shape[dim]


def require_whole(cache: dict, names: Sequence[str], family: str) -> None:
    """Raise ``NotImplementedError`` where the current serving step splits
    one of the cache leaves ``names`` (other than over the batch): the
    decode step of ``family`` takes them whole."""
    for name in names:
        split = cache_split(cache[name])
        if split is not None and split.split_dims():
            raise NotImplementedError(
                f"{family}: the plan splits the cache leaf {name!r} over "
                f"{split.split_dims()} ({split.sharding.spec}); the decode step takes it "
                f"whole")


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


class Stacked:
    """A parameter stacked along its first ``lead`` (``layers``) dims as a
    plan-sharded serving step hands it to the model: ``self[i]`` (or
    ``self[g, a]``) is that layer's local view, tagged with its per-layer
    placement, so :func:`for_use` (``layers.remat``) gathers it where the
    layer runs."""

    def __init__(self, local: torch.Tensor, placement: Placement):
        self._local, self._placement = local, placement

    def __getitem__(self, idx) -> torch.Tensor:
        return tag(self._local[idx], self._placement)

    def for_use(self) -> "UsedLayers":
        """Handed whole to ``layers.remat`` (zamba2's groups): each layer is
        gathered as it is indexed."""
        return UsedLayers(self)


class UsedLayers:
    """Stacked layers (a :class:`Stacked`, or a train step's per-layer
    autograd leaves) as ``layers.remat`` hands them to the model: each layer
    gathered for use as it is indexed."""

    def __init__(self, stacked):
        self._stacked = stacked

    def __getitem__(self, idx) -> torch.Tensor:
        return for_use(self._stacked[idx])


def serving_params(params: Any, axes: Any, placements: Any) -> Any:
    """The tree a plan-sharded serving step hands the model, from this
    rank's shards: a parameter stacked along ``layers`` as a
    :class:`Stacked` (gathered a layer at a time where the layer runs), every
    other one gathered once now.  Call it inside the step's context."""
    from repro_torch.models.param import tree_map

    def one(p: torch.Tensor, ax, pl: Placement):
        lead = 0
        while lead < len(ax) and ax[lead] == "layers":
            lead += 1
        if lead:
            return Stacked(p, pl.per_layer(lead))
        return for_use(tag(p.detach(), pl))

    return tree_map(one, params, axes, placements, is_leaf=lambda x: isinstance(x, torch.Tensor))
