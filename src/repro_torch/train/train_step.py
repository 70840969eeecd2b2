"""The train step: microbatched gradient accumulation + optimizer update.

Counterpart of ``repro/train/train_step.py`` on one device.  The step is
eager PyTorch: the model's ``loss_fn`` runs forward (its blocks recomputed in
the backward when ``cfg.remat``), ``backward`` runs every kernel's backward
(K2's, K1's, K4's through ``kernels.ops``), and the optimizer updates the
parameters and its state in place (:mod:`repro_torch.train.optimizer`).

Gradients land in one buffer per parameter: in the parameter's dtype for
one microbatch, in float32 when microbatches are accumulated.  A parameter
stacked along ``layers`` is handed to the model as one autograd leaf per
layer, a view of its storage whose gradient is a view of that buffer:
autograd adds each layer's gradient into its slice in place.  Indexing the
stacked tensor itself would make autograd build a zero tensor of the whole
stack for every layer and add them up.  Where the buffer's dtype is not the
parameter's (bf16 parameters accumulated in float32), the leaf keeps its own
gradient in its dtype and it is added into the buffer after the backward,
as the reference adds each microbatch's gradient cast to float32.

Plan-sharded training keeps the reference's names: ``state_logical_axes``,
``state_shardings``, ``batch_shardings``, ``make_train_step(api, tcfg, plan,
mesh)`` and ``jit_train_step``.  Nothing is compiled: the step runs eagerly
on every rank, on the rank's shards of the state and rows of the batch, as
``parallel/spmd.py`` describes (each parameter gathered where a layer uses
it, or left split where the layer computes its heads, ffn columns or
vocabulary locally; its gradient summed over the batch axes and sliced to
the rank's shard; the global clip norm; the optimizer on the shards: AdamW elementwise,
Adafactor's means and int8's scales over whole leaves).  Under a plan that
splits the sequence (``tp2d``, ``zero3_sp``, ``sequence_parallel``) every
family (``ModelAPI.sequence_split``; under ``tp2d``, which splits ``embed``
too, only one with embed-split rules, ``ModelAPI.embed_split``) keeps each
rank's block of the tokens and labels (the VLM takes them and its patches
whole and builds its block of [patches; prompt]) and computes only that
block; the
gradients and the loss are then summed over the sequence axis too.  On a
mesh of one rank it is the unsharded step's arithmetic.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.api import ModelAPI
from repro_torch.models.convert import from_reference
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import (P, Mesh, Sharding, ShardingPlan,
                                           is_sharding_leaf, tree_map_axes)
from . import grad_compress, optimizer as opt

Params = Any


@dataclass
class TrainState:
    params: Params
    opt_state: Any
    residual: Optional[Params] = None


def init_state(api: ModelAPI, tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
               device="cuda", shardings: Optional[TrainState] = None) -> TrainState:
    """Parameters drawn from ``generator`` (seeded with ``tcfg.seed`` when
    not given) in the spec's dtype, a zero optimizer state and, with int8
    gradient compression, a zero residual.  With ``shardings``
    (:func:`state_shardings`) every rank draws the same parameters and keeps
    its shards."""
    if generator is None:
        generator = torch.Generator(device=torch.device(device)).manual_seed(tcfg.seed)
    params = api.init(generator, device,
                      shardings=None if shardings is None else shardings.params)
    res = grad_compress.init_residual(params) if tcfg.grad_compression == "int8" else None
    return TrainState(params, opt.opt_init(params, tcfg), res)


def abstract_state(api: ModelAPI, tcfg: TrainConfig) -> TrainState:
    """The train state's shapes and dtypes as ``meta`` tensors (no
    allocation): what a checkpoint is restored into at start-up."""
    params = api.abstract_params()
    res = grad_compress.init_residual(params) if tcfg.grad_compression == "int8" else None
    return TrainState(params, opt.opt_init(params, tcfg), res)


def train_state_from_reference(params_numpy: Dict[str, Any], opt_state_numpy: Dict[str, Any],
                               residual_numpy=None, device="cuda") -> TrainState:
    """The reference's train state as the port's, on ``device``.

    The trees are nested dicts of numpy arrays, as for
    ``models.convert.from_reference``.  ``opt_state_numpy`` is the
    reference's optimizer state as a dict of its fields (``state._asdict()``
    with every leaf turned into numpy): ``step``, ``mu``, ``nu`` for AdamW,
    ``step``, ``vr``, ``vc``, ``v`` for Adafactor (whose placeholder scalars
    stay 0-d tensors).  ``residual_numpy`` is the int8 compression's
    error-feedback residual, or None."""
    fields = {name: from_reference(tree, device) for name, tree in opt_state_numpy.items()}
    fields["step"] = fields["step"].to(torch.int32)
    cls = opt.AdafactorState if "vr" in fields else opt.AdamWState
    residual = None if residual_numpy is None else from_reference(residual_numpy, device)
    return TrainState(from_reference(params_numpy, device), cls(**fields), residual)


class LayerLeaves:
    """A parameter stacked along its first ``lead`` dimensions seen as one
    autograd leaf per layer: ``self[i]`` (or ``self[g, a]``) is
    ``bind(stacked[i], grad[i])``."""

    def __init__(self, stacked: torch.Tensor, grad: torch.Tensor, lead: int,
                 bind: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
        self._leaves = {idx: bind(stacked[idx], grad[idx])
                        for idx in itertools.product(*(range(n) for n in stacked.shape[:lead]))}

    def __getitem__(self, idx) -> torch.Tensor:
        return self._leaves[idx if isinstance(idx, tuple) else (idx,)]

    def for_use(self) -> "spmd.UsedLayers":
        """What a plan-sharded step's ``layers.remat`` hands the model when
        the whole tree goes in (zamba2's groups): each layer gathered as it
        is indexed."""
        return spmd.UsedLayers(self)


def _tmap(fn: Callable, tree, *rest):
    return tree_map(fn, tree, *rest, is_leaf=lambda x: isinstance(x, torch.Tensor))


def zero_grads(params: Params, dtype: Optional[torch.dtype] = None) -> Params:
    return _tmap(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device),
                 params)


def accumulate_grad(api: ModelAPI, params: Params, batch: Dict[str, torch.Tensor],
                    grads: Params, placements: Optional[Params] = None,
                    loss_scale: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run ``api.loss_fn(params, batch)`` and its backward, adding the
    gradient of every parameter into ``grads`` (a tree of buffers shaped
    like ``params``) in place.  Returns the loss and metrics, detached.

    Inside a plan-sharded step, ``params`` are the rank's shards and
    ``placements`` their ``spmd.Placement``s: the model sees each parameter
    gathered for use (a layer's inside ``layers.remat``), and the backward
    runs on the loss times ``loss_scale``."""
    unbound = []            # (leaf, buffer) whose dtypes differ

    def bind(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        leaf = p.detach().requires_grad_()
        if g.dtype == p.dtype:
            leaf.grad = g
        else:
            unbound.append((leaf, g))
        return leaf

    def leaf_of(p: torch.Tensor, g: torch.Tensor, axes, pl=None) -> Any:
        lead = 0
        while lead < len(axes) and axes[lead] == "layers":
            lead += 1
        if pl is None:
            return LayerLeaves(p, g, lead, bind) if lead else bind(p, g)
        if lead:
            per = pl.per_layer(lead)
            return LayerLeaves(p, g, lead, lambda a, b: spmd.tag(bind(a, b), per))
        return spmd.for_use(spmd.tag(bind(p, g), pl))

    trees = (params, grads, api.param_axes()) + (() if placements is None else (placements,))
    model_params = tree_map(leaf_of, *trees, is_leaf=lambda x: isinstance(x, torch.Tensor))
    with torch.enable_grad():
        loss, metrics = api.loss_fn(model_params, batch)
        (loss if loss_scale == 1.0 else loss * loss_scale).backward()
    for leaf, g in unbound:
        if leaf.grad is not None:
            g.add_(leaf.grad)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def value_and_grad(api: ModelAPI, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Params]:
    """The loss, its metrics and the gradient of every parameter (in the
    parameters' dtype), as ``jax.value_and_grad(loss_fn, has_aux=True)``."""
    grads = zero_grads(params)
    loss, metrics = accumulate_grad(api, params, batch, grads)
    return loss, metrics, grads


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    return [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def _step(api: ModelAPI, tcfg: TrainConfig, state: TrainState,
          batch: Dict[str, torch.Tensor], sharded: Optional[spmd.Step] = None,
          placements: Optional[Params] = None, opt_specs: Optional[list] = None):
    """One step on ``state`` in place: the loss and gradients (averaged in
    float32 over ``tcfg.microbatches``), the int8 error-feedback round trip
    when asked for, then the optimizer.  ``sharded`` runs it as one rank of
    a plan-sharded step (``state`` and ``batch`` the rank's shards,
    ``placements`` the parameters', ``opt_specs`` each leaf's Adafactor
    ``vr`` / ``vc`` specs): int8's scales and Adafactor's means are then the
    whole leaves'."""
    scale = 1.0 if sharded is None else 1.0 / sharded.loss_shards
    norm_fn = None if sharded is None else (lambda g: sharded.global_norm(g, placements))
    if tcfg.microbatches <= 1:
        grads = zero_grads(state.params)
        loss, metrics = accumulate_grad(api, state.params, batch, grads, placements, scale)
    else:
        grads = zero_grads(state.params, torch.float32)
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for mb in _split_microbatches(batch, tcfg.microbatches):
            mb_loss, _ = accumulate_grad(api, state.params, mb, grads, placements, scale)
            loss = loss + mb_loss
        n = float(tcfg.microbatches)
        for g in opt._leaves(grads):
            g.div_(n)
        loss = loss / n
        metrics = {"loss": loss}
    residual = state.residual
    if tcfg.grad_compression == "int8" and residual is not None:
        grads, residual = grad_compress.roundtrip(grads, residual, placements)
    split = {} if sharded is None else {
        "placements": spmd.placement_leaves(placements), "state_specs": opt_specs}
    params, opt_state, opt_metrics = opt.opt_update(grads, state.opt_state, state.params,
                                                    tcfg, norm_fn=norm_fn, **split)
    metrics = dict(metrics)
    metrics["loss"] = loss
    if sharded is not None:
        metrics = {k: sharded.batch_mean(v) for k, v in metrics.items()}
    metrics.update(opt_metrics)
    return TrainState(params, opt_state, residual), metrics


def make_train_step(api: ModelAPI, tcfg: TrainConfig,
                    plan: Optional[ShardingPlan] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss and
    gradients (averaged in float32 over ``tcfg.microbatches``), the int8
    error-feedback round trip when asked for, then the optimizer.  The state
    is updated in place and returned.

    With ``plan`` and ``mesh`` the step is one rank's part of the
    plan-sharded step: ``state`` holds the rank's shards
    (:func:`state_shardings`) and ``batch`` is the global batch, which
    every rank passes alike (:func:`jit_train_step` also takes the rank's
    rows); the metrics are the global step's."""
    if plan is None or mesh is None:
        return lambda state, batch: _step(api, tcfg, state, batch)
    return _planned_step(api, tcfg, plan, mesh)


def param_placements(api: ModelAPI, plan: ShardingPlan, mesh: Mesh) -> Params:
    """``spmd.Placement`` of every parameter under ``plan`` on ``mesh``."""
    shapes = api.abstract_params()
    return tree_map_axes(
        lambda ax, s: spmd.Placement(Sharding(mesh, plan.spec(ax, tuple(s.shape), mesh)),
                                     tuple(s.shape), ax),
        api.param_axes(), shapes)


def _planned_step(api: ModelAPI, tcfg: TrainConfig, plan: ShardingPlan, mesh: Mesh,
                  batch_specs: Optional[Dict[str, Any]] = None) -> Callable:
    placements = param_placements(api, plan, mesh)
    st_sh = state_shardings(api, tcfg, plan, mesh)
    abstract = abstract_state(api, tcfg)
    opt_specs = None
    if tcfg.optimizer == "adafactor":
        leaves = lambda t: tree_leaves(t, is_leaf=is_sharding_leaf)
        opt_specs = [{"vr": r.spec, "vc": c.spec}
                     for r, c in zip(leaves(st_sh.opt_state.vr), leaves(st_sh.opt_state.vc))]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state = place_tree(state, st_sh, abstract)
        seq = seq_split_axis(api, plan, mesh, (batch_specs or batch)["tokens"].shape[1])
        local, batch_part = local_batch(batch, batch_specs, plan, mesh,
                                        seq if api.block_inputs else None)
        # the model sees one microbatch's rows at a time
        rows = local["tokens"].shape[0] // max(1, tcfg.microbatches)
        step = spmd.Step(plan, mesh, batch_part, rows, local=api.local_compute, seq_axis=seq)
        with spmd.step_context(step):
            return _step(api, tcfg, state, local, step, placements, opt_specs)

    return train_step


def seq_split_axis(api: ModelAPI, plan: ShardingPlan, mesh: Mesh, seq_len: int
                   ) -> Optional[str]:
    """The mesh axis a step of ``api``'s family splits a prompt of
    ``seq_len`` tokens over under ``plan`` (``spmd.seq_axis_of`` of each of
    ``ModelAPI.seq_lengths``: the VLM's patches and prompt together, the
    encoder-decoder's frames too), None where the family has no
    sequence-split rules, the plan splits none or the axis does not divide
    those lengths, or the plan also splits the residual's ``embed``
    (``tp2d``) and the family has no rules for that
    (``ModelAPI.embed_split``)."""
    if not api.sequence_split:
        return None
    axes = {spmd.seq_axis_of(plan, mesh, n) for n in api.seq_lengths(seq_len)}
    ax = axes.pop() if len(axes) == 1 else None
    if ax is not None and not api.embed_split and spmd.embed_axis_of(plan, mesh, ax):
        return None
    return ax


def local_batch(batch: Dict[str, torch.Tensor], batch_specs: Optional[Dict[str, Any]],
                plan: ShardingPlan, mesh: Mesh, seq_axis: Optional[str] = None
                ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """The batch as this rank's step uses it (given whole, or as this rank's
    rows under :func:`batch_shardings` of ``batch_specs``, None: the batch
    is whole): the rows stay this rank's; a split over any other axis is
    gathered, but the sequence's over ``seq_axis`` (:func:`seq_split_axis`),
    whose block stays this rank's.  Also the batch dim's entry of the
    tokens' spec."""
    specs = batch_specs if batch_specs is not None else batch
    b_sh = batch_shardings(specs, plan, mesh)
    local = {}
    for k, x in batch.items():
        x = place_leaf(x, b_sh[k], tuple(specs[k].shape))
        if seq_axis is not None and x.dim() >= 2:
            if b_sh[k].spec[1:2] != (seq_axis,):
                raise ValueError(f"{k}: the plan does not split its sequence over "
                                 f"{seq_axis!r} ({b_sh[k].spec})")
            local[k] = x
            continue
        use = P(None, *b_sh[k].spec[1:])
        shape = tuple(x.shape[:1]) + tuple(specs[k].shape[1:])
        local[k] = spmd.gather_blocks(x, mesh, use, shape, Sharding(mesh, use).mesh_axes())
    return local, b_sh["tokens"].spec[0]


def place_leaf(x: torch.Tensor, sharding: Sharding, shape: Tuple[int, ...]) -> torch.Tensor:
    """``x`` as this rank holds it under ``sharding``: as it is when it has
    the local shape, its slice when it has the global ``shape`` (what
    ``jax.jit``'s in_shardings do to a global array)."""
    want = sharding.local_shape(shape)
    if tuple(x.shape) == want:
        return x
    if tuple(x.shape) == tuple(shape):
        return sharding.local(x).clone()
    raise ValueError(f"a leaf of shape {tuple(x.shape)} is neither the global {tuple(shape)} "
                     f"nor the local {want} under {sharding.spec}")


def place_tree(tree: Any, shardings: Any, shapes: Any) -> Any:
    """:func:`place_leaf` over a tree (a TrainState; None stays None)."""
    return tree_map_axes(lambda sh, x, s: x if sh is None else place_leaf(x, sh, tuple(s.shape)),
                         shardings, tree, shapes, is_leaf=is_sharding_leaf)


def state_logical_axes(api: ModelAPI, tcfg: TrainConfig) -> TrainState:
    paxes = api.param_axes()
    res = paxes if tcfg.grad_compression == "int8" else None
    return TrainState(paxes, opt.opt_state_axes(paxes, tcfg), res)


def state_shardings(api: ModelAPI, tcfg: TrainConfig, plan: ShardingPlan,
                    mesh: Mesh) -> TrainState:
    """Sharding tree for the TrainState under a plan."""
    def one(ax, shaped):
        if shaped is None:
            return None
        if ax is None or not isinstance(ax, tuple):
            ax = ()
        spec = plan.spec(ax, tuple(shaped.shape), mesh) \
            if len(ax) == len(shaped.shape) else P()
        return Sharding(mesh, spec)

    return tree_map_axes(one, state_logical_axes(api, tcfg), abstract_state(api, tcfg))


def batch_shardings(batch_specs: Dict[str, Any], plan: ShardingPlan,
                    mesh: Mesh) -> Dict[str, Any]:
    """tokens/labels (B, S) over ("batch", "seq"); frames/patches (B, L, D)
    over ("batch", "seq", None); a scalar replicated."""
    def one(shaped):
        nd = len(shaped.shape)
        if nd == 0:
            return Sharding(mesh, P())
        axes = ("batch",) + (None,) * (nd - 1)
        if nd >= 2:
            axes = ("batch", "seq") + (None,) * (nd - 2)
        return Sharding(mesh, plan.spec(axes, tuple(shaped.shape), mesh))
    return {k: one(v) for k, v in batch_specs.items()}


def jit_train_step(api: ModelAPI, tcfg: TrainConfig, plan: ShardingPlan,
                   mesh: Mesh, batch_specs: Dict[str, Any]) -> Callable:
    """The reference's jitted step with in/out shardings and donation, run
    eagerly: ``step(state, batch)`` takes the state as this rank's shards
    (or whole, and slices it) and the batch whole or as this rank's rows
    under :func:`batch_shardings` of ``batch_specs`` (anything with a
    ``shape``); it updates the state in place (the donation) and returns it
    with the global step's metrics.  Nothing is compiled."""
    return _planned_step(api, tcfg, plan, mesh, batch_specs)
