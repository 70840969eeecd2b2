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

The shardings of the reference (``state_shardings``, ``batch_shardings``,
``jit_train_step``) wait for ``parallel/sharding`` (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.api import ModelAPI
from repro_torch.models.convert import from_reference
from repro_torch.models.param import tree_map
from . import grad_compress, optimizer as opt

Params = Any


@dataclass
class TrainState:
    params: Params
    opt_state: Any
    residual: Optional[Params] = None


def init_state(api: ModelAPI, tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> TrainState:
    """Parameters drawn from ``generator`` (seeded with ``tcfg.seed`` when
    not given) in the spec's dtype, a zero optimizer state and, with int8
    gradient compression, a zero residual."""
    if generator is None:
        generator = torch.Generator(device=torch.device(device)).manual_seed(tcfg.seed)
    params = api.init(generator, device)
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


def _tmap(fn: Callable, tree, *rest):
    return tree_map(fn, tree, *rest, is_leaf=lambda x: isinstance(x, torch.Tensor))


def zero_grads(params: Params, dtype: Optional[torch.dtype] = None) -> Params:
    return _tmap(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device),
                 params)


def accumulate_grad(api: ModelAPI, params: Params, batch: Dict[str, torch.Tensor],
                    grads: Params) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run ``api.loss_fn(params, batch)`` and its backward, adding the
    gradient of every parameter into ``grads`` (a tree of buffers shaped
    like ``params``) in place.  Returns the loss and metrics, detached."""
    unbound = []            # (leaf, buffer) whose dtypes differ

    def bind(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        leaf = p.detach().requires_grad_()
        if g.dtype == p.dtype:
            leaf.grad = g
        else:
            unbound.append((leaf, g))
        return leaf

    def leaf_of(p: torch.Tensor, g: torch.Tensor, axes) -> Any:
        lead = 0
        while lead < len(axes) and axes[lead] == "layers":
            lead += 1
        return LayerLeaves(p, g, lead, bind) if lead else bind(p, g)

    model_params = tree_map(leaf_of, params, grads, api.param_axes(),
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    with torch.enable_grad():
        loss, metrics = api.loss_fn(model_params, batch)
        loss.backward()
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


def make_train_step(api: ModelAPI, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss and
    gradients (averaged in float32 over ``tcfg.microbatches``), the int8
    error-feedback round trip when asked for, then the optimizer.  The state
    is updated in place and returned."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if tcfg.microbatches <= 1:
            grads = zero_grads(state.params)
            loss, metrics = accumulate_grad(api, state.params, batch, grads)
        else:
            grads = zero_grads(state.params, torch.float32)
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for mb in _split_microbatches(batch, tcfg.microbatches):
                mb_loss, _ = accumulate_grad(api, state.params, mb, grads)
                loss = loss + mb_loss
            n = float(tcfg.microbatches)
            for g in opt._leaves(grads):
                g.div_(n)
            loss = loss / n
            metrics = {"loss": loss}
        residual = state.residual
        if tcfg.grad_compression == "int8" and residual is not None:
            grads, residual = grad_compress.roundtrip(grads, residual)
        params, opt_state, opt_metrics = opt.opt_update(grads, state.opt_state,
                                                        state.params, tcfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params, opt_state, residual), metrics

    return train_step
