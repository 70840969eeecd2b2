"""Optimizers: AdamW and Adafactor, with the warmup + cosine schedule,
global-norm clipping and a configurable state dtype.

Counterpart of ``repro/train/optimizer.py``, with its arithmetic in the same
order.  The reference's functions are pure; these update the parameters,
the optimizer state and the gradients (clipping) **in place** and return the
same tensors, which keeps one copy of each on the card: qwen2.5-3b's
float32 parameters, gradients and two AdamW moments already take 49 GB.
AdamW is torch's fused update: one pass over its operands, no
temporaries.  Adafactor takes row/column means and a whole-leaf RMS and
runs per leaf; on a leaf split over a mesh those are the whole leaf's,
all-reduced over the axes that split it.

State trees mirror the parameter tree, as in the reference; ``step`` is a
0-d int32 tensor on the parameters' device, so no step reads a device value
back to the host.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.param import tree_leaves, tree_map

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Params
    nu: Params


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Params          # row second-moment factors
    vc: Params          # column second-moment factors
    v: Params           # full second moment for parameters of fewer than 2 dims


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _map(fn: Callable, tree, *rest):
    return tree_map(fn, tree, *rest, is_leaf=_is_tensor)


def _leaves(tree) -> list:
    return tree_leaves(tree, is_leaf=_is_tensor)


def lr_schedule(tcfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup, then cosine decay to 10 % of ``learning_rate``, in
    float32 from the int32 step."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp((step + 1) / max(1, tcfg.warmup_steps), max=1.0)
        prog = torch.clamp((step - tcfg.warmup_steps)
                           / max(1, tcfg.total_steps - tcfg.warmup_steps), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)
    return lr


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in _leaves(grads)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: Params, max_norm: float,
                        norm_fn: Optional[Callable] = None) -> Tuple[Params, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / (norm + 1e-9)), in place;
    returns the same tree and the norm before clipping.  ``norm_fn(grads)``
    computes the norm instead of :func:`global_norm` (a sharded step's
    norm over every rank's shards)."""
    gnorm = (norm_fn or global_norm)(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in _leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_((g.float() * scale).to(g.dtype))
    return grads, gnorm


# ------------------------------------------------------------------ AdamW
def adamw_init(params: Params, tcfg: TrainConfig) -> AdamWState:
    dt = _DTYPES[tcfg.opt_state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = _leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=_map(zeros, params), nu=_map(zeros, params))


def _fused_adamw(p, g, m, v, step: torch.Tensor, lr: torch.Tensor, tcfg: TrainConfig) -> None:
    """torch's fused AdamW over lists of float32 leaves, in place: decoupled
    decay, ``eps`` added after sqrt(v_hat), ``lr`` a tensor."""
    torch._fused_adamw_(p, g, m, v, [], [step.float()] * len(p), lr=lr, beta1=tcfg.b1,
                        beta2=tcfg.b2, weight_decay=tcfg.weight_decay, eps=tcfg.eps,
                        amsgrad=False, maximize=False)


def adamw_update(grads: Params, state: AdamWState, params: Params,
                 tcfg: TrainConfig, norm_fn: Optional[Callable] = None
                 ) -> Tuple[Params, AdamWState, Dict]:
    """One AdamW step, in place on ``params``, ``state`` and ``grads``: one
    fused pass over every leaf whose parameter, gradient and moments are
    float32.  A leaf stored in another dtype (bf16 parameters or state) is
    updated on float32 copies and rounded back once, as the reference
    computes in float32 and casts."""
    lr = lr_schedule(tcfg)(state.step)
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, norm_fn)
    step = state.step + 1
    f32, other = [], []
    for leaf in zip(_leaves(params), _leaves(grads), _leaves(state.mu), _leaves(state.nu)):
        (f32 if all(t.dtype == torch.float32 for t in leaf) else other).append(leaf)
    if f32:
        _fused_adamw(*(list(ts) for ts in zip(*f32)), step, lr, tcfg)
    for p, g, m, v in other:
        p32, m32, v32 = p.float(), m.float(), v.float()
        _fused_adamw([p32], [g.float()], [m32], [v32], step, lr, tcfg)
        for t, t32 in ((p, p32), (m, m32), (v, v32)):
            t.copy_(t32)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------- Adafactor
def adafactor_init(params: Params, tcfg: TrainConfig) -> AdafactorState:
    dt = _DTYPES[tcfg.opt_state_dtype]

    def zeros(shape, p):
        return torch.zeros(shape, dtype=dt, device=p.device)

    device = _leaves(params)[0].device
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        vr=_map(lambda p: zeros(p.shape[:-1] if p.dim() >= 2 else (), p), params),
        vc=_map(lambda p: zeros(p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else (), p),
                params),
        v=_map(lambda p: zeros(p.shape if p.dim() < 2 else (), p), params))


class _WholeLeaf:
    """A leaf held whole: its means are local means."""

    @staticmethod
    def mean(x: torch.Tensor, dim: int, leaf_dim: int) -> torch.Tensor:
        return torch.mean(x, dim)

    @staticmethod
    def mean_all(x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x)

    @staticmethod
    def to_state(x: torch.Tensor, which: str) -> torch.Tensor:
        return x

    from_state = to_state


class _SplitLeaf:
    """A leaf this rank holds a block of (``placement``: its
    ``spmd.Placement``): every mean is the whole leaf's, a local sum
    all-reduced over the mesh axes that split the reduced dims and divided
    by the global size; the factored moments move between the gradient's
    layout and their own state placement where the two differ."""

    def __init__(self, placement, state_specs):
        self.pl, self.state_specs = placement, state_specs
        self.mesh = placement.sharding.mesh
        spec = tuple(placement.sharding.spec)
        self.spec = spec + (None,) * (len(placement.shape) - len(spec))

    def _axes(self, dims) -> tuple:
        from repro_torch.parallel.sharding import part_axes
        return tuple(a for d in dims for a in part_axes(self.spec[d]))

    def mean(self, x: torch.Tensor, dim: int, leaf_dim: int) -> torch.Tensor:
        from repro_torch.parallel import spmd
        n = len(self.spec)
        total = spmd.reduce_over(torch.sum(x, dim), self.mesh, self._axes([leaf_dim % n]))
        return total / self.pl.shape[leaf_dim % n]

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.parallel import spmd
        total = spmd.reduce_over(torch.sum(x), self.mesh, self.pl.sharding.mesh_axes())
        return total / math.prod(self.pl.shape)

    def _layout(self, which: str):
        from repro_torch.parallel.sharding import P
        s, shape = self.spec, self.pl.shape
        if which == "vr":
            return P(*s[:-1]), shape[:-1]
        return P(*(s[:-2] + s[-1:])), shape[:-2] + shape[-1:]

    def _move(self, x: torch.Tensor, src, dst, shape) -> torch.Tensor:
        from repro_torch.parallel import spmd
        from repro_torch.parallel.sharding import Sharding
        norm = lambda sp: tuple(sp) + (None,) * (len(shape) - len(sp))
        if norm(src) == norm(dst):
            return x
        full = spmd.gather_blocks(x, self.mesh, src, shape, Sharding(self.mesh, src).mesh_axes())
        return Sharding(self.mesh, dst).local(full)

    def to_state(self, x: torch.Tensor, which: str) -> torch.Tensor:
        src, shape = self._layout(which)
        return self._move(x, src, self.state_specs[which], shape)

    def from_state(self, x: torch.Tensor, which: str) -> torch.Tensor:
        dst, shape = self._layout(which)
        return self._move(x, self.state_specs[which], dst, shape)


def adafactor_update(grads: Params, state: AdafactorState, params: Params,
                     tcfg: TrainConfig, norm_fn: Optional[Callable] = None,
                     placements: Optional[list] = None, state_specs: Optional[list] = None
                     ) -> Tuple[Params, AdafactorState, Dict]:
    """One Adafactor step, in place on ``params``, ``state`` and ``grads``.

    In a plan-sharded step ``placements`` lists each leaf's
    ``spmd.Placement`` (in the parameters' leaf order) and ``state_specs``
    each leaf's ``{"vr": spec, "vc": spec}`` under the state's placement:
    the row and column means, the mean of ``vr`` and the update's RMS are
    then the whole leaf's (a sum all-reduced over the axes that split the
    reduced dims, over the global size), so every rank computes its block
    of the unsharded step's update."""
    lr = lr_schedule(tcfg)(state.step)
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, norm_fn)
    step = state.step + 1
    b2 = 1.0 - (step.float() + 1.0) ** -0.8

    def upd(g, vr, vc, v, p, red):
        g32 = torch.square(g.float()) + 1e-30
        if p.dim() >= 2:
            vr32 = red.from_state(vr.float(), "vr") * b2 + red.mean(g32, -1, -1) * (1 - b2)
            vc32 = red.from_state(vc.float(), "vc") * b2 + red.mean(g32, -2, -2) * (1 - b2)
            denom = (vr32[..., None] * vc32[..., None, :]
                     / (red.mean(vr32, -1, -2)[..., None, None] + 1e-30))
            update = g.float() * torch.rsqrt(denom + 1e-30)
            vr.copy_(red.to_state(vr32, "vr").to(vr.dtype))
            vc.copy_(red.to_state(vc32, "vc").to(vc.dtype))
        else:
            v32 = v.float() * b2 + g32 * (1 - b2)
            update = g.float() * torch.rsqrt(v32 + 1e-30)
            v.copy_(v32.to(v.dtype))
        update = update / torch.clamp(torch.sqrt(red.mean_all(torch.square(update))), min=1.0)
        p32 = p.float()
        p.copy_((p32 - lr * update - lr * tcfg.weight_decay * p32).to(p.dtype))

    leaves = list(zip(_leaves(grads), _leaves(state.vr), _leaves(state.vc), _leaves(state.v),
                      _leaves(params)))
    reds = [_WholeLeaf] * len(leaves) if placements is None else \
        [_SplitLeaf(pl, sp) for pl, sp in zip(placements, state_specs)]
    for (g, vr, vc, v, p), red in zip(leaves, reds):
        upd(g, vr, vc, v, p, red)
    return params, AdafactorState(step, state.vr, state.vc, state.v), \
        {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------------------------ facade
def opt_init(params: Params, tcfg: TrainConfig):
    return (adafactor_init if tcfg.optimizer == "adafactor" else adamw_init)(params, tcfg)


def opt_update(grads: Params, state, params: Params, tcfg: TrainConfig,
               norm_fn: Optional[Callable] = None, placements: Optional[list] = None,
               state_specs: Optional[list] = None):
    """One step of ``tcfg.optimizer``.  ``placements`` / ``state_specs``:
    a plan-sharded step's (:func:`adafactor_update`; AdamW is elementwise
    and needs only ``norm_fn``)."""
    if tcfg.optimizer == "adafactor":
        return adafactor_update(grads, state, params, tcfg, norm_fn, placements, state_specs)
    return adamw_update(grads, state, params, tcfg, norm_fn)


def opt_state_axes(param_axes: Params, tcfg: TrainConfig):
    """Logical axes for the optimizer state (mirrors the parameters' axes)."""
    is_axes = lambda x: isinstance(x, tuple)
    if tcfg.optimizer == "adafactor":
        return AdafactorState(
            step=(),
            vr=tree_map(lambda a: a[:-1] if len(a) >= 2 else (), param_axes, is_leaf=is_axes),
            vc=tree_map(lambda a: a[:-2] + a[-1:] if len(a) >= 2 else (), param_axes,
                        is_leaf=is_axes),
            v=tree_map(lambda a: a if len(a) < 2 else (), param_axes, is_leaf=is_axes))
    return AdamWState(step=(), mu=param_axes, nu=param_axes)
