"""Unified model API: one entry point per architecture family.

``build_model(cfg)`` returns a :class:`ModelAPI` whose members close over the
config: parameter spec (single source of truth for init / abstract shapes /
axes), logits function, decode step, prefill and cache constructor.  The
dense decoder, MoE and RWKV6 (``ssm``) families are ported so far; the
others raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from . import layers as L
from . import param as P
from . import moe, rwkv6, transformer

Params = Dict[str, Any]


def require_device(device) -> torch.device:
    """The device an entry point runs on.  Asking for a CUDA device on a
    machine without one raises: nothing carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions")
    return dev


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    spec: Params
    logits_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    decode_step: Optional[Callable]
    prefill: Optional[Callable]
    init_cache: Optional[Callable]

    # -- params -------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """Random parameters from ``generator`` on ``device``, in the spec's
        parameter dtype."""
        return P.materialize(generator, self.spec, require_device(device))

    def abstract_params(self) -> Params:
        return P.abstract(self.spec)

    def param_axes(self) -> Params:
        return P.axes_of(self.spec)

    def n_params(self) -> int:
        return P.count_params(self.spec)


def _cast(spec, cfg: ModelConfig):
    return P.cast_spec_dtype(spec, L.pdtype(cfg))


_QUEUE = {"hybrid": "mamba2 / zamba2", "vlm": "encdec / vlm", "audio": "encdec / vlm"}


def build_model(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam == "dense":
        return ModelAPI(
            cfg=cfg, spec=_cast(transformer.transformer_spec(cfg), cfg),
            logits_fn=lambda p, b: transformer.forward(p, b["tokens"], cfg),
            decode_step=lambda p, t, c: transformer.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c: transformer.prefill(p, t, c, cfg),
            init_cache=transformer.init_cache)
    if fam == "moe":
        return ModelAPI(
            cfg=cfg, spec=_cast(moe.moe_spec(cfg), cfg),
            logits_fn=lambda p, b: moe.forward(p, b["tokens"], cfg)[0],
            decode_step=lambda p, t, c: moe.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c: moe.prefill(p, t, c, cfg),
            init_cache=transformer.init_cache)
    if fam == "ssm":
        return ModelAPI(
            cfg=cfg, spec=_cast(rwkv6.rwkv6_spec(cfg), cfg),
            logits_fn=lambda p, b: rwkv6.forward(p, b["tokens"], cfg),
            decode_step=lambda p, t, c: rwkv6.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c: rwkv6.prefill(p, t, c, cfg),
            init_cache=rwkv6.init_cache)
    if fam in _QUEUE:
        raise NotImplementedError(
            f"family {fam!r} ({cfg.name}) is not ported yet: see ROADMAP.md, "
            f"Queue 1, '{_QUEUE[fam]}'")
    raise ValueError(f"unknown family {fam!r}")
