"""Unified model API: one entry point per architecture family.

``build_model(cfg)`` returns a :class:`ModelAPI` whose members close over the
config: parameter spec (single source of truth for init / abstract shapes /
axes), logits function, training loss, decode step, prefill and cache
constructor, for all six families, each of which trains.  The VLM and the
encoder-decoder also take a stubbed frontend input (image patches, audio
frames): :meth:`ModelAPI.frontend_inputs` makes it, and ``prefill(params,
tokens, cache, **inputs)`` and ``logits_fn`` consume it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from . import layers as L
from . import param as P
from . import encdec, moe, rwkv6, transformer, vlm, zamba2

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
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]],
                      Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    decode_step: Optional[Callable]
    prefill: Optional[Callable]
    init_cache: Optional[Callable]
    cache_axes: Optional[Callable] = None     # () -> logical axes of the cache's leaves

    @property
    def block_inputs(self) -> bool:
        """Whether a step that splits the sequence hands the model its block
        of the tokens (and frames): every family but the VLM, which takes
        its inputs whole and builds its block of [patches; prompt]."""
        return self.cfg.family != "vlm"

    def seq_lengths(self, seq_len: int) -> Tuple[int, ...]:
        """The lengths the ranks along a split sequence must divide for a
        prompt of ``seq_len`` tokens: the prompt's; the VLM's patches and
        prompt as one sequence; the encoder-decoder's prompt and frames."""
        fam = self.cfg.family
        if fam == "vlm":
            return (self.cfg.frontend_len + seq_len,)
        if fam == "audio":
            return (seq_len, self.cfg.frontend_len)
        return (seq_len,)

    # -- params -------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda", shardings=None) -> Params:
        """Random parameters from ``generator`` on ``device``, in the spec's
        parameter dtype; with ``shardings`` (``train_step.state_shardings``'
        ``params``) each rank keeps its slice of the same parameters."""
        return P.materialize(generator, self.spec, require_device(device), shardings)

    def abstract_params(self) -> Params:
        return P.abstract(self.spec)

    def param_axes(self) -> Params:
        return P.axes_of(self.spec)

    def n_params(self) -> int:
        return P.count_params(self.spec)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        cfg = self.cfg
        if not cfg.n_experts:
            return self.n_params()
        total = 0
        for leaf in P.tree_leaves(self.spec):
            size = 1
            for s in leaf.shape:
                size *= s
            if "experts" in leaf.axes:
                frac = (cfg.experts_per_token or cfg.n_experts) / cfg.n_experts
                size = int(size * frac)
            total += size
        return total

    # -- input specs (meta tensors: no allocation) -----------------------------
    def input_specs(self, shape: ShapeConfig,
                    batch_override: Optional[int] = None) -> Dict[str, Any]:
        """The reference's ``input_specs``: a ``meta`` tensor wherever it
        returns a ``jax.ShapeDtypeStruct`` (same shapes and dtypes).  For
        decode, the cache is ``init_cache(cfg, B, S, device="meta")``, its
        ``index`` a Python int."""
        cfg = self.cfg
        B = batch_override or shape.global_batch
        S = shape.seq_len
        meta = lambda s, dt: torch.empty(s, dtype=dt, device="meta")
        if shape.kind in ("train", "prefill"):
            specs: Dict[str, Any] = {"tokens": meta((B, S), torch.int32),
                                     "labels": meta((B, S), torch.int32)}
            name = _FRONTEND.get(cfg.family)
            if name is not None:
                specs[name] = meta((B, cfg.frontend_len, cfg.frontend_dim), torch.bfloat16)
            return specs
        if shape.kind == "decode":
            if self.init_cache is None:
                raise ValueError(f"{cfg.name} has no decode step")
            return {"tokens": meta((B, 1), torch.int32),
                    "cache": self.init_cache(cfg, B, S, device="meta")}
        raise ValueError(shape.kind)

    # -- the stubbed modality frontend ------------------------------------------
    def frontend_inputs(self, batch: int, generator: torch.Generator,
                        device) -> Dict[str, torch.Tensor]:
        """What ``prefill`` takes beside the tokens: ``{}``, or for the VLM
        ``{"patches": ...}`` and for the encoder-decoder ``{"frames": ...}``,
        (batch, frontend_len, frontend_dim) in the compute dtype, drawn from
        ``generator`` as ``SyntheticLM`` draws them (standard normal x 0.02)."""
        cfg = self.cfg
        name = _FRONTEND.get(cfg.family)
        if name is None:
            return {}
        x = torch.randn((batch, cfg.frontend_len, cfg.frontend_dim), generator=generator,
                        device=require_device(device)) * 0.02
        return {name: x.to(L.cdtype(cfg))}

    def head_positions(self, n_tokens: int) -> int:
        """How many of a prompt's positions reach the head on this rank, the
        prompt's ``n_tokens`` tokens as the step hands them to the model:
        all of them; the VLM's text positions in the rank's block of
        [patches; prompt] (``vlm._text_rows``, under the step's context)."""
        if self.cfg.family != "vlm":
            return n_tokens
        t0, t1 = vlm._text_rows(self.cfg.frontend_len, n_tokens)
        return t1 - t0

    def prefix_len(self) -> int:
        """Cache positions the frontend input takes ahead of the prompt: the
        VLM's image patches; 0 elsewhere (the encoder memory has its own
        cross K/V)."""
        return self.cfg.frontend_len if self.cfg.family == "vlm" else 0


def _cast(spec, cfg: ModelConfig):
    return P.cast_spec_dtype(spec, L.pdtype(cfg))


_FRONTEND = {"vlm": "patches", "audio": "frames"}


def attention_calls(cfg: ModelConfig) -> int:
    """Prompt-length attention calls of one forward pass: one a layer for
    the dense, MoE and VLM families; one a group of ``attn_every`` Mamba2
    layers for the hybrid (its shared block's sites); one an encoder layer
    and two a decoder layer (self, then cross over the encoder's memory)
    for the encoder-decoder; none for RWKV6."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "audio":
        return (cfg.n_encoder_layers or cfg.n_layers) + 2 * cfg.n_layers
    return cfg.n_layers


def build_model(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam == "dense":
        return ModelAPI(
            cfg=cfg, spec=_cast(transformer.transformer_spec(cfg), cfg),
            logits_fn=lambda p, b: transformer.forward(p, b["tokens"], cfg),
            loss_fn=lambda p, b: transformer.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c: transformer.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c: transformer.prefill(p, t, c, cfg),
            init_cache=transformer.init_cache, cache_axes=transformer.cache_logical_axes)
    if fam == "moe":
        return ModelAPI(
            cfg=cfg, spec=_cast(moe.moe_spec(cfg), cfg),
            logits_fn=lambda p, b: moe.forward(p, b["tokens"], cfg)[0],
            loss_fn=lambda p, b: moe.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c: moe.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c: moe.prefill(p, t, c, cfg),
            init_cache=transformer.init_cache, cache_axes=transformer.cache_logical_axes)
    if fam == "ssm":
        return ModelAPI(
            cfg=cfg, spec=_cast(rwkv6.rwkv6_spec(cfg), cfg),
            logits_fn=lambda p, b: rwkv6.forward(p, b["tokens"], cfg),
            loss_fn=lambda p, b: rwkv6.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c: rwkv6.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c: rwkv6.prefill(p, t, c, cfg),
            init_cache=rwkv6.init_cache, cache_axes=rwkv6.cache_logical_axes)
    if fam == "hybrid":
        return ModelAPI(
            cfg=cfg, spec=_cast(zamba2.zamba2_spec(cfg), cfg),
            logits_fn=lambda p, b: zamba2.forward(p, b["tokens"], cfg),
            loss_fn=lambda p, b: zamba2.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c: zamba2.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c: zamba2.prefill(p, t, c, cfg),
            init_cache=zamba2.init_cache, cache_axes=zamba2.cache_logical_axes)
    if fam == "vlm":
        return ModelAPI(
            cfg=cfg, spec=_cast(vlm.vlm_spec(cfg), cfg),
            logits_fn=lambda p, b: vlm.forward(p, b["tokens"], b["patches"], cfg),
            loss_fn=lambda p, b: vlm.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c: vlm.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c, *, patches=None: vlm.prefill(p, t, c, cfg, patches=patches),
            init_cache=vlm.init_cache, cache_axes=transformer.cache_logical_axes)
    if fam == "audio":
        return ModelAPI(
            cfg=cfg, spec=_cast(encdec.encdec_spec(cfg), cfg),
            logits_fn=lambda p, b: encdec.forward(p, b["frames"], b["tokens"], cfg),
            loss_fn=lambda p, b: encdec.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c: encdec.decode_step(p, t, c, cfg),
            prefill=lambda p, t, c, *, frames=None: encdec.prefill(p, t, c, cfg, frames=frames),
            init_cache=encdec.init_cache, cache_axes=encdec.cache_logical_axes)
    raise ValueError(f"unknown family {fam!r}")
