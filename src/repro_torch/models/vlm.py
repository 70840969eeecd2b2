"""InternVL2-1b backbone: an InternLM2-style decoder consuming stubbed ViT
patches.

Counterpart of ``repro/models/vlm.py``.  The modality frontend is a stub: the
caller hands over precomputed patch embeddings (B, n_patches, frontend_dim);
a linear connector projects them into the LM's embedding space and they are
prepended to the token embeddings (the InternVL "LLM-as-decoder" wiring).
Logits are over the text positions only.  Serving runs the image prefix and
the prompt through one cached causal pass (:func:`prefill`); a decode step
is the dense transformer's, its positions counting the prefix.  The loss
is over the text positions.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import layers as L
from . import transformer as TF
from .param import LeafSpec

Params = Dict[str, Any]


def vlm_spec(cfg: ModelConfig) -> Params:
    spec = TF.transformer_spec(cfg)
    spec["connector"] = {
        "w": LeafSpec((cfg.frontend_dim, cfg.d_model), ("patches", "embed")),
        "b": LeafSpec((cfg.d_model,), ("embed",), init="zeros"),
    }
    return spec


def _prefix(params: Params, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """[connector(patches); embed(tokens)]: (B, P + S_text, d)."""
    dt = L.cdtype(cfg)
    vis = patches.to(dt) @ params["connector"]["w"].to(dt) + params["connector"]["b"].to(dt)
    return torch.cat([vis, L.embed(params["embed"], tokens, cfg)], dim=1)


def forward(params: Params, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens: (B, S_text); patches: (B, P, frontend_dim) -> logits over the
    text positions (B, S_text, V)."""
    x = TF.layers(params, _prefix(params, tokens, patches, cfg), cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    x = x[:, patches.shape[1]:]                  # text positions only
    return L.lm_head(params.get("lm_head", {}), x, cfg, embed_params=params["embed"])


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    logits = forward(params, batch["tokens"], batch["patches"], cfg)
    loss = L.softmax_xent(logits, batch["labels"])
    return loss, {"loss": loss}


# ----------------------------------------------------------------- serving
init_cache = TF.init_cache


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Text-token decode (the image prefix was consumed during prefill)."""
    return TF.decode_step(params, tokens, cache, cfg)


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig, *, patches: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Fill an empty cache with the image prefix and the prompt in one causal
    pass and return the last text token's logits (B, 1, V).  The cache must
    hold ``P + S_text`` keys and more for the tokens to come."""
    if int(cache["index"]) != 0:
        raise ValueError(f"prefill fills an empty cache; this one holds "
                         f"{int(cache['index'])} tokens")
    return TF.cached_layers(params, _prefix(params, tokens, patches, cfg), cache, cfg,
                            last_only=True)
