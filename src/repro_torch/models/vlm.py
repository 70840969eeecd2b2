"""InternVL2-1b backbone: an InternLM2-style decoder consuming stubbed ViT
patches.

Counterpart of ``repro/models/vlm.py``.  The modality frontend is a stub: the
caller hands over precomputed patch embeddings (B, n_patches, frontend_dim);
a linear connector projects them into the LM's embedding space and they are
prepended to the token embeddings (the InternVL "LLM-as-decoder" wiring).
Logits are over the text positions only.  Serving runs the image prefix and
the prompt through one cached causal pass (:func:`prefill`; a prompt in
chunks: the patches with the first, the later ones text); a decode step
is the dense transformer's, its positions counting the prefix.  The loss
is over the text positions.  Under a plan-sharded step that splits the
sequence, the patches and the prompt are one sequence of ``P + S_text``
positions split evenly over the ranks: each rank takes both whole, builds
its block of them (:func:`_prefix`), and reaches the head and the loss with
the text positions of its block only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import spmd
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
    """[connector(patches); embed(tokens)]: (B, P + S_text, d); under a step
    that splits the sequence, only this rank's block of that one sequence
    (``spmd.seq_block``): the connector rows of the patches it covers and
    the embeddings of the tokens it covers.  Both run on every rank, on no
    rows where the block holds none, so that every rank's backward reaches
    the same parameters."""
    dt = L.cdtype(cfg)
    n_p = patches.shape[1]
    o, n = spmd.seq_block(n_p + tokens.shape[1])
    vis = patches[:, min(o, n_p):min(o + n, n_p)].to(dt)
    vis = vis @ params["connector"]["w"].to(dt) + params["connector"]["b"].to(dt)
    txt = tokens[:, max(o - n_p, 0):max(o + n - n_p, 0)]
    return torch.cat([vis, L.embed(params["embed"], txt, cfg)], dim=1)


def _text_rows(n_p: int, n_text: int) -> Tuple[int, int]:
    """(first, end) of the text positions, counted from the first token,
    that this rank's block of the sequence [patches; prompt] holds."""
    o, n = spmd.seq_block(n_p + n_text)
    return max(o - n_p, 0), max(o + n - n_p, 0)


def forward(params: Params, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens: (B, S_text); patches: (B, P, frontend_dim) -> logits over the
    text positions (B, S_text, V); under a step that splits the sequence,
    both given whole, over the text positions of this rank's block of
    [patches; prompt] (:func:`_text_rows`)."""
    x = TF.layers(params, _prefix(params, tokens, patches, cfg), cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    t0, t1 = _text_rows(patches.shape[1], tokens.shape[1])
    x = x[:, x.shape[1] - (t1 - t0):]            # text positions only
    return L.lm_head(params.get("lm_head", {}), x, cfg, embed_params=params["embed"])


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The mean cross-entropy over the text positions; under a step that
    splits the sequence, whose ranks hold different numbers of them, this
    rank's share of it (``spmd.seq_share``)."""
    logits = forward(params, batch["tokens"], batch["patches"], cfg)
    labels = batch["labels"]
    if spmd.seq_axis() is None:
        loss = L.softmax_xent(logits, labels)
    else:
        t0, t1 = _text_rows(batch["patches"].shape[1], labels.shape[1])
        loss = L.softmax_xent(logits, labels[:, t0:t1], total=labels.numel())
    return loss, {"loss": loss}


# ----------------------------------------------------------------- serving
init_cache = TF.init_cache


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Text-token decode (the image prefix was consumed during prefill)."""
    return TF.decode_step(params, tokens, cache, cfg)


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig, *, patches: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Write the image prefix and the prompt (or its first chunk) into an
    empty cache in one causal pass, or a later chunk of text at the cache's
    index, and return the last text token's logits (B, 1, V).  The patches
    go in with the first pass only.  The cache must hold ``P + S_text``
    keys and more for the tokens to come.  Under a serving step that splits
    the sequence, ``tokens`` and ``patches`` come whole and the rank
    computes its block of [patches; prompt], writing the block of the cache
    that its plan gives it."""
    if int(cache["index"]) == 0:
        if patches is None:
            raise ValueError("the first pass into an empty cache carries the patches")
        x = _prefix(params, tokens, patches, cfg)
    else:
        if patches is not None:
            raise ValueError(f"the patches go into an empty cache only, with the first pass; "
                             f"this one holds {int(cache['index'])} positions (a later chunk "
                             f"is text alone)")
        x = L.embed(params["embed"], tokens, cfg)
    return TF.cached_layers(params, x, cache, cfg, last_only=True)
