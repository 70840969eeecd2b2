"""Deterministic token pipeline (numpy only).

Counterpart of ``repro/data/pipeline.py``: prompts are produced
deterministically from (seed, step, host), so the port's serve loop reads
exactly the prompts the reference's reads.  ``SyntheticLM`` is a Zipf-ish
token stream with a fixed PRNG tree; ``FileTokens`` and the batch iterators
arrive with training.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig

@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    source: str = "synthetic"        # synthetic | file
    path: Optional[str] = None
    zipf_a: float = 1.2


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    key = hashlib.blake2b(f"{seed}:{step}:{host}".encode(),
                          digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(key, "little"))


class SyntheticLM:
    """Zipf-distributed tokens; deterministic per (seed, step, host)."""

    def __init__(self, dcfg: DataConfig, cfg: ModelConfig):
        self.dcfg = dcfg
        self.vocab = min(cfg.vocab_size, dcfg.vocab_size)
        self.cfg = cfg

    def batch_at(self, step: int, batch: int, seq_len: int,
                 host: int = 0) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.dcfg.seed, step, host)
        z = rng.zipf(self.dcfg.zipf_a, size=(batch, seq_len + 1))
        toks = (z % (self.vocab - 2)) + 1          # avoid 0 (pad)
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (batch, self.cfg.frontend_len, self.cfg.frontend_dim)
            ).astype(np.float32) * 0.02
        if self.cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (batch, self.cfg.frontend_len, self.cfg.frontend_dim)
            ).astype(np.float32) * 0.02
        return out


def make_source(dcfg: DataConfig, cfg: ModelConfig):
    if dcfg.source == "file":
        raise NotImplementedError("the memory-mapped token file source is not ported "
                                  "yet (ROADMAP.md, Queue 1, training)")
    return SyntheticLM(dcfg, cfg)
