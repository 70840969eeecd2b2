"""Deterministic token pipeline (numpy only).

Counterpart of ``repro/data/pipeline.py``: prompts are produced
deterministically from (seed, step, host), so the port's serve loop reads
exactly the prompts and training batches the reference's reads.  Each host
produces only its shard of the global batch (:func:`host_batch_slice`),
deterministically from (seed, step), so any host can restart at any step.
Sources:

* ``SyntheticLM`` -- Zipf-ish token stream with a fixed PRNG tree;
* ``FileTokens``  -- memory-mapped token file (``.bin`` of uint16), a window
  per (step, host, slot).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


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


class FileTokens:
    """Memory-mapped contiguous token file; window per (step, host, slot)."""

    def __init__(self, dcfg: DataConfig, cfg: ModelConfig):
        if not dcfg.path:
            raise ValueError("FileTokens needs DataConfig.path")
        self.tokens = np.memmap(dcfg.path, dtype=np.uint16, mode="r")
        self.cfg = cfg
        self.dcfg = dcfg

    def batch_at(self, step: int, batch: int, seq_len: int,
                 host: int = 0) -> Dict[str, np.ndarray]:
        n = len(self.tokens) - (seq_len + 1)
        rng = _rng_for(self.dcfg.seed, step, host)
        starts = rng.integers(0, max(1, n), size=batch)
        win = np.stack([self.tokens[s:s + seq_len + 1] for s in starts])
        win = win.astype(np.int32) % self.cfg.vocab_size
        return {"tokens": win[:, :-1], "labels": win[:, 1:]}


def make_source(dcfg: DataConfig, cfg: ModelConfig):
    if dcfg.source == "file":
        return FileTokens(dcfg, cfg)
    return SyntheticLM(dcfg, cfg)


def host_batch_slice(global_batch: int, n_hosts: int, host: int) -> Tuple[int, int]:
    """[start, size) of this host's slice of the global batch."""
    per = global_batch // n_hosts
    rem = global_batch % n_hosts
    start = host * per + min(host, rem)
    size = per + (1 if host < rem else 0)
    return start, size


def batches(source, shape: ShapeConfig, *, start_step: int = 0,
            host: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield source.batch_at(step, shape.global_batch, shape.seq_len, host)
        step += 1
