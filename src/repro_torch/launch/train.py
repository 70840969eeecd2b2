"""Training driver on one GPU.

``python -m repro_torch.launch.train --arch qwen2.5-3b --steps 3 --batch 4
--seq 512`` trains the full config from random float32 weights made from
``TrainConfig.seed``, computing in the config's dtype (bf16), with AdamW
(float32 state), remat as the config says, and batches from
``SyntheticLM``; every model family trains (``--arch rwkv6-3b`` too).
Every prompt-length attention goes through the FlashAttention kernel and
its backward (K2, K2-bwd), an MoE's expert products through the grouped
GEMM forward and backward (K4), RWKV6's WKV scan through the chunked-WKV
kernel and its backward (K5, K5-bwd); the rest is PyTorch.  It prints the
reference's per-step line: loss, gradient norm, learning rate and tokens a
second.
``--device cpu --reduced`` runs the same code on the kernels' plain versions
(the tests do); without a GPU and without ``--device cpu`` it raises.

Not ported yet (ROADMAP.md, Queue 1, items 8-9): the mesh-plan ranking, the
checkpoint manager with auto-resume and the resilient driver (heartbeats,
stragglers, step retry, injected faults).  ``--ckpt-dir`` and
``--save-every`` are therefore not accepted rather than ignored.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataConfig, make_source
from repro_torch.launch.common import launch_config
from repro_torch.models import build_model
from repro_torch.models.api import ModelAPI, require_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import train_step as TS


@dataclass
class TrainResult:
    state: TS.TrainState
    history: List[Dict[str, float]]       # per step: loss, grad_norm, lr (+ aux_loss)
    step_s: List[float]                   # wall seconds per step, synchronised
    launches: Dict[str, int] = field(default_factory=dict)
    peak_bytes: int = 0


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors: ids as int64, stub frontend inputs as
    float32 (the model casts them to its compute dtype)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device=device, dtype=torch.long if v.dtype.kind in "iu" else torch.float32)
        for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(api: ModelAPI, tcfg: TrainConfig, steps: int, batch: int, seq: int, device, *,
        state: TS.TrainState = None, log_every: int = 10, log=print) -> TrainResult:
    """``steps`` optimizer steps on ``SyntheticLM`` batches 0, 1, ...; prints
    the reference's per-step line every ``log_every`` steps and at the end.
    The kernels' launch counters are read around the steps."""
    device = torch.device(device)
    if state is None:
        state = TS.init_state(api, tcfg, device=device)
    source = make_source(DataConfig(vocab_size=api.cfg.vocab_size), api.cfg)
    step_fn = TS.make_train_step(api, tcfg)
    history, step_s = [], []
    before = kernels.launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for step in range(1, steps + 1):
        data = to_device(source.batch_at(step - 1, batch, seq), device)
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data)
        _sync(device)
        dt = time.perf_counter() - t0
        step_s.append(dt)
        history.append({k: float(v) for k, v in metrics.items()})
        if (step - 1) % log_every == 0 or step == steps:
            m = history[-1]
            log(f"[train] step {step - 1:5d} loss={m['loss']:.4f} "
                f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                f"{batch * seq / max(dt, 1e-9):,.0f} tok/s")
    after = kernels.launch_counts()
    return TrainResult(state=state, history=history, step_s=step_s,
                       launches={k: after[k] - before[k] for k in after},
                       peak_bytes=(torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0))


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none", choices=("none", "int8"))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (CPU-friendly)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = launch_config(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20),
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression)
    api = build_model(cfg)
    print(f"[train] {cfg.name}: {api.n_params():,} params on {device} "
          f"(kernels={cfg.kernels}, compute {cfg.compute_dtype}, remat={cfg.remat})")
    print("[train] fresh start")
    t0 = time.perf_counter()
    res = run(api, tcfg, args.steps, args.batch, args.seq, device,
              log_every=args.log_every)
    total = time.perf_counter() - t0
    print(f"[train] done: {args.steps} steps in {total:.1f}s")
    print("[train] kernel launches: " + " ".join(
        f"{k}={v}" for k, v in sorted(res.launches.items())))
    if res.peak_bytes:
        print(f"[train] peak device memory {res.peak_bytes / 2**30:.2f} GiB")
    counts = obs_metrics.counter_totals(obs_metrics.snapshot())
    if counts:
        print("[train] metrics: " + " ".join(f"{k}={v:g}" for k, v in sorted(counts.items())))
    dumped = obs_metrics.dump()          # honors REPRO_METRICS=<path>
    if dumped:
        print(f"[train] metrics snapshot written to {dumped}")
    return res


if __name__ == "__main__":
    main()
