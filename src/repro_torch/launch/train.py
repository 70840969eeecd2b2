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

The reference's resilient loop (``repro/launch/train.py``): a checkpoint
manager under ``--ckpt-dir/<config name>`` saves every ``--save-every``
steps (the host copy taken before the step after it, the files written
beside it) and the driver resumes from the newest checkpoint by itself;
:class:`~repro_torch.runtime.ResilientDriver` reports heartbeats into a
one-host registry with a straggler tracker, and retries a failed step by
restoring the newest checkpoint **into the live state** and replaying (the
train step updates the state in place, so a failed step may have changed
it).  ``REPRO_FAULTS`` straggler factors scale the step times reported to
the registry.

Before the first step it prints the reference's ranking line: the TileLoom
mesh planner's candidate plans for this model and batch on the planner's
H100 cluster (``parallel/planner_bridge.plan_mesh``), with ``(cache)`` or
``(search)`` for where the ranking came from.  Plan-sharded training over
a mesh is ``train_step.jit_train_step`` (``chip_smoke.py``'s ``mesh_train``
phase drives it).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels, plancache
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import leaves
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data import DataConfig, make_source
from repro_torch.launch.common import launch_config
from repro_torch.models import build_model
from repro_torch.models.api import ModelAPI, require_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.parallel.planner_bridge import plan_mesh
from repro_torch.runtime import HeartbeatRegistry, ResilientDriver, StragglerTracker
from repro_torch.runtime.fault_tolerance import RecoveryEvent
from repro_torch.runtime.faults import env_schedule
from repro_torch.train import train_step as TS


@dataclass
class TrainResult:
    state: TS.TrainState
    history: List[Dict[str, float]]       # per step: loss, grad_norm, lr (+ aux_loss)
    step_s: List[float]                   # wall seconds per step, synchronised
    launches: Dict[str, int] = field(default_factory=dict)
    peak_bytes: int = 0
    events: List[RecoveryEvent] = field(default_factory=list)


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
        state: TS.TrainState = None, log_every: int = 10, log=print, start: int = 0,
        manager: Optional[CheckpointManager] = None,
        restore: Optional[Callable[[TS.TrainState], tuple]] = None,
        registry: Optional[HeartbeatRegistry] = None,
        tracker: Optional[StragglerTracker] = None,
        step_time_scale: Optional[Callable[[int], float]] = None,
        on_step: Optional[Callable] = None) -> TrainResult:
    """Optimizer steps ``start`` .. ``steps - 1`` on ``SyntheticLM`` batches
    of those indices, through a :class:`ResilientDriver`; prints the
    reference's per-step line every ``log_every`` steps and at the end.
    The kernels' launch counters are read around the steps.

    ``manager`` saves checkpoints at its cadence.  ``restore(live_state) ->
    (state, step)`` is how a failed step is recovered: it is handed the
    state the failed step started from and returns the state to replay from
    (up to 3 retries); without it a failure raises.  ``registry``,
    ``tracker`` and ``step_time_scale`` go to the driver.  ``on_step(step,
    state, metrics, dt)`` is called after each completed step.  ``history``
    and ``step_s`` hold the steps of the final trajectory, a replayed step
    once."""
    device = torch.device(device)
    if state is None:
        state = TS.init_state(api, tcfg, device=device)
    source = make_source(DataConfig(vocab_size=api.cfg.vocab_size), api.cfg)
    step_fn = TS.make_train_step(api, tcfg)
    history, step_s = [], []
    live = {"state": state}

    def batches(step):
        data = to_device(source.batch_at(step, batch, seq), device)
        _sync(device)
        return data

    def timed_step(state, data):
        live["state"] = state
        out = step_fn(state, data)
        _sync(device)
        return out

    def completed(step, state, metrics, dt):
        del history[step - 1 - start:], step_s[step - 1 - start:]
        step_s.append(dt)
        history.append({k: float(v) for k, v in metrics.items()})
        if (step - 1) % log_every == 0 or step == steps:
            m = history[-1]
            log(f"[train] step {step - 1:5d} loss={m['loss']:.4f} "
                f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                f"{batch * seq / max(dt, 1e-9):,.0f} tok/s")
        if on_step is not None:
            on_step(step, state, metrics, dt)

    drv = ResilientDriver(timed_step, manager, max_retries=0 if restore is None else 3,
                          registry=registry, tracker=tracker,
                          step_time_scale=step_time_scale)
    before = kernels.launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, _, _ = drv.run(state, batches, start_step=start, n_steps=steps - start,
                          restore_fn=(None if restore is None
                                      else lambda: restore(live["state"])),
                          on_step=completed)
    if manager is not None:
        manager.wait()
    after = kernels.launch_counts()
    return TrainResult(state=state, history=history, step_s=step_s,
                       launches={k: after[k] - before[k] for k in after},
                       peak_bytes=(torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0),
                       events=drv.events)


def reset_state(state: TS.TrainState, api: ModelAPI, tcfg: TrainConfig,
                device) -> TS.TrainState:
    """``state`` set in place to what ``TS.init_state`` makes: the
    parameters drawn again from ``tcfg.seed``, the optimizer state and the
    residual zeroed.  Only one parameter tree is allocated beside it."""
    fresh = api.init(torch.Generator(device=device).manual_seed(tcfg.seed), device)
    with torch.no_grad():
        for dst, src in zip(leaves(state.params), leaves(fresh)):
            dst.copy_(src)
        for t in leaves((state.opt_state, state.residual)):
            t.zero_()
    return state


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none", choices=("none", "int8"))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
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
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch, kind="train")
    # TileLoom mesh planning (informational on one card; resolves from the
    # persistent plan registry when the same cell was ranked before)
    store = plancache.get_store()
    with plancache.lookup_source(store) as probe:
        ranking = plan_mesh(api, shape, tcfg)
    print(f"[train] {cfg.name}: {api.n_params():,} params; planner ranking "
          f"({probe['source']}): "
          + ", ".join(f"{r.plan.name}({r.cost.dominant})" for r in ranking[:3]))
    store.flush_stats()

    mgr = CheckpointManager(Path(args.ckpt_dir) / cfg.name,
                            save_every=args.save_every, keep=3)
    state, start = mgr.restore_latest(target_tree=TS.abstract_state(api, tcfg),
                                      device=device)
    if state is None:
        state = TS.init_state(api, tcfg, device=device)
        start = 0
        print("[train] fresh start")
    else:
        print(f"[train] resumed from step {start}")

    reg = HeartbeatRegistry(1)
    straggler = StragglerTracker(reg)
    # fault injection (REPRO_FAULTS): host-straggler factors scale the step
    # wall-times reported into the heartbeat registry so detection paths run
    # under injected load; hw faults apply inside the planner/benchmarks
    sched = env_schedule()
    if sched is not None:
        print(f"[train] injected faults: {sched.describe()}")

    def restore(live):
        tree, at = mgr.restore_latest(target_tree=live, device=device)
        if tree is None:
            return reset_state(live, api, tcfg, device), 0
        return tree, at

    t0 = time.perf_counter()
    res = run(api, tcfg, args.steps, args.batch, args.seq, device, state=state,
              start=start, log_every=args.log_every, manager=mgr, restore=restore,
              registry=reg, tracker=straggler,
              step_time_scale=(None if sched is None
                               else lambda s: sched.straggler_factor(0, s)))
    total = time.perf_counter() - t0
    print(f"[train] done: {args.steps - start} steps in {total:.1f}s; "
          f"stragglers={straggler.stragglers()}")
    for ev in res.events:
        print(f"[train] recovery: step {ev.step} {ev.kind}: {ev.detail}")
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
