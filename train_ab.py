#!/usr/bin/env python3
"""Time the training step of every model the port trains through K2-bwd,
for several checkouts in turns on one card, each model alone on the card.

    python3 train_ab.py [--steps N] TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` is this one; an older
commit unpacked with ``git archive`` into ``_parent/`` is another).  Each
runs in a fresh process that builds that checkout's kernels into
``TREE/build/ab-kernels`` and, one model after the other, trains it with
that checkout's ``launch.train.run`` as ``chip_smoke.py``'s training phases
do: float32 master weights from seed 0, bf16 compute, remat, AdamW at lr
1e-3, SyntheticLM batches of 4 x 512.  The models: qwen2.5-3b at full
depth (``train``), gemma-7b at 4 layers (``gemma_train``), qwen3-moe at 2
layers (``moe_train``), zamba2-1.2b, internvl2-1b and seamless-m4t-medium at
full depth.  Per model it prints the host's step ms of N steps (8 by
default; the first compiles nothing but allocates), their median without
the first, the peak bytes, K2-bwd's calls, and one more step traced under
``torch.profiler``: its wall ms, the device's busy ms and K2-bwd's share of
it (the device time of the kernels named ``flash_bwd``).  One JSON line a
tree; the card's name and power limit last.  Name the trees as parent,
change, change, parent to see the drift across the call.  Needs one NVIDIA
GPU.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

# (row, arch, layers: None for full depth)
MODELS = (("train", "qwen2.5-3b", None), ("gemma_train", "gemma-7b", 4),
          ("moe_train", "qwen3-moe-30b-a3b", 2), ("hybrid_train", "zamba2-1.2b", None),
          ("vlm_train", "internvl2-1b", None), ("encdec_train", "seamless-m4t-medium", None))
BATCH, SEQ = 4, 512


def traced_step(step, device) -> dict:
    """One call of ``step`` under ``torch.profiler``: wall ms, the device's
    busy ms and the device ms of the K2-bwd kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    busy = bwd = 0.0
    for ev in prof.events():
        if getattr(ev, "device_type", None) is not None and "cuda" in str(
                ev.device_type).lower() and ev.device_time_total > 0:
            busy += ev.device_time_total / 1e3
            if "flash_bwd" in ev.name:
                bwd += ev.device_time_total / 1e3
    return {"wall_ms": wall, "busy_ms": busy, "flash_bwd_ms": bwd}


def one(tree: str, steps: int) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    from dataclasses import replace

    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import common, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt, train_step as TS
    if not os.path.samefile(TL.__file__, os.path.join(tree, "src", "repro_torch", "launch",
                                                      "train.py")):
        raise RuntimeError(f"repro_torch came from {TL.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rows = {}
    for row, arch, layers in MODELS:
        cfg = common.launch_config(arch)
        if layers is not None:
            cfg = replace(cfg, n_layers=layers)
        api = build_model(cfg)
        params = api.init(torch.Generator(device=device).manual_seed(0), device)
        tcfg = TrainConfig(learning_rate=1e-3, total_steps=steps + 1, warmup_steps=1)
        state = TS.TrainState(params, opt.opt_init(params, tcfg))
        res = TL.run(api, tcfg, steps, BATCH, SEQ, device, state=state, log=lambda _: None)
        step_fn = TS.make_train_step(api, tcfg)
        data = TL.to_device(make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
                            .batch_at(steps, BATCH, SEQ), device)
        holder = {"state": res.state}

        def step():
            holder["state"] = step_fn(holder["state"], data)[0]

        ms = [t * 1e3 for t in res.step_s]
        rows[row] = {"arch": arch, "n_layers": cfg.n_layers, "step_ms": ms,
                     "median_ms": statistics.median(ms[1:]), "peak_bytes": res.peak_bytes,
                     "flash_attention_bwd": res.launches.get("flash_attention_bwd"),
                     "finite": all(math.isfinite(h[k]) for h in res.history
                                   for k in ("loss", "grad_norm")),
                     "traced": traced_step(step, device)}
        del holder, res, state, params, api, step_fn, data
        gc.collect()
        torch.cuda.empty_cache()
    return {"tree": tree, "rows": rows}


def main(argv) -> int:
    steps = 8
    if argv[:1] == ["--steps"]:
        steps, argv = int(argv[1]), argv[2:]
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(one(os.path.abspath(argv[1]), steps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not argv:
        print("train_ab: needs one NVIDIA GPU and at least one checkout", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    for i, tree in enumerate(argv):
        tree = os.path.abspath(tree)
        env = dict(os.environ,
                   REPRO_TORCH_BUILD_DIR=os.path.join(tree, "build", "ab-kernels"),
                   REPRO_PLAN_CACHE_DIR=os.path.join(tree, "build", f"ab-plancache-{i}"),
                   REPRO_PLANNER_WORKERS="1")
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--steps",
                               str(steps), "--one", tree], env=env, capture_output=True,
                              text=True, timeout=1200)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return done.returncode
        print(json.dumps(dict(json.loads(done.stdout.strip().splitlines()[-1]), order=i)),
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
