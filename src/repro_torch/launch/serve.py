"""Batched serving launcher: one causal prefill pass + a greedy decode loop
with a KV cache, on one GPU.

``python -m repro_torch.launch.serve --arch qwen2.5-3b --batch 4
--prompt-len 512 --tokens 32`` greedy-decodes a batch of synthetic prompts
with random weights made from ``--seed``; ``--arch qwen3-moe-30b-a3b`` or
``deepseek-moe-16b`` serves an MoE model the same way.  The prompt goes
through the FlashAttention kernel in one pass, every decode step through the
flash-decode kernels with the cache's valid length; an MoE layer's experts
go through the grouped-GEMM kernel; projections, router, dense MLP and LM
head are ``torch.einsum``.  ``--device cpu`` runs the same code with the
kernels' plain versions (tests do); without a GPU and without that flag the
launcher raises.

Not ported yet (ROADMAP.md, Queue 1): the mesh-plan ranking, ``--tenants``
mode and the ``--introspect-port`` / ``--flightrec`` flags of the reference.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lower_torch
from repro_torch.data import DataConfig, make_source
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.api import ModelAPI, require_device
from repro_torch.models import param as P
from repro_torch.obs import metrics
from repro_torch.train.serve_step import make_serve_step


@dataclass
class ServeResult:
    generated: torch.Tensor              # (batch, tokens) greedy ids
    prefill_logits: torch.Tensor         # (batch, vocab) of the last prompt token
    last_logits: torch.Tensor            # (batch, vocab) of the last decode step
    step_logits: List[torch.Tensor]      # per decode step, when asked for
    prefill_s: float
    decode_s: float
    launches: Dict[str, int] = field(default_factory=dict)
    blocks: Dict[Any, Any] = field(default_factory=dict)
    peak_bytes: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_params(api: ModelAPI, device, seed: int) -> Dict[str, Any]:
    """Random weights from ``seed``, each leaf drawn **directly in the
    compute dtype**, so that the per-use casts in ``models/layers.py`` cost
    nothing while serving and no float32 copy is ever held: qwen3-moe-30b-a3b
    takes 61 GB in bf16 but would take 122 GB in the spec's float32."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return P.materialize(gen, P.cast_spec_dtype(api.spec, L.cdtype(api.cfg)), dev)


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, device) -> torch.Tensor:
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    toks = source.batch_at(0, batch, prompt_len)["tokens"]
    return torch.from_numpy(toks).to(device=device, dtype=torch.long)


@torch.no_grad()
def generate(api: ModelAPI, params, prompts: torch.Tensor, tokens: int, *,
             keep_step_logits: bool = False,
             forced_ids: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` in one causal pass, then decode ``tokens`` ids
    greedily.  The kernels' launch counters are read around the run.

    With ``forced_ids`` (batch, tokens) the loop feeds those ids instead of
    its own argmax (teacher forcing), which lets two attention paths be
    compared step by step without one broken tie sending them apart."""
    cfg = api.cfg
    device = prompts.device
    batch, prompt_len = prompts.shape
    max_len = prompt_len + tokens + 1
    cache = api.init_cache(cfg, batch, max_len, device=device)
    step = make_serve_step(api)
    before = kernels.launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prompts, cache)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits[:, -1, :cfg.vocab_size].float()

    def pick(i: int, logits: torch.Tensor) -> torch.Tensor:
        if forced_ids is not None:
            return forced_ids[:, i:i + 1]
        return torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)

    out, step_logits = [], []
    t0 = time.perf_counter()
    for i in range(tokens):
        tok = pick(i, logits)
        out.append(tok)
        logits, cache = step(params, tok, cache)
        if keep_step_logits:
            step_logits.append(logits[:, -1, :cfg.vocab_size].float())
    _sync(device)
    decode_s = time.perf_counter() - t0

    after = kernels.launch_counts()
    return ServeResult(
        generated=torch.cat(out, dim=1) if out else prompts[:, :0],
        prefill_logits=prefill_logits,
        last_logits=logits[:, -1, :cfg.vocab_size].float(),
        step_logits=step_logits, prefill_s=prefill_s, decode_s=decode_s,
        launches={k: after[k] - before[k] for k in after},
        blocks=lower_torch.resolved_blocks(),
        peak_bytes=(torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0))


@torch.no_grad()
def profile_decode(api: ModelAPI, params, prompts: torch.Tensor, steps: int) -> Dict[str, Any]:
    """Where a decode step's time goes on the card: prefill, warm up, then
    trace ``steps`` decode steps with ``torch.profiler`` and report the wall
    time per step, the time the device was busy, its idle share and the
    kernels that took most device time."""
    from torch.profiler import ProfilerActivity, profile
    cfg = api.cfg
    device = prompts.device
    if device.type != "cuda":
        raise ValueError("profile_decode traces the card; it needs a CUDA device")
    cache = api.init_cache(cfg, prompts.shape[0], prompts.shape[1] + steps + 4,
                           device=device)
    step = make_serve_step(api)
    logits, cache = api.prefill(params, prompts, cache)
    tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
    for _ in range(2):
        logits, cache = step(params, tok, cache)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = step(params, tok, cache)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: Dict[str, List[float]] = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) is not None and "cuda" in str(
                ev.device_type).lower() and ev.device_time_total > 0:
            rec = by_kernel.setdefault(ev.name, [0.0, 0])
            rec[0] += ev.device_time_total / 1e3
            rec[1] += 1
    busy_ms = sum(v[0] for v in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "top_kernels": [{"name": n[:80], "ms_per_step": v[0] / steps,
                             "calls_per_step": v[1] / steps} for n, v in top]}


def serve_config(arch: str, *, reduced: bool = False,
                 kernels_path: str = "cuda") -> ModelConfig:
    """The served model's config: ``kernels_path`` is ``"cuda"`` (attention
    and MoE experts through ``repro_torch.kernels``) or ``"plain"`` (dense
    PyTorch)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return replace(cfg, kernels=kernels_path)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the run, trace STEPS decode steps with torch.profiler "
                         "and print the device's busy time, idle share and top kernels")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = serve_config(args.arch, reduced=args.reduced)
    api = build_model(cfg)
    params = load_params(api, device, args.seed)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, device)
    res = generate(api, params, prompts, args.tokens)

    print(f"[serve] {cfg.name} on {device} "
          f"({api.n_params() / 1e9:.2f}B params, kernels={cfg.kernels})")
    for (template, request), (blocks, source) in sorted(res.blocks.items()):
        print(f"[serve] planner {template} shape={request[:-1]} "
              f"({request[-1]}-byte elements): blocks={blocks} ({source})")
    print(f"[serve] prefill {args.prompt_len} tok x{args.batch}: "
          f"{res.prefill_s:.3f}s; decode {args.tokens} tok x{args.batch}: "
          f"{res.decode_s:.3f}s "
          f"({args.tokens * args.batch / max(res.decode_s, 1e-9):.1f} tok/s)")
    print(f"[serve] sample generation (ids): {res.generated[0, :16].tolist()}")
    print("[serve] kernel launches: " + " ".join(
        f"{k}={v}" for k, v in sorted(res.launches.items())))
    counts = metrics.counter_totals(metrics.snapshot())
    if counts:
        print("[serve] metrics: " + " ".join(
            f"{k}={v:g}" for k, v in sorted(counts.items())))
    dumped = metrics.dump()              # honors REPRO_METRICS=<path>
    if dumped:
        print(f"[serve] metrics snapshot written to {dumped}")
    if args.profile > 0:
        import json
        print("[serve] decode profile: "
              + json.dumps(profile_decode(api, params, prompts, args.profile)))
    return res


if __name__ == "__main__":
    main()
