"""Batched serving launcher: one causal prefill pass + a greedy decode loop
with a KV cache (a recurrent state for RWKV6, both for zamba2), on one GPU.

``python -m repro_torch.launch.serve --arch qwen2.5-3b --batch 4
--prompt-len 512 --tokens 32`` greedy-decodes a batch of synthetic prompts
with random weights made from ``--seed``.  ``--arch`` names any of the six
families' configs: a dense decoder (``qwen2.5-3b``), an MoE
(``qwen3-moe-30b-a3b``, ``deepseek-moe-16b``), RWKV6 (``rwkv6-3b``), the
Mamba2 hybrid (``zamba2-1.2b``), the VLM (``internvl2-1b``, whose prompt
follows 256 stub image patches) or the encoder-decoder
(``seamless-m4t-medium``, whose decoder attends to 1024 encoded stub audio
frames).  The stub frontend input is drawn from the seed as well.

Every prompt pass (the decoder's, the VLM's image prefix and prompt, the
encoder's frames, the cross-attention over the memory) goes through the
FlashAttention kernel, every decode step's attention, self and cross,
through the flash-decode kernel; an MoE layer's experts go through the
grouped-GEMM kernel; an RWKV6 layer's prompt goes through the chunked-WKV
kernel in one pass, which hands its final state to decode.  The RWKV6 and
Mamba2 decode recurrences and the Mamba2 SSD scan are plain PyTorch, as the
reference's are plain array code; projections, router, dense MLP and LM
head are ``torch.einsum``.  ``--device cpu`` runs the same code with the
kernels' plain versions (tests do); without a GPU and without that flag the
launcher raises.

Before the weights load, the deadline-bounded plan service
(``--plan-budget-ms``) is asked for the mesh-parallel decode plan and the
launcher prints its ranking line with the rung that answered.  Serving-layer
observability (DESIGN_OBS.md): ``--introspect-port`` starts a read-only HTTP
endpoint (``/metrics`` Prometheus text, ``/healthz``, ``/slo``, ``/plans``,
``/tenants``) before any planning happens; ``--flightrec PATH`` (or
``REPRO_FLIGHTREC``) dumps the structured event ring buffer at exit for
``python -m repro_torch.obs incident PATH``.  Observation changes nothing
that is served: the ids, the kernel launches and the planned blocks are the
same with and without these flags.

``--tenants k`` is the reference's multi-tenant mode: k kernel tenants
planned onto disjoint partitions of one fabric (``--tenant-hw``, default
``wormhole_8x8``) through the tenancy layer, the plan checked for isolation,
optionally a core killed (``--tenant-kill R,C``) and the containment contract
asserted; ``/tenants`` then serves the live plan.  This mode plans and
launches no kernel, so it needs no device.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch import kernels, plancache
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import lower_torch
from repro_torch.data import DataConfig, make_source
from repro_torch.launch.common import launch_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.api import ModelAPI, require_device
from repro_torch.models import param as P
from repro_torch.obs import expo, flightrec, metrics, slo
from repro_torch.planservice import PlanService
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
             inputs: Optional[Dict[str, torch.Tensor]] = None,
             keep_step_logits: bool = False,
             forced_ids: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` in one causal pass, then decode ``tokens`` ids
    greedily.  ``inputs`` is the stub frontend input the VLM and the
    encoder-decoder take (:meth:`ModelAPI.frontend_inputs`).  The kernels'
    launch counters are read around the run.

    With ``forced_ids`` (batch, tokens) the loop feeds those ids instead of
    its own argmax (teacher forcing), which lets two attention paths be
    compared step by step without one broken tie sending them apart."""
    cfg = api.cfg
    device = prompts.device
    batch, prompt_len = prompts.shape
    inputs = inputs or {}
    max_len = api.prefix_len() + prompt_len + tokens + 1
    cache = api.init_cache(cfg, batch, max_len, device=device)
    step = make_serve_step(api)
    before = kernels.launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prompts, cache, **inputs)
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


def _traced(fn, device: torch.device, repeat: int) -> Dict[str, Any]:
    """Run ``fn`` ``repeat`` times under ``torch.profiler``; the wall time per
    run, the device's busy time and idle share, and the kernels that took
    most device time."""
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeat):
            fn()
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
    return {"runs": repeat, "wall_ms": wall_ms / repeat, "device_busy_ms": busy_ms / repeat,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "top_kernels": [{"name": n[:80], "ms": v[0] / repeat, "calls": v[1] / repeat}
                            for n, v in top]}


@torch.no_grad()
def profile_serve(api: ModelAPI, params, prompts: torch.Tensor, steps: int,
                  inputs: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """Where the time goes on the card: one traced prefill of ``prompts``
    (and the frontend ``inputs``; after an untraced one) and ``steps`` traced
    decode steps (after two untraced ones), each with its wall time per run,
    the device's busy time, its idle share and the kernels that took most
    device time."""
    cfg = api.cfg
    device = prompts.device
    if device.type != "cuda":
        raise ValueError("profile_serve traces the card; it needs a CUDA device")
    max_len = api.prefix_len() + prompts.shape[1] + steps + 4

    def prefill():
        cache = api.init_cache(cfg, prompts.shape[0], max_len, device=device)
        return api.prefill(params, prompts, cache, **(inputs or {}))

    prefill()
    traced_prefill = _traced(prefill, device, 1)
    logits, cache = prefill()
    step = make_serve_step(api)
    tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
    for _ in range(2):
        logits, cache = step(params, tok, cache)
    state = {"cache": cache}

    def decode():
        state["cache"] = step(params, tok, state["cache"])[1]

    return {"prefill": traced_prefill, "decode_step": _traced(decode, device, steps)}


def _plans_view() -> dict:
    """``/plans`` payload: the registry's cross-process stats blob, this
    serving process's live lookup counters, and the H100 block requests
    :mod:`repro_torch.core.lower_torch` resolved (blocks and source)."""
    store = plancache.get_store()
    s = store.stats
    blob = plancache.stats_blob(store)
    blob["process"] = {"hits_mem": s.hits_mem, "hits_disk": s.hits_disk,
                       "misses": s.misses, "puts": s.puts}
    blob["resolved"] = [
        {"template": template, "request": list(request), "blocks": list(blocks),
         "source": source}
        for (template, request), (blocks, source) in sorted(lower_torch.resolved_blocks().items())]
    return blob


def _tenants_view(state: dict) -> dict:
    """``/tenants`` payload from the live :class:`TenancyPlan` (filled in
    by :func:`_run_tenants`; empty in single-model mode)."""
    plan = state.get("plan")
    if plan is None:
        return {"mode": "model", "tenants": []}
    return {
        "hw": plan.hw.name,
        "layout_score": plan.layout_score,
        "n_layouts": plan.n_layouts,
        "free_cells": sorted(plan.free_cells()),
        "tenants": [{
            "tenant": p.tenant.name, "qos": p.tenant.qos,
            "rect": p.rect.describe(), "hw": p.hw.name, "rung": p.rung,
            "digest": p.digest, "sim_us": p.sim_s * 1e6,
        } for p in plan.placements],
        "incidents": list(state.get("incidents", [])),
    }


def _setup_observability(args) -> dict:
    """Arm the flight recorder / SLO tracker and (with
    ``--introspect-port``) start the read-only HTTP endpoint *before* any
    planning happens, so the earliest rung decisions are observable."""
    flightrec.refresh_from_env()             # REPRO_FLIGHTREC=<path>
    if args.flightrec:
        flightrec.enable(args.flightrec)
    obs = {"server": None, "plan": None, "incidents": []}
    if args.introspect_port is None and not flightrec.enabled():
        return obs
    slo.enable()                             # honors REPRO_SLO_* knobs
    if args.introspect_port is not None:
        server = expo.IntrospectionServer(port=args.introspect_port)
        server.add_provider("/plans", _plans_view)
        server.add_provider("/tenants", lambda: _tenants_view(obs))
        server.start()
        obs["server"] = server
        # scrapers parse this line for the bound (ephemeral) port
        print(f"[serve] introspection at {server.url} "
              f"(/metrics /healthz /slo /plans /tenants)", flush=True)
    return obs


def _finish_observability(args, obs: dict) -> None:
    if flightrec.enabled():
        path = flightrec.dump(reason="serve_done")
        if path:
            print(f"[serve] flight recorder dump: {path}")
    server = obs.get("server")
    if server is not None:
        if args.introspect_hold > 0:
            print(f"[serve] holding introspection open "
                  f"{args.introspect_hold:.1f}s at {server.url}", flush=True)
            time.sleep(args.introspect_hold)
        server.stop()


def _run_tenants(args, obs) -> None:
    """Multi-tenant serving mode (``--tenants k``): plan k concurrent
    kernel tenants onto disjoint partitions of one fabric through the
    tenancy layer, optionally inject a core kill, and *assert* the
    containment contract.  It plans and launches no kernel, as in the
    reference, so it needs no device.
    """
    from repro_torch.core import (block_shape_candidates, get_hw, matmul_program)
    from repro_torch.core.planner import SearchBudget
    from repro_torch.tenancy import (IsolationValidator, MeshPartitioner,
                                     TenantAdmission, TenantRuntime, TenantSpec)

    hw = get_hw(args.tenant_hw)
    shapes = [(256, 256, 256), (128, 512, 256), (512, 128, 256),
              (256, 512, 128)]
    tenants = []
    for i in range(args.tenants):
        m, n, k = shapes[i % len(shapes)]
        progs = [matmul_program(m, n, k, bm=bm, bn=bn, bk=bk)
                 for bm, bn, bk in block_shape_candidates(m, n, k)][:6]
        qos = "guaranteed" if i % 2 == 0 else "best_effort"
        tenants.append(TenantSpec(f"tenant{i}", progs, qos=qos))

    service = PlanService()
    budget = SearchBudget(top_k=3, max_mappings=16,
                          max_plans_per_mapping=10, max_candidates=500)
    admission = TenantAdmission()
    partitioner = MeshPartitioner(plan_layouts=2)
    # admission gates each tenant's resolve deadline; the joint search
    # receives the per-tenant outcome as its budget override
    tenant_ms = {}
    for t in tenants:
        with admission.admit(t, args.plan_budget_ms) as ms:
            if ms is not None:
                tenant_ms[t.name] = ms
    plan = partitioner.plan(hw, tenants, service=service, budget=budget,
                            budget_ms=float("inf"),
                            tenant_budget_ms=tenant_ms or None)
    bad = IsolationValidator().validate(plan)
    if bad:
        raise SystemExit(f"[serve] isolation validation failed: {bad}")
    obs["plan"] = plan                   # /tenants now serves the live view
    print(f"[serve] {args.tenants} tenants on {hw.name}: "
          f"{plan.describe()}")

    if args.tenant_kill:
        core = tuple(int(v) for v in args.tenant_kill.split(","))
        runtime = TenantRuntime(plan, service=service, cache=service.cache,
                                budget=budget, partitioner=partitioner)
        ev = runtime.kill_core(core)
        obs["plan"] = runtime.plan       # containment may repartition
        obs["incidents"].append({
            "cause": ev.cause, "cell": core, "owner": ev.owner,
            "rung": ev.rung, "blast_radius": ev.blast_radius,
            "seconds": ev.seconds, "within_budget": ev.within_budget,
        })
        print(f"[serve] core_kill {core}: owner={ev.owner} rung={ev.rung} "
              f"blast_radius={ev.blast_radius} "
              f"seconds={ev.seconds * 1e3:.1f}ms "
              f"within_budget={ev.within_budget}")
        for line in ev.log:
            print(f"[serve]   {line}")
        if not ev.contained():
            raise SystemExit("[serve] CONTAINMENT VIOLATED: an untouched "
                             "tenant's plan digest changed")
        if ev.owner is not None and not ev.within_budget:
            raise SystemExit("[serve] deadline exceeded: the degraded "
                             "tenant did not resolve within its budget")
        print(f"[serve] containment ok: untouched={list(ev.untouched)} "
              f"digests unchanged")
    plancache.get_store().flush_stats()
    counts = metrics.counter_totals(metrics.snapshot())
    if counts:
        print("[serve] metrics: " + " ".join(
            f"{k}={v:g}" for k, v in sorted(counts.items())
            if k.startswith(("tenancy", "replan", "planservice"))))
    dumped = metrics.dump()              # honors REPRO_METRICS=<path>
    if dumped:
        print(f"[serve] metrics snapshot written to {dumped}")


def main(argv=None) -> Optional[ServeResult]:
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
                    help="after the run, trace one prefill and STEPS decode steps with "
                         "torch.profiler and print the device's busy time, idle share "
                         "and top kernels for each")
    ap.add_argument("--plan-budget-ms", type=float, default=None,
                    help="plan-service deadline (default "
                         "$REPRO_PLAN_DEADLINE_MS / 10ms)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="multi-tenant mode: partition the fabric for k "
                         "concurrent kernel tenants instead of serving "
                         "one model")
    ap.add_argument("--tenant-hw", default="wormhole_8x8",
                    help="fabric preset for --tenants mode")
    ap.add_argument("--tenant-kill", default="",
                    help="inject a core kill at mesh coords 'R,C' after "
                         "partitioning and assert containment")
    ap.add_argument("--introspect-port", type=int, default=None,
                    metavar="PORT",
                    help="serve read-only introspection HTTP on PORT "
                         "(0 = ephemeral; prints the bound URL): /metrics "
                         "(Prometheus text), /healthz, /slo, /plans, "
                         "/tenants")
    ap.add_argument("--introspect-hold", type=float, default=0.0,
                    metavar="SECONDS",
                    help="keep the introspection endpoint up SECONDS after "
                         "the run finishes (scrape window for smoke tests)")
    ap.add_argument("--flightrec", default="",
                    metavar="PATH",
                    help="arm the flight recorder and dump its ring buffer "
                         "to PATH at exit (same as REPRO_FLIGHTREC=PATH); "
                         "render with `python -m repro_torch.obs incident PATH`")
    args = ap.parse_args(argv)

    obs = _setup_observability(args)
    try:
        if args.tenants > 0:
            _run_tenants(args, obs)
            res = None
        else:
            res = _serve(args)
        _finish_observability(args, obs)
    finally:
        if obs["server"] is not None:
            obs["server"].stop()             # also when serving raised
    return res


def _serve(args) -> ServeResult:
    device = require_device(args.device)
    cfg = launch_config(args.arch, reduced=args.reduced)
    api = build_model(cfg)
    shape = ShapeConfig("serve", seq_len=args.prompt_len + args.tokens,
                        global_batch=args.batch, kind="decode")
    # the serving loop never stalls on planning: the deadline-bounded
    # service answers from cache / family / bounded search / fallback
    resp = PlanService().resolve_mesh(api, shape, TrainConfig(),
                                      budget_ms=args.plan_budget_ms)
    ranking = resp.ranking or []
    print(f"[serve] {cfg.name}: decode plan ranking "
          f"(rung={resp.rung} {resp.seconds * 1e3:.1f}ms): "
          + ", ".join(r.plan.name for r in ranking[:3]))
    plancache.get_store().flush_stats()

    params = load_params(api, device, args.seed)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, device)
    inputs = api.frontend_inputs(args.batch,
                                 torch.Generator(device=device).manual_seed(args.seed), device)
    res = generate(api, params, prompts, args.tokens, inputs=inputs)

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
        print("[serve] profile: "
              + json.dumps(profile_serve(api, params, prompts, args.profile, inputs)))
    return res


if __name__ == "__main__":
    main()
