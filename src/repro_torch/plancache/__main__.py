"""AOT tuning CLI for the persistent plan registry.

Counterpart of ``repro/plancache/__main__.py`` with its commands and flags:

``python -m repro_torch.plancache warm``   pre-tunes the GEMM / flash
                                           block-shape tables of the port's
                                           kernels on one H100 (bf16, the
                                           keys ``kernels.ops`` looks up)
                                           and the mesh sharding rankings on
                                           the port's default cluster for
                                           every registry (arch x shape)
                                           cell, so ``launch/serve`` and
                                           ``launch/train`` start with a hot
                                           cache.  ``--wormhole``, ``--faults``
                                           and ``--pipeline`` warm the
                                           paper's Wormhole tables, the
                                           single-core-failure pools and the
                                           co-planning cells as the
                                           reference does.  ``--jobs N``
                                           shards the sweep across N worker
                                           processes publishing into the
                                           shared disk store (see
                                           ``warmjobs.py``).
``python -m repro_torch.plancache ls``     lists entries (template, shape, hw).
``python -m repro_torch.plancache stats``  entry count + cumulative hit/miss
                                           counters across processes;
                                           ``--json`` adds this process's
                                           metrics registry
                                           (``repro_torch.obs``).
``python -m repro_torch.plancache prune``  age/count-based disk eviction.

The benchmark tables come from ``warmjobs.py``'s copies: the
``benchmarks`` package imports the reference.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Sequence, Tuple

from . import warmjobs
from .store import get_store

# chip-level GEMM shapes always worth pre-tuning (the benchmark suite's
# tables are merged in from warmjobs.py's copies)
BASE_GEMM_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (1024, 1024, 4096), (4096, 4096, 4096),
    (16384, 1024, 4096), (4096, 16384, 4096),
)
BASE_FLASH_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (4096, 4096, 64), (4096, 4096, 128), (8192, 8192, 128),
)
# GEMM cells of the single-core-failure plan pools (``warm --faults``) —
# must mirror the degraded-mesh acceptance suite (tests/test_faults.py)
FAULT_GEMM_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (256, 256, 256), (512, 512, 512), (512, 1024, 512),
)


def _parse_shape(text: str, n: int) -> Tuple[int, ...]:
    parts = tuple(int(p) for p in text.lower().split("x"))
    if len(parts) != n:
        raise argparse.ArgumentTypeError(
            f"expected {n}'x'-separated ints, got {text!r}")
    return parts


def _registry_gemm_shapes(archs: Sequence[str], tokens: int = 4096
                          ) -> List[Tuple[int, int, int]]:
    from repro_torch.configs import ARCHS
    shapes = set()
    for name in archs:
        cfg = ARCHS[name]
        d, f = cfg.d_model, cfg.d_ff
        shapes.add((tokens, f, d))              # up-projection
        shapes.add((tokens, d, f))              # down-projection
        shapes.add((tokens, cfg.padded_vocab, d))   # LM head
    return sorted(shapes)


def _registry_flash_shapes(archs: Sequence[str]
                           ) -> List[Tuple[int, int, int]]:
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import SHAPES
    shapes = set()
    seqs = sorted({s.seq_len for s in SHAPES.values() if s.seq_len <= 32768})
    for name in archs:
        hd = ARCHS[name].head_dim_
        for seq in seqs:
            shapes.add((seq, seq, hd))
    return sorted(shapes)


def _benchmark_gemm_shapes(full: bool) -> List[Tuple[int, int, int]]:
    return sorted(set(warmjobs.gemm_shape_table(full)) | set(warmjobs.TOPK_SHAPES))


def _benchmark_flash_shapes() -> List[Tuple[int, int, int]]:
    """(Sq, Skv, d) cells derived from the Fig-7 benchmark sweep."""
    return sorted({(seq, seq, d) for _bh, seq, d in warmjobs.flash_shape_table()})


def _wormhole_flash_shapes() -> List[Tuple[int, int, int]]:
    """(batch*heads, seq, head_dim) cells of the Fig-7 sweep itself."""
    return list(warmjobs.flash_shape_table())


# ----------------------------------------------------------------- warm
def cmd_warm(args: argparse.Namespace) -> int:
    if args.fast:
        os.environ["REPRO_FAST_SEARCH"] = "1"
    from repro_torch.core.planner import fast_search_enabled
    if fast_search_enabled():
        # keys include the effective (shrunk) budget, so these entries only
        # serve consumers that also run with REPRO_FAST_SEARCH set
        print("[warm] note: REPRO_FAST_SEARCH is on — entries are keyed for "
              "fast-search consumers; production lookups without the env "
              "var will not hit them")
    store = get_store()
    if not store.enabled:
        print("plan cache disabled (REPRO_PLAN_CACHE=off); nothing to warm")
        return 1
    archs = (args.archs.split(",") if args.archs else None)
    t0 = time.perf_counter()
    jobs: List[tuple] = []

    if not args.skip_gemm:
        from repro_torch.configs import ARCHS
        names = archs or sorted(ARCHS)
        shapes = set(args.gemm or [])
        if not args.gemm:
            shapes.update(BASE_GEMM_SHAPES)
            shapes.update(_registry_gemm_shapes(names))
        jobs += [("gemm", s) for s in sorted(shapes)]

    if not args.skip_flash:
        from repro_torch.configs import ARCHS
        names = archs or sorted(ARCHS)
        shapes = set(args.flash or [])
        if not args.flash:
            shapes.update(BASE_FLASH_SHAPES)
            shapes.update(_registry_flash_shapes(names))
            shapes.update(_benchmark_flash_shapes())
        jobs += [("flash", s) for s in sorted(shapes)]

    if not args.skip_mesh:
        from repro_torch.configs.registry import cells
        jobs += [("mesh", (cfg.name, shape.name)) for cfg, shape, _ in cells()
                 if not archs or cfg.name in archs]

    if args.pipeline:
        jobs += [("pipeline", (spec, args.pipeline_hw))
                 for spec in args.pipeline]

    if args.wormhole:
        hw_names = warmjobs.HW_CONFIGS if args.hw == "all" else (args.hw,)
        jobs += [("wh_gemm", (hw_name, s)) for hw_name in hw_names
                 for s in _benchmark_gemm_shapes(args.full)]
        # flash_fig7 cells (wormhole_8x8 only, as the benchmark runs them)
        jobs += [("wh_flash", s) for s in _wormhole_flash_shapes()]

    if args.faults:
        from repro_torch.core import get_hw
        fhw = get_hw(args.faults_hw)
        shapes = list(args.faults_gemm or FAULT_GEMM_SHAPES)
        if args.faults_core:
            cores = [tuple(int(v) for v in c.split(","))
                     for c in args.faults_core]
        else:
            import itertools
            cores = [tuple(c) for c in itertools.product(
                *(range(s) for _, s in fhw.mesh_dims))]
        jobs += [("fault_gemm", (args.faults_hw, s, core))
                 for core in cores for s in shapes]

    cum0 = store.cumulative_stats()       # workers flush into this file
    for line in warmjobs.run_jobs(jobs, args.jobs):
        print(line)

    cum = store.flush_stats()
    dt = time.perf_counter() - t0
    if args.jobs > 1:
        # this run's activity lives in the worker processes; the parent's
        # own store.stats saw nothing — report the cumulative-file delta
        # the workers flushed under the advisory lock
        d = {k: cum.get(k, 0) - cum0.get(k, 0) for k in
             ("hits_mem", "hits_disk", "misses", "puts")}
        hits = d["hits_mem"] + d["hits_disk"]
        line = (f"{hits} hits ({d['hits_mem']} mem / {d['hits_disk']} "
                f"disk), {d['misses']} misses, {d['puts']} new entries")
    else:
        s = store.stats
        line = (f"{s.hits} hits ({s.hits_mem} mem / {s.hits_disk} disk), "
                f"{s.misses} misses, {s.puts} new entries")
    print(f"[warm] {len(jobs)} shapes in {dt:.1f}s"
          + (f" across {args.jobs} jobs" if args.jobs > 1 else "")
          + f": {line}; store now {store.n_entries()} entries, "
          f"cumulative hit rate "
          f"{_rate(cum):.0%}")
    return 0


def _rate(cum: dict) -> float:
    hits = cum.get("hits_mem", 0) + cum.get("hits_disk", 0)
    total = hits + cum.get("misses", 0)
    return hits / total if total else 0.0


# ------------------------------------------------------------------- ls
def cmd_ls(args: argparse.Namespace) -> int:
    store = get_store()
    now = time.time()
    n = 0
    for ent in store.entries():
        meta = ent.get("meta", {})
        if args.template and meta.get("template") != args.template:
            continue
        n += 1
        age = now - float(ent.get("created", now))
        shape = "x".join(str(s) for s in meta.get("shape", [])) or "-"
        print(f"{ent['key'][:12]}  {meta.get('template', '?'):<12} "
              f"shape={shape:<20} hw={meta.get('hw_name', '?'):<16} "
              f"age={age / 3600:.1f}h")
    print(f"{n} entries in {store.root}")
    return 0


# ---------------------------------------------------------------- stats
def cmd_stats(args: argparse.Namespace) -> int:
    from .store import stats_blob
    store = get_store()
    blob = stats_blob(store)
    cum = blob["cumulative"]
    if getattr(args, "as_json", False):
        import json
        from repro_torch.obs import metrics
        print(json.dumps({"store": blob, "metrics": metrics.snapshot()},
                         indent=1, sort_keys=True))
        return 0
    print(f"store: {store.root}  (enabled={store.enabled})")
    print(f"entries: {blob['entries']}")
    for t, c in sorted(blob["by_template"].items()):
        print(f"  {t}: {c}")
    hits = cum.get("hits_mem", 0) + cum.get("hits_disk", 0)
    print(f"cumulative: {hits} hits ({cum.get('hits_mem', 0)} mem / "
          f"{cum.get('hits_disk', 0)} disk), {cum.get('misses', 0)} misses, "
          f"{cum.get('puts', 0)} puts, {cum.get('warm_starts', 0)} "
          f"warm-starts, {cum.get('bypassed', 0)} bypassed")
    print(f"hit rate: {_rate(cum):.1%}")
    return 0


# ---------------------------------------------------------------- prune
def cmd_prune(args: argparse.Namespace) -> int:
    store = get_store()
    max_age = args.max_age_days * 86400.0 if args.max_age_days else None
    removed = store.prune(max_entries=args.max_entries, max_age_s=max_age)
    print(f"pruned {removed} entries; {store.n_entries()} remain "
          f"in {store.root}")
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plancache",
        description="Persistent dataflow-plan registry: AOT tuning + "
                    "maintenance")
    sub = ap.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("warm", help="pre-tune shape tables into the cache")
    w.add_argument("--gemm", action="append",
                   type=lambda t: _parse_shape(t, 3), metavar="MxNxK",
                   help="explicit GEMM shape (repeatable; overrides tables)")
    w.add_argument("--flash", action="append",
                   type=lambda t: _parse_shape(t, 3), metavar="SqxSkvxD",
                   help="explicit flash shape (repeatable; overrides tables)")
    w.add_argument("--archs", default=None,
                   help="comma-separated registry archs (default: all)")
    w.add_argument("--skip-gemm", action="store_true")
    w.add_argument("--skip-flash", action="store_true")
    w.add_argument("--skip-mesh", action="store_true")
    w.add_argument("--pipeline", action="append", metavar="KIND:DIMS",
                   help="warm a kernel-graph co-planning cell (repeatable): "
                        "mlp2:MxDxF, attn:HxSqxSkvxD, or moe:ExCxDmxDf "
                        "(graph-level entry + the per-node kernel entries)")
    w.add_argument("--pipeline-hw", default="wormhole_8x8",
                   help="hardware preset for --pipeline cells "
                        "(default: wormhole_8x8)")
    w.add_argument("--wormhole", action="store_true",
                   help="also warm the Wormhole benchmark GEMM/flash tables")
    w.add_argument("--hw", default="all",
                   help="hardware preset for --wormhole GEMM warming "
                        "(\"all\" = every benchmark mesh config)")
    w.add_argument("--full", action="store_true",
                   help="use the full benchmark shape tables")
    w.add_argument("--faults", action="store_true",
                   help="pre-warm single-core-failure plan pools: for each "
                        "core of --faults-hw, run the degradation ladder "
                        "(repro_torch.runtime.replan) on the one-core-dead mesh "
                        "and publish under the degraded cache key, so a "
                        "live failure re-plans as a pure cache hit")
    w.add_argument("--faults-hw", default="wormhole_8x8",
                   help="hardware preset for --faults pools "
                        "(default: wormhole_8x8)")
    w.add_argument("--faults-gemm", action="append",
                   type=lambda t: _parse_shape(t, 3), metavar="MxNxK",
                   help="GEMM cells per failed core (repeatable; default: "
                        "the degraded-mesh acceptance suite)")
    w.add_argument("--faults-core", action="append", metavar="R,C",
                   help="restrict the pool to specific failed cores "
                        "(repeatable; default: every core of the mesh)")
    w.add_argument("--fast", action="store_true",
                   help="set REPRO_FAST_SEARCH=1 for this run")
    w.add_argument("--jobs", type=int, default=1,
                   help="shard the sweep across N worker processes (all "
                        "publish into the shared disk store; results are "
                        "identical to --jobs 1).  Each job runs its search "
                        "inline — the per-search process pool "
                        "(REPRO_PLANNER_WORKERS, default cpu count, 0/1 = "
                        "inline) applies when --jobs is 1.  Default: 1")
    w.set_defaults(fn=cmd_warm)

    l = sub.add_parser("ls", help="list cache entries")
    l.add_argument("--template", default=None,
                   help="filter by entry template (gemm_blocks, mesh_plan...)")
    l.set_defaults(fn=cmd_ls)

    s = sub.add_parser("stats", help="entry counts + cumulative hit/miss")
    s.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable snapshot: store stats + this "
                        "process's unified metrics registry "
                        "(repro_torch.obs.metrics)")
    s.set_defaults(fn=cmd_stats)

    p = sub.add_parser("prune", help="evict old/stale entries")
    p.add_argument("--max-entries", type=int, default=None)
    p.add_argument("--max-age-days", type=float, default=None)
    p.set_defaults(fn=cmd_prune)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
