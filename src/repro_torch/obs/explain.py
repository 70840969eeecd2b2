"""Plan introspection: why did the planner pick *this* dataflow?

``python -m repro_torch.obs explain <suite/cell>`` re-resolves one benchmark
cell (same programs, same budgets, same plan-cache keys as
``benchmarks/plan_speed.py``) and renders:

* the **simulated resource timeline** — the wave-class records of the
  event simulator (``repro_torch.core.simulator.simulate(..., record=[])``):
  per class its population, active-core count, wave/hoist/overhead
  seconds and DRAM/NoC bytes, with a proportional ASCII bar;
* an **ASCII mesh heatmap** — per-core busy time accumulated over the
  wave classes (population x wave seconds for every class whose active
  mask covers the core), scaled to a 10-glyph ramp;
* the **winner-vs-runner-up diff** — per-resource busy seconds and bytes
  from :func:`repro_torch.core.perfmodel.cost_breakdown` for the top two
  candidates, so "why not the runner-up" is answerable from the df
  resource that separates them;
* for **pipeline cells**, the per-edge forward-vs-spill delta: each edge
  of the winning graph plan is flipped in isolation and the affected
  nodes re-simulated, so every forwarding decision carries its marginal
  end-to-end cost.

Resolution is read-through-cached: pass a :class:`repro_torch.plancache.PlanCache`
(the CLI default) and previously-planned cells render without re-searching.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import (SearchBudget, block_shape_candidates,
                        flash_attention_program, flash_decode_program,
                        get_hw, matmul_program, moe_gmm_program,
                        plan_kernel_multi, simulate)
from repro_torch.core.perfmodel import cost_breakdown
from repro_torch.core.simulator import _core_coords
from repro_torch.pipeline import (attn_qk_pv_graph, forward_spec, mlp2_graph,
                            moe_ffn_graph, node_legs, plan_pipeline,
                            simulate_nodes)

# ---------------------------------------------------------------------------
# Benchmark-suite mirrors.  These constants intentionally duplicate
# benchmarks/common.py, benchmarks/plan_speed.py, benchmarks/reduction_table.py
# and benchmarks/pipeline_table.py: explain must resolve the *same* programs
# under the *same* budgets so its plans (and plan-cache keys) match what the
# benchmark JSON reports.  benchmarks/ is not an installed package, so the
# values are mirrored rather than imported; tests/test_obs.py pins them.
# ---------------------------------------------------------------------------
DEFAULT_BUDGET = SearchBudget(top_k=5, max_plans_per_mapping=48,
                              max_candidates=8000)
FLASH_BUDGET = SearchBudget(top_k=5, max_plans_per_mapping=48)
REDUCTION_BUDGET = SearchBudget(top_k=5, max_plans_per_mapping=48,
                                max_candidates=8000)
PIPELINE_BUDGET = SearchBudget(top_k=4, max_plans_per_mapping=48,
                               max_candidates=8000)
GEMM_BLOCKS = ((64, 64, 64), (128, 128, 64), (128, 64, 128),
               (128, 128, 128))
ATTN_BLOCKS = ((64, 64), (128, 128), (128, 256), (256, 128))

_RAMP = " .:-=+*#%@"


class CellError(ValueError):
    """Unrecognized or malformed cell name."""


def _parse(pattern: str, text: str, cell: str) -> Tuple[int, ...]:
    m = re.fullmatch(pattern, text)
    if m is None:
        raise CellError(f"malformed cell {cell!r} (want {pattern})")
    return tuple(int(g) for g in m.groups())


def resolve_kernel_cell(cell: str, *, cache: Any = None,
                        workers: Optional[int] = 1):
    """(PlanResult, HardwareModel) for a single-kernel plan_speed cell
    (``gemm/<hw>/...``, ``flash/...`` or ``reduction/<family>/...``)."""
    from dataclasses import replace
    parts = cell.split("/")
    suite = parts[0]
    if suite == "gemm" and len(parts) == 3:
        hw = get_hw(parts[1])
        M, N, K = _parse(r"M(\d+)_N(\d+)_K(\d+)", parts[2], cell)
        progs = [matmul_program(M, N, K, bm=bm, bn=bn, bk=bk)
                 for bm, bn, bk in block_shape_candidates(M, N, K)]
        budget = DEFAULT_BUDGET
    elif suite == "flash" and len(parts) == 2:
        hw = get_hw("wormhole_8x8")
        bh, seq = _parse(r"h(\d+)_s(\d+)", parts[1], cell)
        progs = [flash_attention_program(bh, seq, seq, 64, bq=bq, bkv=bkv)
                 for bq in (32, 64, 128) for bkv in (32, 64, 128)]
        budget = FLASH_BUDGET
    elif suite == "reduction" and len(parts) == 3:
        hw = get_hw("wormhole_8x8")
        budget = REDUCTION_BUDGET
        fam = parts[1]
        if fam == "gemm_ts":
            M, N, K = _parse(r"M(\d+)_N(\d+)_K(\d+)", parts[2], cell)
            progs = [matmul_program(M, N, K, bm=bm, bn=bn, bk=bk)
                     for bm in (32, 64) for bn in (32, 64)
                     for bk in (64, 128)]
        elif fam == "flash_decode":
            H, S, D = _parse(r"h(\d+)_kv(\d+)_d(\d+)", parts[2], cell)
            progs = [flash_decode_program(H, S, D, bkv=bkv)
                     for bkv in (32, 64, 128)]
        elif fam == "moe_gmm":
            E, cap, din, dout = _parse(r"e(\d+)_c(\d+)_(\d+)x(\d+)",
                                       parts[2], cell)
            progs = [moe_gmm_program(E, cap, din, dout, bm=bm, bn=64, bk=bk)
                     for bm in (64, 128) for bk in (64, 128)]
        else:
            raise CellError(f"unknown reduction family {fam!r} in {cell!r}")
    else:
        raise CellError(f"unknown kernel cell {cell!r}")
    if workers is not None:
        budget = replace(budget, workers=workers)
    return plan_kernel_multi(progs, hw, budget=budget, cache=cache), hw


def resolve_pipeline_cell(cell: str, *, cache: Any = None,
                          workers: Optional[int] = 1):
    """(graph, co-planned GraphPlan, forwarding-off GraphPlan, hw) for a
    ``pipeline/<family>/...`` cell."""
    from dataclasses import replace
    parts = cell.split("/")
    if len(parts) != 3 or parts[0] != "pipeline":
        raise CellError(f"unknown pipeline cell {cell!r}")
    fam = parts[1]
    if fam == "mlp2":
        M, D, F = _parse(r"M(\d+)_d(\d+)_f(\d+)", parts[2], cell)
        mk = lambda: mlp2_graph(M, D, F, blocks=GEMM_BLOCKS)  # noqa: E731
    elif fam == "attn":
        H, Sq, Skv, Dh = _parse(r"h(\d+)_q(\d+)_kv(\d+)_d(\d+)",
                                parts[2], cell)
        mk = lambda: attn_qk_pv_graph(H, Sq, Skv, Dh,  # noqa: E731
                                      blocks=ATTN_BLOCKS)
    elif fam == "moe_ffn":
        E, C, Dm, Df = _parse(r"e(\d+)_c(\d+)_(\d+)x(\d+)", parts[2], cell)
        mk = lambda: moe_ffn_graph(E, C, Dm, Df,  # noqa: E731
                                   blocks=GEMM_BLOCKS)
    else:
        raise CellError(f"unknown pipeline family {fam!r} in {cell!r}")
    budget = PIPELINE_BUDGET
    if workers is not None:
        budget = replace(budget, workers=workers)
    graph = mk()
    co = plan_pipeline(graph, hw := get_hw("wormhole_8x8"), budget=budget,
                       cache=cache)
    base = plan_pipeline(mk(), hw,
                         budget=replace(budget, pipeline_forwarding=False),
                         cache=cache)
    return graph, co, base, hw


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------
def _bar(frac: float, width: int = 24) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * n + "." * (width - n)


def timeline_lines(plan, hw, record: Optional[List[dict]] = None
                   ) -> List[str]:
    """Wave-class timeline of one plan's simulation (``record`` may be a
    pre-captured ``simulate(..., record=...)`` list to avoid re-running)."""
    if record is None:
        record = []
        simulate(plan, hw, record=record)
    tot = sum(r["population"] * (r["wave_s"] + r["hoist_s"])
              for r in record) or 1.0
    lines = ["wave-class timeline "
             f"({len(record)} classes, {sum(r['population'] for r in record)}"
             " waves):",
             "  cls  pop  cores  wave_us  hoist_us   dram_KB    noc_KB  "
             "share"]
    for i, r in enumerate(record):
        share = r["population"] * (r["wave_s"] + r["hoist_s"]) / tot
        lines.append(
            f"  {i:3d} {r['population']:4d}  {r['n_active']:5d} "
            f"{r['wave_s'] * 1e6:8.2f} {r['hoist_s'] * 1e6:9.2f} "
            f"{r['dram_bytes'] / 1024:9.1f} {r['noc_bytes'] / 1024:9.1f}  "
            f"|{_bar(share)}| {share * 100:5.1f}%")
    return lines


def mesh_heatmap_lines(plan, hw, record: Optional[List[dict]] = None
                       ) -> List[str]:
    """ASCII per-core busy-time heatmap over the mesh (rows = first mesh
    dim, cols = second; 1D meshes render one row)."""
    if record is None:
        record = []
        simulate(plan, hw, record=record)
    coords = _core_coords(plan)
    busy = [0.0] * len(coords)
    for r in record:
        amask, w = r["active_mask"], r["wave_s"] + r["hoist_s"]
        if not amask or w <= 0:
            continue
        for i in range(len(coords)):
            if (amask >> i) & 1:
                busy[i] += r["population"] * w
    mesh = list(hw.mesh_dims)
    ax_r, n_r = mesh[0] if mesh else ("", 1)
    ax_c, n_c = mesh[1] if len(mesh) > 1 else ("", 1)
    grid = [[0.0] * n_c for _ in range(n_r)]
    for c, b in zip(coords, busy):
        grid[c.get(ax_r, 0)][c.get(ax_c, 0)] += b
    peak = max((b for row in grid for b in row), default=0.0)
    lines = [f"mesh utilization ({ax_r or 'core'} x {ax_c or '-'}, "
             f"peak core busy {peak * 1e6:.1f}us, "
             f"ramp '{_RAMP.strip() or _RAMP}'):"]
    for row in grid:
        glyphs = "".join(
            _RAMP[min(len(_RAMP) - 1,
                      int(b / peak * (len(_RAMP) - 1)))] if peak else _RAMP[0]
            for b in row)
        lines.append("  |" + glyphs + "|")
    return lines


def diff_lines(winner, runner, hw) -> List[str]:
    """Winner-vs-runner-up per-resource busy-seconds diff (Candidates)."""
    bw = cost_breakdown(winner.plan, hw)
    br = cost_breakdown(runner.plan, hw)
    lines = [
        "winner vs runner-up:",
        f"  winner    : {winner.plan.describe()}",
        f"  runner-up : {runner.plan.describe()}",
        f"  final_us  : {winner.final_s * 1e6:.2f} vs "
        f"{runner.final_s * 1e6:.2f} "
        f"({(runner.final_s - winner.final_s) * 1e6:+.2f})",
        f"  compute_us: {bw['compute_s'] * 1e6:.2f} vs "
        f"{br['compute_s'] * 1e6:.2f}",
        f"  bound     : {bw['cost'].bound} vs {br['cost'].bound}",
        "  resource        winner_us   runner_us    delta_us",
    ]
    for res in sorted(set(bw["resources"]) | set(br["resources"])):
        w = bw["resources"].get(res, {}).get("busy_s", 0.0)
        r = br["resources"].get(res, {}).get("busy_s", 0.0)
        lines.append(f"  {res:<14} {w * 1e6:11.2f} {r * 1e6:11.2f} "
                     f"{(r - w) * 1e6:+11.2f}")
    return lines


def edge_flip_deltas(graph, hw, plan) -> List[Dict[str, Any]]:
    """Marginal cost of every edge decision of a winning GraphPlan: flip
    each edge in isolation (forward <-> spill), re-simulate the two
    endpoint nodes with the flipped leg set, and report the end-to-end
    delta (positive = the planner's decision is that much faster)."""
    chosen = {name: c.plan for name, c in plan.nodes.items()}
    specs = {}
    for e in graph.edges:
        ek = (e.src, e.dst, e.tensor)
        specs[ek] = forward_spec(graph, e, chosen[e.src], chosen[e.dst], hw)
    fwd_now = {d.key: d.forwarded for d in plan.decisions}
    out = []
    for d in plan.decisions:
        ek = d.key
        row = {"edge": d.describe(), "forwarded": d.forwarded,
               "resident_bytes": d.resident_bytes,
               "shuffle_axes": d.shuffle_axes, "flip_delta_us": None}
        if not d.forwarded and specs.get(ek) is None:
            row["note"] = "no legal forward for the chosen pair"
            out.append(row)
            continue
        flipped = dict(fwd_now)
        flipped[ek] = not d.forwarded
        affected = {d.src, d.dst}
        cur = sum(plan.node_sims[n].total_s for n in affected)
        legs = {n: node_legs(graph, n, specs, flipped) for n in affected}
        sims = simulate_nodes(graph, {n: chosen[n] for n in affected},
                              legs, hw)
        row["flip_delta_us"] = (sims.total_s - cur) * 1e6
        out.append(row)
    return out


def explain_kernel(cell: str, *, cache: Any = None,
                   workers: Optional[int] = 1) -> str:
    res, hw = resolve_kernel_cell(cell, cache=cache, workers=workers)
    best = res.best
    record: List[dict] = []
    sim = simulate(best.plan, hw, record=record)
    lines = [
        f"cell {cell} on {hw.name}",
        f"  best plan : {best.plan.describe()}",
        f"  simulated : {sim.total_s * 1e6:.2f}us "
        f"({sim.tflops:.2f} TFLOP/s, {sim.n_wave_classes}/{sim.n_waves} "
        "wave classes)",
        f"  model     : {best.cost.total_s * 1e6:.2f}us "
        f"(bound={best.cost.bound})",
        f"  search    : {res.n_candidates} candidates, "
        f"{res.n_estimated} estimated, {res.n_pruned} pruned, "
        f"{res.plan_seconds:.2f}s",
        "",
    ]
    lines += timeline_lines(best.plan, hw, record)
    lines.append("")
    lines += mesh_heatmap_lines(best.plan, hw, record)
    if len(res.topk) > 1:
        lines.append("")
        lines += diff_lines(best, res.topk[1], hw)
    return "\n".join(lines)


def explain_pipeline(cell: str, *, cache: Any = None,
                     workers: Optional[int] = 1) -> str:
    graph, co, base, hw = resolve_pipeline_cell(cell, cache=cache,
                                                workers=workers)
    lines = [
        f"cell {cell} on {hw.name} "
        f"({len(graph.nodes)} nodes, {len(graph.edges)} edges)",
        f"  co-planned : {co.total_s * 1e6:.2f}us "
        f"({co.n_forwarded()}/{len(co.decisions)} edges forwarded)",
        f"  independent: {base.total_s * 1e6:.2f}us (every edge spilled)",
        f"  improvement: {co.improvement:.3f}x   "
        f"dram roundtrip {co.dram_roundtrip_s * 1e6:.2f}us",
        "",
        "per-edge decisions (flip delta = end-to-end cost of reversing "
        "just this edge):",
    ]
    for row in edge_flip_deltas(graph, hw, co):
        extra = f"  resident={row['resident_bytes']}B" \
            if row["forwarded"] else ""
        if row["flip_delta_us"] is None:
            lines.append(f"  {row['edge']}{extra}  "
                         f"[{row.get('note', 'n/a')}]")
        else:
            lines.append(f"  {row['edge']}{extra}  "
                         f"flip_delta={row['flip_delta_us']:+.2f}us")
    lines.append("")
    lines.append("per-node edge-adjusted simulations:")
    for name, sim in co.node_sims.items():
        cand = co.nodes[name]
        standalone = cand.sim.total_s if cand.sim else float("nan")
        lines.append(f"  {name:<10} {sim.total_s * 1e6:9.2f}us "
                     f"(standalone {standalone * 1e6:9.2f}us)  "
                     f"{cand.plan.describe()}")
    name0 = next(iter(co.nodes))
    lines.append("")
    lines.append(f"winning node {name0!r} timeline:")
    lines += ["  " + ln for ln in
              timeline_lines(co.nodes[name0].plan, hw)]
    lines += ["  " + ln for ln in
              mesh_heatmap_lines(co.nodes[name0].plan, hw)]
    return "\n".join(lines)


def explain(cell: str, *, cache: Any = None,
            workers: Optional[int] = 1) -> str:
    """Render one benchmark cell (dispatches on the suite prefix)."""
    if cell.startswith("pipeline/"):
        return explain_pipeline(cell, cache=cache, workers=workers)
    return explain_kernel(cell, cache=cache, workers=workers)


def known_cells() -> List[str]:
    """The plan_speed cell names explain can resolve (mirrors the
    benchmark sweep at ``full=False``)."""
    cells: List[str] = []
    for hw_name in ("wormhole_1x8", "wormhole_4x8", "wormhole_8x8"):
        for M in (1024, 4096, 16384):
            for N in (1024, 4096, 16384):
                cells.append(f"gemm/{hw_name}/M{M}_N{N}_K4096")
    for heads in (64, 128):
        for seq in (512, 1024, 2048, 4096, 8192):
            cells.append(f"flash/h{(8192 // seq) * heads}_s{seq}")
    for M, N, K in ((256, 256, 65536), (512, 256, 32768),
                    (256, 1024, 32768), (512, 512, 16384)):
        cells.append(f"reduction/gemm_ts/M{M}_N{N}_K{K}")
    for H, S, D in ((16, 32768, 128), (32, 65536, 64), (8, 131072, 128)):
        cells.append(f"reduction/flash_decode/h{H}_kv{S}_d{D}")
    for E, cap, din, dout in ((8, 128, 16384, 512), (4, 256, 32768, 256)):
        cells.append(f"reduction/moe_gmm/e{E}_c{cap}_{din}x{dout}")
    for M, D, F in ((16384, 128, 512), (32768, 128, 512)):
        cells.append(f"pipeline/mlp2/M{M}_d{D}_f{F}")
    for H, Sq, Skv, Dh in ((8, 4096, 1024, 64), (8, 2048, 2048, 64)):
        cells.append(f"pipeline/attn/h{H}_q{Sq}_kv{Skv}_d{Dh}")
    for E, C, Dm, Df in ((8, 2048, 128, 512), (8, 1024, 128, 512)):
        cells.append(f"pipeline/moe_ffn/e{E}_c{C}_{Dm}x{Df}")
    return cells
