"""Rung 2: shape-family plan reuse with cost-model certification.

A cached neighbor — same kernel template, same hardware, different shape
— usually encodes the right *mapping decisions* (which mesh dims bind
which loop dims, where loads hoist, what broadcasts along which axis)
even when its extents differ.  :func:`retarget_plan` transplants those
decisions onto the requested shape: keep the neighbor's spatial binds,
recompute the residual temporal loops from the new extents, and re-pick
the memory-op combo closest to the neighbor's among the feasible ones.

The transplant is only *served* if it certifies: the wave-class
simulator re-costs it on the requested shape and the result must fall
within ``regret x`` an admissible per-program floor (peak-compute time
vs. aggregate-DRAM time, plus the launch overhead every plan pays).
Any plan's simulated time is at least the floor, so certification
``sim <= regret * floor`` implies ``sim <= regret * exact`` — the
family answer is provably within the regret bound of the plan a full
search would have found, without running that search.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hw import HardwareModel
from repro_torch.core.mapping import Mapping, TemporalLoop
from repro_torch.core.perfmodel import estimate
from repro_torch.core.plan import DataflowPlan
from repro_torch.core.planner import Candidate, PlanResult
from repro_torch.core.program import TileProgram
from repro_torch.core.reuse import memop_choices_with_stores
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.plancache import serialize, warmstart
from repro_torch.plancache.validate import validate_plan

#: Launch overhead every simulated plan pays (simulator.simulate default);
#: folded into the floor so tiny kernels don't fail certification on a
#: constant no plan can avoid.
LAUNCH_OVERHEAD_S = 20e-6


def program_floor(program: TileProgram, hw: HardwareModel) -> float:
    """Admissible lower bound on any plan's simulated time for
    ``program`` on ``hw``: the slower of peak-compute time and the time
    to move each unique tensor through aggregate DRAM bandwidth once,
    plus the launch overhead."""
    compute_s = program.total_flops() / hw.peak_flops()
    unique: Dict[str, int] = {}
    for a in program.loads + program.stores:
        t = a.tensor
        unique[t.name] = math.prod(t.shape) * t.dtype_bytes
    bw = hw.global_mem.bandwidth_gbps * 1e9 * hw.global_channels()
    dram_s = sum(unique.values()) / bw
    return LAUNCH_OVERHEAD_S + max(compute_s, dram_s)


def retarget_plan(entry: Dict[str, Any], programs: Sequence[TileProgram],
                  hw: HardwareModel) -> Optional[DataflowPlan]:
    """Transplant a cached neighbor's plan onto the requested programs.
    Returns None whenever anything about the neighbor doesn't transfer —
    the family rung simply moves to the next neighbor."""
    try:
        nbr = serialize.result_from_dict(entry["payload"]["result"])
    except (KeyError, TypeError, ValueError):
        return None
    meta = entry.get("meta")
    tiles = meta.get("tiles") if isinstance(meta, dict) else None
    ordered = warmstart.order_programs(list(programs), tiles)
    if not ordered:
        return None
    prog = ordered[0]
    nmap = nbr.best.plan.mapping

    mesh = dict(hw.mesh_dims)
    grid = {d.name: d.extent for d in prog.grid_dims}
    seq = {d.name: d.extent for d in prog.seq_dims}
    binds = []
    for b in nmap.spatial:
        if b.hw_dim not in mesh or not 1 <= b.hw_size <= mesh[b.hw_dim]:
            return None
        if b.reduce:
            # a split reduction only pays when the requested reduction is
            # at least as deep as the split; otherwise drop the bind
            if seq.get(b.grid_dim, 0) >= b.hw_size:
                binds.append(b)
        else:
            if b.grid_dim not in grid:
                return None
            binds.append(b)
    if not any(not b.reduce for b in binds):
        return None
    reduce_style = nmap.reduce_style if any(b.reduce for b in binds) else ""

    factor: Dict[str, int] = {}
    for b in binds:
        if not b.reduce:
            factor[b.grid_dim] = factor.get(b.grid_dim, 1) * b.hw_size
    temporal = []
    for d in prog.grid_dims:
        ext = -(-d.extent // factor.get(d.name, 1))
        if ext > 1:
            temporal.append(TemporalLoop(f"t_{d.name}", d.name, ext))
    mapping = Mapping(prog, hw.name, hw.mesh_dims, tuple(binds),
                      tuple(temporal), reduce_style)
    if mapping.conflicts_with_faults(hw):
        return None
    try:
        combos, stores = memop_choices_with_stores(mapping, hw,
                                                   max_per_load=8)
    except (RuntimeError, ValueError):
        return None
    if not combos:
        return None

    # re-pick the combo closest to the neighbor's realized choices
    want = {c.access.tensor.name: (tuple(c.bcast_axes), c.hoist.level)
            for c in nbr.best.plan.loads}

    def match(combo) -> int:
        s = 0
        for c in combo:
            w = want.get(c.access.tensor.name)
            if w is None:
                continue
            if tuple(c.bcast_axes) == w[0]:
                s += 2
            if c.hoist.level == w[1]:
                s += 1
        return s

    best = max(combos, key=match)      # ties: first in stream order
    plan = DataflowPlan(mapping, best, stores)
    if validate_plan(plan, hw):
        return None
    return plan


def certify_plan(plan: DataflowPlan, hw: HardwareModel,
                 regret: float) -> Tuple[bool, SimResult, float]:
    """Simulate the transplanted plan on the requested shape and accept
    it only within ``regret x`` the admissible floor."""
    sim = simulate(plan, hw)
    floor = program_floor(plan.program, hw)
    return sim.total_s <= regret * max(floor, 1e-12), sim, floor


def certified_result(entry: Dict[str, Any],
                     programs: Sequence[TileProgram],
                     hw: HardwareModel, *,
                     regret: float) -> Optional[PlanResult]:
    """retarget + validate + certify, packaged as a PlanResult the
    service can return (or None when the neighbor doesn't transfer)."""
    t0 = time.perf_counter()
    plan = retarget_plan(entry, programs, hw)
    if plan is None:
        return None
    ok, sim, floor = certify_plan(plan, hw, regret)
    if not ok:
        return None
    cost = estimate(plan, hw)
    cand = Candidate(plan=plan, cost=cost, sim=sim, index=(0, 0, 0))
    log: List[str] = [
        f"family: certified sim {sim.total_s * 1e6:.1f}us <= "
        f"{regret:g}x floor {floor * 1e6:.1f}us "
        f"(neighbor {entry.get('key', '?')[:12]})"]
    return PlanResult(kernel=plan.program.name, hw_name=hw.name, best=cand,
                      topk=[cand], n_candidates=1, n_mappings=1,
                      plan_seconds=time.perf_counter() - t0, log=log)
