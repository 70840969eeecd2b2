"""Rung 4: the guaranteed generic fallback plan.

When the deadline expires (or every other rung declined), the service
still owes the caller a runnable plan.  This module builds one without
searching: take the smallest-footprint candidate program, bind it with
the natural 2D output-stationary mapping (or the flattened 1D one when
the program/mesh is not 2D), pick the first capacity-feasible memory-op
combo, and cost it.  Quality is explicitly *not* the goal — validity and
O(1) construction time are; background completion replaces the answer
with a searched plan off the request path.

On a degraded fabric the fallback targets the largest healthy
rectangular submesh (``runtime/replan.best_submesh``), the same floor
PR 7's ladder bottoms out on.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

from repro_torch.core.hw import HardwareModel
from repro_torch.core.perfmodel import estimate
from repro_torch.core.plan import DataflowPlan
from repro_torch.core.planner import Candidate, PlanResult
from repro_torch.core.program import TileProgram
from repro_torch.core.reuse import memop_choices_with_stores
from repro_torch.core.simulator import simulate
from repro_torch.core.templates import _mapping_1d, _mapping_2d
from repro_torch.plancache.validate import validate_plan


def _footprint(prog: TileProgram) -> int:
    """Double-buffered load tiles + accumulators: the residency the plan
    will need, so ascending order tries the most-likely-feasible first."""
    return sum(2 * a.tile_bytes for a in prog.loads) + \
        prog.accumulator_bytes()


def generic_fallback_plan(programs: Sequence[TileProgram],
                          hw: HardwareModel
                          ) -> Tuple[PlanResult, HardwareModel]:
    """Build the guaranteed plan.  Raises ``RuntimeError`` only when *no*
    candidate program fits the hardware at all (a genuinely infeasible
    request — the service reports it instead of inventing a plan)."""
    t0 = time.perf_counter()
    target = hw
    if hw.is_degraded and hw.disabled_cores:
        try:
            from repro_torch.runtime.replan import best_submesh
            target = best_submesh(hw)
        except RuntimeError:
            target = hw              # no clean cut: try routing around holes
    log: List[str] = []
    for prog in sorted(programs, key=_footprint):
        if len(prog.grid_dims) >= 2 and len(target.mesh_dims) >= 2:
            mapping = _mapping_2d(prog, target)
        else:
            flat = max(prog.grid_dims, key=lambda d: d.extent).name
            mapping = _mapping_1d(prog, target, flat)
        if mapping.conflicts_with_faults(target):
            log.append(f"{prog.name}: mapping lands on disabled cores")
            continue
        try:
            combos, stores = memop_choices_with_stores(
                mapping, target, max_per_load=2, max_plans=1)
        except (RuntimeError, ValueError) as e:
            log.append(f"{prog.name}: {e}")
            continue
        if not combos:
            log.append(f"{prog.name}: no feasible memory-op combo")
            continue
        plan = DataflowPlan(mapping, combos[0], stores)
        bad = validate_plan(plan, target)
        if bad:
            log.append(f"{prog.name}: {'; '.join(bad)}")
            continue
        cost = estimate(plan, target)
        sim = simulate(plan, target)
        cand = Candidate(plan=plan, cost=cost, sim=sim, index=(0, 0, 0))
        log.append("generic_fallback")
        return PlanResult(
            kernel=prog.name, hw_name=target.name, best=cand, topk=[cand],
            n_candidates=1, n_mappings=1,
            plan_seconds=time.perf_counter() - t0, log=log), target
    raise RuntimeError(
        f"no generic fallback on {target.name}: "
        + ("; ".join(log) if log else "no candidate programs"))
