"""Elastic re-planning for degraded meshes (DESIGN_FAULTS.md).

The TileLoom thesis, applied to failure: a mapping is a compiled decision
over an explicit hardware representation, so losing a core or a link means
the *hardware changed* — the answer is a new plan for the surviving fabric,
found fast.  This module wires failure detection
(:class:`~repro_torch.runtime.fault_tolerance.HeartbeatRegistry` /
:class:`StragglerTracker`) to the planner through a **degradation ladder**
with an explicit re-plan latency budget:

1. **cache hit** — the degraded fabric has its own plan-cache key
   (``HardwareModel.with_faults`` participates in ``df_text()``), so a
   pre-warmed fault pool (``python -m repro_torch.plancache warm --faults``)
   answers a single-core failure with zero search;
2. **warm-started bounded search** — on a miss, candidate block shapes are
   re-ordered around the nearest *healthy-mesh* cached plan of the same
   template (the degraded digest has no neighbors yet), then searched
   under a trimmed budget on the degraded model — which enumerates only
   mappings that route around the dead cores;
3. **rectangular-submesh fallback** — guaranteed feasible: drop the mesh
   rows/columns containing dead cores along the axis that keeps the most
   cores and plan the clean smaller mesh.  The submesh plan also serves as
   a quality floor: whichever of rung 2/3 simulates faster is kept (one
   dead core on an 8x8 costs ~8/7 on the submesh, far better than the
   hole-avoiding full-mesh mappings).

Every re-plan emits ``replan_total{cause,rung}`` and ``replan_seconds``
through the PR 6 observability layer.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.hw import HardwareModel, Interconnect, SpatialDim, _ring_map
from repro_torch.core.planner import (PlanResult, SearchBudget, effective_budget,
                                plan_kernel_multi)
from repro_torch.core.program import TileProgram
from repro_torch.obs import context, flightrec, metrics, trace

RUNGS = ("cache_hit", "warm_search", "bounded_search", "submesh_fallback")

#: Default trimmed budget for the in-incident bounded search (rung 2/3).
#: Deliberately smaller than the AOT warm budget: an online re-plan trades
#: a little plan quality for seconds of downtime.
REPLAN_BUDGET = SearchBudget(top_k=3, max_mappings=64,
                             max_plans_per_mapping=24, max_candidates=2000,
                             max_programs=8)


@dataclass
class ReplanOutcome:
    """One completed trip down the degradation ladder."""
    cause: str                  # core_kill | link_slow | straggler | manual
    rung: str                   # member of RUNGS: where the plan came from
    result: PlanResult
    hw: HardwareModel           # the model the chosen plan targets
    seconds: float
    within_budget: bool
    log: List[str] = field(default_factory=list)

    @property
    def plan(self):
        return self.result.best.plan


# --------------------------------------------------------------------------
# Rectangular-submesh fallback
# --------------------------------------------------------------------------
def _shrink_axis(hw: HardwareModel, axis: str, new_size: int,
                 dropped: Sequence[int]) -> HardwareModel:
    """A logical submesh of ``hw`` with ``axis`` shrunk to ``new_size``
    (the planes listed in ``dropped`` removed and survivors renumbered).

    Ring interconnects along the shrunk axis are rebuilt with the new
    modulus; the DRAM channel map is kept and evaluated at the renumbered
    coordinates (a documented approximation: survivors that change
    channel groups keep their old attribution).  The overlay is cleared —
    the submesh is healthy by construction.
    """
    dims = tuple(SpatialDim(d.name, new_size) if d.name == axis else d
                 for d in hw.spatial_dims)
    mesh = tuple((n, new_size if n == axis else s)
                 for n, s in hw.mesh_dims)
    ics = []
    for ic in hw.interconnects:
        if ic.axis(hw.core.scaleout) == axis:
            moved = next(e for e in ic.map.exprs
                         if not (e.coeffs == ((axis, 1),) and e.const == 0
                                 and e.mod is None and e.floordiv is None)
                         ) if ic.map.exprs else None
            stride = moved.const if moved is not None else 1
            ics.append(Interconnect(ic.name, ic.src, ic.dst,
                                    _ring_map(list(mesh), axis, stride),
                                    ic.bandwidth_gbps))
        else:
            ics.append(ic)
    note = (f"submesh of {hw.name}: {axis} planes {sorted(dropped)} "
            f"dropped ({new_size} survive)")
    return dataclasses.replace(
        hw, name=f"{hw.name}_sub_{axis}{new_size}", spatial_dims=dims,
        interconnects=tuple(ics), disabled_cores=(), degraded_links=(),
        notes=(hw.notes + "; " if hw.notes else "") + note)


def best_submesh(hw: HardwareModel) -> HardwareModel:
    """The largest healthy logical submesh of a degraded mesh.

    Each disabled core must sit on a dropped plane of *some* axis; the
    search assigns every fault to an axis and keeps the assignment whose
    combined cut preserves the most cores.  Single-axis assignments (all
    faults cut along one axis — the historical behavior) are tried first,
    so single-core failures and any case where one axis is optimal stay
    bit-identical (golden-gated); mixed assignments win only strictly.
    Two faults at (1, 2) and (5, 6) on an 8x8 used to cost two rows
    (48 cores left); dropping one row *and* one column keeps 7x7 = 49.

    Guaranteed feasible when any assignment leaves every axis at least
    one plane; the combo enumeration is capped (pure assignments only)
    for pathological fault counts.
    """
    if not hw.disabled_cores:
        return hw
    mesh = hw.mesh_dims
    faults = list(hw.disabled_cores)
    n_axes = len(mesh)

    def cut_of(assign: Tuple[int, ...]):
        """(remaining cores, per-axis dropped-plane sets) or None when the
        assignment empties an axis."""
        dropped: List[set] = [set() for _ in mesh]
        for f, a in zip(faults, assign):
            dropped[a].add(f[a])
        remaining = 1
        for i, (_, size) in enumerate(mesh):
            keep = size - len(dropped[i])
            if keep < 1:
                return None
            remaining *= keep
        return remaining, dropped

    candidates: List[Tuple[int, ...]] = [(i,) * len(faults)
                                         for i in range(n_axes)]
    if n_axes > 1 and len(faults) > 1 and n_axes ** len(faults) <= 256:
        candidates += [a for a in
                       itertools.product(range(n_axes), repeat=len(faults))
                       if len(set(a)) > 1]
    best: Optional[Tuple[int, List[set]]] = None
    for assign in candidates:
        cut = cut_of(assign)
        if cut is not None and (best is None or cut[0] > best[0]):
            best = cut
    if best is None:
        raise RuntimeError(f"no healthy submesh of {hw.name}: faults cover "
                           f"every plane of every axis")
    sub = hw
    for i, (axis, size) in enumerate(mesh):
        bad = sorted(best[1][i])
        if bad:
            sub = _shrink_axis(sub, axis, size - len(bad), bad)
    return sub


# --------------------------------------------------------------------------
# The degradation ladder
# --------------------------------------------------------------------------
def plan_degraded(programs: Sequence[TileProgram], hw: HardwareModel, *,
                  healthy_hw: Optional[HardwareModel] = None,
                  cache: Optional[Any] = None,
                  budget: Optional[SearchBudget] = None,
                  latency_budget_s: Optional[float] = 30.0,
                  cause: str = "manual",
                  compare_submesh: bool = True) -> ReplanOutcome:
    """Find the plan to run on the degraded fabric ``hw``, fast.

    Walks the ladder described in the module docstring.  ``healthy_hw``
    (default: ``hw`` sans overlay is unavailable, so pass the original
    model) seeds the warm-start ordering; ``latency_budget_s`` bounds the
    in-incident search — once exceeded, remaining search rungs are skipped
    in favor of the guaranteed submesh fallback (None = no deadline).
    The chosen result is published to ``cache`` under the *degraded* key,
    so the next identical failure is a rung-1 hit.
    """
    if not hw.is_degraded:
        raise ValueError("plan_degraded requires a fault overlay; plan the "
                         "healthy model with plan_kernel_multi")
    t0 = time.perf_counter()
    budget = effective_budget(budget if budget is not None
                              else replace(REPLAN_BUDGET))
    programs = list(programs)
    log: List[str] = []

    def _finish(rung: str, result: PlanResult,
                target: HardwareModel) -> ReplanOutcome:
        secs = time.perf_counter() - t0
        within = latency_budget_s is None or secs <= latency_budget_s
        metrics.inc("replan_total", cause=cause, rung=rung)
        metrics.observe("replan_seconds", secs, cause=cause)
        if not within:
            metrics.inc("replan_budget_exceeded_total", cause=cause)
        flightrec.record("replan", cause=cause, rung=rung, seconds=secs,
                         within_budget=within, hw=target.name, log=log)
        return ReplanOutcome(cause=cause, rung=rung, result=result,
                             hw=target, seconds=secs, within_budget=within,
                             log=log)

    # correlate("replan") reuses an enclosing incident/plan ID, so a
    # ladder trip nested under a fault event stays on the incident's
    # timeline; a direct plan_degraded call gets its own replan-* ID
    with context.correlate("replan"), \
         trace.span("replan.ladder", cat="replan", cause=cause,
                    hw=hw.name, n_faults=len(hw.disabled_cores)
                    + len(hw.degraded_links)):
        # ---- rung 1: exact degraded-key cache hit -------------------------
        if cache is not None:
            hit = cache.get_result(programs, hw, budget, profile=True,
                                   spatial_reuse=True, temporal_reuse=True)
            if hit is not None:
                log.append("rung 1: degraded-key cache hit (zero search)")
                return _finish("cache_hit", hit, hw)

        # ---- rung 2: warm-start ordering from the healthy mesh ------------
        ordered = programs
        warmed = False
        if cache is not None and programs:
            from repro_torch.plancache import keying, warmstart
            seed_hw = healthy_hw if healthy_hw is not None else hw
            before = cache.store.stats.warm_starts
            ordered = warmstart.warm_order_from_store(
                cache.store, keying.template_signature(programs[0]),
                keying.hw_digest(seed_hw), keying.shape_vector(programs[0]),
                programs)
            warmed = cache.store.stats.warm_starts > before
            if warmed:
                log.append("rung 2: warm-start ordering from healthy-mesh "
                           "neighbor")

        # ---- rung 2/3: bounded search on the degraded model ---------------
        searched: Optional[PlanResult] = None
        deadline_hit = (latency_budget_s is not None
                        and time.perf_counter() - t0 > 0.5 * latency_budget_s)
        if deadline_hit:
            log.append("latency budget half-spent before search; skipping "
                       "to submesh fallback")
        else:
            try:
                searched = plan_kernel_multi(ordered, hw, budget=budget,
                                             profile=True)
                log.append(f"rung {'2' if warmed else '3'}: degraded-mesh "
                           f"search best {searched.best.final_s * 1e6:.1f}us")
            except (RuntimeError, ValueError) as e:
                log.append(f"degraded-mesh search infeasible: {e}")

        # ---- rung 4: rectangular-submesh fallback / quality floor ---------
        sub_result: Optional[PlanResult] = None
        sub_hw: Optional[HardwareModel] = None
        need_sub = searched is None or (compare_submesh
                                        and bool(hw.disabled_cores))
        if need_sub and hw.disabled_cores:
            sub_hw = best_submesh(hw)
            sub_result = plan_kernel_multi(programs, sub_hw, budget=budget,
                                           profile=True)
            log.append(f"rung 4: submesh {sub_hw.name} best "
                       f"{sub_result.best.final_s * 1e6:.1f}us")
        if searched is None and sub_result is None:
            raise RuntimeError(
                f"no feasible plan on {hw.name} (degraded search failed and "
                f"no disabled cores to cut a submesh around)")

        if sub_result is not None and (
                searched is None
                or sub_result.best.final_s < searched.best.final_s):
            rung, result, target = "submesh_fallback", sub_result, sub_hw
        else:
            rung = "warm_search" if warmed else "bounded_search"
            result, target = searched, hw

        if cache is not None:
            # published under the degraded key: the next identical failure
            # (or a pre-warmed pool) answers at rung 1 with zero search
            cache.put_result(programs, hw, budget, result, profile=True,
                             spatial_reuse=True, temporal_reuse=True)
        return _finish(rung, result, target)


# --------------------------------------------------------------------------
# Detection -> re-plan orchestration
# --------------------------------------------------------------------------
class ReplanOrchestrator:
    """Polls failure detection and walks the ladder when the fabric shrinks.

    ``host_cores`` maps heartbeat host ids to the mesh cores they drive
    (coords in ``hw.core.scaleout`` order).  A dead host kills its cores; a
    flagged straggler is treated the same way (hot-swap policy: route work
    off the slow host, reclaim on the next full re-plan).  Link faults come
    in through :meth:`degrade_links` (switch counters / SDN telemetry in a
    real deployment, :mod:`repro_torch.runtime.faults` schedules in tests).
    """

    def __init__(self, hw: HardwareModel, programs: Sequence[TileProgram], *,
                 registry=None, tracker=None,
                 host_cores: Optional[Mapping[int, Sequence[Tuple[int, ...]]]]
                 = None,
                 cache: Optional[Any] = None,
                 budget: Optional[SearchBudget] = None,
                 latency_budget_s: Optional[float] = 30.0,
                 service: Optional[Any] = None,
                 tenancy: Optional[Any] = None) -> None:
        self.healthy_hw = hw
        self.current_hw = hw
        self.programs = list(programs)
        self.registry = registry
        self.tracker = tracker
        self.host_cores = dict(host_cores or {})
        self.cache = cache
        self.budget = budget
        self.latency_budget_s = latency_budget_s
        # a subscribed PlanService: fault events invalidate its breaker /
        # search-time state so degraded-key requests walk a fresh ladder
        self.service = service
        # a multi-tenant runtime (repro_torch.tenancy.TenantRuntime): fault
        # events route through its contained per-partition ladder instead
        # of re-planning the whole fabric, and the orchestrator's methods
        # return its ContainedReplan events
        self.tenancy = tenancy
        self.outcomes: List[ReplanOutcome] = []
        self._handled_hosts: set = set()

    # ------------------------------------------------------------ faults
    def kill_cores(self, cores: Sequence[Tuple[int, ...]],
                   cause: str = "core_kill") -> Any:
        # one incident ID spans the fault event and every nested re-plan
        # (the tenancy path records its own fault/containment events)
        with context.correlate("incident"):
            if self.tenancy is not None:
                ev = None
                for c in cores:
                    ev = self.tenancy.kill_core(c)
                self.current_hw = self.tenancy.hw
                return ev
            flightrec.record("fault", cause=cause, cores=list(cores))
            self.current_hw = self.current_hw.with_faults(
                disabled_cores=cores)
            return self._replan(cause)

    def degrade_links(self, links: Sequence[Tuple[str, float]],
                      cause: str = "link_slow") -> Any:
        with context.correlate("incident"):
            if self.tenancy is not None:
                ev = None
                for name, factor in links:
                    ev = self.tenancy.slow_link(name, factor)
                self.current_hw = self.tenancy.hw
                return ev
            flightrec.record("fault", cause=cause, links=list(links))
            self.current_hw = self.current_hw.with_faults(
                degraded_links=links)
            return self._replan(cause)

    def poll(self, now: Optional[float] = None) -> Optional[ReplanOutcome]:
        """One detection sweep: declare dead/straggling hosts' cores
        disabled and re-plan.  Returns the outcome when the fabric changed,
        None when everything is healthy (no planner work at all)."""
        dead: List[Tuple[int, str]] = []
        if self.registry is not None:
            dead += [(h, "core_kill") for h in self.registry.dead_hosts(now)]
        if self.tracker is not None:
            dead += [(h, "straggler") for h in self.tracker.stragglers()]
        cores: List[Tuple[int, ...]] = []
        cause = "core_kill"
        for host, why in dead:
            if host in self._handled_hosts:
                continue
            self._handled_hosts.add(host)
            mapped = self.host_cores.get(host, ())
            if mapped:
                cores.extend(tuple(c) for c in mapped)
                cause = why
        new = [c for c in cores
               if tuple(c) not in self.current_hw.disabled_core_set()]
        if not new:
            return None
        return self.kill_cores(new, cause=cause)

    # ------------------------------------------------------------ ladder
    def _replan(self, cause: str) -> ReplanOutcome:
        out = plan_degraded(self.programs, self.current_hw,
                            healthy_hw=self.healthy_hw, cache=self.cache,
                            budget=self.budget,
                            latency_budget_s=self.latency_budget_s,
                            cause=cause)
        self.outcomes.append(out)
        if self.service is not None:
            self.service.note_fault(out)
        return out
