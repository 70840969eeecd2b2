"""Contained re-planning: the per-partition degradation ladder.

The containment invariant this module enforces (and the property tests
state): **a fault re-plans only the tenant that owns the faulted cell** —
every other tenant's plan stays byte-identical (same
:func:`~repro_torch.tenancy.partition.plan_digest`).  Ownership is rect
membership: a ``core_kill`` at global coords, or a ``link_slow`` localized
by an ``at=`` coordinate, belongs to exactly one partition (or to the free
/spare region, in which case *no* tenant re-plans at all).

The owning tenant walks a three-rung ladder, strictly widening the blast
radius only when the previous rung cannot deliver:

* ``shrink_in_place``  — PR 7's :func:`~repro_torch.runtime.replan.plan_degraded`
  on the tenant's own submesh with the fault as a *local* overlay (warmed
  partition fault pools answer at its rung 1 with zero search);
* ``claim_adjacent``   — grow the rect one plane into all-free adjacent
  cells (the :class:`MeshPartitioner`'s ``spare_planes`` strip exists for
  this) and plan the expanded, still-degraded submesh; taken when
  shrinking is infeasible or costs more than ``claim_threshold``x the
  pre-fault time;
* ``repartition``      — the last resort with a deliberately bounded
  disruption contract: the full joint search re-runs for **guaranteed**
  tenants only, while best-effort tenants are evicted to the service's
  fallback rung (deadline 0 walks straight to the memoized generic plan).
  Never the other way around.

Every event emits ``tenancy_replan_total{tenant,rung}`` and a
``tenancy_blast_radius`` observation (number of tenants whose plan
changed), so containment is a measured property, not a comment.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hw import HardwareModel
from repro_torch.core.planner import SearchBudget
from repro_torch.obs import context, flightrec, metrics, slo, trace
from repro_torch.runtime.faults import FaultSpec
from repro_torch.runtime.replan import plan_degraded

from .partition import (MeshPartitioner, Rect, TenancyPlan, TenantPlacement,
                        submesh)
from .validator import IsolationValidator

TENANCY_RUNGS = ("none", "shrink_in_place", "claim_adjacent", "repartition")


@dataclass
class ContainedReplan:
    """One handled fault event, with the evidence for containment."""
    cause: str                       # core_kill | link_slow
    owner: Optional[str]             # owning tenant; None = free/spare cell
    rung: str                        # member of TENANCY_RUNGS
    replanned: Tuple[str, ...]       # tenants whose plan changed
    blast_radius: int                # == len(replanned)
    seconds: float
    within_budget: bool
    digests_before: Dict[str, str]
    digests_after: Dict[str, str]
    log: List[str] = field(default_factory=list)

    @property
    def untouched(self) -> Tuple[str, ...]:
        return tuple(t for t in self.digests_before
                     if t not in self.replanned)

    def contained(self) -> bool:
        """True iff every non-replanned tenant's plan digest is unchanged
        — the invariant, checked on the actual bytes."""
        return all(self.digests_after.get(t) == d
                   for t, d in self.digests_before.items()
                   if t not in self.replanned)


class TenantRuntime:
    """Owns a live :class:`TenancyPlan` and applies fault events to it
    with contained blast radius.

    ``latency_budget_s`` bounds each owning tenant's trip down the
    ladder (None: ``REPRO_PLAN_DEADLINE_MS``, the same deadline the plan
    service answers under — with warmed partition fault pools the
    shrink-in-place rung is a cache hit and meets even the 10 ms
    default); ``claim_threshold`` is the shrink-vs-claim quality bar
    (shrinking that costs more than this factor over the pre-fault time
    escalates to claiming adjacent free cells).
    """

    def __init__(self, plan: TenancyPlan, *, service: Any,
                 cache: Optional[Any] = None,
                 budget: Optional[SearchBudget] = None,
                 partitioner: Optional[MeshPartitioner] = None,
                 validator: Optional[IsolationValidator] = None,
                 latency_budget_s: Optional[float] = None,
                 claim_threshold: float = 2.0) -> None:
        self.plan = plan
        self.service = service
        self.cache = cache if cache is not None \
            else getattr(service, "cache", None)
        self.budget = budget
        self.partitioner = partitioner if partitioner is not None \
            else MeshPartitioner()
        self.validator = validator if validator is not None \
            else IsolationValidator()
        if latency_budget_s is None:
            from repro_torch.planservice.service import default_deadline_ms
            latency_budget_s = default_deadline_ms() / 1e3
        self.latency_budget_s = latency_budget_s
        self.claim_threshold = claim_threshold
        # current fabric with the cumulative fault overlay (global coords);
        # submesh() restricts + renumbers it per partition
        self.hw = plan.hw
        # pre-fault submesh per tenant: the warm-start seed for the ladder
        self._healthy_sub: Dict[str, HardwareModel] = {
            p.tenant.name: p.hw for p in plan.placements}
        self.events: List[ContainedReplan] = []

    # ----------------------------------------------------------- fault API
    def inject(self, fault: FaultSpec,
               at: Optional[Sequence[int]] = None) -> ContainedReplan:
        """Apply one :class:`FaultSpec`.  ``at`` localizes a ``link_slow``
        to the partition owning that core coordinate (switch telemetry
        names the failing port; its coords are the localization a real
        deployment has)."""
        if fault.kind == "core_kill":
            return self.kill_core(fault.core)
        if fault.kind == "link_slow":
            return self.slow_link(fault.link, fault.factor, at=at)
        raise ValueError(f"tenancy runtime handles hardware faults only, "
                         f"not {fault.kind!r}")

    def kill_core(self, core: Sequence[int]) -> ContainedReplan:
        core = tuple(int(v) for v in core)
        # one incident ID covers the fault, the owning tenant's ladder
        # trip, and every plan-service resolve nested under it
        with context.correlate("incident"):
            flightrec.record("fault", cause="core_kill", cell=core,
                             hw=self.hw.name)
            self.hw = self.hw.with_faults(disabled_cores=[core])
            owner = self.plan.owner_of(core)
            return self._handle("core_kill", owner, faulted_cell=core)

    def slow_link(self, link: str, factor: float,
                  at: Optional[Sequence[int]] = None) -> ContainedReplan:
        with context.correlate("incident"):
            flightrec.record("fault", cause="link_slow", link=link,
                             factor=factor,
                             cell=tuple(at) if at is not None else None,
                             hw=self.hw.name)
            if at is not None:
                at = tuple(int(v) for v in at)
                owner = self.plan.owner_of(at)
                if owner is not None:
                    # physically the links inside a partition are disjoint
                    # from every other partition's, even though the model
                    # names them once per fabric: degrade the owner's
                    # submesh only, and leave the global model untouched
                    return self._handle("link_slow", owner, faulted_cell=at,
                                        link=(link, factor))
                # fell on a free/spare cell: record on the fabric so future
                # repartitions see it, but nobody re-plans
                self.hw = self._degrade_global(link, factor)
                return self._handle("link_slow", None, faulted_cell=at)
            # unlocalized: the honest blast radius is every tenant
            self.hw = self._degrade_global(link, factor)
            return self._handle_global_link()

    def _degrade_global(self, link: str, factor: float) -> HardwareModel:
        try:
            return self.hw.with_faults(degraded_links=[(link, factor)])
        except ValueError:               # axis not present on this fabric
            return self.hw

    # ------------------------------------------------------------- ladder
    def _handle(self, cause: str, owner: Optional[TenantPlacement], *,
                faulted_cell: Tuple[int, ...],
                link: Optional[Tuple[str, float]] = None) -> ContainedReplan:
        t0 = time.perf_counter()
        before = self.plan.digests()
        metrics.inc("tenancy_fault_events_total", cause=cause)
        log: List[str] = []
        if owner is None:
            log.append(f"{cause} at {faulted_cell}: free/spare cell, "
                       f"no tenant affected")
            return self._finish(cause, None, "none", (), t0, before, log)

        name = owner.tenant.name
        log.append(f"{cause} at {faulted_cell}: owned by {name} "
                   f"({owner.rect.describe()})")
        with trace.span("tenancy.contain", cat="tenancy", cause=cause,
                        tenant=name):
            pre_fault_s = owner.sim_s
            rung, outcome, new_rect, new_hw = self._contain(
                owner, faulted_cell, link, pre_fault_s, log)
            if rung == "repartition":
                return self._repartition(cause, name, t0, before, log)
            owner.rect = new_rect
            owner.hw = new_hw
            owner.response = outcome
            owner.rung = f"tenancy:{rung}"
            bad = self.validator.validate(self.plan)
            if bad:
                log.append(f"isolation validation failed after {rung}: "
                           f"{bad}; escalating to repartition")
                return self._repartition(cause, name, t0, before, log)
            if self.service is not None and hasattr(self.service,
                                                    "note_fault"):
                self.service.note_fault(outcome)
            return self._finish(cause, name, rung, (name,), t0, before, log,
                                within=outcome.within_budget)

    def _contain(self, owner: TenantPlacement,
                 cell: Tuple[int, ...], link: Optional[Tuple[str, float]],
                 pre_fault_s: float, log: List[str]):
        """Rungs 1-2 for the owning tenant.  Returns
        (rung, outcome, rect, hw) or ("repartition", None, None, None)."""
        name = owner.tenant.name
        healthy = self._healthy_sub[name]
        programs = list(owner.tenant.programs)

        def degraded_sub(rect: Rect) -> HardwareModel:
            sub = submesh(self.hw, rect.origin, rect.shape)
            if link is not None:
                try:
                    sub = sub.with_faults(degraded_links=[link])
                except ValueError:
                    pass                 # link's axis collapsed away
            return sub

        # ---- rung 1: shrink in place ---------------------------------
        shrink = None
        try:
            sub = degraded_sub(owner.rect)
            if not sub.is_degraded:
                log.append("fault vanished inside the partition model; "
                           "keeping the current plan")
                return "none", owner.response, owner.rect, owner.hw
            shrink = plan_degraded(
                programs, sub, healthy_hw=healthy, cache=self.cache,
                budget=self.budget, latency_budget_s=self.latency_budget_s,
                cause=f"tenancy_{name}")
            log.append(f"shrink_in_place: {shrink.rung} "
                       f"{shrink.result.best.final_s * 1e6:.1f}us "
                       f"(pre-fault {pre_fault_s * 1e6:.1f}us)")
        except (RuntimeError, ValueError) as e:
            log.append(f"shrink_in_place infeasible: {e}")

        good_enough = (shrink is not None
                       and shrink.result.best.final_s
                       <= self.claim_threshold * pre_fault_s)
        if good_enough:
            return "shrink_in_place", shrink, owner.rect, shrink.hw

        # ---- rung 2: claim adjacent free cells -----------------------
        grown = self._claim_adjacent(owner, degraded_sub, programs,
                                     healthy, log)
        if grown is not None:
            rect, outcome = grown
            if (shrink is None or outcome.result.best.final_s
                    < shrink.result.best.final_s):
                return "claim_adjacent", outcome, rect, outcome.hw
        if shrink is not None:           # degraded but alive beats nothing
            return "shrink_in_place", shrink, owner.rect, shrink.hw
        return "repartition", None, None, None

    def _claim_adjacent(self, owner: TenantPlacement, degraded_sub,
                        programs, healthy, log: List[str]
                        ) -> Optional[Tuple[Rect, Any]]:
        free = self.plan.free_cells()
        sizes = [s for _, s in self.hw.mesh_dims]
        for axis in range(len(sizes)):
            for direction in (1, -1):
                try:
                    rect = owner.rect.expanded(axis, direction)
                except ValueError:
                    continue             # expansion walks off the mesh edge
                if not rect.within(sizes):
                    continue
                gained = set(rect.cells()) - set(owner.rect.cells())
                if not gained or not gained <= free:
                    continue
                try:
                    sub = degraded_sub(rect)
                    if not sub.is_degraded:
                        continue         # plan_degraded needs the overlay
                    out = plan_degraded(
                        programs, sub, healthy_hw=healthy,
                        cache=self.cache, budget=self.budget,
                        latency_budget_s=self.latency_budget_s,
                        cause=f"tenancy_{owner.tenant.name}")
                    log.append(
                        f"claim_adjacent: grew to {rect.describe()}, "
                        f"{out.rung} {out.result.best.final_s * 1e6:.1f}us")
                    return rect, out
                except (RuntimeError, ValueError) as e:
                    log.append(f"claim_adjacent {rect.describe()} "
                               f"infeasible: {e}")
        return None

    # ------------------------------------------- global-blast-radius paths
    def _handle_global_link(self) -> ContainedReplan:
        """An unlocalized link_slow degrades the shared fabric model: the
        honest answer is that every tenant re-plans in place (each on its
        own submesh, still inside its own rect — partitions don't move)."""
        t0 = time.perf_counter()
        before = self.plan.digests()
        metrics.inc("tenancy_fault_events_total", cause="link_slow")
        log: List[str] = ["unlocalized link_slow: all tenants re-plan "
                          "in place"]
        replanned: List[str] = []
        within = True
        for p in self.plan.placements:
            name = p.tenant.name
            sub = submesh(self.hw, p.rect.origin, p.rect.shape)
            if not sub.is_degraded:
                continue                 # link didn't survive into this rect
            out = plan_degraded(
                list(p.tenant.programs), sub,
                healthy_hw=self._healthy_sub[name], cache=self.cache,
                budget=self.budget, latency_budget_s=self.latency_budget_s,
                cause=f"tenancy_{name}")
            p.hw, p.response = out.hw, out
            p.rung = "tenancy:shrink_in_place"
            within = within and out.within_budget
            replanned.append(name)
        return self._finish("link_slow", None, "shrink_in_place",
                            tuple(replanned), t0, before, log, within=within)

    def _repartition(self, cause: str, owner: str, t0: float,
                     before: Dict[str, str],
                     log: List[str]) -> ContainedReplan:
        """Rung 3: re-run the joint search on the degraded fabric.
        Bounded disruption: best-effort tenants resolve at deadline 0
        (the service's memoized fallback rung), guaranteed tenants get
        the full deadline."""
        tenants = [p.tenant for p in self.plan.placements]
        evict = {t.name: 0.0 for t in tenants if t.qos == "best_effort"}
        if evict:
            log.append(f"repartition: evicting best-effort "
                       f"{sorted(evict)} to the fallback rung")
            for t in sorted(evict):
                metrics.inc("tenancy_evicted_total", tenant=t)
                flightrec.record("qos_evict", tenant=t, cause=cause)
        new_plan = self.partitioner.plan(
            self.hw, tenants, service=self.service, budget=self.budget,
            tenant_budget_ms=evict or None)
        bad = self.validator.validate(new_plan)
        if bad:
            raise RuntimeError(f"repartition of {self.hw.name} failed "
                               f"isolation validation: {bad}")
        self.plan = new_plan
        self._healthy_sub = {p.tenant.name: p.hw
                             for p in new_plan.placements}
        for p in new_plan.placements:
            p.rung = "tenancy:repartition"
        if self.service is not None and hasattr(self.service, "note_fault"):
            self.service.note_fault(
                type("_Evt", (), {"cause": cause})())
        after = self.plan.digests()
        replanned = tuple(t for t, d in after.items()
                          if before.get(t) != d)
        log.append(f"repartition: {len(replanned)}/{len(after)} tenant "
                   f"plans changed")
        return self._finish(cause, owner, "repartition", replanned, t0,
                            before, log)

    # ------------------------------------------------------------- finish
    def _finish(self, cause: str, owner: Optional[str], rung: str,
                replanned: Tuple[str, ...], t0: float,
                before: Dict[str, str], log: List[str], *,
                within: bool = True) -> ContainedReplan:
        seconds = time.perf_counter() - t0
        for t in replanned:
            metrics.inc("tenancy_replan_total", tenant=t, rung=rung)
        metrics.observe("tenancy_blast_radius", float(len(replanned)),
                        cause=cause)
        metrics.observe("tenancy_contain_seconds", seconds, rung=rung)
        flightrec.record("containment", cause=cause, owner=owner,
                         rung=rung, blast_radius=len(replanned),
                         replanned=replanned, seconds=seconds,
                         within_budget=within, log=log)
        slo.note_containment(owner if owner is not None else "(shared)",
                             len(replanned), rung=rung)
        ev = ContainedReplan(
            cause=cause, owner=owner, rung=rung, replanned=replanned,
            blast_radius=len(replanned), seconds=seconds,
            within_budget=within, digests_before=before,
            digests_after=self.plan.digests(), log=log)
        self.events.append(ev)
        return ev
