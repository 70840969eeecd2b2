"""IsolationValidator: the gate run before any partitioned plan is served.

The single-tenant sanitizer (:func:`repro_torch.plancache.validate.validate_plan`)
checks one plan against one model; multi-tenancy adds *cross-tenant*
failure modes it cannot see:

* overlapping partitions (two tenants' waves landing on the same cores);
* a rect that walks off the physical mesh;
* a plan whose spatial binds exceed its own partition (it was computed on
  the wrong submesh model, or the placement was edited after planning);
* joint DRAM residency: partitions slice the core mesh, but every tenant's
  tensors live in the *same* physical DRAM — the sum of per-tenant
  footprints must fit even though each fits alone.  (L1 needs no joint
  check: scratchpads are per-core and partitions are disjoint, so the
  per-plan residency check *is* the joint check.)

Like the sanitizer it wraps, :func:`IsolationValidator.validate` never
raises — it returns the violation list, empty when the partitioned plan
is servable.
"""
from __future__ import annotations

from typing import List

from repro_torch.obs import flightrec, metrics
from repro_torch.plancache.validate import dram_residency_bytes, validate_plan

from .partition import TenancyPlan


class IsolationValidator:
    """Structural isolation checks over a :class:`TenancyPlan`.

    ``dram_slack`` scales the joint-DRAM capacity check (1.0 = the full
    physical capacity; serving deployments reserve headroom for KV-cache
    growth by passing < 1.0).
    """

    def __init__(self, *, dram_slack: float = 1.0) -> None:
        if not 0.0 < dram_slack <= 1.0:
            raise ValueError(f"dram_slack must be in (0, 1], got {dram_slack}")
        self.dram_slack = dram_slack

    def validate(self, plan: TenancyPlan) -> List[str]:
        try:
            bad = self._validate(plan)
        except Exception as e:  # noqa: BLE001 — the gate must not throw
            bad = [f"isolation validator error: {e!r}"]
        if bad:
            metrics.inc("tenancy_isolation_violations_total", len(bad),
                        hw=plan.hw.name)
            flightrec.record("violation", hw=plan.hw.name, problems=bad)
            # an isolation violation is the incident the recorder exists
            # for: force the dump NOW, before any escalation path (or the
            # serve driver's SystemExit) can lose the buffer
            flightrec.dump(reason="isolation_violation")
        return bad

    def _validate(self, plan: TenancyPlan) -> List[str]:
        bad: List[str] = []
        hw = plan.hw
        sizes = [s for _, s in hw.mesh_dims]
        places = plan.placements

        # -- partition geometry: on-mesh, pairwise disjoint ----------------
        for p in places:
            if len(p.rect.origin) != len(sizes):
                bad.append(f"{p.tenant.name}: rect rank "
                           f"{len(p.rect.origin)} vs mesh rank {len(sizes)}")
            elif not p.rect.within(sizes):
                bad.append(f"{p.tenant.name}: rect {p.rect.describe()} "
                           f"exceeds {hw.name} mesh "
                           f"{'x'.join(str(s) for s in sizes)}")
        for i, a in enumerate(places):
            for b in places[i + 1:]:
                if a.rect.overlaps(b.rect):
                    bad.append(f"partitions overlap: {a.tenant.name} "
                               f"{a.rect.describe()} vs {b.tenant.name} "
                               f"{b.rect.describe()}")
        if bad:
            return bad                     # geometry broken: stop here

        # -- per-tenant plan vs its own submesh model ----------------------
        for p in places:
            if p.response is None or p.result is None:
                bad.append(f"{p.tenant.name}: no plan resolved")
                continue
            for v in validate_plan(p.plan, p.hw):
                bad.append(f"{p.tenant.name}: {v}")
            # binds may not reach outside the partition even if the plan
            # was (wrongly) computed against a larger model
            part = dict(p.hw.mesh_dims)
            for b in p.plan.mapping.spatial:
                limit = part.get(b.hw_dim)
                if limit is not None and b.hw_size > limit:
                    bad.append(
                        f"{p.tenant.name}: bind {b.grid_dim}->{b.hw_dim} "
                        f"size {b.hw_size} exceeds partition "
                        f"{p.rect.describe()}")

        # -- joint DRAM residency across co-located tenants ----------------
        cap = int(hw.global_mem.size_bytes * hw.global_mem.count(hw)
                  * self.dram_slack)
        total = sum(dram_residency_bytes(p.plan) for p in places
                    if p.response is not None and p.result is not None)
        if total > cap:
            bad.append(f"joint DRAM residency {total} B across "
                       f"{len(places)} tenants exceeds {cap} B on {hw.name}")
        return bad
