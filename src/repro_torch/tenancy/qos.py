"""Tenant QoS classes and per-tenant admission (DESIGN_TENANCY.md).

Two classes, the smallest vocabulary that expresses the serving contract:

* ``guaranteed``   — always admitted with its requested plan deadline; never
  preempted below its QoS by a repartition (the runtime gives it a full
  resolve, not the fallback rung);
* ``best_effort``  — admitted through a bounded gate layered on the PR 8
  semaphore machinery; under pressure its *deadline* is shed to 0 ms, which
  walks the :class:`~repro_torch.planservice.PlanService` ladder straight to the
  memoized generic fallback (rung 4) — the tenant still gets a runnable
  plan, just not a searched one.  On a global repartition, best-effort
  tenants are evicted the same way (bounded disruption: the expensive joint
  search is spent on guaranteed tenants only).

Shedding by deadline rather than by rejection keeps the service's "always
return a runnable plan" contract intact across the tenancy layer — no
caller ever has to handle an admission error mid-decode.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

from repro_torch.obs import flightrec, metrics

from .partition import QOS_CLASSES, TenantSpec


class TenantAdmission:
    """Per-tenant admission gate over the plan service.

    ``max_best_effort`` bounds *concurrent* best-effort resolutions (the
    guaranteed class is never gated).  :meth:`admit` yields the effective
    ``budget_ms`` to pass to the service: the tenant's requested deadline
    when admitted, ``0.0`` (straight to the fallback rung) when shed.
    Emits ``tenancy_admitted_total{tenant,qos,outcome}``.
    """

    def __init__(self, *, max_best_effort: int = 2) -> None:
        if max_best_effort < 0:
            raise ValueError("max_best_effort must be >= 0")
        self._no_best_effort = max_best_effort == 0
        self._gate = threading.BoundedSemaphore(max(1, max_best_effort))
        self.shed_total: Dict[str, int] = {}

    @contextmanager
    def admit(self, tenant: TenantSpec,
              budget_ms: Optional[float] = None
              ) -> Iterator[Optional[float]]:
        """``with admission.admit(tenant) as ms: service.resolve(...,
        budget_ms=ms)``.  Guaranteed tenants pass through untouched;
        best-effort tenants either hold a gate slot for the duration or
        are shed to a 0 ms deadline."""
        if tenant.qos not in QOS_CLASSES:
            raise ValueError(f"unknown qos {tenant.qos!r}")
        if tenant.qos == "guaranteed":
            metrics.inc("tenancy_admitted_total", tenant=tenant.name,
                        qos=tenant.qos, outcome="admitted")
            yield budget_ms
            return
        if not self._no_best_effort and self._gate.acquire(blocking=False):
            metrics.inc("tenancy_admitted_total", tenant=tenant.name,
                        qos=tenant.qos, outcome="admitted")
            try:
                yield budget_ms
            finally:
                self._gate.release()
            return
        self.shed_total[tenant.name] = self.shed_total.get(tenant.name,
                                                           0) + 1
        metrics.inc("tenancy_admitted_total", tenant=tenant.name,
                    qos=tenant.qos, outcome="shed")
        flightrec.record("qos_shed", tenant=tenant.name, qos=tenant.qos,
                         requested_ms=budget_ms)
        yield 0.0                          # deadline 0: fallback rung only
