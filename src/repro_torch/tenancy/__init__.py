"""Multi-tenant mesh partitioning with fault-domain isolation
(DESIGN_TENANCY.md).

* :mod:`~repro_torch.tenancy.partition` — ``submesh()`` logical-partition
  models, guillotine layout enumeration, and the joint
  partition-shape x per-tenant-plan search (:class:`MeshPartitioner`);
* :mod:`~repro_torch.tenancy.qos`       — guaranteed/best-effort admission
  (:class:`TenantAdmission`);
* :mod:`~repro_torch.tenancy.validator` — the pre-serve isolation gate
  (:class:`IsolationValidator`);
* :mod:`~repro_torch.tenancy.runtime`   — contained re-planning
  (:class:`TenantRuntime`, blast radius measured per event).
"""
from .partition import (MeshPartitioner, Rect, TenancyPlan, TenantPlacement,
                        TenantSpec, enumerate_layouts, plan_digest, submesh)
from .qos import TenantAdmission
from .runtime import TENANCY_RUNGS, ContainedReplan, TenantRuntime
from .validator import IsolationValidator

__all__ = [
    "ContainedReplan", "IsolationValidator", "MeshPartitioner", "Rect",
    "TENANCY_RUNGS", "TenancyPlan", "TenantAdmission", "TenantPlacement",
    "TenantRuntime", "TenantSpec", "enumerate_layouts", "plan_digest",
    "submesh",
]
