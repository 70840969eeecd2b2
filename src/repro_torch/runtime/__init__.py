"""Runtime resilience: fault tolerance, elastic rescale, fault injection,
and degraded-mesh re-planning.

Imports are lazy (PEP 562): ``elastic`` pulls in JAX at import time, but
the fault-injection and re-plan layers are pure planner code — callers
like the benchmark harness and pool workers must be able to import them
without paying (or having) an accelerator runtime.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "RescalePlan": "elastic",
    "apply_rescale": "elastic",
    "plan_rescale": "elastic",
    "viable_mesh_shapes": "elastic",
    "HeartbeatRegistry": "fault_tolerance",
    "RecoveryEvent": "fault_tolerance",
    "ResilientDriver": "fault_tolerance",
    "StragglerTracker": "fault_tolerance",
    "FaultSpec": "faults",
    "FaultSchedule": "faults",
    "parse_faults": "faults",
    "apply_env_faults": "faults",
    "ReplanOutcome": "replan",
    "ReplanOrchestrator": "replan",
    "plan_degraded": "replan",
    "best_submesh": "replan",
}

__all__ = sorted(_EXPORTS)

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from .elastic import (RescalePlan, apply_rescale, plan_rescale,
                          viable_mesh_shapes)
    from .fault_tolerance import (HeartbeatRegistry, RecoveryEvent,
                                  ResilientDriver, StragglerTracker)
    from .faults import FaultSchedule, FaultSpec, apply_env_faults, parse_faults
    from .replan import (ReplanOrchestrator, ReplanOutcome, best_submesh,
                         plan_degraded)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
