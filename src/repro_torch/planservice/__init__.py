# Deadline-bounded plan service (DESIGN_PLANSERVICE.md).
#
# Layers:  fallback.py (rung 4: guaranteed generic plan, O(1) build)
#       -> family.py   (rung 2: shape-neighbor transplant + certification)
#       -> service.py  (the ladder, coalescing, admission gate, breaker,
#                       background completion)
from .fallback import generic_fallback_plan
from .family import certified_result, certify_plan, program_floor, \
    retarget_plan
from .service import (ENV_BG, ENV_DEADLINE, ENV_REGRET, MeshPlanResponse,
                      PlanRequest, PlanResponse, PlanService, RUNGS,
                      background_enabled, default_deadline_ms,
                      default_regret)

__all__ = [
    "PlanService", "PlanRequest", "PlanResponse", "MeshPlanResponse",
    "RUNGS", "ENV_DEADLINE", "ENV_REGRET", "ENV_BG",
    "default_deadline_ms", "default_regret", "background_enabled",
    "generic_fallback_plan",
    "certified_result", "certify_plan", "program_floor", "retarget_plan",
]
