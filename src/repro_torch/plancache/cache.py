"""High-level plan cache consumed by ``plan_kernel`` / ``plan_kernel_multi``.

The planner takes ``cache=`` as a duck-typed object (so ``repro_torch.core``
never imports this package at module scope); :class:`PlanCache` is the
canonical implementation.  It maps full kernel-planning invocations to
serialized :class:`~repro_torch.core.planner.PlanResult` payloads in the two-tier
store, and supplies warm-start program ordering on misses.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.hw import HardwareModel
from repro_torch.core.planner import PlanResult, SearchBudget
from repro_torch.core.program import TileProgram
from repro_torch.obs import metrics, trace

from . import keying, serialize, warmstart
from .store import PlanCacheStore, get_store
from .validate import validate_plan


def _note_cache_seconds(t0: float) -> None:
    """Attribute cache lookup/publish time to the unified per-phase
    breakdown (the same counter the planner's search phases land in)."""
    metrics.inc("planner_phase_seconds_total", time.perf_counter() - t0,
                phase="cache")


class PlanCache:
    """Content-addressed cache of full planner results."""

    def __init__(self, store: Optional[PlanCacheStore] = None) -> None:
        self._store = store

    @property
    def store(self) -> PlanCacheStore:
        return self._store if self._store is not None else get_store()

    # ------------------------------------------------------------ planner API
    def get_result(self, programs: Sequence[TileProgram], hw: HardwareModel,
                   budget: Optional[SearchBudget], *, profile: bool,
                   spatial_reuse: bool, temporal_reuse: bool,
                   entry: str = "kernel_multi") -> Optional[PlanResult]:
        t0 = time.perf_counter()
        with trace.span("plancache.get", cat="plancache", entry=entry):
            key = keying.kernel_key(programs, hw, budget, profile=profile,
                                    spatial_reuse=spatial_reuse,
                                    temporal_reuse=temporal_reuse,
                                    entry=entry)
            ent = self.store.get(key)
            _note_cache_seconds(t0)
            if ent is None:
                return None
            try:
                result = serialize.result_from_dict(ent["payload"]["result"])
            except (KeyError, TypeError, ValueError):
                # structurally valid JSON that doesn't deserialize into a
                # PlanResult is corruption, not a schema skew: quarantine it
                self.store.quarantine(key, "deserialize")
                return None
            bad = validate_plan(result.best.plan, hw)
            if bad:
                self.store.quarantine(key, "invalid_plan")
                return None
            return result

    def put_result(self, programs: Sequence[TileProgram], hw: HardwareModel,
                   budget: Optional[SearchBudget], result: PlanResult, *,
                   profile: bool, spatial_reuse: bool, temporal_reuse: bool,
                   entry: str = "kernel_multi") -> None:
        t0 = time.perf_counter()
        with trace.span("plancache.put", cat="plancache", entry=entry):
            key = keying.kernel_key(programs, hw, budget, profile=profile,
                                    spatial_reuse=spatial_reuse,
                                    temporal_reuse=temporal_reuse,
                                    entry=entry)
            best_prog = result.best.plan.program
            meta = {
                "template": keying.template_signature(best_prog),
                "shape": keying.shape_vector(best_prog),
                "hw": keying.hw_digest(hw),
                "hw_name": hw.name,
                "kernel": result.kernel,
                "tiles": warmstart.tile_signature(best_prog),
            }
            self.store.put(key, {"result": serialize.result_to_dict(result),
                                 "tiles": meta["tiles"]}, meta)
            _note_cache_seconds(t0)

    # ------------------------------------------------------- pipeline API
    def get_graph_result(self, graph, hw: HardwareModel,
                         budget: Optional[SearchBudget]):
        """Graph-level hit for ``repro_torch.pipeline.plan_pipeline`` (schema-v3
        keys composed from the node program signatures + edge list)."""
        t0 = time.perf_counter()
        with trace.span("plancache.get_graph", cat="plancache",
                        graph=graph.name):
            key = keying.graph_key(graph, hw, budget)
            ent = self.store.get(key)
            _note_cache_seconds(t0)
            if ent is None:
                return None
            try:
                return serialize.graph_plan_from_dict(ent["payload"]["graph"])
            except (KeyError, TypeError, ValueError):
                self.store.quarantine(key, "deserialize")
                return None

    def put_graph_result(self, graph, hw: HardwareModel,
                         budget: Optional[SearchBudget], plan) -> None:
        t0 = time.perf_counter()
        with trace.span("plancache.put_graph", cat="plancache",
                        graph=graph.name):
            key = keying.graph_key(graph, hw, budget)
            meta = {
                "template": "pipeline_graph",
                "graph": graph.name,
                "shape": [len(n.programs) for n in graph.nodes],
                "hw": keying.hw_digest(hw),
                "hw_name": hw.name,
                "kernel": graph.name,
                "edges": [[e.src, e.dst, e.tensor] for e in graph.edges],
            }
            self.store.put(key, {"graph": serialize.graph_plan_to_dict(plan)},
                           meta)
            _note_cache_seconds(t0)

    def order_programs(self, programs: Sequence[TileProgram],
                       hw: HardwareModel) -> List[TileProgram]:
        """Warm-start hook: on a miss, reorder candidates around the nearest
        cached winner of the same template on the same hardware."""
        programs = list(programs)
        if not programs:
            return programs
        with trace.span("plancache.warm_order", cat="plancache",
                        n_programs=len(programs)):
            return warmstart.warm_order_from_store(
                self.store, keying.template_signature(programs[0]),
                keying.hw_digest(hw), keying.shape_vector(programs[0]),
                programs)
