"""Stable JSON round-trip for planner artifacts (no pickle).

Every dataclass the planner produces — :class:`TileProgram`,
:class:`Mapping`, :class:`MemOpChoice`, :class:`DataflowPlan`,
:class:`PlanCost`, :class:`SimResult`, :class:`Candidate`,
:class:`PlanResult` — gets a ``*_to_dict`` / ``*_from_dict`` pair whose
output survives ``json.dumps``/``json.loads`` unchanged.  The planner's
dataclasses are frozen and built from tuples of primitives, so round-trip
equality is structural: ``result_from_dict(result_to_dict(r))`` compares
equal field-by-field and ``estimate(plan, hw)`` reproduces identical costs.

The only non-trivial leaf is :class:`AffineExpr` — the plan-side algebra is
always the pure linear + ``mod``/``floordiv`` form (the composite channel
map of ``hw._channel_expr`` lives in hardware models, which are re-created
from presets, never serialized).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.core.affine import AffineExpr, AffineMap
from repro_torch.core.mapping import Mapping, SpatialBind, TemporalLoop
from repro_torch.core.perfmodel import PlanCost
from repro_torch.core.plan import DataflowPlan
from repro_torch.core.planner import Candidate, PlanResult
from repro_torch.core.program import (LoopDim, TensorSpec, TileAccess, TileOp,
                                TileProgram)
from repro_torch.core.reuse import HoistOption, MemOpChoice, StorePlacement
from repro_torch.core.simulator import SimResult


# --------------------------------------------------------------- affine
def expr_to_dict(e: AffineExpr) -> Dict[str, Any]:
    return {"coeffs": [[k, v] for k, v in e.coeffs], "const": e.const,
            "mod": e.mod, "floordiv": e.floordiv}


def expr_from_dict(d: Dict[str, Any]) -> AffineExpr:
    return AffineExpr(coeffs=tuple((str(k), int(v)) for k, v in d["coeffs"]),
                      const=int(d["const"]), mod=d.get("mod"),
                      floordiv=d.get("floordiv"))


def map_to_dict(m: AffineMap) -> Dict[str, Any]:
    return {"exprs": [expr_to_dict(e) for e in m.exprs]}


def map_from_dict(d: Dict[str, Any]) -> AffineMap:
    return AffineMap(tuple(expr_from_dict(e) for e in d["exprs"]))


# --------------------------------------------------------------- program
def tensor_to_dict(t: TensorSpec) -> Dict[str, Any]:
    return {"name": t.name, "shape": list(t.shape),
            "dtype_bytes": t.dtype_bytes}


def tensor_from_dict(d: Dict[str, Any]) -> TensorSpec:
    return TensorSpec(d["name"], tuple(int(s) for s in d["shape"]),
                      int(d["dtype_bytes"]))


def access_to_dict(a: TileAccess) -> Dict[str, Any]:
    return {"tensor": tensor_to_dict(a.tensor), "index": map_to_dict(a.index),
            "tile_shape": list(a.tile_shape), "kind": a.kind, "name": a.name}


def access_from_dict(d: Dict[str, Any]) -> TileAccess:
    return TileAccess(tensor_from_dict(d["tensor"]),
                      map_from_dict(d["index"]),
                      tuple(int(s) for s in d["tile_shape"]),
                      d["kind"], d.get("name", ""))


def program_to_dict(p: TileProgram) -> Dict[str, Any]:
    return {
        "name": p.name,
        "grid_dims": [[d.name, d.extent] for d in p.grid_dims],
        "seq_dims": [[d.name, d.extent] for d in p.seq_dims],
        "loads": [access_to_dict(a) for a in p.loads],
        "stores": [access_to_dict(a) for a in p.stores],
        "body": [{"kind": o.kind, "unit": o.unit, "work": o.work,
                  "segment": o.segment} for o in p.body],
        "accumulators": [[n, b] for n, b in p.accumulators],
    }


def program_from_dict(d: Dict[str, Any]) -> TileProgram:
    return TileProgram(
        name=d["name"],
        grid_dims=tuple(LoopDim(n, int(e)) for n, e in d["grid_dims"]),
        seq_dims=tuple(LoopDim(n, int(e)) for n, e in d["seq_dims"]),
        loads=tuple(access_from_dict(a) for a in d["loads"]),
        stores=tuple(access_from_dict(a) for a in d["stores"]),
        body=tuple(TileOp(o["kind"], o["unit"], float(o["work"]),
                          int(o.get("segment", 0))) for o in d["body"]),
        accumulators=tuple((n, int(b)) for n, b in d["accumulators"]))


# --------------------------------------------------------------- mapping
def mapping_to_dict(m: Mapping) -> Dict[str, Any]:
    return {
        "program": program_to_dict(m.program),
        "hw_name": m.hw_name,
        "hw_dims": [[n, s] for n, s in m.hw_dims],
        "spatial": [{"hw_dim": b.hw_dim, "hw_size": b.hw_size,
                     "grid_dim": b.grid_dim, "reduce": b.reduce}
                    for b in m.spatial],
        "temporal": [{"name": t.name, "grid_dim": t.grid_dim,
                      "extent": t.extent} for t in m.temporal],
        "reduce_style": m.reduce_style,
    }


def mapping_from_dict(d: Dict[str, Any]) -> Mapping:
    return Mapping(
        program=program_from_dict(d["program"]),
        hw_name=d["hw_name"],
        hw_dims=tuple((n, int(s)) for n, s in d["hw_dims"]),
        spatial=tuple(SpatialBind(b["hw_dim"], int(b["hw_size"]),
                                  b["grid_dim"], bool(b.get("reduce", False)))
                      for b in d["spatial"]),
        temporal=tuple(TemporalLoop(t["name"], t["grid_dim"], int(t["extent"]))
                       for t in d["temporal"]),
        reduce_style=str(d.get("reduce_style", "")))


# ------------------------------------------------------------ memory ops
def memop_to_dict(c: MemOpChoice) -> Dict[str, Any]:
    h = c.hoist
    return {
        "access": access_to_dict(c.access),
        "bcast_axes": list(c.bcast_axes),
        "hoist": {"level": h.level, "footprint_tiles": h.footprint_tiles,
                  "issues_per_core": h.issues_per_core,
                  "tiles_per_issue": h.tiles_per_issue},
    }


def memop_from_dict(d: Dict[str, Any]) -> MemOpChoice:
    h = d["hoist"]
    return MemOpChoice(
        access_from_dict(d["access"]),
        tuple(str(a) for a in d["bcast_axes"]),
        HoistOption(int(h["level"]), int(h["footprint_tiles"]),
                    int(h["issues_per_core"]), int(h["tiles_per_issue"])))


def store_placement_to_dict(s: StorePlacement) -> Dict[str, Any]:
    return {"access": access_to_dict(s.access), "level": s.level,
            "issues_per_core": s.issues_per_core,
            "reduce_axes": list(s.reduce_axes),
            "reduce_style": s.reduce_style}


def store_placement_from_dict(d: Dict[str, Any]) -> StorePlacement:
    return StorePlacement(access_from_dict(d["access"]), int(d["level"]),
                          int(d["issues_per_core"]),
                          reduce_axes=tuple(str(a) for a in
                                            d.get("reduce_axes", [])),
                          reduce_style=str(d.get("reduce_style", "")))


# --------------------------------------------------------------- plan
def plan_to_dict(p: DataflowPlan) -> Dict[str, Any]:
    return {
        "mapping": mapping_to_dict(p.mapping),
        "loads": [memop_to_dict(c) for c in p.loads],
        "stores": [store_placement_to_dict(s) for s in p.stores],
    }


def plan_from_dict(d: Dict[str, Any]) -> DataflowPlan:
    return DataflowPlan(
        mapping_from_dict(d["mapping"]),
        tuple(memop_from_dict(c) for c in d["loads"]),
        tuple(store_placement_from_dict(s) for s in d["stores"]))


# --------------------------------------------------------------- costs
_COST_FIELDS = ("total_s", "compute_s", "inner_load_s", "inner_store_s",
                "hoisted_s", "dram_bytes", "noc_bytes", "flops",
                "buffer_bytes", "utilization", "bound")


def cost_to_dict(c: PlanCost) -> Dict[str, Any]:
    return {f: getattr(c, f) for f in _COST_FIELDS}


def cost_from_dict(d: Dict[str, Any]) -> PlanCost:
    return PlanCost(**{f: d[f] for f in _COST_FIELDS})


_SIM_FIELDS = ("total_s", "dram_bytes", "noc_bytes", "flops", "n_waves",
               "wave_overhead_s", "n_wave_classes")
_SIM_DEFAULTS = {"n_wave_classes": 0}      # absent in pre-fast-search entries


def sim_to_dict(s: SimResult) -> Dict[str, Any]:
    return {f: getattr(s, f) for f in _SIM_FIELDS}


def sim_from_dict(d: Dict[str, Any]) -> SimResult:
    # only fields with an explicit default may be absent (older entries);
    # anything else missing is a corrupt entry and should KeyError loudly
    return SimResult(**{f: d.get(f, _SIM_DEFAULTS[f]) if f in _SIM_DEFAULTS
                        else d[f] for f in _SIM_FIELDS})


# --------------------------------------------------------------- results
def candidate_to_dict(c: Candidate) -> Dict[str, Any]:
    return {"plan": plan_to_dict(c.plan), "cost": cost_to_dict(c.cost),
            "sim": sim_to_dict(c.sim) if c.sim is not None else None,
            # canonical (program, mapping, combo) stream index — what the
            # process-sharded search merges on (absent in older entries)
            "index": list(c.index) if c.index is not None else None}


def candidate_from_dict(d: Dict[str, Any]) -> Candidate:
    idx = d.get("index")
    return Candidate(plan_from_dict(d["plan"]), cost_from_dict(d["cost"]),
                     sim_from_dict(d["sim"]) if d.get("sim") else None,
                     index=tuple(int(i) for i in idx) if idx else None)


def graph_plan_to_dict(g) -> Dict[str, Any]:
    """Serialize a :class:`repro_torch.pipeline.planner.GraphPlan` (imported
    duck-typed so the plancache package keeps zero import-time dependency
    on the pipeline subsystem)."""
    return {
        "graph_name": g.graph_name,
        "hw_name": g.hw_name,
        "nodes": {name: candidate_to_dict(c) for name, c in g.nodes.items()},
        "decisions": [{
            "src": d.src, "dst": d.dst, "tensor": d.tensor,
            "forwarded": d.forwarded,
            "shuffle_axes": list(d.shuffle_axes),
            "resident_bytes": d.resident_bytes,
        } for d in g.decisions],
        "node_sims": {name: sim_to_dict(s)
                      for name, s in g.node_sims.items()},
        "total_s": g.total_s,
        "baseline_s": g.baseline_s,
        "dram_roundtrip_s": g.dram_roundtrip_s,
        "plan_seconds": g.plan_seconds,
        "n_graph_combos": g.n_graph_combos,
        "n_graph_pruned": g.n_graph_pruned,
        "n_forwardable_pairs": g.n_forwardable_pairs,
        "n_pairs": g.n_pairs,
        "log": list(g.log),
    }


def graph_plan_from_dict(d: Dict[str, Any]):
    from repro_torch.pipeline.planner import EdgeDecision, GraphPlan
    return GraphPlan(
        graph_name=d["graph_name"], hw_name=d["hw_name"],
        nodes={name: candidate_from_dict(c)
               for name, c in d["nodes"].items()},
        decisions=tuple(EdgeDecision(
            e["src"], e["dst"], e["tensor"], forwarded=bool(e["forwarded"]),
            shuffle_axes=tuple(str(a) for a in e["shuffle_axes"]),
            resident_bytes=int(e["resident_bytes"])) for e in d["decisions"]),
        node_sims={name: sim_from_dict(s)
                   for name, s in d["node_sims"].items()},
        total_s=float(d["total_s"]),
        baseline_s=float(d["baseline_s"]),
        dram_roundtrip_s=float(d["dram_roundtrip_s"]),
        plan_seconds=float(d["plan_seconds"]),
        n_graph_combos=int(d.get("n_graph_combos", 0)),
        n_graph_pruned=int(d.get("n_graph_pruned", 0)),
        n_forwardable_pairs=int(d.get("n_forwardable_pairs", 0)),
        n_pairs=int(d.get("n_pairs", 0)),
        log=[str(x) for x in d.get("log", [])])


def result_to_dict(r: PlanResult) -> Dict[str, Any]:
    return {
        "kernel": r.kernel,
        "hw_name": r.hw_name,
        "best": candidate_to_dict(r.best),
        "topk": [candidate_to_dict(c) for c in r.topk],
        "n_candidates": r.n_candidates,
        "n_mappings": r.n_mappings,
        "plan_seconds": r.plan_seconds,
        "log": list(r.log),
        "n_pruned": r.n_pruned,
        "n_estimated": r.n_estimated,
        "n_mappings_pruned": r.n_mappings_pruned,
        "n_wave_classes": r.n_wave_classes,
        "n_infeasible_programs": r.n_infeasible_programs,
    }


def result_from_dict(d: Dict[str, Any]) -> PlanResult:
    return PlanResult(
        kernel=d["kernel"], hw_name=d["hw_name"],
        best=candidate_from_dict(d["best"]),
        topk=[candidate_from_dict(c) for c in d["topk"]],
        n_candidates=int(d["n_candidates"]),
        n_mappings=int(d["n_mappings"]),
        plan_seconds=float(d["plan_seconds"]),
        log=[str(x) for x in d.get("log", [])],
        n_pruned=int(d.get("n_pruned", 0)),
        n_estimated=int(d.get("n_estimated", 0)),
        n_mappings_pruned=int(d.get("n_mappings_pruned", 0)),
        n_wave_classes=int(d.get("n_wave_classes", 0)),
        n_infeasible_programs=int(d.get("n_infeasible_programs", 0)))
