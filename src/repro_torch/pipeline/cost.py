"""Graph-level cost evaluation: fused two-phase simulation + handoff terms.

The co-planned execution model is *phase-wise*: the producer kernel runs to
completion (its waves writing the forwarded intermediates into the
distributed local memories), then the consumer kernel runs (its waves
reading them back, through the re-shuffle rings where the two mappings'
spatial digits disagree).  End-to-end graph time is therefore the sum of
the nodes' *edge-adjusted* simulations:

* a **spilled** edge leaves both sides untouched — the producer's DRAM
  store and the consumer's DRAM reload are already priced inside their own
  simulations (that sum is exactly the independent-planning baseline, the
  benchmarks' ``dram_roundtrip_us`` column);
* a **forwarded** edge reprices the producer's store and the consumer's
  load on-chip via :class:`~repro_torch.core.reuse.ForwardLeg` overrides
  (``simulate(plan, hw, fwd=...)`` — the scalar and batch engines stay
  bit-identical on these adjusted simulations).

``edge_dram_roundtrip_s`` prices what a spilled edge pays on the DRAM pool
(the store + reload bytes over the aggregate bandwidth) — the reporting
term the benchmark table and the graph plan summary surface.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping as TMapping, Optional

from repro_torch.core import batch_cost
from repro_torch.core.hw import HardwareModel
from repro_torch.core.perfmodel import _resource_pools
from repro_torch.core.plan import DataflowPlan
from repro_torch.core.planner import resolve_engine
from repro_torch.core.reuse import ForwardLeg
from repro_torch.core.simulator import SimResult, simulate

from .graph import PipelineEdge, PipelineGraph


@dataclass(frozen=True)
class GraphSim:
    """One graph-plan evaluation: per-node adjusted simulations + totals."""
    total_s: float
    node_sims: Dict[str, SimResult]
    dram_bytes: float
    noc_bytes: float


def simulate_nodes(graph: PipelineGraph,
                   plans: TMapping[str, DataflowPlan],
                   legs: TMapping[str, TMapping[str, ForwardLeg]],
                   hw: HardwareModel, *,
                   engine: Optional[str] = None) -> GraphSim:
    """Simulate every node with its forwarded-edge legs applied and sum.

    With empty legs this is exactly the sum of the standalone per-kernel
    simulations — the forwarding-disabled property the tests pin.  ``plans``
    may cover a subset of the graph's nodes (the co-planner evaluates nodes
    one at a time as their edges get decided)."""
    order = [n.name for n in graph.nodes if n.name in plans]
    plan_list = [plans[name] for name in order]
    fwd_list = [dict(legs.get(name) or {}) or None for name in order]
    if resolve_engine(engine) == "batch":
        sims = batch_cost.simulate_plans(plan_list, hw, fwd=fwd_list)
    else:
        sims = [simulate(p, hw, fwd=f)
                for p, f in zip(plan_list, fwd_list)]
    node_sims = dict(zip(order, sims))
    return GraphSim(
        total_s=sum(s.total_s for s in sims),
        node_sims=node_sims,
        dram_bytes=sum(s.dram_bytes for s in sims),
        noc_bytes=sum(s.noc_bytes for s in sims))


def edge_dram_roundtrip_s(graph: PipelineGraph, edge: PipelineEdge,
                          producer: DataflowPlan, consumer: DataflowPlan,
                          hw: HardwareModel) -> float:
    """The DRAM time a spilled edge pays for the intermediate's round trip:
    (store bytes + reload bytes) over the aggregate DRAM pool.  A reporting
    term (the simulator prices the real thing with per-channel contention);
    also a convenient upper-level summary of what forwarding removes."""
    pools = _resource_pools(hw)
    store = graph.edge_store(edge, producer.program)
    load = graph.edge_load(edge, consumer.program)
    store_bytes = 0.0
    for s in producer.stores:
        if s.access.tensor.name != edge.tensor:
            continue
        mult = 2.0 if (s.reduce_axes and s.reduce_style == "accum") else 1.0
        store_bytes += (mult * store.tile_bytes * s.issues_per_core
                        * producer.mapping.active_cores())
    load_bytes = 0.0
    for c in consumer.loads:
        if c.access.tensor.name != edge.tensor:
            continue
        load_bytes += (load.tile_bytes * c.hoist.tiles_per_issue
                       * c.hoist.issues_per_core
                       * consumer.mapping.active_cores())
    return (store_bytes + load_bytes) / pools["dram"]
