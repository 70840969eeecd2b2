"""Inter-kernel reuse analysis: when can an edge be forwarded on-chip?

For a fixed (producer plan, consumer plan) pair and one graph edge, this
module decides whether the intermediate can stay in the distributed local
memories between the two kernel phases — and at what cost — instead of
round-tripping through DRAM:

* **tiling legality** — both sides must address the same logical tile grid:
  the producer's store tile shape must equal the consumer's load tile shape
  (the graph-level correspondence is the identity on the tensor dims);
* **placement compatibility** — rewriting both accesses through their
  mappings gives each tile-grid coordinate as an affine function of
  hardware spatial digits (+ wave/sequential indices).  Where the two
  rewritten maps agree on every spatial-digit coefficient, each tile is
  consumed by the core that produced it (zero-cost handoff through that
  core's L1); every hardware axis whose digit coefficients *disagree*
  contributes a **re-shuffle leg**: the tile crosses that axis' NoC ring
  once on its way to the consuming core;
* **reduction exclusion** — a store still carrying a spatial-reduction
  combine (``reduce_axes``) spills: the partial-sum epilogue already owns
  the store path and pinning it to L1 would change the combine semantics;
* **broadcast exclusion** — a consumer load realized as a NoC multicast
  (``bcast_axes``) spills: the multicast source is the DRAM-fetched copy,
  so serving it from distributed L1 would need a different (gather+
  multicast) dataflow that the cost layers do not model;
* **capacity** — the resident intermediate (each producer core keeps the
  tiles it produced until the consumer phase) must fit next to the working
  buffers of *both* phases.  The joint check across all live edges of a
  node happens in the co-planner; this module computes the per-edge
  resident bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.hw import HardwareModel
from repro_torch.core.plan import DataflowPlan
from repro_torch.core.reuse import ForwardLeg, forward_resident_bytes

from .graph import PipelineEdge, PipelineGraph


@dataclass(frozen=True)
class ForwardSpec:
    """The priced realization of one forwarded edge for one candidate pair:
    the mismatch axes the re-shuffle leg crosses and the per-core bytes the
    resident intermediate occupies on each side."""
    edge: PipelineEdge
    shuffle_axes: Tuple[str, ...]
    resident_bytes: int                 # per producer core, while live
    aligned: bool                       # True = zero-shuffle handoff

    def send_leg(self) -> ForwardLeg:
        return ForwardLeg(self.edge.tensor, "send")

    def recv_leg(self) -> ForwardLeg:
        return ForwardLeg(self.edge.tensor, "recv", self.shuffle_axes)


def _digit_mismatch_axes(store_map, load_map, hw: HardwareModel
                         ) -> Tuple[str, ...]:
    """Hardware axes whose spatial-digit coefficients differ between the
    producer's rewritten store map and the consumer's rewritten load map on
    any tile-grid coordinate — the axes the re-shuffle leg must cross."""
    mism = []
    for a, _ in hw.mesh_dims:
        for pe, ce in zip(store_map.exprs, load_map.exprs):
            if pe.coeff_of(a) != ce.coeff_of(a):
                mism.append(a)
                break
    return tuple(mism)


def forward_spec(graph: PipelineGraph, edge: PipelineEdge,
                 producer: DataflowPlan, consumer: DataflowPlan,
                 hw: HardwareModel) -> Optional[ForwardSpec]:
    """The forwarding realization of ``edge`` for one candidate plan pair,
    or ``None`` when the pair is not forwardable (see module docstring for
    the legality rules).  Capacity against each side's working buffers is
    checked here; the *joint* capacity across several simultaneously-live
    edges is the co-planner's job."""
    store = graph.edge_store(edge, producer.program)
    load = graph.edge_load(edge, consumer.program)
    if store.tile_shape != load.tile_shape:
        return None                     # different tile grids: re-tiling
    for s in producer.stores:
        if s.access.tensor.name == edge.tensor and s.reduce_axes:
            return None                 # partial-sum combine owns the store
    for c in consumer.loads:
        if c.access.tensor.name == edge.tensor and c.bcast_axes:
            return None                 # multicast loads source from DRAM
    p_map = producer.mapping.rewrite_access(store)
    c_map = consumer.mapping.rewrite_access(load)
    shuffle = _digit_mismatch_axes(p_map, c_map, hw)
    resident = forward_resident_bytes(store, producer.mapping)
    cap = hw.local_capacity()
    if producer.buffer_bytes() + resident > cap:
        return None
    if consumer.buffer_bytes() + resident > cap:
        return None
    return ForwardSpec(edge=edge, shuffle_axes=shuffle,
                       resident_bytes=resident, aligned=not shuffle)


def node_legs(graph: PipelineGraph, node: str,
              specs: Dict[Tuple[str, str, str], Optional[ForwardSpec]],
              forwarded: Dict[Tuple[str, str, str], bool]
              ) -> Dict[str, ForwardLeg]:
    """The ``fwd`` leg map one node's simulation needs, given the per-edge
    forwarding decisions (keys are ``(src, dst, tensor)`` triples)."""
    legs: Dict[str, ForwardLeg] = {}
    for e in graph.out_edges(node):
        key = (e.src, e.dst, e.tensor)
        spec = specs.get(key)
        if spec is not None and forwarded.get(key):
            legs[e.tensor] = spec.send_leg()
    for e in graph.in_edges(node):
        key = (e.src, e.dst, e.tensor)
        spec = specs.get(key)
        if spec is not None and forwarded.get(key):
            legs[e.tensor] = spec.recv_leg()
    return legs


def free_legs(graph: PipelineGraph, node: str) -> Dict[str, ForwardLeg]:
    """Zero-cost legs for every edge tensor of ``node`` — the admissible
    floor the graph branch-and-bound simulates against (any realizable
    edge handling prices these accesses at >= 0 on every resource)."""
    legs: Dict[str, ForwardLeg] = {}
    for e in graph.out_edges(node) + graph.in_edges(node):
        legs[e.tensor] = ForwardLeg(e.tensor, "free")
    return legs
