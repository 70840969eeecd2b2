# Kernel-graph pipeline planning: co-plan chained tile programs with
# on-chip tile forwarding between kernels (DESIGN_PIPELINE.md).
#
# graph.py       — PipelineGraph IR (nodes = TileProgram candidate pools,
#                  edges = named intermediate tensors) + benchmark builders
# forwarding.py  — inter-kernel reuse analysis: forwarding legality,
#                  spatial-digit compatibility, re-shuffle axes, residency
# cost.py        — fused two-phase graph simulation + DRAM handoff terms
# planner.py     — per-node pools + exact graph branch-and-bound composition
from .graph import (PipelineEdge, PipelineGraph, PipelineNode,
                    attn_qk_pv_graph, graph_from_spec, mlp2_graph,
                    moe_ffn_graph)
from .forwarding import ForwardSpec, forward_spec, free_legs, node_legs
from .cost import GraphSim, edge_dram_roundtrip_s, simulate_nodes
from .planner import EdgeDecision, GraphPlan, plan_pipeline

__all__ = [
    "PipelineEdge", "PipelineGraph", "PipelineNode",
    "attn_qk_pv_graph", "graph_from_spec", "mlp2_graph", "moe_ffn_graph",
    "ForwardSpec", "forward_spec", "free_legs", "node_legs",
    "GraphSim", "edge_dram_roundtrip_s", "simulate_nodes",
    "EdgeDecision", "GraphPlan", "plan_pipeline",
]
