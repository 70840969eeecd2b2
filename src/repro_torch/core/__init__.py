# TileLoom core: the paper's primary contribution — automatic dataflow
# planning for tile-based programs on spatial dataflow architectures.
#
# Pipeline (paper Fig 2):  program.py (front-end IR)  ->  mapping.py (S2.2)
# -> reuse.py (S2.3) -> plan.py (dataflow-aware IR) -> perfmodel.py (S2.5)
# -> planner.py (two-step top-k selection; simulator.py plays the hardware
# profiling stage) -> lower_jax.py (back-end handoff).
from .affine import AffineExpr, AffineMap, footprint_tiles
from .hw import (HardwareModel, MatUnit, Memory, VecUnit, get_hw, tpu_v5e_chip,
                 tpu_v5e_pod, wormhole, spyre_triple_ring, PRESETS)
from .mapping import Mapping, SpatialBind, TemporalLoop, enumerate_mappings
from .perfmodel import (BoundContext, PlanCost, body_compute_seconds, estimate,
                        pipelined_loop_time, plan_lower_bound)
from .plan import DataflowPlan, make_plan
from .batch_cost import HAVE_NUMPY, MappingBatch, simulate_plans
from .planner import (Candidate, PlanResult, SearchBudget, effective_budget,
                      fast_search_enabled, iter_plan_stream, plan_kernel,
                      plan_kernel_multi, resolve_engine)
from .program import (LoopDim, TensorSpec, TileAccess, TileOp, TileProgram,
                      block_shape_candidates, flash_attention_program,
                      flash_decode_program, fused_matmul_program,
                      matmul_program, moe_gmm_program, qk_matmul_program,
                      softmax_pv_program)
from .reuse import (ForwardLeg, HoistOption, MemOpChoice, ReuseInfo,
                    analyze_reuse, broadcast_options, edge_forward_demand,
                    enumerate_memop_choices, forward_resident_bytes,
                    memop_choices_with_stores, memop_demand, hoist_options)
from .simulator import SimResult, simulate, simulate_reference
from . import templates

__all__ = [
    "AffineExpr", "AffineMap", "footprint_tiles",
    "HardwareModel", "MatUnit", "Memory", "VecUnit", "get_hw", "PRESETS",
    "tpu_v5e_chip", "tpu_v5e_pod", "wormhole", "spyre_triple_ring",
    "Mapping", "SpatialBind", "TemporalLoop", "enumerate_mappings",
    "BoundContext", "PlanCost", "body_compute_seconds", "estimate",
    "pipelined_loop_time", "plan_lower_bound",
    "DataflowPlan", "make_plan",
    "Candidate", "PlanResult", "SearchBudget", "effective_budget",
    "fast_search_enabled", "iter_plan_stream", "plan_kernel",
    "plan_kernel_multi", "resolve_engine",
    "HAVE_NUMPY", "MappingBatch", "simulate_plans",
    "LoopDim", "TensorSpec", "TileAccess", "TileOp", "TileProgram",
    "block_shape_candidates", "flash_attention_program",
    "flash_decode_program", "fused_matmul_program", "matmul_program",
    "moe_gmm_program", "qk_matmul_program", "softmax_pv_program",
    "ForwardLeg", "HoistOption", "MemOpChoice", "ReuseInfo", "analyze_reuse",
    "broadcast_options", "edge_forward_demand", "enumerate_memop_choices",
    "forward_resident_bytes", "memop_choices_with_stores", "memop_demand",
    "hoist_options",
    "SimResult", "simulate", "simulate_reference", "templates",
]
