"""Quickstart: plan a GEMM with TileLoom on the paper's Wormhole target, and
watch the two-step selection at work.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.core import (SearchBudget, block_shape_candidates, estimate,
                        get_hw, matmul_program, plan_kernel_multi, simulate,
                        templates)

hw = get_hw("wormhole_8x8")
print("=== hardware (df dialect, paper S2.4) ===")
print(hw.df_text())

M = N = K = 2048
# front-end block-shape exploration (paper S2.1) + dataflow planning
progs = [matmul_program(M, N, K, bm=bm, bn=bn, bk=bk)
         for bm, bn, bk in block_shape_candidates(M, N, K)]
res = plan_kernel_multi(progs, hw, budget=SearchBudget(top_k=5))
print("\n=== TileLoom two-step selection ===")
print(res.summary())
print("\n=== chosen dataflow (paper Listing 5 style) ===")
print(res.best.plan.mlir_like(hw))

print("\n=== vs vendor templates ===")
for name, mk in (("TT-1D", templates.tt1d_matmul_plan),
                 ("TT-2D", templates.tt2d_matmul_plan),
                 ("TTNN", templates.ttnn_matmul_plan)):
    t = simulate(mk(M, N, K, hw), hw)
    print(f"{name:6s}: {t.total_s * 1e6:8.1f} us  ({t.tflops:5.1f} TFLOP/s)")
best = res.best.sim
print(f"TL    : {best.total_s * 1e6:8.1f} us  ({best.tflops:5.1f} TFLOP/s)")

# -- pipeline co-planning: a 2-GEMM graph with on-chip forwarding -----------
# Chained kernels planned in isolation pay a DRAM store + reload for every
# producer->consumer intermediate.  The kernel-graph planner (repro.pipeline,
# DESIGN_PIPELINE.md) co-plans the chain and decides per edge whether the
# intermediate is *forwarded* through the distributed L1s or *spilled*.
from repro_torch.pipeline import mlp2_graph, plan_pipeline

print("\n=== pipeline co-planning: 2-GEMM MLP (Y = X@W1; Z = Y@W2) ===")
graph = mlp2_graph(M=8192, d_model=128, d_ff=512)
gp = plan_pipeline(graph, hw, budget=SearchBudget(top_k=4))
for d in gp.decisions:
    print(f"edge {d.describe()}")
print(f"co-planned end-to-end:   {gp.total_s * 1e6:8.1f} us")
print(f"independent + DRAM trip: {gp.baseline_s * 1e6:8.1f} us "
      f"({gp.improvement:.2f}x)")
