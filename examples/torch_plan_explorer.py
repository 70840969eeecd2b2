"""Mesh-plan explorer on the PyTorch/CUDA port: how TileLoom picks sharding
layouts per (arch, shape) for a cluster of H100s.

    PYTHONPATH=src python examples/torch_plan_explorer.py [arch ...]

The plans are ranked on the port's default cluster
(``core.lower_torch.h100_cluster()``: 32 nodes of 8 H100s, NVLink within a
node and InfiniBand between nodes), so the choices and their estimates are
the H100 cluster's, not those of the TPU pod the reference example ranks on.
"""
import sys

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import TrainConfig
from repro_torch.models import build_model
from repro_torch.parallel.planner_bridge import plan_mesh, tileloom_view

archs = sys.argv[1:] or ["qwen2.5-3b", "llama3-405b", "qwen3-moe-30b-a3b",
                         "rwkv6-3b"]
tcfg = TrainConfig(microbatches=4, opt_state_dtype="bfloat16")
for arch in archs:
    api = build_model(ARCHS[arch])
    print(f"\n=== {arch} ({api.n_params():,} params) ===")
    for shp in ("train_4k", "prefill_32k", "decode_32k"):
        ranked = plan_mesh(api, SHAPES[shp], tcfg)
        top = ranked[0]
        print(f"{shp:12s} -> {top.plan.name:18s} "
              f"dominant={top.cost.dominant:10s} "
              f"est={top.cost.total_s * 1e3:9.2f} ms/step "
              f"hbm={top.cost.hbm_bytes_per_chip / 1e9:5.1f} GB/chip")
    print("TileLoom view of the chosen train plan:")
    print(tileloom_view(plan_mesh(api, SHAPES['train_4k'], tcfg)[0].plan,
                        api.cfg))
