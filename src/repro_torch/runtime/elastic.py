"""Elastic scaling: re-plan + reshard when the device set changes.

Counterpart of ``repro/runtime/elastic.py``.  The TileLoom thesis applied to
cluster operations: a mapping is a *compiled decision*, so losing a node (or
gaining one) is handled by (1) re-running the mesh planner for the surviving
device set, (2) restoring the latest checkpoint resharded onto the new mesh
(checkpoints are stored fully gathered, so any mesh shape can load them),
(3) resuming — the data pipeline is deterministic in (seed, step) so no
input state moves.

``plan_rescale`` is pure (testable without devices); ``apply_rescale``
keeps each rank's slice of a gathered, host-resident tree under the new
shardings (what the reference's ``jax.device_put`` does).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.hw import HardwareModel
from repro_torch.models.api import ModelAPI
from repro_torch.parallel.planner_bridge import MeshPlanResult, plan_mesh
from repro_torch.parallel.sharding import is_sharding_leaf, tree_map_axes


@dataclass
class RescalePlan:
    old_devices: int
    new_devices: int
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    plan_name: str
    batch_note: str
    ranking: List[MeshPlanResult]


def viable_mesh_shapes(n_devices: int) -> List[Tuple[int, int]]:
    """(data, model) factorizations, squarest first."""
    out = []
    for d in range(1, n_devices + 1):
        if n_devices % d == 0:
            out.append((d, n_devices // d))
    out.sort(key=lambda dm: abs(math.log(dm[0] / dm[1])))
    return out


def plan_rescale(api: ModelAPI, shape: ShapeConfig, tcfg: TrainConfig, *,
                 old_devices: int, new_devices: int,
                 hw: Optional[HardwareModel] = None) -> RescalePlan:
    """Choose mesh shape + sharding plan for the new device count.  Keeps the
    global batch when divisible; otherwise documents the adjustment (exact
    reproducibility of the loss curve requires fixed global batch).  The
    plan is ranked on ``hw`` (default: the planner's H100 cluster)."""
    shapes = viable_mesh_shapes(new_devices)
    best = shapes[0]
    note = ""
    if shape.global_batch % best[0] != 0:
        for cand in shapes:
            if shape.global_batch % cand[0] == 0:
                best = cand
                break
        else:
            note = (f"global_batch {shape.global_batch} not divisible by any "
                    f"data-axis choice of {new_devices} devices; batch "
                    f"padding required")
    ranking = plan_mesh(api, shape, tcfg, multi_pod=False, hw=hw)
    return RescalePlan(
        old_devices=old_devices, new_devices=new_devices,
        mesh_shape=best, mesh_axes=("data", "model"),
        plan_name=ranking[0].plan.name if ranking else "megatron_tp",
        batch_note=note, ranking=ranking)


def apply_rescale(tree, shardings, device=None) -> Any:
    """Each rank's slice of a (restored, host-resident, fully gathered) tree
    under the new ``shardings`` (a matching tree of ``Sharding``; a None
    sharding keeps its leaf as it is), as a contiguous tensor on ``device``
    (default: the leaf's own)."""
    def one(s, x):
        if s is None:
            return x
        out = s.local(torch.as_tensor(x))
        return out.to(device=device, copy=True, memory_format=torch.contiguous_format)
    return tree_map_axes(one, shardings, tree, is_leaf=is_sharding_leaf)
