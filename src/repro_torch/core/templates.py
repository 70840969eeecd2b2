"""Vendor-library baselines (paper S3.2).

TTNN chooses between two hand-written dataflow templates:

* **TT-1D** — the output grid is flattened 1D across all cores; the smaller
  input matrix is loaded per-core from global memory while the other input is
  broadcast across the *entire* array.
* **TT-2D** — both inputs are streamed across the mesh systolically: A tiles
  broadcast along rows, B tiles along columns (output-stationary 2D dataflow).

plus a fixed block-size heuristic.  TTNN's selector between the two is a
shape-based rule.  We reimplement all three as fixed :class:`DataflowPlan`
constructors over our IR so the paper's Fig 5/6 comparisons can be reproduced;
the selector rule below is a documented stand-in for Tenstorrent's proprietary
strategy (DESIGN.md S4) and mirrors its published behaviour: 2D for large
balanced shapes, 1D otherwise.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from .hw import HardwareModel
from .mapping import Mapping, SpatialBind, TemporalLoop
from .plan import DataflowPlan, make_plan
from .program import TileProgram, matmul_program, flash_attention_program
from .reuse import (HoistOption, MemOpChoice, analyze_reuse, hoist_options,
                    buffer_footprint_bytes, store_placement)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def vendor_block_shape(M: int, N: int, K: int, hw: HardwareModel,
                       dtype_bytes: int = 2, *,
                       fill: Optional[Tuple[int, int]] = None
                       ) -> Tuple[int, int, int]:
    """Fixed vendor-style block heuristic: the largest square-ish power-of-two
    tile (multiple of the 32x32 hardware tile) such that A+B double-buffered
    plus the C accumulator fit in L1 — additionally capped so the output grid
    fills the core array (``fill=(cores_m, cores_n)``), which is what TTNN's
    block-size strategy ensures."""
    cap = hw.local_capacity()
    fm, fn = fill or (1, 1)
    best = (32, 32, 32)
    for b in (32, 64, 128, 256):
        bm = bn = b
        bk = min(b, 64)
        need = (2 * (bm * bk + bk * bn) * dtype_bytes
                + bm * bn * 4 + bm * bn * dtype_bytes)
        if need > cap:
            continue
        if bm > max(32, M // max(1, fm)) or bn > max(32, N // max(1, fn)):
            continue
        best = (bm, bn, bk)
    return best


def _mapping_2d(prog: TileProgram, hw: HardwareModel) -> Mapping:
    """gx -> x, gy -> y (the natural 2D output-stationary assignment)."""
    (ax, sx), (ay, sy) = hw.mesh_dims[0], hw.mesh_dims[-1]
    gx, gy = prog.grid_dims[0].name, prog.grid_dims[1].name
    spatial = (SpatialBind(ax, sx, gx), SpatialBind(ay, sy, gy))
    temporal = []
    for d, sf in ((prog.grid_dims[0], sx), (prog.grid_dims[1], sy)):
        ext = _ceil(d.extent, sf)
        if ext > 1:
            temporal.append(TemporalLoop(f"t_{d.name}", d.name, ext))
    return Mapping(prog, hw.name, hw.mesh_dims, spatial, tuple(temporal))


def _mapping_1d(prog: TileProgram, hw: HardwareModel,
                flat_dim: str) -> Mapping:
    """Flatten the whole mesh onto one grid dim (TT-1D's core order)."""
    spatial = tuple(SpatialBind(a, s, flat_dim) for a, s in hw.mesh_dims)
    sf = math.prod(s for _, s in hw.mesh_dims)
    temporal = []
    for d in prog.grid_dims:
        f = sf if d.name == flat_dim else 1
        ext = _ceil(d.extent, f)
        if ext > 1:
            temporal.append(TemporalLoop(f"t_{d.name}", d.name, ext))
    return Mapping(prog, hw.name, hw.mesh_dims, spatial, tuple(temporal))


def _choice(mapping: Mapping, hw: HardwareModel, tensor_name: str,
            bcast_axes: Tuple[str, ...], hoist_dependent_crossings: int = 0
            ) -> MemOpChoice:
    infos = {i.access.tensor.name: i for i in analyze_reuse(mapping, hw)
             if i.access.kind == "load"}
    info = infos[tensor_name]
    # filter requested broadcast axes down to the legally reusable ones
    legal = tuple(a for a in bcast_axes if a in info.spatial_axes)
    opts = hoist_options(info, mapping)
    idx = min(hoist_dependent_crossings, len(opts) - 1)
    return MemOpChoice(info.access, legal, opts[idx])


def tt1d_matmul_plan(M: int, N: int, K: int, hw: HardwareModel,
                     dtype_bytes: int = 2) -> DataflowPlan:
    n_cores = math.prod(s for _, s in hw.mesh_dims)
    # flatten cores over the output dim of the larger operand; broadcast the
    # smaller operand to the whole array
    a_bytes, b_bytes = M * K, K * N
    if a_bytes >= b_bytes:
        flat, bcast_tensor = "gx", "B"
        fill = (n_cores, 1)
    else:
        flat, bcast_tensor = "gy", "A"
        fill = (1, n_cores)
    bm, bn, bk = vendor_block_shape(M, N, K, hw, dtype_bytes, fill=fill)
    prog = matmul_program(M, N, K, bm=bm, bn=bn, bk=bk, dtype_bytes=dtype_bytes,
                          name="tt1d_matmul")
    mapping = _mapping_1d(prog, hw, flat)
    axes = tuple(a for a, _ in hw.mesh_dims)
    loads = (
        _choice(mapping, hw, "A",
                axes if bcast_tensor == "A" else ()),
        _choice(mapping, hw, "B",
                axes if bcast_tensor == "B" else ()),
    )
    return make_plan(mapping, loads, hw)


def tt2d_matmul_plan(M: int, N: int, K: int, hw: HardwareModel,
                     dtype_bytes: int = 2) -> DataflowPlan:
    bm, bn, bk = vendor_block_shape(M, N, K, hw, dtype_bytes)
    prog = matmul_program(M, N, K, bm=bm, bn=bn, bk=bk, dtype_bytes=dtype_bytes,
                          name="tt2d_matmul")
    mapping = _mapping_2d(prog, hw)
    ax = mapping.spatial[0].hw_dim        # bound to gx
    ay = mapping.spatial[1].hw_dim        # bound to gy
    # A[gx,k] is identical along the gy-axis -> broadcast along ay (rows);
    # B[k,gy] identical along the gx-axis -> broadcast along ax (cols).
    loads = (
        _choice(mapping, hw, "A", (ay,)),
        _choice(mapping, hw, "B", (ax,)),
    )
    return make_plan(mapping, loads, hw)


def ttnn_matmul_plan(M: int, N: int, K: int, hw: HardwareModel,
                     dtype_bytes: int = 2) -> DataflowPlan:
    """TTNN's fixed selector (documented stand-in, see module docstring):
    prefer the 2D systolic template when both output dims can fill the mesh
    and the shape is balanced; otherwise fall back to 1D."""
    rows = hw.mesh_dims[0][1]
    cols = hw.mesh_dims[-1][1]
    bm, bn, _ = vendor_block_shape(M, N, K, hw, dtype_bytes)
    fills_2d = (M >= rows * bm) and (N >= cols * bn)
    balanced = max(M, N) <= 8 * min(M, N)
    if fills_2d and balanced and rows > 1 and cols > 1:
        return tt2d_matmul_plan(M, N, K, hw, dtype_bytes)
    return tt1d_matmul_plan(M, N, K, hw, dtype_bytes)


def ttnn_flash_plan(batch_heads: int, seq_q: int, seq_kv: int, head_dim: int,
                    hw: HardwareModel, dtype_bytes: int = 2) -> DataflowPlan:
    """TTNN-like FlashAttention mapping: heads/queries flattened across cores,
    every core streams K/V directly from DRAM each iteration (the paper:
    "TTNN's default mapping ... repeatedly reloads these operands from
    DRAM")."""
    bq = 64 if seq_q >= 64 else 32
    bkv = 64 if seq_kv >= 64 else 32
    prog = flash_attention_program(batch_heads, seq_q, seq_kv, head_dim,
                                   bq=bq, bkv=bkv, dtype_bytes=dtype_bytes,
                                   name="ttnn_flash")
    mapping = _mapping_1d(prog, hw, "h")
    loads = (
        _choice(mapping, hw, "Q", ()),
        _choice(mapping, hw, "K", ()),
        _choice(mapping, hw, "V", ()),
    )
    return make_plan(mapping, loads, hw)
