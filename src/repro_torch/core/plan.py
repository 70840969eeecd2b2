"""Dataflow-aware plan representation (paper Listing 5).

A :class:`DataflowPlan` fixes everything the planner decides: the
spatiotemporal mapping, plus one :class:`~repro_torch.core.reuse.MemOpChoice` per
load (broadcast pattern + hoist point) and the derived store placements.  It
is the Python analogue of the paper's "dataflow-aware MLIR": loop nest +
annotated memory operations bound to concrete ``df`` resources.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .hw import HardwareModel
from .mapping import Mapping
from .reuse import (MemOpChoice, StorePlacement, analyze_reuse,
                    buffer_footprint_bytes, store_placement)


@dataclass(frozen=True)
class DataflowPlan:
    mapping: Mapping
    loads: Tuple[MemOpChoice, ...]
    stores: Tuple[StorePlacement, ...]

    @property
    def program(self):
        return self.mapping.program

    def buffer_bytes(self) -> int:
        return buffer_footprint_bytes(self.loads, self.stores, self.mapping)

    def describe(self) -> str:
        parts = [self.mapping.describe()]
        for c in self.loads:
            tag = "+".join(c.bcast_axes) if c.bcast_axes else "global"
            parts.append(f"{c.access.tensor.name}:{tag}@L{c.hoist.level}")
        return " ".join(parts)

    def mlir_like(self, hw: HardwareModel) -> str:
        """Render in the paper's Listing-5 style: the mapped loop nest with
        per-level alloc/load annotations."""
        loops: List[Tuple[str, str, int]] = []
        for b in self.mapping.spatial:
            loops.append(("parallel", b.hw_dim, b.hw_size))
        n_par = len(loops)
        for t in self.mapping.temporal:
            loops.append(("for", t.name, t.extent))
        for name, ext in self.mapping.seq_loops():   # per-core split extents
            loops.append(("for", name, ext))
        by_level: Dict[int, List[str]] = {}
        for c in self.loads:
            ann = c.annotate(hw)
            alloc = (f"alloc {c.access.tensor.name} "
                     f"{{target_buffer=%{hw.local_mem.name}, "
                     f"size={c.hoist.footprint_tiles * c.access.tile_bytes}}}")
            by_level.setdefault(c.hoist.level, []).extend([alloc, ann])
        store_lines: Dict[int, List[str]] = {}
        for s in self.stores:
            if s.reduce_axes:
                axes = ", ".join(f"%{a}" for a in s.reduce_axes)
                ann = (f"store {s.access.tensor.name} "
                       f"{{type=\"reduce_{s.reduce_style}\", "
                       f"axes={{{axes}}}}}")
            else:
                ann = f"store {s.access.tensor.name} {{type=\"global\"}}"
            store_lines.setdefault(s.level, []).append(ann)
        lines: List[str] = []
        indent = ""
        # emit loops; memory-op level L sits just inside the L-th temporal loop
        lvl = 0
        for kind, name, ext in loops:
            if kind == "parallel":
                lines.append(f"{indent}affine.parallel (%{name}) = 0 to {ext} {{")
            else:
                for text in by_level.get(lvl, []):
                    lines.append(f"{indent}{text}")
                lines.append(f"{indent}affine.for %{name} = 0 to {ext} {{")
                lvl += 1
            indent += "  "
        for text in by_level.get(lvl, []):
            lines.append(f"{indent}{text}")
        for op in self.program.body:
            lines.append(f"{indent}linalg.{op.kind} ...")
        for s_lvl in sorted(store_lines, reverse=True):
            for text in store_lines[s_lvl]:
                lines.append(f"{indent}{text}")
        while indent:
            indent = indent[:-2]
            lines.append(f"{indent}}}")
        return "\n".join(lines)


def make_plan(mapping: Mapping, loads: Sequence[MemOpChoice],
              hw: HardwareModel) -> DataflowPlan:
    infos = analyze_reuse(mapping, hw)
    stores = tuple(store_placement(i, mapping)
                   for i in infos if i.access.kind == "store")
    return DataflowPlan(mapping, tuple(loads), stores)
