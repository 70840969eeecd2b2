"""Warm-starting the block-shape search from the nearest cached plan.

On a cache miss the planner still has to search, but the cache usually
holds a plan for the *same kernel template at a different shape* (e.g. the
4096-cubed GEMM when the miss is the 8192-cubed one).  The winning block
shape is strongly shape-correlated, so we seed the candidate ranking by
reordering the program list: candidates whose per-tensor tile shapes are
closest to the cached winner's come first.  Combined with
``SearchBudget.max_programs`` (the fast-search program cap) this turns the
neighbor into a real search-space prior instead of just a tie-break.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.program import TileProgram


def tile_signature(program: TileProgram) -> Dict[str, List[int]]:
    """tensor name -> tile shape of its load/store; what a cache entry
    records about the winning block shape (``meta["tiles"]``)."""
    out: Dict[str, List[int]] = {}
    for a in program.loads + program.stores:
        out[a.tensor.name] = [int(s) for s in a.tile_shape]
    return out


def tile_distance(program: TileProgram,
                  hint_tiles: Mapping[str, Sequence[int]]) -> float:
    """Log-space distance between a candidate program's tile shapes and the
    hinted winner's, summed over the tensors they share."""
    getter = getattr(hint_tiles, "get", None)
    if getter is None:               # corrupt meta (list, scalar, ...)
        return float("inf")
    d = 0.0
    matched = 0
    for name, tile in tile_signature(program).items():
        hint = getter(name)
        if not isinstance(hint, (list, tuple)) or len(hint) != len(tile):
            continue
        try:
            hint = [int(h) for h in hint]
        except (TypeError, ValueError):
            continue
        matched += 1
        for x, y in zip(tile, hint):
            d += abs(math.log2(max(1, x) / max(1, y)))
    return d if matched else float("inf")


def order_programs(programs: Sequence[TileProgram],
                   hint_tiles: Optional[Mapping[str, Sequence[int]]]
                   ) -> List[TileProgram]:
    """Stable-sort candidate programs by proximity to the hinted tiles.
    With no usable hint — ``None``, empty, a corrupt non-mapping, zero or
    one candidates — the original order is preserved and nothing raises."""
    programs = list(programs)
    if len(programs) < 2 or not hint_tiles:
        return programs
    try:
        return sorted(programs, key=lambda p: tile_distance(p, hint_tiles))
    except Exception:  # noqa: BLE001 — ordering is a hint, never a failure
        return programs


def warm_order_from_store(store, template: str, hw_digest: str,
                          shape: Sequence[int],
                          programs: Sequence[TileProgram]
                          ) -> List[TileProgram]:
    """The full warm-start policy: find the nearest same-template entry on
    the same hardware, extract its winning tiles, record the warm-start in
    the store's stats, and reorder the candidates.  Both integration points
    (``PlanCache.order_programs`` and the ``lower_jax`` block tables) go
    through here so the policy has one implementation."""
    programs = list(programs)
    if not programs:
        return programs
    try:
        hint = store.nearest(template, hw_digest, shape)
    except Exception:  # noqa: BLE001 — an empty/corrupt store is not an error
        return programs
    if hint is None:
        return programs
    meta = hint.get("meta")
    payload = hint.get("payload")
    tiles = (meta.get("tiles") if isinstance(meta, Mapping) else None) or \
        (payload.get("tiles") if isinstance(payload, Mapping) else None)
    if not isinstance(tiles, Mapping) or not tiles:
        return programs
    store.note_warm_start()
    return order_programs(programs, tiles)
