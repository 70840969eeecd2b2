"""Plan sanitizer: structural checks run before any cached plan is served.

A plan-cache entry is attacker-free but not failure-free: a torn write, a
bit-flipped disk block, or an entry produced by a buggy build can
deserialize into a :class:`~repro_torch.core.plan.DataflowPlan` that is
syntactically valid JSON yet semantically unrunnable — binds to mesh dims
the hardware doesn't have, tile footprints that overflow L1, mappings that
land waves on disabled cores.  :func:`validate_plan` is the gate the cache
(and the plan service's shape-family rung) runs before serving any plan it
did not just compute; a non-empty violation list quarantines the entry
(``PlanCacheStore.quarantine``) instead of handing the runtime a plan that
will fail at lowering or, worse, on hardware.

The checks are deliberately permissive about *provenance*: a plan computed
for a logical submesh of ``hw`` (the degraded-mesh ladder's rung-4 results
are cached under the full degraded fabric's key) binds fewer/smaller dims
than the mesh has, which is fine — only binds that *exceed* the hardware,
or fault conflicts on the exact model the plan was computed for, are
violations.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.hw import HardwareModel
from repro_torch.core.plan import DataflowPlan


def dram_residency_bytes(plan: DataflowPlan) -> int:
    """The plan's resident DRAM footprint: total bytes of the distinct
    global tensors it loads or stores.  Per-plan this is bounded by
    ``hw.global_mem`` trivially on today's workloads; the multi-tenant
    isolation validator sums it across co-located tenants, whose tensors
    share one physical DRAM — the joint fit is the constraint a
    single-tenant sanitizer can never see."""
    seen = {}
    for acc in plan.program.loads + plan.program.stores:
        seen[acc.tensor.name] = acc.tensor.bytes
    return sum(seen.values())


def validate_plan(plan: DataflowPlan, hw: HardwareModel) -> List[str]:
    """Return the list of structural violations (empty = plan is servable).

    Never raises: an exception inside a check is itself reported as a
    violation, so a malformed plan can't crash the serving path it was
    supposed to protect.
    """
    try:
        return _validate(plan, hw)
    except Exception as e:  # noqa: BLE001 — the gate must not throw
        return [f"validator error: {e!r}"]


def _validate(plan: DataflowPlan, hw: HardwareModel) -> List[str]:
    bad: List[str] = []
    mapping = plan.mapping
    prog = plan.program

    # -- program contract (undeclared access dims, nonpositive extents) ----
    try:
        prog.validate()
    except ValueError as e:
        bad.append(f"program: {e}")
        return bad                     # everything below reads the dims

    dims = {d.name for d in prog.grid_dims} | {d.name for d in prog.seq_dims}
    mesh = dict(hw.mesh_dims)

    # -- spatial binds: inside the hardware mesh, over declared dims -------
    seen_hw = set()
    for b in mapping.spatial:
        if b.hw_dim not in mesh:
            bad.append(f"bind {b.grid_dim}->{b.hw_dim}: unknown hw dim")
            continue
        if b.hw_size < 1 or b.hw_size > mesh[b.hw_dim]:
            bad.append(f"bind {b.grid_dim}->{b.hw_dim}: size {b.hw_size} "
                       f"outside mesh dim of {mesh[b.hw_dim]}")
        if b.hw_dim in seen_hw:
            bad.append(f"hw dim {b.hw_dim} bound twice")
        seen_hw.add(b.hw_dim)
        if b.grid_dim not in dims:
            bad.append(f"bind {b.grid_dim}->{b.hw_dim}: undeclared loop dim")

    # -- temporal loops: declared grid dims, positive extents --------------
    for t in mapping.temporal:
        if t.grid_dim not in dims:
            bad.append(f"temporal {t.name}: undeclared dim {t.grid_dim}")
        if t.extent < 1:
            bad.append(f"temporal {t.name}: extent {t.extent}")

    # -- tile shapes: rank-matched, positive, L1-sized blocks --------------
    cap = hw.local_capacity()
    for acc in prog.loads + prog.stores:
        if len(acc.tile_shape) != len(acc.tensor.shape):
            bad.append(f"{acc.label()}: tile rank {len(acc.tile_shape)} vs "
                       f"tensor rank {len(acc.tensor.shape)}")
        if any(s < 1 for s in acc.tile_shape):
            bad.append(f"{acc.label()}: nonpositive tile shape "
                       f"{acc.tile_shape}")
        elif acc.tile_bytes > cap:
            bad.append(f"{acc.label()}: single tile "
                       f"({acc.tile_bytes} B) exceeds L1 ({cap} B)")

    if bad:
        return bad

    # -- residency: the full double-buffered footprint fits L1 -------------
    footprint = plan.buffer_bytes()
    if footprint > cap:
        bad.append(f"residency: footprint {footprint} B exceeds L1 {cap} B")

    # -- fault overlay: only meaningful for plans computed on this model ---
    # (a submesh plan cached under the degraded fabric's key renumbers
    # coordinates, so the conflict test would misfire on it)
    if mapping.hw_name == hw.name and hw.is_degraded \
            and mapping.conflicts_with_faults(hw):
        bad.append("fault conflict: mapping activates disabled cores")
    return bad
