"""Wave-accurate machine simulator — the "profile on hardware" stage.

The paper's two-step selection ranks candidates with the coarse analytic model
and then *profiles the top-k on real hardware*.  This container has no
Tenstorrent card, so the profiling stage is played by this simulator, which is
deliberately **higher-fidelity than the ranking model** so the two-step flow
stays non-circular (see DESIGN.md S4):

analytic model (perfmodel.py)           simulator (this file)
--------------------------------------  -----------------------------------------
aggregate bandwidth pools               per-DRAM-channel and per-NoC-ring
                                        contention, resolved per wave
waves folded into closed-form loops     every wave accounted for; ragged final
                                        waves and partially-active meshes cost
                                        real time
no launch cost                          per-wave dispatch/barrier overhead
                                        (reproduces the paper's small-shape
                                        degradation, S3.2 / Fig 9)
steady-state pipeline formula           explicit fill/drain per wave, barrier at
                                        wave boundaries (no cross-wave overlap)

The simulator consumes the same :class:`DataflowPlan` and df hardware
description as the model.

Two entry points:

* :func:`simulate` — the fast **wave-equivalence-class** path (exact).  A
  wave's cost is fully determined by (a) the set of cores active in it and
  (b) which temporal indices changed relative to the previous wave (that is
  what triggers hoisted reloads).  Both are functions of a tiny per-wave
  signature, so the full wave space collapses into a handful of equivalence
  classes: each class is costed once and multiplied by its population (see
  DESIGN_SEARCHPERF.md for the argument).  There is no sampling cut — the
  old ``max_waves_exact`` stride decimation is retired.
* :func:`simulate_reference` — the original wave-by-wave loop, kept as the
  oracle for ``tests/test_search_equivalence.py`` (and for its stride-sample
  mode, should anyone want the historical behaviour).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Mapping as TMapping, Optional, Sequence, Tuple

from .hw import HardwareModel
from .perfmodel import body_compute_seconds, pipelined_loop_time
from .plan import DataflowPlan
from .reuse import ForwardLeg, MemOpChoice, StorePlacement


@dataclass(frozen=True)
class SimResult:
    total_s: float
    dram_bytes: float
    noc_bytes: float
    flops: float
    n_waves: int
    wave_overhead_s: float
    n_wave_classes: int = 0       # equivalence classes costed (0 = reference path)

    @property
    def tflops(self) -> float:
        return self.flops / self.total_s / 1e12 if self.total_s > 0 else 0.0


def _core_coords(plan: DataflowPlan) -> List[Dict[str, int]]:
    dims = [(b.hw_dim, b.hw_size) for b in plan.mapping.spatial]
    if not dims:
        return [{}]
    names = [d for d, _ in dims]
    return [dict(zip(names, pt))
            for pt in itertools.product(*[range(s) for _, s in dims])]


def _wave_envs(plan: DataflowPlan) -> List[Dict[str, int]]:
    ts = plan.mapping.temporal
    if not ts:
        return [{}]
    names = [t.name for t in ts]
    return [dict(zip(names, pt))
            for pt in itertools.product(*[range(t.extent) for t in ts])]


def _is_active(plan: DataflowPlan, env: Dict[str, int]) -> bool:
    """A (core, wave) slot is active iff every grid index is in range and,
    under a reduce bind, the core's sequential chunk is non-empty (ragged
    final waves / ragged splits leave cores idle — real cost the model
    ignores)."""
    m = plan.mapping
    for d in m.program.grid_dims:
        idx = m.grid_index_expr(d.name).evaluate(env)
        if idx >= d.extent:
            return False
    for d in m.program.seq_dims:
        if m.reduce_factor(d.name) > 1:
            if m.seq_index_expr(d.name).evaluate({**env, d.name: 0}) \
                    >= d.extent:
                return False
    return True


def _reduce_epilogue_cost(mapping, outer_stores, n_active: int, red_act: int,
                          hw: HardwareModel, dram_bw: float,
                          link_bw: Dict[str, float], *,
                          fwd: Optional[TMapping[str, ForwardLeg]] = None,
                          l1_bw: float = 0.0
                          ) -> Tuple[float, float, float]:
    """Per-wave hoisted-store cost (time, dram bytes, noc bytes), including
    the spatial-reduction epilogue.  ``accum`` read-modify-writes every
    partial through the store path; ``tree``/``chain`` forward partials over
    the axis NoC in per-axis stages (log-depth combining tree vs ``r - 1``
    neighbor hops per stage) and only the owner core stores.  Shared
    verbatim by the wave-class simulator, the reference loop, and the
    vectorized engine so the three stay bit-identical.

    ``fwd`` marks stores riding a forwarded inter-kernel edge (pipeline
    co-planning): a plain forwarded store writes the producing core's L1
    (all cores concurrently: ``tb / l1_bw``) and touches no DRAM; a
    ``free`` leg costs nothing (the graph bound's floor).  Reduce-combining
    stores ignore the leg — the pipeline legality rule spills them."""
    chans = hw.global_channels()
    t = db = nb = 0.0
    for s in outer_stores:
        tb = s.access.tile_bytes
        leg = fwd.get(s.access.tensor.name) if fwd else None
        if leg is not None and not s.reduce_axes:
            if leg.kind != "free":
                t += tb / l1_bw
            continue
        if s.reduce_axes and red_act > 1:
            if s.reduce_style == "accum":
                db += 2.0 * tb * n_active
                t += 2.0 * tb * n_active / (dram_bw * chans)
                continue
            owners = max(1, n_active // red_act)
            planes = n_active
            for a, digits in mapping.reduce_stages():
                if a not in s.reduce_axes:
                    continue
                groups = max(1, planes // digits)
                depth = (math.ceil(math.log2(digits))
                         if s.reduce_style == "tree" else digits - 1)
                ic = hw.interconnect_along(a)
                if ic is not None:
                    t += depth * tb / link_bw[ic.name]
                nb += tb * (digits - 1) * groups
                planes = groups
            t += tb * owners / (dram_bw * chans)
            db += tb * owners
        else:
            db += tb * n_active
            t += tb * n_active / (dram_bw * chans)
    return t, db, nb


# --------------------------------------------------------------------------
# Fast path: wave equivalence classes
# --------------------------------------------------------------------------
# A wave is one point of the temporal loop nest, iterated lexicographically
# (outer loop first — the order _wave_envs produces).  Its cost depends on
# exactly two things:
#
# 1. the **active-core set**: core c is active iff every grid index is in
#    range.  Each grid dim's index is ``t_g * stride + digit(c)``, so per
#    grid dim the active predicate depends only on that dim's own wave value
#    — the overall active set is the intersection of per-loop core masks;
# 2. the **changed-temporal mask**: a load hoisted to level L re-issues when
#    any of the first min(L, n_temporal) temporal indices changed.  In
#    lexicographic iteration the changed positions of a wave are exactly
#    {j..n-1} where j is the wave's last non-zero digit (odometer carry), so
#    "some of the first k loops changed" == (j < k); the first wave changes
#    everything.
#
# Group waves by (per-loop mask, per-loop digit==0) and every member shares
# both ingredients — cost one representative, multiply by the population.

_LoopGroup = Tuple[int, bool, int]          # (core mask, digit == 0, population)


def _loop_digit_groups(plan: DataflowPlan, coords: Sequence[Dict[str, int]],
                       hw: Optional[HardwareModel] = None
                       ) -> Tuple[int, List[List[_LoopGroup]]]:
    """Per temporal loop, group digit values by the core mask they induce
    (keeping value 0 separate — it feeds the odometer-carry bookkeeping).
    Returns (static mask from waveless grid dims, per-loop group lists).

    When ``hw`` carries a fault overlay, its disabled cores are removed
    from the static mask — exactly like a waveless grid dim idling a core
    for the whole kernel — so both wave-class engines (scalar and batch
    call this shared helper) exclude dead cores identically.  Fault-free
    models contribute nothing, keeping the healthy path byte-identical.
    """
    m = plan.mapping
    prog = m.program
    n_cores = len(coords)
    full = (1 << n_cores) - 1
    with_loop = {t.grid_dim for t in m.temporal}

    static_mask = full
    if hw is not None and hw.disabled_cores:
        for i, c in enumerate(coords):
            if hw.is_disabled(c):
                static_mask &= ~(1 << i)
    for d in prog.grid_dims:
        if d.name in with_loop:
            continue
        expr = m.grid_index_expr(d.name)
        mask = 0
        for i, c in enumerate(coords):
            if expr.evaluate(c) < d.extent:
                mask |= 1 << i
        static_mask &= mask
    # reduce binds: cores whose sequential chunk is empty (ragged split)
    # idle for the whole kernel — a static mask, like waveless grid dims
    for d in prog.seq_dims:
        if m.reduce_factor(d.name) <= 1:
            continue
        expr = m.seq_index_expr(d.name)
        mask = 0
        for i, c in enumerate(coords):
            if expr.evaluate({**c, d.name: 0}) < d.extent:
                mask |= 1 << i
        static_mask &= mask

    per_loop: List[List[_LoopGroup]] = []
    for t in m.temporal:
        d = prog.dim(t.grid_dim)
        expr = m.grid_index_expr(t.grid_dim)
        E = t.extent
        agg: Dict[Tuple[int, bool], int] = {}
        exotic = any(e is not None for e in (expr.mod, expr.floordiv))
        if not exotic:
            # grid index = v * stride + digit(core) is monotone in the wave
            # value v, so each core has one threshold T below which it is
            # active; the mask over cores changes at most n_cores times.
            stride = expr.coeff_of(t.name)
            thresholds = []
            for c in coords:
                base = expr.evaluate({**c, t.name: 0})
                if stride <= 0:
                    thresholds.append(E if base < d.extent else 0)
                else:
                    n_active = -(-(d.extent - base) // stride)  # ceil
                    thresholds.append(max(0, min(E, n_active)))
            cuts = sorted({T for T in thresholds if 0 < T < E})
            for lo, hi in zip([0] + cuts, cuts + [E]):
                if hi <= lo:
                    continue
                mask = 0
                for i, T in enumerate(thresholds):
                    if T > lo:
                        mask |= 1 << i
                if lo == 0:
                    agg[(mask, True)] = agg.get((mask, True), 0) + 1
                    if hi > 1:
                        agg[(mask, False)] = agg.get((mask, False), 0) + hi - 1
                else:
                    agg[(mask, False)] = agg.get((mask, False), 0) + hi - lo
        else:  # pragma: no cover - no current grid expr uses mod/floordiv
            for v in range(E):
                mask = 0
                for i, c in enumerate(coords):
                    if expr.evaluate({**c, t.name: v}) < d.extent:
                        mask |= 1 << i
                key = (mask, v == 0)
                agg[key] = agg.get(key, 0) + 1
        per_loop.append([(mask, zero, count)
                         for (mask, zero), count in agg.items()])
    return static_mask, per_loop


def simulate(plan: DataflowPlan, hw: HardwareModel, *,
             launch_overhead_s: float = 20e-6,
             wave_overhead_s: float = 2e-6,
             fwd: Optional[TMapping[str, ForwardLeg]] = None,
             record: Optional[List[dict]] = None) -> SimResult:
    """Simulate plan execution by wave equivalence class (exact).

    For each class: per-core inner-loop time uses the double-buffered pipeline
    with *per-channel* / *per-ring* effective bandwidths resolved from the set
    of cores active in its waves; a wave completes at the max over cores
    (barrier), plus a dispatch overhead.  Hoisted transfers are charged at the
    waves where their enclosing temporal index changes.  Identical math to
    :func:`simulate_reference` at stride 1, without visiting every wave.

    ``fwd`` maps tensor names to :class:`~repro_torch.core.reuse.ForwardLeg`\\ s
    for accesses riding a forwarded inter-kernel edge (the pipeline
    co-planner's two-phase producer/consumer execution): a ``send`` store
    lands in the producing core's L1, a ``recv`` load reads the tile back
    from distributed L1 — crossing one NoC ring per mismatched spatial
    digit (``shuffle_axes``, each ring contended by every active core
    pulling through it) — and neither touches DRAM.  ``None``/empty keeps
    the simulation bit-identical to the historical single-kernel path.

    ``record``, when given a list, receives one dict per wave equivalence
    class — population, active-core mask, wave/hoist/overhead seconds and
    DRAM/NoC bytes (class totals) — the raw material for the simulated
    resource timelines ``repro_torch.obs.explain`` renders.  It is append-only
    bookkeeping of values already computed: passing it changes no cost.
    """
    fwd = fwd or {}
    m = plan.mapping
    prog = m.program
    t_body = body_compute_seconds(plan, hw)
    coords = _core_coords(plan)
    n_cores = len(coords)
    n_temporal = len(m.temporal)
    n_loops = n_temporal + len(prog.seq_dims)
    seq_extents = [e for _, e in m.seq_loops()]      # per-core (split) extents
    inner_I = seq_extents[-1] if seq_extents else 1
    outer_seq = math.prod(seq_extents[:-1]) if len(seq_extents) > 1 else 1
    red_act = m.active_reduce_factor()

    dram_bw = hw.global_mem.bandwidth_gbps * 1e9
    link_bw = {ic.name: ic.bandwidth_gbps * 1e9 for ic in hw.interconnects}
    l1_bw = hw.local_mem.bandwidth_gbps * 1e9
    sizes = dict(m.hw_dims)

    inner_loads = [c for c in plan.loads if c.hoist.level == n_loops]
    hoisted_loads = [c for c in plan.loads if c.hoist.level < n_loops]
    inner_stores = [s for s in plan.stores if s.level == n_loops]
    outer_stores = [s for s in plan.stores if s.level < n_loops]
    k_cut = [min(c.hoist.level, n_temporal) for c in hoisted_loads]

    static_mask, per_loop = _loop_digit_groups(plan, coords, hw)
    n_waves = math.prod(t.extent for t in m.temporal) if m.temporal else 1

    def wave_cost(amask: int):
        """Everything about one active-core set, per wave (no population):
        barrier time, inner-op traffic, per-hoisted-load (time, dram, noc)
        when its reload triggers, and the per-wave outer-store cost."""
        active = [coords[i] for i in range(n_cores) if (amask >> i) & 1]

        # --- contention census ---------------------------------------------
        # DRAM channels: one user per fetching core per op.  NoC rings: one
        # user per *multicast operation* per ring instance (a ring multicast
        # carries the tile once regardless of receiver count).
        chan_users: Dict[Tuple[int, ...], int] = {}
        ring_users: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], int] = {}
        for c in inner_loads:
            leg = fwd.get(c.access.tensor.name)
            if leg is not None:
                # forwarded recv: no DRAM users; each active core pulls its
                # own tile through the re-shuffle rings (per-core users, not
                # per-multicast — every tile is distinct)
                if leg.kind != "free":
                    for core in active:
                        for a in leg.shuffle_axes:
                            ic = hw.interconnect_along(a)
                            if ic is None:
                                continue
                            other = tuple(sorted((k, v)
                                                 for k, v in core.items()
                                                 if k != a))
                            rk = (ic.name, other)
                            ring_users[rk] = ring_users.get(rk, 0) + 1
                continue
            if not c.bcast_axes:
                for core in active:
                    ch = hw.channel_of_core(core)
                    chan_users[ch] = chan_users.get(ch, 0) + 1
            else:
                seen_rings = set()
                for core in active:
                    # producer cores (coordinate 0 along every bcast axis)
                    # fetch from DRAM once
                    if all(core.get(a, 0) == 0 for a in c.bcast_axes):
                        ch = hw.channel_of_core(core)
                        chan_users[ch] = chan_users.get(ch, 0) + 1
                    for a in c.bcast_axes:
                        ic = hw.interconnect_along(a)
                        if ic is None:
                            continue
                        other = tuple(sorted((k, v) for k, v in core.items()
                                             if k != a))
                        key = (id(c), ic.name, other)
                        if key in seen_rings:
                            continue
                        seen_rings.add(key)
                        rk = (ic.name, other)
                        ring_users[rk] = ring_users.get(rk, 0) + 1

        # --- per-core inner-loop time --------------------------------------
        wave_time = 0.0
        for core in active:
            t_load = 0.0
            for c in inner_loads:
                tb = c.access.tile_bytes
                leg = fwd.get(c.access.tensor.name)
                if leg is not None:
                    if leg.kind == "free":
                        continue
                    # on-chip receive: remote L1 read + re-shuffle ring hops
                    t_leg = tb / l1_bw
                    for a in leg.shuffle_axes:
                        ic = hw.interconnect_along(a)
                        if ic is None:
                            continue
                        other = tuple(sorted((k, v) for k, v in core.items()
                                             if k != a))
                        users = max(1, ring_users.get((ic.name, other), 1))
                        t_leg += tb / (link_bw[ic.name] / users)
                    t_load += t_leg
                    t_load += tb / l1_bw        # local landing, like any load
                    continue
                if not c.bcast_axes:
                    ch = hw.channel_of_core(core)
                    users = max(1, chan_users.get(ch, 1))
                    t_load += tb / (dram_bw / users)
                else:
                    t_leg = 0.0
                    if all(core.get(a, 0) == 0 for a in c.bcast_axes):
                        ch = hw.channel_of_core(core)
                        users = max(1, chan_users.get(ch, 1))
                        t_leg = tb / (dram_bw / users)
                    t_noc = 0.0
                    for a in c.bcast_axes:
                        ic = hw.interconnect_along(a)
                        if ic is None:
                            continue
                        other = tuple(sorted((k, v) for k, v in core.items()
                                             if k != a))
                        users = max(1, ring_users.get((ic.name, other), 1))
                        t_noc += tb / (link_bw[ic.name] / users)
                    t_load += max(t_leg, t_noc)       # cut-through pipelining
                t_load += tb / l1_bw
            t_store = 0.0
            for s in inner_stores:
                leg = fwd.get(s.access.tensor.name)
                if leg is not None and not s.reduce_axes:
                    if leg.kind != "free":
                        t_store += s.access.tile_bytes / l1_bw
                    continue
                ch = hw.channel_of_core(core)
                users = max(1, chan_users.get(ch, 1))
                t_store += s.access.tile_bytes / (dram_bw / max(1, users))
            core_t = pipelined_loop_time(inner_I, t_load, t_store, t_body)
            core_t *= outer_seq
            wave_time = max(wave_time, core_t)

        # --- hoisted transfers at temporal boundaries ----------------------
        n_active = len(active)
        hoist_info = []
        for c in hoisted_loads:
            # reload when any temporal loop outer to the hoist level changed;
            # loads hoisted *within* the sequential nest re-issue once per
            # iteration of the seq loops outer to their level
            seq_issues = (math.prod(seq_extents[:c.hoist.level - n_temporal])
                          if c.hoist.level > n_temporal else 1)
            tb = c.access.tile_bytes * c.hoist.tiles_per_issue * seq_issues
            leg = fwd.get(c.access.tensor.name)
            if leg is not None:
                if leg.kind == "free":
                    hoist_info.append((0.0, 0.0, 0.0))
                    continue
                # bulk on-chip receive: every active core pulls its slab from
                # distributed L1 concurrently; each mismatched axis carries
                # the whole per-ring slab set through its ring serially
                t_c = tb / l1_bw
                nb = 0.0
                for a in leg.shuffle_axes:
                    ic = hw.interconnect_along(a)
                    if ic is None:
                        continue
                    t_c += tb * sizes[a] / link_bw[ic.name]
                    nb += tb * n_active
                hoist_info.append((t_c, 0.0, nb))
                continue
            if c.bcast_axes:
                repl = math.prod(sizes[a] for a in c.bcast_axes)
                producers = max(1, n_active // repl)
                t_dram = tb * producers / (dram_bw * hw.global_channels())
                slowest_ring = min((link_bw[hw.interconnect_along(a).name]
                                    for a in c.bcast_axes
                                    if hw.interconnect_along(a)), default=None)
                t_nc = tb / slowest_ring if slowest_ring else 0.0
                t_c = max(t_dram, t_nc)
                db = tb * producers
                nb = 0.0
                planes = producers
                for a in c.bcast_axes:
                    nb += tb * (sizes[a] - 1) * planes
                    planes *= sizes[a]
            else:
                t_c = tb * n_active / (dram_bw * hw.global_channels())
                db = tb * n_active
                nb = 0.0
            hoist_info.append((t_c, db, nb))

        # --- traffic bookkeeping for inner ops -----------------------------
        iters = inner_I * outer_seq
        inner_dram = inner_noc = 0.0
        for c in inner_loads:
            tb = c.access.tile_bytes * iters
            leg = fwd.get(c.access.tensor.name)
            if leg is not None:
                if leg.kind != "free":
                    for a in leg.shuffle_axes:
                        if hw.interconnect_along(a) is not None:
                            inner_noc += tb * n_active
                continue
            if c.bcast_axes:
                repl = math.prod(sizes[a] for a in c.bcast_axes)
                producers = max(1, n_active // repl)
                inner_dram += tb * producers
                planes = producers
                for a in c.bcast_axes:
                    inner_noc += tb * (sizes[a] - 1) * planes
                    planes *= sizes[a]
            else:
                inner_dram += tb * n_active
        for s in inner_stores:
            leg = fwd.get(s.access.tensor.name)
            if leg is not None and not s.reduce_axes:
                continue                        # on-chip: no DRAM bytes
            inner_dram += s.access.tile_bytes * iters * n_active
        ostore_t, ostore_dram, ostore_noc = _reduce_epilogue_cost(
            m, outer_stores, n_active, red_act, hw, dram_bw, link_bw,
            fwd=fwd, l1_bw=l1_bw)
        return (wave_time, inner_dram, inner_noc, hoist_info, ostore_t,
                ostore_dram, ostore_noc)

    total = 0.0
    dram_bytes = 0.0
    noc_bytes = 0.0
    n_classes = 0
    cache: Dict[int, tuple] = {}
    for combo in itertools.product(*per_loop) if per_loop else [()]:
        pop = 1
        amask = static_mask
        j = -1                          # last non-zero digit position
        for i, (mask, zero, count) in enumerate(combo):
            pop *= count
            amask &= mask
            if not zero:
                j = i
        first = j == -1                 # the all-zero wave (population 1)
        n_classes += 1
        if amask == 0:
            total += wave_overhead_s * pop
            if record is not None:
                record.append({
                    "population": pop, "active_mask": 0, "n_active": 0,
                    "wave_s": 0.0, "hoist_s": 0.0,
                    "overhead_s": wave_overhead_s,
                    "dram_bytes": 0.0, "noc_bytes": 0.0})
            continue
        cost = cache.get(amask)
        if cost is None:
            cost = cache[amask] = wave_cost(amask)
        (wave_time, inner_dram, inner_noc, hoist_info, ostore_t,
         ostore_dram, ostore_noc) = cost
        t_hoist = ostore_t
        cls_dram = (inner_dram + ostore_dram) * pop
        cls_noc = (inner_noc + ostore_noc) * pop
        dram_bytes += (inner_dram + ostore_dram) * pop
        noc_bytes += (inner_noc + ostore_noc) * pop
        for (t_c, db, nb), k in zip(hoist_info, k_cut):
            if first or j < k:
                t_hoist += t_c
                dram_bytes += db * pop
                noc_bytes += nb * pop
                cls_dram += db * pop
                cls_noc += nb * pop
        total += (wave_time + t_hoist + wave_overhead_s) * pop
        if record is not None:
            record.append({
                "population": pop, "active_mask": amask,
                "n_active": bin(amask).count("1"),
                "wave_s": wave_time, "hoist_s": t_hoist,
                "overhead_s": wave_overhead_s,
                "dram_bytes": cls_dram, "noc_bytes": cls_noc})

    total += launch_overhead_s        # per-kernel dispatch cost (paper S3.2:
    #                                   small shapes dominated by overheads)
    flops = prog.mat_flops()
    return SimResult(total_s=total, dram_bytes=dram_bytes, noc_bytes=noc_bytes,
                     flops=flops, n_waves=n_waves,
                     wave_overhead_s=wave_overhead_s,
                     n_wave_classes=n_classes)


# --------------------------------------------------------------------------
# Reference path: explicit wave-by-wave loop (test oracle)
# --------------------------------------------------------------------------
def simulate_reference(plan: DataflowPlan, hw: HardwareModel, *,
                       launch_overhead_s: float = 20e-6,
                       wave_overhead_s: float = 2e-6,
                       max_waves_exact: int = 4096) -> SimResult:
    """Simulate plan execution wave by wave (the original O(waves x cores x
    ops) loop).  Exact below ``max_waves_exact`` waves; beyond that it
    stride-samples and scales (the historical fidelity cut the class-based
    :func:`simulate` retires).  Kept as the oracle for equivalence tests.
    """
    m = plan.mapping
    prog = m.program
    t_body = body_compute_seconds(plan, hw)
    coords = _core_coords(plan)
    waves = _wave_envs(plan)
    n_temporal = len(m.temporal)
    n_loops = n_temporal + len(prog.seq_dims)
    seq_extents = [e for _, e in m.seq_loops()]      # per-core (split) extents
    inner_I = seq_extents[-1] if seq_extents else 1
    outer_seq = math.prod(seq_extents[:-1]) if len(seq_extents) > 1 else 1
    red_act = m.active_reduce_factor()

    stride = max(1, len(waves) // max_waves_exact)
    sampled = waves[::stride]
    scale = len(waves) / len(sampled)

    dram_bw = hw.global_mem.bandwidth_gbps * 1e9
    link_bw = {ic.name: ic.bandwidth_gbps * 1e9 for ic in hw.interconnects}
    l1_bw = hw.local_mem.bandwidth_gbps * 1e9
    sizes = dict(m.hw_dims)

    total = 0.0
    dram_bytes = 0.0
    noc_bytes = 0.0
    prev_env: Dict[str, int] = {}

    # pre-split ops
    inner_loads = [c for c in plan.loads if c.hoist.level == n_loops]
    hoisted_loads = [c for c in plan.loads if c.hoist.level < n_loops]
    inner_stores = [s for s in plan.stores if s.level == n_loops]
    outer_stores = [s for s in plan.stores if s.level < n_loops]

    for env in sampled:
        active = [c for c in coords if _is_active(plan, {**c, **env})
                  and not hw.is_disabled(c)]
        if not active:
            total += wave_overhead_s
            continue

        # --- contention census for this wave -------------------------------
        # DRAM channels: one user per fetching core per op.  NoC rings: one
        # user per *multicast operation* per ring instance (a ring multicast
        # carries the tile once regardless of receiver count).
        chan_users: Dict[Tuple[int, ...], int] = {}
        ring_users: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], int] = {}

        for c in inner_loads:
            if not c.bcast_axes:
                for core in active:
                    ch = hw.channel_of_core(core)
                    chan_users[ch] = chan_users.get(ch, 0) + 1
            else:
                seen_rings = set()
                for core in active:
                    # producer cores (coordinate 0 along every bcast axis)
                    # fetch from DRAM once
                    if all(core.get(a, 0) == 0 for a in c.bcast_axes):
                        ch = hw.channel_of_core(core)
                        chan_users[ch] = chan_users.get(ch, 0) + 1
                    for a in c.bcast_axes:
                        ic = hw.interconnect_along(a)
                        if ic is None:
                            continue
                        other = tuple(sorted((k, v) for k, v in core.items()
                                             if k != a))
                        key = (id(c), ic.name, other)
                        if key in seen_rings:
                            continue
                        seen_rings.add(key)
                        rk = (ic.name, other)
                        ring_users[rk] = ring_users.get(rk, 0) + 1

        # --- per-core inner-loop time ---------------------------------------
        wave_time = 0.0
        for core in active:
            t_load = 0.0
            for c in inner_loads:
                tb = c.access.tile_bytes
                if not c.bcast_axes:
                    ch = hw.channel_of_core(core)
                    users = max(1, chan_users.get(ch, 1))
                    t_load += tb / (dram_bw / users)
                else:
                    t_leg = 0.0
                    if all(core.get(a, 0) == 0 for a in c.bcast_axes):
                        ch = hw.channel_of_core(core)
                        users = max(1, chan_users.get(ch, 1))
                        t_leg = tb / (dram_bw / users)
                    t_noc = 0.0
                    for a in c.bcast_axes:
                        ic = hw.interconnect_along(a)
                        if ic is None:
                            continue
                        other = tuple(sorted((k, v) for k, v in core.items() if k != a))
                        users = max(1, ring_users.get((ic.name, other), 1))
                        t_noc += tb / (link_bw[ic.name] / users)
                    t_load += max(t_leg, t_noc)       # cut-through pipelining
                t_load += tb / l1_bw
            t_store = 0.0
            for s in inner_stores:
                ch = hw.channel_of_core(core)
                users = max(1, chan_users.get(ch, 1))
                t_store += s.access.tile_bytes / (dram_bw / max(1, users))
            core_t = pipelined_loop_time(inner_I, t_load, t_store, t_body)
            core_t *= outer_seq
            wave_time = max(wave_time, core_t)

        # --- hoisted transfers at temporal boundaries ------------------------
        t_hoist = 0.0
        for c in hoisted_loads:
            # reload when any temporal loop outer to the hoist level changed;
            # loads hoisted *within* the sequential nest re-issue once per
            # iteration of the seq loops outer to their level
            changed = (not prev_env) or any(
                env.get(t.name, 0) != prev_env.get(t.name, 0)
                for t in m.temporal[:min(c.hoist.level, n_temporal)])
            if changed:
                seq_issues = (math.prod(seq_extents[:c.hoist.level - n_temporal])
                              if c.hoist.level > n_temporal else 1)
                tb = c.access.tile_bytes * c.hoist.tiles_per_issue * seq_issues
                if c.bcast_axes:
                    repl = math.prod(sizes[a] for a in c.bcast_axes)
                    producers = max(1, len(active) // repl)
                    t_dram = tb * producers / (dram_bw * hw.global_channels())
                    slowest_ring = min((link_bw[hw.interconnect_along(a).name]
                                        for a in c.bcast_axes
                                        if hw.interconnect_along(a)), default=None)
                    t_nc = tb / slowest_ring if slowest_ring else 0.0
                    t_hoist += max(t_dram, t_nc)
                    dram_bytes += tb * producers * scale
                    planes = producers
                    for a in c.bcast_axes:
                        noc_bytes += tb * (sizes[a] - 1) * planes * scale
                        planes *= sizes[a]
                else:
                    t_hoist += tb * len(active) / (dram_bw * hw.global_channels())
                    dram_bytes += tb * len(active) * scale

        # --- traffic bookkeeping for inner ops ------------------------------
        iters = inner_I * outer_seq
        for c in inner_loads:
            tb = c.access.tile_bytes * iters
            if c.bcast_axes:
                repl = math.prod(sizes[a] for a in c.bcast_axes)
                producers = max(1, len(active) // repl)
                dram_bytes += tb * producers * scale
                planes = producers
                for a in c.bcast_axes:
                    noc_bytes += tb * (sizes[a] - 1) * planes * scale
                    planes *= sizes[a]
            else:
                dram_bytes += tb * len(active) * scale
        for s in inner_stores:
            dram_bytes += s.access.tile_bytes * iters * len(active) * scale
        ostore_t, ostore_dram, ostore_noc = _reduce_epilogue_cost(
            m, outer_stores, len(active), red_act, hw, dram_bw, link_bw)
        t_hoist += ostore_t
        dram_bytes += ostore_dram * scale
        noc_bytes += ostore_noc * scale

        total += wave_time + t_hoist + wave_overhead_s
        prev_env = env

    total *= scale
    total += launch_overhead_s        # per-kernel dispatch cost (paper S3.2:
    #                                   small shapes dominated by overheads)
    flops = prog.mat_flops()
    return SimResult(total_s=total, dram_bytes=dram_bytes, noc_bytes=noc_bytes,
                     flops=flops, n_waves=len(waves),
                     wave_overhead_s=wave_overhead_s)
