"""Batched (structure-of-arrays) cost engine for the planner hot loop.

PR 2 made the cold search algorithmically cheap (branch-and-bound, wave
equivalence classes); what remains is pure Python evaluating one candidate
at a time.  This module rewrites the innermost cost loops of
``perfmodel.py`` / ``simulator.py`` into array form:

* :class:`MappingBatch` materializes every surviving (plan, combo)
  candidate of one mapping into numpy arrays — per-(level, resource) busy
  rates, per-level transfer times, traffic terms, buffer bytes — and
  computes the admissible lower bound and the full hierarchical
  :func:`~repro_torch.core.perfmodel.estimate` for the whole batch at once;
* :func:`simulate_plans` computes the wave-equivalence-class simulation
  with the per-core inner loop vectorized over the active-core set
  (sharing the per-mapping class decomposition across plans).

The scalar functions (``estimate``, ``plan_lower_bound``, ``simulate``)
remain the per-plan API and the test oracle.  **Selection identity is a
hard requirement**: every vectorized expression mirrors the scalar code's
floating-point operation order exactly — accumulation across load slots
happens slot-by-slot (zeros from other levels are exact no-ops), store
contributions are added term-by-term after the loads, and the pipelined
loop formula is evaluated with the same association — so batch costs are
bit-identical to the scalar path and tie-breaking by canonical
(program, mapping, combo) index resolves identically
(``tests/test_search_equivalence.py`` pins this).  Only the lower bound
may differ by float rounding (different summation order across levels),
which the branch-and-bound slack already absorbs: pruning decisions can
shift between "pruned" and "estimated", never the selected top-k.

numpy is an optional dependency at import time: when it is unavailable the
planner transparently falls back to the scalar engine
(``repro_torch.core.planner.resolve_engine``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

try:                                   # gate, don't hard-require (CI installs
    import numpy as np                 # numpy; minimal images may lack it)
except ImportError:                    # pragma: no cover - exercised via env
    np = None

from ..obs import trace
from .hw import HardwareModel
from .mapping import Mapping as _Mapping
from .perfmodel import (PlanCost, _contended_time, _issues_at,
                        _resource_pools, _store_transfer,
                        body_compute_seconds, pipelined_loop_time)
from .plan import DataflowPlan
from .reuse import (ForwardLeg, MemOpChoice, StorePlacement,
                    _store_staging_tiles, memop_demand)
from .simulator import (SimResult, _core_coords, _loop_digit_groups,
                        _reduce_epilogue_cost)

HAVE_NUMPY = np is not None


def _pipelined_vec(I: int, t_load, t_store, t_body):
    """:func:`~repro_torch.core.perfmodel.pipelined_loop_time` with the load (and
    possibly total) terms as arrays — identical expression structure, so
    each element reproduces the scalar result bit-for-bit."""
    if I <= 0:
        return t_load * 0.0
    if I == 1:
        return t_load + t_body + t_store
    steady = (I - 2) * np.maximum(t_load + t_store, t_body)
    return (steady + np.maximum(t_load, t_body) + np.maximum(t_store, t_body)
            + t_load + t_store)


class MappingBatch:
    """SoA cost engine for all memory-op combos of one mapping.

    Layout (R = #df resources, n = #temporal+sequential loops, so memory-op
    levels range 0..n; O = #distinct load options across the combos; C =
    #combos; L = #loads of the program):

    ======================  =======================  =========================
    array                   shape                    content
    ======================  =======================  =========================
    ``_opt_busy``           (O, n+1, R)              per-issue demand / pool
                                                     (the contention busy
                                                     rate), nonzero only at
                                                     the option's hoist level
    ``_opt_lb``             (O, n+1, R)              demand x issues / pool
                                                     (the bound's busy time)
    ``_opt_noc``            (O, R_noc)               demand x issues / pool on
                                                     NoC resources (bottleneck
                                                     classification)
    ``_opt_dram/_opt_nocb`` (O,)                     whole-run traffic bytes
    ``_opt_buf``            (O,)                     local-buffer bytes
    ``_idx``                (C, L)                   combo -> option rows
    ======================  =======================  =========================

    Store placements are mapping-constant: their per-level contended times,
    traffic terms, and bound busy are precomputed as scalars/small vectors
    and folded in term-by-term (matching the scalar accumulation order).
    """

    def __init__(self, mapping: _Mapping, stores: Sequence[StorePlacement],
                 hw: HardwareModel,
                 combos: Sequence[Tuple[MemOpChoice, ...]], *,
                 pipeline_outer_levels: bool = False,
                 demands: Optional[Dict[int, tuple]] = None):
        self.mapping = mapping
        self.stores = tuple(stores)
        self.hw = hw
        self.pol = pipeline_outer_levels
        self.n_combos = len(combos)

        pools = _resource_pools(hw)
        self.pools = pools
        res = list(pools)                       # dram, interconnects..., l1
        res_col = {r: i for i, r in enumerate(res)}
        noc_res = [r for r in res if r not in ("dram", "l1")]
        noc_col = {r: i for i, r in enumerate(noc_res)}
        R, Rn = len(res), len(noc_res)

        # per-core effective loop nest: reduce binds divide sequential
        # extents (identical to what estimate()/BoundContext build)
        loops: List[Tuple[str, int]] = list(mapping.cost_loops())
        self.loops = loops
        n = len(loops)
        self.n_levels = n
        issues = [_issues_at(lvl, loops) for lvl in range(n + 1)]

        prog = mapping.program
        self.t_body = body_compute_seconds(mapping, hw)
        self.compute_total = self.t_body * math.prod(e for _, e in loops) \
            if loops else self.t_body
        self.utilization = mapping.utilization()
        self.flops = prog.mat_flops() + sum(
            op.work for op in prog.body
            if op.unit != "mat") * prog.inner_iters * prog.n_blocks

        # ---- mapping-constant store terms ---------------------------------
        store_trs = [_store_transfer(s, mapping, hw) for s in self.stores]
        # per-level contended store time (the scalar helper itself, so the
        # constant is bit-identical to what estimate() would compute)
        self.store_time = [
            _contended_time([t for t in store_trs if t.level == lvl], pools)
            for lvl in range(n + 1)]
        # level-0 busy vectors, one per store (estimate's level-0 pass mixes
        # loads and stores in one census; adding the store terms one by one
        # after the loads reproduces its accumulation order)
        self._store_busy0 = []
        for tr in store_trs:
            if tr.level == 0:
                v = np.zeros(R)
                for r, b in tr.demand.items():
                    v[res_col[r]] += b / pools[r]
                self._store_busy0.append(v)
        # traffic terms, one per store, in store order
        self._store_dram = [tr.dram_bytes * issues[tr.level]
                            for tr in store_trs]
        self._store_noc = [tr.noc_bytes * issues[tr.level]
                           for tr in store_trs]
        # bound busy, accumulated store-by-store (BoundContext does the same)
        store_lb = np.zeros((n + 1, R))
        for tr in store_trs:
            for r, b in tr.demand.items():
                store_lb[tr.level, res_col[r]] += b * issues[tr.level] \
                    / pools[r]
        self._store_lb = store_lb

        self._base_buf = sum(s.access.tile_bytes * _store_staging_tiles(s)
                             for s in self.stores) \
            + prog.accumulator_bytes()

        # ---- load-option registry (one allocation per table, not one per
        # option: the planner builds hundreds of batches per kernel) -------
        rows: Dict[int, int] = {}
        opt_entries: List[Tuple[int, Dict[str, float]]] = []
        opt_dram: List[float] = []
        opt_nocb: List[float] = []
        opt_buf: List[int] = []

        def row_of(c: MemOpChoice) -> int:
            got = rows.get(id(c))
            if got is not None:
                return got
            dem = demands.get(id(c)) if demands is not None else None
            if dem is None:
                dem = memop_demand(c, mapping, hw)
            demand, dram_b, noc_b = dem
            lvl = c.hoist.level
            opt_entries.append((lvl, demand))
            opt_dram.append(dram_b * issues[lvl])
            opt_nocb.append(noc_b * issues[lvl])
            opt_buf.append(c.hoist.footprint_tiles * c.access.tile_bytes
                           * (2 if lvl == n else 1))
            rows[id(c)] = len(opt_entries) - 1
            return rows[id(c)]

        self.n_loads = len(combos[0]) if combos else 0
        self._idx = np.array([[row_of(c) for c in combo] for combo in combos],
                             dtype=np.intp).reshape(self.n_combos,
                                                    self.n_loads)
        O = len(opt_entries)
        busy = np.zeros((O, n + 1, R))
        nocv = np.zeros((O, Rn))
        for o, (lvl, demand) in enumerate(opt_entries):
            for r, b in demand.items():
                busy[o, lvl, res_col[r]] = b / pools[r]
                if r in noc_col:
                    # (b * issues) / pool — the scalar classification's exact
                    # operation order (the busy-rate x issues product below
                    # can differ in the last ulp, fine for the bound but not
                    # for reproducing estimate()'s bottleneck label)
                    nocv[o, noc_col[r]] = b * issues[lvl] / pools[r]
        self._opt_busy = busy
        # bound busy: each option is nonzero only at its own level, so one
        # broadcast multiply applies the right issues factor everywhere
        self._opt_lb = busy * np.array(issues, dtype=float)[None, :, None]
        self._opt_noc = nocv
        self._opt_dram = np.array(opt_dram) if opt_dram else np.zeros(0)
        self._opt_nocb = np.array(opt_nocb) if opt_nocb else np.zeros(0)
        self._opt_buf = np.array(opt_buf, dtype=np.int64) if opt_buf \
            else np.zeros(0, dtype=np.int64)
        self._Rn = Rn

    # ---------------------------------------------------------------- sums
    def _slot_sum(self, table: "np.ndarray", rows: "np.ndarray"):
        """Sum per-option rows across load slots, slot by slot — the scalar
        code accumulates transfers in ``plan.loads`` order, and adding the
        zero entries a mismatched level contributes is exact."""
        if self.n_loads == 0:
            shape = (len(rows),) + table.shape[1:]
            return np.zeros(shape)
        acc = table[self._idx[rows, 0]]
        for l in range(1, self.n_loads):
            acc = acc + table[self._idx[rows, l]]
        return acc

    # --------------------------------------------------------------- bound
    def lower_bounds(self) -> "np.ndarray":
        """Admissible lower bound per combo (vectorized
        :meth:`~repro_torch.core.perfmodel.BoundContext.lower_bound`).  May differ
        from the scalar bound by float rounding (summation order across
        levels); the planner's pruning slack absorbs that."""
        rows = np.arange(self.n_combos)
        agg = self._store_lb[None] + self._slot_sum(self._opt_lb, rows) \
            if self.n_loads else np.broadcast_to(
                self._store_lb, (self.n_combos,) + self._store_lb.shape)
        if self.pol:
            traffic = agg.max(axis=(1, 2)) if agg.size else \
                np.zeros(self.n_combos)
        else:
            per_res = agg.sum(axis=1)
            traffic = per_res.max(axis=1) if per_res.size else \
                np.zeros(self.n_combos)
        return np.maximum(self.compute_total, traffic)

    # ------------------------------------------------------------ estimate
    def estimate_rows(self, rows: "np.ndarray") -> "_BatchCosts":
        """Full hierarchical estimate for the selected combo rows — the
        vectorized twin of :func:`~repro_torch.core.perfmodel.estimate`, matched
        operation-for-operation so each column is bit-identical to the
        scalar result."""
        n = self.n_levels
        C = len(rows)
        busy = self._slot_sum(self._opt_busy, rows)      # (C, n+1, R)
        t_load = busy.max(axis=2) if busy.size else np.zeros((C, n + 1))

        # traffic: loads slot-by-slot, then stores term-by-term
        dram = self._slot_sum(self._opt_dram, rows)
        nocb = self._slot_sum(self._opt_nocb, rows)
        for term in self._store_dram:
            dram = dram + term
        for term in self._store_noc:
            nocb = nocb + term

        t_body = self.t_body
        st = self.store_time
        if n == 0:
            total = t_load[:, 0] + t_body + st[0]
            hoisted = np.zeros(C)
            inner_load = t_load[:, 0]
            inner_store = np.full(C, st[0])
        else:
            I_in = self.loops[-1][1]
            inner_load = t_load[:, n]
            inner_store = np.full(C, st[n])
            total = _pipelined_vec(I_in, t_load[:, n], st[n], t_body)
            hoisted = np.zeros(C)
            for lvl in range(n - 2, -1, -1):
                tol = t_load[:, lvl + 1]
                tos = st[lvl + 1]
                I = self.loops[lvl][1]
                if self.pol:
                    mask = (tol + tos) > 0
                    pipe = _pipelined_vec(I, tol, tos, total)
                    h_pipe = np.maximum(0.0, pipe - I * total)
                    ser = I * (total + tol + tos)
                    h_ser = I * (tol + tos)
                    total = np.where(mask, pipe, ser)
                    hoisted = hoisted + np.where(mask, h_pipe, h_ser)
                else:
                    total = I * (total + tol + tos)
                    hoisted = hoisted + I * (tol + tos)
            # level-0 ops: loads (already summed in slot order) then stores
            busy0 = busy[:, 0, :]
            for sv in self._store_busy0:
                busy0 = busy0 + sv
            t0 = busy0.max(axis=1) if busy0.size else np.zeros(C)
            total = total + t0
            hoisted = hoisted + t0

        # bottleneck classification (same tie order as max(terms, key=...):
        # compute beats memory beats noc on exact ties)
        t_dram = dram / self.pools["dram"]
        nbusy = self._slot_sum(self._opt_noc, rows)
        t_noc = nbusy.max(axis=1) if (self._Rn and nbusy.size) \
            else np.zeros(C)
        is_c = (self.compute_total >= t_dram) & (self.compute_total >= t_noc)
        is_m = ~is_c & (t_dram >= t_noc)

        buf = self._slot_sum(self._opt_buf, rows) + self._base_buf \
            if self.n_loads else np.full(C, self._base_buf, dtype=np.int64)
        return _BatchCosts(self, total, hoisted, inner_load, inner_store,
                           dram, nocb, buf, is_c, is_m)


class _BatchCosts:
    """Column view over one :meth:`MappingBatch.estimate_rows` result;
    :meth:`cost` materializes a scalar :class:`PlanCost` on demand (only
    candidates that enter the top-k heap pay for the dataclass)."""

    def __init__(self, batch, total, hoisted, inner_load, inner_store,
                 dram, noc, buf, is_c, is_m):
        self.batch = batch
        self.total = total
        self._hoisted = hoisted
        self._inner_load = inner_load
        self._inner_store = inner_store
        self._dram = dram
        self._noc = noc
        self._buf = buf
        self._is_c = is_c
        self._is_m = is_m

    def cost(self, j: int) -> PlanCost:
        b = self.batch
        bound = "compute" if self._is_c[j] else \
            ("memory" if self._is_m[j] else "noc")
        return PlanCost(
            total_s=float(self.total[j]), compute_s=float(b.compute_total),
            inner_load_s=float(self._inner_load[j]),
            inner_store_s=float(self._inner_store[j]),
            hoisted_s=float(self._hoisted[j]),
            dram_bytes=float(self._dram[j]), noc_bytes=float(self._noc[j]),
            flops=float(b.flops), buffer_bytes=int(self._buf[j]),
            utilization=b.utilization, bound=bound)


# ==========================================================================
# Vectorized wave-equivalence-class simulation
# ==========================================================================
class _MeshView:
    """Per-(mapping, hw) geometry shared by every plan of the mapping:
    core coordinates, DRAM-channel ids, and per-axis ring-instance ids."""

    def __init__(self, plan: DataflowPlan, hw: HardwareModel):
        self.coords = _core_coords(plan)
        self.n_cores = len(self.coords)
        ch_ids: Dict[Tuple[int, ...], int] = {}
        ch = []
        for c in self.coords:
            t = hw.channel_of_core(c)
            ch.append(ch_ids.setdefault(t, len(ch_ids)))
        self.ch_idx = np.array(ch, dtype=np.intp)
        self.n_channels = max(1, len(ch_ids))
        # ring instance ids: along axis a, cores sharing all non-a coords
        # share one ring (the scalar census keys rings by that tuple)
        self.groups: Dict[str, Tuple["np.ndarray", int]] = {}
        axes = {k for c in self.coords for k in c}
        for a in axes:
            gids: Dict[tuple, int] = {}
            g = []
            for c in self.coords:
                other = tuple(sorted((k, v) for k, v in c.items() if k != a))
                g.append(gids.setdefault(other, len(gids)))
            self.groups[a] = (np.array(g, dtype=np.intp), max(1, len(gids)))
        self.static_mask, self.per_loop = _loop_digit_groups(plan, self.coords,
                                                             hw)


def simulate_plans(plans: Sequence[DataflowPlan], hw: HardwareModel, *,
                   launch_overhead_s: float = 20e-6,
                   wave_overhead_s: float = 2e-6,
                   fwd: Optional[Sequence[Optional[Dict[str, ForwardLeg]]]]
                   = None) -> List[SimResult]:
    """Wave-equivalence-class simulation for a batch of plans, with the
    per-core inner loop of each class costed as numpy arrays over the
    active-core set (replacing ``simulate``'s O(cores x ops) Python loop).
    Identical math to :func:`repro_torch.core.simulator.simulate` — the class
    walk is the same; only the per-core arithmetic is array-shaped — so
    totals and traffic agree with the scalar simulator bit-for-bit
    (asserted at 1e-12 by the equivalence tests).

    ``fwd`` is an optional per-plan sequence of forwarded-edge leg maps
    (``simulate``'s ``fwd`` parameter) — the pipeline co-planner's fused
    producer/consumer simulation; the batch path mirrors the scalar leg
    pricing operation-for-operation, so forwarded totals stay bit-identical
    (``==``) to the scalar simulator as well.

    Plans sharing a :class:`Mapping` object share the class decomposition
    and mesh geometry (the planner's top-k profiling pass benefits when
    several finalists ride one mapping).
    """
    legs = list(fwd) if fwd is not None else [None] * len(plans)
    if np is None:
        from .simulator import simulate
        return [simulate(p, hw, launch_overhead_s=launch_overhead_s,
                         wave_overhead_s=wave_overhead_s, fwd=f)
                for p, f in zip(plans, legs)]
    views: Dict[int, _MeshView] = {}
    out = []
    with trace.span("planner.simulate_plans", n_plans=len(plans)):
        for plan, f in zip(plans, legs):
            view = views.get(id(plan.mapping))
            if view is None:
                view = views[id(plan.mapping)] = _MeshView(plan, hw)
            out.append(_simulate_one(plan, hw, view, launch_overhead_s,
                                     wave_overhead_s, fwd=f))
    return out


def _simulate_one(plan: DataflowPlan, hw: HardwareModel, view: _MeshView,
                  launch_overhead_s: float,
                  wave_overhead_s: float, *,
                  fwd: Optional[Dict[str, ForwardLeg]] = None) -> SimResult:
    fwd = fwd or {}
    m = plan.mapping
    prog = m.program
    t_body = body_compute_seconds(plan, hw)
    n_cores = view.n_cores
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

    # per-op producer masks and ring-axis handles (precomputed once)
    prod_mask = {}
    op_axes = {}
    for c in inner_loads:
        if c.bcast_axes:
            prod_mask[id(c)] = np.array(
                [all(co.get(a, 0) == 0 for a in c.bcast_axes)
                 for co in view.coords])
            op_axes[id(c)] = [(a, hw.interconnect_along(a))
                              for a in c.bcast_axes]

    n_waves = math.prod(t.extent for t in m.temporal) if m.temporal else 1

    def wave_cost(amask: int):
        active = np.array([i for i in range(n_cores) if (amask >> i) & 1],
                          dtype=np.intp)
        A = len(active)

        # --- contention census (integer counts: exact) ---------------------
        hist = np.bincount(view.ch_idx[active], minlength=view.n_channels)
        chan_counts = np.zeros(view.n_channels, dtype=np.int64)
        ring_counts = {a: np.zeros(g[1], dtype=np.int64)
                       for a, g in view.groups.items()}
        for c in inner_loads:
            leg = fwd.get(c.access.tensor.name)
            if leg is not None:
                # forwarded recv: no DRAM users; the re-shuffle rings count
                # one user per active core (every tile is distinct), sharing
                # the per-axis ring census with the multicast ops — exactly
                # the scalar census' shared (ring, instance) keying
                if leg.kind != "free":
                    for a in leg.shuffle_axes:
                        if hw.interconnect_along(a) is None:
                            continue
                        gid = view.groups[a][0][active]
                        ring_counts[a] += np.bincount(
                            gid, minlength=view.groups[a][1])
                continue
            if not c.bcast_axes:
                chan_counts += hist
            else:
                pmask = prod_mask[id(c)][active]
                if pmask.any():
                    chan_counts += np.bincount(
                        view.ch_idx[active[pmask]],
                        minlength=view.n_channels)
                for a, ic in op_axes[id(c)]:
                    if ic is None:
                        continue
                    gid = view.groups[a][0][active]
                    present = np.unique(gid)
                    ring_counts[a][present] += 1

        # --- per-core inner-loop time (vectorized over active cores) -------
        ch_users = chan_counts[view.ch_idx[active]]
        t_load = np.zeros(A)
        for c in inner_loads:
            tb = c.access.tile_bytes
            leg = fwd.get(c.access.tensor.name)
            if leg is not None:
                if leg.kind == "free":
                    continue
                # on-chip receive: remote L1 read + re-shuffle ring hops
                # (same expression order as the scalar path)
                t_leg = np.zeros(A) + tb / l1_bw
                for a in leg.shuffle_axes:
                    ic = hw.interconnect_along(a)
                    if ic is None:
                        continue
                    gid = view.groups[a][0][active]
                    r_users = np.maximum(1, ring_counts[a][gid])
                    t_leg = t_leg + tb / (link_bw[ic.name] / r_users)
                t_load = t_load + t_leg
                t_load = t_load + tb / l1_bw    # local landing, like any load
                continue
            if not c.bcast_axes:
                users = np.maximum(1, ch_users)
                t_load = t_load + tb / (dram_bw / users)
            else:
                users = np.maximum(1, ch_users)
                t_leg = np.where(prod_mask[id(c)][active],
                                 tb / (dram_bw / users), 0.0)
                t_noc = np.zeros(A)
                for a, ic in op_axes[id(c)]:
                    if ic is None:
                        continue
                    gid = view.groups[a][0][active]
                    r_users = np.maximum(1, ring_counts[a][gid])
                    t_noc = t_noc + tb / (link_bw[ic.name] / r_users)
                t_load = t_load + np.maximum(t_leg, t_noc)
            t_load = t_load + tb / l1_bw
        t_store = np.zeros(A)
        for s in inner_stores:
            leg = fwd.get(s.access.tensor.name)
            if leg is not None and not s.reduce_axes:
                if leg.kind != "free":
                    t_store = t_store + s.access.tile_bytes / l1_bw
                continue
            users = np.maximum(1, ch_users)
            t_store = t_store + s.access.tile_bytes / (dram_bw / users)
        if A:
            core_t = _pipelined_vec(inner_I, t_load, t_store, t_body)
            wave_time = float((core_t * outer_seq).max())
        else:                           # pragma: no cover - masked earlier
            wave_time = 0.0

        # --- hoisted transfers / traffic (identical to simulator.simulate) -
        n_active = A
        hoist_info = []
        for c in hoisted_loads:
            seq_issues = (math.prod(seq_extents[:c.hoist.level - n_temporal])
                          if c.hoist.level > n_temporal else 1)
            tb = c.access.tile_bytes * c.hoist.tiles_per_issue * seq_issues
            leg = fwd.get(c.access.tensor.name)
            if leg is not None:
                if leg.kind == "free":
                    hoist_info.append((0.0, 0.0, 0.0))
                    continue
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

    # class walk: identical order and accumulation to simulator.simulate
    import itertools
    total = 0.0
    dram_bytes = 0.0
    noc_bytes = 0.0
    n_classes = 0
    cache: Dict[int, tuple] = {}
    per_loop = view.per_loop
    for combo in itertools.product(*per_loop) if per_loop else [()]:
        pop = 1
        amask = view.static_mask
        j = -1
        for i, (mask, zero, count) in enumerate(combo):
            pop *= count
            amask &= mask
            if not zero:
                j = i
        first = j == -1
        n_classes += 1
        if amask == 0:
            total += wave_overhead_s * pop
            continue
        cost = cache.get(amask)
        if cost is None:
            cost = cache[amask] = wave_cost(amask)
        (wave_time, inner_dram, inner_noc, hoist_info, ostore_t,
         ostore_dram, ostore_noc) = cost
        t_hoist = ostore_t
        dram_bytes += (inner_dram + ostore_dram) * pop
        noc_bytes += (inner_noc + ostore_noc) * pop
        for (t_c, db, nb), k in zip(hoist_info, k_cut):
            if first or j < k:
                t_hoist += t_c
                dram_bytes += db * pop
                noc_bytes += nb * pop
        total += (wave_time + t_hoist + wave_overhead_s) * pop

    total += launch_overhead_s
    flops = prog.mat_flops()
    return SimResult(total_s=total, dram_bytes=dram_bytes,
                     noc_bytes=noc_bytes, flops=flops, n_waves=n_waves,
                     wave_overhead_s=wave_overhead_s,
                     n_wave_classes=n_classes)
