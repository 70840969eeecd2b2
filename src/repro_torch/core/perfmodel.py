"""Analytic performance model (paper S2.5).

Evaluates a :class:`DataflowPlan` hierarchically from the innermost loop
outward, exactly as the paper describes:

* **compute** — each tile op is decomposed onto its unit type; ``N``
  independent intrinsics on ``U`` units issuing ``r``/cycle cost
  ``N/(U*r)`` cycles; ops in the same dependence segment but on different
  unit types overlap (max), segments serialize (sum);
* **overlap** — the innermost loop runs as a double-buffered
  load-compute-store pipeline:
  ``T ~ (I-2)*max(Tl+Ts, Tc) + max(Tl,Tc) + max(Ts,Tc) + Tl + Ts``;
* **contention** — concurrent transfers are grouped by the ``df`` resources
  they occupy; each resource's nominal bandwidth is partitioned among its
  users, transfers on disjoint resources proceed in parallel
  (``T = max over resources of sum(demand)/bandwidth``).

The model deliberately stays coarse (the paper: "calibrated to be accurate
enough to distinguish compute-bound from memory-bound mappings") — the
event-driven ``simulator.py`` plays the role of the paper's on-hardware
profiling stage for the top-k candidates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping as TMapping, Optional, Sequence, Tuple

from .hw import HardwareModel, Interconnect
from .mapping import Mapping as _Mapping
from .plan import DataflowPlan
from .reuse import (ForwardLeg, MemOpChoice, StorePlacement,
                    edge_forward_demand, memop_demand)


@dataclass(frozen=True)
class PlanCost:
    """Everything the ranking and the reports need."""
    total_s: float
    compute_s: float                    # pure compute time (body x iters)
    inner_load_s: float                 # per-innermost-iteration load time
    inner_store_s: float
    hoisted_s: float                    # serialized out-of-loop transfer time
    dram_bytes: float                   # total off-chip traffic (whole array)
    noc_bytes: float                    # total NoC traffic (whole array)
    flops: float
    buffer_bytes: int
    utilization: float
    bound: str                          # "compute" | "memory" | "noc"

    @property
    def tflops(self) -> float:
        return self.flops / self.total_s / 1e12 if self.total_s > 0 else 0.0


# --------------------------------------------------------------------------
# Compute cost of the innermost tile body (per core)
# --------------------------------------------------------------------------
def body_compute_seconds(plan_or_mapping, hw: HardwareModel) -> float:
    mapping = getattr(plan_or_mapping, "mapping", plan_or_mapping)
    prog = mapping.program
    core = hw.core
    clock_hz = hw.clock_ghz * 1e9
    segments: Dict[int, Dict[str, float]] = {}
    for op in prog.body:
        seg = segments.setdefault(op.segment, {})
        if op.unit == "mat":
            if core.mat is None:
                raise ValueError(f"{hw.name} has no matrix unit for op {op.kind}")
            n_intr = op.work / core.mat.flops_per_intrinsic
            cycles = n_intr / (core.mat.count * core.mat.intrinsics_per_cycle)
        elif op.unit == "vec":
            if core.vec is None:
                raise ValueError(f"{hw.name} has no vector unit for op {op.kind}")
            n_intr = op.work / core.vec.width
            cycles = n_intr / (core.vec.count * core.vec.intrinsics_per_cycle)
        else:
            lat = core.scalar.latency_cycles if core.scalar else 1.0
            cycles = op.work * lat
        seg[op.unit] = seg.get(op.unit, 0.0) + cycles
    total_cycles = 0.0
    for seg in segments.values():
        total_cycles += max(seg.values())      # unit types overlap in a segment
    return total_cycles / clock_hz


# --------------------------------------------------------------------------
# Memory-op timing with contention
# --------------------------------------------------------------------------
@dataclass
class _Transfer:
    """One memory operation instance at some loop level, with its aggregate
    (whole-array) demand on each df resource per issue."""
    name: str
    level: int
    kind: str                           # "load" | "store"
    demand: Dict[str, float]            # resource -> bytes per issue (array-wide)
    dram_bytes: float
    noc_bytes: float


def _resource_pools(hw: HardwareModel) -> Dict[str, float]:
    """Aggregate bandwidth pools (bytes/s)."""
    pools: Dict[str, float] = {}
    pools["dram"] = hw.global_mem.bandwidth_gbps * 1e9 * hw.global_channels()
    for ic in hw.interconnects:
        pools[ic.name] = ic.bandwidth_gbps * 1e9 * hw.links_of(ic)
    pools["l1"] = hw.local_mem.bandwidth_gbps * 1e9 * hw.n_cores
    return pools


def _load_transfer(c: MemOpChoice, mapping: _Mapping,
                   hw: HardwareModel) -> _Transfer:
    demand, dram_bytes, noc_bytes = memop_demand(c, mapping, hw)
    return _Transfer(c.access.label(), c.hoist.level, "load",
                     demand, dram_bytes, noc_bytes)


def forward_transfer(access, level: int, leg: ForwardLeg, mapping: _Mapping,
                     hw: HardwareModel, kind: str) -> _Transfer:
    """The :class:`_Transfer` of an access riding a forwarded inter-kernel
    edge (``pipeline`` co-planning): on-chip demand from
    :func:`~repro_torch.core.reuse.edge_forward_demand`, zero DRAM.  A ``free``
    leg is the graph bound's zero-cost floor."""
    if leg.kind == "free":
        return _Transfer(access.label(), level, kind, {}, 0.0, 0.0)
    demand, noc_bytes = edge_forward_demand(access, mapping,
                                            leg.shuffle_axes, hw)
    return _Transfer(access.label(), level, kind, demand, 0.0, noc_bytes)


def _store_transfer(s: StorePlacement, mapping: _Mapping,
                    hw: HardwareModel) -> _Transfer:
    active = mapping.active_cores()
    tb = s.access.tile_bytes
    if s.reduce_axes:
        # spatial reduction: the cores along the reduce binds hold partial
        # sums of the same output tile
        r_act = mapping.active_reduce_factor()
        if s.reduce_style == "accum":
            # every partial read-modify-writes the tile in global memory
            bytes_all = 2.0 * tb * active
            demand = {"dram": bytes_all, "l1": float(tb * active)}
            return _Transfer(s.access.label(), s.level, "store", demand,
                             bytes_all, 0.0)
        # forwarding (tree/chain): each non-owner partial crosses the axis
        # NoC exactly once, in per-axis stages (the staged-multicast
        # accounting in reverse); only the owner core touches the store
        # path.  The demand model costs both styles identically (same bytes
        # on the same resources); the simulator's hop-depth term separates
        # them.
        owners = max(1, active // r_act)
        demand = {"dram": float(tb * owners)}
        noc_bytes = 0.0
        planes = active
        for a, digits in mapping.reduce_stages():
            if a not in s.reduce_axes:
                continue
            groups = max(1, planes // digits)
            leg = float(tb * (digits - 1) * groups)
            ic = hw.interconnect_along(a)
            if ic is not None:
                demand[ic.name] = demand.get(ic.name, 0.0) + leg
            noc_bytes += leg
            planes = groups
        demand["l1"] = float(tb * active)
        return _Transfer(s.access.label(), s.level, "store", demand,
                         float(tb * owners), noc_bytes)
    bytes_all = tb * active
    demand = {"dram": bytes_all, "l1": bytes_all}
    return _Transfer(s.access.label(), s.level, "store", demand, bytes_all, 0.0)


def _contended_time(transfers: Sequence[_Transfer],
                    pools: TMapping[str, float]) -> float:
    """Paper's contention rule: partition each resource's bandwidth among its
    users; disjoint resources in parallel -> makespan = max over resources of
    (total demand / bandwidth)."""
    if not transfers:
        return 0.0
    busy: Dict[str, float] = {}
    for t in transfers:
        for res, b in t.demand.items():
            busy[res] = busy.get(res, 0.0) + b / pools[res]
    # a free forwarded leg contributes a transfer with empty demand
    return max(busy.values(), default=0.0)


# --------------------------------------------------------------------------
# Pipelined loop formula (paper S2.5, Figure 4)
# --------------------------------------------------------------------------
def pipelined_loop_time(I: int, t_load: float, t_store: float,
                        t_body: float) -> float:
    if I <= 0:
        return 0.0
    if I == 1:
        return t_load + t_body + t_store
    steady = (I - 2) * max(t_load + t_store, t_body)
    return (steady + max(t_load, t_body) + max(t_store, t_body)
            + t_load + t_store)


# --------------------------------------------------------------------------
# End-to-end estimation
# --------------------------------------------------------------------------
def plan_transfers(plan: DataflowPlan, hw: HardwareModel, *,
                   fwd: Optional[TMapping[str, ForwardLeg]] = None
                   ) -> List[_Transfer]:
    """The plan's full transfer list — exactly what :func:`estimate`
    consumes.  ``fwd`` reroutes forwarded-edge accesses on-chip
    (reduce-combining stores never forward: the pipeline legality rule
    spills them, so their leg is ignored)."""
    m = plan.mapping
    if not fwd:
        return ([_load_transfer(c, m, hw) for c in plan.loads]
                + [_store_transfer(s, m, hw) for s in plan.stores])
    transfers: List[_Transfer] = []
    for c in plan.loads:
        leg = fwd.get(c.access.tensor.name)
        transfers.append(
            forward_transfer(c.access, c.hoist.level, leg, m, hw, "load")
            if leg is not None else _load_transfer(c, m, hw))
    for s in plan.stores:
        leg = fwd.get(s.access.tensor.name)
        transfers.append(
            forward_transfer(s.access, s.level, leg, m, hw, "store")
            if leg is not None and not s.reduce_axes
            else _store_transfer(s, m, hw))
    return transfers


def estimate(plan: DataflowPlan, hw: HardwareModel, *,
             pipeline_outer_levels: bool = False,
             transfers: Optional[Sequence[_Transfer]] = None,
             fwd: Optional[TMapping[str, ForwardLeg]] = None) -> PlanCost:
    """Estimate end-to-end execution time of one candidate plan.

    ``pipeline_outer_levels=False`` is the paper-faithful model (overlap only
    in the innermost loop).  ``True`` additionally double-buffers hoisted
    transfers against the inner loop body — the beyond-paper "collective /
    compute overlap" optimization evaluated in EXPERIMENTS.md SPerf.

    ``transfers`` may be supplied by callers that already materialized the
    plan's transfer list (``BoundContext.transfers_for``); it must equal
    what this function would rebuild.

    ``fwd`` maps tensor names to :class:`~repro_torch.core.reuse.ForwardLeg`\\ s for
    accesses riding a forwarded inter-kernel edge (the pipeline co-planner):
    those transfers are priced on-chip (L1 + re-shuffle rings) instead of
    through DRAM.  ``None``/empty leaves the model bit-identical to the
    historical single-kernel path.
    """
    m = plan.mapping
    prog = m.program
    pools = _resource_pools(hw)

    # per-core effective loop nest: reduce binds divide sequential extents
    loops: List[Tuple[str, int]] = list(m.cost_loops())
    n = len(loops)

    if transfers is None:
        transfers = plan_transfers(plan, hw, fwd=fwd)
    by_level: Dict[int, List[_Transfer]] = {}
    for t in transfers:
        by_level.setdefault(t.level, []).append(t)

    t_body = body_compute_seconds(plan, hw)

    # traffic bookkeeping (drives the paper's "-70% DRAM accesses" ablation
    # and the roofline reports)
    dram_bytes = noc_bytes = 0.0
    for tr, issues in ((tr, _issues_at(tr.level, loops)) for tr in transfers):
        dram_bytes += tr.dram_bytes * issues
        noc_bytes += tr.noc_bytes * issues

    # innermost level: pipelined load/compute/store (levels index positions:
    # ops at level L sit between loop L-1 and loop L; level n = in-body)
    inner = by_level.get(n, [])
    t_load_in = _contended_time([t for t in inner if t.kind == "load"], pools)
    t_store_in = _contended_time([t for t in inner if t.kind == "store"], pools)

    hoisted_s = 0.0
    if n == 0:
        total = t_load_in + t_body + t_store_in
    else:
        _, I_in = loops[-1]
        # consumes loop n-1 and the level-n (in-body) memory ops
        total = pipelined_loop_time(I_in, t_load_in, t_store_in, t_body)
        for lvl in range(n - 2, -1, -1):        # consume loop `lvl`
            ops = by_level.get(lvl + 1, [])
            t_ops_load = _contended_time([t for t in ops if t.kind == "load"], pools)
            t_ops_store = _contended_time([t for t in ops if t.kind == "store"], pools)
            _, I = loops[lvl]
            if pipeline_outer_levels and (t_ops_load + t_ops_store) > 0:
                new_total = pipelined_loop_time(I, t_ops_load, t_ops_store, total)
                hoisted_s += max(0.0, new_total - I * total)
                total = new_total
            else:
                total = I * (total + t_ops_load + t_ops_store)
                hoisted_s += I * (t_ops_load + t_ops_store)
        # level-0 ops (once per core, outside all temporal loops)
        ops0 = by_level.get(0, [])
        t0 = _contended_time(ops0, pools)
        total += t0
        hoisted_s += t0

    flops = prog.mat_flops() + sum(op.work for op in prog.body
                                   if op.unit != "mat") * prog.inner_iters * prog.n_blocks

    compute_total = t_body * math.prod(e for _, e in loops) if loops else t_body
    util = m.utilization()

    # classify the bottleneck via the three roofline-style terms
    t_dram = dram_bytes / pools["dram"]
    noc_pools = {k: v for k, v in pools.items() if k not in ("dram", "l1")}
    # per-resource accumulation for the NoC term
    noc_busy: Dict[str, float] = {}
    for tr in transfers:
        issues = _issues_at(tr.level, loops)
        for res, b in tr.demand.items():
            if res in noc_pools:
                noc_busy[res] = noc_busy.get(res, 0.0) + b * issues / noc_pools[res]
    t_noc = max(noc_busy.values()) if noc_busy else 0.0
    terms = {"compute": compute_total, "memory": t_dram, "noc": t_noc}
    bound = max(terms, key=terms.get)

    return PlanCost(total_s=total, compute_s=compute_total,
                    inner_load_s=t_load_in, inner_store_s=t_store_in,
                    hoisted_s=hoisted_s, dram_bytes=dram_bytes,
                    noc_bytes=noc_bytes, flops=flops,
                    buffer_bytes=plan.buffer_bytes(), utilization=util,
                    bound=bound)


def _issues_at(level: int, loops: Sequence[Tuple[str, int]]) -> int:
    k = 1
    for _, e in loops[:level]:
        k *= e
    return k


def cost_breakdown(plan: DataflowPlan, hw: HardwareModel, *,
                   pipeline_outer_levels: bool = False,
                   fwd: Optional[TMapping[str, ForwardLeg]] = None) -> Dict:
    """Per-resource decomposition of :func:`estimate` for introspection
    (``repro_torch.obs.explain``): total busy-seconds and bytes each df resource
    (dram, every NoC ring class, l1) absorbs over the whole kernel, plus
    the per-transfer contributions and the :class:`PlanCost` itself.

    Pure read-only companion of :func:`estimate` — it reuses the identical
    transfer list and pools, so ``breakdown["cost"]`` is bit-identical to a
    direct ``estimate()`` call with the same arguments.
    """
    m = plan.mapping
    pools = _resource_pools(hw)
    loops: List[Tuple[str, int]] = list(m.cost_loops())
    transfers = plan_transfers(plan, hw, fwd=fwd)
    resources: Dict[str, Dict[str, float]] = {
        res: {"busy_s": 0.0, "bytes": 0.0} for res in pools}
    per_transfer = []
    for tr in transfers:
        issues = _issues_at(tr.level, loops)
        row = {"name": tr.name, "kind": tr.kind, "level": tr.level,
               "issues": issues, "dram_bytes": tr.dram_bytes * issues,
               "noc_bytes": tr.noc_bytes * issues, "resources": {}}
        for res, b in tr.demand.items():
            busy = b * issues / pools[res]
            resources[res]["busy_s"] += busy
            resources[res]["bytes"] += b * issues
            row["resources"][res] = {"busy_s": busy, "bytes": b * issues}
        per_transfer.append(row)
    cost = estimate(plan, hw, pipeline_outer_levels=pipeline_outer_levels,
                    transfers=transfers)
    return {"cost": cost, "compute_s": cost.compute_s,
            "resources": resources, "transfers": per_transfer,
            "pools_bytes_per_s": dict(pools)}


# --------------------------------------------------------------------------
# Admissible lower bound (branch-and-bound ranking, DESIGN_SEARCHPERF.md)
# --------------------------------------------------------------------------
class BoundContext:
    """Per-mapping precomputation for a cheap admissible lower bound on
    :func:`estimate`.

    For every plan over this mapping, ``lower_bound(plan) <=
    estimate(plan, hw, pipeline_outer_levels=...).total_s`` (in either
    overlap mode), so the planner may skip the full estimate for any plan
    whose bound already exceeds the current k-th best cost without changing
    the selected top-k.  Two terms:

    * **compute**: the pipelined-loop formula satisfies ``T >= I * t_body``
      at every level, so ``t_body * prod(extents)`` bounds the total;
    * **traffic**: in the paper-faithful mode every level contributes its
      contended transfer time ``max_r(demand_r / pool_r) >= demand_r /
      pool_r`` serially, so summing per-resource busy time across levels
      bounds the total per resource; with ``pipeline_outer_levels`` the
      model lets different levels overlap, so only the per-(level,
      resource) maximum remains admissible.

    Store placements are mapping-constant and folded in at construction;
    per-load-option busy vectors are memoized, so a bound costs a few dict
    additions per plan instead of a full hierarchical walk.
    """

    def __init__(self, mapping: _Mapping, stores: Sequence[StorePlacement],
                 hw: HardwareModel, *, pipeline_outer_levels: bool = False):
        self.mapping = mapping
        self.hw = hw
        self.pipelined = pipeline_outer_levels
        self.pools = _resource_pools(hw)
        loops: List[Tuple[str, int]] = list(mapping.cost_loops())
        self.loops = loops
        self.compute_lb = body_compute_seconds(mapping, hw) \
            * math.prod(e for _, e in loops)
        self.utilization = mapping.utilization()
        self.active_cores = mapping.active_cores()
        self._store_trs = [_store_transfer(s, mapping, hw) for s in stores]
        self._store_busy: Dict[Tuple[int, str], float] = {}
        for tr in self._store_trs:
            issues = _issues_at(tr.level, loops)
            for r, b in tr.demand.items():
                key = (tr.level, r)
                self._store_busy[key] = self._store_busy.get(key, 0.0) \
                    + b * issues / self.pools[r]
        self._tr_memo: Dict[int, _Transfer] = {}
        self._memo: Dict[int, Dict[Tuple[int, str], float]] = {}

    def _load_tr(self, c: MemOpChoice) -> _Transfer:
        tr = self._tr_memo.get(id(c))
        if tr is None:
            tr = self._tr_memo[id(c)] = _load_transfer(c, self.mapping,
                                                       self.hw)
        return tr

    def transfers_for(self, plan: DataflowPlan) -> List[_Transfer]:
        """The plan's transfer list (loads memoized per option, stores
        shared) — exactly what :func:`estimate` would rebuild itself."""
        return [self._load_tr(c) for c in plan.loads] + self._store_trs

    def _load_busy(self, c: MemOpChoice) -> Dict[Tuple[int, str], float]:
        busy = self._memo.get(id(c))
        if busy is None:
            tr = self._load_tr(c)
            issues = _issues_at(tr.level, self.loops)
            busy = {(tr.level, r): b * issues / self.pools[r]
                    for r, b in tr.demand.items()}
            self._memo[id(c)] = busy
        return busy

    def lower_bound(self, plan: DataflowPlan) -> float:
        agg = dict(self._store_busy)
        for c in plan.loads:
            for key, v in self._load_busy(c).items():
                agg[key] = agg.get(key, 0.0) + v
        if self.pipelined:
            traffic = max(agg.values(), default=0.0)
        else:
            per_res: Dict[str, float] = {}
            for (_, r), v in agg.items():
                per_res[r] = per_res.get(r, 0.0) + v
            traffic = max(per_res.values(), default=0.0)
        return max(self.compute_lb, traffic)


def plan_lower_bound(plan: DataflowPlan, hw: HardwareModel, *,
                     pipeline_outer_levels: bool = False) -> float:
    """One-shot admissible lower bound on ``estimate(plan, hw).total_s``."""
    ctx = BoundContext(plan.mapping, plan.stores, hw,
                       pipeline_outer_levels=pipeline_outer_levels)
    return ctx.lower_bound(plan)
