"""End-to-end dataflow planner (paper S2.1 "two-step selection strategy").

Pipeline per kernel:

1. front-end block-shape exploration (``program_factory`` over candidate block
   shapes);
2. spatiotemporal mapping enumeration (S2.2);
3. memory-operation mapping: broadcast x hoist design space, capacity-pruned
   (S2.3);
4. analytic ranking with the performance model (S2.5) -> keep top-k;
5. "profiling": the event-driven simulator (the on-hardware stage stand-in,
   DESIGN.md S4) -> pick the final top-1.

Step 4 runs as **branch-and-bound over a streamed candidate space**
(DESIGN_SEARCHPERF.md): candidates are generated mapping by mapping, a cheap
admissible lower bound (:class:`~repro_torch.core.perfmodel.BoundContext`) filters
plans that provably cannot enter the current top-k, and only the survivors
pay for a full :func:`~repro_torch.core.perfmodel.estimate`.  Ties are broken by
stream order, so the selected top-k is bit-identical to ranking every
candidate and stable-sorting by model cost.

Two execution backends evaluate that candidate space (selection is
identical on either; see DESIGN_SEARCHPERF.md "Batched cost engine"):

* ``engine="batch"`` (default when numpy is available) — the
  structure-of-arrays engine (:mod:`repro_torch.core.batch_cost`) bounds and
  estimates every combo of a mapping in vectorized numpy ops, bit-identical
  to the scalar model;
* ``engine="scalar"`` — the historical per-candidate loop (the oracle the
  equivalence tests compare against).

``plan_kernel_multi`` additionally shards its program list across a
process pool (``SearchBudget.workers`` / ``REPRO_PLANNER_WORKERS``,
default ``os.cpu_count()``; ``0``/``1`` = inline) — each worker ranks its
chunk and the per-program top-k are merged by (cost, canonical index), so
the result is bit-identical to the sequential search regardless of worker
count (``repro_torch.parallel.search_exec``).

``plan_kernel`` is the public entry point used by benchmarks and the JAX
lowering layer.
"""
from __future__ import annotations

import heapq
import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..obs import metrics, trace
from . import batch_cost
from .hw import HardwareModel
from .mapping import Mapping, SpatialBind, enumerate_mappings
from .perfmodel import BoundContext, PlanCost, body_compute_seconds, estimate
from .plan import DataflowPlan
from .program import TileProgram
from .reuse import memop_choices_with_stores
from .simulator import SimResult, simulate


@dataclass
class Candidate:
    plan: DataflowPlan
    cost: PlanCost                       # analytic (ranking) cost
    sim: Optional[SimResult] = None      # "profiled" cost (top-k only)
    # canonical (program, mapping, combo) stream indices — the deterministic
    # tie-break key; carried explicitly so process-sharded searches merge
    # their per-chunk top-k exactly as the sequential stream order would
    index: Optional[Tuple[int, int, int]] = None

    @property
    def final_s(self) -> float:
        return self.sim.total_s if self.sim is not None else self.cost.total_s


@dataclass
class PlanResult:
    kernel: str
    hw_name: str
    best: Candidate
    topk: List[Candidate]
    n_candidates: int
    n_mappings: int
    plan_seconds: float
    log: List[str] = field(default_factory=list)
    # search-efficiency counters (benchmarks/plan_speed.py reports these)
    n_pruned: int = 0            # full estimates skipped via the lower bound
    n_estimated: int = 0         # candidates that paid a full estimate
    n_wave_classes: int = 0      # wave classes the best plan's profile costed
    n_mappings_pruned: int = 0   # whole mappings skipped by the floor bound
    n_infeasible_programs: int = 0

    def summary(self) -> str:
        c = self.best
        lines = [
            f"kernel={self.kernel} hw={self.hw_name} "
            f"candidates={self.n_candidates} mappings={self.n_mappings} "
            f"plan_time={self.plan_seconds:.2f}s "
            f"(estimated={self.n_estimated} bound-pruned={self.n_pruned})",
            f"  best: {c.plan.describe()}",
            f"  model: {c.cost.total_s * 1e6:.1f}us ({c.cost.tflops:.2f} TFLOP/s, "
            f"{c.cost.bound}-bound)  dram={c.cost.dram_bytes / 1e6:.1f}MB "
            f"noc={c.cost.noc_bytes / 1e6:.1f}MB",
        ]
        if c.sim:
            lines.append(f"  sim:   {c.sim.total_s * 1e6:.1f}us "
                         f"({c.sim.tflops:.2f} TFLOP/s, "
                         f"{c.sim.n_wave_classes}/{c.sim.n_waves} wave classes)")
        return "\n".join(lines)


@dataclass
class SearchBudget:
    """Knobs bounding the search (paper Table 2 studies top-k; the others cap
    pathological spaces without changing small-space results)."""
    top_k: int = 5
    max_mappings: int = 256
    max_plans_per_mapping: int = 96
    max_candidates: int = 20000
    max_per_load: int = 12
    min_utilization: float = 0.0        # prune mappings below this (0 = keep all)
    pipeline_outer_levels: bool = False  # beyond-paper overlap (EXPERIMENTS SPerf)
    max_programs: int = 0               # cap block-shape candidates (0 = all);
                                        # honored by plan_kernel_multi after
                                        # warm-start ordering
    # spatial-reduction (split-K) plan space: bind reduction dims to mesh
    # axes with partial-sum accumulate/forwarding epilogues.  Off restores
    # the parallel-only space (the reduction benchmarks' baseline column).
    spatial_reduction: bool = True
    # kernel-graph co-planning (repro_torch.pipeline): allow producer->consumer
    # intermediates to be *forwarded* through the distributed on-chip
    # memories instead of spilled to DRAM.  Off restores fully independent
    # per-kernel planning (every edge pays the DRAM round trip) — the
    # pipeline benchmarks' `dram_roundtrip_us` baseline.  Ignored by the
    # single-kernel planners.
    pipeline_forwarding: bool = True
    # process-parallel search sharding (plan_kernel_multi): None = resolve
    # from REPRO_PLANNER_WORKERS (default os.cpu_count()); 0/1 = inline.
    # Selection-invariant, so it is excluded from plan-cache keys
    # (plancache.keying.budget_signature).
    workers: Optional[int] = None


FAST_SEARCH_ENV = "REPRO_FAST_SEARCH"
ENGINE_ENV = "REPRO_COST_ENGINE"        # "batch" (default) | "scalar"

# invocation counters (tests and the plancache acceptance criteria assert a
# cache hit performs zero planner invocations)
PLAN_CALLS = {"plan_kernel": 0, "plan_kernel_multi": 0}


def fast_search_enabled() -> bool:
    return os.environ.get(FAST_SEARCH_ENV, "").lower() in ("1", "true", "on",
                                                           "yes")


def resolve_engine(engine: Optional[str] = None) -> str:
    """The cost backend actually used: the caller's choice, else
    ``REPRO_COST_ENGINE``, else ``batch`` — degraded to ``scalar`` when
    numpy is unavailable.  Never part of cache keys: both engines select
    identical plans."""
    e = (engine or os.environ.get(ENGINE_ENV, "") or "batch").lower()
    if e not in ("batch", "scalar"):
        raise ValueError(f"unknown cost engine {e!r} (batch|scalar)")
    if e == "batch" and not batch_cost.HAVE_NUMPY:
        e = "scalar"
    return e


def effective_budget(budget: Optional[SearchBudget] = None) -> SearchBudget:
    """Resolve the budget actually searched: the caller's budget, shrunk when
    ``REPRO_FAST_SEARCH=1`` (CI / test-latency knob).  Cache keys are computed
    from the *effective* budget so fast and full searches never collide."""
    b = budget or SearchBudget()
    if not fast_search_enabled():
        return b
    # top_k floor of 3 (was 2): the model costs split-K twins against flat
    # plans close enough that the reduction winner routinely sits at rank
    # 2-3; profiling it is what lets fast-search CI runs still select it
    # (the wave-class simulator makes the extra profile essentially free)
    return replace(
        b,
        top_k=min(b.top_k, 3),
        max_mappings=min(b.max_mappings, 24),
        max_plans_per_mapping=min(b.max_plans_per_mapping, 12),
        max_candidates=min(b.max_candidates, 2000),
        max_per_load=min(b.max_per_load, 6),
        max_programs=min(b.max_programs, 16) if b.max_programs else 16)


def budget_for_deadline(budget: Optional[SearchBudget],
                        remaining_s: float) -> SearchBudget:
    """Trim a search budget to what is plausibly searchable in
    ``remaining_s`` seconds (the plan service's rung-3 knob).

    A deterministic step ladder, not a continuous scaler: the trimmed
    budget must be reproducible for cache keying and testing, so the
    remaining time only selects one of three fixed trim levels.  With ten
    seconds or more (or an unbounded deadline) the budget is returned
    unchanged — full-budget resolution through the service stays
    bit-identical to calling the planner directly.
    """
    b = effective_budget(budget)
    if remaining_s == float("inf") or remaining_s >= 10.0:
        return b
    if remaining_s >= 1.0:
        return replace(
            b,
            top_k=min(b.top_k, 3),
            max_mappings=min(b.max_mappings, 64),
            max_plans_per_mapping=min(b.max_plans_per_mapping, 24),
            max_candidates=min(b.max_candidates, 2000),
            max_programs=min(b.max_programs, 8) if b.max_programs else 8)
    if remaining_s >= 0.1:
        return replace(
            b,
            top_k=min(b.top_k, 2),
            max_mappings=min(b.max_mappings, 24),
            max_plans_per_mapping=min(b.max_plans_per_mapping, 12),
            max_candidates=min(b.max_candidates, 500),
            max_per_load=min(b.max_per_load, 6),
            max_programs=min(b.max_programs, 4) if b.max_programs else 4)
    return replace(
        b,
        top_k=1,
        max_mappings=min(b.max_mappings, 8),
        max_plans_per_mapping=min(b.max_plans_per_mapping, 4),
        max_candidates=min(b.max_candidates, 120),
        max_per_load=min(b.max_per_load, 4),
        max_programs=min(b.max_programs, 2) if b.max_programs else 2)


# --------------------------------------------------------------------------
# Streaming candidate generation
# --------------------------------------------------------------------------
def _swap_pairs(hw: HardwareModel) -> List[Tuple[str, str]]:
    """Mesh-dim pairs the hardware is exactly symmetric under: equal sizes,
    equal ring bandwidth, and a DRAM-channel map equivariant with the swap
    (channels permute consistently).  Relabeling such dims permutes cores
    and channels without changing any contention census, so a mapping and
    its swapped image cost bit-identically under both the analytic model
    and the wave-class simulator (the estimate memo's interconnect
    canonicalization rests on the same fact).  Cached per instance."""
    pairs = hw.__dict__.get("_swap_pairs")
    if pairs is not None:
        return pairs
    import itertools as _it
    dims = hw.mesh_dims
    scaleout = hw.core.scaleout
    disabled = hw.disabled_core_set()
    pairs = []
    for i in range(len(dims)):
        for j in range(i + 1, len(dims)):
            (d1, s1), (d2, s2) = dims[i], dims[j]
            if s1 != s2 or s1 <= 1:
                continue
            # a fault overlay breaks the swap symmetry unless the disabled
            # set is itself invariant under it (a hole at (3, 5) makes the
            # swapped mapping activate different physical cores)
            if disabled:
                i1, i2 = scaleout.index(d1), scaleout.index(d2)

                def _swapped(c, a=i1, b=i2):
                    c = list(c)
                    c[a], c[b] = c[b], c[a]
                    return tuple(c)

                if {_swapped(c) for c in disabled} != set(disabled):
                    continue
            ic1, ic2 = hw.interconnect_along(d1), hw.interconnect_along(d2)
            if (ic1 is None) != (ic2 is None):
                continue
            if ic1 is not None and ic1.bandwidth_gbps != ic2.bandwidth_gbps:
                continue
            perm: dict = {}
            ok = True
            for pt in _it.product(*[range(s) for _, s in dims]):
                env = dict(zip([d for d, _ in dims], pt))
                sw = dict(env)
                sw[d1], sw[d2] = env[d2], env[d1]
                ch, ch_sw = hw.channel_of_core(env), hw.channel_of_core(sw)
                if perm.setdefault(ch, ch_sw) != ch_sw:
                    ok = False
                    break
            if ok and len(set(perm.values())) == len(perm):
                pairs.append((d1, d2))
    hw.__dict__["_swap_pairs"] = pairs
    return pairs


def _dedup_twin_mappings(mappings: Tuple[Mapping, ...],
                         hw: HardwareModel) -> Tuple[Mapping, ...]:
    """Drop mappings that provably cost bit-identically to an earlier one:

    * binds to size-1 hardware dims without an interconnect (wormhole_1x8's
      ``x``, the TPU chip's ``u``) contribute digit 0 with any stride —
      every cost input (grid indices, reuse annotations, utilization, wave
      structure) is unchanged with or without them;
    * on meshes symmetric under a dim swap (:func:`_swap_pairs`, e.g. the
      8x8 Wormhole's ``x``/``y``), a mapping and its relabeled image are
      the same machine program on permuted cores.

    Twin candidates tie exactly, and ties already resolve to the earliest
    twin's canonical stream index, so skipping the later twins changes no
    selection — only the redundant enumeration and ranking work the
    estimate memo used to absorb one layer further down (~3x of the 1x8
    space, ~2x of the symmetric-mesh space).
    """
    ones = {d for d, s in hw.mesh_dims
            if s == 1 and hw.interconnect_along(d) is None}
    pairs = _swap_pairs(hw)
    if not ones and not pairs:
        return mappings

    def reduced(spatial):
        return tuple(b for b in spatial if b.hw_dim not in ones) \
            if ones else spatial

    seen = set()
    out = []
    for m in mappings:
        key = (reduced(m.spatial), m.temporal, m.reduce_style)
        if key in seen:
            continue
        dup = False
        for d1, d2 in pairs:
            swap = {d1: d2, d2: d1}
            sw_key = (tuple(SpatialBind(swap.get(b.hw_dim, b.hw_dim),
                                        b.hw_size, b.grid_dim, b.reduce)
                            for b in key[0]), m.temporal, m.reduce_style)
            if sw_key in seen:
                dup = True
                break
        if dup:
            continue
        seen.add(key)
        out.append(m)
    return tuple(out)


def _filtered_mappings(program: TileProgram, hw: HardwareModel,
                       budget: SearchBudget) -> Tuple[Mapping, ...]:
    mappings = _dedup_twin_mappings(
        enumerate_mappings(program, hw, max_candidates=budget.max_mappings,
                           allow_reduction=budget.spatial_reduction),
        hw)
    if budget.min_utilization > 0:
        best_u = max((m.utilization() for m in mappings), default=0.0)
        mappings = tuple(m for m in mappings
                         if m.utilization() >= budget.min_utilization * best_u)
    return tuple(mappings)


def iter_plan_stream(program: TileProgram, hw: HardwareModel,
                     budget: SearchBudget, *,
                     mappings: Optional[Sequence[Mapping]] = None
                     ) -> Iterator[Tuple[Mapping, DataflowPlan]]:
    """Stream candidate plans mapping by mapping (reuse analysis and store
    placement run once per mapping, not once per plan).  Honors the same
    ``max_plans_per_mapping`` / ``max_candidates`` truncation — and yields in
    the same order — as the historical list-building enumeration.
    ``mappings`` lets callers that already enumerated the (budget-filtered)
    mapping space avoid re-enumerating it."""
    if mappings is None:
        mappings = _filtered_mappings(program, hw, budget)
    n = 0
    for mapping in mappings:
        combos, stores = memop_choices_with_stores(
            mapping, hw, max_per_load=budget.max_per_load)
        for combo in combos[:budget.max_plans_per_mapping]:
            yield mapping, DataflowPlan(mapping, combo, stores)
            n += 1
            if n >= budget.max_candidates:
                return


def enumerate_plans(program: TileProgram, hw: HardwareModel,
                    budget: SearchBudget) -> Tuple[List[DataflowPlan], int]:
    """Materialized form of :func:`iter_plan_stream` (kept for callers that
    want the full list; the planner itself streams)."""
    mappings = _filtered_mappings(program, hw, budget)
    plans = [p for _, p in iter_plan_stream(program, hw, budget,
                                            mappings=mappings)]
    return plans, len(mappings)


def _combo_ablation_ok(mapping: Mapping, combo, spatial: bool,
                       temporal: bool) -> bool:
    """The ablation filter at combo level — the single predicate both cost
    engines apply, so their candidate sets cannot diverge."""
    if not spatial and any(c.bcast_axes for c in combo):
        return False
    if not temporal:
        n = len(mapping.temporal) + len(mapping.program.seq_dims)
        if any(c.hoist.level != n for c in combo):
            return False
    return True


def _ablation_ok(plan: DataflowPlan, spatial: bool, temporal: bool) -> bool:
    return _combo_ablation_ok(plan.mapping, plan.loads, spatial, temporal)


# --------------------------------------------------------------------------
# Branch-and-bound top-k ranking
# --------------------------------------------------------------------------
@dataclass
class _SearchStats:
    n_candidates: int = 0
    n_mappings: int = 0
    n_pruned: int = 0
    n_estimated: int = 0
    n_mappings_pruned: int = 0
    n_infeasible_programs: int = 0
    first_failure: str = ""
    # per-phase wall seconds (enumerate/estimate/bnb/simulate) accumulated
    # during the search and flushed once into the metrics registry by
    # _finish (workers ship theirs back through the chunk-result dict)
    phases: Dict[str, float] = field(default_factory=dict)

    def note_failure(self, msg: str) -> None:
        self.n_infeasible_programs += 1
        if not self.first_failure:
            self.first_failure = msg

    def add_phase(self, phase: str, seconds: float) -> None:
        self.phases[phase] = self.phases.get(phase, 0.0) + seconds

    def merge_phases(self, phases: Optional[Dict[str, float]]) -> None:
        for k, v in (phases or {}).items():
            self.phases[k] = self.phases.get(k, 0.0) + v


# tolerance on the prune test: the bound is mathematically <= the estimate,
# but both are float expressions; the margin keeps ulp-level rounding from
# ever discarding a true top-k member (costs this close are re-estimated)
_BOUND_SLACK = 1e-9

# smallest combo list worth the SoA setup: below this the scalar path (dict
# bounds + the cross-mapping estimate memo) is cheaper than building numpy
# tables.  Purely an execution choice — both paths produce bit-identical
# costs, so the threshold can never change the selected top-k.
_BATCH_MIN_COMBOS = 10


def _cost_signature(ctx: "BoundContext", plan: DataflowPlan,
                    transfers, pol: bool):
    """Exact memo key for :func:`estimate`: two plans with equal signatures
    produce bit-identical :class:`PlanCost` values.

    The signature captures every input the model reads — the loop nest, the
    per-transfer (level, per-resource demand, traffic, footprint) tuples,
    utilization/active-core counts, the program identity (body, flops,
    accumulators), and the overlap mode.  Interconnect names are canonicalized
    to (pool bandwidth, first-appearance rank), so plans isomorphic under a
    bandwidth-preserving ring renaming — e.g. the x<->y twins of a symmetric
    mesh, or mappings differing only in size-1 spatial binds — share one
    estimate instead of recomputing identical arithmetic."""
    ring_rank: dict = {}

    def canon(r):
        if r in ("dram", "l1"):
            return r
        got = ring_rank.get(r)
        if got is None:
            got = ring_rank[r] = (ctx.pools[r], len(ring_rank))
        return got

    tr_sig = tuple(
        (t.kind, t.level,
         tuple(sorted((str(canon(r)), b) for r, b in t.demand.items())),
         t.dram_bytes, t.noc_bytes)
        for t in transfers)
    buf_sig = tuple((c.hoist.footprint_tiles, c.access.tile_bytes,
                     c.hoist.level) for c in plan.loads)
    return (id(plan.program), tuple(ctx.loops), pol, ctx.utilization,
            ctx.active_cores, tr_sig, buf_sig)


def _rank_mapping_batch(p_idx: int, m_idx: int, mapping: Mapping, stores,
                        combos, hw: HardwareModel, budget: SearchBudget, *,
                        spatial_reuse: bool, temporal_reuse: bool,
                        use_bound: bool, heap: List[tuple],
                        stats: _SearchStats, demands=None) -> int:
    """Evaluate every combo of one mapping through the SoA batch engine and
    push survivors into the shared top-k heap.  Returns the number of
    candidates that contributed (streamed past the ablation filter).

    Heap semantics match the scalar loop exactly: candidates enter in
    canonical combo order with (cost, canonical-index) keys, so ties
    resolve identically.  The bound prune uses the k-th best *at mapping
    entry* — a (weakly) larger threshold than the scalar loop's
    per-candidate refresh, which can only prune less, never differently.
    """
    k = budget.top_k
    pol = budget.pipeline_outer_levels
    if spatial_reuse and temporal_reuse:
        ok_idx = list(range(len(combos)))
    else:
        ok_idx = [ci for ci, combo in enumerate(combos)
                  if _combo_ablation_ok(mapping, combo, spatial_reuse,
                                        temporal_reuse)]
    stats.n_candidates += len(ok_idx)
    if not ok_idx:
        return 0
    batch = batch_cost.MappingBatch(mapping, stores, hw,
                                    [combos[ci] for ci in ok_idx],
                                    pipeline_outer_levels=pol,
                                    demands=demands)
    np = batch_cost.np
    rows = np.arange(len(ok_idx))
    if use_bound and len(heap) >= k:
        worst = -heap[0][0]
        keep = batch.lower_bounds() <= worst * (1.0 + _BOUND_SLACK)
        stats.n_pruned += int((~keep).sum())
        rows = rows[keep]
    if not len(rows):
        return len(ok_idx)
    _t_est = time.perf_counter()
    with trace.span("planner.batch_estimate", n_rows=len(rows)):
        costs = batch.estimate_rows(rows)
    stats.add_phase("estimate", time.perf_counter() - _t_est)
    stats.n_estimated += len(rows)
    for j, r in enumerate(rows):
        c_idx = ok_idx[int(r)]
        total = float(costs.total[j])
        key = (-total, (-p_idx, -m_idx, -c_idx))
        if len(heap) >= k and not key > heap[0][:2]:
            continue
        cand = Candidate(DataflowPlan(mapping, combos[c_idx], stores),
                         costs.cost(j), index=(p_idx, m_idx, c_idx))
        item = key + (cand,)
        if len(heap) < k:
            heapq.heappush(heap, item)
        else:
            heapq.heapreplace(heap, item)
    return len(ok_idx)


def _rank_streamed(programs: Sequence[TileProgram], hw: HardwareModel,
                   budget: SearchBudget, *, spatial_reuse: bool,
                   temporal_reuse: bool, use_bound: bool,
                   catch_infeasible: bool, stats: _SearchStats,
                   engine: Optional[str] = None) -> List[Candidate]:
    """Rank the pooled candidate space of ``programs``, returning the top-k
    by (model cost, canonical stream order) — bit-identical to estimating
    every candidate and stable-sorting, but:

    * plans whose admissible lower bound already exceeds the current k-th
      best skip the full estimate;
    * whole mappings are skipped when their compute floor (``t_body x waves
      x inner iterations`` — the pipelined-loop formula is ``>= I*t_body``
      at every level) exceeds the k-th best; mappings are also *processed*
      in ascending-floor order so the heap converges before the bulk of the
      space streams by.  Candidates carry their canonical (program, mapping,
      combo) indices, so reordered processing still resolves cost ties
      exactly as the canonical stable sort would.  Both reorder and skip
      engage only when the ``max_candidates`` truncation provably cannot
      fire for the program (otherwise skipping would shift which plans the
      cap admits), which keeps the explored set identical;
    * bit-equal estimates (size-1-bind twins, symmetric-mesh x<->y twins)
      are shared through an exact cost-signature memo.
    """
    engine = resolve_engine(engine)
    if not spatial_reuse and budget.spatial_reduction:
        # the spatial-reuse ablation (paper Table 1) must also drop the
        # spatial-reduction space: partial-sum forwarding/accumulation is a
        # spatially-cooperative dataflow, so the "no spatial reuse" arm
        # would otherwise still contain cross-core plans
        budget = replace(budget, spatial_reduction=False)
    k = budget.top_k
    pol = budget.pipeline_outer_levels
    heap: List[tuple] = []   # (-cost, (-p, -m, -c), Candidate): max-heap
    est_memo: dict = {}
    # phase attribution: enumerate/estimate are timed directly; the branch-
    # and-bound residual (bounds, heap, memo lookups) is everything else
    # this function spends (observation only — never read back)
    _t_rank0 = time.perf_counter()
    _acc0 = (stats.phases.get("enumerate", 0.0)
             + stats.phases.get("estimate", 0.0))
    for p_idx, prog in enumerate(programs):
        contributed = 0
        # feasibility failures (validation, capacity, degenerate spaces)
        # raised by the *enumeration* layers drop the program but are
        # counted and surfaced; anything raised by the cost model — and any
        # non-(RuntimeError|ValueError) — is a planner bug and propagates
        try:
            _t_en = time.perf_counter()
            with trace.span("planner.enumerate", program=prog.name):
                mappings = _filtered_mappings(prog, hw, budget)
            stats.add_phase("enumerate", time.perf_counter() - _t_en)
        except (RuntimeError, ValueError) as e:
            if not catch_infeasible:
                raise
            stats.note_failure(f"{prog.name}: {e}")
            continue
        stats.n_mappings += len(mappings)
        cap_safe = (len(mappings) * budget.max_plans_per_mapping
                    <= budget.max_candidates)
        t_body = body_compute_seconds(mappings[0], hw) if mappings else 0.0
        # per-mapping inner iterations: split-K mappings divide the
        # sequential extents, so the compute floor must shrink with them
        # (it stays admissible: estimate >= t_body * prod(effective loops))
        floors = [t_body * m.n_waves() * m.inner_iters() for m in mappings]
        m_order: Sequence[int] = range(len(mappings))
        if use_bound and cap_safe:
            m_order = sorted(m_order, key=lambda i: floors[i])
        n_streamed = 0
        floor_pruned = 0
        for m_idx in m_order:
            mapping = mappings[m_idx]
            if use_bound and cap_safe and len(heap) >= k and \
                    floors[m_idx] > (-heap[0][0]) * (1.0 + _BOUND_SLACK):
                stats.n_mappings_pruned += 1
                floor_pruned += 1
                continue
            demands = {} if engine == "batch" else None
            try:
                _t_en = time.perf_counter()
                combos, stores = memop_choices_with_stores(
                    mapping, hw, max_per_load=budget.max_per_load,
                    max_plans=budget.max_plans_per_mapping, demands=demands)
                stats.add_phase("enumerate", time.perf_counter() - _t_en)
            except (RuntimeError, ValueError) as e:
                if not catch_infeasible:
                    raise
                if contributed == 0:      # else: partial program, keep plans
                    stats.note_failure(f"{prog.name}: {e}")
                    contributed = -1      # already counted infeasible
                elif not stats.first_failure:
                    stats.first_failure = f"{prog.name}: {e}"
                break                     # drop the rest of this program
            combos = combos[:budget.max_plans_per_mapping]
            if engine == "batch" and len(combos) >= _BATCH_MIN_COMBOS:
                room = budget.max_candidates - n_streamed
                take = combos[:room] if len(combos) > room else combos
                n_streamed += len(take)
                contributed += _rank_mapping_batch(
                    p_idx, m_idx, mapping, stores, take, hw, budget,
                    spatial_reuse=spatial_reuse,
                    temporal_reuse=temporal_reuse, use_bound=use_bound,
                    heap=heap, stats=stats, demands=demands)
                if n_streamed >= budget.max_candidates:
                    break
                continue
            ctx: Optional[BoundContext] = None
            for c_idx, combo in enumerate(combos):
                n_streamed += 1
                plan = DataflowPlan(mapping, combo, stores)
                if _ablation_ok(plan, spatial_reuse, temporal_reuse):
                    stats.n_candidates += 1
                    contributed += 1
                    if ctx is None:
                        ctx = BoundContext(mapping, stores, hw,
                                           pipeline_outer_levels=pol)
                    skip = False
                    if use_bound and len(heap) >= k:
                        worst = -heap[0][0]
                        if ctx.lower_bound(plan) > \
                                worst * (1.0 + _BOUND_SLACK):
                            stats.n_pruned += 1
                            skip = True
                    if not skip:
                        transfers = ctx.transfers_for(plan)
                        key = _cost_signature(ctx, plan, transfers, pol)
                        cost = est_memo.get(key)
                        if cost is None:
                            _t_est = time.perf_counter()
                            cost = estimate(plan, hw,
                                            pipeline_outer_levels=pol,
                                            transfers=transfers)
                            stats.add_phase(
                                "estimate", time.perf_counter() - _t_est)
                            est_memo[key] = cost
                            stats.n_estimated += 1
                        item = (-cost.total_s, (-p_idx, -m_idx, -c_idx),
                                Candidate(plan, cost,
                                          index=(p_idx, m_idx, c_idx)))
                        if len(heap) < k:
                            heapq.heappush(heap, item)
                        elif item > heap[0]:
                            heapq.heapreplace(heap, item)
                if n_streamed >= budget.max_candidates:
                    break
            if n_streamed >= budget.max_candidates:
                break
        # a program whose every mapping was skipped by the floor bound is
        # feasible (just provably worse than the top-k) — only count it
        # infeasible when nothing contributed *and* nothing was pruned
        if contributed == 0 and floor_pruned == 0 and catch_infeasible:
            stats.note_failure(f"{prog.name}: no feasible plan")
    _acc1 = (stats.phases.get("enumerate", 0.0)
             + stats.phases.get("estimate", 0.0))
    stats.add_phase("bnb", max(0.0, (time.perf_counter() - _t_rank0)
                               - (_acc1 - _acc0)))
    return [it[2] for it in sorted(
        heap, key=lambda it: (-it[0], -it[1][0], -it[1][1], -it[1][2]))]


def _flush_search_metrics(stats: _SearchStats, kernel: str,
                          plan_seconds: float) -> None:
    """Publish one completed search into the unified metrics registry
    (phases merged across worker shards; one flush per search)."""
    for phase, secs in sorted(stats.phases.items()):
        metrics.inc("planner_phase_seconds_total", secs, phase=phase)
    metrics.inc("planner_searches_total")
    metrics.inc("planner_candidates_total", stats.n_candidates)
    metrics.inc("planner_mappings_total", stats.n_mappings)
    metrics.inc("planner_estimated_total", stats.n_estimated)
    metrics.inc("planner_pruned_total", stats.n_pruned, kind="bound")
    metrics.inc("planner_pruned_total", stats.n_mappings_pruned,
                kind="mapping_floor")
    if stats.n_infeasible_programs:
        metrics.inc("planner_infeasible_programs_total",
                    stats.n_infeasible_programs)
    metrics.observe("planner_plan_seconds", plan_seconds, kernel=kernel)


def _finish(topk: List[Candidate], *, kernel: str, hw: HardwareModel,
            profile: bool, stats: _SearchStats, t0: float,
            engine: Optional[str] = None) -> PlanResult:
    if profile:
        _t_sim = time.perf_counter()
        with trace.span("planner.profile", kernel=kernel, n_topk=len(topk)):
            if resolve_engine(engine) == "batch":
                sims = batch_cost.simulate_plans([c.plan for c in topk], hw)
                for c, s in zip(topk, sims):
                    c.sim = s
            else:
                for c in topk:
                    c.sim = simulate(c.plan, hw)
        stats.add_phase("simulate", time.perf_counter() - _t_sim)
        topk.sort(key=lambda c: c.final_s)
    best = topk[0]
    log = []
    if stats.n_infeasible_programs:
        log.append(f"infeasible_programs={stats.n_infeasible_programs}")
    if stats.first_failure:
        log.append(f"first_failure: {stats.first_failure}")
    _flush_search_metrics(stats, kernel, time.perf_counter() - t0)
    return PlanResult(
        kernel=kernel, hw_name=hw.name, best=best, topk=topk,
        n_candidates=stats.n_candidates, n_mappings=stats.n_mappings,
        plan_seconds=time.perf_counter() - t0, log=log,
        n_pruned=stats.n_pruned, n_estimated=stats.n_estimated,
        n_wave_classes=best.sim.n_wave_classes if best.sim else 0,
        n_mappings_pruned=stats.n_mappings_pruned,
        n_infeasible_programs=stats.n_infeasible_programs)


def plan_kernel(program: TileProgram, hw: HardwareModel, *,
                budget: Optional[SearchBudget] = None,
                profile: bool = True,
                spatial_reuse: bool = True,
                temporal_reuse: bool = True,
                cache: Optional[Any] = None,
                use_bound: bool = True,
                engine: Optional[str] = None) -> PlanResult:
    """Run the full TileLoom pipeline for one program on one target.

    ``spatial_reuse`` / ``temporal_reuse`` disable the respective passes for
    the paper's ablations (Table 1 / Fig 8): with spatial reuse off every load
    is a per-core global load; with temporal reuse off every load stays at the
    innermost level.

    ``cache`` is a :class:`repro_torch.plancache.PlanCache` (duck-typed); a hit
    returns the persisted result without searching, a miss stores the fresh
    result after planning.

    ``use_bound=False`` disables branch-and-bound pruning (every candidate is
    fully estimated — the exhaustive oracle the equivalence tests compare
    against; selections are identical either way).

    ``engine`` picks the cost backend (``"batch"``/``"scalar"``, see
    :func:`resolve_engine`); selection is identical on either, so the
    choice never enters cache keys.
    """
    trace.refresh_from_env()
    budget = effective_budget(budget)
    if cache is not None:
        hit = cache.get_result([program], hw, budget, profile=profile,
                               spatial_reuse=spatial_reuse,
                               temporal_reuse=temporal_reuse, entry="kernel")
        if hit is not None:
            return hit
    PLAN_CALLS["plan_kernel"] += 1
    t0 = time.perf_counter()
    stats = _SearchStats()
    with trace.span("planner.plan_kernel", kernel=program.name, hw=hw.name):
        topk = _rank_streamed([program], hw, budget,
                              spatial_reuse=spatial_reuse,
                              temporal_reuse=temporal_reuse,
                              use_bound=use_bound,
                              catch_infeasible=False, stats=stats,
                              engine=engine)
        if not topk:
            raise RuntimeError(
                f"no feasible plan for {program.name} on {hw.name} "
                f"(local memory too small for any tiling?)")
        result = _finish(topk, kernel=program.name, hw=hw,
                         profile=profile, stats=stats, t0=t0, engine=engine)
    if cache is not None:
        cache.put_result([program], hw, budget, result, profile=profile,
                         spatial_reuse=spatial_reuse,
                         temporal_reuse=temporal_reuse, entry="kernel")
    return result


def plan_kernel_multi(programs: Sequence[TileProgram], hw: HardwareModel, *,
                      budget: Optional[SearchBudget] = None,
                      profile: bool = True,
                      spatial_reuse: bool = True,
                      temporal_reuse: bool = True,
                      cache: Optional[Any] = None,
                      use_bound: bool = True,
                      engine: Optional[str] = None) -> PlanResult:
    """Front-end block-shape exploration (S2.1): plan every candidate program
    (one per block shape) and keep the global best.  Ranking pools candidates
    across programs before the top-k profiling cut, exactly as the paper's
    front-end + planner interact.

    Programs whose search raises a feasibility error (``RuntimeError`` /
    ``ValueError``: capacity, validation, degenerate spaces) or yields no
    plan are counted in ``PlanResult.n_infeasible_programs`` with the first
    failure message appended to ``PlanResult.log``; any other exception is a
    planner bug and propagates.

    With a ``cache``, a hit skips the search entirely; a miss warm-starts it
    by reordering the candidate programs around the nearest cached plan of
    the same kernel template (then ``budget.max_programs``, if set, trims
    the tail of the reordered list).

    With ``budget.workers`` (or ``REPRO_PLANNER_WORKERS``) above 1 the
    program list is sharded across a process pool
    (``repro_torch.parallel.search_exec``); the merged result selects the exact
    top-k the inline search would, with search-efficiency counters
    (``n_pruned``/``n_estimated``...) reflecting the per-shard searches.
    """
    trace.refresh_from_env()
    budget = effective_budget(budget)
    programs = list(programs)
    requested = programs                 # the cache key covers the full
    if cache is not None:                # requested candidate set, pre-trim
        hit = cache.get_result(requested, hw, budget, profile=profile,
                               spatial_reuse=spatial_reuse,
                               temporal_reuse=temporal_reuse)
        if hit is not None:
            return hit
        programs = cache.order_programs(programs, hw)
    if budget.max_programs and len(programs) > budget.max_programs:
        programs = programs[:budget.max_programs]
    PLAN_CALLS["plan_kernel_multi"] += 1
    t0 = time.perf_counter()
    stats = _SearchStats()
    kernel = programs[0].name.split("_b")[0] if programs else "?"
    with trace.span("planner.plan_kernel_multi", kernel=kernel, hw=hw.name,
                    n_programs=len(programs)):
        topk = None
        if len(programs) > 1:
            from repro_torch.parallel import search_exec
            workers = search_exec.resolve_workers(budget.workers)
            if workers > 1:
                topk = search_exec.rank_sharded(
                    programs, hw, budget, spatial_reuse=spatial_reuse,
                    temporal_reuse=temporal_reuse, use_bound=use_bound,
                    catch_infeasible=True, engine=engine, stats=stats,
                    workers=workers)
        if topk is None:                 # inline (workers<=1 or unshardable)
            topk = _rank_streamed(programs, hw, budget,
                                  spatial_reuse=spatial_reuse,
                                  temporal_reuse=temporal_reuse,
                                  use_bound=use_bound, catch_infeasible=True,
                                  stats=stats, engine=engine)
        if not topk:
            raise RuntimeError("no feasible plan across any block shape"
                               + (f" ({stats.first_failure})"
                                  if stats.first_failure else ""))
        result = _finish(topk, kernel=kernel, hw=hw,
                         profile=profile, stats=stats, t0=t0, engine=engine)
    if cache is not None:
        cache.put_result(requested, hw, budget, result, profile=profile,
                         spatial_reuse=spatial_reuse,
                         temporal_reuse=temporal_reuse)
    return result


def _apply_ablations(plans: List[DataflowPlan], spatial: bool,
                     temporal: bool) -> List[DataflowPlan]:
    return [p for p in plans if _ablation_ok(p, spatial, temporal)]
