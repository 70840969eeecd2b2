"""Data-reuse analysis and memory-operation mapping (paper S2.3).

For a fixed spatiotemporal mapping the loop nest contains spatial loops
(``affine.parallel`` over core indices), temporal wave loops (``affine.for``)
and sequential loops (``scf.for``).  Every access is an affine function of
these indices, so:

* an access **independent of a spatial index** is *spatially reusable* along
  that hardware dim -> candidate for a NoC broadcast instead of per-core
  global loads;
* an access **independent of a temporal/sequential loop** is *temporally
  reusable* across it -> candidate for hoisting the load outward, buffering
  the tile(s) locally.

Hoisting rules (paper Listing 4): crossing a loop the access does *not*
depend on increases reuse at no buffer cost; crossing a loop it *does* depend
on multiplies the buffered footprint by that loop's extent.  Consequently the
only *meaningful* hoist points are "just above the j-th dependent loop,
maximally hoisted across independent loops" — crossing an independent loop is
free and strictly reduces traffic, so we canonicalize to those points (this
prunes plans that are dominated under the paper's own cost model, keeping the
design space exact w.r.t. distinguishable costs).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .affine import AffineMap, footprint_tiles
from .hw import HardwareModel
from .mapping import Mapping
from .program import TileAccess


@dataclass(frozen=True)
class ReuseInfo:
    """Reuse annotations for one access under one mapping (the paper's
    "reuse annotations on the memory operations")."""
    access: TileAccess
    rewritten: AffineMap
    spatial_axes: Tuple[str, ...]       # hw dims along which tile is identical
    temporal_loops: Tuple[str, ...]     # temporal/seq loops it is independent of


@dataclass(frozen=True)
class HoistOption:
    """One canonical hoist point for a load.

    ``level`` indexes the temporal+sequential loop nest (0 = outside all of
    them, i.e. once per core; n = innermost).  ``footprint_tiles`` is the
    number of distinct tiles that must be simultaneously live;
    ``issues_per_core`` how many times the (bulk) load is issued per core;
    ``tiles_per_issue`` tiles moved per issue.
    """
    level: int
    footprint_tiles: int
    issues_per_core: int
    tiles_per_issue: int


@dataclass(frozen=True)
class MemOpChoice:
    """A concrete realization of one load: broadcast pattern + hoist point.

    ``bcast_axes`` is an *ordered* tuple of hw spatial dims (the order encodes
    the multi-dim broadcast realization, paper S2.3 "several concrete ways");
    empty tuple = direct per-core global load.  Annotations mirror Listing 5's
    ``{type=..., resources=...}``.
    """
    access: TileAccess
    bcast_axes: Tuple[str, ...]
    hoist: HoistOption

    @property
    def load_type(self) -> str:
        return "broadcast" if self.bcast_axes else "global"

    def resources(self, hw: HardwareModel) -> Tuple[str, ...]:
        res = ["dram"] if True else []
        for a in self.bcast_axes:
            ic = hw.interconnect_along(a)
            if ic is not None:
                res.append(ic.name)
        res.append("l1")
        return tuple(res)

    def annotate(self, hw: HardwareModel) -> str:
        res = ", ".join(f"%{r}" for r in self.resources(hw))
        return (f"load_{self.access.tensor.name} "
                f"{{type=\"{self.load_type}\", level={self.hoist.level}, "
                f"footprint_tiles={self.hoist.footprint_tiles}, "
                f"resources={{{res}}}}}")


@dataclass(frozen=True)
class ForwardLeg:
    """How one access of a kernel participates in an *inter-kernel* forwarded
    edge (the pipeline co-planner's on-chip handoff; DESIGN_PIPELINE.md).

    ``kind``:

    * ``"send"`` — a producer store pinned to the distributed local memories:
      the tile is written to the producing core's L1 instead of DRAM and stays
      resident until the consumer kernel runs;
    * ``"recv"`` — a consumer load served from the distributed local
      memories: the tile is read from the producing core's L1; when the two
      mappings' spatial digits disagree on ``shuffle_axes`` the tile
      additionally crosses one NoC ring per mismatched axis (the re-shuffle
      leg);
    * ``"free"`` — the access costs nothing (no time, no bytes, no
      contention).  Never a real dataflow: it is the admissible *floor* the
      graph-level branch-and-bound uses (any realizable edge handling —
      spilled or forwarded — prices the access at >= 0 on every resource,
      so the free-leg simulation lower-bounds them all).
    """
    tensor: str
    kind: str                          # "send" | "recv" | "free"
    shuffle_axes: Tuple[str, ...] = ()


def edge_forward_demand(access: TileAccess, mapping: Mapping,
                        shuffle_axes: Sequence[str], hw: HardwareModel
                        ) -> Tuple[Dict[str, float], float]:
    """Array-wide per-issue resource demand of one *forwarded* edge access
    (the on-chip analogue of :func:`memop_demand`): ``(demand, noc_bytes)``.

    A send touches the local memory once per active core; a recv touches it
    twice (remote read at the producer's L1 port + landing write at the
    consumer's) and moves the tile across one ring per mismatched spatial
    digit.  DRAM demand is zero by construction — that is the point of
    forwarding."""
    active = mapping.active_cores()
    tb = float(access.tile_bytes)
    demand: Dict[str, float] = {}
    noc_bytes = 0.0
    if access.kind == "store":
        demand["l1"] = tb * active
    else:
        demand["l1"] = 2.0 * tb * active
        for a in shuffle_axes:
            ic = hw.interconnect_along(a)
            if ic is None:
                continue
            leg = tb * active
            demand[ic.name] = demand.get(ic.name, 0.0) + leg
            noc_bytes += leg
    return demand, noc_bytes


def forward_resident_bytes(access: TileAccess, mapping: Mapping) -> int:
    """Per-core local-memory bytes the forwarded intermediate occupies while
    resident between the producer and consumer phases: the (padded) tile grid
    of the tensor, spread over the producer's active cores (each core keeps
    the tiles it produced)."""
    tiles = 1
    for dim, blk in zip(access.tensor.shape, access.tile_shape):
        tiles *= -(-dim // blk) if blk else 1
    per_core = -(-tiles // max(1, mapping.active_cores()))
    return per_core * access.tile_bytes


@dataclass(frozen=True)
class StorePlacement:
    """Where (and how) one store issues.

    ``reduce_axes`` names the mesh axes carrying ``reduce=True`` binds whose
    partial results this store must combine (empty = ordinary store);
    ``reduce_style`` is the mapping's combining style: ``accum`` =
    read-modify-write accumulation in global memory, ``tree``/``chain`` =
    partials forwarded over the axis NoC to an owner core (log-depth tree /
    neighbor chain) which performs the single final store.
    """
    access: TileAccess
    level: int
    issues_per_core: int
    reduce_axes: Tuple[str, ...] = ()
    reduce_style: str = ""


# --------------------------------------------------------------------------
# Analysis
# --------------------------------------------------------------------------
def analyze_reuse(mapping: Mapping, hw: HardwareModel) -> Tuple[ReuseInfo, ...]:
    """Paper S2.3 "Reuse analysis on affine accesses"."""
    infos = []
    noc_axes = set(hw.noc_axes())
    t_loops = [t.name for t in mapping.temporal] + \
              [d.name for d in mapping.program.seq_dims]
    for acc in mapping.program.loads + mapping.program.stores:
        rewritten = mapping.rewrite_access(acc)
        sp = tuple(b.hw_dim for b in mapping.spatial
                   if not rewritten.depends_on(b.hw_dim) and b.hw_dim in noc_axes)
        tp = tuple(l for l in t_loops if not rewritten.depends_on(l))
        infos.append(ReuseInfo(acc, rewritten, sp, tp))
    return tuple(infos)


def _nest_loops(mapping: Mapping) -> List[Tuple[str, int]]:
    """Temporal + sequential loops, outer -> inner (spatial excluded: those are
    parallel, not schedulable time).  Sequential extents are the *per-core*
    effective extents — reduce binds divide them (``Mapping.cost_loops``)."""
    return list(mapping.cost_loops())


def hoist_options(info: ReuseInfo, mapping: Mapping) -> Tuple[HoistOption, ...]:
    """Canonical hoist points for one load (see module docstring).

    Enumerates, for j = 0..#dependent-loops, the point just above the j-th
    dependent loop counted from innermost, maximally hoisted across
    independent loops.  Footprints computed by exact affine enumeration.
    """
    loops = _nest_loops(mapping)
    n = len(loops)
    env = mapping.extents_env()
    dep = [info.rewritten.depends_on(name) for name, _ in loops]

    # candidate raw levels: innermost (n) and just-above each loop
    canonical: List[int] = []
    level = n
    while True:
        # hoist maximally across independent loops
        while level > 0 and not dep[level - 1]:
            level -= 1
        if level not in canonical:
            canonical.append(level)
        if level == 0:
            break
        level -= 1          # cross one dependent loop, then re-canonicalize

    out = []
    for lvl in canonical:
        inner = [name for name, _ in loops[lvl:]]
        fp = footprint_tiles(info.rewritten, env, inner)
        issues = 1
        for name, ext in loops[:lvl]:
            issues *= ext
        out.append(HoistOption(level=lvl, footprint_tiles=fp,
                               issues_per_core=issues, tiles_per_issue=fp))
    return tuple(out)


def broadcast_options(info: ReuseInfo) -> Tuple[Tuple[str, ...], ...]:
    """All legal broadcast patterns: every ordered arrangement of every subset
    of the spatially-reusable axes (paper: "from direct per-core global loads
    to one-dimensional and multi-dimensional broadcasts")."""
    axes = info.spatial_axes
    pats: List[Tuple[str, ...]] = [()]
    for r in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, r):
            for perm in itertools.permutations(sub):
                pats.append(perm)
    return tuple(dict.fromkeys(pats))


def store_placement(info: ReuseInfo, mapping: Mapping) -> StorePlacement:
    """Stores are issued at the deepest level whose inner loops are all
    independent of the store address (once per distinct output tile, after the
    reduction loops complete).

    Under a spatial-reduction mapping the cores along each ``reduce=True``
    bind hold *partial sums* of the same output tile whenever the (rewritten)
    store address is independent of that axis; the placement then carries the
    axes and the mapping's combining style so the cost layers charge the
    partial-sum epilogue (accumulate-in-place vs forwarding + owner store).
    """
    loops = _nest_loops(mapping)
    n = len(loops)
    lvl = n
    while lvl > 0 and not info.rewritten.depends_on(loops[lvl - 1][0]):
        lvl -= 1
    issues = 1
    for name, ext in loops[:lvl]:
        issues *= ext
    red_axes = tuple(b.hw_dim for b in mapping.reduce_binds()
                     if not info.rewritten.depends_on(b.hw_dim))
    return StorePlacement(info.access, lvl, issues,
                          reduce_axes=red_axes,
                          reduce_style=mapping.reduce_style if red_axes
                          else "")


def memop_demand(c: MemOpChoice, mapping: Mapping, hw: HardwareModel
                 ) -> Tuple[Dict[str, float], float, float]:
    """Array-wide per-issue resource demand of one load realization.

    Returns ``(demand, dram_bytes, noc_bytes)`` where ``demand`` maps df
    resource names (``dram``, interconnect names, ``l1``) to bytes moved per
    issue summed over the whole core array.  This is the common currency of
    the analytic model's contention rule (perfmodel), the planner's
    branch-and-bound lower bound, and the dominance pruning below.
    """
    active = mapping.active_cores()
    bytes_per_core = c.access.tile_bytes * c.hoist.tiles_per_issue
    demand: Dict[str, float] = {}
    noc_bytes = 0.0
    if not c.bcast_axes:
        # direct per-core global load: every active core fetches its tiles
        dram = float(bytes_per_core * active)
        demand["dram"] = dram
        demand["l1"] = dram
    else:
        sizes = {a: s for a, s in mapping.hw_dims}
        repl = math.prod(sizes[a] for a in c.bcast_axes)
        producers = max(1, active // repl)
        demand["dram"] = float(bytes_per_core * producers)
        # staged multicast: along axis a_i, (s_i - 1) link-hops per receiving
        # plane; earlier stages fan out to progressively more planes
        planes = producers
        for a in c.bcast_axes:
            ic = hw.interconnect_along(a)
            s = sizes[a]
            leg = bytes_per_core * (s - 1) * planes
            if ic is not None:
                demand[ic.name] = demand.get(ic.name, 0.0) + leg
            noc_bytes += leg
            planes *= s
        demand["l1"] = float(bytes_per_core * active)  # every core lands a copy
    return demand, demand.get("dram", 0.0), noc_bytes


def buffer_footprint_bytes(choices: Sequence[MemOpChoice],
                           stores: Sequence[StorePlacement],
                           mapping: Mapping) -> int:
    """Peak local-memory bytes implied by a set of choices: hoisted-load
    buffers (double-buffered when streamed at the innermost level), store
    staging tiles (x2 for forwarding reductions: the owner stages an
    incoming partial next to its own accumulator), and block accumulators."""
    n = len(_nest_loops(mapping))
    total = 0
    for c in choices:
        buf = c.hoist.footprint_tiles * c.access.tile_bytes
        if c.hoist.level == n:      # streamed in the innermost loop
            buf *= 2                # double buffering (paper Fig 4)
        total += buf
    for s in stores:
        total += s.access.tile_bytes * _store_staging_tiles(s)
    total += mapping.program.accumulator_bytes()
    return total


def _store_staging_tiles(s: StorePlacement) -> int:
    """Forwarding reductions hold a receive buffer for the inbound partial
    alongside the local staging tile; plain and accumulate stores need one."""
    return 2 if s.reduce_style in ("tree", "chain") else 1


def _prune_dominated(opts: Sequence[MemOpChoice], mapping: Mapping,
                     hw: HardwareModel,
                     demands: Optional[Dict[int, tuple]] = None
                     ) -> List[MemOpChoice]:
    """Drop load realizations dominated on (dram_bytes, noc_bytes).

    Safety constraint (see DESIGN_SEARCHPERF.md): byte totals alone do not
    order *time* under either cost model — a hoist level changes overlap
    structure (inner streams pipeline with compute, hoisted transfers
    serialize), and equal byte totals can split differently across NoC
    rings.  So an option is pruned only when a same-hoist-level alternative
    is no worse on **every** per-resource demand (which subsumes dram/noc
    totals), no worse on buffer footprint, and strictly better somewhere —
    then the dominator wins at every composition of the analytic model and
    the pruned option can never be part of a distinguishable-best plan.
    Exact duplicates keep their first (stable-order) representative.
    """
    if demands is None:
        demands = {}
    for c in opts:
        if id(c) not in demands:
            demands[id(c)] = memop_demand(c, mapping, hw)
    infos = [(c, demands[id(c)]) for c in opts]
    keep: List[MemOpChoice] = []
    for i, (c, (dem_c, dram_c, noc_c)) in enumerate(infos):
        dominated = False
        for j, (a, (dem_a, dram_a, noc_a)) in enumerate(infos):
            if j == i or a.hoist.level != c.hoist.level:
                continue
            if a.hoist.footprint_tiles > c.hoist.footprint_tiles:
                continue
            res = set(dem_a) | set(dem_c)
            if any(dem_a.get(r, 0.0) > dem_c.get(r, 0.0) for r in res):
                continue
            strict = (dram_a < dram_c or noc_a < noc_c
                      or a.hoist.footprint_tiles < c.hoist.footprint_tiles
                      or any(dem_a.get(r, 0.0) < dem_c.get(r, 0.0)
                             for r in res))
            if strict or j < i:
                dominated = True
                break
        if not dominated:
            keep.append(c)
    return keep


def enumerate_memop_choices(
        mapping: Mapping, hw: HardwareModel, *,
        max_per_load: int = 12,
        capacity_fraction: float = 1.0) -> Tuple[Tuple[MemOpChoice, ...], ...]:
    """The per-mapping memory-operation design space: the cross product of
    (broadcast pattern x hoist point) over all loads, pruned by local-memory
    capacity (paper: "discards options whose footprint exceeds the capacity
    of the hardware model")."""
    combos, _ = memop_choices_with_stores(mapping, hw,
                                          max_per_load=max_per_load,
                                          capacity_fraction=capacity_fraction)
    return combos


def memop_choices_with_stores(
        mapping: Mapping, hw: HardwareModel, *,
        max_per_load: int = 12,
        capacity_fraction: float = 1.0,
        max_plans: Optional[int] = None,
        demands: Optional[Dict[int, tuple]] = None
) -> Tuple[Tuple[Tuple[MemOpChoice, ...], ...], Tuple[StorePlacement, ...]]:
    """As :func:`enumerate_memop_choices`, but also return the (per-mapping
    constant) store placements so streaming callers build plans without
    re-running reuse analysis per combo.

    ``max_plans`` is the caller's downstream combo-window size
    (``SearchBudget.max_plans_per_mapping``); dominance pruning only engages
    when the *unpruned* combo product fits inside it, so removing options can
    never shift which combos that window admits (see `_prune_dominated`).
    Without it (``None``) pruning stays off and the enumeration is exactly
    the historical one.

    ``demands``, when given an (empty) dict, is filled with
    ``id(option) -> memop_demand(option, ...)`` for every surviving option —
    the batched cost engine shares these with the dominance pruning instead
    of recomputing the demand model per option."""
    infos = analyze_reuse(mapping, hw)
    load_infos = [i for i in infos if i.access.kind == "load"]
    store_infos = [i for i in infos if i.access.kind == "store"]
    stores = tuple(store_placement(i, mapping) for i in store_infos)
    capacity = hw.local_capacity() * capacity_fraction

    sizes = dict(mapping.hw_dims)
    per_load: List[List[MemOpChoice]] = []
    for info in load_infos:
        opts = []
        for pat in broadcast_options(info):
            for h in hoist_options(info, mapping):
                opts.append(MemOpChoice(info.access, pat, h))
        # order by estimated per-core global traffic (issues x tiles, divided
        # by the broadcast replication factor) so that capped/truncated
        # enumeration explores the high-reuse region of the space first
        def _traffic(c: MemOpChoice) -> float:
            repl = math.prod(sizes[a] for a in c.bcast_axes) or 1
            return (c.hoist.issues_per_core * c.hoist.tiles_per_issue
                    * c.access.tile_bytes / repl)
        opts.sort(key=lambda c: (_traffic(c), c.hoist.footprint_tiles))
        per_load.append(opts[:max_per_load])

    # dominance pruning *after* the per-load truncation, and only when the
    # full (unpruned) combo product already fits the caller's downstream
    # window: then removal can never promote a previously-unexplored combo
    # into `combos[:max_plans]`, so the explored set stays a subset of the
    # historical one and only provably-no-better plans drop out
    if max_plans is not None and \
            math.prod(len(o) for o in per_load) <= max_plans:
        per_load = [_prune_dominated(opts, mapping, hw, demands)
                    if len(opts) > 1 else opts for opts in per_load]
    if demands is not None:
        for opts in per_load:
            for c in opts:
                if id(c) not in demands:
                    demands[id(c)] = memop_demand(c, mapping, hw)

    # combo capacity filter with per-option precomputed buffer contributions:
    # footprint = sum of per-load buffers (x2 when streamed innermost, paper
    # Fig 4) + store staging + accumulators — identical arithmetic to
    # buffer_footprint_bytes, hoisted out of the product loop
    n = len(_nest_loops(mapping))
    base = sum(s.access.tile_bytes * _store_staging_tiles(s) for s in stores) \
        + mapping.program.accumulator_bytes()
    per_load_buf = [
        [(c, c.hoist.footprint_tiles * c.access.tile_bytes
          * (2 if c.hoist.level == n else 1)) for c in opts]
        for opts in per_load]
    budget_left = capacity - base
    plans = []
    for combo in itertools.product(*per_load_buf):
        if sum(b for _, b in combo) <= budget_left:
            plans.append(tuple(c for c, _ in combo))
            if max_plans is not None and len(plans) >= max_plans:
                break       # caller only consumes combos[:max_plans]
    return tuple(plans), stores
