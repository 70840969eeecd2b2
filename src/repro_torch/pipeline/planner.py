"""Kernel-graph co-planner: compose per-node plans + per-edge decisions.

Search structure (DESIGN_PIPELINE.md):

1. **per-node candidate pools** — each node runs the existing single-kernel
   two-step selection (``plan_kernel_multi``: block-shape pooling,
   branch-and-bound ranking, wave-class profiling) and keeps its top-k
   candidates *with* their standalone simulations.  Node searches shard
   across worker processes (one job per node,
   ``repro_torch.parallel.search_exec.plan_node_pools``) when the budget allows;
2. **edge analysis** — every (producer candidate, consumer candidate) pair
   of every edge gets a forwarding spec (legality + re-shuffle axes +
   resident bytes) from ``repro_torch.pipeline.forwarding``;
3. **graph branch-and-bound** — nodes are assigned candidates in
   topological order; a node's incoming edges are decided
   (forward vs spill) as soon as both endpoints are fixed, and a node's
   *edge-adjusted* simulation is finalized once all its edges are decided.
   The admissible bound for every unfinalized node is its **free-leg
   floor**: the node simulated with all edge accesses at zero cost — a
   float-monotone lower bound on any realizable edge handling — so pruning
   is exact (``use_bound=False`` is the exhaustive oracle the tests compare
   against).  Ties resolve to the earliest assignment in canonical
   enumeration order (candidates by standalone rank, forwarding before
   spilling), so results are deterministic.

Joint capacity: when a node is finalized, its working buffers plus the
resident bytes of *all* its live forwarded intermediates (incoming and
outgoing) must fit the local memory — branches that violate it are
infeasible, not merely expensive.

``SearchBudget.pipeline_forwarding=False`` restricts every edge to the
spill decision; the co-planner then provably reproduces the independent
per-kernel plans and the graph time equals the sum of the standalone
simulations (the DRAM-handoff baseline the benchmarks report).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hw import HardwareModel
from repro_torch.core.planner import (Candidate, SearchBudget, effective_budget,
                                plan_kernel, resolve_engine)
from repro_torch.core.simulator import SimResult
from repro_torch.obs import metrics, trace

from . import cost as gcost
from .forwarding import ForwardSpec, forward_spec, free_legs, node_legs
from .graph import PipelineGraph

EdgeKey = Tuple[str, str, str]          # (src, dst, tensor)


@dataclass(frozen=True)
class EdgeDecision:
    """The planned handling of one edge: forwarded on-chip (with its
    re-shuffle axes and per-core resident bytes) or spilled to DRAM."""
    src: str
    dst: str
    tensor: str
    forwarded: bool
    shuffle_axes: Tuple[str, ...] = ()
    resident_bytes: int = 0

    @property
    def key(self) -> EdgeKey:
        return (self.src, self.dst, self.tensor)

    def describe(self) -> str:
        if not self.forwarded:
            return f"{self.src}-({self.tensor})->{self.dst}: spill"
        tag = "aligned" if not self.shuffle_axes else \
            "shuffle:" + "+".join(self.shuffle_axes)
        return f"{self.src}-({self.tensor})->{self.dst}: forward[{tag}]"


@dataclass
class GraphPlan:
    """The co-planner's output: one candidate per node, one decision per
    edge, and the fused two-phase evaluation."""
    graph_name: str
    hw_name: str
    nodes: Dict[str, Candidate]          # chosen candidate per node
    decisions: Tuple[EdgeDecision, ...]
    node_sims: Dict[str, SimResult]      # edge-adjusted simulations
    total_s: float                       # end-to-end co-planned time
    baseline_s: float                    # independent plans + DRAM handoff
    dram_roundtrip_s: float              # what the spill baseline pays per edge
    plan_seconds: float = 0.0
    n_graph_combos: int = 0              # assignments streamed
    n_graph_pruned: int = 0              # assignments cut by the floor bound
    n_forwardable_pairs: int = 0         # candidate pairs with a legal spec
    n_pairs: int = 0                     # candidate pairs examined
    log: List[str] = field(default_factory=list)

    @property
    def improvement(self) -> float:
        return self.baseline_s / self.total_s if self.total_s > 0 else 0.0

    def n_forwarded(self) -> int:
        return sum(1 for d in self.decisions if d.forwarded)

    def describe(self) -> str:
        parts = []
        for name, cand in self.nodes.items():
            parts.append(f"{name}={cand.plan.describe()}")
        for d in self.decisions:
            parts.append(d.describe())
        return " | ".join(parts)

    def summary(self) -> str:
        lines = [
            f"graph={self.graph_name} hw={self.hw_name} "
            f"combos={self.n_graph_combos} "
            f"(pruned={self.n_graph_pruned}) plan_time="
            f"{self.plan_seconds:.2f}s",
            f"  co-planned: {self.total_s * 1e6:.1f}us   "
            f"independent+DRAM handoff: {self.baseline_s * 1e6:.1f}us   "
            f"({self.improvement:.2f}x, {self.n_forwarded()}/"
            f"{len(self.decisions)} edges forwarded)",
        ]
        for d in self.decisions:
            lines.append(f"  edge {d.describe()}")
        return "\n".join(lines)


def node_candidate_pool(programs: Sequence, hw: HardwareModel,
                        budget: SearchBudget, *,
                        engine: Optional[str] = None,
                        cache: Optional[Any] = None) -> List[Candidate]:
    """One node's candidate pool: the single-kernel two-step selection run
    *per block-shape candidate* and merged.

    Running the B&B top-k per program — rather than pooling all programs
    into one ranking as ``plan_kernel_multi`` does — keeps every block
    shape's best plan in the pool.  That diversity is what the graph
    composition needs: the forwarding legality rule matches producer store
    tiles against consumer load tiles, so a pool collapsed onto one block
    shape can starve every edge of compatible pairs.  The pool is sorted by
    (profiled time, program index, canonical index): position 0 is the
    node's standalone winner, and the order is deterministic.
    """
    pool: List[Tuple[float, int, tuple, Candidate]] = []
    for p_i, prog in enumerate(programs):
        try:
            res = plan_kernel(prog, hw, budget=budget, profile=True,
                              cache=cache, engine=engine)
        except RuntimeError:
            continue                     # infeasible block shape
        for c in res.topk:
            pool.append((c.final_s, p_i, c.index or (0, 0, 0), c))
    if not pool:
        raise RuntimeError(f"no feasible plan for any block shape of "
                           f"{programs[0].name if programs else '?'} "
                           f"on {hw.name}")
    pool.sort(key=lambda e: e[:3])
    return [c for _, _, _, c in pool]


def _node_pools(graph: PipelineGraph, hw: HardwareModel,
                budget: SearchBudget, engine: Optional[str],
                cache) -> List[List[Candidate]]:
    """Per-node candidate pools (with standalone sims), sharded
    one-job-per-node across the planner worker pool when available."""
    from repro_torch.parallel import search_exec
    program_lists = [list(n.programs) for n in graph.nodes]
    workers = search_exec.resolve_workers(budget.workers)
    if workers > 1 and len(program_lists) > 1:
        results = search_exec.plan_node_pools(
            program_lists, hw, budget, engine=engine, workers=workers)
        if results is not None:
            return results
    return [node_candidate_pool(progs, hw, budget, engine=engine,
                                cache=cache)
            for progs in program_lists]


def plan_pipeline(graph: PipelineGraph, hw: HardwareModel, *,
                  budget: Optional[SearchBudget] = None,
                  cache: Optional[Any] = None,
                  engine: Optional[str] = None,
                  use_bound: bool = True) -> GraphPlan:
    """Co-plan a kernel graph end to end (see module docstring).

    ``cache`` is a :class:`repro_torch.plancache.PlanCache`: graph-level hits
    return the persisted :class:`GraphPlan` without searching (schema-v3
    graph keys composed from the node program signatures + edge list);
    node-level entries additionally serve the per-node pools on a graph
    miss.  ``use_bound=False`` disables the graph branch-and-bound (the
    exhaustive oracle; selections are identical either way).
    """
    trace.refresh_from_env()
    graph.validate()
    budget = effective_budget(budget)
    engine = resolve_engine(engine)
    if cache is not None:
        hit = cache.get_graph_result(graph, hw, budget)
        if hit is not None:
            return hit
    t0 = time.perf_counter()
    names = [n.name for n in graph.nodes]
    with trace.span("pipeline.node_pools", cat="pipeline",
                    graph=graph.name, n_nodes=len(names)):
        pools: Dict[str, List[Candidate]] = dict(zip(
            names, _node_pools(graph, hw, budget, engine, cache)))

    # ---- per-(edge, candidate pair) forwarding specs -----------------------
    specs: Dict[Tuple[EdgeKey, int, int], Optional[ForwardSpec]] = {}
    n_pairs = n_fwd = 0
    if budget.pipeline_forwarding:
        with trace.span("pipeline.forward_specs", cat="pipeline",
                        graph=graph.name, n_edges=len(graph.edges)):
            for e in graph.edges:
                ek = (e.src, e.dst, e.tensor)
                for pi, pc in enumerate(pools[e.src]):
                    for ci, cc in enumerate(pools[e.dst]):
                        sp = forward_spec(graph, e, pc.plan, cc.plan, hw)
                        specs[(ek, pi, ci)] = sp
                        n_pairs += 1
                        n_fwd += sp is not None

    # ---- memoized edge-adjusted node simulation ----------------------------
    sim_memo: Dict[tuple, SimResult] = {}

    def node_sim(name: str, cand_idx: int,
                 legs: Dict[str, Any]) -> SimResult:
        sig = (name, cand_idx,
               tuple(sorted((t, l.kind, l.shuffle_axes)
                            for t, l in legs.items())))
        got = sim_memo.get(sig)
        if got is None:
            cand = pools[name][cand_idx]
            if not legs and cand.sim is not None:
                got = cand.sim              # standalone profile, already paid
            else:
                got = gcost.simulate_nodes(
                    graph, {name: cand.plan}, {name: legs}, hw,
                    engine=engine).node_sims[name]
            sim_memo[sig] = got
        return got

    # admissible per-node floor: all edge accesses free (monotone <= any
    # realizable edge handling), minimized over the candidate pool
    floors: Dict[str, float] = {}
    if use_bound:
        for name in names:
            fl = free_legs(graph, name)
            floors[name] = min(
                node_sim(name, i, dict(fl)).total_s
                for i in range(len(pools[name])))

    # ---- graph branch-and-bound --------------------------------------------
    cap = hw.local_capacity()
    # a node is finalizable once every adjacent edge is decided, i.e. after
    # the last adjacent node (by topo index) has been assigned
    final_at: Dict[int, List[str]] = {}
    for i, name in enumerate(names):
        fpoint = i
        for e in graph.out_edges(name):
            fpoint = max(fpoint, graph.node_index(e.dst))
        final_at.setdefault(fpoint, []).append(name)

    best: Dict[str, Any] = {"total": float("inf"), "assign": None,
                            "decisions": None}
    stats = {"combos": 0, "pruned": 0}

    def remaining_floor(finalized: set) -> float:
        if not use_bound:
            return 0.0
        return sum(floors[n] for n in names if n not in finalized)

    def edge_options(ek: EdgeKey, pi: int, ci: int) -> List[bool]:
        """Decision order: forward first (canonical), spill always legal."""
        opts: List[bool] = []
        if budget.pipeline_forwarding and specs.get((ek, pi, ci)) is not None:
            opts.append(True)
        opts.append(False)
        return opts

    def finalize(i: int, assign: Dict[str, int],
                 decided: Dict[EdgeKey, bool], partial: float,
                 finalized: set) -> Optional[float]:
        """Finalize nodes whose edges are all decided at step ``i``:
        joint-capacity check + adjusted sim.  None = infeasible branch."""
        for name in final_at.get(i, ()):
            spec_map = {}
            fwd_map = {}
            resident = 0
            for e in graph.in_edges(name) + graph.out_edges(name):
                ek = (e.src, e.dst, e.tensor)
                sp = specs.get((ek, assign[e.src], assign[e.dst]))
                spec_map[ek] = sp
                fwd_map[ek] = decided.get(ek, False)
                if fwd_map[ek] and sp is not None:
                    resident += sp.resident_bytes
            cand = pools[name][assign[name]]
            if resident and cand.plan.buffer_bytes() + resident > cap:
                return None             # joint live intermediates overflow L1
            legs = node_legs(graph, name, spec_map, fwd_map)
            partial += node_sim(name, assign[name], legs).total_s
            finalized.add(name)
        return partial

    def rec(i: int, assign: Dict[str, int], decided: Dict[EdgeKey, bool],
            partial: float, finalized: set) -> None:
        if i == len(names):
            stats["combos"] += 1
            if partial < best["total"]:
                best["total"] = partial
                best["assign"] = dict(assign)
                best["decisions"] = dict(decided)
            return
        name = names[i]
        in_edges = graph.in_edges(name)
        for cand_idx in range(len(pools[name])):
            assign[name] = cand_idx

            def decide(j: int, decided_now: Dict[EdgeKey, bool]) -> None:
                if j == len(in_edges):
                    fin = set(finalized)
                    got = finalize(i, assign, decided_now, partial, fin)
                    if got is None:
                        return
                    if use_bound and got + remaining_floor(fin) \
                            >= best["total"]:
                        stats["pruned"] += 1
                        return
                    rec(i + 1, assign, decided_now, got, fin)
                    return
                e = in_edges[j]
                ek = (e.src, e.dst, e.tensor)
                for f in edge_options(ek, assign[e.src], assign[e.dst]):
                    decided_now[ek] = f
                    decide(j + 1, decided_now)
                del decided_now[ek]

            decide(0, decided)
        del assign[name]

    with trace.span("pipeline.graph_bnb", cat="pipeline", graph=graph.name,
                    n_nodes=len(names), use_bound=use_bound):
        rec(0, {}, {}, 0.0, set())
    if best["assign"] is None:
        raise RuntimeError(f"no feasible graph plan for {graph.name} on "
                           f"{hw.name}")

    # ---- materialize the winner --------------------------------------------
    assign = best["assign"]
    decided = best["decisions"]
    chosen = {name: pools[name][assign[name]] for name in names}
    decisions = []
    for e in graph.edges:
        ek = (e.src, e.dst, e.tensor)
        sp = specs.get((ek, assign[e.src], assign[e.dst]))
        fwd = bool(decided.get(ek, False)) and sp is not None
        decisions.append(EdgeDecision(
            e.src, e.dst, e.tensor, forwarded=fwd,
            shuffle_axes=sp.shuffle_axes if fwd else (),
            resident_bytes=sp.resident_bytes if fwd else 0))
    node_sims = {}
    for name in names:
        spec_map = {d.key: specs.get((d.key, assign[d.src], assign[d.dst]))
                    for d in decisions}
        fwd_map = {d.key: d.forwarded for d in decisions}
        legs = node_legs(graph, name, spec_map, fwd_map)
        node_sims[name] = node_sim(name, assign[name], legs)
    total = best["total"]
    baseline = sum(pools[name][0].sim.total_s for name in names)
    roundtrip = sum(
        gcost.edge_dram_roundtrip_s(graph, e, pools[e.src][0].plan,
                                    pools[e.dst][0].plan, hw)
        for e in graph.edges)
    plan_seconds = time.perf_counter() - t0
    metrics.inc("pipeline_plans_total", graph=graph.name)
    metrics.inc("pipeline_graph_combos_total", stats["combos"])
    metrics.inc("pipeline_graph_pruned_total", stats["pruned"])
    metrics.inc("pipeline_forwardable_pairs_total", n_fwd)
    metrics.inc("pipeline_candidate_pairs_total", n_pairs)
    metrics.observe("pipeline_plan_seconds", plan_seconds, graph=graph.name)
    plan = GraphPlan(
        graph_name=graph.name, hw_name=hw.name, nodes=chosen,
        decisions=tuple(decisions), node_sims=node_sims, total_s=total,
        baseline_s=baseline, dram_roundtrip_s=roundtrip,
        plan_seconds=plan_seconds,
        n_graph_combos=stats["combos"], n_graph_pruned=stats["pruned"],
        n_forwardable_pairs=n_fwd, n_pairs=n_pairs)
    if cache is not None:
        cache.put_graph_result(graph, hw, budget, plan)
    return plan
