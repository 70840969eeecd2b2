"""Disjoint rectangular mesh partitioning (DESIGN_TENANCY.md).

Production serving never runs one kernel on the whole fabric: k concurrent
tenants each get a **rectangular sub-mesh** of the physical mesh, planned
independently on a logical :func:`submesh` hardware model.  Because the
submesh is a full :class:`~repro_torch.core.hw.HardwareModel` whose ``df_text()``
differs from the parent's, plan-cache digests fork automatically — warmed
partition pools behave exactly like PR 7's fault pools, and a plan found
for one 4x8 partition serves every 4x8 partition of the same fabric
(the submesh model is deliberately *origin-independent*, see below).

Layers in this module:

* :class:`Rect` — a half-open rectangular window over the core mesh;
* :func:`submesh` — the offset-aware generalization of
  ``runtime.replan._shrink_axis``: carve ``hw`` down to ``Rect(origin,
  shape)`` with rebuilt ring/torus interconnects and the fault overlay
  restricted to (and renumbered into) the window;
* :func:`enumerate_layouts` — ordered guillotine partitions of the mesh
  into k rectangles, cut positions biased toward the tenants' weight
  shares;
* :class:`MeshPartitioner` — the joint search: layouts are ranked by an
  admissible per-tenant roofline floor (``planservice.family
  .program_floor``), then the top few are *planned for real* through the
  PR 8 :class:`~repro_torch.planservice.PlanService` and the best simulated
  makespan wins.

Origin independence: the submesh keeps the parent's DRAM-channel map
evaluated at the *renumbered* (local) coordinates — the same documented
approximation ``_shrink_axis`` makes — so two same-shape partitions at
different origins produce byte-identical ``df_text()`` and share one
plan-cache digest.  That is what makes partition pools warmable per
*shape* rather than per placement.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Set,
                    Tuple)

from repro_torch.core.hw import HardwareModel, Interconnect, SpatialDim, _ring_map
from repro_torch.core.planner import SearchBudget
from repro_torch.core.program import TileProgram
from repro_torch.obs import metrics, trace
from repro_torch.plancache import keying, serialize

QOS_CLASSES = ("guaranteed", "best_effort")


# --------------------------------------------------------------------------
# Rect — a half-open window over the core mesh
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Rect:
    """``[origin, origin + shape)`` over the mesh axes in
    ``hw.core.scaleout`` order."""
    origin: Tuple[int, ...]
    shape: Tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.origin) != len(self.shape):
            raise ValueError(f"origin {self.origin} and shape {self.shape} "
                             f"rank mismatch")
        if any(o < 0 for o in self.origin) or any(s < 1 for s in self.shape):
            raise ValueError(f"bad rect origin={self.origin} "
                             f"shape={self.shape}")

    @property
    def n_cells(self) -> int:
        return math.prod(self.shape)

    @property
    def end(self) -> Tuple[int, ...]:
        return tuple(o + s for o, s in zip(self.origin, self.shape))

    def contains(self, coords: Sequence[int]) -> bool:
        return all(o <= c < e for o, c, e in
                   zip(self.origin, coords, self.end))

    def local(self, coords: Sequence[int]) -> Tuple[int, ...]:
        """Global mesh coords -> partition-local coords."""
        return tuple(c - o for c, o in zip(coords, self.origin))

    def overlaps(self, other: "Rect") -> bool:
        return all(o1 < e2 and o2 < e1 for o1, e1, o2, e2 in
                   zip(self.origin, self.end, other.origin, other.end))

    def within(self, sizes: Sequence[int]) -> bool:
        return all(e <= s for e, s in zip(self.end, sizes))

    def cells(self) -> Iterator[Tuple[int, ...]]:
        return itertools.product(*(range(o, e) for o, e in
                                   zip(self.origin, self.end)))

    def expanded(self, axis: int, direction: int) -> "Rect":
        """The rect grown by one plane along ``axis`` (+1 after the end,
        -1 before the origin)."""
        origin = list(self.origin)
        shape = list(self.shape)
        if direction < 0:
            origin[axis] -= 1
        shape[axis] += 1
        return Rect(tuple(origin), tuple(shape))

    def describe(self) -> str:
        return ("x".join(str(s) for s in self.shape)
                + "@(" + ",".join(str(o) for o in self.origin) + ")")


# --------------------------------------------------------------------------
# submesh — offset-aware logical partition model
# --------------------------------------------------------------------------
def _ic_stride(ic: Interconnect, axis: str) -> int:
    moved = next((e for e in ic.map.exprs
                  if not (e.coeffs == ((axis, 1),) and e.const == 0
                          and e.mod is None and e.floordiv is None)), None)
    return moved.const if moved is not None else 1


def submesh(hw: HardwareModel, origin: Sequence[int],
            shape: Sequence[int]) -> HardwareModel:
    """A logical :class:`HardwareModel` for the rectangular window
    ``[origin, origin + shape)`` of ``hw``'s core mesh.

    * Mesh spatial dims are resized to ``shape``; non-mesh dims (DRAM
      channel indices etc.) are untouched.
    * Ring interconnects along resized axes are rebuilt with the new
      modulus (same per-link bandwidth, including any degradation the
      parent overlay already applied); an axis shrunk to a single plane
      drops its interconnect, matching the presets (``wormhole_1x8`` has
      no ``noc_h``).
    * The fault overlay is restricted to cores inside the window and
      renumbered into local coordinates; degradation factors for
      surviving interconnects carry over.
    * The DRAM-channel and L1 muxes are kept and evaluated at the local
      coordinates — the same documented approximation
      ``runtime.replan._shrink_axis`` makes — so the model depends only
      on the *shape* (plus local faults), never on the origin.

    The identity window returns ``hw`` itself, byte-identical: a k=1
    tenancy plans exactly like a solo whole-mesh run.
    """
    mesh = hw.mesh_dims
    origin = tuple(int(v) for v in origin)
    shape = tuple(int(v) for v in shape)
    if len(origin) != len(mesh) or len(shape) != len(mesh):
        raise ValueError(
            f"origin {origin} / shape {shape} must have one entry per mesh "
            f"axis {tuple(n for n, _ in mesh)} of {hw.name}")
    rect = Rect(origin, shape)
    sizes = tuple(s for _, s in mesh)
    if not rect.within(sizes):
        raise ValueError(f"window {rect.describe()} exceeds {hw.name} mesh "
                         f"{'x'.join(str(s) for s in sizes)}")
    if origin == (0,) * len(mesh) and shape == sizes:
        return hw

    new_size = {name: shape[i] for i, (name, _) in enumerate(mesh)}
    dims = tuple(SpatialDim(d.name, new_size[d.name])
                 if d.name in new_size else d for d in hw.spatial_dims)
    new_mesh = [(name, new_size[name]) for name, _ in mesh]
    old_size = dict(mesh)
    ics: List[Interconnect] = []
    for ic in hw.interconnects:
        ax = ic.axis(hw.core.scaleout)
        if ax in new_size and new_size[ax] != old_size[ax]:
            if new_size[ax] <= 1:
                continue                     # a one-plane ring is no link
            ics.append(Interconnect(ic.name, ic.src, ic.dst,
                                    _ring_map(new_mesh, ax,
                                              _ic_stride(ic, ax)),
                                    ic.bandwidth_gbps))
        else:
            ics.append(ic)
    kept = {ic.name for ic in ics}
    disabled = tuple(sorted(rect.local(c) for c in hw.disabled_cores
                            if rect.contains(c)))
    if len(disabled) >= rect.n_cells:
        raise ValueError(f"window {rect.describe()} of {hw.name} has no "
                         f"healthy cores")
    degraded = tuple((n, f) for n, f in hw.degraded_links if n in kept)
    name = f"{hw.name}_part_{'x'.join(str(s) for s in shape)}"
    note = f"partition of {hw.name}: window {rect.describe()}"
    return dataclasses.replace(
        hw, name=name, spatial_dims=dims, interconnects=tuple(ics),
        disabled_cores=disabled, degraded_links=degraded,
        notes=(hw.notes + "; " if hw.notes else "") + note)


# --------------------------------------------------------------------------
# Tenants and placements
# --------------------------------------------------------------------------
@dataclass
class TenantSpec:
    """One tenant's workload: candidate programs (block shapes) plus its
    QoS class.  ``weight`` biases the partition search toward giving the
    tenant a proportional share of the mesh."""
    name: str
    programs: Sequence[TileProgram]
    qos: str = "guaranteed"
    weight: float = 1.0

    def __post_init__(self) -> None:
        self.programs = list(self.programs)
        if not self.programs:
            raise ValueError(f"tenant {self.name!r} has no programs")
        if self.qos not in QOS_CLASSES:
            raise ValueError(f"tenant {self.name!r}: qos {self.qos!r} not in "
                             f"{QOS_CLASSES}")
        if not self.weight > 0:
            raise ValueError(f"tenant {self.name!r}: weight {self.weight} "
                             f"must be > 0")


def plan_digest(plan: Any) -> str:
    """Content digest of a concrete plan — the byte-identity handle the
    containment invariant is stated (and property-tested) in."""
    return keying.digest_of(serialize.plan_to_dict(plan))


@dataclass
class TenantPlacement:
    """One tenant's slice of the mesh plus the plan it runs there.
    ``response`` is whatever resolved the plan — a
    :class:`~repro_torch.planservice.PlanResponse` at placement time, a
    :class:`~repro_torch.runtime.replan.ReplanOutcome` after a contained
    re-plan — anything with a ``.result`` :class:`PlanResult`."""
    tenant: TenantSpec
    rect: Rect
    hw: HardwareModel
    response: Any
    rung: str = "cache"

    @property
    def result(self):
        return self.response.result

    @property
    def plan(self):
        return self.result.best.plan

    @property
    def sim_s(self) -> float:
        return self.result.best.final_s

    @property
    def digest(self) -> str:
        return plan_digest(self.plan)


@dataclass
class TenancyPlan:
    """The partitioned fabric: disjoint placements plus the spare region
    left for contained growth (``claim_adjacent``)."""
    hw: HardwareModel            # the full fabric the rects index into
    region: Rect                 # partitionable window (mesh minus spare)
    placements: List[TenantPlacement]
    layout_score: float          # simulated makespan of the chosen layout
    n_layouts: int               # layouts considered by the joint search
    log: List[str] = field(default_factory=list)

    def placement(self, tenant: str) -> TenantPlacement:
        for p in self.placements:
            if p.tenant.name == tenant:
                return p
        raise KeyError(tenant)

    def owner_of(self, coords: Sequence[int]) -> Optional[TenantPlacement]:
        """The placement whose rect contains the (global) core coords, or
        None for free/spare cells — fault-domain ownership is exactly
        rect membership."""
        for p in self.placements:
            if p.rect.contains(coords):
                return p
        return None

    def free_cells(self) -> Set[Tuple[int, ...]]:
        sizes = [s for _, s in self.hw.mesh_dims]
        owned: Set[Tuple[int, ...]] = set()
        for p in self.placements:
            owned |= set(p.rect.cells())
        return set(itertools.product(*(range(s) for s in sizes))) - owned

    def digests(self) -> Dict[str, str]:
        return {p.tenant.name: p.digest for p in self.placements}

    def describe(self) -> str:
        return "; ".join(
            f"{p.tenant.name}[{p.tenant.qos}]={p.rect.describe()} "
            f"rung={p.rung} sim={p.sim_s * 1e6:.1f}us"
            for p in self.placements)


# --------------------------------------------------------------------------
# Layout enumeration — ordered guillotine cuts
# --------------------------------------------------------------------------
def enumerate_layouts(region: Rect, weights: Sequence[float], *,
                      cuts_per_split: int = 3,
                      max_layouts: int = 128) -> List[Tuple[Rect, ...]]:
    """Ordered guillotine partitions of ``region`` into ``len(weights)``
    rectangles (the i-th rect hosts tenant i).  Cut positions are ranked
    by closeness to the weight-proportional split and capped at
    ``cuts_per_split`` per (axis, group-split), so the candidate count
    stays bounded while proportional layouts are enumerated first —
    deterministic for a fixed (region, weights, knobs) input."""
    k = len(weights)
    if k < 1:
        raise ValueError("at least one tenant required")
    if region.n_cells < k:
        raise ValueError(f"region {region.describe()} has fewer cells than "
                         f"{k} tenants")
    out: List[Tuple[Rect, ...]] = []
    seen: Set[Tuple[Rect, ...]] = set()

    def rec(rect: Rect, ws: Sequence[float]) -> List[Tuple[Rect, ...]]:
        if len(ws) == 1:
            return [(rect,)]
        results: List[Tuple[Rect, ...]] = []
        for k1 in range(1, len(ws)):
            wa = sum(ws[:k1])
            wb = sum(ws[k1:])
            for axis in range(len(rect.shape)):
                size = rect.shape[axis]
                if size < 2:
                    continue
                target = size * wa / (wa + wb)
                cuts = sorted(range(1, size),
                              key=lambda p: (abs(p - target), p))
                for p in cuts[:max(1, cuts_per_split)]:
                    a_shape = list(rect.shape)
                    a_shape[axis] = p
                    b_origin = list(rect.origin)
                    b_origin[axis] += p
                    b_shape = list(rect.shape)
                    b_shape[axis] = size - p
                    a = Rect(rect.origin, tuple(a_shape))
                    b = Rect(tuple(b_origin), tuple(b_shape))
                    if a.n_cells < k1 or b.n_cells < len(ws) - k1:
                        continue
                    for left in rec(a, ws[:k1]):
                        for right in rec(b, ws[k1:]):
                            results.append(left + right)
        return results

    for layout in rec(region, list(weights)):
        if layout in seen:
            continue
        seen.add(layout)
        out.append(layout)
        if len(out) >= max_layouts:
            break
    if not out:
        raise ValueError(f"no feasible {k}-way layout of "
                         f"{region.describe()}")
    return out


# --------------------------------------------------------------------------
# MeshPartitioner — the joint partition-shape x per-tenant-plan search
# --------------------------------------------------------------------------
class MeshPartitioner:
    """Carve a fabric into disjoint tenant partitions, searching partition
    shapes jointly with the per-tenant plans.

    Two-phase, mirroring the planner's own bound-then-profile structure:
    candidate layouts are ranked by an admissible roofline floor per
    tenant (``planservice.family.program_floor`` on the candidate
    submesh — cheap, no search), then the best ``plan_layouts`` layouts
    are resolved for real through the PlanService (per-tenant deadline,
    warmed partition pools answer at rung 1) and the layout with the
    smallest simulated makespan wins.  Per-(tenant, submesh-digest)
    resolutions are memoized, so layouts sharing a partition shape share
    the plan.

    ``spare_planes`` reserves trailing planes of the largest mesh axis as
    an unassigned hot-spare strip: contained re-planning
    (``runtime.TenantRuntime``) can grow a degraded partition into it
    without touching any other tenant.
    """

    def __init__(self, *, spare_planes: int = 0, cuts_per_split: int = 3,
                 max_layouts: int = 128, plan_layouts: int = 3) -> None:
        if spare_planes < 0:
            raise ValueError("spare_planes must be >= 0")
        self.spare_planes = spare_planes
        self.cuts_per_split = cuts_per_split
        self.max_layouts = max_layouts
        self.plan_layouts = max(1, plan_layouts)

    # ------------------------------------------------------------- region
    def region(self, hw: HardwareModel) -> Rect:
        """The partitionable window: the full mesh minus the hot-spare
        strip (trailing planes of the largest axis; ties -> first axis in
        scaleout order)."""
        mesh = hw.mesh_dims
        sizes = [s for _, s in mesh]
        if not self.spare_planes:
            return Rect((0,) * len(mesh), tuple(sizes))
        axis = max(range(len(mesh)), key=lambda i: (sizes[i], -i))
        if sizes[axis] - self.spare_planes < 1:
            raise ValueError(f"spare_planes={self.spare_planes} leaves no "
                             f"partitionable plane of {hw.name}")
        shape = list(sizes)
        shape[axis] -= self.spare_planes
        return Rect((0,) * len(mesh), tuple(shape))

    # --------------------------------------------------------------- plan
    def plan(self, hw: HardwareModel, tenants: Sequence[TenantSpec], *,
             service: Any, budget: Optional[SearchBudget] = None,
             budget_ms: Optional[float] = None,
             tenant_budget_ms: Optional[Dict[str, float]] = None,
             regret_bound: Optional[float] = None,
             ) -> TenancyPlan:
        """The joint search.  ``tenant_budget_ms`` overrides the resolve
        deadline per tenant (the repartition path uses it to evict
        best-effort tenants to the fallback rung: deadline 0 walks the
        service ladder straight to rung 4).  ``regret_bound=0.0``
        disables the service's shape-family rung, forcing exact searches
        — the isolation property tests use it so in-partition plans are
        bit-for-bit the standalone submesh plans."""
        from repro_torch.planservice import PlanRequest
        from repro_torch.planservice.family import program_floor

        tenants = list(tenants)
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        region = self.region(hw)
        log: List[str] = []
        with trace.span("tenancy.plan", cat="tenancy", hw=hw.name,
                        k=len(tenants)):
            layouts = enumerate_layouts(
                region, [t.weight for t in tenants],
                cuts_per_split=self.cuts_per_split,
                max_layouts=self.max_layouts)
            metrics.inc("tenancy_layouts_total", len(layouts), hw=hw.name)

            # ---- phase 1: admissible roofline ranking (no search) -------
            sub_memo: Dict[Tuple[int, ...], HardwareModel] = {}
            floor_memo: Dict[Tuple[int, str], float] = {}

            def sub_of(rect: Rect) -> HardwareModel:
                key = rect.origin + rect.shape
                sub = sub_memo.get(key)
                if sub is None:
                    sub = sub_memo[key] = submesh(hw, rect.origin, rect.shape)
                return sub

            def floor_of(i: int, rect: Rect) -> float:
                try:
                    sub = sub_of(rect)
                except ValueError:       # window has no healthy cores
                    return float("inf")
                key = (i, keying.hw_digest(sub))
                f = floor_memo.get(key)
                if f is None:
                    f = floor_memo[key] = min(
                        program_floor(p, sub) for p in tenants[i].programs)
                return f

            def proxy_score(layout: Tuple[Rect, ...]) -> Tuple[float, float]:
                floors = [floor_of(i, r) for i, r in enumerate(layout)]
                return (max(floors), sum(floors))

            ranked = sorted(range(len(layouts)),
                            key=lambda j: proxy_score(layouts[j]) + (j,))
            finalists = ranked[:self.plan_layouts]
            log.append(f"{len(layouts)} layouts, "
                       f"{len(finalists)} planned for real")

            # ---- phase 2: plan the finalists through the service --------
            resolve_memo: Dict[Tuple[int, str], Any] = {}

            def resolve(i: int, rect: Rect) -> Any:
                sub = sub_of(rect)
                key = (i, keying.hw_digest(sub))
                if key in resolve_memo:
                    return resolve_memo[key]
                t = tenants[i]
                ms = budget_ms
                if tenant_budget_ms and t.name in tenant_budget_ms:
                    ms = tenant_budget_ms[t.name]
                resp = service.resolve(PlanRequest(
                    programs=list(t.programs), hw=sub, budget=budget,
                    budget_ms=ms, regret_bound=regret_bound))
                resolve_memo[key] = resp
                return resp

            best: Optional[Tuple[Tuple[float, float], int]] = None
            for j in finalists:
                if proxy_score(layouts[j])[0] == float("inf"):
                    log.append(f"layout {j} infeasible (dead partition)")
                    continue
                times = []
                feasible = True
                for i, rect in enumerate(layouts[j]):
                    resp = resolve(i, rect)
                    if resp.result is None:
                        feasible = False
                        break
                    times.append(resp.result.best.final_s)
                if not feasible:
                    log.append(f"layout {j} infeasible")
                    continue
                score = (max(times), sum(times))
                if best is None or score < best[0]:
                    best = (score, j)
            if best is None:
                raise RuntimeError(
                    f"no feasible {len(tenants)}-tenant layout of {hw.name} "
                    f"(every finalist had an unplannable partition)")
            score, j = best
            placements = []
            for i, rect in enumerate(layouts[j]):
                resp = resolve(i, rect)
                placements.append(TenantPlacement(
                    tenant=tenants[i], rect=rect, hw=sub_of(rect),
                    response=resp, rung=getattr(resp, "rung", "search")))
                metrics.inc("tenancy_plans_total", tenant=tenants[i].name,
                            rung=getattr(resp, "rung", "search"))
            log.append(f"layout {j} wins: makespan {score[0] * 1e6:.1f}us")
            return TenancyPlan(hw=hw, region=region, placements=placements,
                               layout_score=score[0],
                               n_layouts=len(layouts), log=log)
