"""Spatiotemporal mapping (paper S2.2).

A mapping decides how the iteration space of the ``affine.parallel`` loop —
the logical multidimensional tile grid — is assigned to physical cores and to
time.  Following the paper, mappings are *tiling-based*: contiguous regions of
the iteration space go to contiguous spatial regions of the core array or to
contiguous temporal *waves*.

The design space is the paper's three coupled choices:

1. each parallel (grid) dim maps to **zero or more** hardware spatial dims;
2. when a grid dim is tiled by multiple spatial dims, the **tiling order**
   matters (different orders induce different layouts / reuse);
3. residual extents become **temporal wave loops** whose order is itself a
   design choice.

``enumerate_mappings`` produces the full space; each :class:`Mapping` then
yields the concrete loop-nest structure (Listing 2) and rewritten affine
accesses that reuse analysis and the performance model consume.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping as TMapping, Optional, Sequence, Tuple

from .affine import AffineExpr, AffineMap
from .hw import HardwareModel
from .program import LoopDim, TileAccess, TileProgram


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class SpatialBind:
    """One hardware spatial dim consumed by one loop dim.

    ``reduce=False`` binds a parallel grid dim (the historical case).
    ``reduce=True`` binds a *reduction* (sequential) dim: the cores along
    ``hw_dim`` each execute a contiguous chunk of the sequential loop and
    produce partial results that must be combined (split-K style spatial
    reduction; ``grid_dim`` then names a program *seq* dim).
    """
    hw_dim: str
    hw_size: int
    grid_dim: str
    reduce: bool = False


@dataclass(frozen=True)
class TemporalLoop:
    """A wave loop over the residual extent of one grid dim (Listing 2's
    ``%tx`` / ``%ty``)."""
    name: str                      # "t_<grid_dim>"
    grid_dim: str
    extent: int


@dataclass(frozen=True)
class Mapping:
    """A fixed spatiotemporal mapping of a program onto a hardware mesh.

    Loop-nest structure implied (outermost -> innermost), matching Listing 2:

        affine.parallel (hw spatial dims)        # truly parallel cores
          affine.for (temporal wave loops, in ``temporal`` order)
            scf.for (program sequential dims)
              <tile body>
    """
    program: TileProgram
    hw_name: str
    hw_dims: Tuple[Tuple[str, int], ...]          # full mesh (name, size)
    spatial: Tuple[SpatialBind, ...]              # tiling order: outer digit first
    temporal: Tuple[TemporalLoop, ...]            # outer -> inner
    # how spatial partial sums along reduce binds are combined ("" = no
    # reduce binds): "accum" = accumulate-in-place at global memory (RMW),
    # "tree"/"chain" = partials forwarded along the axis NoC to an
    # owner core (log-depth combining tree / neighbor chain) which stores.
    reduce_style: str = ""

    # -- derived structure -----------------------------------------------------
    def spatial_for(self, grid_dim: str) -> Tuple[SpatialBind, ...]:
        return tuple(b for b in self.spatial
                     if b.grid_dim == grid_dim and not b.reduce)

    def spatial_factor(self, grid_dim: str) -> int:
        return math.prod(b.hw_size for b in self.spatial_for(grid_dim)) or 1

    # -- spatial reduction (split-K) -------------------------------------------
    def reduce_binds(self) -> Tuple[SpatialBind, ...]:
        return tuple(b for b in self.spatial if b.reduce)

    def reduce_for(self, seq_dim: str) -> Tuple[SpatialBind, ...]:
        return tuple(b for b in self.spatial
                     if b.reduce and b.grid_dim == seq_dim)

    def reduce_factor(self, seq_dim: str) -> int:
        """Number of mesh slots the sequential dim is split across."""
        return math.prod(b.hw_size for b in self.reduce_for(seq_dim)) or 1

    def seq_extent(self, seq_dim: str) -> int:
        """Per-core residual extent of one sequential loop: the declared
        extent divided (ceil) across the dim's reduce binds."""
        ext = self.program.dim(seq_dim).extent
        f = self.reduce_factor(seq_dim)
        return _ceil(ext, f) if f > 1 else ext

    def seq_loops(self) -> Tuple[Tuple[str, int], ...]:
        """(name, effective extent) of the sequential nest, outer -> inner."""
        loops = self.__dict__.get("_seq_loops")
        if loops is None:
            loops = tuple((d.name, self.seq_extent(d.name))
                          for d in self.program.seq_dims)
            object.__setattr__(self, "_seq_loops", loops)
        return loops

    def cost_loops(self) -> Tuple[Tuple[str, int], ...]:
        """The schedulable (temporal + sequential) loop nest with per-core
        effective extents — the single loop list every cost layer
        (perfmodel, bound context, batch engine, reuse hoisting) consumes,
        so split-K extents cannot diverge between them."""
        loops = self.__dict__.get("_cost_loops")
        if loops is None:
            loops = tuple((t.name, t.extent) for t in self.temporal) \
                + self.seq_loops()
            object.__setattr__(self, "_cost_loops", loops)
        return loops

    def inner_iters(self) -> int:
        """Per-core sequential iterations per wave (split-K divides this)."""
        return math.prod(e for _, e in self.seq_loops()) or 1

    def active_reduce_factor(self) -> int:
        """Active mesh slots along the reduce binds: digits whose sequential
        chunk is non-empty (exact for the single-axis splits the enumerator
        produces; ragged splits leave trailing digits idle)."""
        n = 1
        for d in self.program.seq_dims:
            if self.reduce_factor(d.name) > 1:
                n *= _ceil(d.extent, self.seq_extent(d.name))
        return n

    def reduce_stages(self) -> Tuple[Tuple[str, int], ...]:
        """Per-axis stages of the partial-sum combine, outer -> inner:
        ``(hw_dim, active digits along it)``.  The cost layers charge one
        staged combining leg per stage (mirroring the staged-multicast
        accounting of broadcasts), so a multi-bind reduction is never
        double-counted.  Single binds (all the enumerator emits) carry the
        dim's exact active-digit count, making the stage product equal
        :meth:`active_reduce_factor`; for a (deserialized) multi-bind dim
        the raggedness is attributed to the outermost digit (mixed-radix
        ceiling), which can overcount idle trailing digits — a modeling
        approximation only reachable outside the enumerated space."""
        stages = self.__dict__.get("_reduce_stages")
        if stages is None:
            out: List[Tuple[str, int]] = []
            for d in self.program.seq_dims:
                binds = self.reduce_for(d.name)
                if not binds:
                    continue
                digits = _ceil(d.extent, self.seq_extent(d.name))
                inner = math.prod(b.hw_size for b in binds[1:]) or 1
                out.append((binds[0].hw_dim, _ceil(digits, inner)))
                for b in binds[1:]:
                    out.append((b.hw_dim, b.hw_size))
            stages = tuple(out)
            object.__setattr__(self, "_reduce_stages", stages)
        return stages

    def wave_extent(self, grid_dim: str) -> int:
        return _ceil(self.program.dim(grid_dim).extent, self.spatial_factor(grid_dim))

    def used_hw_dims(self) -> Tuple[str, ...]:
        return tuple(b.hw_dim for b in self.spatial)

    def idle_hw_dims(self) -> Tuple[Tuple[str, int], ...]:
        used = set(self.used_hw_dims())
        return tuple((n, s) for n, s in self.hw_dims if n not in used)

    def active_cores(self) -> int:
        # called once per load option by the demand model — cache on the
        # frozen instance (does not enter dataclass eq/hash)
        n = self.__dict__.get("_active_cores")
        if n is None:
            n = 1
            for b in self.spatial:
                if not b.reduce:
                    n *= min(b.hw_size, self.program.dim(b.grid_dim).extent)
            n *= self.active_reduce_factor()
            object.__setattr__(self, "_active_cores", n)
        return n

    def total_cores(self) -> int:
        return math.prod(s for _, s in self.hw_dims)

    # -- fault feasibility -----------------------------------------------------
    def conflicts_with_faults(self, hw: HardwareModel) -> bool:
        """True iff any disabled core of ``hw`` would ever be active under
        this mapping — i.e. the mapping is infeasible on the degraded fabric.

        Ever-active reduces to active-at-the-all-zero-wave: each grid index
        is ``t * stride + digit(core)`` with ``stride >= 0``, so a core's
        activity threshold over any wave loop is monotone and the wave-0
        active set is the union over all waves (the same monotonicity the
        wave-class simulator's threshold grouping relies on).  Cores on
        idle hardware dims occupy implicit plane 0 (mirroring
        ``simulator._core_coords``), so a disabled core with a nonzero
        idle-dim coordinate never conflicts.
        """
        if not hw.disabled_cores:
            return False
        used = set(self.used_hw_dims())
        for full in hw.disabled_cores:
            env: Dict[str, int] = {}
            on_plane0 = True
            for dname, v in zip(hw.core.scaleout, full):
                if dname in used:
                    env[dname] = v
                elif v != 0:
                    on_plane0 = False
                    break
            if not on_plane0:
                continue
            for t in self.temporal:
                env[t.name] = 0
            active = True
            for gd in self.program.grid_dims:
                if self.grid_index_expr(gd.name).evaluate(env) >= gd.extent:
                    active = False
                    break
            if active:
                for sd in self.program.seq_dims:
                    if self.reduce_factor(sd.name) > 1 \
                            and self.seq_index_expr(sd.name).evaluate(
                                {**env, sd.name: 0}) >= sd.extent:
                        active = False
                        break
            if active:
                return True
        return False

    def utilization(self) -> float:
        """Fraction of (core x wave) slots holding real (non-padded) tiles."""
        u = 1.0
        for d in self.program.grid_dims:
            padded = self.spatial_factor(d.name) * self.wave_extent(d.name)
            u *= d.extent / padded
        # split reduction dims pad to (mesh slots x per-core chunk)
        for d in self.program.seq_dims:
            f = self.reduce_factor(d.name)
            if f > 1:
                u *= d.extent / (f * self.seq_extent(d.name))
        # idle hw dims waste whole planes of the machine
        for _, s in self.idle_hw_dims():
            u /= s
        return u

    def n_waves(self) -> int:
        return math.prod(t.extent for t in self.temporal) or 1

    # -- index rewriting ---------------------------------------------------------
    def grid_index_expr(self, grid_dim: str) -> AffineExpr:
        """Reconstruct the logical grid index from (wave, spatial digits).

        With binds [h1(s1), h2(s2)] (tiling order: h1 outer) and wave t:
            g = t * s1 * s2 + h1 * s2 + h2

        Memoized per instance: the reuse analysis rewrites every access of
        every mapping through these expressions.
        """
        cache = self.__dict__.get("_grid_exprs")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_grid_exprs", cache)
        hit = cache.get(grid_dim)
        if hit is not None:
            return hit
        expr = self._grid_index_expr(grid_dim)
        cache[grid_dim] = expr
        return expr

    def _grid_index_expr(self, grid_dim: str) -> AffineExpr:
        binds = self.spatial_for(grid_dim)
        terms: Dict[str, int] = {}
        stride = 1
        for b in reversed(binds):              # innermost digit has stride 1
            terms[b.hw_dim] = stride
            stride *= b.hw_size
        t = self._temporal_for(grid_dim)
        if t is not None and t.extent > 1:
            terms[t.name] = stride
        elif t is not None:
            pass                                # extent-1 wave: index 0
        return AffineExpr.linear(terms)

    def _temporal_for(self, grid_dim: str) -> Optional[TemporalLoop]:
        for t in self.temporal:
            if t.grid_dim == grid_dim:
                return t
        return None

    def seq_index_expr(self, seq_dim: str) -> AffineExpr:
        """Reconstruct the logical sequential index from the reduce-bind
        digits and the per-core loop variable (blocked split: core digit d
        along a reduce bind owns the contiguous chunk
        ``[d * seq_extent, (d+1) * seq_extent)``):

            k_global = digit(core) * seq_extent + k_local
        """
        cache = self.__dict__.get("_grid_exprs")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_grid_exprs", cache)
        key = ("seq", seq_dim)
        hit = cache.get(key)
        if hit is not None:
            return hit
        binds = self.reduce_for(seq_dim)
        terms: Dict[str, int] = {seq_dim: 1}
        stride = self.seq_extent(seq_dim)
        for b in reversed(binds):          # innermost digit has stride E_eff
            terms[b.hw_dim] = stride
            stride *= b.hw_size
        expr = AffineExpr.linear(terms)
        cache[key] = expr
        return expr

    def rewrite_access(self, access: TileAccess) -> AffineMap:
        """Substitute grid dims with their (wave, spatial) reconstruction and
        reduce-bound sequential dims with their (digit, local) split.

        Cached on the (shared, frozen) access object keyed by the grid
        expressions actually substituted: mappings that reconstruct the
        access's grid dims identically — very common across the enumerated
        space — share one rewritten map object (which in turn lets the
        downstream footprint analysis memoize per rewritten map).
        """
        m = access.index
        subs = tuple((d.name, self.grid_index_expr(d.name))
                     for d in self.program.grid_dims
                     if m.depends_on(d.name))
        subs += tuple((d.name, self.seq_index_expr(d.name))
                      for d in self.program.seq_dims
                      if self.reduce_factor(d.name) > 1
                      and m.depends_on(d.name))
        cache = access.__dict__.get("_rewrite_cache")
        if cache is None:
            cache = {}
            object.__setattr__(access, "_rewrite_cache", cache)
        hit = cache.get(subs)
        if hit is not None:
            return hit
        for name, expr in subs:
            m = m.substitute(name, expr)
        cache[subs] = m
        return m

    # -- loop nest (for reuse analysis & printing) --------------------------------
    def loop_nest(self) -> Tuple[Tuple[str, str, int], ...]:
        """(kind, name, extent) outer->inner; kind in
        {"spatial", "temporal", "sequential"}."""
        nest: List[Tuple[str, str, int]] = []
        for b in self.spatial:
            nest.append(("spatial", b.hw_dim, b.hw_size))
        for t in self.temporal:
            nest.append(("temporal", t.name, t.extent))
        for name, ext in self.seq_loops():
            nest.append(("sequential", name, ext))
        return tuple(nest)

    def extents_env(self) -> Dict[str, int]:
        env = dict(self.program.extents)
        for name, ext in self.seq_loops():
            env[name] = ext
        for b in self.spatial:
            env[b.hw_dim] = b.hw_size
        for t in self.temporal:
            env[t.name] = t.extent
        return env

    def describe(self) -> str:
        sp = ", ".join(
            f"{b.grid_dim}{'=>' if b.reduce else '->'}%{b.hw_dim}({b.hw_size})"
            for b in self.spatial)
        tp = ", ".join(f"{t.name}({t.extent})" for t in self.temporal)
        red = f" | reduce: {self.reduce_style}" if self.reduce_style else ""
        return f"[spatial: {sp or '-'} | temporal: {tp or '-'}{red}]"

    def mlir_like(self) -> str:
        """Render the mapped loop structure in the paper's Listing-2 style."""
        lines = []
        sp_dims = ", ".join(f"%{b.hw_dim}" for b in self.spatial)
        sp_sizes = ", ".join(str(b.hw_size) for b in self.spatial)
        indent = ""
        if self.spatial:
            lines.append(f"affine.parallel ({sp_dims}) = (0) to ({sp_sizes}) {{")
            indent += "  "
        for t in self.temporal:
            lines.append(f"{indent}affine.for %{t.name} = 0 to {t.extent} {{")
            indent += "  "
        for name, ext in self.seq_loops():
            lines.append(f"{indent}scf.for %{name} = 0 to {ext} {{")
            indent += "  "
        lines.append(f"{indent}// tile body: "
                     + ", ".join(op.kind for op in self.program.body))
        while indent:
            indent = indent[:-2]
            lines.append(f"{indent}}}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Enumeration
# --------------------------------------------------------------------------
# enumeration order of the reduction styles: the analytic model costs
# "tree" and "chain" identically (same per-resource demand; only the
# simulator's hop-depth term separates them), so the log-depth tree — the
# one the profiling stage prefers — must take the earlier canonical index
# and win exact model-cost ties.
REDUCE_STYLES = ("tree", "chain", "accum")


def enumerate_mappings(program: TileProgram, hw: HardwareModel, *,
                       allow_idle_dims: bool = True,
                       max_candidates: int = 512,
                       allow_reduction: bool = True) -> Tuple[Mapping, ...]:
    """Enumerate the paper's mapping design space.

    For every function ``hw_dim -> grid_dim | idle`` we derive the set of
    spatial binds; for every grid dim bound to >=2 hw dims we expand all tiling
    orders; residual grid dims with wave extent > 1 generate temporal loops in
    all orders.  Degenerate duplicates (idle dims that could host work while a
    grid dim still has residual extent) are kept only if ``allow_idle_dims`` —
    they are occasionally optimal for very small grids (paper S3.2 small-shape
    regime).

    With ``allow_reduction`` a second pass extends the space with **spatial
    reductions**: one hardware dim hosts a sequential (reduction) dim via a
    ``reduce=True`` bind (split-K), crossed with every parallel assignment of
    the remaining dims and every partial-combining style
    (:data:`REDUCE_STYLES`).  The pass runs strictly *after* the parallel
    space so existing mappings keep their canonical indices (exact cost ties
    still resolve to the historical plan), and it has its own
    ``max_candidates`` allowance so a large parallel space cannot starve the
    reduction space out of a capped enumeration.
    """
    program.validate()
    mesh = hw.mesh_dims
    grid_names = [d.name for d in program.grid_dims]
    out: List[Mapping] = []
    seen = set()
    # Degraded fabrics: mappings that would ever activate a disabled core
    # are infeasible and never enter the candidate list.  The guard keeps
    # the fault-free path byte-identical (same mappings, same canonical
    # indices) — `conflicts_with_faults` is only consulted when an overlay
    # is present.
    degraded = bool(hw.disabled_cores)

    def expand(par_mesh, combo, extra_binds, styles, cap):
        """Expand one parallel assignment (``combo`` over ``par_mesh``) into
        mappings: tiling orders x temporal orders x styles, with
        ``extra_binds`` (the reduce binds) appended to the spatial tuple.
        Returns False when the cap was hit."""
        by_grid: Dict[str, List[Tuple[str, int]]] = {}
        for (hw_name, hw_size), g in zip(par_mesh, combo):
            if g is not None:
                by_grid.setdefault(g, []).append((hw_name, hw_size))
        if not allow_idle_dims and len(by_grid) == 0 and grid_names \
                and not extra_binds:
            return True
        # skip assignments where a hw dim is idle while unassigned grid dims
        # exist *and* idle dims are disallowed
        if not allow_idle_dims:
            idle = len(par_mesh) - sum(len(v) for v in by_grid.values())
            unassigned = [g for g in grid_names if g not in by_grid]
            if idle > 0 and unassigned:
                return True
        # expand tiling orders per grid dim with multiple binds
        order_spaces = []
        for g in grid_names:
            binds = by_grid.get(g, [])
            if len(binds) > 1:
                order_spaces.append([tuple(p)
                                     for p in itertools.permutations(binds)])
            else:
                order_spaces.append([tuple(binds)])
        for orders in itertools.product(*order_spaces):
            spatial: List[SpatialBind] = []
            for g, binds in zip(grid_names, orders):
                for hw_name, hw_size in binds:
                    spatial.append(SpatialBind(hw_name, hw_size, g))
            spatial.extend(extra_binds)
            # temporal loops for residual extents
            residual = []
            for d in program.grid_dims:
                sf = math.prod(b.hw_size for b in spatial
                               if b.grid_dim == d.name and not b.reduce) or 1
                ext = _ceil(d.extent, sf)
                residual.append((d.name, ext))
            movable = [(g, e) for g, e in residual if e > 1]
            temporal_orders = (list(itertools.permutations(movable))
                               if movable else [()])
            for t_order in temporal_orders:
                temporal = tuple(TemporalLoop(f"t_{g}", g, e)
                                 for g, e in t_order)
                # extent-1 waves are dropped (index fixed at 0)
                for style in styles:
                    m = Mapping(program=program, hw_name=hw.name,
                                hw_dims=mesh, spatial=tuple(spatial),
                                temporal=temporal, reduce_style=style)
                    key = (m.spatial, m.temporal, style)
                    if key in seen:
                        continue
                    seen.add(key)
                    if degraded and m.conflicts_with_faults(hw):
                        continue
                    out.append(m)
                    if len(out) >= cap:
                        return False
        return True

    # ---- pass 1: the historical parallel-only space -----------------------
    # a cap hit ends *this pass* (truncating exactly the tail the historical
    # enumeration truncated) but not the reduction pass below, which owns an
    # equal allowance — so small `max_mappings` budgets (REPRO_FAST_SEARCH)
    # still see split-K candidates
    choices = [grid_names + [None] for _ in mesh]
    for combo in itertools.product(*choices):
        if not expand(mesh, combo, (), ("",), max_candidates):
            break

    # ---- pass 2: spatial reductions (split-K binds) -----------------------
    # One sequential dim is bound to one hardware axis; the output must be
    # invariant to the whole sequential nest (the accumulator pattern) so
    # the partial combine is a single epilogue after the per-core loops.
    if not allow_reduction or not program.seq_dims:
        return tuple(out)
    seq_names = {d.name for d in program.seq_dims}
    if any(st.index.dims & seq_names for st in program.stores):
        return tuple(out)
    cap2 = len(out) + max_candidates
    for ax_i, (ax_name, ax_size) in enumerate(mesh):
        if ax_size <= 1:
            continue
        # forwarding needs a NoC ring along the axis; accumulate-in-place
        # only needs the store path
        styles = (REDUCE_STYLES if hw.interconnect_along(ax_name) is not None
                  else ("accum",))
        rest = tuple(m for j, m in enumerate(mesh) if j != ax_i)
        rest_choices = [grid_names + [None] for _ in rest]
        for rd in program.seq_dims:
            if rd.extent <= 1:
                continue
            rbind = (SpatialBind(ax_name, ax_size, rd.name, reduce=True),)
            for combo in (itertools.product(*rest_choices) if rest else [()]):
                if not expand(rest, combo, rbind, styles, cap2):
                    return tuple(out)
    return tuple(out)
