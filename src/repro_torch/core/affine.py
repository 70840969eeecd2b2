"""Tiny affine-expression algebra used by the TileLoom planner.

The paper's front-end "affinizes" all memory-address arithmetic: every load and
store address is an affine function of loop induction variables (tile indices
and intra-tile indices).  This module provides exactly the algebra the
planner's reuse analysis (paper S2.3) needs:

* ``AffineExpr``   — integer-linear combination of named dims plus a constant,
                     with optional ``mod``/``floordiv`` wrappers (needed for the
                     wrap-around links in the df interconnect maps, Listing 6).
* ``AffineMap``    — a tuple of exprs, mapping an index space to another.
* dependence tests — "does this access depend on dim d?" drives both spatial
                     and temporal reuse detection.
* footprints       — number of distinct tiles touched while a set of dims
                     ranges over their extents (drives hoisting buffer sizes).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Sequence, Tuple


@dataclass(frozen=True)
class AffineExpr:
    """``sum_i coeffs[d_i] * d_i + const``, optionally followed by mod/floordiv.

    ``mod`` and ``floordiv`` are applied (in that order: ``(e mod m) // f``)
    after the linear part; either may be ``None``.  This is enough to express
    every map in the paper's listings (e.g. ``(d0 + 1) mod 8`` for ring links
    and ``d0 ceildiv 4`` for DRAM-channel muxes — ceildiv is normalised to
    floordiv by the caller).
    """

    coeffs: Tuple[Tuple[str, int], ...] = ()
    const: int = 0
    mod: int | None = None
    floordiv: int | None = None

    # -- constructors -------------------------------------------------------
    @staticmethod
    def var(name: str, coeff: int = 1) -> "AffineExpr":
        return AffineExpr(coeffs=((name, coeff),))

    @staticmethod
    def const_expr(c: int) -> "AffineExpr":
        return AffineExpr(const=c)

    @staticmethod
    def linear(terms: Mapping[str, int], const: int = 0) -> "AffineExpr":
        items = tuple(sorted((k, v) for k, v in terms.items() if v != 0))
        return AffineExpr(coeffs=items, const=const)

    # -- algebra (only valid on pure-linear exprs) ---------------------------
    def _check_linear(self) -> None:
        if self.mod is not None or self.floordiv is not None:
            raise ValueError("operation only defined for pure-linear exprs")

    def __add__(self, other: "AffineExpr") -> "AffineExpr":
        self._check_linear(); other._check_linear()
        terms: Dict[str, int] = dict(self.coeffs)
        for k, v in other.coeffs:
            terms[k] = terms.get(k, 0) + v
        return AffineExpr.linear(terms, self.const + other.const)

    def __mul__(self, scalar: int) -> "AffineExpr":
        self._check_linear()
        return AffineExpr.linear({k: v * scalar for k, v in self.coeffs}, self.const * scalar)

    def with_mod(self, m: int) -> "AffineExpr":
        return AffineExpr(self.coeffs, self.const, mod=m, floordiv=self.floordiv)

    def with_floordiv(self, f: int) -> "AffineExpr":
        return AffineExpr(self.coeffs, self.const, mod=self.mod, floordiv=f)

    # -- queries -------------------------------------------------------------
    @property
    def dims(self) -> frozenset:
        # dependence tests are the single hottest query of the reuse
        # analysis (tens of thousands per planned kernel) — cache the dim
        # set on the frozen instance (extra slot never enters dataclass
        # eq/hash, which are generated from the declared fields)
        ds = self.__dict__.get("_dims")
        if ds is None:
            ds = frozenset(k for k, v in self.coeffs if v != 0)
            object.__setattr__(self, "_dims", ds)
        return ds

    def depends_on(self, dim: str) -> bool:
        return dim in self.dims

    def coeff_of(self, dim: str) -> int:
        for k, v in self.coeffs:
            if k == dim:
                return v
        return 0

    def evaluate(self, env: Mapping[str, int]) -> int:
        val = self.const + sum(v * env[k] for k, v in self.coeffs)
        if self.mod is not None:
            val = val % self.mod
        if self.floordiv is not None:
            val = val // self.floordiv
        return val

    def rename(self, renames: Mapping[str, str]) -> "AffineExpr":
        return AffineExpr(
            tuple(sorted((renames.get(k, k), v) for k, v in self.coeffs)),
            self.const, self.mod, self.floordiv)

    def substitute(self, dim: str, replacement: "AffineExpr") -> "AffineExpr":
        """Substitute ``dim := replacement`` (replacement must be linear)."""
        replacement._check_linear()
        c = self.coeff_of(dim)
        if c == 0:
            return self
        base = AffineExpr.linear(
            {k: v for k, v in self.coeffs if k != dim}, self.const)
        out = base + replacement * c
        return AffineExpr(out.coeffs, out.const, self.mod, self.floordiv)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        parts = [f"{v}*{k}" for k, v in self.coeffs] or []
        if self.const or not parts:
            parts.append(str(self.const))
        s = " + ".join(parts)
        if self.mod is not None:
            s = f"({s}) mod {self.mod}"
        if self.floordiv is not None:
            s = f"({s}) floordiv {self.floordiv}"
        return s


@dataclass(frozen=True)
class AffineMap:
    """A tuple of affine expressions: index-space -> index-space map."""

    exprs: Tuple[AffineExpr, ...]

    @staticmethod
    def from_terms(*term_dicts: Mapping[str, int]) -> "AffineMap":
        return AffineMap(tuple(AffineExpr.linear(t) for t in term_dicts))

    @staticmethod
    def identity(dims: Sequence[str]) -> "AffineMap":
        return AffineMap(tuple(AffineExpr.var(d) for d in dims))

    @property
    def dims(self) -> frozenset:
        ds = self.__dict__.get("_dims")
        if ds is None:
            ds = frozenset()
            for e in self.exprs:
                ds = ds | e.dims
            object.__setattr__(self, "_dims", ds)
        return ds

    def depends_on(self, dim: str) -> bool:
        return dim in self.dims

    def evaluate(self, env: Mapping[str, int]) -> Tuple[int, ...]:
        return tuple(e.evaluate(env) for e in self.exprs)

    def rename(self, renames: Mapping[str, str]) -> "AffineMap":
        return AffineMap(tuple(e.rename(renames) for e in self.exprs))

    def substitute(self, dim: str, replacement: AffineExpr) -> "AffineMap":
        return AffineMap(tuple(e.substitute(dim, replacement) for e in self.exprs))

    def __iter__(self):
        return iter(self.exprs)

    def __len__(self) -> int:
        return len(self.exprs)


def distinct_points(map_: AffineMap, extents: Mapping[str, int],
                    over: Iterable[str]) -> int:
    """Number of distinct output points of ``map_`` as dims in ``over`` range
    over ``[0, extents[d])`` (other dims held fixed at 0).

    Used to size hoisted buffers (paper S2.3: hoisting across a loop the access
    *depends on* enlarges the buffered region proportionally to that loop's
    extent; hoisting across an independent loop does not).  Exact enumeration —
    the planner only ever calls this with small tile-grid extents, never with
    element-level extents.
    """
    over = [d for d in over if map_.depends_on(d)]
    if not over:
        return 1
    total = 1
    for d in over:
        total *= extents[d]
    # Fast path: each ranging dim appears in exactly one expr, all exprs are
    # pure-linear, and within each expr the coefficients form a mixed-radix
    # system (|c_{i+1}| >= |c_i| * extent_i when sorted by |coeff|).  Then
    # every combination yields a distinct output point and the count is just
    # the product of extents.  This covers all maps the mapper constructs
    # (grid-index reconstruction is mixed-radix by design).
    if _is_mixed_radix(map_, extents, over):
        return total
    if total > 4_000_000:  # pragma: no cover - safety net for degenerate input
        raise ValueError(f"footprint enumeration too large: {total}")
    seen = set()
    ranges = [range(extents[d]) for d in over]
    env = {d: 0 for d in map_.dims}
    for point in itertools.product(*ranges):
        env.update(zip(over, point))
        seen.add(map_.evaluate(env))
    return len(seen)


def _is_mixed_radix(map_: AffineMap, extents: Mapping[str, int],
                    over: Sequence[str]) -> bool:
    over_set = set(over)
    seen_dims = set()
    for e in map_.exprs:
        if e.mod is not None or e.floordiv is not None:
            if e.dims & over_set:
                return False
            continue
        terms = [(d, abs(c)) for d, c in e.coeffs if d in over_set and c != 0]
        for d, _ in terms:
            if d in seen_dims:         # dim feeds two exprs: cannot decouple
                return False
            seen_dims.add(d)
        terms.sort(key=lambda t: t[1])
        bound = 1
        for d, c in terms:
            if c < bound:
                return False
            bound = c * extents[d]
    return True


def footprint_tiles(map_: AffineMap, extents: Mapping[str, int],
                    inner_dims: Sequence[str]) -> int:
    """Tiles that must be simultaneously live when a load of ``map_`` is hoisted
    above all of ``inner_dims`` (paper's hoisting rule, Listing 4).

    Memoized per map instance: the result depends only on the ranging dims
    the map reads and their extents, and the reuse analysis shares rewritten
    maps across mappings (``Mapping.rewrite_access``), so repeated hoists of
    the same access shape hit the cache."""
    key = tuple((d, extents[d]) for d in inner_dims if d in map_.dims)
    cache = map_.__dict__.get("_fp_cache")
    if cache is None:
        cache = {}
        object.__setattr__(map_, "_fp_cache", cache)
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = distinct_points(map_, extents, inner_dims)
    return hit
