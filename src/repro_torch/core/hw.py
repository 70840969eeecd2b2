"""The ``df`` hardware-representation dialect (paper S2.4), in Python.

The paper encodes hardware as an MLIR dialect; we mirror it 1:1 as a small set
of frozen dataclasses plus a :class:`HardwareModel` container.  The three
abstraction layers of the paper are preserved:

* **scale-out**  — ``SpatialDim`` / ``Core`` / ``Interconnect``   (consumed by
  spatiotemporal mapping, S2.2)
* **memories**   — ``Memory`` / ``Mux``                            (consumed by
  data-movement planning, S2.3)
* **intra-core** — ``MatUnit`` / ``VecUnit`` / ``ScalarUnit``      (consumed by
  the performance model, S2.5)

``HardwareModel.df_text()`` renders the description in the paper's textual
``df``-dialect syntax so that tests can assert structural fidelity with the
paper's Listings 6-9.

Presets are provided for the paper's evaluation targets (Tenstorrent Wormhole
8x8 / 4x8 / 1x8, an IBM-Spyre-like 1D triple ring) and for the TPU-v5e targets
of the deployment layer (16x16 single pod, 2x16x16 multi-pod) — see DESIGN.md
S4 for the adaptation rationale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .affine import AffineExpr, AffineMap

GB = 1_000_000_000
MB = 1_000_000


# --------------------------------------------------------------------------
# df operators
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SpatialDim:
    """``df.spatial_dim(size)`` — an abstract dimension indexing replicated
    hardware components (cores, memories, DRAM channels...)."""
    name: str
    size: int


@dataclass(frozen=True)
class MatUnit:
    """``df.mat(shape, throughput)`` — a matrix unit (MXU / Tensix FPU).

    ``shape=(m, k, n)`` is the intrinsic matmul tile; ``intrinsics_per_cycle``
    is the paper's per-unit issue rate ``r`` (may be fractional: an intrinsic
    that takes 128 cycles has r = 1/128).
    """
    name: str
    shape: Tuple[int, int, int]
    intrinsics_per_cycle: float
    count: int = 1

    @property
    def flops_per_intrinsic(self) -> int:
        m, k, n = self.shape
        return 2 * m * k * n

    def flops_per_cycle(self) -> float:
        return self.flops_per_intrinsic * self.intrinsics_per_cycle * self.count


@dataclass(frozen=True)
class VecUnit:
    """``df.vec(shape, throughput)`` — a vector/SIMD unit; ``width`` lanes,
    ``r`` intrinsic issues per cycle (one intrinsic = ``width`` element ops)."""
    name: str
    width: int
    intrinsics_per_cycle: float
    count: int = 1

    def elems_per_cycle(self) -> float:
        return self.width * self.intrinsics_per_cycle * self.count


@dataclass(frozen=True)
class ScalarUnit:
    """``df.scalar(latency)``."""
    name: str
    latency_cycles: float = 1.0


@dataclass(frozen=True)
class Core:
    """``df.core(scaleout, scalein)`` — a set of cores indexed by spatial dims
    with intra-core compute units."""
    name: str
    scaleout: Tuple[str, ...]                      # spatial-dim names
    mat: Optional[MatUnit] = None
    vec: Optional[VecUnit] = None
    scalar: Optional[ScalarUnit] = None


@dataclass(frozen=True)
class Memory:
    """``df.memory(scaleout, size, bandwidth)`` — replicated memories.

    ``bandwidth_gbps`` is per-instance port bandwidth.  ``level`` tags the role
    in the hierarchy ("local" scratchpad vs "global" DRAM/HBM) — the paper's
    listings distinguish these by how they are wired (mux vs interconnect); we
    keep an explicit tag as well for planner convenience.
    """
    name: str
    scaleout: Tuple[str, ...]
    size_bytes: int
    bandwidth_gbps: float
    level: str = "local"          # "local" | "global"

    def count(self, hw: "HardwareModel") -> int:
        n = 1
        for d in self.scaleout:
            n *= hw.dim(d).size
        return n


@dataclass(frozen=True)
class Mux:
    """``df.mux(dst, srcs, map)`` — 1-to-N connectivity (e.g. "each core
    accesses its local scratchpad", "groups of cores share a DRAM channel")."""
    name: str
    dst: str                       # component name (cores)
    src: str                       # component name (memories)
    map: AffineMap                 # dst coords -> src coords
    bandwidth_gbps: float


@dataclass(frozen=True)
class Interconnect:
    """``df.interconnects(components, map, bandwidth)`` — a set of links
    connecting ``src`` to ``dst`` instances per an affine map; per-link
    bandwidth.  For a 2D mesh's horizontal ring the map is
    ``(d0, d1) -> ((d0 + 1) mod X, d1)`` (paper Listing 6)."""
    name: str
    src: str
    dst: str
    map: AffineMap
    bandwidth_gbps: float

    def axis(self, dims: Sequence[str]) -> Optional[str]:
        """The spatial dim along which this interconnect moves data: the
        (single) output coordinate that is not the identity of its input dim.
        Returns None for non-shift topologies."""
        moved = []
        for i, d in enumerate(dims):
            e = self.map.exprs[i] if i < len(self.map.exprs) else None
            if e is None:
                continue
            identity = (e.coeffs == ((d, 1),) and e.const == 0
                        and e.mod is None and e.floordiv is None)
            if not identity:
                moved.append(d)
        return moved[0] if len(moved) == 1 else None


# --------------------------------------------------------------------------
# HardwareModel
# --------------------------------------------------------------------------
@dataclass
class HardwareModel:
    """A complete multi-layer df description of one target."""

    name: str
    clock_ghz: float
    spatial_dims: Tuple[SpatialDim, ...]
    core: Core
    local_mem: Memory
    core_to_local: Mux
    global_mem: Memory
    to_global: Mux                 # cores/L1 -> DRAM/HBM channel map
    interconnects: Tuple[Interconnect, ...]
    # Optional second-level scratch (e.g. TPU VMEM inside a chip whose "L1"
    # is HBM at the mesh planning level).
    scratch_mem: Optional[Memory] = None
    notes: str = ""
    # -- fault overlay (see with_faults) --------------------------------------
    # Coordinates are in ``core.scaleout`` order; link entries are
    # ``(interconnect_name, cumulative_bandwidth_factor)``.  Both participate
    # in ``df_text()`` so plan-cache keys distinguish degraded fabrics.
    disabled_cores: Tuple[Tuple[int, ...], ...] = ()
    degraded_links: Tuple[Tuple[str, float], ...] = ()

    # -- indexing ------------------------------------------------------------
    def dim(self, name: str) -> SpatialDim:
        for d in self.spatial_dims:
            if d.name == name:
                return d
        raise KeyError(name)

    @property
    def mesh_dims(self) -> Tuple[Tuple[str, int], ...]:
        """Spatial dims that index cores, in declaration order."""
        return tuple((d, self.dim(d).size) for d in self.core.scaleout)

    @property
    def n_cores(self) -> int:
        return math.prod(s for _, s in self.mesh_dims)

    # -- interconnect queries --------------------------------------------------
    def interconnect_along(self, axis: str) -> Optional[Interconnect]:
        # queried per load option per mapping (the reuse analysis and both
        # cost engines); the answer is a pure function of the immutable
        # interconnect tuple, so memoize per instance
        cache = self.__dict__.get("_ic_along")
        if cache is None:
            cache = self.__dict__["_ic_along"] = {}
        if axis not in cache:
            cache[axis] = next(
                (ic for ic in self.interconnects
                 if ic.src == self.local_mem.name
                 and ic.axis(self.core.scaleout) == axis), None)
        return cache[axis]

    def noc_axes(self) -> Tuple[str, ...]:
        axes = self.__dict__.get("_noc_axes")
        if axes is None:
            axes = self.__dict__["_noc_axes"] = tuple(
                a for a, _ in self.mesh_dims if self.interconnect_along(a))
        return axes

    def links_of(self, ic: Interconnect) -> int:
        """Total number of physical links the interconnect declares (one per
        source instance for shift maps)."""
        n = 1
        for d in self.core.scaleout:
            n *= self.dim(d).size
        return n

    # -- memory queries --------------------------------------------------------
    def global_channels(self) -> int:
        return self.global_mem.count(self)

    def channel_of_core(self, coords: Mapping[str, int]) -> Tuple[int, ...]:
        return self.to_global.map.evaluate(dict(coords))

    def cores_per_channel(self) -> int:
        return max(1, self.n_cores // max(1, self.global_channels()))

    def local_capacity(self) -> int:
        return self.local_mem.size_bytes

    # -- fault overlay ---------------------------------------------------------
    @property
    def is_degraded(self) -> bool:
        return bool(self.disabled_cores or self.degraded_links)

    def disabled_core_set(self) -> frozenset:
        """Disabled core coordinates as a frozenset of tuples (memoized)."""
        s = self.__dict__.get("_disabled_set")
        if s is None:
            s = self.__dict__["_disabled_set"] = frozenset(self.disabled_cores)
        return s

    def is_disabled(self, coords: Mapping[str, int]) -> bool:
        """Whether the core at ``coords`` (spatial-dim name -> index; unbound
        dims default to plane 0) is disabled by the fault overlay."""
        if not self.disabled_cores:
            return False
        key = tuple(coords.get(d, 0) for d in self.core.scaleout)
        return key in self.disabled_core_set()

    @property
    def healthy_cores(self) -> int:
        return self.n_cores - len(self.disabled_cores)

    def with_faults(self, disabled_cores: Sequence[Sequence[int]] = (),
                    degraded_links: Sequence[Tuple[str, float]] = ()
                    ) -> "HardwareModel":
        """A copy of this model with additional faults applied on top of any
        existing overlay.

        ``disabled_cores`` are core coordinates (``core.scaleout`` order) that
        no mapping may ever activate; ``degraded_links`` are
        ``(interconnect_name, factor)`` pairs scaling per-link bandwidth by
        ``factor`` (0 < factor <= 1).  Repeated degradation of the same link
        composes multiplicatively.  The copy keeps the base ``name`` — the
        overlay is distinguished by ``df_text()`` (and therefore by plan-cache
        hardware digests), not by renaming.
        """
        import dataclasses

        n_dims = len(self.core.scaleout)
        new_disabled = set(self.disabled_cores)
        for c in disabled_cores:
            t = tuple(int(v) for v in c)
            if len(t) != n_dims:
                raise ValueError(
                    f"disabled core {t} has {len(t)} coords; "
                    f"{self.name} cores are indexed by {self.core.scaleout}")
            for v, d in zip(t, self.core.scaleout):
                if not 0 <= v < self.dim(d).size:
                    raise ValueError(f"disabled core {t}: coord {d}={v} out of "
                                     f"range [0, {self.dim(d).size})")
            new_disabled.add(t)
        if len(new_disabled) >= self.n_cores:
            raise ValueError(f"cannot disable all {self.n_cores} cores of "
                             f"{self.name}")

        ic_names = {ic.name for ic in self.interconnects}
        factors: Dict[str, float] = dict(self.degraded_links)
        scale: Dict[str, float] = {}
        for name, f in degraded_links:
            if name not in ic_names:
                raise ValueError(f"unknown interconnect {name!r}; "
                                 f"available: {sorted(ic_names)}")
            f = float(f)
            if not 0.0 < f <= 1.0:
                raise ValueError(f"degradation factor for {name} must be in "
                                 f"(0, 1], got {f}")
            factors[name] = factors.get(name, 1.0) * f
            scale[name] = scale.get(name, 1.0) * f
        new_ics = tuple(
            dataclasses.replace(ic, bandwidth_gbps=ic.bandwidth_gbps * scale[ic.name])
            if ic.name in scale else ic
            for ic in self.interconnects)
        # dataclasses.replace re-runs __init__, so per-instance memo caches
        # (_ic_along, _noc_axes, _disabled_set, ...) are dropped in the copy.
        return dataclasses.replace(
            self, interconnects=new_ics,
            disabled_cores=tuple(sorted(new_disabled)),
            degraded_links=tuple(sorted(factors.items())))

    # -- compute queries -------------------------------------------------------
    def peak_flops_per_core(self) -> float:
        if self.core.mat is None:
            return 0.0
        return self.core.mat.flops_per_cycle() * self.clock_ghz * 1e9

    def peak_flops(self) -> float:
        return self.peak_flops_per_core() * self.n_cores

    def peak_vec_elems_per_core(self) -> float:
        if self.core.vec is None:
            return 0.0
        return self.core.vec.elems_per_cycle() * self.clock_ghz * 1e9

    # -- df-dialect text --------------------------------------------------------
    def df_text(self) -> str:
        lines: List[str] = [f"// df description of {self.name}"]
        for d in self.spatial_dims:
            lines.append(f"%{d.name} = df.spatial_dim {d.size}")
        core = self.core
        scalein = []
        if core.mat:
            m = core.mat
            lines.append(
                f"%{m.name} = df.mat {{shape=[{m.shape[0]}, {m.shape[1]}, "
                f"{m.shape[2]}], throughput={m.intrinsics_per_cycle:g}}}")
            scalein.append(f"%{m.name}")
        if core.vec:
            v = core.vec
            lines.append(
                f"%{v.name} = df.vec {{shape=[{v.width}], "
                f"throughput={v.intrinsics_per_cycle:g}}}")
            scalein.append(f"%{v.name}")
        if core.scalar:
            s = core.scalar
            lines.append(f"%{s.name} = df.scalar {{latency={s.latency_cycles:g}}}")
            scalein.append(f"%{s.name}")
        so = ", ".join(f"%{d}" for d in core.scaleout)
        si = f", scalein=({', '.join(scalein)})" if scalein else ""
        lines.append(f"%{core.name} = df.core {{scaleout=({so}){si}}}")
        for mem in filter(None, [self.local_mem, self.scratch_mem, self.global_mem]):
            so = ", ".join(f"%{d}" for d in mem.scaleout)
            lines.append(
                f"%{mem.name} = df.memory {{scaleout=({so}), size={mem.size_bytes}, "
                f"bandwidth={mem.bandwidth_gbps:g}}}")
        for mux in [self.core_to_local, self.to_global]:
            lines.append(
                f"%{mux.name} = df.mux %{mux.dst}, %{mux.src}, "
                f"{{map={_map_text(mux.map)}, bandwidth={mux.bandwidth_gbps:g}}}")
        for ic in self.interconnects:
            lines.append(
                f"%{ic.name} = df.interconnects %{ic.src}, %{ic.dst}, "
                f"{{map={_map_text(ic.map)}, bandwidth={ic.bandwidth_gbps:g}}}")
        # Fault overlay: rendered last so a fault-free model's text is
        # byte-identical to pre-overlay output.  Degraded links already show
        # in the interconnect bandwidths above; the explicit lines make the
        # overlay legible and fork the hardware digest for disabled cores.
        for c in self.disabled_cores:
            coords = ", ".join(str(v) for v in c)
            lines.append(f"df.fault disable %{core.name}[{coords}]")
        for lname, f in self.degraded_links:
            lines.append(f"df.fault degrade %{lname} {{factor={f:g}}}")
        return "\n".join(lines)


def _map_text(m: AffineMap) -> str:
    ins = sorted(m.dims)
    outs = ", ".join(repr(e) for e in m.exprs)
    return f"affine_map<({', '.join(ins)}) -> ({outs})>"


# --------------------------------------------------------------------------
# Presets — paper targets (Tenstorrent Wormhole n300 socket)
# --------------------------------------------------------------------------
def _ring_map(dims: Sequence[Tuple[str, int]], axis: str, stride: int = 1) -> AffineMap:
    exprs = []
    for d, size in dims:
        if d == axis:
            exprs.append((AffineExpr.var(d) + AffineExpr.const_expr(stride)).with_mod(size))
        else:
            exprs.append(AffineExpr.var(d))
    return AffineMap(tuple(exprs))


def wormhole(rows: int = 8, cols: int = 8) -> HardwareModel:
    """Tenstorrent Wormhole socket as described in paper Listings 6-8 and S3.1.

    Constants from the paper: 64 Tensix cores @ 1 GHz, 1024 FP16 ops/cycle/core
    (=> 64 TFLOP/s per socket), ~1.5 MB L1 per core (1_499_136 B) at 60 GB/s,
    NoC rings at 28 GB/s/link, 12 GB GDDR6 at 288 GB/s total across 4 edge
    channel groups (each 4x4 quadrant of cores shares one channel), 30 GB/s
    core<->DRAM link.  ``rows``/``cols`` select the paper's three logical
    configurations: 8x8 full mesh, 4x8 asymmetric submesh, 1x8 ring.
    """
    x = SpatialDim("x", rows)
    y = SpatialDim("y", cols)
    dims = (x, y)
    # Tensix FPU: a 32x32x32 intrinsic is 32768 MACs = 65536 flops; at the
    # nominal 1024 flops/cycle it retires every 64 cycles (r = 1/64).  The
    # paper calibrates df throughputs from isolated microbenchmarks (S3.1) and
    # observes sustained GEMM throughput "stabilizes around 45 TOP/s" (S3.3
    # footnote), i.e. ~0.7 of nominal peak — we plug the same sustained rate
    # into the df description: r = 0.7/64.
    fpu = MatUnit("FPU", (32, 32, 32), intrinsics_per_cycle=0.7 / 64.0)
    sfpu = VecUnit("SFPU", width=32, intrinsics_per_cycle=1.0)
    core = Core("cores", ("x", "y"), mat=fpu, vec=sfpu, scalar=ScalarUnit("RISCV", 1.0))
    l1 = Memory("l1", ("x", "y"), size_bytes=1_499_136, bandwidth_gbps=60.0, level="local")
    core_to_l1 = Mux("core_to_l1", "cores", "l1",
                     AffineMap.identity(["x", "y"]), bandwidth_gbps=60.0)
    groups_x, groups_y = max(1, rows // 4), max(1, cols // 4)
    dram_channels = groups_x * groups_y
    dram_idx = SpatialDim("dram_idx", dram_channels)
    dram_total_gbps = 288.0
    dram = Memory("drams", ("dram_idx",), size_bytes=12 * GB,
                  bandwidth_gbps=dram_total_gbps / dram_channels, level="global")
    # Paper Listing 7: channel = (d0 floordiv 4) + groups_x * (d1 floordiv 4)
    ch_map = AffineMap((_channel_expr(rows, cols),))
    to_dram = Mux("to_dram", "l1", "drams", ch_map, bandwidth_gbps=30.0)
    ics = []
    if rows > 1:
        ics.append(Interconnect("noc_h", "l1", "l1",
                                _ring_map([("x", rows), ("y", cols)], "x"), 28.0))
    if cols > 1:
        ics.append(Interconnect("noc_v", "l1", "l1",
                                _ring_map([("x", rows), ("y", cols)], "y"), 28.0))
    return HardwareModel(
        name=f"wormhole_{rows}x{cols}", clock_ghz=1.0, spatial_dims=(x, y, dram_idx),
        core=core, local_mem=l1, core_to_local=core_to_l1, global_mem=dram,
        to_global=to_dram, interconnects=tuple(ics),
        notes="Tenstorrent Wormhole n300 socket (paper S3.1, Listings 6-8)")


def _channel_expr(rows: int, cols: int) -> AffineExpr:
    """Composite channel map ``x//4 + groups_x*(y//4)`` (paper Listing 7) — the
    only non-single-floordiv map in the paper; implemented as a small subclass
    overriding ``evaluate`` so the rest of the algebra stays simple."""
    groups_x = max(1, rows // 4)

    class _E(AffineExpr):
        def evaluate(self, env: Mapping[str, int]) -> int:  # type: ignore[override]
            return (env.get("x", 0) // 4) + groups_x * (env.get("y", 0) // 4)

    return _E(coeffs=(("x", 1), ("y", 1)))  # dims recorded for dependence queries


def spyre_triple_ring(n: int = 32) -> HardwareModel:
    """IBM-Spyre-like 1D triple-ring (paper Fig 3 / Listing 9): one spatial
    dim, three ring interconnects with different hop strides and bandwidths."""
    p = SpatialDim("p", n)
    mat = MatUnit("PT", (32, 32, 32), intrinsics_per_cycle=1.0 / 64.0)
    vec = VecUnit("VU", width=64, intrinsics_per_cycle=1.0)
    core = Core("cores", ("p",), mat=mat, vec=vec)
    l0 = Memory("l0", ("p",), size_bytes=2 * MB, bandwidth_gbps=100.0, level="local")
    mux = Mux("core_to_l0", "cores", "l0", AffineMap.identity(["p"]), 100.0)
    hbm_idx = SpatialDim("hbm_idx", 4)
    hbm = Memory("lpddr", ("hbm_idx",), size_bytes=32 * GB, bandwidth_gbps=50.0,
                 level="global")
    to_hbm = Mux("to_lpddr", "l0", "lpddr",
                 AffineMap((AffineExpr.var("p").with_floordiv(max(1, n // 4)),)), 25.0)
    ics = (
        Interconnect("ring0", "l0", "l0", _ring_map([("p", n)], "p", 1), 32.0),
        Interconnect("ring1", "l0", "l0", _ring_map([("p", n)], "p", 2), 16.0),
        Interconnect("ring2", "l0", "l0", _ring_map([("p", n)], "p", 4), 8.0),
    )
    return HardwareModel(
        name=f"spyre_ring_{n}", clock_ghz=1.0, spatial_dims=(p, hbm_idx), core=core,
        local_mem=l0, core_to_local=mux, global_mem=hbm, to_global=to_hbm,
        interconnects=ics, notes="1D triple-ring example (paper Fig 3, Listing 9)")


# --------------------------------------------------------------------------
# Presets — TPU deployment targets (DESIGN.md S4 adaptation)
# --------------------------------------------------------------------------
TPU_V5E_PEAK_BF16 = 197e12      # FLOP/s per chip (assignment constant)
TPU_V5E_HBM_GBPS = 819.0        # GB/s per chip
TPU_V5E_ICI_GBPS = 50.0         # GB/s per link per direction
TPU_V5E_HBM_BYTES = 16 * GB
TPU_V5E_VMEM_BYTES = 128 * MB


def tpu_v5e_pod(data: int = 16, model: int = 16, pods: int = 1,
                clock_ghz: float = 0.94) -> HardwareModel:
    """A TPU-v5e pod described in the *same* df dialect, at mesh granularity:
    chips are the ``df.core``s, HBM is the per-core memory, ICI rings are the
    interconnects, and the host/DCN-attached storage is the "global" level.

    The MXU is a 128x128x128 intrinsic; r is chosen so the peak matches the
    assignment's 197 TFLOP/s bf16.  VMEM is exposed as ``scratch_mem`` and is
    what the Pallas BlockSpec planner sizes against (the paper's L1 analogue
    one level down).
    """
    dims = []
    core_dims = []
    if pods > 1:
        dims.append(SpatialDim("pod", pods)); core_dims.append("pod")
    dims.append(SpatialDim("data", data)); core_dims.append("data")
    dims.append(SpatialDim("model", model)); core_dims.append("model")
    intrinsic = (128, 128, 128)
    flops_per_intr = 2 * 128 ** 3
    r = TPU_V5E_PEAK_BF16 / (flops_per_intr * clock_ghz * 1e9)
    mxu = MatUnit("MXU", intrinsic, intrinsics_per_cycle=r)
    vpu = VecUnit("VPU", width=1024, intrinsics_per_cycle=4.0)
    core = Core("chips", tuple(core_dims), mat=mxu, vec=vpu,
                scalar=ScalarUnit("SC", 1.0))
    hbm = Memory("hbm", tuple(core_dims), size_bytes=TPU_V5E_HBM_BYTES,
                 bandwidth_gbps=TPU_V5E_HBM_GBPS, level="local")
    vmem = Memory("vmem", tuple(core_dims), size_bytes=TPU_V5E_VMEM_BYTES,
                  bandwidth_gbps=22_000.0, level="local")
    mux = Mux("chip_to_hbm", "chips", "hbm",
              AffineMap.identity(list(core_dims)), TPU_V5E_HBM_GBPS)
    host_idx = SpatialDim("host_idx", max(1, (data * model * pods) // 4))
    host = Memory("hostmem", ("host_idx",), size_bytes=512 * GB,
                  bandwidth_gbps=25.0, level="global")   # PCIe/DCN feed
    to_host = Mux("to_host", "hbm", "hostmem",
                  AffineMap((AffineExpr.var(core_dims[-1]).with_floordiv(4),)), 25.0)
    pairs = [(d, s) for d, s in ((n, next(x.size for x in dims if x.name == n))
                                 for n in core_dims)]
    ics = []
    for axis, size in pairs:
        if size > 1:
            bw = TPU_V5E_ICI_GBPS if axis != "pod" else 25.0   # DCN between pods
            ics.append(Interconnect(f"ici_{axis}", "hbm", "hbm",
                                    _ring_map(pairs, axis), bw))
    return HardwareModel(
        name=f"tpu_v5e_{'x'.join(str(s) for _, s in pairs)}", clock_ghz=clock_ghz,
        spatial_dims=tuple(dims) + (host_idx,), core=core, local_mem=hbm,
        core_to_local=mux, global_mem=host, to_global=to_host,
        interconnects=tuple(ics), scratch_mem=vmem,
        notes="TPU v5e pod at mesh granularity (DESIGN.md S4)")


def tpu_v5e_chip() -> HardwareModel:
    """A single TPU chip at *intra-chip* granularity for the Pallas BlockSpec
    planner: the 'cores' are the (8, 128)-lane compute over a 1x1 'mesh', the
    local memory is VMEM, and the 'global' memory is that chip's HBM.  This is
    the paper's original granularity (L1 scratchpad <-> DRAM) transplanted one
    level down the TPU hierarchy."""
    u = SpatialDim("u", 1)
    clock = 0.94
    r = TPU_V5E_PEAK_BF16 / (2 * 128 ** 3 * clock * 1e9)
    mxu = MatUnit("MXU", (128, 128, 128), intrinsics_per_cycle=r)
    vpu = VecUnit("VPU", width=1024, intrinsics_per_cycle=4.0)
    core = Core("tc", ("u",), mat=mxu, vec=vpu, scalar=ScalarUnit("SC", 1.0))
    vmem = Memory("vmem", ("u",), size_bytes=TPU_V5E_VMEM_BYTES,
                  bandwidth_gbps=22_000.0, level="local")
    mux = Mux("tc_to_vmem", "tc", "vmem", AffineMap.identity(["u"]), 22_000.0)
    hbm_idx = SpatialDim("hbm_idx", 1)
    hbm = Memory("hbm", ("hbm_idx",), size_bytes=TPU_V5E_HBM_BYTES,
                 bandwidth_gbps=TPU_V5E_HBM_GBPS, level="global")
    to_hbm = Mux("to_hbm", "vmem", "hbm", AffineMap((AffineExpr.const_expr(0),)),
                 TPU_V5E_HBM_GBPS)
    return HardwareModel(
        name="tpu_v5e_chip", clock_ghz=clock, spatial_dims=(u, hbm_idx), core=core,
        local_mem=vmem, core_to_local=mux, global_mem=hbm, to_global=to_hbm,
        interconnects=(), notes="single-chip VMEM/MXU model for BlockSpec planning")


PRESETS = {
    "wormhole_8x8": lambda: wormhole(8, 8),
    "wormhole_4x8": lambda: wormhole(4, 8),
    "wormhole_1x8": lambda: wormhole(1, 8),
    "spyre_ring": lambda: spyre_triple_ring(32),
    "tpu_v5e_pod": lambda: tpu_v5e_pod(16, 16, 1),
    "tpu_v5e_2pod": lambda: tpu_v5e_pod(16, 16, 2),
    "tpu_v5e_chip": tpu_v5e_chip,
}


def get_hw(name: str) -> HardwareModel:
    try:
        return PRESETS[name]()
    except KeyError as e:
        raise KeyError(f"unknown hardware preset {name!r}; "
                       f"available: {sorted(PRESETS)}") from e
