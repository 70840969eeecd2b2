"""Roofline terms of one dry-run cell, on a cluster given as data.

Counterpart of ``repro/launch/roofline.py``.  Three terms per (arch x
shape x mesh) cell:

    compute term    = flops / (chips x the card's peak)
    memory term     = bytes / (chips x the card's memory rate)
    collective term = sum over mesh axes of
                      that axis's collective bytes / (chips x its link rate)

The reference bakes in one TPU's figures; here the cluster is a
``core.hw.HardwareModel``: ``lower_torch.h100_cluster()`` by default (989
TFLOP/s and 3.35 TB/s a card, NVLink 450 GB/s along ``model``, InfiniBand 50
GB/s along ``data``, an assumed 25 GB/s along ``pod``; data-sheet figures,
none measured here).  Given ``core.hw.tpu_v5e_pod`` with every collective
byte on one of its axes it gives the reference's terms.

The counts come from running the step, not from compiled HLO
(:func:`from_counts`): ``launch/dryrun.py`` counts each kernel launch's work
(``kernels.work``), the plain PyTorch operations' flops
(``torch.utils.flop_counter.FlopCounterMode``) and bytes (inputs plus
outputs of every operation that is not a view), and each collective's
output bytes by kind and mesh axis (``parallel.spmd``).  Eager execution
counts every launch as it happens, so no loop reweighting is needed.  The
reference's HLO-text parsers (``_split_computations``,
``computation_multipliers``, ``dot_flops``, ``loop_weighted_flops_scale``,
``collective_bytes``) have no counterpart: the port emits no HLO.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def _default_cluster(mesh: str):
    from repro_torch.core.lower_torch import h100_cluster
    return h100_cluster(pods=2 if mesh.count("x") == 2 else 1)


@dataclass
class RooflineReport:
    """One cell's totals over all ``chips`` (per-device counts times the
    chips, as the reference's) and its three terms on ``hw``.
    ``coll_by_axis`` holds the collective bytes per mesh axis; where it is
    None every collective byte is taken to cross the link of the cluster's
    last axis (``model``)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    model_flops: float
    hw: object = None
    coll_by_axis: Optional[Dict[str, float]] = None
    measured_s: Optional[float] = None
    compute_s: float = field(init=False)
    memory_s: float = field(init=False)
    collective_s: float = field(init=False)

    def __post_init__(self):
        if self.hw is None:
            self.hw = _default_cluster(self.mesh)
        peak = self.hw.peak_flops_per_core()
        rate = self.hw.local_mem.bandwidth_gbps * 1e9
        self.compute_s = self.hlo_flops / (self.chips * peak)
        self.memory_s = self.hlo_bytes / (self.chips * rate)
        by_axis = self.coll_by_axis if self.coll_by_axis is not None else \
            {self.hw.mesh_dims[-1][0]: self.coll_bytes}
        self.collective_s = sum(b / (self.chips * self._link(a)) for a, b in by_axis.items()
                                if b)

    def _link(self, axis: str) -> float:
        ic = self.hw.interconnect_along(axis)
        if ic is None:
            raise ValueError(f"{self.hw.name} has no link along {axis!r}")
        return ic.bandwidth_gbps * 1e9

    @property
    def dominant(self) -> str:
        terms = self.terms()
        return max(terms, key=terms.get)

    def terms(self) -> Dict[str, float]:
        return {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}

    @property
    def bound_s(self) -> float:
        return max(self.terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops: how much of the computed work is
        useful (catches remat recompute and padding waste)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time as a fraction of the bound (the score)."""
        useful_s = self.model_flops / (self.chips * self.hw.peak_flops_per_core())
        return useful_s / max(self.bound_s, 1e-30)

    def row(self) -> Dict:
        out = {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_by_kind": {k: v for k, v in self.coll_by_kind.items()
                             if k != "_counts" and v},
            "coll_counts": self.coll_by_kind.get("_counts", {}),
        }
        out["hw"] = self.hw.name
        out["bound_s"] = self.bound_s
        if self.coll_by_axis is not None:
            out["coll_by_axis"] = {k: v for k, v in self.coll_by_axis.items() if v}
        if self.measured_s is not None:
            out["measured_s"] = self.measured_s
        return out


def model_flops_estimate(n_params_active: int, tokens: int,
                         is_train: bool) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N = active params."""
    return (6.0 if is_train else 2.0) * n_params_active * tokens


def trips_by_depth_for(cfg, shape_kind: str, microbatches: int = 1,
                       seq_len: int = 0) -> Tuple[int, ...]:
    """The loop-nest trip counts of the step, outermost first (the
    reference's, kept for its reports: the port's counts need no
    reweighting)."""
    chunks = []
    if cfg.family == "ssm" and shape_kind != "decode":
        chunks = [max(1, seq_len // 16)]          # WKV chunk scan
    if cfg.family == "hybrid" and shape_kind != "decode":
        chunks = [max(1, seq_len // 32)]          # SSD chunk scan
    if cfg.family == "hybrid":
        a = cfg.attn_every or cfg.n_layers
        layers = [cfg.n_layers // a, a]
    elif cfg.family == "audio":
        layers = [max(cfg.n_layers, cfg.n_encoder_layers or 0)]
    else:
        layers = [cfg.n_layers]
    if shape_kind == "train" and microbatches > 1:
        return tuple([microbatches] + layers + chunks)
    return tuple(layers + chunks)


def from_counts(arch: str, shape: str, mesh_name: str, chips: int, flops: float,
                byts: float, coll_by_kind: Dict[str, float], coll_by_axis: Dict[str, float],
                coll_counts: Dict[str, int], model_flops: float, hw=None,
                measured_s: Optional[float] = None) -> RooflineReport:
    """The report of one rank's counted step (per-device flops, bytes and
    collective bytes, the dry run's), scaled to all ``chips``."""
    kinds = {k: float(coll_by_kind.get(k, 0.0)) * chips for k in KINDS}
    kinds["_counts"] = dict(coll_counts)          # type: ignore[assignment]
    return RooflineReport(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                          hlo_flops=flops * chips, hlo_bytes=byts * chips,
                          coll_bytes=sum(kinds[k] for k in KINDS), coll_by_kind=kinds,
                          model_flops=model_flops, hw=hw,
                          coll_by_axis={a: b * chips for a, b in coll_by_axis.items()},
                          measured_s=measured_s)
