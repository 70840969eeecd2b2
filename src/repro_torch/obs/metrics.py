"""Unified metrics registry for the planning stack (stdlib-only).

One process-wide :class:`Registry` of counters, gauges and histograms with
labeled series, replacing the scattered ad-hoc signals that grew over the
first five PRs: ``lower_jax.PLANNER_FALLBACKS``, the plancache
``CacheStats`` silo, ``_SearchStats`` pruning counters, and worker shard
timings all publish here, so ``plan_speed`` and the serve/train launchers
can emit one coherent JSON blob (:func:`snapshot`).

Metric identity is ``(name, frozenset(labels.items()))`` — one metric
object per name, one series per label combination::

    metrics.counter("plancache_get_total", result="hit_mem").inc()
    metrics.observe("planner_phase_seconds", 0.12, phase="estimate")
    metrics.snapshot()  # -> plain-JSON dict

Everything is guarded by a single registry lock; increments are cheap
(dict lookup + float add) but, like the tracer, this module only ever
*observes* — nothing in the planner reads a metric back to make a
decision, which is what keeps instrumented and uninstrumented searches
bit-identical.

The canonical metric names and label sets live in DESIGN_OBS.md.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

METRICS_ENV = "REPRO_METRICS"

#: Process start as this module saw it — the snapshot meta block's epoch.
_START_TIME = time.time()

from . import context  # noqa: E402  (no cycle: context imports nothing)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Mapping[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    """One (metric, label-set) time series.  ``rid`` is the exemplar:
    the correlation ID active at the last correlated update (None until
    one happens) — per-series, not per-increment, so request IDs never
    explode label cardinality."""
    __slots__ = ("labels", "value", "rid")

    def __init__(self, labels: LabelKey) -> None:
        self.labels = labels
        self.value = 0.0
        self.rid: Optional[str] = None


class _HistSeries:
    """Histogram series: count / sum / min / max plus fixed log-ish buckets
    (seconds-oriented; fine for the planner's ms-to-minutes range)."""
    __slots__ = ("labels", "count", "sum", "min", "max", "buckets", "rid")

    BOUNDS = (1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0)

    def __init__(self, labels: LabelKey) -> None:
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets = [0] * (len(self.BOUNDS) + 1)
        self.rid: Optional[str] = None

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for i, b in enumerate(self.BOUNDS):
            if v <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1


class Counter:
    """Monotonic counter with labeled series."""

    def __init__(self, registry: "Registry", name: str,
                 help_: str = "") -> None:
        self._registry = registry
        self.name = name
        self.help = help_
        self._series: Dict[LabelKey, _Series] = {}

    def labels(self, **labels: Any) -> "_BoundCounter":
        return _BoundCounter(self, _label_key(labels))

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._bump(_label_key(labels), amount)

    def _bump(self, key: LabelKey, amount: float) -> None:
        rid = context.current()
        with self._registry._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _Series(key)
            s.value += amount
            if rid is not None:
                s.rid = rid

    def value(self, **labels: Any) -> float:
        with self._registry._lock:
            s = self._series.get(_label_key(labels))
            return s.value if s is not None else 0.0

    def total(self) -> float:
        with self._registry._lock:
            return sum(s.value for s in self._series.values())

    def clear(self) -> None:
        """Drop every series (used by compat shims like
        ``lower_jax.clear_block_caches`` that must re-zero a signal)."""
        with self._registry._lock:
            self._series.clear()


class _BoundCounter:
    __slots__ = ("_counter", "_key")

    def __init__(self, counter: Counter, key: LabelKey) -> None:
        self._counter = counter
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._counter._bump(self._key, amount)


class Gauge:
    """Last-value-wins gauge with labeled series."""

    def __init__(self, registry: "Registry", name: str,
                 help_: str = "") -> None:
        self._registry = registry
        self.name = name
        self.help = help_
        self._series: Dict[LabelKey, _Series] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        rid = context.current()
        with self._registry._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _Series(key)
            s.value = float(value)
            if rid is not None:
                s.rid = rid

    def add(self, amount: float, **labels: Any) -> None:
        key = _label_key(labels)
        rid = context.current()
        with self._registry._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _Series(key)
            s.value += amount
            if rid is not None:
                s.rid = rid

    def value(self, **labels: Any) -> float:
        with self._registry._lock:
            s = self._series.get(_label_key(labels))
            return s.value if s is not None else 0.0


class Histogram:
    """Distribution metric (count/sum/min/max + coarse buckets)."""

    def __init__(self, registry: "Registry", name: str,
                 help_: str = "") -> None:
        self._registry = registry
        self.name = name
        self.help = help_
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        rid = context.current()
        with self._registry._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(key)
            s.observe(float(value))
            if rid is not None:
                s.rid = rid

    def series(self, **labels: Any) -> Optional[_HistSeries]:
        with self._registry._lock:
            return self._series.get(_label_key(labels))


class Registry:
    """Process-wide metric store.  One metric object per name; the type of
    the first registration wins and a mismatched re-registration raises."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help_: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help_)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self._get(Histogram, name, help_)

    def reset(self) -> None:
        """Forget everything (tests; also the per-bench-cell phase delta
        helpers snapshot-and-diff instead of resetting)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, Any]:
        """Plain-JSON view: ``{name: {type, help, series: [{labels, ...}]}}``
        plus a ``_meta`` block (pid, start time, uptime, plancache schema)
        so scraped blobs are self-describing.  Counter/gauge series carry
        ``value``; histogram series carry ``count``/``sum``/``min``/
        ``max``/``buckets``; any series touched inside a correlation
        scope carries its last ``rid`` exemplar.  ``_meta`` has no
        ``type`` key, which is what keeps the diff-style consumers
        (:func:`counter_totals`, :func:`diff_counters`) oblivious to it.
        """
        out: Dict[str, Any] = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                series: List[Dict[str, Any]] = []
                if isinstance(m, Histogram):
                    mtype = "histogram"
                    for s in m._series.values():
                        d = {
                            "labels": dict(s.labels),
                            "count": s.count,
                            "sum": s.sum,
                            "min": s.min if s.count else None,
                            "max": s.max if s.count else None,
                            "buckets": {
                                "le": list(_HistSeries.BOUNDS) + ["inf"],
                                "counts": list(s.buckets),
                            },
                        }
                        if s.rid is not None:
                            d["rid"] = s.rid
                        series.append(d)
                else:
                    mtype = "counter" if isinstance(m, Counter) else "gauge"
                    for s in m._series.values():
                        d = {"labels": dict(s.labels), "value": s.value}
                        if s.rid is not None:
                            d["rid"] = s.rid
                        series.append(d)
                series.sort(key=lambda d: sorted(d["labels"].items()))
                out[name] = {"type": mtype, "help": m.help, "series": series}
        out["_meta"] = _meta_block()
        return out


def _meta_block() -> Dict[str, Any]:
    """Self-description for scraped snapshots.  The plancache schema
    version rides along so a scrape can be matched against the on-disk
    plan store it was taken next to (import kept lazy and fallible:
    metrics must stay importable from anywhere in the stack)."""
    try:
        from repro_torch.plancache.keying import SCHEMA_VERSION
        schema: Optional[int] = SCHEMA_VERSION
    except Exception:
        schema = None
    now = time.time()
    return {"pid": os.getpid(), "start_time": _START_TIME,
            "uptime_s": now - _START_TIME, "plancache_schema": schema}


REGISTRY = Registry()

# ------------------------------------------------- module-level convenience
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset


def inc(name: str, amount: float = 1.0, **labels: Any) -> None:
    REGISTRY.counter(name).inc(amount, **labels)


def set_gauge(name: str, value: float, **labels: Any) -> None:
    REGISTRY.gauge(name).set(value, **labels)


def observe(name: str, value: float, **labels: Any) -> None:
    REGISTRY.histogram(name).observe(value, **labels)


# ------------------------------------------------------- snapshot utilities
def counter_totals(snap: Mapping[str, Any],
                   names: Optional[Iterable[str]] = None
                   ) -> Dict[str, float]:
    """Sum each counter's series into ``{name: total}`` (optionally only
    the listed names).  Used by diff-style consumers like the per-cell
    phase breakdown in benchmarks/plan_speed.py."""
    out: Dict[str, float] = {}
    for name, m in snap.items():
        if m.get("type") != "counter":
            continue
        if names is not None and name not in names:
            continue
        out[name] = sum(s["value"] for s in m["series"])
    return out


def diff_counters(before: Mapping[str, Any], after: Mapping[str, Any]
                  ) -> Dict[str, Dict[str, float]]:
    """Per-series counter deltas between two snapshots:
    ``{name: {label-repr: delta}}``, dropping zero deltas."""
    out: Dict[str, Dict[str, float]] = {}
    for name, m in after.items():
        if m.get("type") != "counter":
            continue
        prev = {}
        if name in before and before[name].get("type") == "counter":
            prev = {json.dumps(s["labels"], sort_keys=True): s["value"]
                    for s in before[name]["series"]}
        deltas: Dict[str, float] = {}
        for s in m["series"]:
            key = json.dumps(s["labels"], sort_keys=True)
            d = s["value"] - prev.get(key, 0.0)
            if d:
                deltas[key] = d
        if deltas:
            out[name] = deltas
    return out


def hist_quantile(series: Mapping[str, Any], q: float) -> Optional[float]:
    """Estimate the ``q``-quantile of a snapshot histogram series (the
    ``{count, min, max, buckets}`` dict :meth:`Registry.snapshot` emits).

    Linear interpolation inside the covering bucket, clamped to the
    observed ``[min, max]`` so the coarse log bounds can't report a p99
    above the largest value actually seen.

    Boundary contract: ``None`` series or empty histogram -> ``None``;
    ``q <= 0`` -> observed min; ``q >= 1`` -> observed max (exact, not
    interpolated); a single-bucket histogram interpolates within
    ``[min, max]`` instead of within the much coarser bucket; a series
    without bucket data (foreign/minimal snapshots) degrades to linear
    interpolation between min and max."""
    if not series:
        return None
    count = int(series.get("count") or 0)
    if count <= 0:
        return None
    lo = float(series.get("min") if series.get("min") is not None else 0.0)
    hi = float(series.get("max") if series.get("max") is not None else lo)
    q = min(1.0, max(0.0, float(q)))
    if q <= 0.0 or count == 1 or lo == hi:
        return lo if q <= 0.0 else (hi if q >= 1.0 else lo)
    if q >= 1.0:
        return hi
    buckets = series.get("buckets") or {}
    bounds = list(buckets.get("le") or [])
    counts = list(buckets.get("counts") or [])
    if not bounds or not counts or sum(counts) <= 0:
        return lo + (hi - lo) * q
    if sum(1 for n in counts if n > 0) == 1:
        # Single occupied bucket: the bucket edges say nothing the
        # observed extremes don't say better.
        return lo + (hi - lo) * q
    rank = q * count
    seen = 0.0
    prev_bound = 0.0
    for bound, n in zip(bounds, counts):
        if n <= 0:
            if bound != "inf":
                prev_bound = float(bound)
            continue
        if seen + n >= rank:
            upper = hi if bound == "inf" else float(bound)
            frac = (rank - seen) / n
            est = prev_bound + (upper - prev_bound) * frac
            return min(hi, max(lo, est))
        seen += n
        if bound != "inf":
            prev_bound = float(bound)
    return hi


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the snapshot as JSON to ``path`` or ``$REPRO_METRICS``.
    Returns the path written, or None when no destination is known.

    Atomic (tmp + rename, like the plancache's stats writes): launchers
    dump on exit and are routinely SIGKILLed by orchestrators, and a
    torn half-JSON is worse for the scraper than a stale complete one.
    """
    path = path or os.environ.get(METRICS_ENV, "").strip() or None
    if not path:
        return None
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(snapshot(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return path
