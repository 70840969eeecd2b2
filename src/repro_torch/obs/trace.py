"""Structured span tracer for the planning stack (Chrome trace-event JSON).

Disabled by default with near-zero cost when off: :func:`span` is one
attribute load plus returning a shared no-op context manager, and
:func:`traced`-wrapped functions pay one ``if`` per call.  Enabled via
``REPRO_TRACE=<path>`` (the file is written at interpreter exit, and by
:func:`write` explicitly), :func:`enable`, or ``benchmarks/run.py
--trace``.

Spans are Chrome trace-event *complete* events (``"ph": "X"``)::

    {"name": ..., "cat": ..., "ph": "X", "ts": <us>, "dur": <us>,
     "pid": ..., "tid": ..., "args": {...}}

``ts`` is wall-clock microseconds derived from one per-process epoch
(``time.time() - time.perf_counter()`` at import), so spans recorded in
different processes land on one comparable timeline: worker processes
buffer their spans in memory (``repro_torch.parallel.search_exec`` passes a
``trace`` flag with each job), :func:`drain` hands them back through the
existing chunk-result path, and the parent :func:`ingest`\\ s them with the
worker's ``pid``/``tid`` preserved — the cross-process merge protocol
documented in DESIGN_OBS.md.

Invariant: the tracer only *observes* (two clock reads and a dict append
per span).  It never feeds anything back into planning, so traced and
untraced searches select bit-identical plans (``tests/test_obs.py``).
"""
from __future__ import annotations

import atexit
import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

TRACE_ENV = "REPRO_TRACE"

from . import context  # noqa: E402  (no cycle: context imports nothing)

# wall-clock anchor for perf_counter timestamps; computed once per process
# so every span of a process shares one epoch (fork children inherit the
# parent's, spawn children recompute — both express the same wall clock)
_EPOCH = time.time() - time.perf_counter()


class _State:
    __slots__ = ("on", "path", "events", "lock", "atexit_armed")

    def __init__(self) -> None:
        self.on = False
        self.path: Optional[str] = None
        self.events: List[Dict[str, Any]] = []
        self.lock = threading.Lock()
        self.atexit_armed = False


_STATE = _State()


def enabled() -> bool:
    """Whether spans are being collected right now."""
    return _STATE.on


def enable(path: Optional[str] = None) -> None:
    """Start collecting spans.  With ``path``, also arm an atexit write of
    the Chrome trace JSON there (idempotent)."""
    _STATE.on = True
    if path:
        _STATE.path = path
        if not _STATE.atexit_armed:
            _STATE.atexit_armed = True
            atexit.register(_atexit_write)


def disable() -> None:
    """Stop collecting (buffered events are kept until :func:`clear`)."""
    _STATE.on = False


def clear() -> None:
    with _STATE.lock:
        _STATE.events.clear()


def refresh_from_env() -> None:
    """Re-resolve the ``REPRO_TRACE`` env var.  Called by the planner entry
    points (``plan_kernel`` / ``plan_kernel_multi`` / ``plan_pipeline``) so
    an env flip after import still takes effect, while the per-span check
    stays a single attribute load."""
    path = os.environ.get(TRACE_ENV, "").strip()
    if path:
        enable(path)
    elif _STATE.path is not None and not path:
        # env-driven tracing withdrawn; explicit enable(None) is unaffected
        _STATE.on = False
        _STATE.path = None


def _record(name: str, cat: str, t0: float, t1: float,
            args: Optional[Dict[str, Any]]) -> None:
    ev: Dict[str, Any] = {
        "name": name, "cat": cat, "ph": "X",
        "ts": (_EPOCH + t0) * 1e6, "dur": max(0.0, (t1 - t0) * 1e6),
        "pid": os.getpid(), "tid": threading.get_ident(),
    }
    rid = context.current()
    if rid is not None:
        # correlation ID rides in args so Perfetto's span view shows it
        # and `repro_torch.obs incident` can join spans against the recorder
        args = dict(args) if args else {}
        args["rid"] = rid
    if args:
        ev["args"] = args
    with _STATE.lock:
        _STATE.events.append(ev)


class _Span:
    """Active span context manager (only constructed when tracing is on)."""
    __slots__ = ("name", "cat", "args", "t0")

    def __init__(self, name: str, cat: str, args: Dict[str, Any]) -> None:
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _record(self.name, self.cat, self.t0, time.perf_counter(), self.args)


class _NullSpan:
    """Shared no-op context manager: the entire disabled-tracing cost."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, cat: str = "planner", **args: Any):
    """``with trace.span("planner.enumerate", program=p.name): ...``"""
    if not _STATE.on:
        return _NULL
    return _Span(name, cat, args)


def traced(name: Optional[str] = None, cat: str = "planner"
           ) -> Callable[[Callable], Callable]:
    """Decorator form of :func:`span` (span name defaults to the function's
    qualified name)."""
    def deco(fn: Callable) -> Callable:
        sname = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _STATE.on:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                _record(sname, cat, t0, time.perf_counter(), None)
        return wrapper
    return deco


# ------------------------------------------------------- cross-process merge
def drain() -> List[Dict[str, Any]]:
    """Hand back (and clear) the buffered events — what a worker process
    attaches to its chunk result for the parent to :func:`ingest`."""
    with _STATE.lock:
        out = list(_STATE.events)
        _STATE.events.clear()
    return out


def ingest(events: Optional[List[Dict[str, Any]]]) -> None:
    """Merge another process's drained events into this buffer.  Events
    keep their original ``pid``/``tid``/``ts`` (one shared wall-clock
    epoch), so the exported trace shows every worker as its own process
    track."""
    if not events:
        return
    with _STATE.lock:
        _STATE.events.extend(events)


def events() -> List[Dict[str, Any]]:
    with _STATE.lock:
        return list(_STATE.events)


# ------------------------------------------------------------------- export
def write(path: Optional[str] = None) -> Optional[str]:
    """Write the buffered events as Chrome trace-event JSON (perfetto /
    ``chrome://tracing`` loadable).  Returns the path written, or None when
    no destination is known."""
    path = path or _STATE.path
    if not path:
        return None
    with _STATE.lock:
        evs = sorted(_STATE.events, key=lambda e: (e["pid"], e["tid"],
                                                   e["ts"]))
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return path


def _atexit_write() -> None:
    try:
        write()
    except OSError:
        pass


# --------------------------------------------------------------- validation
REQUIRED_KEYS = ("ph", "ts", "pid", "tid", "name")


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema-check a loaded Chrome trace document.  Returns a list of
    problems (empty = valid): required keys per event, numeric ``ts`` /
    ``dur``, and monotonic span nesting per ``(pid, tid)`` — two complete
    events on one thread must be disjoint or properly nested (a context
    manager tracer cannot legally produce partial overlap)."""
    problems: List[str] = []
    evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(evs, list):
        return ["top level is neither an event array nor {'traceEvents': []}"]
    if not evs:
        problems.append("no events")
    tracks: Dict[tuple, List[tuple]] = {}
    for i, ev in enumerate(evs):
        for k in REQUIRED_KEYS:
            if k not in ev:
                problems.append(f"event {i} missing key {k!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i} has non-numeric ts")
            continue
        if ev.get("ph") == "X":
            if not isinstance(ev.get("dur"), (int, float)):
                problems.append(f"event {i} missing numeric dur")
                continue
            tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (float(ev["ts"]), float(ev["dur"]), ev.get("name", "?")))
    eps = 0.5                       # us: clock-granularity slack
    for (pid, tid), spans in tracks.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[tuple] = []
        for ts, dur, name in spans:
            while stack and stack[-1][0] + stack[-1][1] <= ts + eps:
                stack.pop()
            if stack and ts + dur > stack[-1][0] + stack[-1][1] + eps:
                problems.append(
                    f"pid={pid} tid={tid}: span {name!r} [{ts:.1f},"
                    f"{ts + dur:.1f}] partially overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]:.1f},"
                    f"{stack[-1][0] + stack[-1][1]:.1f}]")
            stack.append((ts, dur, name))
    return problems
