"""Bounded flight recorder for the serving stack (stdlib-only).

A ring buffer of *structured events* — plan-request rung decisions,
circuit-breaker transitions, fault injections, containment-ladder rungs,
QoS shed/evictions, isolation-validator violations, SLO burn alerts,
pool-worker failures — each stamped with a wall-clock time, a monotonic
sequence number, and the active request/incident ID
(:mod:`repro_torch.obs.context`).  The buffer is capacity-bounded (oldest
events drop, a ``dropped`` counter keeps the loss honest) so the
recorder can stay on for the lifetime of a serving process.

Off by default with one attribute load per :func:`record` call when off
— the same near-zero-cost discipline as the tracer, and the same
invariant: the recorder only *observes*; with it off (or on), planning
and serving decisions are bit-identical.

Enable with ``REPRO_FLIGHTREC=<path>`` (the launchers call
:func:`refresh_from_env`; the dump is written at interpreter exit —
which includes ``SystemExit`` paths like the serve driver's containment
assertion) or programmatically with :func:`enable`.  The dump is written
atomically (tmp + ``os.replace``) so an orchestrator's SIGKILL can tear
at most the tmp file, never the dump.  Isolation violations additionally
force an immediate dump (:mod:`repro_torch.tenancy.validator` calls
:func:`dump` with ``reason="isolation_violation"``): the buffer at the
moment of the violation is exactly the evidence an incident review
needs.

``python -m repro_torch.obs incident <dump>`` renders the per-request
timeline: which rung answered each request, why (the resolution log),
how long each step took, and what it displaced (re-planned tenants,
evicted best-effort deadlines).
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

FLIGHTREC_ENV = "REPRO_FLIGHTREC"
CAP_ENV = "REPRO_FLIGHTREC_CAP"
DEFAULT_CAPACITY = 2048

#: The event taxonomy (DESIGN_OBS.md).  ``record`` accepts any kind —
#: the tuple documents the canonical ones the stack emits.
KINDS = ("plan_request", "breaker", "fault", "replan", "containment",
         "qos_shed", "qos_evict", "violation", "slo_alert", "pool_failure")


def _json_safe(v: Any) -> Any:
    """Copy-normalize a field value at record time: events must not hold
    references to caller state that mutates later (log lists especially —
    a torn buffer is exactly what the recorder exists to rule out)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return str(v)


class FlightRecorder:
    """The ring buffer.  One module-level instance (:data:`RECORDER`) is
    the intended deployment; the class is separate for tests."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.on = False
        self.path: Optional[str] = None
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0
        self.started = time.time()
        self._atexit_armed = False

    # ----------------------------------------------------------- control
    def enable(self, path: Optional[str] = None,
               capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self.capacity:
            with self._lock:
                self.capacity = capacity
                self._events = deque(self._events, maxlen=capacity)
        self.on = True
        if path:
            self.path = path
            if not self._atexit_armed:
                self._atexit_armed = True
                atexit.register(self._atexit_dump)

    def disable(self) -> None:
        self.on = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._seq = 0

    # ------------------------------------------------------------ record
    def record(self, kind: str, **fields: Any) -> None:
        """Append one event (no-op when off).  The active correlation ID
        is stamped automatically; fields are copy-normalized to JSON-safe
        values at record time."""
        if not self.on:
            return
        from . import context
        ev: Dict[str, Any] = {"kind": kind, "t": time.time(),
                              "rid": context.current()}
        for k, v in fields.items():
            ev[k] = _json_safe(v)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    # -------------------------------------------------------------- dump
    def dump(self, path: Optional[str] = None,
             reason: str = "explicit") -> Optional[str]:
        """Write the buffer as JSON to ``path`` (default: the armed path).
        Atomic: tmp + ``os.replace``.  Returns the path written, or None
        when no destination is known."""
        path = path or self.path
        if not path:
            return None
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        doc = {
            "meta": {
                "pid": os.getpid(),
                "argv": list(sys.argv),
                "started": self.started,
                "dumped": time.time(),
                "reason": reason,
                "capacity": self.capacity,
                "n_events": len(events),
                "dropped": dropped,
            },
            "events": events,
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True, default=str)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        return path

    def _atexit_dump(self) -> None:
        try:
            self.dump(reason="atexit")
        except OSError:
            pass


RECORDER = FlightRecorder()


# ------------------------------------------------- module-level convenience
def enabled() -> bool:
    return RECORDER.on


def enable(path: Optional[str] = None,
           capacity: Optional[int] = None) -> None:
    RECORDER.enable(path, capacity)


def disable() -> None:
    RECORDER.disable()


def clear() -> None:
    RECORDER.clear()


def record(kind: str, **fields: Any) -> None:
    if not RECORDER.on:                  # the entire disabled cost
        return
    RECORDER.record(kind, **fields)


def events() -> List[Dict[str, Any]]:
    return RECORDER.events()


def dump(path: Optional[str] = None,
         reason: str = "explicit") -> Optional[str]:
    return RECORDER.dump(path, reason=reason)


def refresh_from_env() -> None:
    """Arm the recorder from ``REPRO_FLIGHTREC=<path>`` (capacity from
    ``REPRO_FLIGHTREC_CAP``).  Called by the launchers at startup; a
    programmatic :func:`enable` is unaffected when the env is unset."""
    path = os.environ.get(FLIGHTREC_ENV, "").strip()
    if not path:
        return
    cap: Optional[int] = None
    raw = os.environ.get(CAP_ENV, "").strip()
    if raw:
        try:
            cap = max(1, int(raw))
        except ValueError:
            cap = None
    enable(path, capacity=cap)


# ------------------------------------------------------- incident renderer
def load_dump(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "events" not in doc:
        raise ValueError(f"{path}: not a flight-recorder dump "
                         f"(no 'events' key)")
    return doc


def _fmt_ms(seconds: Any) -> str:
    try:
        return f"{float(seconds) * 1e3:.1f}ms"
    except (TypeError, ValueError):
        return "?"


def _fmt_event(ev: Dict[str, Any]) -> tuple:
    """One summary line + indented detail lines for an event."""
    kind = ev.get("kind", "?")
    detail: List[str] = []
    if kind == "plan_request":
        line = (f"rung={ev.get('rung')} outcome={ev.get('outcome')} "
                f"{_fmt_ms(ev.get('seconds'))} "
                f"deadline={ev.get('deadline_ms')}ms")
        if ev.get("background"):
            line += " background=yes"
        if ev.get("key"):
            line += f" key={str(ev['key'])[:12]}"
        detail = [str(l) for l in ev.get("log") or []]
    elif kind == "breaker":
        line = (f"{ev.get('key')}: {ev.get('from')} -> {ev.get('to')}")
    elif kind == "fault":
        what = ev.get("cores") or ev.get("link") or ev.get("cell") or ""
        line = f"cause={ev.get('cause')} {what}"
    elif kind == "replan":
        line = (f"cause={ev.get('cause')} rung={ev.get('rung')} "
                f"{_fmt_ms(ev.get('seconds'))} "
                f"within_budget={ev.get('within_budget')}")
    elif kind == "containment":
        line = (f"cause={ev.get('cause')} owner={ev.get('owner')} "
                f"rung={ev.get('rung')} "
                f"blast_radius={ev.get('blast_radius')} "
                f"{_fmt_ms(ev.get('seconds'))}")
        repl = ev.get("replanned") or []
        if repl:
            line += f" replanned={','.join(str(t) for t in repl)}"
        detail = [str(l) for l in ev.get("log") or []]
    elif kind in ("qos_shed", "qos_evict"):
        line = f"tenant={ev.get('tenant')}"
    elif kind == "violation":
        probs = ev.get("problems") or []
        line = f"{len(probs)} problem(s)"
        detail = [str(p) for p in probs]
    elif kind == "slo_alert":
        line = (f"state={ev.get('state')} "
                f"fast_burn={ev.get('fast_burn')} "
                f"slow_burn={ev.get('slow_burn')} "
                f"attainment={ev.get('attainment')}")
    elif kind == "pool_failure":
        line = f"{ev.get('error')} in {ev.get('where')}"
    else:
        skip = {"kind", "t", "rid", "seq"}
        line = " ".join(f"{k}={ev[k]}" for k in sorted(ev)
                        if k not in skip)
    return line, detail


def render_incident(doc: Dict[str, Any],
                    rid: Optional[str] = None) -> str:
    """Reconstruct the per-request/incident timeline from a dump.

    Events are grouped by correlation ID (first-seen order, uncorrelated
    events last), each group rendered as offsets from its first event —
    which rung answered, why (log lines), how long, what it displaced.
    ``rid`` filters to one group.
    """
    meta = doc.get("meta", {})
    events = sorted(doc.get("events", []),
                    key=lambda e: e.get("seq", 0))
    groups: Dict[Optional[str], List[Dict[str, Any]]] = {}
    order: List[Optional[str]] = []
    for ev in events:
        g = ev.get("rid")
        if g not in groups:
            groups[g] = []
            order.append(g)
    for ev in events:
        groups[ev.get("rid")].append(ev)
    if None in order:                    # uncorrelated events render last
        order.remove(None)
        order.append(None)
    if rid is not None:
        if rid not in groups:
            known = ", ".join(str(g) for g in order if g)
            return (f"no events for rid {rid!r}; "
                    f"known ids: {known or '(none)'}")
        order = [rid]

    out: List[str] = []
    out.append(f"flight recorder: {len(events)} events "
               f"({meta.get('dropped', 0)} dropped, "
               f"cap {meta.get('capacity', '?')}), "
               f"pid {meta.get('pid', '?')}, "
               f"reason {meta.get('reason', '?')}")
    by_kind: Dict[str, int] = {}
    for ev in events:
        by_kind[ev.get("kind", "?")] = by_kind.get(ev.get("kind", "?"),
                                                   0) + 1
    out.append("  " + "  ".join(f"{k}={n}"
                                for k, n in sorted(by_kind.items())))
    for g in order:
        evs = groups[g]
        t0 = evs[0].get("t", 0.0)
        span_ms = (evs[-1].get("t", t0) - t0) * 1e3
        label = g if g is not None else "(uncorrelated)"
        out.append("")
        out.append(f"{label}  ({len(evs)} events, {span_ms:.1f}ms)")
        for ev in evs:
            dt = (ev.get("t", t0) - t0) * 1e3
            line, detail = _fmt_event(ev)
            out.append(f"  +{dt:8.1f}ms  {ev.get('kind', '?'):<12} {line}")
            for d in detail:
                out.append(f"        | {d}")
    return "\n".join(out)
