"""Sliding-window SLO tracker for the serving stack (stdlib-only).

Tracks the three serving questions the plan-service/tenancy stack must
answer about itself:

* **deadline attainment** — fraction of plan requests answered within
  their deadline, over a *fast* window (default 60s) and a *slow* window
  (default 600s);
* **rung distribution** — which ladder rung answered, over the slow
  window (a healthy service answers from ``cache``; a drift toward
  ``fallback`` is the early-warning signal the attainment number lags);
* **blast radius** — per-tenant containment incidents and how many
  innocent tenants each displaced.

Alerting follows the multi-window burn-rate scheme (Google SRE workbook):
``burn = miss_rate / (1 - target)`` (how many times faster than the
error budget allows we are burning it), and the alert fires only when
*both* the fast and the slow window exceed the threshold — the fast
window gives detection latency, the slow window keeps one bad second
from paging.  Transitions are edge-triggered: each ``ok -> firing`` and
``firing -> ok`` edge emits one ``slo_alert`` flight-recorder event and
bumps ``slo_alert_transitions_total`` — state, not a per-request siren.

The tracker is off by default (the serve launcher enables it); when off,
:func:`note_request` is one attribute load.  Like every obs module it
only observes — nothing reads it back to make a serving decision.  The
clock is injectable so tests can replay a week of traffic in
microseconds.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

TARGET_ENV = "REPRO_SLO_TARGET"
FAST_ENV = "REPRO_SLO_FAST_S"
SLOW_ENV = "REPRO_SLO_SLOW_S"
BURN_ENV = "REPRO_SLO_BURN"

DEFAULT_TARGET = 0.99
DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 600.0
#: 14.4 = burning a 30-day budget in 2 days (the workbook's page-now
#: threshold); scaled windows keep the same constant meaningful.
DEFAULT_BURN = 14.4


class SLOTracker:
    """Sliding-window attainment/burn-rate tracker.

    One module-level instance (:data:`TRACKER`) serves the process; the
    class is separate so tests can drive a private one with a fake clock.
    """

    def __init__(self, target: float = DEFAULT_TARGET,
                 fast_s: float = DEFAULT_FAST_S,
                 slow_s: float = DEFAULT_SLOW_S,
                 burn_threshold: float = DEFAULT_BURN,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.on = False
        self.target = target
        self.fast_s = fast_s
        self.slow_s = max(slow_s, fast_s)
        self.burn_threshold = burn_threshold
        self.clock = clock
        self._lock = threading.Lock()
        # (t, ok, rung, tenant) per request, pruned past the slow window
        self._requests: deque = deque()
        # (t, owner, blast_radius, rung) per containment incident
        self._incidents: deque = deque()
        self.alert_state = "ok"
        self.alert_since: Optional[float] = None
        self.transitions = 0

    # ----------------------------------------------------------- control
    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def clear(self) -> None:
        with self._lock:
            self._requests.clear()
            self._incidents.clear()
            self.alert_state = "ok"
            self.alert_since = None
            self.transitions = 0

    def configure_from_env(self) -> None:
        """Apply ``REPRO_SLO_{TARGET,FAST_S,SLOW_S,BURN}`` overrides."""
        for env, attr in ((TARGET_ENV, "target"), (FAST_ENV, "fast_s"),
                          (SLOW_ENV, "slow_s"), (BURN_ENV, "burn_threshold")):
            raw = os.environ.get(env, "").strip()
            if raw:
                try:
                    setattr(self, attr, float(raw))
                except ValueError:
                    pass
        self.slow_s = max(self.slow_s, self.fast_s)

    # ------------------------------------------------------------ intake
    def note_request(self, ok: bool, rung: str,
                     seconds: float = 0.0,
                     tenant: Optional[str] = None) -> None:
        """One plan request answered: ``ok`` is deadline attainment
        (rung outcome, not plan quality).  Re-evaluates the burn alert."""
        if not self.on:
            return
        now = self.clock()
        with self._lock:
            self._requests.append((now, bool(ok), str(rung), tenant))
            self._prune(now)
            self._check_alert(now)

    def note_containment(self, owner: str, blast_radius: int,
                         rung: str = "") -> None:
        """One tenancy containment incident attributed to ``owner``
        displacing ``blast_radius`` tenants (including the owner)."""
        if not self.on:
            return
        now = self.clock()
        with self._lock:
            self._incidents.append((now, str(owner), int(blast_radius),
                                    str(rung)))
            self._prune(now)

    # ---------------------------------------------------------- internal
    def _prune(self, now: float) -> None:
        horizon = now - self.slow_s
        while self._requests and self._requests[0][0] < horizon:
            self._requests.popleft()
        while self._incidents and self._incidents[0][0] < horizon:
            self._incidents.popleft()

    def _window(self, now: float, width: float) -> Dict[str, float]:
        t0 = now - width
        total = miss = 0
        for t, ok, _rung, _tenant in self._requests:
            if t >= t0:
                total += 1
                if not ok:
                    miss += 1
        miss_rate = (miss / total) if total else 0.0
        budget = 1.0 - self.target
        burn = (miss_rate / budget) if budget > 0 else (
            float("inf") if miss else 0.0)
        return {"total": total, "miss": miss,
                "attainment": 1.0 - miss_rate, "burn": burn}

    def _check_alert(self, now: float) -> None:
        fast = self._window(now, self.fast_s)
        slow = self._window(now, self.slow_s)
        firing = (fast["total"] > 0 and slow["total"] > 0
                  and fast["burn"] >= self.burn_threshold
                  and slow["burn"] >= self.burn_threshold)
        state = "firing" if firing else "ok"
        if state == self.alert_state:
            return
        self.alert_state = state
        self.alert_since = now
        self.transitions += 1
        # Emit outside the registry's own locking concerns but inside
        # ours: flightrec/metrics use their own locks and never call back.
        from . import flightrec, metrics
        flightrec.record("slo_alert", state=state,
                         fast_burn=round(fast["burn"], 3),
                         slow_burn=round(slow["burn"], 3),
                         attainment=round(slow["attainment"], 5),
                         threshold=self.burn_threshold)
        metrics.inc("slo_alert_transitions_total", state=state)

    # ------------------------------------------------------------ report
    def report(self) -> Dict[str, Any]:
        """Plain-JSON view for ``/slo`` and the smoke lane."""
        now = self.clock()
        with self._lock:
            self._prune(now)
            fast = self._window(now, self.fast_s)
            slow = self._window(now, self.slow_s)
            rungs: Dict[str, int] = {}
            for _t, _ok, rung, _tenant in self._requests:
                rungs[rung] = rungs.get(rung, 0) + 1
            tenants: Dict[str, Dict[str, Any]] = {}
            for _t, owner, blast, rung in self._incidents:
                rec = tenants.setdefault(owner, {
                    "incidents": 0, "blast_radius_max": 0,
                    "blast_radius_sum": 0, "rungs": {}})
                rec["incidents"] += 1
                rec["blast_radius_sum"] += blast
                rec["blast_radius_max"] = max(rec["blast_radius_max"],
                                              blast)
                if rung:
                    rec["rungs"][rung] = rec["rungs"].get(rung, 0) + 1
            return {
                "enabled": self.on,
                "target": self.target,
                "burn_threshold": self.burn_threshold,
                "windows": {"fast_s": self.fast_s, "slow_s": self.slow_s},
                "fast": fast,
                "slow": slow,
                "rungs": rungs,
                "tenants": tenants,
                "alert": {"state": self.alert_state,
                          "since": self.alert_since,
                          "transitions": self.transitions},
            }


TRACKER = SLOTracker()


# ------------------------------------------------- module-level convenience
def enabled() -> bool:
    return TRACKER.on


def enable() -> None:
    TRACKER.configure_from_env()
    TRACKER.enable()


def disable() -> None:
    TRACKER.disable()


def clear() -> None:
    TRACKER.clear()


def note_request(ok: bool, rung: str, seconds: float = 0.0,
                 tenant: Optional[str] = None) -> None:
    if not TRACKER.on:                   # the entire disabled cost
        return
    TRACKER.note_request(ok, rung, seconds, tenant)


def note_containment(owner: str, blast_radius: int,
                     rung: str = "") -> None:
    if not TRACKER.on:
        return
    TRACKER.note_containment(owner, blast_radius, rung)


def report() -> Dict[str, Any]:
    return TRACKER.report()
