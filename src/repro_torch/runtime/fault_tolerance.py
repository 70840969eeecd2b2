"""Fault tolerance for 1000+-node operation.

Three mechanisms, each exercised by tests with injected failures:

* **Heartbeats / failure detection** — every host reports (step, wall-time)
  into a :class:`HeartbeatRegistry`; a host silent for ``timeout_s`` is
  declared dead.  In a real deployment the registry is a small etcd/GCS
  object; the interface is identical.
* **Straggler mitigation** — per-step wall-times feed a rolling p50/p95
  tracker; a host persistently above ``straggler_factor x p50`` is flagged,
  and the driver's policy (``on_straggler``) can hot-swap it (elastic
  re-mesh) or deprioritize its shard.  This is the *detection* half the
  paper's static planner cannot do — and the re-plan half is exactly what a
  dataflow planner buys: a new mapping for the surviving device set.
* **Step-retry driver** — ``run_resilient_step`` wraps the train step;
  device/transfer failures raise, the driver restores from the checkpoint
  manager and replays (deterministic data => bitwise-identical recovery
  modulo the lost steps).
"""
from __future__ import annotations

import collections
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple


@dataclass
class HostState:
    host: int
    last_step: int = -1
    last_seen: float = 0.0
    step_times: Deque[float] = field(default_factory=lambda:
                                     collections.deque(maxlen=64))


class HeartbeatRegistry:
    def __init__(self, n_hosts: int, *, timeout_s: float = 60.0,
                 now: Optional[float] = None):
        # registration counts as the first "seen" instant: a host that
        # never beats at all (crashed during bring-up, silent from birth)
        # must still time out rather than look eternally healthy
        t0 = now if now is not None else time.time()
        self.hosts: Dict[int, HostState] = {
            h: HostState(h, last_seen=t0) for h in range(n_hosts)}
        self.timeout_s = timeout_s

    def beat(self, host: int, step: int, step_time_s: float,
             now: Optional[float] = None) -> None:
        st = self.hosts[host]
        st.last_step = step
        st.last_seen = now if now is not None else time.time()
        st.step_times.append(step_time_s)

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [h for h, st in self.hosts.items()
                if now - st.last_seen > self.timeout_s]

    def alive_hosts(self, now: Optional[float] = None) -> List[int]:
        dead = set(self.dead_hosts(now))
        return [h for h in self.hosts if h not in dead]


class StragglerTracker:
    """Flags hosts persistently slower than ``factor x median`` step time."""

    def __init__(self, registry: HeartbeatRegistry, *,
                 factor: float = 1.5, min_samples: int = 8):
        self.reg = registry
        self.factor = factor
        self.min_samples = min_samples

    def medians(self) -> Dict[int, float]:
        return {h: statistics.median(st.step_times)
                for h, st in self.reg.hosts.items()
                if len(st.step_times) >= self.min_samples}

    def stragglers(self) -> List[int]:
        med = self.medians()
        if len(med) < 2:
            return []
        global_p50 = statistics.median(med.values())
        return [h for h, m in med.items() if m > self.factor * global_p50]


@dataclass
class RecoveryEvent:
    step: int
    kind: str                 # "restart" | "straggler" | "rescale"
    detail: str


class ResilientDriver:
    """Wraps a step function with checkpoint-restore-replay semantics.

    Recovery is *strictly* replay-from-checkpoint: after a failed step the
    in-memory ``state`` may hold a partially-applied update, so the driver
    never retries against it — it restores from the checkpoint manager and
    replays.  ``registry``/``tracker`` wire in failure and straggler
    detection; detections are recorded as :class:`RecoveryEvent`\\ s
    (``"straggler"`` / ``"rescale"``) and, for dead hosts, forwarded to
    ``rescale_fn(dead, alive)`` so an elastic re-mesh can run.
    """

    def __init__(self, step_fn: Callable, manager, *, max_retries: int = 3,
                 registry: Optional[HeartbeatRegistry] = None,
                 tracker: Optional["StragglerTracker"] = None,
                 rescale_fn: Optional[Callable] = None,
                 host: int = 0,
                 step_time_scale: Optional[Callable[[int], float]] = None,
                 clock: Callable[[], float] = time.time):
        self.step_fn = step_fn
        self.manager = manager
        self.max_retries = max_retries
        self.registry = registry
        self.tracker = tracker
        self.rescale_fn = rescale_fn
        self.host = host
        self.step_time_scale = step_time_scale
        self.clock = clock
        self.events: List[RecoveryEvent] = []
        self._flagged_stragglers: set = set()
        self._known_dead: set = set()

    def run(self, state, batches, *, start_step: int, n_steps: int,
            restore_fn: Optional[Callable] = None,
            on_step: Optional[Callable] = None):
        """Run steps with retry-on-failure.

        ``restore_fn() -> (state, step)`` rebuilds state from the latest
        checkpoint.  It is *required* whenever retries are allowed: replaying
        against the in-memory state after a failure would re-run on a
        possibly-corrupt tree, so the driver refuses up front rather than
        silently doing the unsafe thing (pass ``max_retries=0`` to fail
        fast instead).  ``on_step(step, state, metrics, dt)`` is called
        after each completed step (logging hook)."""
        if restore_fn is None and self.max_retries > 0:
            raise ValueError(
                "ResilientDriver.run: restore_fn is required when "
                "max_retries > 0 — recovery replays from the last "
                "checkpoint, never from in-memory state after a failed "
                "step.  Pass restore_fn=, or max_retries=0 to fail fast.")
        step = start_step
        retries = 0
        metrics = None
        while step < start_step + n_steps:
            batch = batches(step)
            try:
                t0 = self.clock()
                state, metrics = self.step_fn(state, batch)
                dt = self.clock() - t0
                # checkpoint step := number of COMPLETED steps, so a restore
                # resumes at exactly that step index (no replayed double step)
                done = step + 1
                if self.manager is not None and self.manager.should_save(done):
                    self.manager.save(state, done)
            except Exception as e:             # device loss, preemption, ...
                retries += 1
                self.events.append(RecoveryEvent(step, "restart", repr(e)))
                if retries > self.max_retries:
                    raise
                state, step = restore_fn()
                continue
            step += 1
            retries = 0
            self._observe(step, dt)
            if on_step is not None:
                on_step(step, state, metrics, dt)
        return state, step, metrics

    # ------------------------------------------------- detection plumbing
    def _observe(self, step: int, dt: float) -> None:
        """Report this host's heartbeat and turn tracker/registry state
        into recovery events (each host flagged at most once)."""
        now = self.clock()
        if self.registry is not None:
            scale = (self.step_time_scale(step)
                     if self.step_time_scale is not None else 1.0)
            self.registry.beat(self.host, step, dt * scale, now=now)
        if self.tracker is not None:
            for h in self.tracker.stragglers():
                if h not in self._flagged_stragglers:
                    self._flagged_stragglers.add(h)
                    self.events.append(RecoveryEvent(
                        step, "straggler",
                        f"host {h} > {self.tracker.factor:g}x median "
                        f"step time"))
        if self.registry is not None:
            dead = [h for h in self.registry.dead_hosts(now=now)
                    if h not in self._known_dead]
            if dead:
                self._known_dead.update(dead)
                alive = self.registry.alive_hosts(now=now)
                self.events.append(RecoveryEvent(
                    step, "rescale",
                    f"hosts {sorted(dead)} dead; rescale to "
                    f"{len(alive)} hosts"))
                if self.rescale_fn is not None:
                    self.rescale_fn(sorted(dead), alive)
