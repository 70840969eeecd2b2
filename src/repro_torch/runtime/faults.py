"""Deterministic, seeded fault injection (DESIGN_FAULTS.md).

Every recovery path in this repo is exercised by *injected* faults, never by
prose: a :class:`FaultSchedule` is a reproducible, seeded list of
:class:`FaultSpec` events that tests, the benchmark harness
(``REPRO_FAULTS``), and the launchers feed into the simulator and the
runtime drivers.

Fault kinds:

* ``core_kill``       — permanently disable one core; materialized as a
  :meth:`HardwareModel.with_faults` overlay, so the planner routes around it
  (degraded-mesh planning) and the simulators mask it out.
* ``link_slow``       — scale one interconnect's per-link bandwidth.
* ``host_straggler``  — multiply one host's step wall-times (feeds
  :class:`~repro_torch.runtime.fault_tolerance.StragglerTracker` detection).
* ``worker_crash``    — hard-exit one search-pool worker (armed through
  ``repro_torch.parallel.search_exec.CRASH_ENV``; exercises the pool's
  retry-then-inline hardening).

The module imports no accelerator runtime — it is safe to use from the
planner, the benchmark harness, and worker processes alike.
"""
from __future__ import annotations

import os
import random
import tempfile
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

FAULTS_ENV = "REPRO_FAULTS"

KINDS = ("core_kill", "link_slow", "host_straggler", "worker_crash")


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault.  ``step`` is the (0-based) step index at which
    the fault takes effect; hardware faults are permanent from that step."""
    kind: str
    step: int = 0
    core: Optional[Tuple[int, ...]] = None     # core_kill
    link: str = ""                             # link_slow
    factor: float = 1.0                        # link_slow / host_straggler
    host: int = -1                             # host_straggler

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds: {KINDS}")

    def describe(self) -> str:
        if self.kind == "core_kill":
            return f"core_kill{self.core}@{self.step}"
        if self.kind == "link_slow":
            return f"link_slow:{self.link}x{self.factor:g}@{self.step}"
        if self.kind == "host_straggler":
            return f"straggler:host{self.host}x{self.factor:g}@{self.step}"
        return f"worker_crash@{self.step}"


class FaultSchedule:
    """An ordered, deterministic fault timeline."""

    def __init__(self, faults: Sequence[FaultSpec] = ()) -> None:
        self.faults: Tuple[FaultSpec, ...] = tuple(
            sorted(faults, key=lambda f: (f.step, KINDS.index(f.kind),
                                          f.describe())))

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def describe(self) -> str:
        return "; ".join(f.describe() for f in self.faults) or "(no faults)"

    # ------------------------------------------------------------ queries
    def at(self, step: int) -> List[FaultSpec]:
        return [f for f in self.faults if f.step == step]

    def active(self, step: Optional[int] = None) -> List[FaultSpec]:
        """Faults in effect at ``step`` (None = all of them)."""
        if step is None:
            return list(self.faults)
        return [f for f in self.faults if f.step <= step]

    def degraded_hw(self, hw, step: Optional[int] = None):
        """``hw`` with every hardware fault active at ``step`` applied
        (:meth:`HardwareModel.with_faults`); the unchanged model when none
        are — the fault-free path stays byte-identical.

        A schedule describes faults on *a* fabric, but callers (the
        benchmark sweeps especially) apply it to many mesh shapes — faults
        that do not exist on ``hw`` (core coords out of range, unknown
        interconnect names) are skipped rather than raised, so one
        ``REPRO_FAULTS`` setting can degrade every mesh it fits.
        """
        dims = [hw.dim(d).size for d in hw.core.scaleout]
        ic_names = {ic.name for ic in hw.interconnects}
        cores = [f.core for f in self.active(step)
                 if f.kind == "core_kill" and f.core is not None
                 and len(f.core) == len(dims)
                 and all(0 <= v < s for v, s in zip(f.core, dims))]
        links = [(f.link, f.factor) for f in self.active(step)
                 if f.kind == "link_slow" and f.link in ic_names]
        if len({tuple(c) for c in cores} | hw.disabled_core_set()) >= hw.n_cores:
            cores = []  # would kill the whole fabric — nothing left to plan on
        if not cores and not links:
            return hw
        return hw.with_faults(disabled_cores=cores, degraded_links=links)

    def straggler_factor(self, host: int, step: int) -> float:
        """Multiplier on ``host``'s step wall-time at ``step`` (1.0 =
        healthy) — tests and the launch harness scale simulated step times
        by this to drive straggler detection."""
        out = 1.0
        for f in self.active(step):
            if f.kind == "host_straggler" and f.host == host:
                out *= f.factor
        return out

    def worker_crashes(self, step: Optional[int] = None) -> int:
        return sum(1 for f in self.active(step) if f.kind == "worker_crash")

    # ----------------------------------------------------- worker crashes
    def arm_worker_crash(self, directory: Optional[str] = None) -> str:
        """Arm one search-pool worker crash: create the one-shot marker
        file and export it via ``search_exec.CRASH_ENV``.  Returns the
        marker path; call :meth:`disarm_worker_crash` (or let the crash
        consume the marker) when done."""
        from repro_torch.parallel.search_exec import CRASH_ENV
        fd, marker = tempfile.mkstemp(prefix="crash_", dir=directory)
        os.close(fd)
        os.environ[CRASH_ENV] = marker
        return marker

    @staticmethod
    def disarm_worker_crash() -> None:
        from repro_torch.parallel.search_exec import CRASH_ENV
        marker = os.environ.pop(CRASH_ENV, "")
        if marker:
            try:
                os.remove(marker)
            except OSError:
                pass

    # ------------------------------------------------------------ seeding
    @classmethod
    def seeded(cls, seed: int, *, hw=None, n_steps: int = 1,
               n_hosts: int = 0, n_faults: int = 1,
               kinds: Optional[Sequence[str]] = None) -> "FaultSchedule":
        """Draw a reproducible schedule: same (seed, hw shape, args) =>
        same faults, on any machine.  ``kinds`` defaults to every kind the
        inputs support (core/link faults need ``hw``, stragglers need
        ``n_hosts``)."""
        rng = random.Random(seed)
        allowed = list(kinds) if kinds is not None else [
            k for k in KINDS
            if (k == "worker_crash"
                or (k == "host_straggler" and n_hosts > 0)
                or (k in ("core_kill", "link_slow") and hw is not None))]
        for k in allowed:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        if not allowed:
            raise ValueError("no fault kind is drawable from the given "
                             "inputs (pass hw= and/or n_hosts=)")
        faults: List[FaultSpec] = []
        killed = set()
        for _ in range(n_faults):
            kind = rng.choice(allowed)
            step = rng.randrange(max(1, n_steps))
            if kind == "core_kill":
                sizes = [s for _, s in hw.mesh_dims]
                core = tuple(rng.randrange(s) for s in sizes)
                if core in killed or len(killed) + 1 >= hw.n_cores:
                    continue
                killed.add(core)
                faults.append(FaultSpec("core_kill", step, core=core))
            elif kind == "link_slow":
                ics = [ic.name for ic in hw.interconnects]
                if not ics:
                    continue
                faults.append(FaultSpec(
                    "link_slow", step, link=rng.choice(ics),
                    factor=round(rng.uniform(0.25, 0.75), 2)))
            elif kind == "host_straggler":
                faults.append(FaultSpec(
                    "host_straggler", step, host=rng.randrange(n_hosts),
                    factor=round(rng.uniform(2.0, 4.0), 2)))
            else:
                faults.append(FaultSpec("worker_crash", step))
        return cls(faults)


# ------------------------------------------------------------- env syntax
def parse_faults(text: str) -> FaultSchedule:
    """Parse the ``REPRO_FAULTS`` syntax: ``;``-separated items, each
    optionally suffixed ``@step`` (default step 0):

    * ``core:R,C``          — kill the core at mesh coords (R, C, ...)
    * ``link:NAME:FACTOR``  — slow interconnect NAME to FACTOR of nominal
    * ``straggler:HOST[:FACTOR]`` — host HOST runs FACTOR (default 3) slower
    * ``crash``             — crash one search-pool worker

    Example: ``REPRO_FAULTS="core:3,5;link:noc_h:0.5@2"``.

    Rejected with an actionable error (both used to be accepted and
    either failed much later or silently composed):

    * link factors outside ``(0, 1]`` — a factor of 0 models a *cut*
      link, which the bandwidth model cannot represent (use ``core:``
      kills to remove capacity); > 1 is a speed-up, not a fault;
    * duplicate items — killing the same core twice, or repeating any
      item verbatim, is almost always a typo'd schedule; link
      degradations compose *multiplicatively*, so a pasted duplicate
      would silently halve the bandwidth again.
    """
    faults: List[FaultSpec] = []
    seen_cores: dict = {}
    seen_items: dict = {}
    for raw in text.split(";"):
        item = raw.strip()
        if not item:
            continue
        first = seen_items.setdefault(item, raw)
        if first is not raw:
            raise ValueError(
                f"duplicate fault item {raw!r}: already specified; link "
                f"factors compose multiplicatively, so repeating an item "
                f"changes the schedule — drop the duplicate or change its "
                f"@step")
        step = 0
        if "@" in item:
            item, _, s = item.rpartition("@")
            step = int(s)
        parts = item.split(":")
        tag = parts[0].strip().lower()
        try:
            if tag == "core":
                core = tuple(int(v) for v in parts[1].split(","))
                prev = seen_cores.setdefault(core, raw)
                if prev is not raw:
                    raise ValueError(
                        f"core {core} already killed by {prev!r}; a core "
                        f"can only die once — remove one of the items")
                faults.append(FaultSpec("core_kill", step, core=core))
            elif tag == "link":
                factor = float(parts[2])
                if not 0.0 < factor <= 1.0:
                    raise ValueError(
                        f"link factor {factor:g} must be in (0, 1] — "
                        f"1.0 is nominal bandwidth, 0 would be a cut "
                        f"link (kill the adjacent cores instead)")
                faults.append(FaultSpec("link_slow", step, link=parts[1],
                                        factor=factor))
            elif tag == "straggler":
                factor = float(parts[2]) if len(parts) > 2 else 3.0
                faults.append(FaultSpec("host_straggler", step,
                                        host=int(parts[1]), factor=factor))
            elif tag == "crash":
                faults.append(FaultSpec("worker_crash", step))
            else:
                raise ValueError(f"unknown fault item {raw!r}")
        except (IndexError, ValueError) as e:
            raise ValueError(f"bad fault item {raw!r}: {e}") from e
    return FaultSchedule(faults)


def env_schedule() -> Optional[FaultSchedule]:
    """The schedule from ``REPRO_FAULTS``, or None when unset/empty."""
    text = os.environ.get(FAULTS_ENV, "").strip()
    return parse_faults(text) if text else None


def apply_env_faults(hw):
    """``hw`` degraded by every hardware fault in ``REPRO_FAULTS`` (any
    step), byte-identical pass-through when the variable is unset — the
    benchmark harness's injection point."""
    sched = env_schedule()
    return sched.degraded_hw(hw, None) if sched is not None else hw
