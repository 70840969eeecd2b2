"""The deadline-bounded plan service (DESIGN_PLANSERVICE.md).

``PlanService.resolve`` walks a four-rung ladder under a
``time.monotonic`` deadline and **always returns a PlanResponse, never
raises**:

1. ``cache``    — exact plancache hit (integrity-checked + sanitized);
2. ``family``   — a cached shape-neighbor's plan transplanted onto the
   requested shape and certified against a regret bound (family.py);
3. ``search``   — a bounded incremental search, budget trimmed to the
   remaining deadline (``core.planner.budget_for_deadline``); degraded
   fabrics route into the PR 7 ladder (``runtime.replan.plan_degraded``)
   instead of a cold search;
4. ``fallback`` — the guaranteed generic plan (fallback.py).

Robustness machinery: concurrent identical requests coalesce onto one
in-flight resolution; a semaphore admission gate bounds concurrent cold
searches (overload sheds to the fallback rung); a per-(template, hw)
circuit breaker skips the search rung after repeated deadline misses and
half-opens on a cooldown timer; and when the deadline forces a fallback
or family answer, the full search continues on a background thread and
publishes to the plancache so the next identical request is a rung-1
hit.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

from repro_torch.core.hw import HardwareModel
from repro_torch.core.planner import (PlanResult, SearchBudget, budget_for_deadline,
                                effective_budget, plan_kernel_multi)
from repro_torch.core.program import TileProgram
from repro_torch.obs import context, flightrec, metrics, slo, trace
from repro_torch.plancache import PlanCache, keying

RUNGS = ("cache", "family", "search", "fallback")

ENV_DEADLINE = "REPRO_PLAN_DEADLINE_MS"
ENV_REGRET = "REPRO_PLAN_REGRET"
ENV_BG = "REPRO_PLAN_BG"


def default_deadline_ms() -> float:
    try:
        return float(os.environ.get(ENV_DEADLINE, "") or 10.0)
    except ValueError:
        return 10.0


def default_regret() -> float:
    try:
        return float(os.environ.get(ENV_REGRET, "") or 3.0)
    except ValueError:
        return 3.0


def background_enabled() -> bool:
    return os.environ.get(ENV_BG, "").lower() not in (
        "0", "off", "false", "no")


@dataclass
class PlanRequest:
    """One plan resolution request.  ``budget_ms=None`` means the env
    default (:data:`ENV_DEADLINE`, ~10ms); ``float("inf")`` disables the
    deadline entirely — full-budget resolution through the service is
    then bit-identical to calling ``plan_kernel_multi`` directly."""
    programs: Sequence[TileProgram]
    hw: HardwareModel
    budget: Optional[SearchBudget] = None
    budget_ms: Optional[float] = None
    profile: bool = True
    spatial_reuse: bool = True
    temporal_reuse: bool = True
    regret_bound: Optional[float] = None   # None -> env default (~3x)
    background: Optional[bool] = None      # None -> env default (on)


@dataclass
class PlanResponse:
    """What resolve() always returns.  ``result`` is None only for
    ``outcome="infeasible"`` (no candidate program fits the hardware at
    all — the one case where "always return a runnable plan" has no
    plan to return, reported instead of invented)."""
    result: Optional[PlanResult]
    rung: str                   # member of RUNGS
    outcome: str                # ok|coalesced|deadline|shed|breaker_open|
    #                             infeasible|error
    hw: HardwareModel           # the model the plan targets (may be a
    #                             submesh of the requested fabric)
    seconds: float
    deadline_ms: float
    key: str
    log: List[str] = field(default_factory=list)
    background: bool = False    # a background completion was scheduled

    @property
    def plan(self):
        return self.result.best.plan if self.result is not None else None

    @property
    def ok(self) -> bool:
        return self.result is not None


@dataclass
class MeshPlanResponse:
    """resolve_mesh()'s answer: the mesh-parallel ranking plus the same
    rung/latency accounting single-kernel responses carry."""
    ranking: Any
    rung: str
    outcome: str
    seconds: float


class _Flight:
    """One in-flight resolution identical requests coalesce onto."""
    __slots__ = ("event", "response")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.response: Optional[PlanResponse] = None


class _Breaker:
    """Per-(template, hw) circuit breaker over rung-3 deadline misses.

    closed -> (threshold misses) -> open -> (cooldown) -> half_open
    -> one trial -> closed on success / open on another miss.

    Every state transition lands in the flight recorder (kind
    ``breaker``) and in ``planservice_breaker_transitions_total`` — a
    breaker flapping open is the single most explanatory event in a
    deadline-miss incident.
    """

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float], key: str = "") -> None:
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.key = key
        self.state = "closed"
        self.misses = 0
        self.opened_at = 0.0

    def _set_state(self, state: str) -> None:
        if state == self.state:
            return
        prev, self.state = self.state, state
        flightrec.record("breaker", key=self.key,
                         **{"from": prev, "to": state})
        metrics.inc("planservice_breaker_transitions_total", to=state)

    def force_open(self) -> None:
        """Re-open without counting a miss (half-open trial gave its
        slot back)."""
        self._set_state("open")
        self.opened_at = self.clock()

    def allow(self) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.clock() - self.opened_at >= self.cooldown_s:
                self._set_state("half_open")  # admit exactly one trial
                return True
            return False
        return False                         # half_open trial in flight

    def record_ok(self) -> None:
        self._set_state("closed")
        self.misses = 0

    def record_miss(self) -> None:
        self.misses += 1
        if self.state == "half_open" or self.misses >= self.threshold:
            self._set_state("open")
            self.opened_at = self.clock()
            self.misses = 0


class PlanService:
    """In-process plan server; thread-safe; one instance per process is
    the intended deployment (``launch/serve.py`` owns one)."""

    def __init__(self, cache: Optional[PlanCache] = None, *,
                 max_concurrent_searches: int = 2,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.cache = cache if cache is not None else PlanCache()
        self.clock = clock
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        # max_concurrent_searches=0 is a legal test/overload configuration
        # (shed every search); BoundedSemaphore(0) is not constructible
        self._no_search = max_concurrent_searches <= 0
        self._gate = threading.BoundedSemaphore(
            max(1, max_concurrent_searches))
        self._lock = threading.Lock()
        self._flights: Dict[str, _Flight] = {}
        self._fallbacks: Dict[str, Tuple[Optional[PlanResult],
                                         HardwareModel]] = {}
        self._breakers: Dict[str, _Breaker] = {}
        self._ewma: Dict[str, float] = {}    # predicted search seconds
        self._bg_keys: Set[str] = set()
        self._bg_threads: List[threading.Thread] = []

    # ------------------------------------------------------------- public
    def resolve(self, request: PlanRequest) -> PlanResponse:
        """Walk the ladder.  Never raises; always within ~one rung-check
        of the deadline (each rung re-checks remaining time before it
        starts, so only the granularity of a single check can overrun).

        Runs inside a correlation scope: a fresh ``plan-*`` request ID
        unless the caller already holds one (a resolve nested inside a
        tenancy/replan incident inherits the incident ID)."""
        with context.correlate("plan"):
            return self._resolve(request)

    def _resolve(self, request: PlanRequest) -> PlanResponse:
        t0 = self.clock()
        deadline_ms = (request.budget_ms if request.budget_ms is not None
                       else default_deadline_ms())
        budget = effective_budget(request.budget)
        try:
            key = keying.kernel_key(
                list(request.programs), request.hw, budget,
                profile=request.profile,
                spatial_reuse=request.spatial_reuse,
                temporal_reuse=request.temporal_reuse)
        except Exception as e:  # noqa: BLE001 — resolve must not raise
            resp = self._fallback_response(
                request, "", t0, deadline_ms, budget,
                log=[f"keying error: {e!r}"], outcome="error")
            self._note(resp)
            return resp

        # ---- in-flight coalescing ---------------------------------------
        with self._lock:
            flight = self._flights.get(key)
            leader = flight is None
            if leader:
                flight = self._flights[key] = _Flight()
        if not leader:
            timeout = (None if deadline_ms == float("inf")
                       else max(0.0, deadline_ms / 1e3
                                - (self.clock() - t0)))
            if flight.event.wait(timeout) and flight.response is not None:
                resp = dataclasses.replace(
                    flight.response, outcome="coalesced",
                    seconds=self.clock() - t0, deadline_ms=deadline_ms)
            else:
                resp = self._fallback_response(
                    request, key, t0, deadline_ms, budget,
                    log=["coalesced wait expired before leader finished"],
                    outcome="deadline")
            self._note(resp)
            return resp

        resp: Optional[PlanResponse] = None
        try:
            resp = self._ladder(request, key, t0, deadline_ms, budget)
        except Exception as e:  # noqa: BLE001 — the contract: never raise
            resp = self._fallback_response(
                request, key, t0, deadline_ms, budget,
                log=[f"ladder error: {e!r}"], outcome="error")
        finally:
            flight.response = resp
            with self._lock:
                self._flights.pop(key, None)
            flight.event.set()
        self._note(resp)
        return resp

    def resolve_mesh(self, api, shape, tcfg, *, multi_pod: bool = False,
                     top_k: int = 3,
                     budget_ms: Optional[float] = None) -> MeshPlanResponse:
        """Mesh-parallel requests (``parallel.planner_bridge.plan_mesh``)
        through the service's accounting: rung from the plancache probe,
        latency against the deadline, same metric families.  Never
        raises."""
        from repro_torch.plancache import lookup_source
        with context.correlate("plan"):
            t0 = self.clock()
            deadline_ms = (budget_ms if budget_ms is not None
                           else default_deadline_ms())
            ranking, rung, outcome = None, "fallback", "error"
            try:
                from repro_torch.parallel.planner_bridge import plan_mesh
                with lookup_source(self.cache.store) as probe:
                    ranking = plan_mesh(api, shape, tcfg,
                                        multi_pod=multi_pod, top_k=top_k)
                rung = "cache" if probe["source"] == "cache" else "search"
                outcome = "ok"
            except Exception:  # noqa: BLE001
                pass
            resp = MeshPlanResponse(ranking=ranking, rung=rung,
                                    outcome=outcome,
                                    seconds=self.clock() - t0)
            metrics.inc("planservice_requests_total", rung=rung,
                        outcome=outcome)
            metrics.observe("planservice_resolve_seconds", resp.seconds,
                            rung=rung)
            missed = (deadline_ms != float("inf")
                      and resp.seconds * 1e3 > deadline_ms)
            if missed:
                metrics.inc("planservice_deadline_miss_total", rung=rung)
            flightrec.record("plan_request", mode="mesh", rung=rung,
                             outcome=outcome, seconds=resp.seconds,
                             deadline_ms=deadline_ms)
            slo.note_request(ok=(outcome == "ok" and not missed),
                             rung=rung, seconds=resp.seconds)
            return resp

    def note_fault(self, outcome: Any) -> None:
        """Fault-event subscription (``runtime.replan`` orchestration):
        the fabric changed, so per-(template, hw) breaker states and
        search-time estimates keyed to the old digest are stale — reset
        them and count the event.  Subsequent degraded-key requests hit
        rung 3's ``plan_degraded`` routing (and rung 1 once the ladder's
        published pool lands)."""
        metrics.inc("planservice_fault_events_total",
                    cause=getattr(outcome, "cause", "unknown"))
        with self._lock:
            self._breakers.clear()
            self._ewma.clear()

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Join outstanding background completions (tests/benchmarks).
        Real wall-clock, regardless of any injected ``clock``."""
        end = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._bg_threads)
        for th in threads:
            th.join(max(0.0, end - time.monotonic()))
        with self._lock:
            self._bg_threads = [t for t in self._bg_threads if t.is_alive()]
            return not self._bg_threads

    # ------------------------------------------------------------- ladder
    def _ladder(self, request: PlanRequest, key: str, t0: float,
                deadline_ms: float, budget: SearchBudget) -> PlanResponse:
        programs = list(request.programs)
        hw = request.hw
        log: List[str] = []

        def left() -> float:
            if deadline_ms == float("inf"):
                return float("inf")
            return deadline_ms / 1e3 - (self.clock() - t0)

        def respond(result: PlanResult, rung: str, outcome: str = "ok",
                    background: bool = False,
                    target: Optional[HardwareModel] = None) -> PlanResponse:
            return PlanResponse(
                result=result, rung=rung, outcome=outcome,
                hw=target if target is not None else hw,
                seconds=self.clock() - t0, deadline_ms=deadline_ms, key=key,
                log=list(log), background=background)

        with trace.span("planservice.resolve", cat="planservice",
                        deadline_ms=deadline_ms):
            if not programs:
                return self._fallback_response(
                    request, key, t0, deadline_ms, budget,
                    log=["empty program list"], outcome="infeasible")

            # ---- rung 1: exact plancache hit ----------------------------
            if left() > 0:
                hit = self.cache.get_result(
                    programs, hw, budget, profile=request.profile,
                    spatial_reuse=request.spatial_reuse,
                    temporal_reuse=request.temporal_reuse)
                if hit is not None:
                    log.append("rung 1: exact plancache hit")
                    return respond(hit, "cache")

            # ---- rung 2: certified shape-family neighbor ----------------
            regret = (request.regret_bound
                      if request.regret_bound is not None
                      else default_regret())
            template = keying.template_signature(programs[0])
            hwd = keying.hw_digest(hw)
            bkey = f"{template}:{hwd[:16]}"
            if left() > 0:
                from . import family as family_mod
                shape = keying.shape_vector(programs[0])
                for ent in self.cache.store.nearest_k(
                        template, hwd, shape, k=3):
                    if left() <= 0:
                        break
                    res = family_mod.certified_result(
                        ent, programs, hw, regret=regret)
                    if res is not None:
                        log.extend(res.log)
                        bg = self._schedule_background(request, key, budget)
                        return respond(res, "family", background=bg)

            # ---- rung 3: deadline-bounded search ------------------------
            fall_outcome: Optional[str] = None
            if left() > 0:
                if self._no_search:
                    log.append("rung 3 shed: no search slots configured")
                    fall_outcome = "shed"
                else:
                    predicted = self._ewma.get(bkey)
                    if predicted is not None and predicted > left():
                        log.append(f"rung 3 skipped: predicted search "
                                   f"{predicted * 1e3:.1f}ms > "
                                   f"{left() * 1e3:.1f}ms left")
                    else:
                        resp = self._try_search(request, key, budget, bkey,
                                                left, log, respond)
                        if isinstance(resp, PlanResponse):
                            return resp
                        fall_outcome = resp   # None or shed/breaker_open

            # ---- rung 4: guaranteed generic fallback --------------------
            if fall_outcome is None:
                fall_outcome = "deadline" if left() <= 0 else "ok"
            return self._fallback_response(request, key, t0, deadline_ms,
                                           budget, log=log,
                                           outcome=fall_outcome)

    def _try_search(self, request: PlanRequest, key: str,
                    budget: SearchBudget, bkey: str,
                    left: Callable[[], float], log: List[str],
                    respond: Callable[..., PlanResponse]
                    ):
        """Admission gate + breaker + the search itself.  Returns a
        PlanResponse on success, else the fallback outcome tag (or None
        for plain did-not-answer)."""
        breaker = self._breaker(bkey)
        if breaker.state == "open" and not breaker.allow():
            log.append("rung 3 skipped: circuit breaker open")
            return "breaker_open"
        if not self._gate.acquire(blocking=False):
            if breaker.state == "half_open":
                breaker.force_open()         # give the trial slot back
            log.append("rung 3 shed: concurrent search limit reached")
            return "shed"
        result: Optional[PlanResult] = None
        exact = False
        target = request.hw
        t_search = self.clock()
        try:
            result, exact, target = self._do_search(request, budget, left())
        except (RuntimeError, ValueError) as e:
            log.append(f"rung 3 search infeasible: {e}")
        finally:
            self._gate.release()
        dt = self.clock() - t_search
        prev = self._ewma.get(bkey)
        self._ewma[bkey] = dt if prev is None else 0.5 * dt + 0.5 * prev
        missed = left() < 0
        if missed:
            breaker.record_miss()
            metrics.inc("planservice_breaker_miss_total")
        elif result is not None:
            breaker.record_ok()
        if result is None:
            return None
        log.append(f"rung 3: {'full' if exact else 'trimmed'}-budget search "
                   f"best {result.best.final_s * 1e6:.1f}us in "
                   f"{dt * 1e3:.1f}ms")
        bg = (False if exact
              else self._schedule_background(request, key, budget))
        return respond(result, "search",
                       outcome="deadline" if missed else "ok",
                       background=bg, target=target)

    def _do_search(self, request: PlanRequest, budget: SearchBudget,
                   remaining_s: float
                   ) -> Tuple[PlanResult, bool, HardwareModel]:
        """The actual rung-3 search.  Returns (result, exact, target_hw);
        ``exact`` means the full requested budget ran (result published
        under the exact key — no background completion needed)."""
        programs = list(request.programs)
        hw = request.hw
        if hw.is_degraded:
            # route into PR 7's degradation ladder (warmed fault pools,
            # warm-start, bounded search, submesh floor) — it publishes
            # under the degraded key itself
            from repro_torch.runtime.replan import plan_degraded
            out = plan_degraded(
                programs, hw, cache=self.cache, budget=budget,
                latency_budget_s=(None if remaining_s == float("inf")
                                  else max(remaining_s, 1e-3)),
                cause="planservice")
            return out.result, True, out.hw
        trimmed = budget_for_deadline(budget, remaining_s)
        if trimmed == budget:
            res = plan_kernel_multi(
                programs, hw, budget=budget, profile=request.profile,
                spatial_reuse=request.spatial_reuse,
                temporal_reuse=request.temporal_reuse, cache=self.cache)
            return res, True, hw
        # trimmed budget: a different search than the exact key promises,
        # so do NOT publish under it — warm-order manually, search
        # uncached, and let background completion publish the real thing
        ordered = self.cache.order_programs(programs, hw)
        res = plan_kernel_multi(
            ordered, hw, budget=trimmed, profile=request.profile,
            spatial_reuse=request.spatial_reuse,
            temporal_reuse=request.temporal_reuse, cache=None)
        return res, False, hw

    # ------------------------------------------------------------ helpers
    def _breaker(self, bkey: str) -> _Breaker:
        with self._lock:
            br = self._breakers.get(bkey)
            if br is None:
                br = self._breakers[bkey] = _Breaker(
                    self.breaker_threshold, self.breaker_cooldown_s,
                    self.clock, key=bkey)
            return br

    def _fallback_response(self, request: PlanRequest, key: str, t0: float,
                           deadline_ms: float, budget: SearchBudget, *,
                           log: List[str], outcome: str) -> PlanResponse:
        """Rung 4, memoized per key (the fallback construction is cheap
        but not free, and overloaded callers hit it repeatedly)."""
        log = list(log)
        with self._lock:
            memo = self._fallbacks.get(key)
        if memo is None:
            try:
                from .fallback import generic_fallback_plan
                result, target = generic_fallback_plan(
                    list(request.programs), request.hw)
            except Exception as e:  # noqa: BLE001 — never raise
                result, target = None, request.hw
                log.append(f"fallback infeasible: {e}")
            memo = (result, target)
            with self._lock:
                self._fallbacks[key] = memo
        result, target = memo
        if result is None:
            outcome = "infeasible"
        bg = False
        if result is not None and key:
            bg = self._schedule_background(request, key, budget)
        if result is not None:
            log.append("rung 4: generic fallback plan")
        return PlanResponse(result=result, rung="fallback", outcome=outcome,
                            hw=target, seconds=self.clock() - t0,
                            deadline_ms=deadline_ms, key=key, log=log,
                            background=bg)

    def _schedule_background(self, request: PlanRequest, key: str,
                             budget: SearchBudget) -> bool:
        """Off-path full search publishing to the plancache; deduped per
        key so a burst of identical deadline misses starts one search."""
        want = (request.background if request.background is not None
                else background_enabled())
        if not want or self._no_search:
            return False
        with self._lock:
            if key in self._bg_keys:
                return True
            self._bg_keys.add(key)
        programs = list(request.programs)
        hw = request.hw
        rid = context.current()   # threads start with a fresh Context —
        #                           carry the request ID over explicitly

        def run() -> None:
            token = context.attach(rid)
            try:
                with self._gate:
                    if hw.is_degraded:
                        from repro_torch.runtime.replan import plan_degraded
                        plan_degraded(programs, hw, cache=self.cache,
                                      budget=budget, latency_budget_s=None,
                                      cause="planservice_bg")
                    else:
                        plan_kernel_multi(
                            programs, hw, budget=budget,
                            profile=request.profile,
                            spatial_reuse=request.spatial_reuse,
                            temporal_reuse=request.temporal_reuse,
                            cache=self.cache)
                metrics.inc("planservice_background_total",
                            outcome="published")
            except Exception:  # noqa: BLE001 — background must die quietly
                metrics.inc("planservice_background_total", outcome="failed")
            finally:
                with self._lock:
                    self._bg_keys.discard(key)
                context.detach(token)

        th = threading.Thread(target=run, daemon=True,
                              name=f"planservice-bg-{key[:8]}")
        with self._lock:
            self._bg_threads.append(th)
        th.start()
        return True

    def _note(self, resp: Optional[PlanResponse]) -> None:
        if resp is None:
            return
        metrics.inc("planservice_requests_total", rung=resp.rung,
                    outcome=resp.outcome)
        metrics.observe("planservice_resolve_seconds", resp.seconds,
                        rung=resp.rung)
        missed = (resp.deadline_ms != float("inf")
                  and resp.seconds * 1e3 > resp.deadline_ms)
        if missed:
            metrics.inc("planservice_deadline_miss_total", rung=resp.rung)
        flightrec.record("plan_request", rung=resp.rung,
                         outcome=resp.outcome, seconds=resp.seconds,
                         deadline_ms=resp.deadline_ms, key=resp.key,
                         background=resp.background, log=resp.log)
        # SLO view: a request attains its deadline when it answered with
        # a usable plan inside the budget — regardless of which rung
        slo.note_request(ok=(resp.ok and not missed
                             and resp.outcome not in ("error",)),
                         rung=resp.rung, seconds=resp.seconds)
