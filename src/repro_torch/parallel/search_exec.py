"""Process-parallel search executor: shard a planner search across cores.

``plan_kernel_multi``'s candidate space is a pooled stream over independent
programs (one per block shape), so the program list shards cleanly: each
worker ranks a contiguous chunk with the normal branch-and-bound engine
and returns its top-k serialized through the plancache serializers, each
candidate carrying its canonical (program, mapping, combo) stream index.
The parent merges by ``(model cost, canonical index)`` — exactly the key
the sequential heap sorts by — so the selected top-k and every tie-break
are bit-identical to the inline search regardless of worker count (the
per-candidate costs themselves are deterministic: both cost engines
produce the same floats in any process).  Only the search-efficiency
counters (``n_pruned``/``n_estimated``/...) depend on sharding, because
each shard's incumbent threshold converges independently.

The pool is cached module-wide so repeated planning calls amortize worker
start-up, and workers start via ``fork`` where available (see
``_mp_context`` — overridable with ``REPRO_PLANNER_MP``).
``REPRO_PLANNER_WORKERS`` sets the default worker count (unset =
``os.cpu_count()``; ``0``/``1`` = inline); worker processes pin it to 1
so nested searches never oversubscribe.

:func:`map_jobs` is the generic job-level variant used by the AOT warm
sweep (``python -m repro_torch.plancache warm --jobs N``) and
``planner_bridge.plan_mesh_many``: results return in submission order and
each worker publishes into the shared on-disk plan store (pid-unique
temp-file renames + the advisory stats lock keep that coherent).
"""
from __future__ import annotations

import atexit
import dataclasses
import multiprocessing
import os
import pickle
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import context, flightrec, metrics, trace

WORKERS_ENV = "REPRO_PLANNER_WORKERS"
MP_CONTEXT_ENV = "REPRO_PLANNER_MP"      # fork | spawn | forkserver

# Deterministic worker-crash injection (repro_torch.runtime.faults arms this):
# the env var names a marker file; the first worker task to claim it
# removes the file and hard-exits, breaking the pool exactly once.
CRASH_ENV = "REPRO_FAULT_WORKER_CRASH"

# Pool-failure policy: a BrokenProcessPool (worker OOM-killed, crashed, or
# torn down by a signal) is retried on a fresh pool with exponential
# backoff; pickling errors are permanent and fail fast.  Callers fall back
# to the inline search when retries are exhausted, so a dying pool degrades
# throughput but never the result.
_POOL_RETRIES = 2
_POOL_BACKOFF_S = 0.05


def _maybe_crash_worker() -> None:
    """One-shot injected crash (see :data:`CRASH_ENV`).  Claiming the
    marker file is atomic (``os.remove`` succeeds in exactly one process),
    so a schedule arms exactly one crash no matter how many workers race."""
    marker = os.environ.get(CRASH_ENV, "").strip()
    if not marker:
        return
    try:
        os.remove(marker)
    except OSError:
        return                           # already claimed (or never armed)
    os._exit(17)


def _mp_context():
    """Worker start method.  ``fork`` where available and safe: no
    interpreter restart and no re-execution of the caller's ``__main__``
    (spawn runs the parent's main module in every worker, which breaks
    stdin scripts and console-script entry points).  Fork is avoided once
    JAX is loaded in the parent — its runtime is multithreaded and
    fork-hostile — which a pure planning process (benchmarks, the AOT
    warm driver) never triggers.  ``REPRO_PLANNER_MP`` overrides."""
    name = os.environ.get(MP_CONTEXT_ENV, "").strip().lower()
    if not name:
        import sys
        forkable = "fork" in multiprocessing.get_all_start_methods()
        name = "fork" if forkable and "jax" not in sys.modules else "spawn"
    return multiprocessing.get_context(name)


def resolve_workers(workers: Optional[int] = None) -> int:
    """The effective worker count: the caller's explicit value, else
    ``REPRO_PLANNER_WORKERS``, else ``os.cpu_count()``.  Values <= 1 (and
    unparsable env text) mean inline."""
    if workers is None:
        raw = os.environ.get(WORKERS_ENV, "").strip()
        if raw:
            try:
                workers = int(raw)
            except ValueError:
                workers = 1
        else:
            workers = os.cpu_count() or 1
    return workers if workers > 1 else 1


# ------------------------------------------------------------------ pool
_POOL: Optional[ProcessPoolExecutor] = None
_POOL_WORKERS = 0


def _get_pool(workers: int) -> ProcessPoolExecutor:
    """Module-wide spawn pool, grown (never shrunk) to ``workers``."""
    global _POOL, _POOL_WORKERS
    if _POOL is not None and _POOL_WORKERS >= workers:
        return _POOL
    if _POOL is not None:
        _POOL.shutdown(wait=False, cancel_futures=True)
    _POOL = ProcessPoolExecutor(max_workers=workers, mp_context=_mp_context())
    _POOL_WORKERS = workers
    return _POOL


def shutdown_pool() -> None:
    global _POOL, _POOL_WORKERS
    if _POOL is not None:
        _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = None
        _POOL_WORKERS = 0


atexit.register(shutdown_pool)


def _run_pool_tasks(fn: Callable[[Any], Any], tasks: Sequence[Any],
                    workers: int, *, label: str) -> Optional[List[Any]]:
    """Submit one task per ``fn(task)`` call and collect results in
    submission order, surviving crashed workers: a broken pool is torn
    down and the whole batch retried on a fresh pool (bounded, with
    exponential backoff).  Returns None when the pool is truly unusable —
    pickling failure, or retries exhausted — and the caller runs inline.
    Tasks must therefore be idempotent (every current caller's are: pure
    ranking, or content-addressed store publishes)."""
    delay = _POOL_BACKOFF_S
    for attempt in range(_POOL_RETRIES + 1):
        try:
            pool = _get_pool(workers)
            futs = [pool.submit(fn, t) for t in tasks]
            return [f.result() for f in futs]
        except (OSError, pickle.PicklingError, BrokenProcessPool) as e:
            shutdown_pool()              # a broken pool never recovers
            metrics.inc("search_pool_failures_total",
                        kind=type(e).__name__, where=label)
            flightrec.record("pool_failure", error=type(e).__name__,
                             where=label, attempt=attempt,
                             will_retry=(not isinstance(
                                 e, pickle.PicklingError)
                                 and attempt < _POOL_RETRIES))
            if isinstance(e, pickle.PicklingError) \
                    or attempt == _POOL_RETRIES:
                return None
            time.sleep(delay)
            delay *= 2
    return None


# ------------------------------------------------------------ hw transport
def hw_spec(hw) -> Optional[Tuple[str, Any]]:
    """A cross-process handle for a HardwareModel: preset name when the
    model is a registered preset (Wormhole's composite channel map is a
    local class and cannot pickle), a ``preset_faults`` triple when the
    model is a preset plus a fault overlay (degraded fabrics inherit the
    unpicklable channel map), else pickled bytes, else None (caller must
    run inline)."""
    from repro_torch.core.hw import PRESETS
    if hw.name in PRESETS:
        try:
            if PRESETS[hw.name]().df_text() == hw.df_text():
                return ("preset", hw.name)
            if hw.is_degraded:
                rebuilt = PRESETS[hw.name]().with_faults(
                    hw.disabled_cores, hw.degraded_links)
                if rebuilt.df_text() == hw.df_text():
                    return ("preset_faults",
                            (hw.name, hw.disabled_cores, hw.degraded_links))
        except Exception:
            pass
    try:
        return ("pickle", pickle.dumps(hw))
    except Exception:
        return None


def hw_from_spec(spec: Tuple[str, Any]):
    kind, val = spec
    if kind == "preset":
        from repro_torch.core.hw import get_hw
        return get_hw(val)
    if kind == "preset_faults":
        from repro_torch.core.hw import get_hw
        name, disabled, links = val
        return get_hw(name).with_faults(disabled, links)
    return pickle.loads(val)


# --------------------------------------------------------------- sharding
def _chunk_bounds(n: int, chunks: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal [start, stop) chunks covering range(n)."""
    base, extra = divmod(n, chunks)
    bounds = []
    start = 0
    for i in range(chunks):
        stop = start + base + (1 if i < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def _worker_rank(task: Dict[str, Any]) -> Dict[str, Any]:
    """Rank one program chunk (runs in a worker process).  Returns the
    chunk's top-k as serialized candidates with *global* canonical indices
    plus the chunk's search counters — and, when the parent is tracing,
    the worker's buffered spans (the parent ingests them so the exported
    trace shows every worker process; workers never write trace files
    themselves, which would clobber the parent's ``REPRO_TRACE`` path)."""
    os.environ[WORKERS_ENV] = "1"        # no nested pools
    _maybe_crash_worker()
    # adopt the parent's correlation ID (shipped with the job, like the
    # trace flag) so worker spans land on the request's timeline; attach
    # overwrites, so a reused worker never keeps a previous task's ID
    context.attach(task.get("rid"))
    from repro_torch.core import planner
    from repro_torch.plancache import serialize
    tracing = bool(task.get("trace"))
    # a forked worker inherits the parent's span buffer — clear it so the
    # drain below returns only this task's spans (no duplicates)
    trace.clear()
    if tracing:
        trace.enable()
    else:
        trace.disable()
    t0 = time.perf_counter()
    programs = [serialize.program_from_dict(d) for d in task["programs"]]
    hw = hw_from_spec(task["hw"])
    budget = planner.SearchBudget(**task["budget"])
    stats = planner._SearchStats()
    with trace.span("planner.worker_rank", cat="worker",
                    n_programs=len(programs), p_base=task["p_base"]):
        topk = planner._rank_streamed(
            programs, hw, budget, spatial_reuse=task["spatial_reuse"],
            temporal_reuse=task["temporal_reuse"],
            use_bound=task["use_bound"],
            catch_infeasible=task["catch_infeasible"], stats=stats,
            engine=task["engine"])
    out = []
    p_base = task["p_base"]
    for c in topk:
        d = serialize.candidate_to_dict(c)
        p, m, ci = c.index
        d["index"] = [p + p_base, m, ci]
        out.append(d)
    return {"topk": out, "stats": dataclasses.asdict(stats),
            "wall_s": time.perf_counter() - t0,
            "spans": trace.drain() if tracing else []}


def rank_sharded(programs: Sequence, hw, budget, *, spatial_reuse: bool,
                 temporal_reuse: bool, use_bound: bool,
                 catch_infeasible: bool, engine: Optional[str],
                 stats, workers: int) -> Optional[List]:
    """Shard ``_rank_streamed`` over ``workers`` processes and merge.

    Returns the merged top-k Candidate list, or None when sharding is
    unavailable (unpicklable hardware model, pool failure) — the caller
    then runs inline.  ``stats`` is only mutated on success.  Planner bugs
    raised inside a worker (anything ``_rank_streamed`` would propagate
    inline, e.g. TypeError from a malformed program) re-raise here.
    """
    from repro_torch.core import planner
    from repro_torch.plancache import serialize
    spec = hw_spec(hw)
    if spec is None:
        return None
    n = len(programs)
    workers = min(workers, n)
    # resolve the engine here: workers must not re-read REPRO_COST_ENGINE
    # from the (potentially stale) environment they were started with
    engine = planner.resolve_engine(engine)
    wbudget = dataclasses.asdict(dataclasses.replace(budget, workers=1))
    tasks = []
    for start, stop in _chunk_bounds(n, workers):
        tasks.append({
            "programs": [serialize.program_to_dict(p)
                         for p in programs[start:stop]],
            "p_base": start,
            "hw": spec,
            "budget": wbudget,
            "spatial_reuse": spatial_reuse,
            "temporal_reuse": temporal_reuse,
            "use_bound": use_bound,
            "catch_infeasible": catch_infeasible,
            "engine": engine,
            "trace": trace.enabled(),
            "rid": context.current(),
        })
    results = _run_pool_tasks(_worker_rank, tasks, workers,
                              label="rank_sharded")
    if results is None:
        return None
    entries = []
    for res in results:                  # chunk order == program order
        w = res["stats"]
        stats.n_candidates += w["n_candidates"]
        stats.n_mappings += w["n_mappings"]
        stats.n_pruned += w["n_pruned"]
        stats.n_estimated += w["n_estimated"]
        stats.n_mappings_pruned += w["n_mappings_pruned"]
        stats.n_infeasible_programs += w["n_infeasible_programs"]
        stats.merge_phases(w.get("phases"))
        if w["first_failure"] and not stats.first_failure:
            stats.first_failure = w["first_failure"]
        metrics.observe("planner_shard_seconds", res.get("wall_s", 0.0))
        trace.ingest(res.get("spans"))
        for d in res["topk"]:
            c = serialize.candidate_from_dict(d)
            entries.append(((c.cost.total_s,) + tuple(c.index), c))
    entries.sort(key=lambda e: e[0])     # (cost, p, m, c): the heap's order
    return [c for _, c in entries[:budget.top_k]]


# ------------------------------------------------------- node-level pools
def _plan_node_pool_job(task: Dict[str, Any]) -> Dict[str, Any]:
    """Build one pipeline node's candidate pool (per-block-shape B&B +
    profiling, ``repro_torch.pipeline.planner.node_candidate_pool``) in a worker
    process; returns the serialized candidates in pool order (plus the
    worker's buffered spans when the parent is tracing)."""
    os.environ[WORKERS_ENV] = "1"        # no nested pools
    _maybe_crash_worker()
    context.attach(task.get("rid"))      # see _worker_rank
    from repro_torch.core import planner
    from repro_torch.pipeline.planner import node_candidate_pool
    from repro_torch.plancache import serialize
    tracing = bool(task.get("trace"))
    trace.clear()                        # drop any fork-inherited buffer
    if tracing:
        trace.enable()
    else:
        trace.disable()
    t0 = time.perf_counter()
    programs = [serialize.program_from_dict(d) for d in task["programs"]]
    hw = hw_from_spec(task["hw"])
    budget = planner.SearchBudget(**task["budget"])
    with trace.span("pipeline.worker_node_pool", cat="worker",
                    n_programs=len(programs)):
        pool = node_candidate_pool(programs, hw, budget,
                                   engine=task["engine"])
    return {"pool": [serialize.candidate_to_dict(c) for c in pool],
            "wall_s": time.perf_counter() - t0,
            "spans": trace.drain() if tracing else []}


def plan_node_pools(program_lists: Sequence[Sequence], hw, budget, *,
                    engine: Optional[str], workers: int) -> Optional[List]:
    """Shard the per-node candidate-pool searches of a pipeline graph
    across the worker pool — one job per node (each node's search is itself
    the normal inline two-step selection, so pools are bit-identical to the
    sequential per-node loop).  Returns per-node Candidate lists in node
    order, or None when sharding is unavailable (caller runs inline)."""
    from repro_torch.core import planner
    from repro_torch.plancache import serialize
    spec = hw_spec(hw)
    if spec is None:
        return None
    engine = planner.resolve_engine(engine)
    wbudget = dataclasses.asdict(dataclasses.replace(budget, workers=1))
    tasks = [{
        "programs": [serialize.program_to_dict(p) for p in progs],
        "hw": spec,
        "budget": wbudget,
        "engine": engine,
        "trace": trace.enabled(),
        "rid": context.current(),
    } for progs in program_lists]
    results = _run_pool_tasks(_plan_node_pool_job, tasks,
                              min(workers, len(tasks)),
                              label="plan_node_pools")
    if results is None:
        return None
    pools = []
    for res in results:
        metrics.observe("planner_shard_seconds", res.get("wall_s", 0.0))
        trace.ingest(res.get("spans"))
        pools.append([serialize.candidate_from_dict(d)
                      for d in res["pool"]])
    return pools


# ---------------------------------------------------------------- map_jobs
def _repro_env() -> Dict[str, Optional[str]]:
    """Snapshot of the planner/registry env contract.  The pool is
    persistent, so workers hold whatever environment existed at their
    start — a parent that redirects ``REPRO_PLAN_CACHE_DIR`` or toggles
    ``REPRO_FAST_SEARCH`` afterwards must ship the current values with
    each job or the workers plan against stale settings."""
    keys = ("REPRO_PLAN_CACHE_DIR", "REPRO_PLAN_CACHE", "REPRO_FAST_SEARCH",
            "REPRO_COST_ENGINE")
    return {k: os.environ.get(k) for k in keys}


def _run_with_env(task: Tuple[Dict[str, Optional[str]],
                              Callable[[Any], Any], Any, Optional[str]]
                  ) -> Any:
    env, fn, job, rid = task
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    _maybe_crash_worker()
    context.attach(rid)                  # see _worker_rank
    return fn(job)


def map_jobs(fn: Callable[[Any], Any], jobs: Sequence[Any],
             workers: int) -> List[Any]:
    """Run ``fn(job)`` for every job, sharded across worker processes
    (``fn`` must be a module-level importable function).  Each job carries
    the parent's current ``REPRO_*`` environment (see :func:`_repro_env`),
    and results arrive in submission order, so output is deterministic
    regardless of completion order.  ``workers <= 1`` (or a single job)
    runs inline.

    Jobs must be idempotent: a crashed worker breaks the whole pool, and
    the batch is retried on a fresh pool (:func:`_run_pool_tasks`) — with
    the entire batch run inline as the last resort — so partially
    completed side effects (content-addressed store puts) repeat."""
    jobs = list(jobs)
    workers = min(workers, len(jobs))
    if workers <= 1:
        return [fn(j) for j in jobs]
    env = _repro_env()
    rid = context.current()
    results = _run_pool_tasks(_run_with_env,
                              [(env, fn, j, rid) for j in jobs],
                              workers, label="map_jobs")
    if results is None:                  # pool unusable: degrade, don't die
        return [fn(j) for j in jobs]
    return results
