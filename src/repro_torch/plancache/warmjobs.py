"""Shardable units of the AOT warm sweep (``warm --jobs N``).

Counterpart of ``repro/plancache/warmjobs.py``.  Each job is a
``(kind, payload)`` pair small enough to pickle into a worker process;
:func:`run_job` executes one and returns its log line.  The same function
backs the inline path (``--jobs 1``), so the sharded and sequential sweeps
are one implementation.

Against the reference:

* ``gemm`` and ``flash`` jobs plan the kernels' block tables on one H100
  (``core/lower_torch.py``: :func:`~repro_torch.core.lower_torch.
  plan_gemm_blocks` / ``plan_flash_blocks`` against ``h100_sm()``), at
  bf16, the type whose keys ``kernels.ops.matmul`` and the models'
  attention look up when they serve;
* ``mesh`` jobs rank the sharding plans on the port's default cluster
  (``parallel/planner_bridge.py``);
* the Wormhole benchmark tables the reference reads from the
  ``benchmarks`` package (which imports the reference) are copied here:
  :func:`gemm_shape_table`, :data:`TOPK_SHAPES`, :func:`flash_shape_table`,
  :data:`DEFAULT_BUDGET`, :data:`HW_CONFIGS` and :func:`tl_gemm`.  The
  ``wh_gemm``, ``wh_flash``, ``pipeline`` and ``fault_gemm`` jobs plan on
  the text-copied planner and Wormhole models, so they print the
  reference's lines.

Workers publish directly into the shared on-disk plan store resolved from
the inherited environment (``REPRO_PLAN_CACHE_DIR``): entry writes go
through pid-unique temp files + atomic renames, and each job flushes its
hit/miss counters under the store's advisory lock, so N concurrent jobs
keep the registry and its stats coherent.
"""
from __future__ import annotations

import os
from typing import Any, List, Tuple

from repro_torch.core import SearchBudget

Job = Tuple[str, Any]

# ---------------------------------------------- the benchmark suite's tables
# (copies of benchmarks/common.py, gemm_table.py, topk_table.py and
# flash_table.py, whose modules import the reference)
HW_CONFIGS = ("wormhole_1x8", "wormhole_4x8", "wormhole_8x8")
DEFAULT_BUDGET = SearchBudget(top_k=5, max_plans_per_mapping=48,
                              max_candidates=8000)
TOPK_SHAPES = ((1024, 1024, 4096), (4096, 4096, 4096), (16384, 1024, 4096),
               (4096, 16384, 4096))
FLASH_TOTAL_TOKENS = 8192


def gemm_shape_table(full: bool = False):
    """The Fig-5 (M, N, K) grid."""
    Ms = (256, 1024, 4096, 16384) if full else (1024, 4096, 16384)
    Ks = (1024, 4096) if full else (4096,)
    return tuple((M, N, K) for K in Ks for M in Ms for N in Ms)


def flash_shape_table():
    """(batch*heads, seq, head_dim) cells of the Fig-7 sweep."""
    out = []
    for heads in (64, 128):
        for seq in (512, 1024, 2048, 4096, 8192):
            out.append(((FLASH_TOTAL_TOKENS // seq) * heads, seq, 64))
    return tuple(out)


def tl_gemm(M: int, N: int, K: int, hw, budget=DEFAULT_BUDGET, cache=None,
            **kw):
    """Plan a GEMM with full block-shape exploration, as the benchmark
    sweeps do (``REPRO_FAULTS`` hardware faults apply unless ``hw`` is
    already degraded)."""
    from repro_torch.core import block_shape_candidates, matmul_program, plan_kernel_multi
    if not hw.is_degraded:
        from repro_torch.runtime.faults import apply_env_faults
        hw = apply_env_faults(hw)
    progs = [matmul_program(M, N, K, bm=bm, bn=bn, bk=bk)
             for bm, bn, bk in block_shape_candidates(M, N, K)]
    return plan_kernel_multi(progs, hw, budget=budget, cache=cache, **kw)


# ------------------------------------------------------------------ the jobs
def run_job(job: Job) -> str:
    """Execute one warm job and return its ``[warm] ...`` log line."""
    kind, payload = job
    fn = _KINDS[kind]
    msg = fn(payload)
    from .store import get_store
    get_store().flush_stats()
    return msg


def run_job_isolated(job: Job) -> str:
    """Worker-process entry: like :func:`run_job`, but pins the planner to
    inline search first — the sweep is already parallel at job granularity,
    so nested per-search pools would only oversubscribe."""
    os.environ["REPRO_PLANNER_WORKERS"] = "1"
    return run_job(job)


def _gemm(payload) -> str:
    from repro_torch.core.lower_torch import plan_gemm_blocks
    M, N, K = payload
    blocks = plan_gemm_blocks(M, N, K)
    return f"[warm] gemm {M}x{N}x{K} -> blocks {blocks}"


def _flash(payload) -> str:
    from repro_torch.core.lower_torch import plan_flash_blocks
    Sq, Skv, d = payload
    blocks = plan_flash_blocks(Sq, Skv, d)
    return f"[warm] flash q{Sq} kv{Skv} d{d} -> blocks {blocks}"


def _mesh(payload) -> str:
    arch, shape_name = payload
    # one implementation for every sharded mesh ranking: the same worker
    # entry backs planner_bridge.plan_mesh_many
    from repro_torch.parallel.planner_bridge import _plan_mesh_job
    ranked = _plan_mesh_job((arch, shape_name, {}, False, 3))
    best = ranked[0].plan.name if ranked else "-"
    return f"[warm] mesh {arch}/{shape_name} -> {best}"


def _wormhole_gemm(payload) -> str:
    hw_name, (M, N, K) = payload
    from repro_torch.core import get_hw
    from .cache import PlanCache
    res = tl_gemm(M, N, K, get_hw(hw_name), budget=DEFAULT_BUDGET, cache=PlanCache())
    return f"[warm] {hw_name} gemm {M}x{N}x{K} -> {res.best.plan.describe()}"


def _wormhole_flash(payload) -> str:
    bh, seq, d = payload
    from repro_torch.core import flash_attention_program, get_hw, plan_kernel_multi
    from .cache import PlanCache
    progs = [flash_attention_program(bh, seq, seq, d, bq=bq, bkv=bkv)
             for bq in (32, 64, 128) for bkv in (32, 64, 128)]
    res = plan_kernel_multi(progs, get_hw("wormhole_8x8"),
                            budget=SearchBudget(top_k=5,
                                                max_plans_per_mapping=48),
                            cache=PlanCache())
    return f"[warm] wormhole flash h*b{bh} s{seq} d{d} -> " \
           f"{res.best.plan.describe()}"


def _pipeline(payload) -> str:
    """Warm one kernel-graph co-planning cell (``warm --pipeline SPEC``):
    the graph-level entry plus the per-node kernel entries it resolves
    through."""
    spec, hw_name = payload
    from repro_torch.core import get_hw
    from repro_torch.pipeline import graph_from_spec, plan_pipeline
    from .cache import PlanCache
    g = graph_from_spec(spec)
    gp = plan_pipeline(g, get_hw(hw_name),
                       budget=SearchBudget(top_k=4,
                                           max_plans_per_mapping=48,
                                           max_candidates=8000),
                       cache=PlanCache())
    return (f"[warm] pipeline {spec} on {hw_name} -> "
            f"{gp.total_s * 1e6:.1f}us ({gp.n_forwarded()}/"
            f"{len(gp.decisions)} edges forwarded, "
            f"{gp.improvement:.2f}x vs DRAM handoff)")


def _fault_gemm(payload) -> str:
    """Warm one cell of a single-core-failure plan pool (``warm --faults``):
    run the full degradation ladder for ``hw`` with ``core`` disabled and
    publish the winner under the *degraded* cache key, so a live failure of
    that core re-plans as a pure cache hit.  Budgets and program lists are
    :func:`repro_torch.runtime.replan.plan_degraded`'s, because this calls
    it."""
    hw_name, (M, N, K), core = payload
    from repro_torch.core import block_shape_candidates, get_hw, matmul_program
    from repro_torch.runtime.replan import plan_degraded
    from .cache import PlanCache
    hw = get_hw(hw_name)
    deg = hw.with_faults(disabled_cores=[tuple(core)])
    progs = [matmul_program(M, N, K, bm=bm, bn=bn, bk=bk)
             for bm, bn, bk in block_shape_candidates(M, N, K)]
    out = plan_degraded(progs, deg, healthy_hw=hw, cache=PlanCache(),
                        cause="warm")
    return (f"[warm] faults {hw_name} -core{tuple(core)} gemm {M}x{N}x{K} "
            f"-> {out.rung}, {out.result.best.final_s * 1e6:.1f}us "
            f"on {out.hw.name}")


_KINDS = {
    "gemm": _gemm,
    "flash": _flash,
    "mesh": _mesh,
    "wh_gemm": _wormhole_gemm,
    "wh_flash": _wormhole_flash,
    "pipeline": _pipeline,
    "fault_gemm": _fault_gemm,
}


def run_jobs(jobs: List[Job], n_jobs: int) -> List[str]:
    """Run warm jobs inline (``n_jobs <= 1``) or sharded across the worker
    pool; log lines return in submission order either way."""
    if n_jobs <= 1 or len(jobs) <= 1:
        return [run_job(j) for j in jobs]
    from repro_torch.parallel import search_exec
    return search_exec.map_jobs(run_job_isolated, jobs, n_jobs)
