"""Lowering TileLoom decisions to the port's CUDA kernels (the "back-end" edge).

Counterpart of ``repro/core/lower_jax.py``.  On the paper's stack this is the
hand-off from the dataflow-aware IR to the vendor backend.  Here the planner
runs on a df description of one NVIDIA H100 (:func:`h100_sm`: a streaming
multiprocessor is the core, its shared memory the local scratchpad, HBM the
global memory, the tensor-core tile the ``df.mat`` intrinsic) to choose the
tile shapes of the GEMM and FlashAttention kernels.  The candidates are
exactly the tile shapes the kernels are compiled for, pruned by each
kernel's real shared-memory footprint, so whatever the planner returns can
be launched as it is.

Block choices are memoized at three tiers: ``functools.lru_cache``
(in-process), the plancache memory LRU, and the on-disk plan registry, so a
fresh process resolves repeat shapes without invoking the planner at all.
The hardware digest of the H100 description forks the registry's keys from
every other target's.

:func:`fused_pipeline_spec` and :func:`splitk_pallas_spec` lower the
co-planner's graph plans and the spatial-reduction plans to their CUDA
realization plans, under the reference's names; no kernel realizes a fused
segment yet.
"""
from __future__ import annotations

import functools
import logging
from typing import Dict, Optional, Tuple

import torch

from repro_torch import plancache
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm as _gemm
from repro_torch.obs import metrics
from repro_torch.plancache import warmstart

from .affine import AffineExpr, AffineMap
from .hw import (GB, Core, HardwareModel, Interconnect, MatUnit, Memory, Mux,
                 ScalarUnit, SpatialDim, VecUnit, _ring_map)
from .planner import (SearchBudget, effective_budget, fast_search_enabled,
                      plan_kernel_multi)
from .program import flash_attention_program, matmul_program

log = logging.getLogger(__name__)

# Data-sheet figures of one H100 SXM (NVIDIA's data sheet and the Hopper
# architecture white paper); none of them was measured here.
H100_SMS = 132
H100_SMEM_BYTES = 232448            # 227 KB of shared memory usable by one block
H100_HBM_BYTES = 80 * GB
H100_HBM_GBPS = 3350.0
H100_PEAK_BF16 = 989e12             # dense tensor-core FLOP/s
H100_PEAK_F32 = 67e12               # FLOP/s outside the tensor cores
H100_CUDA_CORES_PER_SM = 128
MMA_TILE = (16, 16, 16)             # the tensor-core tile of the first kernels (wmma)

_CHIP_BUDGET = SearchBudget(top_k=1, max_plans_per_mapping=24,
                            max_mappings=16)
# the tile served when the planner fails, per GEMM body (kernels/gemm.py)
GEMM_FALLBACK = {"tma": (128, 128, 64), "staged": (128, 128, 32)}
FLASH_FALLBACK = (64, 64)

_DTYPE_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2,
                torch.float64: 8}

# Planner failures that served the fallback block shape land in the unified
# metrics registry (``planner_fallbacks_total{template=}``) so deployments
# notice a degraded planner in the same snapshot as every other planner
# signal.  One warning is logged per distinct cause, (template, failure
# message), not per call; the count still rises on every event.
_FALLBACK_WARNED: set = set()


def h100_sm() -> HardwareModel:
    """One H100 at the granularity the kernels are written for: 132 SMs are
    the ``df.core``s, each with its own shared memory as the local
    scratchpad, all under one HBM as the global memory.

    The clock is the one at which 132 SMs x 128 CUDA cores x 2 give the data
    sheet's 67 TFLOP/s of float32; the ``df.mat`` rate is then set so that
    the 132 SMs together peak at the data sheet's 989 TFLOP/s in bf16.  Each
    SM is given an equal share of the HBM rate as its link to global memory.
    There is no SM-to-SM interconnect in this description (thread block
    clusters are not used by the kernels).
    """
    sm = SpatialDim("sm", H100_SMS)
    clock = H100_PEAK_F32 / (H100_SMS * H100_CUDA_CORES_PER_SM * 2) / 1e9
    m, k, n = MMA_TILE
    r = H100_PEAK_BF16 / (H100_SMS * 2 * m * k * n * clock * 1e9)
    tc = MatUnit("TC", MMA_TILE, intrinsics_per_cycle=r)
    fp32 = VecUnit("FP32", width=H100_CUDA_CORES_PER_SM, intrinsics_per_cycle=1.0)
    core = Core("sms", ("sm",), mat=tc, vec=fp32, scalar=ScalarUnit("SC", 1.0))
    smem_gbps = 128.0 * clock       # 128 bytes per cycle per SM
    smem = Memory("smem", ("sm",), size_bytes=H100_SMEM_BYTES,
                  bandwidth_gbps=smem_gbps, level="local")
    mux = Mux("sm_to_smem", "sms", "smem", AffineMap.identity(["sm"]), smem_gbps)
    hbm_idx = SpatialDim("hbm_idx", 1)
    hbm = Memory("hbm", ("hbm_idx",), size_bytes=H100_HBM_BYTES,
                 bandwidth_gbps=H100_HBM_GBPS, level="global")
    to_hbm = Mux("to_hbm", "smem", "hbm", AffineMap((AffineExpr.const_expr(0),)),
                 H100_HBM_GBPS / H100_SMS)
    return HardwareModel(
        name="h100_sm", clock_ghz=clock, spatial_dims=(sm, hbm_idx), core=core,
        local_mem=smem, core_to_local=mux, global_mem=hbm, to_global=to_hbm,
        interconnects=(),
        notes="one H100 SXM, SM granularity, data-sheet figures")


H100_NVLINK_GBPS = 450.0            # NVLink 4: 900 GB/s a card, both directions
H100_IB_GBPS = 50.0                 # one 400 Gb/s InfiniBand NDR port a card
H100_CLUSTER_LINK_GBPS = 25.0       # between clusters: an assumption, no data sheet
H100_HOST_GBPS = 64.0               # PCIe Gen5 x16, one direction
H100_NODE_HOST_BYTES = 2000 * GB    # a DGX H100 node's system memory
H100_CARDS_PER_NODE = 8


def h100_cluster(data: int = 32, model: int = 8, pods: int = 1) -> HardwareModel:
    """H100 SXM cards at mesh granularity, the planner's description of a
    cluster (what ``tpu_v5e_pod`` is to a TPU pod): each card is one
    ``df.core``, its HBM the local memory, the hosts' memory the global
    level, and one interconnect per mesh axis:

    * ``model``: the 8 cards of a node on NVLink 4, 450 GB/s a card each way;
    * ``data``: the nodes, on InfiniBand NDR, 50 GB/s a card each way;
    * ``pod``: a second such cluster, at 25 GB/s a card — an assumption:
      no data sheet fixes the link between two clusters.

    Each card: 80 GB of HBM at 3.35 TB/s and 989 TFLOP/s dense bf16 (the
    H100 SXM data sheet, 700 W); the clock and tile are :func:`h100_sm`'s,
    with the tensor-core rate of all 132 SMs on the one core.  None of these
    figures was measured here."""
    dims, core_dims = [], []
    if pods > 1:
        dims.append(SpatialDim("pod", pods)); core_dims.append("pod")
    dims.append(SpatialDim("data", data)); core_dims.append("data")
    dims.append(SpatialDim("model", model)); core_dims.append("model")
    clock = H100_PEAK_F32 / (H100_SMS * H100_CUDA_CORES_PER_SM * 2) / 1e9
    m, k, n = MMA_TILE
    r = H100_PEAK_BF16 / (2 * m * k * n * clock * 1e9)
    tc = MatUnit("TC", MMA_TILE, intrinsics_per_cycle=r)
    fp32 = VecUnit("FP32", width=H100_SMS * H100_CUDA_CORES_PER_SM, intrinsics_per_cycle=1.0)
    core = Core("cards", tuple(core_dims), mat=tc, vec=fp32, scalar=ScalarUnit("SC", 1.0))
    hbm = Memory("hbm", tuple(core_dims), size_bytes=H100_HBM_BYTES,
                 bandwidth_gbps=H100_HBM_GBPS, level="local")
    mux = Mux("card_to_hbm", "cards", "hbm", AffineMap.identity(list(core_dims)),
              H100_HBM_GBPS)
    cards = data * model * pods
    host_idx = SpatialDim("host_idx", max(1, cards // H100_CARDS_PER_NODE))
    host = Memory("hostmem", ("host_idx",), size_bytes=H100_NODE_HOST_BYTES,
                  bandwidth_gbps=H100_HOST_GBPS, level="global")
    to_host = Mux("to_host", "hbm", "hostmem",
                  AffineMap((AffineExpr.var(core_dims[-1]).with_floordiv(H100_CARDS_PER_NODE),)),
                  H100_HOST_GBPS)
    pairs = [(d.name, d.size) for d in dims]
    rate = {"model": H100_NVLINK_GBPS, "data": H100_IB_GBPS, "pod": H100_CLUSTER_LINK_GBPS}
    ics = tuple(Interconnect(f"link_{axis}", "hbm", "hbm", _ring_map(pairs, axis), rate[axis])
                for axis, size in pairs if size > 1)
    return HardwareModel(
        name=f"h100_{'x'.join(str(s) for _, s in pairs)}", clock_ghz=clock,
        spatial_dims=tuple(dims) + (host_idx,), core=core, local_mem=hbm,
        core_to_local=mux, global_mem=host, to_global=to_host, interconnects=ics,
        notes="H100 SXM cluster at mesh granularity, data-sheet figures")


def dtype_bytes(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    try:
        return _DTYPE_BYTES[dtype]
    except KeyError:
        return torch.empty((), dtype=dtype).element_size()


def _fallback_counter():
    return metrics.counter(
        "planner_fallbacks_total",
        "block-shape requests served the fallback after a planner failure")


def planner_fallback_count(template: str | None = None) -> int:
    """Fallback-block events since process start (or cache clear): a thin
    shim over ``planner_fallbacks_total`` in the metrics registry."""
    c = _fallback_counter()
    if template is not None:
        return int(c.value(template=template))
    return int(c.total())


def _note_fallback(template: str, shape, err, fallback) -> None:
    _fallback_counter().inc(template=template)
    cause = (template, str(err))
    if cause not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(cause)
        log.warning("planner fallback for %s shape=%s: %s "
                    "(serving fallback blocks %s)", template, shape, err,
                    fallback)


def gemm_tile_options(dbytes: int, body: str | None = None
                      ) -> Tuple[Tuple[int, int, int], ...]:
    """The compiled tiles of one GEMM body whose shared memory fits one block
    of it: by default the TMA body's for 2-byte elements and the staged
    body's for 4-byte ones, each against its own limit."""
    body = body or ("tma" if dbytes == 2 else "staged")
    return tuple(t for t in _gemm.body_tiles(body)
                 if _gemm.gemm_smem_bytes(*t, dbytes) <= _gemm.smem_limit(t))


def flash_tile_options(d: int, dbytes: int) -> Tuple[Tuple[int, int], ...]:
    """The FlashAttention kernel's compiled tiles whose shared memory fits
    one block for this head dimension and element size."""
    if d not in _fa.COMPILED_HEAD_DIMS or dbytes not in (2, 4):
        return ()
    return _fa.legal_tiles(d, dbytes)


@functools.lru_cache(maxsize=1)
def _chip():
    """The H100 df model and its content digest."""
    hw = h100_sm()
    return hw, plancache.hw_digest(hw)


def _cached_blocks(template: str, params: dict, shape: Tuple[int, ...],
                   progs, fallback: Tuple[int, ...], pick,
                   tiles: list) -> Tuple[int, ...]:
    """Shared request-level cache path for the block-shape tables.

    On a key hit the stored block tuple is returned without touching the
    planner.  On a miss the search is warm-started from the nearest cached
    shape of the same template, then the winning blocks are persisted.
    ``tiles`` (each candidate tile with its shared-memory footprint) is part
    of the key, so a choice made for another build of the kernel is never
    served.
    """
    hw, hw_dig = _chip()
    request = (template, tuple(params.values()))
    budget = chip_budget()
    store = plancache.get_store()
    key = plancache.request_key(template, params, hw, budget, extra={"tiles": tiles})
    ent = store.get(key)
    if ent is not None:
        try:
            blocks = tuple(int(b) for b in ent["payload"]["blocks"])
            _RESOLVED[request] = (blocks, "cache")
            return blocks
        except (KeyError, TypeError, ValueError):
            pass                     # malformed entry: fall through and re-plan
    if not progs:
        _note_fallback(template, shape,
                       RuntimeError("no compiled tile fits this request"), fallback)
        _RESOLVED[request] = (fallback, "fallback")
        return fallback
    # warm-start ordering; plan_kernel_multi itself applies the
    # budget.max_programs trim to the reordered list
    progs = warmstart.warm_order_from_store(store, template, hw_dig, shape,
                                            progs)
    try:
        res = plan_kernel_multi(progs, hw, budget=budget, profile=False)
    except RuntimeError as e:
        # infeasible space: serve the safe fallback, but never silently:
        # count it and say which request
        _note_fallback(template, shape, e, fallback)
        _RESOLVED[request] = (fallback, "fallback")
        return fallback
    blocks = pick(res)
    best_prog = res.best.plan.program
    # only the block tuple + the warm-start tile hint are persisted: the
    # hit path reads payload["blocks"] and nothing re-reads the full
    # PlanResult at this request-level tier
    store.put(key, {"blocks": list(blocks)},
              meta={"template": template, "shape": list(shape),
                    "hw": hw_dig, "hw_name": hw.name,
                    "blocks": list(blocks),
                    "tiles": warmstart.tile_signature(best_prog),
                    "search": {"plan_seconds": res.plan_seconds,
                               "n_candidates": res.n_candidates,
                               "n_estimated": res.n_estimated,
                               "n_pruned": res.n_pruned,
                               "n_mappings_pruned": res.n_mappings_pruned,
                               "n_infeasible_programs":
                                   res.n_infeasible_programs}})
    _RESOLVED[request] = (blocks, "search")
    return blocks


# What each request that went past the in-process memo resolved to, and
# how: "search", "cache" (the plan registry), "only" (a single tile compiles
# and fits) or "fallback".  A request is
# (template, (shape..., element bytes)).  The serve launcher prints it.
_RESOLVED: dict = {}


def resolved_blocks() -> dict:
    """``{(template, (shape..., element bytes)): (blocks, source)}`` for every
    request this process resolved since the last :func:`clear_block_caches`."""
    return dict(_RESOLVED)


def plan_gemm_blocks(M: int, N: int, K: int, dtype=torch.bfloat16
                     ) -> Tuple[int, int, int]:
    """Choose (bm, bn, bk) for the GEMM kernel on one H100.

    Builds one tile program per compiled tile shape that fits shared memory
    and lets the TileLoom planner rank them on the H100 df model.  The
    tiles are those of the body the request will take with aligned operands
    (``kernels.gemm.shape_body``).  Falls back to that body's
    :data:`GEMM_FALLBACK` tile when the planner finds nothing feasible.
    """
    # the in-process memo must key on the fast-search env too (the disk key
    # covers it via the effective budget; an env flip mid-process would
    # otherwise serve blocks computed under the other budget)
    return _gemm_blocks_memo(M, N, K, dtype, fast_search_enabled())


def chip_budget() -> SearchBudget:
    """The search budget the block tables plan with (``REPRO_FAST_SEARCH``
    shrinks it)."""
    return effective_budget(_CHIP_BUDGET)


def gemm_programs(M: int, N: int, K: int, dtype=torch.bfloat16) -> list:
    """The tile programs :func:`plan_gemm_blocks` ranks: one per compiled
    tile of the body the request takes that fits its shared memory."""
    dbytes = dtype_bytes(dtype)
    return [matmul_program(max(M, bm), max(N, bn), max(K, bk),
                           bm=bm, bn=bn, bk=bk, dtype_bytes=dbytes)
            for bm, bn, bk in gemm_tile_options(dbytes, _gemm.shape_body(dtype, K, N))]


def flash_programs(Sq: int, Skv: int, d: int, dtype=torch.bfloat16) -> list:
    """The tile programs :func:`plan_flash_blocks` ranks."""
    dbytes = dtype_bytes(dtype)
    return [flash_attention_program(8, max(Sq, bq), max(Skv, bkv), d,
                                    bq=bq, bkv=bkv, dtype_bytes=dbytes)
            for bq, bkv in flash_tile_options(d, dbytes)]


def gemm_blocks_of(res) -> Tuple[int, int, int]:
    """(bm, bn, bk) of the best plan of a GEMM search."""
    loads = {c.access.tensor.name: c for c in res.best.plan.loads}
    bm, bk = loads["A"].access.tile_shape
    _, bn = loads["B"].access.tile_shape
    return (bm, bn, bk)


def flash_blocks_of(res) -> Tuple[int, int]:
    """(block_q, block_kv) of the best plan of a FlashAttention search."""
    loads = {c.access.tensor.name: c for c in res.best.plan.loads}
    return (loads["Q"].access.tile_shape[1], loads["K"].access.tile_shape[1])


@functools.lru_cache(maxsize=512)
def _gemm_blocks_memo(M: int, N: int, K: int, dtype, _fast: bool
                      ) -> Tuple[int, int, int]:
    dbytes = dtype_bytes(dtype)
    body = _gemm.shape_body(dtype, K, N)
    options = gemm_tile_options(dbytes, body)
    return _cached_blocks("gemm_blocks",
                          {"M": M, "N": N, "K": K, "dbytes": dbytes},
                          (M, N, K), gemm_programs(M, N, K, dtype), GEMM_FALLBACK[body],
                          gemm_blocks_of,
                          [[*t, _gemm.gemm_smem_bytes(*t, dbytes)] for t in options])


def plan_flash_blocks(Sq: int, Skv: int, d: int, dtype=torch.bfloat16
                      ) -> Tuple[int, int]:
    """Choose (block_q, block_kv) for the FlashAttention kernel.  A query
    offset (context-parallel attention: Sq a rank's block, Skv the prefix
    it sees) changes no tile's footprint, only which tiles are visible, so
    the plan is that of (Sq, Skv) and the offset adds no candidate."""
    return _flash_blocks_memo(Sq, Skv, d, dtype, fast_search_enabled())


@functools.lru_cache(maxsize=512)
def _flash_blocks_memo(Sq: int, Skv: int, d: int, dtype, _fast: bool
                       ) -> Tuple[int, int]:
    dbytes = dtype_bytes(dtype)
    options = flash_tile_options(d, dbytes)
    if len(options) == 1:
        # one compiled tile fits (float32 at d 256): nothing to rank, and the
        # tile program's model, which double-buffers every load, must not
        # veto the tile the kernel runs
        _RESOLVED[("flash_blocks", (Sq, Skv, d, dbytes))] = (options[0], "only")
        return options[0]
    return _cached_blocks("flash_blocks",
                          {"Sq": Sq, "Skv": Skv, "d": d, "dbytes": dbytes},
                          (Sq, Skv, d), flash_programs(Sq, Skv, d, dtype), FLASH_FALLBACK,
                          flash_blocks_of,
                          [[*t, _fa.flash_smem_bytes(*t, d, dbytes)] for t in options])


def clear_block_caches() -> None:
    """Drop the in-process memo tiers (tests use this to emulate a fresh
    process against a warm disk cache)."""
    _gemm_blocks_memo.cache_clear()
    _flash_blocks_memo.cache_clear()
    _fallback_counter().clear()
    _FALLBACK_WARNED.clear()
    _RESOLVED.clear()


def reset_planner_fallbacks() -> None:
    """Re-arm the degraded-planner signal in a long-lived (serve) process.

    Clears the fallback counters together with *every* in-process block-memo
    tier (the ``lru_cache`` tables and the plancache memory LRU) so the next
    repeat shape re-resolves through the disk registry (or a fresh search)
    instead of a memo populated while the planner was failing.
    """
    clear_block_caches()
    plancache.get_store().clear_memory()


def fused_pipeline_spec(graph_plan) -> Dict[str, object]:
    """Lower a co-planned kernel graph (:class:`repro_torch.pipeline.GraphPlan`)
    to its CUDA realization plan.

    Consecutive nodes joined by *forwarded* edges collapse into one
    **fused segment, one kernel launch**: the chain's kernels run as phases
    of a single launch whose blocks compute the producer's tile and then
    the consumer's, and each forwarded intermediate stays in the block's
    shared memory instead of being written to HBM; the consumer phase reads
    the shared-memory tile the producer phase wrote (the on-chip residency
    the mesh plan prices).  A *spilled* edge is a segment boundary: the
    intermediate is written to HBM as an ordinary output and the next
    segment is a separate launch.

    Returns::

        {"segments": [{"nodes": [...],          # fused chain, in order
                       "scratch": [tensor...],  # intermediates kept on-chip
                       "shuffle": {tensor: axes}},  # re-shuffle legs
                      ...],
         "materialized": [tensor...]}           # spilled intermediates
    """
    order = list(graph_plan.nodes)
    fwd_edges = {(d.src, d.dst): d for d in graph_plan.decisions
                 if d.forwarded}
    segments: list = []
    current = {"nodes": [order[0]], "scratch": [], "shuffle": {}}
    for prev, node in zip(order, order[1:]):
        d = fwd_edges.get((prev, node))
        if d is not None:
            current["nodes"].append(node)
            current["scratch"].append(d.tensor)
            if d.shuffle_axes:
                current["shuffle"][d.tensor] = list(d.shuffle_axes)
        else:
            segments.append(current)
            current = {"nodes": [node], "scratch": [], "shuffle": {}}
    segments.append(current)
    # forwarded skip-edges (src and dst non-adjacent but fused into the same
    # segment by the chain in between) keep their intermediate on-chip too
    for d in graph_plan.decisions:
        if not d.forwarded:
            continue
        for seg in segments:
            if d.src in seg["nodes"] and d.dst in seg["nodes"] \
                    and d.tensor not in seg["scratch"]:
                seg["scratch"].append(d.tensor)
                if d.shuffle_axes:
                    seg["shuffle"][d.tensor] = list(d.shuffle_axes)
    # a forwarded edge whose endpoints land in *different* segments (its
    # chain was cut by a spilled edge in between) cannot stay in shared
    # memory across launches: it is written to HBM like a spill
    in_scratch = {t for seg in segments for t in seg["scratch"]}
    return {
        "segments": segments,
        "materialized": [d.tensor for d in graph_plan.decisions
                         if not d.forwarded or d.tensor not in in_scratch],
    }


def splitk_pallas_spec(plan) -> Optional[Dict[str, object]]:
    """Lower a spatial-reduction plan to its CUDA realization.

    A ``reduce=True`` bind splits the reduction into ``n_split`` parts of
    ``steps_per_split`` steps each:

    * ``accum``: every split revisits the same output tile and accumulates
      into it in place;
    * ``tree``/``chain``: every split writes its own partials and the
      partials are combined after the kernel (a sum, or a log-sum-exp for
      attention statistics), as K3's ``flash_decode_partials`` and
      ``combine_partials`` do over its splits.

    The name is the reference's, so that both packages are called alike.
    Returns ``None`` for plans without reduce binds.
    """
    m = plan.mapping
    binds = m.reduce_binds()
    if not binds:
        return None
    b = binds[0]
    n_split = m.active_reduce_factor()
    return {
        "grid_dim": b.grid_dim,
        "n_split": int(n_split),
        "steps_per_split": int(m.seq_extent(b.grid_dim)),
        "style": m.reduce_style,
        "revisit_output": m.reduce_style == "accum",
        "combine": "add" if m.reduce_style == "accum" else "partials",
    }
