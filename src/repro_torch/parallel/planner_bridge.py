"""TileLoom mesh planning: choose the sharding layout like the paper chooses
dataflows.

Counterpart of ``repro/parallel/planner_bridge.py``, retargeted: the cluster
is data that :func:`estimate_plan` and :func:`plan_mesh` take (``hw=``, by
default ``core.lower_torch.h100_cluster``) instead of the TPU constants, so
the same code ranks an H100 cluster or, given ``core.hw.tpu_v5e_pod``, the
reference's pod, exactly as the reference ranks it.  The peak, the HBM rate
and capacity, the per-axis link rates and the mesh sizes are read from the
description; the plan registry's key takes its name and digest, so a TPU
ranking is never served for the H100.

The cluster is described in the same df dialect; a
candidate :class:`ShardingPlan` corresponds 1:1 to a TileLoom spatiotemporal
mapping + memory-op choice of the model's dominant tile program:

==============================  ==============================================
ShardingPlan                    TileLoom plan on C[tokens,ffn]=X[tokens,d]W[d,ffn]
==============================  ==============================================
megatron_tp                     tokens->data, ffn->model; X broadcast along
                                'model' (the TP all-gather); W broadcast along
                                'data' hoisted to level 0 (weights resident)
pure_dp                         tokens->(data,model) flattened; W broadcast to
                                the whole array hoisted to level 0 (replicated)
zero3 (fsdp)                    tokens->(data,model); W broadcast *inside* the
                                layer loop (per-use weight gather = ZeRO-3)
sequence_parallel               seq->model (ring dataflow); per-chip full W
expert_parallel                 experts->model; token tiles all-to-all (the a2a
                                is the EP analogue of the paper's broadcasts)
==============================  ==============================================

Two-step selection, exactly as the paper: (1) the analytic model below ranks
candidates — compute / HBM / per-axis ICI terms with the paper's contention
rule (demand over df-declared link bandwidth) and capacity pruning (candidate
whose per-chip params+optimizer+activations exceed HBM is discarded);
(2) the surviving top-k are validated on hardware: the reference compiles
them in its dry-run (``launch/dryrun.py``, not ported yet); on the card,
``chip_smoke.py``'s ``mesh_train`` phase reads the estimate against a
measured peak.

``tileloom_view()`` renders the chosen plan back as the corresponding df tile
program mapping for the reports.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch import plancache
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.hw import HardwareModel
from repro_torch.core.lower_torch import dtype_bytes, h100_cluster
from repro_torch.models.api import ModelAPI, build_model
from .sharding import (ShardingPlan, expert_parallel_plan, megatron_tp_plan,
                       pure_dp_plan, sequence_parallel_plan)


def is_train_or_prefill(shape: ShapeConfig) -> bool:
    return shape.kind in ("train", "prefill")


# small helper since ShardingPlan is frozen
def _rename(plan: ShardingPlan, name: str) -> ShardingPlan:
    return ShardingPlan(name=name, rules=plan.rules,
                        description=plan.description)


def _tp2d() -> ShardingPlan:
    """2D tensor parallelism for 100B+ models: activations' embed dim sharded
    over 'data' (contraction-parallel partial matmuls + all-reduce), sequence
    over 'model'.  No weight gather at all — the only layout where the
    405B-class weights never move (XLA hoists ZeRO-3's per-layer gather to a
    whole-stack gather, 50 GB/device; measured in the dry-run)."""
    return ShardingPlan(
        name="tp2d",
        rules=(
            ("batch", ("pod",)),
            ("seq", "model"),
            ("kv_seq", "model"),
            ("embed", "data"),
            ("ffn", "model"),
            ("q_heads", "model"),
            ("kv_heads", "model"),
            ("vocab", "model"),
            ("experts", "model"),
        ),
        description="2D TP: embed over data (psum matmuls), seq over model")


def _zero3() -> ShardingPlan:
    """megatron-TP + ZeRO-3: the params' 'embed' axis is sharded over 'data'
    (activations are unaffected: their 'batch' axis already occupies 'data',
    and ShardingPlan.spec never reuses a mesh axis)."""
    return _rename(megatron_tp_plan().with_rule("embed", "data"), "zero3")


@dataclass
class MeshPlanCost:
    compute_s: float
    memory_s: float
    collective_s: float
    hbm_bytes_per_chip: float
    collective_bytes: float
    feasible: bool
    dominant: str

    @property
    def total_s(self) -> float:
        # paper's overlap model at steady state: compute overlaps transfers
        return max(self.compute_s, self.memory_s, self.collective_s)


@dataclass
class MeshPlanResult:
    plan: ShardingPlan
    cost: MeshPlanCost
    notes: str = ""
    # search-efficiency counters of the ranking that produced this result
    # (mirrors PlanResult.n_pruned/n_estimated at mesh granularity; the
    # same stats for every result of one plan_mesh call)
    stats: Optional[Dict[str, int]] = None


def default_cluster(multi_pod: bool = False) -> HardwareModel:
    """The cluster planned for when none is given: 32 nodes of 8 H100s, or
    two such clusters."""
    return h100_cluster(pods=2 if multi_pod else 1)


def _mesh_sizes(hw: HardwareModel) -> Dict[str, int]:
    return dict(hw.mesh_dims)


def _link_bytes_per_s(hw: HardwareModel, axis: str) -> float:
    """Per-card link rate along a mesh axis, any degradation applied."""
    ic = hw.interconnect_along(axis)
    if ic is None:
        raise ValueError(f"{hw.name} has no interconnect along {axis!r}")
    return ic.bandwidth_gbps * dict(hw.degraded_links).get(ic.name, 1.0) * 1e9


def _shard_factor(plan: ShardingPlan, logical: str, sizes: Dict[str, int]
                  ) -> int:
    m = plan.mesh_axes(logical)
    if m is None:
        return 1
    axes = (m,) if isinstance(m, str) else m
    return math.prod(sizes.get(a, 1) for a in axes)


def estimate_plan(api: ModelAPI, shape: ShapeConfig, plan: ShardingPlan,
                  tcfg: TrainConfig, *, multi_pod: bool = False,
                  hw: Optional[HardwareModel] = None) -> MeshPlanCost:
    """Analytic three-term cost of one (plan, arch, shape) cell on the
    cluster's df model (``hw``, default :func:`default_cluster`).  Mirrors
    core/perfmodel.py at mesh granularity.  The activation term keeps the
    reference's formula, which the reference calibrated against its TPU
    dry-run's memory analysis; the card has not re-measured it (``mesh_train``
    in ``chip_smoke.py`` prints it beside a measured peak)."""
    cfg = api.cfg
    hw = hw if hw is not None else default_cluster(multi_pod)
    sizes = _mesh_sizes(hw)
    chips = math.prod(sizes.values())
    B, S = shape.global_batch, shape.seq_len
    dt = 2  # bf16 activations

    n_params = api.n_params()
    n_active = api.n_active_params()
    is_train = shape.kind == "train"
    tokens = B * (S if shape.kind != "decode" else 1)

    # ---- compute term ----------------------------------------------------
    flops = (6.0 if is_train else 2.0) * n_active * tokens
    if cfg.family in ("dense", "moe", "vlm", "audio") and shape.kind != "decode":
        flops += 2.0 * (3.0 if is_train else 1.0) * B * S * S * \
            cfg.n_heads * cfg.head_dim_ * cfg.n_layers * 0.5
    compute_s = flops / (chips * hw.peak_flops_per_core())

    # ---- memory (HBM) term -------------------------------------------------
    p_bytes = dtype_bytes(cfg.param_dtype)
    tp = _shard_factor(plan, "ffn", sizes)
    zero = _shard_factor(plan, "embed", sizes)
    ep = _shard_factor(plan, "experts", sizes) if cfg.n_experts else 1
    if cfg.n_experts and ep > tp:
        tp = ep              # expert sharding dominates the FFN weights
    params_per_chip = n_params * p_bytes / (tp * zero)
    if tcfg.optimizer == "adafactor":
        opt_mult = 0.05          # factored second moments: ~N/d per matrix
    else:
        opt_mult = {"float32": 8, "bfloat16": 4}.get(tcfg.opt_state_dtype, 8)
    opt_per_chip = (n_params * opt_mult / (tp * zero)) if is_train else 0.0
    grad_per_chip = (n_params * 4 / (tp * zero)) if is_train else 0.0
    dp = _shard_factor(plan, "batch", sizes)
    sp = _shard_factor(plan, "seq", sizes)
    # activations carry the embed dim sharded only when 'batch' does not
    # already occupy the same mesh axis (ShardingPlan.spec drops reuses)
    b_ax = str(plan.mesh_axes("batch"))
    e_ax = plan.mesh_axes("embed")
    act_emb = _shard_factor(plan, "embed", sizes) if (
        e_ax and str(e_ax) not in b_ax) else 1
    mb = max(1, tcfg.microbatches) if is_train else 1
    tokens_chip = tokens / max(1, dp * sp * act_emb) / mb
    if is_train:
        # scan-over-layers remat: one carry (layer input) saved per layer,
        # x2 for backward temporaries (calibrated against dry-run
        # memory_analysis on qwen2.5-3b: 30 GB at mb=1 -> 9.4 GB at mb=4)
        act_per_chip = 2 * cfg.n_layers * tokens_chip * cfg.d_model * dt \
            + 8 * tokens_chip * cfg.d_model * dt
    else:
        act_per_chip = 2 * tokens_chip * cfg.d_model * dt
    if shape.kind == "decode":
        # KV cache / recurrent state resident in HBM
        if cfg.family == "ssm":
            cache = cfg.n_layers * B * cfg.d_model * 64 * 4
        else:
            cache = (cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim_
                     * 2 * 2)
        kvh = min(_shard_factor(plan, "kv_heads", sizes),
                  max(1, cfg.n_kv_heads))
        kvs = _shard_factor(plan, "kv_seq", sizes) * kvh
        act_per_chip += cache / max(1, min(dp, B) * kvs)
    hbm_per_chip = params_per_chip + opt_per_chip + grad_per_chip \
        + act_per_chip
    if zero > 1 and act_emb == 1 and is_train_or_prefill(shape) \
           :
        # (the reference's term, kept for parity: the port's step gathers
        # per layer, but the ranking must equal the reference's)
        # ZeRO-3 via GSPMD: XLA hoists the per-layer weight all-gather into a
        # whole-stack gather (measured: llama3-405b 50 GB/device), so the
        # gathered stack is transiently resident sharded only by TP.  Decode
        # is exempt: its activations are MBs, XLA reshards those instead.
        hbm_per_chip += n_params * p_bytes / tp
    # bytes actually streamed per step: weights once (+grad/opt traffic when
    # training) + activations
    hbm_traffic = ((params_per_chip * (3 if is_train else 1)
                    + opt_per_chip) * (mb if zero > 1 else 1)
                   + act_per_chip * 2 * mb)
    memory_s = hbm_traffic / (hw.local_mem.bandwidth_gbps * 1e9)

    # ---- collective term (per-axis df interconnects, paper contention rule)
    busy: Dict[str, float] = {"data": 0.0, "model": 0.0, "pod": 0.0}
    act_bytes = tokens * cfg.d_model * dt
    if tp > 1:
        # TP all-gather + reduce-scatter per layer, fwd (+2x bwd in training)
        n_coll = 2 * cfg.n_layers * (3 if is_train else 1)
        busy["model"] += n_coll * (act_bytes / max(1, dp)) * (tp - 1) / tp
    if zero > 1:
        # ZeRO-3 weight all-gather per step (fwd + bwd re-gather)
        busy["data"] += (n_params * p_bytes / tp) * (2 if is_train else 1)
    if is_train and dp > 1:
        g_bytes = n_params * 4 / (tp * zero)
        if tcfg.grad_compression == "int8":
            g_bytes /= 4
        busy["data"] += 2 * g_bytes * (min(dp, sizes["data"]) - 1) / dp
        if "pod" in sizes and plan.mesh_axes("batch") and \
                "pod" in str(plan.mesh_axes("batch")):
            busy["pod"] += 2 * g_bytes / max(1, sizes.get("pod", 1))
    if cfg.n_experts and _shard_factor(plan, "experts", sizes) > 1:
        # EP all-to-all: k-routed token activations, there and back
        k = cfg.experts_per_token or 1
        busy["model"] += 2 * cfg.n_layers * (3 if is_train else 1) * \
            (tokens / max(1, dp)) * k * cfg.d_model * dt
    if sp > 1:
        # ring attention: K/V blocks circulate around the 'model' ring
        busy["model"] += (3 if is_train else 1) * cfg.n_layers * \
            2 * (tokens / sp) * cfg.n_kv_heads * cfg.head_dim_ * dt * (sp - 1)
    coll_terms = []
    for axis, b in busy.items():
        if b <= 0:
            continue
        bw = _link_bytes_per_s(hw, axis)
        # aggregate pool: one link per chip along the axis ring; demand is
        # time-shared per the paper's contention rule
        coll_terms.append(b / (bw * chips / sizes.get(axis, 1)))
    collective_s = max(coll_terms) if coll_terms else 0.0
    coll_bytes = sum(busy.values())

    feasible = hbm_per_chip <= hw.local_mem.size_bytes * 0.95
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return MeshPlanCost(compute_s, memory_s, collective_s, hbm_per_chip,
                        coll_bytes, feasible, dominant)


def candidate_plans(cfg: ModelConfig, shape: ShapeConfig
                    ) -> List[ShardingPlan]:
    cands = [megatron_tp_plan(), _zero3(), pure_dp_plan()]
    if shape.kind == "train":
        # ZeRO-3 + sequence-parallel activations
        cands.insert(1, _rename(
            _zero3().with_rule("seq", "model").with_rule("kv_seq", "model"),
            "zero3_sp"))
        # 2D TP: required for the 100B+ archs (see module docstring)
        cands.insert(2, _tp2d())
    if shape.kind == "prefill":
        cands.insert(1, _tp2d())     # same reasoning for 32k prefill
    if cfg.n_experts:
        cands.insert(0, expert_parallel_plan())
        cands.append(_rename(expert_parallel_plan().with_rule(
            "embed", "data"), "expert_parallel_zero3"))
    if shape.kind != "train" and shape.seq_len >= 32768:
        cands.append(sequence_parallel_plan())
    if shape.kind == "decode":
        # sequence-split KV attention (flash-decode across the mesh): shard
        # the cache sequence over 'model' — essential when n_kv_heads < 16
        kv_split = megatron_tp_plan().with_rule("kv_seq", "model") \
            .with_rule("kv_heads", None).with_rule("q_heads", None)
        cands.insert(0, _rename(kv_split, "kv_sequence_split"))
        cands.insert(1, _rename(kv_split.with_rule("embed", "data"),
                                "kv_split_zero3"))

    return cands


# ------------------------------------------------------------ plan cache
def _axes_to_jsonable(axes) -> Any:
    return list(axes) if isinstance(axes, tuple) else axes


def _axes_from_jsonable(axes) -> Any:
    return tuple(axes) if isinstance(axes, list) else axes


def _mesh_result_to_dict(r: MeshPlanResult) -> Dict[str, Any]:
    return {
        "plan": {"name": r.plan.name,
                 "rules": [[k, _axes_to_jsonable(v)] for k, v in r.plan.rules],
                 "description": r.plan.description},
        "cost": dataclasses.asdict(r.cost),
        "notes": r.notes,
        "stats": r.stats,
    }


def _mesh_result_from_dict(d: Dict[str, Any]) -> MeshPlanResult:
    plan = ShardingPlan(
        name=d["plan"]["name"],
        rules=tuple((k, _axes_from_jsonable(v)) for k, v in d["plan"]["rules"]),
        description=d["plan"].get("description", ""))
    return MeshPlanResult(plan, MeshPlanCost(**d["cost"]),
                          d.get("notes", ""), d.get("stats"))


# bump whenever estimate_plan's cost logic or candidate_plans' plan set
# changes: persisted rankings are invalid under a different cost model
MESH_PLANNER_VERSION = 1


def _mesh_key(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
              multi_pod: bool, top_k: int, hw: HardwareModel) -> str:
    # only the fields estimate_plan actually reads go into the key: the
    # free-text shape name and schedule-only TrainConfig fields (lr, steps,
    # seed...) must not cause spurious misses — otherwise the AOT-warmed
    # registry cells (named "train_4k" etc.) could never be hit by the
    # launchers' ad-hoc ShapeConfig("serve"/"cli", ...) instances
    return plancache.request_key(
        "mesh_plan",
        {"cfg": dataclasses.asdict(cfg),
         "shape": {"seq_len": shape.seq_len,
                   "global_batch": shape.global_batch, "kind": shape.kind},
         "tcfg": {"optimizer": tcfg.optimizer,
                  "opt_state_dtype": tcfg.opt_state_dtype,
                  "microbatches": tcfg.microbatches,
                  "grad_compression": tcfg.grad_compression},
         "multi_pod": multi_pod, "top_k": top_k},
        hw, extra={"mesh_planner_version": MESH_PLANNER_VERSION})


def plan_mesh(api: ModelAPI, shape: ShapeConfig, tcfg: TrainConfig, *,
              multi_pod: bool = False, top_k: int = 3,
              cache: bool = True, hw: Optional[HardwareModel] = None
              ) -> List[MeshPlanResult]:
    """Rank candidate plans (paper step 1).  The dry-run compiles the top-k
    (paper step 2) and EXPERIMENTS.md records both.

    Rankings are persisted in the plan registry keyed on (model config,
    shape cell, train config, pod df model) — ``launch/serve.py`` and
    ``launch/train.py`` therefore start with a hot cache after
    ``python -m repro_torch.plancache warm``.  ``cache=False`` forces a fresh
    ranking.  ``hw`` is the cluster (default :func:`default_cluster`); its
    name and digest are part of the registry key."""
    hw = hw if hw is not None else default_cluster(multi_pod)
    store = plancache.get_store() if cache else None
    key = None
    if store is not None:
        key = _mesh_key(api.cfg, shape, tcfg, multi_pod, top_k, hw)
        ent = store.get(key)
        if ent is not None:
            try:
                return [_mesh_result_from_dict(d)
                        for d in ent["payload"]["results"]]
            except (KeyError, TypeError, ValueError):
                # decoded fine but doesn't deserialize: corrupt payload,
                # quarantine it and fall through to a fresh ranking
                store.quarantine(key, "deserialize")
    out = []
    t_rank = time.perf_counter()
    for plan in candidate_plans(api.cfg, shape):
        cost = estimate_plan(api, shape, plan, tcfg, multi_pod=multi_pod, hw=hw)
        out.append(MeshPlanResult(plan, cost))
    feasible = [r for r in out if r.cost.feasible]
    infeasible = [r for r in out if not r.cost.feasible]
    feasible.sort(key=lambda r: r.cost.total_s)
    for r in infeasible:
        r.notes = (f"pruned: {r.cost.hbm_bytes_per_chip / 1e9:.1f} GB/chip "
                   f"exceeds HBM (paper capacity rule)")
    ranked = feasible[:top_k] + infeasible
    # mirror core PlanResult's search counters so registry/report tooling
    # can treat both planners uniformly (capacity-infeasible plans are this
    # planner's "pruned" set; every candidate pays a full estimate)
    stats = {"n_candidates": len(out), "n_estimated": len(out),
             "n_pruned": len(infeasible),
             "rank_ms": int((time.perf_counter() - t_rank) * 1e3)}
    for r in ranked:
        r.stats = stats
    if store is not None and key is not None:
        store.put(key,
                  {"results": [_mesh_result_to_dict(r) for r in ranked]},
                  meta={"template": "mesh_plan",
                        "shape": [shape.seq_len, shape.global_batch],
                        "hw_name": hw.name,
                        "arch": api.cfg.name, "kind": shape.kind,
                        "best": ranked[0].plan.name if ranked else None})
    return ranked


def plan_mesh_service(api: ModelAPI, shape: ShapeConfig, tcfg: TrainConfig,
                      *, service=None, multi_pod: bool = False,
                      top_k: int = 3, budget_ms: Optional[float] = None):
    """:func:`plan_mesh` through the deadline-bounded plan service: same
    ranking, plus rung/latency accounting and the never-raise contract.
    Returns a ``planservice.MeshPlanResponse``; ``service=None`` builds a
    throwaway one over the process-wide store."""
    from repro_torch.planservice import PlanService
    svc = service if service is not None else PlanService()
    return svc.resolve_mesh(api, shape, tcfg, multi_pod=multi_pod,
                            top_k=top_k, budget_ms=budget_ms)


def _plan_mesh_job(payload) -> List[MeshPlanResult]:
    """One (arch, shape) mesh ranking, publishing into the shared disk
    registry — the unit both :func:`plan_mesh_many` and the AOT warm sweep
    (``plancache/warmjobs.py``) shard across worker processes."""
    arch, shape_name, tcfg_dict, multi_pod, top_k = payload
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import SHAPES
    api = build_model(ARCHS[arch])
    ranked = plan_mesh(api, SHAPES[shape_name], TrainConfig(**tcfg_dict),
                       multi_pod=multi_pod, top_k=top_k)
    plancache.get_store().flush_stats()
    return ranked


def _plan_mesh_job_isolated(payload) -> List[MeshPlanResult]:
    """Worker-process entry: pins the planner to inline search first (the
    sweep is already parallel at cell granularity)."""
    os.environ["REPRO_PLANNER_WORKERS"] = "1"
    return _plan_mesh_job(payload)


def plan_mesh_many(cells: Sequence[Tuple[str, str]], tcfg: TrainConfig, *,
                   multi_pod: bool = False, top_k: int = 3,
                   workers: Optional[int] = None
                   ) -> List[List[MeshPlanResult]]:
    """Rank many registry cells — ``(arch_name, shape_name)`` pairs —
    sharding across worker processes (``workers``; default
    ``REPRO_PLANNER_WORKERS`` / cpu count; <=1 = inline).

    Results return in cell order regardless of worker count, and every
    worker publishes its ranking into the shared on-disk plan registry
    (pid-unique temp renames + the advisory stats lock keep concurrent
    publishes coherent), so a sharded sweep leaves the exact cache state a
    sequential one would.  This is the mesh-granularity face of the search
    executor; the AOT warm sweep (``python -m repro_torch.plancache warm
    --jobs``) rides the same worker pool.
    """
    from repro_torch.parallel import search_exec
    n = search_exec.resolve_workers(workers)
    tcfg_dict = dataclasses.asdict(tcfg)
    jobs = [(arch, shape, tcfg_dict, multi_pod, top_k)
            for arch, shape in cells]
    if n <= 1:
        from repro_torch.configs import ARCHS
        from repro_torch.configs.shapes import SHAPES
        return [plan_mesh(build_model(ARCHS[a]), SHAPES[s], tcfg,
                          multi_pod=multi_pod, top_k=top_k)
                for a, s in cells]
    return search_exec.map_jobs(_plan_mesh_job_isolated, jobs, n)


# the reference's jax collective -> the torch.distributed call that does
# the same on the port's process groups
COLLECTIVE_OF = {"psum": "all_reduce", "reduce_scatter": "reduce_scatter_tensor",
                 "ppermute": "batch_isend_irecv", "all_to_all": "all_to_all_single"}


def lower_reduction_bind(mapping) -> List[Dict[str, Any]]:
    """Lower a cluster-level spatial-reduction mapping to
    ``torch.distributed`` collectives.

    A ``reduce=True`` bind on a mesh df axis (a core
    :class:`~repro_torch.core.mapping.Mapping` planned on a cluster
    description) is the mesh-granularity face of split-K: every card along
    the axis holds a partial sum of the same output shard.  The combining
    styles map onto collectives 1:1 (the reference's ``psum``,
    ``reduce_scatter`` and ``ppermute``; :data:`COLLECTIVE_OF`):

    * ``accum``  -> ``all_reduce`` over the axis' group (all cards end with
      the reduced value in place — the ``tp2d`` plan's partial matmuls);
    * ``tree``   -> ``reduce_scatter_tensor`` + owner-shard store
      (log-depth combining; only one shard materializes the output);
    * ``chain``  -> a ring of ``batch_isend_irecv`` partial accumulations
      (the neighbor-chain forwarding the Wormhole plans use on the NoC).

    Returns one descriptor per reduce bind (empty list = pure parallel
    mapping, no collective epilogue).
    """
    out: List[Dict[str, Any]] = []
    coll = {"accum": "all_reduce", "tree": "reduce_scatter_tensor",
            "chain": "batch_isend_irecv"}
    for b in mapping.reduce_binds():
        out.append({
            "axis": b.hw_dim,
            "reduction_dim": b.grid_dim,
            "n_split": int(mapping.active_reduce_factor()),
            "collective": coll.get(mapping.reduce_style, "all_reduce"),
            "style": mapping.reduce_style,
        })
    return out


def lower_forwarded_edge(decision) -> Dict[str, Any]:
    """Lower one pipeline edge decision
    (:class:`repro_torch.pipeline.EdgeDecision`) to its cluster-level
    realization.

    At mesh granularity the "distributed local memories" are the cards'
    HBMs, so a *forwarded* edge means the producer's output shard stays
    resident on the card and is handed straight to the consumer (no host
    round trip), and each mismatched spatial digit becomes a re-shard
    collective on that axis:

    * aligned (no shuffle axes)  -> pure donation: producer and consumer
      agree on the sharding, the consumer reads the producer's buffer;
    * shuffle axes               -> one ``all_to_all_single`` per mismatched
      mesh axis (the reference's ``all_to_all``; the NoC re-shuffle leg's
      collective face).

    A *spilled* edge round-trips through the global level instead —
    device-to-host offload + reload, the cluster analogue of the DRAM
    handoff.
    """
    if not decision.forwarded:
        return {
            "edge": [decision.src, decision.dst, decision.tensor],
            "placement": "offload",
            "transfer": "device_to_host+reload",
            "collectives": [],
        }
    return {
        "edge": [decision.src, decision.dst, decision.tensor],
        "placement": "resident",
        "transfer": "donate",
        "collectives": [{"axis": a, "collective": "all_to_all_single"}
                        for a in decision.shuffle_axes],
    }


def tileloom_view(plan: ShardingPlan, cfg: ModelConfig,
                  hw: Optional[HardwareModel] = None) -> str:
    """Render the plan as its TileLoom tile-program mapping (for reports).
    Resources are named by ``hw``'s interconnect along each axis (default
    :func:`default_cluster`: ``link_<axis>``)."""
    hw = hw if hw is not None else default_cluster()

    def link(axis: str) -> str:
        ic = hw.interconnect_along(axis)
        return ic.name if ic is not None else f"link_{axis}"

    batch = plan.mesh_axes("batch") or "-"
    ffn = plan.mesh_axes("ffn") or plan.mesh_axes("experts") or "-"
    zero = plan.mesh_axes("embed")
    lines = [
        f"// TileLoom mapping of C[tokens,ffn] = X[tokens,d] @ W[d,ffn] "
        f"({plan.name})",
        f"tokens -> %{batch}; ffn -> %{ffn}",
        f"load_X {{type=\"broadcast\", resources={{%{link('model')}}}}}"
        if ffn != "-" else "load_X {type=\"local\"}",
    ]
    if zero:
        lines.append(f"load_W {{type=\"broadcast\", level=inner, "
                     f"resources={{%{link('data')}}}}}  // ZeRO-3 per-use gather")

    else:
        lines.append(f"load_W {{type=\"broadcast\", level=0, "
                     f"resources={{%{link('data')}}}}}  // weights resident")
    embed = plan.mesh_axes("embed")
    if embed and plan.name == "tp2d":
        # contraction (d) sharded: the cards along the axis hold split-K
        # partials — the cluster-level reduce bind, lowered as an all_reduce
        # epilogue (see lower_reduction_bind)
        lines.append(f"store_C {{type=\"reduce\", style=\"accum\", "
                     f"resources={{%{link(embed)}}}}}  // split-K all_reduce")
    return "\n".join(lines)
