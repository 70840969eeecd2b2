"""The port's copies of the pipeline co-planner, the plan service, the
degraded-mesh re-planner and ``python -m repro_torch.obs explain`` against the
reference's: the same inputs through both packages give the same plans
(digests of the serialized plans), rungs, simulated totals and text.  Each
package plans into its own temporary store."""
import json
import re
from types import SimpleNamespace

import pytest

import repro.core as ref_core
import repro.pipeline as ref_pipeline
import repro.plancache as ref_pc
import repro.planservice as ref_ps
import repro.runtime.faults as ref_faults
import repro.runtime.replan as ref_replan
import repro_torch.core as port_core
import repro_torch.pipeline as port_pipeline
import repro_torch.plancache as port_pc
import repro_torch.planservice as port_ps
import repro_torch.runtime.replan as port_replan
from repro.core import lower_jax
from repro.obs import __main__ as ref_obs_main
from repro_torch.core import lower_torch
from repro_torch.obs import __main__ as port_obs_main

# tests/test_pipeline.py's budget and block sets
PIPE_BUDGET = dict(top_k=3, max_mappings=24, max_plans_per_mapping=12,
                   max_candidates=2000, max_per_load=6, workers=1)
GRAPHS = {
    "mlp2": ("mlp2_graph", (4096, 128, 256),
             ((64, 64, 64), (128, 128, 64), (128, 64, 128))),
    "attn": ("attn_qk_pv_graph", (4, 512, 512, 64), ((64, 64), (128, 128))),
    "moe_ffn": ("moe_ffn_graph", (4, 512, 128, 256), ((64, 64, 64), (128, 128, 128))),
}
# tests/test_planservice.py's budget
SVC_BUDGET = dict(top_k=2, max_mappings=16, max_plans_per_mapping=8, max_candidates=400)
SIDES = {"ref": (ref_core, ref_pipeline, ref_pc, ref_ps, ref_replan),
         "port": (port_core, port_pipeline, port_pc, port_ps, port_replan)}


def _digest(pc, plan) -> str:
    return pc.keying.digest_of(pc.plan_to_dict(plan))


def _store(pc, root):
    return pc.PlanCache(pc.PlanCacheStore(root=root))


def _graph(pipeline, kind):
    builder, dims, blocks = GRAPHS[kind]
    return getattr(pipeline, builder)(*dims, blocks=blocks)


def _co_plan(side, kind, forwarding=True):
    core, pipeline, *_ = SIDES[side]
    budget = core.SearchBudget(**PIPE_BUDGET, pipeline_forwarding=forwarding)
    hw = core.get_hw("wormhole_8x8")
    graph = _graph(pipeline, kind)
    return graph, pipeline.plan_pipeline(graph, hw, budget=budget), hw


def _graph_sim(pipeline, graph, gp, hw):
    """The co-planned graph re-simulated from its chosen plans and edge
    decisions (``pipeline.simulate_nodes`` with each node's legs)."""
    chosen = {name: c.plan for name, c in gp.nodes.items()}
    specs = {(e.src, e.dst, e.tensor):
             pipeline.forward_spec(graph, e, chosen[e.src], chosen[e.dst], hw)
             for e in graph.edges}
    forwarded = {d.key: d.forwarded for d in gp.decisions}
    legs = {n: pipeline.node_legs(graph, n, specs, forwarded) for n in chosen}
    return pipeline.simulate_nodes(graph, chosen, legs, hw)


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_plan_pipeline_matches_reference(kind, fast_search):
    ref_graph, ref_gp, ref_hw = _co_plan("ref", kind)
    port_graph, port_gp, port_hw = _co_plan("port", kind)
    assert [(d.key, d.forwarded, d.shuffle_axes, d.resident_bytes) for d in port_gp.decisions] \
        == [(d.key, d.forwarded, d.shuffle_axes, d.resident_bytes) for d in ref_gp.decisions]
    assert {n: _digest(port_pc, c.plan) for n, c in port_gp.nodes.items()} \
        == {n: _digest(ref_pc, c.plan) for n, c in ref_gp.nodes.items()}
    assert (port_gp.total_s, port_gp.baseline_s, port_gp.dram_roundtrip_s) \
        == (ref_gp.total_s, ref_gp.baseline_s, ref_gp.dram_roundtrip_s)
    ref_sim = _graph_sim(ref_pipeline, ref_graph, ref_gp, ref_hw)
    port_sim = _graph_sim(port_pipeline, port_graph, port_gp, port_hw)
    assert (port_sim.total_s, port_sim.dram_bytes, port_sim.noc_bytes) \
        == (ref_sim.total_s, ref_sim.dram_bytes, ref_sim.noc_bytes)
    assert {n: s.total_s for n, s in port_sim.node_sims.items()} \
        == {n: s.total_s for n, s in ref_sim.node_sims.items()}


def test_graph_plan_dict_round_trips_through_the_port(fast_search):
    _, ref_gp, _ = _co_plan("ref", "mlp2")
    _, port_gp, _ = _co_plan("port", "mlp2")
    ref_dict = json.loads(json.dumps(ref_pc.serialize.graph_plan_to_dict(ref_gp)))
    port_dict = json.loads(json.dumps(port_pc.serialize.graph_plan_to_dict(port_gp)))
    # every entry but the search's wall time
    assert {k: v for k, v in port_dict.items() if k != "plan_seconds"} \
        == {k: v for k, v in ref_dict.items() if k != "plan_seconds"}
    back = port_pc.serialize.graph_plan_from_dict(ref_dict)
    assert type(back) is port_pipeline.GraphPlan
    assert back.describe() == ref_gp.describe()
    assert (back.total_s, back.baseline_s) == (ref_gp.total_s, ref_gp.baseline_s)
    assert [d.describe() for d in back.decisions] == [d.describe() for d in ref_gp.decisions]
    assert {n: s.total_s for n, s in back.node_sims.items()} \
        == {n: s.total_s for n, s in ref_gp.node_sims.items()}


@pytest.mark.parametrize("forwarding", [True, False])
def test_fused_pipeline_spec_matches_reference(forwarding, fast_search):
    _, ref_gp, _ = _co_plan("ref", "mlp2", forwarding)
    _, port_gp, _ = _co_plan("port", "mlp2", forwarding)
    spec = lower_torch.fused_pipeline_spec(port_gp)
    assert spec == lower_jax.fused_pipeline_spec(ref_gp)
    if not forwarding:
        assert [s["nodes"] for s in spec["segments"]] == [["up"], ["down"]]
        assert spec["materialized"] == ["Y"]


def test_fused_pipeline_spec_materializes_cross_segment_edges():
    specs = []
    for pipeline, lower in ((ref_pipeline, lower_jax), (port_pipeline, lower_torch)):
        decision = pipeline.planner.EdgeDecision
        gp = SimpleNamespace(
            nodes={"a": None, "b": None, "c": None},
            decisions=(decision("a", "b", "T1", forwarded=False),
                       decision("b", "c", "T2", forwarded=False),
                       decision("a", "c", "T3", forwarded=True)))
        specs.append(lower.fused_pipeline_spec(gp))
    assert specs[0] == specs[1]
    assert sorted(specs[1]["materialized"]) == ["T1", "T2", "T3"]


@pytest.mark.parametrize("spatial_reduction", [True, False])
def test_splitk_pallas_spec_matches_reference(spatial_reduction, fast_search):
    """tests/test_spatial_reduction.py's split-K GEMM: a reduce-bound plan
    lowers to the same descriptor, a flat plan to None, in both packages."""
    specs = []
    for core, lower in ((ref_core, lower_jax), (port_core, lower_torch)):
        budget = core.SearchBudget(top_k=4 if spatial_reduction else 1,
                                   spatial_reduction=spatial_reduction)
        res = core.plan_kernel(core.matmul_program(256, 256, 65536, bm=64, bn=64, bk=64),
                               core.get_hw("wormhole_8x8"), budget=budget)
        specs.append(lower.splitk_pallas_spec(res.best.plan))
    assert specs[0] == specs[1]
    assert (specs[1] is not None) == spatial_reduction
    if spatial_reduction:
        assert specs[1]["grid_dim"] == "k" and specs[1]["n_split"] > 1


# ------------------------------------------------------------- plan service
def _resolve(side, root, progs_of, *, budget_ms, searches=4, seed=None):
    core, _, pc, ps, _ = SIDES[side]
    hw = core.get_hw("wormhole_1x8")
    budget = core.SearchBudget(**SVC_BUDGET)
    cache = _store(pc, root)
    if seed is not None:
        core.plan_kernel_multi(progs_of(core, *seed), hw, budget=budget, cache=cache)
    svc = ps.PlanService(cache, max_concurrent_searches=searches)
    req = ps.PlanRequest(progs_of(core), hw, budget=budget, budget_ms=budget_ms,
                         background=False)
    first = svc.resolve(req)
    direct = core.plan_kernel_multi(progs_of(core), hw, budget=budget, cache=None)
    return first, svc.resolve(req), direct, pc


def _gemms(core, M=256, N=256, K=256):
    return [core.matmul_program(M, N, K, bm=b, bn=b, bk=b) for b in (32, 64)]


def test_full_budget_resolve_matches_reference_then_hits(tmp_path, fast_search):
    out = {}
    for side in SIDES:
        first, again, direct, pc = _resolve(side, tmp_path / side, _gemms,
                                            budget_ms=float("inf"))
        assert (first.rung, first.outcome) == ("search", "ok")
        assert (again.rung, again.outcome) == ("cache", "ok")
        assert _digest(pc, first.plan) == _digest(pc, direct.best.plan) \
            == _digest(pc, again.plan)
        assert first.result.best.final_s == direct.best.final_s
        out[side] = _digest(pc, first.plan)
    assert out["port"] == out["ref"]


def test_zero_deadline_resolve_is_the_reference_fallback(tmp_path, fast_search):
    out = {}
    for side in SIDES:
        first, _, _, pc = _resolve(side, tmp_path / side, _gemms, budget_ms=0.0)
        assert (first.rung, first.outcome) == ("fallback", "deadline")
        out[side] = _digest(pc, first.plan)
    assert out["port"] == out["ref"]


def test_family_rung_resolve_matches_reference(tmp_path, fast_search):
    """A cached 512-cubed GEMM answers a 640x512x512 request from the
    shape-family rung when no search slot is free, in both packages."""
    def progs(core, *seed):
        if seed:
            return _gemms(core, *seed)
        return [core.matmul_program(640, 512, 512, bm=64, bn=64, bk=64)]

    out = {}
    for side in SIDES:
        first, _, _, pc = _resolve(side, tmp_path / side, progs, budget_ms=float("inf"),
                                   searches=0, seed=(512, 512, 512))
        assert (first.rung, first.outcome) == ("family", "ok")
        out[side] = (_digest(pc, first.plan), first.result.best.final_s)
    assert out["port"] == out["ref"]


def test_full_budget_resolve_of_the_served_gemm_on_h100(tmp_path, fast_search):
    """qwen2.5-3b's projection (ops.matmul's shape at batch 4 x 512) on the
    H100 model: the service at full budget answers what plan_kernel_multi
    does on the same programs, and the block table picks the same tile."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2.5-3b")
    M, N, K = 4 * 512, cfg.d_ff, cfg.d_model
    progs = lower_torch.gemm_programs(M, N, K)
    hw, budget = lower_torch.h100_sm(), lower_torch.chip_budget()
    svc = port_ps.PlanService(_store(port_pc, tmp_path))
    resp = svc.resolve(port_ps.PlanRequest(progs, hw, budget=budget, budget_ms=float("inf"),
                                           profile=False, background=False))
    direct = port_core.plan_kernel_multi(progs, hw, budget=budget, profile=False)
    assert (resp.rung, resp.outcome) == ("search", "ok")
    assert _digest(port_pc, resp.plan) == _digest(port_pc, direct.best.plan)
    assert lower_torch.gemm_blocks_of(resp.result) == lower_torch.gemm_blocks_of(direct)


def test_resolve_mesh_answers_search_then_cache_with_the_plan_mesh_ranking(isolated_stores):
    """``resolve_mesh`` reaches the port's mesh planner
    (``parallel.planner_bridge.plan_mesh`` on the H100 cluster): the first
    request is ranked (rung ``search``), the second is read back from the
    plan registry (rung ``cache``), both ``ok`` and both the ranking
    ``plan_mesh`` itself returns."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.models import build_model
    from repro_torch.parallel import planner_bridge as PB
    api = build_model(get_config("qwen2.5-3b").reduced())
    shape = ShapeConfig("serve", seq_len=12, global_batch=2, kind="decode")
    svc = port_ps.PlanService()
    first = svc.resolve_mesh(api, shape, TrainConfig(), budget_ms=float("inf"))
    again = svc.resolve_mesh(api, shape, TrainConfig(), budget_ms=float("inf"))
    direct = PB.plan_mesh(api, shape, TrainConfig(), cache=False)
    assert (first.rung, first.outcome) == ("search", "ok")
    assert (again.rung, again.outcome) == ("cache", "ok")
    for resp in (first, again):
        assert [r.plan.name for r in resp.ranking] == [r.plan.name for r in direct]
        assert [r.cost.total_s for r in resp.ranking] \
            == pytest.approx([r.cost.total_s for r in direct], rel=1e-12)
    assert first.seconds >= 0 and again.seconds >= 0


# --------------------------------------------------------------- re-planning
@pytest.fixture()
def isolated_stores(tmp_path, monkeypatch):
    for pc in (ref_pc, port_pc):
        monkeypatch.setenv(pc.ENV_DIR, str(tmp_path / pc.__name__))
        monkeypatch.delenv(pc.ENV_TOGGLE, raising=False)
        pc.reset_store()
    yield
    for pc in (ref_pc, port_pc):
        pc.reset_store()


def test_plan_degraded_and_best_submesh_match_reference(fast_search, isolated_stores):
    out = {}
    for side, (core, _, pc, _, replan) in SIDES.items():
        hw = core.get_hw("wormhole_8x8")
        degraded = hw.with_faults(disabled_cores=[(3, 5)])
        progs = [core.matmul_program(256, 256, 256, bm=bm, bn=bn, bk=bk)
                 for bm, bn, bk in core.block_shape_candidates(256, 256, 256)]
        sub = replan.best_submesh(degraded)
        res = replan.plan_degraded(progs, degraded, healthy_hw=hw, latency_budget_s=None,
                                   cause="core_kill")
        out[side] = (sub.mesh_dims, sub.n_cores, pc.hw_digest(sub), res.rung,
                     pc.hw_digest(res.hw), _digest(pc, res.plan), res.result.best.final_s)
    assert out["port"] == out["ref"]
    assert out["port"][1] == 56


def test_runtime_resolves_the_planner_and_elastic_names():
    """``runtime`` resolves its exports lazily: the copied fault-injection,
    re-plan and fault-tolerance names load, and so do the ported
    ``elastic``'s."""
    import repro_torch.runtime as runtime
    from repro_torch.runtime import elastic as port_elastic
    from repro_torch.runtime import fault_tolerance as port_ft
    assert runtime.plan_degraded is port_replan.plan_degraded
    for name in ("HeartbeatRegistry", "StragglerTracker", "RecoveryEvent", "ResilientDriver"):
        assert getattr(runtime, name) is getattr(port_ft, name)
    text = "core:3,5;link:noc_h:0.5@2"
    assert [f.describe() for f in runtime.parse_faults(text)] \
        == [f.describe() for f in ref_faults.parse_faults(text)]
    for name in ("RescalePlan", "apply_rescale", "plan_rescale", "viable_mesh_shapes"):
        assert getattr(runtime, name) is getattr(port_elastic, name)
    with pytest.raises(AttributeError):
        runtime.no_such_name


# ----------------------------------------------------------- explain (CLI)
CELLS = ["gemm/wormhole_1x8/M1024_N1024_K4096", "flash/h1024_s512",
         "reduction/gemm_ts/M512_N512_K16384", "pipeline/mlp2/M16384_d128_f512"]
# the search line ends with the search's wall time, which no two runs share
WALL = re.compile(r"(?m)^(  search    : .*), [0-9.]+s$")


@pytest.mark.parametrize("cell", CELLS)
def test_explain_prints_the_reference_text(cell, capsys, fast_search):
    texts = []
    for main in (ref_obs_main.main, port_obs_main.main):
        assert main(["explain", "--no-cache", cell]) == 0
        texts.append(WALL.sub(r"\1, <wall>s", capsys.readouterr().out))
    assert texts[0].count("<wall>s") == (0 if cell.startswith("pipeline/") else 1)
    assert texts[1].splitlines() == texts[0].splitlines()


def test_explain_lists_the_reference_cells(capsys):
    listed = []
    for main in (ref_obs_main.main, port_obs_main.main):
        assert main(["explain", "--list"]) == 0
        listed.append(capsys.readouterr().out.splitlines())
    assert listed[1] == listed[0]
    assert set(CELLS) <= set(listed[1])


def test_obs_metrics_prints_the_registry(capsys):
    from repro_torch.obs import metrics
    metrics.inc("t_port_obs_cli_total", rung="cache")
    assert port_obs_main.main(["metrics"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert metrics.counter_totals(snap)["t_port_obs_cli_total"] >= 1
