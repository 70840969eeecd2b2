"""The port's tenancy layer against the reference's, on the CPU.

Every scenario of ``tests/test_tenancy.py`` runs through both packages, at
the reference test's sizes and seeds, each package with a fresh plan store
of its own: the scenario asserts the reference test's properties and returns
what it saw (partition-plan digests, rectangles and rungs, kill events with
owner, rung, blast radius and untouched tenants, admission outcomes,
validator findings, metric deltas), and the two packages' outcomes must be
equal.  No scenario reads a wall-clock deadline: the plan-service deadline
is infinite (``REPRO_PLAN_DEADLINE_MS=inf``) and every explicit latency
budget is too, so both packages search in full (``REPRO_FAST_SEARCH``).
Then ``serve --tenants`` prints the reference's lines, timings aside, and
``/tenants`` serves the live plan.
"""
import json
import math
import random
import re
import types
import urllib.request

import pytest

import repro.core as ref_core
import repro.core.hw as ref_hw
import repro.obs.metrics as ref_metrics
import repro.plancache as ref_pc
import repro.plancache.validate as ref_validate
import repro.planservice as ref_ps
import repro.runtime.faults as ref_faults
import repro.runtime.replan as ref_replan
import repro.tenancy as ref_ten
import repro.tenancy.partition as ref_part
import repro_torch.core as port_core
import repro_torch.core.hw as port_hw
import repro_torch.obs.metrics as port_metrics
import repro_torch.plancache as port_pc
import repro_torch.plancache.validate as port_validate
import repro_torch.planservice as port_ps
import repro_torch.runtime.faults as port_faults
import repro_torch.runtime.replan as port_replan
import repro_torch.tenancy as port_ten
import repro_torch.tenancy.partition as port_part

PKGS = {
    "ref": types.SimpleNamespace(core=ref_core, hw=ref_hw, metrics=ref_metrics, pc=ref_pc,
                                 validate=ref_validate, ps=ref_ps, faults=ref_faults,
                                 replan=ref_replan, ten=ref_ten, part=ref_part),
    "port": types.SimpleNamespace(core=port_core, hw=port_hw, metrics=port_metrics, pc=port_pc,
                                  validate=port_validate, ps=port_ps, faults=port_faults,
                                  replan=port_replan, ten=port_ten, part=port_part),
}
INF = math.inf


def _budget(k):
    return k.core.SearchBudget(top_k=3, max_mappings=16, max_plans_per_mapping=10,
                               max_candidates=500)


def _gemm_progs(k, M=256, N=256, K=256, cap=6):
    return [k.core.matmul_program(M, N, K, bm=bm, bn=bn, bk=bk)
            for bm, bn, bk in k.core.block_shape_candidates(M, N, K)][:cap]


def _service(k):
    return k.ps.PlanService(cache=k.pc.PlanCache(store=k.pc.get_store()))


def _plan_view(plan):
    return [(p.tenant.name, p.tenant.qos, p.rect.describe(), p.hw.name, p.rung, p.digest)
            for p in plan.placements]


def _event(ev):
    return {"cause": ev.cause, "owner": ev.owner, "rung": ev.rung,
            "replanned": list(ev.replanned), "blast_radius": ev.blast_radius,
            "untouched": list(ev.untouched), "contained": ev.contained(),
            "digests_after": ev.digests_after, "log": ev.log}


def _errors(fn, *args):
    try:
        fn(*args)
    except Exception as e:                   # noqa: BLE001 - the type is the outcome
        return type(e).__name__
    return None


# ------------------------------------------------------------ scenarios
def submesh(k, tmp):
    hw = k.core.get_hw("wormhole_8x8")
    assert k.ten.submesh(hw, (0, 0), (8, 8)) is hw
    sub = k.ten.submesh(hw, (2, 0), (4, 8))
    assert sub.mesh_dims == (("x", 4), ("y", 8)) and sub.n_cores == 32
    one = k.ten.submesh(hw, (3, 0), (1, 8))
    a, b = k.ten.submesh(hw, (0, 0), (4, 8)), k.ten.submesh(hw, (4, 0), (4, 8))
    assert a.df_text() == b.df_text()
    assert k.pc.keying.hw_digest(a) == k.pc.keying.hw_digest(b) != k.pc.keying.hw_digest(hw)
    faulty = hw.with_faults(disabled_cores=[(5, 3), (1, 1)])
    local = k.ten.submesh(faulty, (4, 0), (4, 8))
    assert local.disabled_cores == ((1, 3),) and local.is_degraded
    dead = hw.with_faults(disabled_cores=[(0, 0)])
    return {"sub": [sub.mesh_dims, sub.n_cores, sorted(ic.name for ic in sub.interconnects)],
            "one": [ic.name for ic in one.interconnects],
            "digests": [k.pc.keying.hw_digest(a), k.pc.keying.hw_digest(
                k.ten.submesh(hw, (0, 0), (8, 4)))],
            "local": [local.disabled_cores, local.is_degraded,
                      k.ten.submesh(faulty, (0, 2), (1, 1)).is_degraded],
            "errors": [_errors(k.ten.submesh, hw, (6, 0), (4, 8)),
                       _errors(k.ten.submesh, hw, (0, 0), (4,)),
                       _errors(k.ten.submesh, dead, (0, 0), (1, 1))]}


def layouts(k, tmp):
    region = k.ten.Rect((0, 0), (8, 8))
    found = k.ten.enumerate_layouts(region, [1.0, 2.0, 1.0])
    assert found and found == k.ten.enumerate_layouts(region, [1.0, 2.0, 1.0])
    for layout in found:
        cells = [c for r in layout for c in r.cells()]
        assert len(cells) == len(set(cells)) == 64
    first = k.ten.enumerate_layouts(region, [3.0, 1.0])[0]
    assert first[0].n_cells == 48 and first[1].n_cells == 16
    return {"three": [[r.describe() for r in layout] for layout in found],
            "biased": [r.describe() for r in first]}


def partition_isolation(k, tmp):
    """Per-tenant plans of pinned random layouts equal a standalone
    service's plans of the bare submesh, given the same request history."""
    hw = k.hw.wormhole(4, 4)
    service = _service(k)
    twin = k.ps.PlanService(cache=k.pc.PlanCache(store=k.pc.PlanCacheStore(root=tmp / "twin")))
    rng = random.Random(7)
    progs_a = _gemm_progs(k, 128, 128, 128, cap=4)
    progs_b = _gemm_progs(k, 128, 256, 128, cap=4)
    seen = []
    for layout in rng.sample(k.ten.enumerate_layouts(k.ten.Rect((0, 0), (4, 4)), [1.0, 1.0]), 2):
        tenants = [k.ten.TenantSpec("a", progs_a), k.ten.TenantSpec("b", progs_b)]
        mp = k.ten.MeshPartitioner(plan_layouts=1, max_layouts=1, cuts_per_split=1)
        orig = k.part.enumerate_layouts
        k.part.enumerate_layouts = lambda *a, _layout=layout, **kw: [_layout]
        try:
            plan = mp.plan(hw, tenants, service=service, budget=_budget(k), budget_ms=INF,
                           regret_bound=0.0)
        finally:
            k.part.enumerate_layouts = orig
        for p, progs in zip(plan.placements, (progs_a, progs_b)):
            standalone = twin.resolve(k.ps.PlanRequest(
                programs=list(progs), hw=k.ten.submesh(hw, p.rect.origin, p.rect.shape),
                budget=_budget(k), budget_ms=INF, regret_bound=0.0))
            assert standalone.rung == p.rung
            assert k.ten.plan_digest(p.plan) == k.ten.plan_digest(standalone.result.best.plan)
        seen.append(_plan_view(plan))
    return seen


def seeded_kill(k, tmp):
    hw = k.core.get_hw("wormhole_8x8")
    service = _service(k)
    tenants = [k.ten.TenantSpec("a", _gemm_progs(k, 256, 256, 256)),
               k.ten.TenantSpec("b", _gemm_progs(k, 128, 512, 256), qos="best_effort")]
    mp = k.ten.MeshPartitioner(plan_layouts=1)
    plan = mp.plan(hw, tenants, service=service, budget=_budget(k), budget_ms=INF)
    assert k.ten.IsolationValidator().validate(plan) == []
    rng = random.Random(20260807)
    out = []
    for trial in range(2):
        runtime = k.ten.TenantRuntime(plan, service=service, cache=service.cache,
                                      budget=_budget(k), partitioner=mp, latency_budget_s=INF)
        victim = plan.placements[trial % len(plan.placements)]
        cells = sorted(victim.rect.cells())
        cell = cells[rng.randrange(len(cells))]
        before = plan.digests()
        ev = runtime.kill_core(cell)
        assert ev.owner == victim.tenant.name and ev.blast_radius == 1
        assert ev.replanned == (victim.tenant.name,) and ev.contained()
        after = runtime.plan.digests()
        assert all(after[n] == d for n, d in before.items() if n != victim.tenant.name)
        assert k.ten.IsolationValidator().validate(runtime.plan) == []
        out.append({"cell": cell, "plan": _plan_view(plan), "event": _event(ev),
                    "after": _plan_view(runtime.plan)})
        plan = mp.plan(hw, tenants, service=service, budget=_budget(k), budget_ms=INF)
    return out


def kill_in_spare(k, tmp):
    hw = k.core.get_hw("wormhole_8x8")
    service = _service(k)
    tenants = [k.ten.TenantSpec("a", _gemm_progs(k)), k.ten.TenantSpec("b", _gemm_progs(k))]
    mp = k.ten.MeshPartitioner(spare_planes=2, plan_layouts=1)
    plan = mp.plan(hw, tenants, service=service, budget=_budget(k), budget_ms=INF)
    assert plan.region.shape == (6, 8)
    runtime = k.ten.TenantRuntime(plan, service=service, cache=service.cache,
                                  budget=_budget(k), partitioner=mp, latency_budget_s=INF)
    ev = runtime.kill_core((7, 7))
    assert ev.owner is None and ev.rung == "none" and ev.blast_radius == 0 and ev.contained()
    assert runtime.plan.digests() == plan.digests()
    return {"plan": _plan_view(plan), "event": _event(ev)}


def claim_adjacent(k, tmp):
    hw = k.core.get_hw("wormhole_8x8")
    service = _service(k)
    tenants = [k.ten.TenantSpec("a", _gemm_progs(k)), k.ten.TenantSpec("b", _gemm_progs(k))]
    mp = k.ten.MeshPartitioner(spare_planes=1, plan_layouts=1)
    plan = mp.plan(hw, tenants, service=service, budget=_budget(k), budget_ms=INF)
    runtime = k.ten.TenantRuntime(plan, service=service, cache=service.cache,
                                  budget=_budget(k), partitioner=mp, latency_budget_s=INF,
                                  claim_threshold=0.0)
    edge = max(plan.placements, key=lambda p: p.rect.end[0])
    rect_before = edge.rect
    ev = runtime.kill_core(next(iter(edge.rect.cells())))
    assert ev.owner == edge.tenant.name and ev.rung == "claim_adjacent"
    assert ev.blast_radius == 1 and ev.contained()
    grown = runtime.plan.placement(edge.tenant.name).rect
    assert sorted(n - o for n, o in zip(grown.shape, rect_before.shape)) == [0, 1]
    assert k.ten.IsolationValidator().validate(runtime.plan) == []
    return {"before": rect_before.describe(), "grown": grown.describe(), "event": _event(ev),
            "after": _plan_view(runtime.plan)}


def repartition_last_resort(k, tmp):
    hw = k.hw.wormhole(2, 2)
    service = _service(k)
    tenants = [k.ten.TenantSpec("g", _gemm_progs(k, cap=3)),
               k.ten.TenantSpec("e", _gemm_progs(k, 128, 128, 128, cap=3), qos="best_effort")]
    mp = k.ten.MeshPartitioner(plan_layouts=1)
    plan = mp.plan(hw, tenants, service=service, budget=_budget(k), budget_ms=INF)
    runtime = k.ten.TenantRuntime(plan, service=service, cache=service.cache,
                                  budget=_budget(k), partitioner=mp, latency_budget_s=INF)
    cells = sorted(plan.placements[0].rect.cells())
    first = runtime.kill_core(cells[0])
    ev = runtime.kill_core(cells[1])
    assert ev.rung == "repartition"
    assert k.ten.IsolationValidator().validate(runtime.plan) == []
    rungs = {p.tenant.name: getattr(p.response, "rung", "") for p in runtime.plan.placements}
    assert rungs["e"] == "fallback" and rungs["g"] != "fallback"
    dead = set(runtime.hw.disabled_cores)
    assert all(set(p.rect.cells()) - dead for p in runtime.plan.placements)
    return {"first": _event(first), "event": _event(ev), "rungs": rungs,
            "after": _plan_view(runtime.plan)}


def admission(k, tmp):
    adm = k.ten.TenantAdmission(max_best_effort=0)
    g = k.ten.TenantSpec("g", _gemm_progs(k, cap=1))
    with adm.admit(g, 25.0) as ms:
        guaranteed = ms
    adm = k.ten.TenantAdmission(max_best_effort=1)
    e1 = k.ten.TenantSpec("e1", _gemm_progs(k, cap=1), qos="best_effort")
    e2 = k.ten.TenantSpec("e2", _gemm_progs(k, cap=1), qos="best_effort")
    with adm.admit(e1, 25.0) as ms1:
        with adm.admit(e2, 25.0) as ms2:
            pass
    with adm.admit(e2, 25.0) as ms3:
        pass
    assert (guaranteed, ms1, ms2, ms3) == (25.0, 25.0, 0.0, 25.0)
    return {"ms": [guaranteed, ms1, ms2, ms3], "shed": adm.shed_total}


def shed_deadline(k, tmp):
    resp = _service(k).resolve(k.ps.PlanRequest(
        programs=_gemm_progs(k, cap=3), hw=k.core.get_hw("wormhole_4x8"),
        budget=_budget(k), budget_ms=0.0))
    assert resp.rung == "fallback" and resp.ok
    return {"rung": resp.rung, "digest": k.ten.plan_digest(resp.result.best.plan)}


def _two_tenant_plan(k):
    hw = k.core.get_hw("wormhole_8x8")
    tenants = [k.ten.TenantSpec("a", _gemm_progs(k)), k.ten.TenantSpec("b", _gemm_progs(k))]
    return hw, k.ten.MeshPartitioner(plan_layouts=1).plan(
        hw, tenants, service=_service(k), budget=_budget(k), budget_ms=INF)


def validator_overlap(k, tmp):
    hw, plan = _two_tenant_plan(k)
    clean = k.ten.IsolationValidator().validate(plan)
    a, b = plan.placements
    b.rect = a.rect
    overlap = k.ten.IsolationValidator().validate(plan)
    b.rect = k.ten.Rect((6, 0), (4, 8))
    off = k.ten.IsolationValidator().validate(plan)
    assert clean == [] and any("overlap" in v for v in overlap)
    assert any("exceeds" in v for v in off)
    return {"clean": clean, "overlap": overlap, "off": off}


def validator_dram(k, tmp):
    hw, plan = _two_tenant_plan(k)
    sizes = [k.validate.dram_residency_bytes(p.plan) for p in plan.placements]
    assert all(s > 0 for s in sizes)
    tight = k.ten.IsolationValidator(dram_slack=1e-12).validate(plan)
    assert any("DRAM residency" in v for v in tight)
    return {"sizes": sizes, "tight": tight}


def validator_binds(k, tmp):
    hw, plan = _two_tenant_plan(k)
    p = plan.placements[0]
    p.rect = k.ten.Rect(p.rect.origin, (1, 1))
    p.hw = k.ten.submesh(hw, p.rect.origin, p.rect.shape)
    bad = k.ten.IsolationValidator().validate(plan)
    assert any("exceeds partition" in v or "outside mesh" in v or "size" in v for v in bad)
    return bad


def orchestrator(k, tmp):
    hw = k.core.get_hw("wormhole_8x8")
    service = _service(k)
    tenants = [k.ten.TenantSpec("a", _gemm_progs(k)), k.ten.TenantSpec("b", _gemm_progs(k))]
    mp = k.ten.MeshPartitioner(plan_layouts=1)
    plan = mp.plan(hw, tenants, service=service, budget=_budget(k), budget_ms=INF)
    runtime = k.ten.TenantRuntime(plan, service=service, cache=service.cache,
                                  budget=_budget(k), partitioner=mp, latency_budget_s=INF)
    orch = k.replan.ReplanOrchestrator(hw, _gemm_progs(k), cache=service.cache,
                                       budget=_budget(k), tenancy=runtime)
    cell = next(iter(plan.placements[0].rect.cells()))
    ev = orch.kill_cores([cell])
    assert ev.blast_radius == 1 and ev.contained()
    assert orch.current_hw.disabled_cores == (cell,)
    return {"event": _event(ev), "disabled": orch.current_hw.disabled_cores}


def best_submesh(k, tmp):
    hw = k.core.get_hw("wormhole_8x8")
    picks = [k.replan.best_submesh(hw.with_faults(disabled_cores=f)) for f in (
        [(1, 2)], [(1, 2), (5, 6)], [(1, 2), (1, 6)], [(1, 2), (5, 2), (6, 3)])]
    assert picks[0].name == "wormhole_8x8_sub_x7" and picks[1].n_cores == 49
    assert picks[2].mesh_dims == (("x", 7), ("y", 8)) and picks[3].n_cores == 49
    return [(s.name, s.mesh_dims, s.n_cores) for s in picks]


def parse_faults(k, tmp):
    errors = []
    for text in ("link:noc_h:0", "link:noc_h:1.5", "core:3,5;core:3,5@2",
                 "link:noc_h:0.5;link:noc_h:0.5"):
        with pytest.raises(ValueError) as err:
            k.faults.parse_faults(text)
        errors.append(str(err.value))
    ok = k.faults.parse_faults("core:3,5;link:noc_h:0.5@2;straggler:1;crash")
    assert len(ok) == 4
    return {"errors": errors, "ok": [f.describe() for f in ok]}


def metrics_dump(k, tmp):
    k.metrics.inc("tenancy_test_total")
    path = tmp / "metrics.json"
    assert k.metrics.dump(str(path)) == str(path)
    data = json.loads(path.read_text())
    assert data["tenancy_test_total"]["type"] == "counter"
    assert [p.name for p in path.parent.iterdir() if p.suffix == ".json"] == ["metrics.json"]
    return data["tenancy_test_total"]["type"]


def containment_metrics(k, tmp):
    hw = k.core.get_hw("wormhole_8x8")
    service = _service(k)
    tenants = [k.ten.TenantSpec("a", _gemm_progs(k)), k.ten.TenantSpec("b", _gemm_progs(k))]
    mp = k.ten.MeshPartitioner(plan_layouts=1)
    plan = mp.plan(hw, tenants, service=service, budget=_budget(k), budget_ms=INF)
    runtime = k.ten.TenantRuntime(plan, service=service, cache=service.cache,
                                  budget=_budget(k), partitioner=mp, latency_budget_s=INF)
    owner = plan.placements[0]
    reg = k.metrics.REGISTRY
    before = reg.counter("tenancy_replan_total").value(tenant=owner.tenant.name,
                                                       rung="shrink_in_place")
    h0 = reg.histogram("tenancy_blast_radius").series(cause="core_kill")
    count0, sum0 = (h0.count, h0.sum) if h0 is not None else (0, 0.0)
    runtime.kill_core(next(iter(owner.rect.cells())))
    after = reg.counter("tenancy_replan_total").value(tenant=owner.tenant.name,
                                                      rung="shrink_in_place")
    hist = reg.histogram("tenancy_blast_radius").series(cause="core_kill")
    deltas = {"replan": after - before, "count": hist.count - count0, "sum": hist.sum - sum0}
    assert deltas == {"replan": 1, "count": 1, "sum": 1.0}
    return deltas


SCENARIOS = {f.__name__: f for f in (
    submesh, layouts, partition_isolation, seeded_kill, kill_in_spare, claim_adjacent,
    repartition_last_resort, admission, shed_deadline, validator_overlap, validator_dram,
    validator_binds, orchestrator, best_submesh, parse_faults, metrics_dump,
    containment_metrics)}


@pytest.fixture()
def no_deadline(monkeypatch):
    monkeypatch.setenv("REPRO_FAST_SEARCH", "1")
    monkeypatch.setenv("REPRO_PLAN_DEADLINE_MS", "inf")
    monkeypatch.delenv("REPRO_METRICS", raising=False)


def _run(name, side, tmp_path, monkeypatch):
    k = PKGS[side]
    root = tmp_path / side
    root.mkdir()
    monkeypatch.setenv(k.pc.ENV_DIR, str(root / "store"))
    monkeypatch.delenv(k.pc.ENV_TOGGLE, raising=False)
    k.pc.reset_store()
    try:
        return SCENARIOS[name](k, root)
    finally:
        k.pc.reset_store()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tenancy_scenario_matches_reference(name, tmp_path, monkeypatch, no_deadline):
    ref = _run(name, "ref", tmp_path, monkeypatch)
    port = _run(name, "port", tmp_path, monkeypatch)
    assert port == ref


# ------------------------------------------------------------- serve --tenants
TENANT_ARGS = ["--tenants", "2", "--tenant-kill", "0,0", "--plan-budget-ms", "5000"]
TIMINGS = re.compile(r"seconds=[0-9.]+ms")
SERVE_METRICS = ("tenancy", "replan", "planservice")


def _serve_lines(main, metrics, capsys):
    """The printed lines, timings masked, except the metrics line, whose
    totals are the process's; and the run's own change of those totals."""
    before = metrics.counter_totals(metrics.snapshot())
    main(list(TENANT_ARGS))
    after = metrics.counter_totals(metrics.snapshot())
    lines = TIMINGS.sub("seconds=<t>ms", capsys.readouterr().out).splitlines()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if k.startswith(SERVE_METRICS) and v != before.get(k, 0)}
    return [line for line in lines if not line.startswith("[serve] metrics: ")], moved


def test_serve_tenants_prints_the_reference_lines(tmp_path, monkeypatch, capsys):
    """The reference's own smoke (``benchmarks/obs_serve_smoke.py``) runs
    this mode with a 5 s plan deadline: the core kill's replan is held to
    it."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve
    monkeypatch.setenv("REPRO_FAST_SEARCH", "1")
    monkeypatch.setenv("REPRO_PLAN_DEADLINE_MS", "5000")
    lines = {}
    for side, main in (("ref", ref_serve.main), ("port", port_serve.main)):
        monkeypatch.setenv(PKGS[side].pc.ENV_DIR, str(tmp_path / side))
        PKGS[side].pc.reset_store()
        try:
            lines[side] = _serve_lines(main, PKGS[side].metrics, capsys)
        finally:
            PKGS[side].pc.reset_store()
    assert lines["port"] == lines["ref"]
    assert lines["port"][1]["tenancy_replan_total"] == 1
    out = "\n".join(lines["port"][0])
    assert "containment ok: untouched=['tenant1']" in out
    assert "owner=tenant0 rung=shrink_in_place blast_radius=1" in out


def test_serve_tenants_serves_the_live_plan_on_introspection(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve as port_serve
    from repro_torch.obs import flightrec, slo
    monkeypatch.setattr(flightrec.RECORDER, "on", flightrec.RECORDER.on)
    monkeypatch.setattr(flightrec.RECORDER, "path", flightrec.RECORDER.path)
    monkeypatch.setattr(slo.TRACKER, "on", slo.TRACKER.on)
    monkeypatch.setenv("REPRO_FAST_SEARCH", "1")
    monkeypatch.setenv("REPRO_PLAN_DEADLINE_MS", "5000")
    monkeypatch.setenv(port_pc.ENV_DIR, str(tmp_path / "store"))
    port_pc.reset_store()
    views = []

    class Watch:
        """stdout that scrapes ``/tenants`` once the hold line appears."""

        def __init__(self, out):
            self.out = out

        def write(self, text):
            found = re.search(r"holding introspection open .* at (http://\S+)", text)
            if found:
                with urllib.request.urlopen(found.group(1) + "/tenants", timeout=10) as r:
                    views.append(json.loads(r.read().decode()))
            return self.out.write(text)

        def flush(self):
            self.out.flush()

    import sys
    monkeypatch.setattr(sys, "stdout", Watch(sys.stdout))
    try:
        assert port_serve.main(TENANT_ARGS + ["--introspect-port", "0",
                                              "--introspect-hold", "0.1"]) is None
    finally:
        port_pc.reset_store()
    assert len(views) == 1
    view = views[0]
    assert view["hw"] == "wormhole_8x8"
    assert [(t["tenant"], t["qos"]) for t in view["tenants"]] \
        == [("tenant0", "guaranteed"), ("tenant1", "best_effort")]
    assert all(re.fullmatch(r"\d+x\d+@\(\d+,\d+\)", t["rect"]) for t in view["tenants"])
    assert [(i["owner"], i["rung"], i["blast_radius"]) for i in view["incidents"]] \
        == [("tenant0", "shrink_in_place", 1)]
