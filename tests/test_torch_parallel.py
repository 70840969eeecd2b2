"""The port's ``parallel/`` against the reference's, on the CPU: the same
partition specs from ``ShardingPlan.spec`` for every plan on every mesh, the
same placements of the train state, the batch, the parameters and the cache
for all ten configs, each rank's slice equal to ``NamedSharding``'s index
map (computed in a subprocess with 256 or 512 fake jax CPU devices), the
mesh planner's ranking equal to the reference's when it is given the TPU pod
as data, and a ranking on the H100 cluster under its 80 GB capacity rule."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from repro.configs import ARCHS
from repro.configs.base import ShapeConfig as RefShape, TrainConfig as RefTrainConfig
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.models import build_model as ref_build_model
from repro.parallel import planner_bridge as RB
from repro.parallel import sharding as RS
from repro.train import serve_step as ref_ss, train_step as ref_ts
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import lower_torch
from repro_torch.core.hw import tpu_v5e_pod
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import build_model
from repro_torch.parallel import planner_bridge as PB
from repro_torch.parallel import sharding as SH
from repro_torch.train import serve_step as SS, train_step as TS

ROOT = Path(__file__).resolve().parents[1]
MESHES = {(8, 16): ("data", "model"), (16, 16): ("data", "model"),
          (12, 16): ("data", "model"), (32, 8): ("data", "model"),
          (2, 32, 8): ("pod", "data", "model")}


def _plans(mod, bridge):
    """The four fixed plans and the planner's derived ones, by name."""
    out = {n: f() for n, f in mod.FIXED_PLANS.items()}
    out["tp2d"] = bridge._tp2d()
    out["zero3"] = bridge._zero3()
    out["zero3_sp"] = bridge._rename(bridge._zero3().with_rule("seq", "model")
                                     .with_rule("kv_seq", "model"), "zero3_sp")
    out["expert_parallel_zero3"] = bridge._rename(
        mod.expert_parallel_plan().with_rule("embed", "data"), "expert_parallel_zero3")
    kv = mod.megatron_tp_plan().with_rule("kv_seq", "model").with_rule(
        "kv_heads", None).with_rule("q_heads", None)
    out["kv_sequence_split"] = bridge._rename(kv, "kv_sequence_split")
    out["kv_split_zero3"] = bridge._rename(kv.with_rule("embed", "data"), "kv_split_zero3")
    return out


REF_PLANS, PORT_PLANS = _plans(RS, RB), _plans(SH, PB)


def _ref_mesh(shape):
    n = math.prod(shape)
    devs = np.array(jax.devices() * n)[:n].reshape(shape)
    return JaxMesh(devs, MESHES[shape])


def _port_mesh(shape, rank=0):
    return SH.Mesh(MESHES[shape], shape, rank=rank)


# logical axes of every kind the models use, each at tests/test_property.py's
# shapes (2-D) or a shape whose dims some mesh axes divide and some do not
AXES_SHAPES = [
    (("batch", "ffn"), [(256, 512), (100, 512), (256, 300)]),
    (("embed", "ffn"), [(256, 512), (100, 512), (256, 300)]),
    (("vocab", "embed"), [(256, 512), (100, 512), (256, 300)]),
    (("batch", "seq", "embed"), [(256, 512, 64), (64, 96, 256), (2, 4096, 2048)]),
    (("experts", "embed", "ffn"), [(128, 2048, 768), (64, 256, 300), (8, 128, 64)]),
    (("layers", "embed", "q_heads", "head_dim"), [(36, 2048, 16, 128), (2, 128, 4, 32)]),
    (("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
     [(36, 128, 32768, 2, 128), (2, 12, 512, 16, 64)]),
    (("layers", None, "batch", "ssm_heads", None, None), [(6, 6, 32, 64, 64, 16)]),
]


@pytest.mark.parametrize("mesh_shape", sorted(MESHES))
@pytest.mark.parametrize("plan", sorted(PORT_PLANS))
def test_spec_matches_reference(plan, mesh_shape):
    ref_mesh, mesh = _ref_mesh(mesh_shape), _port_mesh(mesh_shape)
    for axes, shapes in AXES_SHAPES:
        for shape in shapes:
            want = REF_PLANS[plan].spec(axes, shape, ref_mesh)
            got = PORT_PLANS[plan].spec(axes, shape, mesh)
            assert tuple(got) == tuple(want), (plan, axes, shape)
        assert tuple(PORT_PLANS[plan].spec(axes)) == tuple(REF_PLANS[plan].spec(axes))


def test_plan_rules_and_fixed_plans_match_reference():
    assert sorted(SH.FIXED_PLANS) == sorted(RS.FIXED_PLANS)
    for name in PORT_PLANS:
        assert PORT_PLANS[name].rules == REF_PLANS[name].rules, name
        assert PORT_PLANS[name].description == REF_PLANS[name].description, name
    plan = SH.megatron_tp_plan().with_rule("embed", "data")
    assert plan.rules == RS.megatron_tp_plan().with_rule("embed", "data").rules


def test_constrain_is_a_no_op_outside_a_plan_and_checks_the_batch_inside():
    x = torch.zeros(2, 3, 4)
    assert SH.constrain(x, ("batch", "seq", "embed")) is x
    assert SH.current_plan() is None
    mesh = _port_mesh((8, 16))
    with SH.use_plan(SH.megatron_tp_plan(), mesh, local_batch=2):
        assert SH.current_plan().name == "megatron_tp"
        assert SH.constrain(x, ("batch", "seq", "embed")) is x
        assert SH.constrain(x, ("batch", "seq")) is x           # rank differs: untouched
        with pytest.raises(ValueError, match="batch dim"):
            SH.constrain(torch.zeros(4, 3, 4), ("batch", "seq", "embed"))
    assert SH.current_plan() is None


# ------------------------------------------------------------- placements
def _ref_specs(tree):
    """{checkpoint key: spec} of a tree of NamedShardings (the reference's
    own leaf keys)."""
    from repro.ckpt.checkpoint import _path_str
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_path_str(p) for p in path): tuple(s.spec) for path, s in flat}


def _port_specs(tree):
    return {k: tuple(s.spec) for k, s in C._flatten_with_paths(
        tree, is_leaf=lambda x: isinstance(x, SH.Sharding))}


def _ref_cache_abstract(api, cfg):
    return jax.eval_shape(lambda: api.init_cache(cfg, 8, 64))


def _placements(arch, reduced, mesh_shape):
    """Every placement of one config under four plans, both packages:
    {(plan, kind, key): (port Sharding, reference spec, global shape)}."""
    ref_cfg, cfg = ARCHS[arch], get_config(arch)
    if reduced:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    ref_api, api = ref_build_model(ref_cfg), build_model(cfg)
    ref_mesh, mesh = _ref_mesh(mesh_shape), _port_mesh(mesh_shape)
    ref_tcfg, tcfg = RefTrainConfig(), TrainConfig()
    out = {}
    shapes = {k: tuple(l.shape) for k, l in C._flatten_with_paths(TS.abstract_state(api, tcfg))}
    batch = {"tokens": torch.empty(256, 4096, device="meta"),
             "labels": torch.empty(256, 4096, device="meta")}
    ref_batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32) for k, v in batch.items()}
    for name in ("megatron_tp", "zero3", "expert_parallel", "tp2d"):
        ref_plan, plan = REF_PLANS[name], PORT_PLANS[name]
        got = C._flatten_with_paths(TS.state_shardings(api, tcfg, plan, mesh),
                                    is_leaf=lambda x: isinstance(x, SH.Sharding))
        want = _ref_specs(ref_ts.state_shardings(ref_api, ref_tcfg, ref_plan, ref_mesh))
        assert sorted(k for k, _ in got) == sorted(want) == sorted(shapes)
        for k, s in got:
            out[(name, "state", k)] = (s, want[k], shapes[k])
        got = TS.batch_shardings(batch, plan, mesh)
        want = ref_ts.batch_shardings(ref_batch, ref_plan, ref_mesh)
        for k in batch:
            out[(name, "batch", k)] = (got[k], tuple(want[k].spec), tuple(batch[k].shape))
        got = _port_specs(SS.param_shardings(api, plan, mesh))
        want = _ref_specs(ref_ss.param_shardings(ref_api, ref_plan, ref_mesh))
        assert got == want, (name, "params")
        ref_cache = _ref_cache_abstract(ref_api, ref_cfg)
        cache = {k: (v if k == "index" else torch.empty(v.shape, device="meta"))
                 for k, v in ref_cache.items()}
        got = _port_specs(SS.cache_shardings(api, cache, plan, mesh))
        want = _ref_specs(ref_ss.cache_shardings(ref_api, ref_cache, ref_plan, ref_mesh))
        assert got == want, (name, "cache")
    return out


_INDEX_MAP_SCRIPT = r"""
import json, math, os, sys
import numpy as np
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d" % int(sys.argv[1])
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
req = json.load(sys.stdin)
shape = tuple(req["mesh"])
mesh = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape), tuple(req["axes"]))
order = {d.id: r for r, d in enumerate(mesh.devices.flat)}
out = []
for spec, gshape in req["cases"]:
    parts = [tuple(p) if isinstance(p, list) else p for p in spec]
    m = NamedSharding(mesh, P(*parts)).devices_indices_map(tuple(gshape))
    rows = [None] * len(order)
    for dev, idx in m.items():
        rows[order[dev.id]] = [[s.start or 0, gshape[i] if s.stop is None else s.stop]
                               for i, s in enumerate(idx)]
    out.append(rows)
json.dump(out, sys.stdout)
"""


def _reference_index_maps(mesh_shape, cases):
    """``NamedSharding(mesh, spec).devices_indices_map(shape)`` per case,
    as [start, stop) per dim per rank (rank = row-major mesh position)."""
    req = {"mesh": list(mesh_shape), "axes": list(MESHES[mesh_shape]),
           "cases": [[[list(p) if isinstance(p, tuple) else p for p in spec], list(shape)]
                     for spec, shape in cases]}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _INDEX_MAP_SCRIPT, str(math.prod(mesh_shape))],
                         input=json.dumps(req), capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


@pytest.mark.parametrize("mesh_shape", [(16, 16), (32, 8)])
def test_placements_match_reference_for_all_ten_configs(mesh_shape):
    """state / batch / param / cache shardings equal the reference's specs
    for all ten configs, full and reduced, under four plans; every distinct
    (spec, shape) of them places each of the mesh's ranks on the slice the
    reference's NamedSharding places that device on."""
    cases = {}
    for arch in sorted(ARCHS):
        for reduced in (False, True):
            for (plan, kind, key), (s, want, shape) in _placements(
                    arch, reduced, mesh_shape).items():
                assert tuple(s.spec) == want, (arch, reduced, plan, kind, key)
                cases[(tuple(s.spec), shape)] = s
    keys = sorted(cases, key=repr)
    maps = _reference_index_maps(mesh_shape, keys)
    for key, rows in zip(keys, maps):
        spec, shape = key
        for rank, row in enumerate(rows):
            mesh = _port_mesh(mesh_shape, rank)
            got = SH.Sharding(mesh, SH.P(*spec)).index(shape)
            assert [[s.start, s.stop] for s in got] == row, (spec, shape, rank)


def test_two_mesh_axes_on_one_dim_are_row_major_in_spec_order():
    """A dim split over ("pod", "data") or ("model", "data") is blocked
    row-major over the axes in the spec's order, as NamedSharding blocks it;
    DTensor's placements exist only for the mesh's own order."""
    shape = (2, 32, 8)
    specs = [SH.P(("pod", "data"), None), SH.P(("model", "data"), None),
             SH.P(("data", "model"), "pod"), SH.P("model", ("pod", "data"))]
    gshape = (512, 64)
    maps = _reference_index_maps(shape, [(s, gshape) for s in specs])
    for spec, rows in zip(specs, maps):
        for rank, row in enumerate(rows):
            got = SH.Sharding(_port_mesh(shape, rank), spec).index(gshape)
            assert [[s.start, s.stop] for s in got] == row, (spec, rank)
    from torch.distributed.tensor import Replicate, Shard
    mesh = _port_mesh(shape)
    assert SH.Sharding(mesh, specs[0]).placements() == (Shard(0), Shard(0), Replicate())
    assert SH.Sharding(mesh, specs[1]).placements() is None
    assert SH.Sharding(mesh, specs[3]).placements() == (Shard(1), Shard(1), Shard(0))


def test_sharded_init_draws_the_same_parameters_on_every_rank():
    """``init_state(shardings=)`` keeps each rank's slice of the parameters
    the unsharded init draws from the same seed, and a zero optimizer state
    of the slice's shape."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    api, tcfg = build_model(cfg), TrainConfig()
    whole = TS.init_state(api, tcfg, device="cpu")
    for rank in range(4):
        mesh = SH.Mesh(("data", "model"), (2, 2), rank=rank)
        sh = TS.state_shardings(api, tcfg, PORT_PLANS["expert_parallel_zero3"], mesh)
        part = TS.init_state(api, tcfg, device="cpu", shardings=sh)
        flat_sh = dict(C._flatten_with_paths(sh, is_leaf=lambda x: isinstance(x, SH.Sharding)))
        for (k, got), (_, want) in zip(C._flatten_with_paths(part),
                                       C._flatten_with_paths(whole)):
            s = flat_sh[k]
            if k.startswith("0/"):
                assert torch.equal(got, s.local(want)), (rank, k)
            else:
                assert got.shape == s.local_shape(want.shape) and not got.any(), (rank, k)
        assert part.params["blocks"]["moe"]["w_gate"].shape[1] == cfg.n_experts // 2


def test_production_mesh_is_the_cluster_shape():
    assert port_mesh.make_production_mesh().shape == {"data": 32, "model": 8}
    assert port_mesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 32, "model": 8}
    assert dict(lower_torch.h100_cluster().mesh_dims) == port_mesh.make_production_mesh().shape
    assert dict(lower_torch.h100_cluster(pods=2).mesh_dims) \
        == port_mesh.make_production_mesh(multi_pod=True).shape


def test_host_mesh_needs_a_process_group_and_a_card():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        port_mesh.make_host_mesh(1, 1)


# ------------------------------------------------------------ mesh planner
# tests/test_plancache.py's mesh-planning cells, and every registry shape
CELLS = [("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "decode_32k"),
         ("qwen3-moe-30b-a3b", "train_4k"), ("qwen3-moe-30b-a3b", "prefill_32k"),
         ("llama3-405b", "train_4k"), ("llama3-405b", "long_500k"),
         ("rwkv6-3b", "decode_32k"), ("zamba2-1.2b", "prefill_32k"),
         ("deepseek-moe-16b", "decode_32k"), ("seamless-m4t-medium", "train_4k")]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_mesh_on_the_tpu_pod_as_data_matches_reference(arch, shape, multi_pod):
    """Given ``tpu_v5e_pod`` as data, the port's planner ranks exactly as the
    reference does: names, dominant term, feasibility, notes, each cost
    within 1e-12 relative."""
    tcfg = dict(microbatches=4) if shape == "train_4k" else {}
    want = RB.plan_mesh(ref_build_model(ARCHS[arch]), REF_SHAPES[shape],
                        RefTrainConfig(**tcfg), multi_pod=multi_pod, cache=False)
    s = REF_SHAPES[shape]
    got = PB.plan_mesh(build_model(get_config(arch)),
                       ShapeConfig(s.name, s.seq_len, s.global_batch, s.kind),
                       TrainConfig(**tcfg), multi_pod=multi_pod, cache=False,
                       hw=tpu_v5e_pod(pods=2 if multi_pod else 1))
    assert [r.plan.name for r in got] == [r.plan.name for r in want]
    for g, w in zip(got, want):
        assert g.plan.rules == w.plan.rules
        assert (g.cost.dominant, g.cost.feasible, g.notes) == \
            (w.cost.dominant, w.cost.feasible, w.notes)
        for f in ("compute_s", "memory_s", "collective_s", "hbm_bytes_per_chip",
                  "collective_bytes", "total_s"):
            assert getattr(g.cost, f) == pytest.approx(getattr(w.cost, f), rel=1e-12, abs=0), f
        assert g.stats["n_candidates"] == w.stats["n_candidates"]
        assert g.stats["n_pruned"] == w.stats["n_pruned"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_mesh_ranks_every_cell_on_the_h100_cluster(arch, shape):
    """The default cluster is the H100 one: every candidate is estimated,
    the feasible ones ranked by total time, and feasibility is the 80 GB
    capacity rule (95 % of each card's HBM)."""
    s = REF_SHAPES[shape]
    api = build_model(get_config(arch))
    shape_cfg = ShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)
    ranked = PB.plan_mesh(api, shape_cfg, TrainConfig(), cache=False)
    hw = lower_torch.h100_cluster()
    assert hw.local_mem.size_bytes == 80e9
    feasible = [r for r in ranked if r.cost.feasible]
    assert feasible, [(r.plan.name, r.cost.hbm_bytes_per_chip) for r in ranked]
    assert [r.cost.total_s for r in feasible] == sorted(r.cost.total_s for r in feasible)
    for r in ranked:
        assert r.cost.feasible == (r.cost.hbm_bytes_per_chip <= 0.95 * 80e9), r.plan.name
        assert r.cost.feasible or "exceeds HBM" in r.notes
        again = PB.estimate_plan(api, shape_cfg, r.plan, TrainConfig(), hw=hw)
        assert again == r.cost
    n = len(PB.candidate_plans(api.cfg, shape_cfg))
    assert ranked[0].stats["n_candidates"] == n
    pruned = ranked[0].stats["n_pruned"]
    assert len(ranked) == min(3, n - pruned) + pruned
    assert pruned == sum(not r.cost.feasible for r in ranked)


def test_plan_mesh_reads_the_cluster_it_is_given():
    """Peak, HBM rate and size, link rates and mesh sizes come from the
    description: a card with half the HBM prunes more; the registry key
    holds the cluster, so the TPU's ranking is never served for the H100."""
    api = build_model(get_config("qwen3-moe-30b-a3b"))
    shape = ShapeConfig("t", 4096, 256, "train")
    h100 = lower_torch.h100_cluster()
    small = dataclasses.replace(h100, local_mem=dataclasses.replace(
        h100.local_mem, size_bytes=40 * 10 ** 9))
    big = PB.plan_mesh(api, shape, TrainConfig(), cache=False)
    half = PB.plan_mesh(api, shape, TrainConfig(), cache=False, hw=small)
    assert half[0].stats["n_pruned"] > big[0].stats["n_pruned"]
    tpu = tpu_v5e_pod()
    key = lambda hw: PB._mesh_key(api.cfg, shape, TrainConfig(), False, 3, hw)  # noqa: E731
    assert key(h100) != key(tpu) != key(small)
    r = PB.estimate_plan(api, shape, PORT_PLANS["megatron_tp"], TrainConfig(), hw=h100)
    flops = 6.0 * api.n_active_params() * 4096 * 256 + 2.0 * 3 * 256 * 4096 ** 2 * \
        api.cfg.n_heads * api.cfg.head_dim_ * api.cfg.n_layers * 0.5
    assert r.compute_s == pytest.approx(flops / (256 * 989e12), rel=1e-12)


def test_plan_mesh_caches_per_cluster(tmp_path, monkeypatch):
    from repro_torch import plancache
    monkeypatch.setenv(plancache.ENV_DIR, str(tmp_path))
    plancache.reset_store()
    try:
        api = build_model(get_config("qwen2.5-3b"))
        shape = ShapeConfig("cli", 4096, 256, "train")
        store = plancache.get_store()
        sources = []
        for hw in (None, None, tpu_v5e_pod(), tpu_v5e_pod()):
            with plancache.lookup_source(store) as probe:
                ranked = PB.plan_mesh(api, shape, TrainConfig(), hw=hw)
            sources.append(probe["source"])
        assert sources == ["search", "cache", "search", "cache"]
        many = PB.plan_mesh_many([("qwen2.5-3b", "train_4k")], TrainConfig(), workers=1)
        direct = PB.plan_mesh(api, shape, TrainConfig(), cache=False)
        assert [r.plan.name for r in many[0]] == [r.plan.name for r in direct]
        assert ranked[0].plan.name == RB.plan_mesh(
            ref_build_model(ARCHS["qwen2.5-3b"]), RefShape("cli", 4096, 256, "train"),
            RefTrainConfig(), cache=False)[0].plan.name
    finally:
        plancache.reset_store()


def test_collectives_map_one_to_one_onto_the_references():
    """``lower_reduction_bind`` / ``lower_forwarded_edge`` name the
    ``torch.distributed`` call that does what the reference's jax collective
    does, style by style; ``tileloom_view`` renders the reference's text on
    the TPU pod and names the H100 cluster's links by default."""
    from types import SimpleNamespace
    for style, ref_name in (("accum", "psum"), ("tree", "reduce_scatter"),
                            ("chain", "ppermute")):
        m = SimpleNamespace(reduce_binds=lambda: [SimpleNamespace(hw_dim="data", grid_dim="k")],
                            active_reduce_factor=lambda: 4, reduce_style=style)
        want, got = RB.lower_reduction_bind(m), PB.lower_reduction_bind(m)
        assert [w["collective"] for w in want] == [ref_name]
        assert [g["collective"] for g in got] == [PB.COLLECTIVE_OF[ref_name]]
        assert [dict(g, collective=None) for g in got] == [dict(w, collective=None)
                                                           for w in want]
    for fwd in (False, True):
        d = SimpleNamespace(forwarded=fwd, src="a", dst="b", tensor="t",
                            shuffle_axes=("data", "model"))
        want, got = RB.lower_forwarded_edge(d), PB.lower_forwarded_edge(d)
        assert [PB.COLLECTIVE_OF[c["collective"]] for c in want["collectives"]] \
            == [c["collective"] for c in got["collectives"]]
        assert dict(got, collectives=None) == dict(want, collectives=None)
    assert set(PB.COLLECTIVE_OF.values()) <= set(dir(torch.distributed))
    cfg = get_config("qwen2.5-3b")
    for name in PORT_PLANS:
        assert PB.tileloom_view(PORT_PLANS[name], cfg, hw=tpu_v5e_pod()).replace(
            "all_reduce", "psum") == RB.tileloom_view(REF_PLANS[name], ARCHS["qwen2.5-3b"])
    assert "%link_model" in PB.tileloom_view(PORT_PLANS["megatron_tp"], cfg)


def test_h100_cluster_describes_the_data_sheet_cluster():
    hw = lower_torch.h100_cluster()
    assert hw.n_cores == 256 and hw.peak_flops_per_core() == pytest.approx(989e12, rel=1e-12)
    assert hw.local_mem.bandwidth_gbps == 3350.0 and hw.local_mem.size_bytes == 80e9
    assert hw.interconnect_along("model").bandwidth_gbps == 450.0
    assert hw.interconnect_along("data").bandwidth_gbps == 50.0
    pods = lower_torch.h100_cluster(pods=2)
    assert pods.interconnect_along("pod").bandwidth_gbps == 25.0 and pods.n_cores == 512
    one = lower_torch.h100_cluster(1, 1)
    assert one.n_cores == 1 and one.interconnects == ()
    from repro_torch import plancache
    assert len({plancache.hw_digest(h) for h in (hw, pods, one, tpu_v5e_pod())}) == 4


def test_remat_recomputes_under_the_forwards_step_on_any_thread():
    """The autograd engine recomputes a checkpointed block on its own thread
    on the card; ``layers.remat`` enters the forward's step there, so the
    recomputation gathers and routes as the forward did."""
    import threading

    from repro_torch.models import layers as L
    from repro_torch.parallel import spmd
    step = spmd.Step(SH.megatron_tp_plan(), SH.Mesh(("data", "model"), (1, 1)), "data", 2)
    seen = []

    def block(w, x):
        seen.append((threading.current_thread().name, spmd.current()))
        return (x * w).sum()

    w = torch.ones(3, requires_grad=True)
    with spmd.step_context(step):
        out = L.remat(True, block, w, torch.arange(3.0))
    assert spmd.current() is None
    t = threading.Thread(target=out.backward, name="autograd-elsewhere")
    t.start()
    t.join()
    assert [s for _, s in seen] == [step, step]
    assert seen[1][0] == "autograd-elsewhere"
    assert torch.equal(w.grad, torch.arange(3.0))
