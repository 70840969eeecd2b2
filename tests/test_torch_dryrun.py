"""The port's cluster dry run, roofline and report against the reference's,
on the CPU.

* ``launch/roofline.py``: ``RooflineReport`` given ``core.hw.tpu_v5e_pod``
  as data (every collective byte on one axis) gives the reference's terms,
  dominant term, bound, useful ratio and roofline fraction to 1e-12;
  ``model_flops_estimate`` and ``trips_by_depth_for`` equal the reference's
  for all ten configs x four shapes.
* ``launch/dryrun.py``: ``run_cell`` as rank 0 of a ``fake`` world of 256
  ranks (a subprocess: a pytest worker must not keep a default process
  group) for reduced qwen2.5-3b at small train / prefill / decode shapes
  substituted through the registry.  Its rows carry the reference's keys,
  the mesh planner's ranking, the plan's TileLoom view (the reference's
  text on the TPU pod), and for the train cell counted flops equal to the
  hand count below.
* ``launch/report.py``: the same tables and summary as the reference's on
  the same rows.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import report as ref_report
from repro.launch import roofline as ref_rl
from repro.models import build_model as ref_build_model
from repro.parallel import planner_bridge as RB
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.hw import tpu_v5e_pod
from repro_torch.launch import dryrun, report, roofline as rl
from repro_torch.models import build_model
from repro_torch.parallel import planner_bridge as PB

ROOT = Path(__file__).resolve().parents[1]
ARCH, MOE = "qwen2.5-3b", "qwen3-moe-30b-a3b"
# small cells for the reduced model: 2 rows a rank on the 32 data ranks
SMALL = {"train_4k": ("train", 16, 64), "prefill_32k": ("prefill", 32, 32),
         "decode_32k": ("decode", 64, 128)}


# ---------------------------------------------------------------- roofline
@pytest.mark.parametrize("seed", range(6))
def test_roofline_on_the_tpu_pod_as_data_gives_the_reference_terms(seed):
    rng = np.random.default_rng(seed)
    flops, byts, coll, model = (float(x) for x in 10.0 ** rng.uniform(12, 19, 4))
    kinds = {"all-gather": coll / 2, "all-reduce": coll / 2, "_counts": {"all-gather": 3}}
    ref = ref_rl.RooflineReport("a", "s", "16x16", 256, flops, byts, coll, kinds, model)
    for by_axis in (None, {"model": coll}, {"data": coll}):
        got = rl.RooflineReport("a", "s", "16x16", 256, flops, byts, coll, kinds, model,
                                hw=tpu_v5e_pod(), coll_by_axis=by_axis)
        for name in ("compute_s", "memory_s", "collective_s", "bound_s",
                     "useful_flops_ratio", "roofline_fraction"):
            assert getattr(got, name) == pytest.approx(getattr(ref, name), rel=1e-12), name
        assert got.dominant == ref.dominant
        want_row = ref.row()
        assert set(want_row) <= set(got.row())
        for k, v in want_row.items():
            if isinstance(v, float):
                assert got.row()[k] == pytest.approx(v, rel=1e-12), k
            else:
                assert got.row()[k] == v, k


def test_roofline_divides_each_axis_bytes_by_its_link():
    """On the H100 cluster: NVLink along model, InfiniBand along data."""
    got = rl.RooflineReport("a", "s", "32x8", 256, 0.0, 0.0, 3e12, {}, 0.0,
                            coll_by_axis={"model": 1e12, "data": 2e12})
    assert got.hw.name == "h100_32x8"
    assert got.collective_s == pytest.approx(1e12 / (256 * 450e9) + 2e12 / (256 * 50e9),
                                             rel=1e-12)
    two = rl.RooflineReport("a", "s", "2x32x8", 512, 0.0, 0.0, 1e12, {}, 0.0,
                            coll_by_axis={"pod": 1e12})
    assert two.collective_s == pytest.approx(1e12 / (512 * 25e9), rel=1e-12)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_model_flops_and_trips_equal_the_reference(arch):
    ref_api, api = ref_build_model(REF_ARCHS[arch]), build_model(get_config(arch))
    for name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[name]
        for train in (False, True):
            assert rl.model_flops_estimate(api.n_active_params(), shape.global_batch, train) \
                == ref_rl.model_flops_estimate(ref_api.n_active_params(),
                                               ref_shape.global_batch, train)
        for mb in (1, 4):
            assert rl.trips_by_depth_for(get_config(arch), shape.kind, mb, shape.seq_len) == \
                ref_rl.trips_by_depth_for(REF_ARCHS[arch], ref_shape.kind, mb,
                                          ref_shape.seq_len)


# ------------------------------------------------------------------ dry run
_CELLS_SCRIPT = r"""
import json, sys
import torch.distributed as dist
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
req = json.loads(sys.argv[1])
for arch, _ in req["cells"]:
    registry.ARCHS[arch] = registry.ARCHS[arch].reduced()
for name, (kind, seq, batch) in req["shapes"].items():
    registry.SHAPES[name] = ShapeConfig(name, seq, batch, kind)
from pathlib import Path
for arch, name in req["cells"]:
    dryrun.run_cell(arch, name, False, out_dir=Path(req["out"]), device="cpu")
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_PLANNER_WORKERS="1",
               REPRO_PLAN_CACHE_DIR=str(out / "plancache"), OMP_NUM_THREADS="1")
    cells = [(ARCH, name) for name in SMALL] + [(MOE, "train_4k")]
    req = {"cells": cells, "shapes": SMALL, "out": str(out)}
    r = subprocess.run([sys.executable, "-c", _CELLS_SCRIPT, json.dumps(req)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    moe = out / f"{MOE}_train_4k_32x8.json"
    rows = {name: json.loads((out / f"{ARCH}_{name}_32x8.json").read_text())
            for name in SMALL}
    rows[MOE] = json.loads(moe.read_text())
    moe.rename(out.parent / moe.name)          # the report tables take qwen's three
    return out, rows


def _small(name):
    kind, seq, batch = SMALL[name]
    return ShapeConfig(name, seq, batch, kind)


def test_dry_run_rows_carry_the_reference_keys(rows):
    _, got = rows
    keys = {"arch", "shape", "mesh", "chips", "plan", "compile_s", "memory_analysis",
            "per_device_bytes", "fits_hbm", "planner_ranking", "tileloom_view", "roofline"}
    mem = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
           "generated_code_size_in_bytes", "alias_size_in_bytes"}
    roof = {"arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes", "coll_bytes",
            "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
            "useful_ratio", "roofline_fraction", "coll_by_kind", "coll_counts"}
    for name, row in got.items():
        assert keys <= set(row) and mem == set(row["memory_analysis"]), name
        assert roof <= set(row["roofline"]), name
        assert row["hw"] == "h100_32x8" and row["chips"] == 256 and "measured_ms" in row
        assert row["measured_ms"] is None and row["per_device_bytes"] is None  # the CPU
        assert row["roofline"]["hlo_flops"] > 0 and row["roofline"]["hlo_bytes"] > 0
    assert {"min_stream_bytes", "bw_fraction"} <= set(got["decode_32k"]["roofline"])
    assert dryrun.REPORT_DIR.parts[-2:] == ("reports", "dryrun_torch")


def test_dry_run_plan_is_the_mesh_planners_and_its_view_the_references(rows):
    _, got = rows
    cfg = replace(get_config(ARCH).reduced(), kernels="cuda")
    api = build_model(cfg)
    ref_cfg = REF_ARCHS[ARCH].reduced()
    for name in SMALL:
        row = got[name]
        ranked = PB.plan_mesh(api, _small(name), dryrun._train_cfg(ARCH), cache=False)
        assert [(r["plan"], r["dominant"], r["feasible"]) for r in row["planner_ranking"]] \
            == [(r.plan.name, r.cost.dominant, r.cost.feasible) for r in ranked]
        assert [r["total_s"] for r in row["planner_ranking"]] == \
            pytest.approx([r.cost.total_s for r in ranked], rel=1e-12)
        assert row["plan"] == ranked[0].plan.name
        plan = ranked[0].plan
        assert row["tileloom_view"] == PB.tileloom_view(plan, cfg)
        ref_plan = next(p for p in RB.candidate_plans(ref_cfg, REF_SHAPES[name])
                        if p.name == plan.name) if plan.name not in ("megatron_tp", "pure_dp") \
            else {"megatron_tp": RB.megatron_tp_plan, "pure_dp": RB.pure_dp_plan}[plan.name]()
        assert PB.tileloom_view(plan, cfg, hw=tpu_v5e_pod()).replace("all_reduce", "psum") \
            == RB.tileloom_view(ref_plan, ref_cfg)


def test_dry_run_train_flops_equal_the_hand_count(rows):
    """Reduced qwen2.5-3b (2 layers, d 128, 4 heads of 32 on 1 kv head, d_ff
    256, vocab 512, tied head), 2 rows of 16 tokens a rank, remat, under
    megatron_tp on 32x8: the 8 ``model`` ranks split the ffn columns and the
    vocabulary, which rank 0 computes locally (its 32 ffn columns, its 64
    vocabulary rows); the 4 query heads do not divide over 8 ranks, so
    attention stays whole.  Per row (16 tokens) and layer: projections P = 2
    x 16 x (128 x 128 q + 2 x 128 x 32 k, v + 128 x 128 o + 3 x 128 x 256 / 8
    MLP), the plain attention A = 4 x 4 heads x 16 x 16 x 32 (every pair:
    the CPU's plain version masks after the product), the down projection
    D = 2 x 16 x 256 / 8 x 128.  Head H = 2 x 16 x 128 x 512 / 8.  A step:
    the forward (P + A per layer, H),
    the recomputation (P - D + A: torch's checkpoint stops after the last
    saved activation, so the block's down projection is not recomputed), the
    backward (2 P, 2.5 A: K2-bwd's plain version computes the scores again,
    five products for the forward's two; 2 H)."""
    _, got = rows
    P = 2 * 16 * (128 * 128 + 2 * 128 * 32 + 128 * 128 + 3 * 128 * 256 / 8)
    A = 4 * 4 * 16 * 16 * 32
    D = 2 * 16 * 256 / 8 * 128
    H = 2 * 16 * 128 * 512 / 8
    layers = 2
    per_row = layers * ((P + A) + (P - D + A) + (2 * P + 2.5 * A)) + 3 * H
    want = 2 * per_row
    row = got["train_4k"]
    counted = row["counted"]["torch_flops"] + row["counted"]["kernel_flops"]
    assert counted == pytest.approx(want, rel=1e-2)
    assert row["roofline"]["hlo_flops"] == pytest.approx(counted * 256, rel=1e-12)
    assert row["microbatches"] == 2


def test_dry_run_moe_train_cell_runs_microbatches_through_the_expert_parallel_branch(rows):
    """The MoE's train cell: expert_parallel, 2 rows a rank in microbatches
    of 1 (the step's batch check is a microbatch's rows), K4's launches
    counted as plain products on the CPU, an all-reduce over the expert
    axis."""
    _, got = rows
    row = got[MOE]
    assert row["plan"] == "expert_parallel" and row["microbatches"] == 2
    assert row["collectives"]["counts"]["all-reduce"] > 0
    assert row["roofline"]["coll_by_axis"]["model"] > 0


def test_dry_run_counts_collectives_by_kind_and_axis(rows):
    _, got = rows
    for name, row in got.items():
        by_kind = row["roofline"]["coll_by_kind"]
        assert by_kind, name
        coll = row["collectives"]
        assert sum(sum(v.values()) for v in coll["bytes"].values()) * 256 == \
            pytest.approx(row["roofline"]["coll_bytes"], rel=1e-12)
        assert set(row["roofline"]["coll_by_axis"]) <= {"data", "model"}
    assert got["train_4k"]["collectives"]["counts"]["all-reduce"] > 0


# ------------------------------------------------------------------- report
def test_report_tables_equal_the_references_on_the_same_rows(rows, monkeypatch):
    out, _ = rows
    monkeypatch.setattr(report, "REPORT_DIR", out)
    monkeypatch.setattr(ref_report, "REPORT_DIR", out)
    assert report.ARCH_ORDER == ref_report.ARCH_ORDER
    assert report.SHAPE_ORDER == ref_report.SHAPE_ORDER
    assert len(report.load_rows("32x8")) == 3
    assert report.roofline_table("32x8") == ref_report.roofline_table("32x8")
    assert report.dryrun_table("32x8") == ref_report.dryrun_table("32x8")
    assert report.summary_stats("32x8") == ref_report.summary_stats("32x8")
    assert report.load_rows() == report.load_rows("32x8")


# ------------------------------------------------------------- input specs
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_input_specs_equal_the_references(arch):
    """``ModelAPI.input_specs`` for every shape: meta tensors with the
    reference's shapes and dtypes (its ``jax.ShapeDtypeStruct``s), the
    decode cache as ``init_cache`` on ``meta`` with a Python-int index."""
    ref_api, api = ref_build_model(REF_ARCHS[arch]), build_model(get_config(arch))
    for name, shape in SHAPES.items():
        want, got = ref_api.input_specs(REF_SHAPES[name]), api.input_specs(shape)
        if shape.kind == "decode":
            want, got = dict(want["cache"], tokens=want["tokens"]), \
                dict(got["cache"], tokens=got["tokens"])
            assert got.pop("index") == 0 and want.pop("index").shape == ()
        assert set(got) == set(want), (arch, name)
        for k, w in want.items():
            assert got[k].device.type == "meta", (arch, name, k)
            assert tuple(got[k].shape) == tuple(w.shape), (arch, name, k)
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), (arch, name, k)
