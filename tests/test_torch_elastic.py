"""The port's elastic rescale against the reference's, on the CPU: the
reference's scenarios (``tests/test_substrate.py``) through both packages,
the plan chosen on the TPU pod given as data equal to the reference's, and
``apply_rescale`` placing each rank's slice of a gathered tree bit-equal."""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs.base import ShapeConfig as RefShape, TrainConfig as RefTrainConfig
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.models import build_model as ref_build_model
from repro.runtime import elastic as ref_elastic
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.hw import tpu_v5e_pod
from repro_torch.models import build_model
from repro_torch.parallel import sharding as SH
from repro_torch.runtime import elastic
from repro_torch.train import train_step as TS


@pytest.mark.parametrize("n", [1, 7, 8, 12, 192, 256, 512])
def test_viable_mesh_shapes_match_reference(n):
    assert elastic.viable_mesh_shapes(n) == ref_elastic.viable_mesh_shapes(n)
    assert elastic.viable_mesh_shapes(256)[0] == (16, 16)


SCENARIOS = {
    # tests/test_substrate.py: test_plan_rescale_shrink
    "shrink": ("qwen2.5-3b", REF_SHAPES["train_4k"], dict(microbatches=4), 256, 192),
    # tests/test_substrate.py: test_plan_rescale_batch_divisibility_fallback
    "odd_batch": ("qwen2.5-3b", RefShape("odd_batch", seq_len=128, global_batch=3,
                                         kind="train"), dict(microbatches=1), 16, 8),
    "grow_moe": ("qwen3-moe-30b-a3b", REF_SHAPES["train_4k"], {}, 128, 256),
    "prime_batch": ("qwen2.5-3b", RefShape("prime", seq_len=128, global_batch=7,
                                          kind="train"), {}, 8, 6),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plan_rescale_matches_reference(name):
    """Mesh shape, batch note and ranking equal the reference's with the
    TPU pod given as data; on the default H100 cluster the mesh shape and
    note are the same and the plan is the cluster's first."""
    arch, s, tc, old, new = SCENARIOS[name]
    want = ref_elastic.plan_rescale(ref_build_model(ARCHS[arch]), s, RefTrainConfig(**tc),
                                    old_devices=old, new_devices=new)
    api = build_model(get_config(arch))
    shape = ShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)
    got = elastic.plan_rescale(api, shape, TrainConfig(**tc), old_devices=old,
                               new_devices=new, hw=tpu_v5e_pod())
    for f in ("old_devices", "new_devices", "mesh_shape", "mesh_axes", "plan_name",
              "batch_note"):
        assert getattr(got, f) == getattr(want, f), f
    assert [r.plan.name for r in got.ranking] == [r.plan.name for r in want.ranking]
    h100 = elastic.plan_rescale(api, shape, TrainConfig(**tc), old_devices=old,
                                new_devices=new)
    assert (h100.mesh_shape, h100.batch_note) == (want.mesh_shape, want.batch_note)
    assert h100.plan_name == h100.ranking[0].plan.name
    assert s.global_batch % h100.mesh_shape[0] == 0 or h100.batch_note
    if name == "odd_batch":
        assert got.mesh_shape == (1, 8) and got.batch_note == ""
    if name == "prime_batch":
        assert got.mesh_shape == (1, 6) and got.batch_note == ""


def _sharding_leaf(x) -> bool:
    return isinstance(x, SH.Sharding)


@pytest.mark.parametrize("plan", ["megatron_tp", "expert_parallel", "pure_dp"])
def test_apply_rescale_places_each_ranks_slice(plan):
    """A gathered host train state (parameters, moments, step) resharded
    onto a 2x2 mesh: every rank's leaf is a contiguous copy equal to the
    slice its Sharding names, bit for bit (a dim over two mesh axes
    included), and the ranks' slices cover every element as many times as
    the plan replicates it."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    api, tcfg = build_model(cfg), TrainConfig()
    state = TS.init_state(api, tcfg, device="cpu")
    full = C._flatten_with_paths(state)
    for i, (_, t) in enumerate(full):
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(i)).to(t.dtype))
    cover = {k: torch.zeros(t.shape, dtype=torch.int32) for k, t in full}
    for rank in range(4):
        mesh = SH.Mesh(("data", "model"), (2, 2), rank=rank)
        sh = TS.state_shardings(api, tcfg, SH.FIXED_PLANS[plan](), mesh)
        local = dict(C._flatten_with_paths(elastic.apply_rescale(state, sh)))
        by_key = dict(C._flatten_with_paths(sh, is_leaf=_sharding_leaf))
        for k, t in full:
            idx = by_key[k].index(t.shape)
            assert local[k].is_contiguous() and local[k].data_ptr() != t.data_ptr()
            assert torch.equal(local[k], t[idx]), (rank, k)
            cover[k][idx] += 1
    sh = TS.state_shardings(api, tcfg, SH.FIXED_PLANS[plan](),
                            SH.Mesh(("data", "model"), (2, 2)))
    split = 0
    for k, s in C._flatten_with_paths(sh, is_leaf=_sharding_leaf):
        reps = 4 // int(np.prod([s.mesh.shape[a] for a in s.mesh_axes()] or [1]))
        assert bool((cover[k] == reps).all()), k
        split += reps < 4
    assert split > 0 or plan == "pure_dp"


def test_apply_rescale_keeps_unsharded_leaves_and_moves_to_the_device():
    tree = {"w": torch.arange(12.0).view(3, 4), "s": torch.tensor(3)}
    mesh = SH.Mesh(("data", "model"), (1, 2), rank=1)
    out = elastic.apply_rescale(tree, {"w": SH.Sharding(mesh, SH.P(None, "model")), "s": None},
                                device="cpu")
    assert torch.equal(out["w"], tree["w"][:, 2:]) and out["s"] is tree["s"]
    np_out = elastic.apply_rescale({"w": np.ones((2, 2), np.float32)},
                                   {"w": SH.Sharding(mesh, SH.P("model", None))})
    assert torch.equal(np_out["w"], torch.ones(1, 2))
