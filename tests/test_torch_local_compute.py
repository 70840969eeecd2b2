"""Head-, ffn- and vocabulary-local compute of plan-sharded training and
prefill, on the CPU over ``gloo`` ranks (``tests/torch_mesh_worker.py``,
mode ``local``).

Under ``megatron_tp``, ``zero3`` and ``expert_parallel`` each rank computes
its query heads and the kv heads they read, its ffn columns and its
vocabulary block (``parallel/spmd.py``, ``models/layers.py``).  Reduced
qwen2.5-3b (4 query heads on 1 kv head: the kv heads do not divide over the
ranks, so every rank projects the one kv head its query heads read) and
reduced gemma-7b (4 heads, MHA, GeGLU, tied head: kv heads split with the
query heads) run two steps on 1x2 and 2x2 meshes, then one prefill pass of
a prompt through ``serve_step.jit_serve_step``; so do reduced internvl2-1b
(the VLM: stub patches ahead of the prompt) under megatron_tp, and on 1x2
the two MoEs under expert_parallel (their attention, deepseek-moe's shared
MLP and the untied head local; on 1x2 the expert-parallel branch routes the
whole batch, as the unsharded step does).  Held against the port's
unsharded step and prefill, in float32:

* every rank's loss within 1e-5 relative, every shard of the updated
  parameters within 1e-5 (learning rate 1e-4, as in
  ``test_torch_mesh_train.py``);
* the prefill's last-token logits within 2e-2, and each rank's cache slice
  equal to its slice of the unsharded cache (its kv heads, or every kv head
  where the cache is whole);
* the collective tally: no all-gather on ``model`` (the head, ffn and
  vocabulary leaves stay split; qwen's kv projection is replicated; only
  the MoE's router is gathered), and all-reduces on ``model`` (the
  row-parallel products, the embedding and the cross-entropy's
  reductions);
* qwen under megatron_tp with int8 gradient compression: the losses within
  1e-5 relative of the unsharded int8 step (its state is held elementwise on
  the whole-activation path, ``test_torch_mesh_train.py``: a product summed
  in parts moves the odd gradient entry across a quantisation boundary).
"""
import functools
import math
from dataclasses import replace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.ckpt import checkpoint as C
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.parallel import sharding as SH, spmd
from repro_torch.train import train_step as TS
from torch_mesh_worker import plan_named, spawn

B, S, STEPS, PROMPT = 4, 16, 2, 12
TCFG = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
CASES = [(arch, plan) for arch in ("qwen2.5-3b", "gemma-7b") for plan in ("megatron_tp", "zero3")]
CASES += [("internvl2-1b", "megatron_tp")]
MOE_CASES = [("qwen3-moe-30b-a3b", "expert_parallel"), ("deepseek-moe-16b", "expert_parallel")]
INT8 = (("grad_compression", "int8"), ("learning_rate", 1e-5))


@functools.lru_cache(maxsize=None)
def _setup(arch, extra=()):
    """The reduced model in float32, its initial state from seed 0 (under
    TCFG with ``extra``), the batches, a prompt (with its frontend input),
    and the unsharded steps' losses and final state."""
    api = build_model(replace(get_config(arch).reduced(), compute_dtype="float32"))
    tcfg = TrainConfig(**dict(TCFG, **dict(extra)))
    gen = torch.Generator().manual_seed(0)
    start = TS.init_state(api, tcfg, gen, device="cpu")
    source = pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=api.cfg.vocab_size), api.cfg)
    batches = [train_launch.to_device(source.batch_at(i, B, S), "cpu") for i in range(STEPS)]
    prompt = train_launch.to_device(source.batch_at(STEPS, B, PROMPT), "cpu")
    prompt.pop("labels")
    state = TS.init_state(api, tcfg, torch.Generator().manual_seed(0), device="cpu")
    step, losses = TS.make_train_step(api, tcfg), []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return api, start, batches, prompt, losses, state


@functools.lru_cache(maxsize=None)
def _prefill(arch):
    """The unsharded prefill of the prompt from the initial parameters."""
    api, start, _, prompt, _, _ = _setup(arch)
    inputs = dict(prompt)
    tokens = inputs.pop("tokens")
    cache = api.init_cache(api.cfg, B, api.prefix_len() + PROMPT + 4, dtype=torch.float32,
                           device="cpu")
    with torch.no_grad():
        logits, cache = api.prefill(start.params, tokens, cache, **inputs)
    return logits, cache


def test_local_axis_follows_the_plan():
    """The local axis is the one mesh axis the plan maps heads, ffn and
    vocabulary to, when it has ranks and splits neither the batch nor the
    sequence; where the plan splits the sequence (tp2d, zero3_sp) the step
    has a sequence axis instead (``tests/test_torch_seq_parallel.py``).
    ``spmd.whole_activations`` takes both away."""
    mesh = SH.Mesh(("data", "model"), (2, 2))
    for name, want, seq in (("megatron_tp", "model", None), ("zero3", "model", None),
                            ("expert_parallel", "model", None), ("tp2d", None, "model"),
                            ("zero3_sp", None, "model"), ("pure_dp", None, None)):
        assert spmd.local_axis_of(plan_named(name), mesh, ("data",)) == want, name
        assert spmd.seq_axis_of(plan_named(name), mesh, S) == seq, name
    assert spmd.local_axis_of(plan_named("megatron_tp"), SH.Mesh(("data", "model"), (2, 1)),
                              ("data",)) is None
    # the tests' whole-activation layout: no local axis and no sequence axis
    with spmd.whole_activations():
        assert spmd.local_axis_of(plan_named("megatron_tp"), mesh, ("data",)) is None
        assert spmd.seq_axis_of(plan_named("tp2d"), mesh, S) is None
    assert spmd.local_axis_of(plan_named("megatron_tp"), mesh, ("data",)) == "model"


@pytest.mark.parametrize("case", [
    ((0, 2, 4), (0, 1, None, 2)),        # qwen2.5-3b-like: 2 query heads share one kv head
    ((2, 2, 4), (0, 1, None, 2)),
    ((4, 8, 4), (1, 3, None, 4)),        # whole groups
    ((3, 3, 2), (1, 3, [0, 1, 1], 1)),   # a block that cuts a group: one kv head a query head
])
def test_local_kv_heads_are_those_the_local_query_heads_read(case):
    """Query head h reads kv head h // G; a rank's block of query heads reads
    the kv heads [lo, hi), each ``q_per_kv`` consecutive query heads, or
    through an index when its block does not cover whole groups."""
    from repro_torch.models.layers import _local_kv_heads
    (h0, hl, G), want = case
    assert _local_kv_heads(h0, hl, G) == want
    lo, hi, index, g = want
    read = [lo + (index[j] if index else j // g) for j in range(hl)]
    assert read == [(h0 + j) // G for j in range(hl)]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_head_ffn_and_vocab_local_steps_match_the_unsharded_step(mesh_shape, tmp_path):
    cases = []
    checked = CASES + (MOE_CASES if mesh_shape == (1, 2) else [])
    for arch, plan in checked:
        _, start, batches, prompt, _, _ = _setup(arch)
        for name, obj in (("state", start), ("batches", batches), ("prompt", prompt)):
            torch.save(obj, tmp_path / f"{name}-{arch}.pt")
        cases.append({"name": f"{arch}-{plan}", "arch": arch, "plan": plan,
                      "state": f"state-{arch}.pt", "batches": f"batches-{arch}.pt",
                      "prompt": f"prompt-{arch}.pt", "steps": STEPS})
    torch.save(_setup("qwen2.5-3b", INT8)[1], tmp_path / "state-int8.pt")
    cases.append({"name": "int8", "arch": "qwen2.5-3b", "plan": "megatron_tp",
                  "state": "state-int8.pt", "batches": "batches-qwen2.5-3b.pt",
                  "prompt": "prompt-qwen2.5-3b.pt", "steps": STEPS, "tcfg": dict(INT8)})
    spawn({"mode": "local", "mesh": list(mesh_shape), "cases": cases, "tcfg": TCFG}, tmp_path)
    int8_losses = _setup("qwen2.5-3b", INT8)[4]
    for rank in range(math.prod(mesh_shape)):
        got = torch.load(tmp_path / f"int8.rank{rank}.pt", weights_only=False)
        assert got["gathered"].get("model", 0.0) == 0.0
        assert [h["loss"] for h in got["history"]] == pytest.approx(int8_losses, rel=1e-5)
    for arch, plan in checked:
        api, _, _, _, want_losses, want = _setup(arch)
        want_logits, want_cache = _prefill(arch)
        for rank in range(math.prod(mesh_shape)):
            got = torch.load(tmp_path / f"{arch}-{plan}.rank{rank}.pt", weights_only=False)
            what = f"{arch} {plan} {mesh_shape} rank {rank}"
            assert [h["loss"] for h in got["history"]] == pytest.approx(want_losses,
                                                                          rel=1e-5), what
            mesh = SH.Mesh(("data", "model"), mesh_shape, rank=rank)
            sh = dict(C._flatten_with_paths(
                TS.state_shardings(api, TrainConfig(**TCFG), plan_named(plan), mesh),
                is_leaf=lambda x: isinstance(x, SH.Sharding)))
            have = dict(C._flatten_with_paths(got["state"].params))
            for k, w in C._flatten_with_paths(want.params):
                assert have[k].shape == sh["0/" + k].local_shape(w.shape), (what, k)
                torch.testing.assert_close(have[k], sh["0/" + k].local(w), rtol=0, atol=1e-5,
                                           msg=lambda m: f"{what} {k}: {m}")
            # no head, ffn or vocabulary leaf is gathered over model; the
            # MoE's float32 router (embed x experts) is, where each layer
            # runs: the forward and the recomputation of every step
            router = api.cfg.d_model * (api.cfg.n_experts or 0) * 4
            assert got["gathered"].get("model", 0.0) == \
                router * api.cfg.n_layers * 2 * STEPS, (what, got["gathered"])
            assert got["reduced"].get("model", 0.0) > 0.0, what
            torch.testing.assert_close(got["prefill_logits"], want_logits, rtol=2e-2,
                                       atol=2e-2, msg=lambda m: f"{what} logits: {m}")
            assert got["cache_index"] == api.prefix_len() + PROMPT
            c_sh = SH.Sharding(mesh, plan_named(plan).spec(
                ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                tuple(want_cache["k"].shape), mesh))
            for name in ("k", "v"):
                torch.testing.assert_close(got["cache"][name], c_sh.local(want_cache[name]),
                                           rtol=1e-5, atol=1e-5,
                                           msg=lambda m: f"{what} cache {name}: {m}")
