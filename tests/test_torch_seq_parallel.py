"""Plans that split the sequence, for the dense family, on the CPU over
``gloo`` ranks (``tests/torch_mesh_worker.py``, mode ``local``).

Under ``tp2d``, ``zero3_sp`` and ``sequence_parallel`` the plan maps ``seq``
and ``kv_seq`` to ``model`` ahead of the heads, ffn and vocabulary, so each
rank computes its block of the tokens: attention gathers K and V over
``model`` and runs K2 with the rank's query offset (context parallelism;
on the CPU K2's plain version, the worker's ``kernels: cuda``), and the
gradients and the loss are summed over ``model`` as over a batch axis.
Under ``tp2d`` the residual's ``embed`` is split over ``data`` too: the
products over ``embed`` are summed over ``data`` and no weight is gathered
over it.  Reduced llama3-405b (2 layers, d_model 128, 8 heads on 2 kv
heads) and reduced qwen2.5-3b (4 heads on 1 kv head, qkv bias, tied head)
run two train steps and a prompt pass through ``serve_step.jit_serve_step``
into an empty cache (split over ``kv_seq``) under ``tp2d`` and ``zero3_sp``
on 2x2 and ``sequence_parallel`` on 1x2, held against the port's
unsharded step and prefill in float32:

* every rank's loss within 1e-5 relative, every shard of the updated
  parameters within 1e-5 (learning rate 1e-4, as in
  ``test_torch_mesh_train.py``);
* the prefill's last-token logits within 2e-2, each rank's cache block
  equal to its block of the unsharded prefill's cache, and K2 called once a
  layer with the rank's query offset;
* the collective tally: under ``tp2d`` no all-gather on ``data``, and the
  all-gather bytes on ``model`` equal to a count by hand of the weights
  gathered over ``model`` (a layer's in its forward and again in its
  recomputation) plus K and V (gathered over the sequence, twice a layer);
  the K/V gathers' backward reduce-scatters on ``model``.

One more test holds the port's unsharded loss and gradients of reduced
llama3-405b against the reference's XLA path, on the same weights.
"""
import functools
import math
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference
from repro_torch.parallel import sharding as SH, spmd
from repro_torch.train import train_step as TS
from torch_mesh_worker import plan_named, spawn

B, S, STEPS, PROMPT = 2, 16, 2, 16
TCFG = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
F32 = (("param_dtype", "float32"),)
ARCHS = {"llama3-405b": (("n_heads", 8), ("n_kv_heads", 2)) + F32, "qwen2.5-3b": F32}


def _cfg(arch):
    return replace(get_config(arch).reduced(**dict(ARCHS[arch])), compute_dtype="float32",
                   kernels="cuda")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reduced model (K2's plain version through ``ops.attention``), its
    initial state from seed 0, the batches, a prompt, the unsharded steps'
    losses and final state, and the unsharded prefill of the prompt."""
    api = build_model(_cfg(arch))
    tcfg = TrainConfig(**TCFG)
    start = TS.init_state(api, tcfg, torch.Generator().manual_seed(0), device="cpu")
    source = pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=api.cfg.vocab_size), api.cfg)
    batches = [train_launch.to_device(source.batch_at(i, B, S), "cpu") for i in range(STEPS)]
    prompt = train_launch.to_device(source.batch_at(STEPS, B, PROMPT), "cpu")
    prompt.pop("labels")
    state = TS.init_state(api, tcfg, torch.Generator().manual_seed(0), device="cpu")
    step, losses = TS.make_train_step(api, tcfg), []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    cache = api.init_cache(api.cfg, B, PROMPT + 4, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, cache = api.prefill(start.params, prompt["tokens"], cache)
    return api, start, batches, prompt, losses, state, logits, cache


def _weights_over_model(cfg, m: int, e: int) -> int:
    """Float32 bytes of the weights a tp2d step gathers over ``model`` (``m``
    ranks), each with its ``embed`` dim split over ``data`` (``e`` ranks):
    a layer's (query and output projections, the kv projections where
    ``m`` divides the kv heads, the query bias, the MLP) in its forward and
    its recomputation, the embedding table and the untied head once."""
    d, hd, nh, nkv, f = cfg.d_model // e, cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    layer = 2 * d * nh * hd + 3 * d * f
    if nkv % m == 0:
        layer += 2 * d * nkv * hd
    if cfg.qkv_bias:
        layer += nh * hd
    head = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    return 4 * (2 * cfg.n_layers * layer + head)


def _kv_over_model(cfg) -> int:
    """Float32 bytes of K and V gathered over the sequence: (B, S, kv heads,
    head dim) each, in a layer's forward and recomputation."""
    return 4 * 2 * 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim_


def test_seq_axis_follows_the_plan():
    """The sequence axis is the one mesh axis the plan maps ``seq`` and
    ``kv_seq`` to, with ranks and not taken by the batch, dividing the
    sequence; ``embed`` is split besides only under tp2d; the local axis
    stays None for these plans (their heads, ffn and vocabulary are whole)."""
    mesh = SH.Mesh(("data", "model"), (2, 2))
    for name, seq, embed in (("tp2d", "model", "data"), ("zero3_sp", "model", None),
                             ("sequence_parallel", "model", None), ("megatron_tp", None, None),
                             ("zero3", None, None), ("kv_sequence_split", None, None),
                             ("pure_dp", None, None)):
        plan = plan_named(name)
        assert spmd.seq_axis_of(plan, mesh, 16) == seq, name
        assert spmd.embed_axis_of(plan, mesh, seq) == embed, name
        if seq:
            assert spmd.local_axis_of(plan, mesh, ("data",)) is None, name
    assert spmd.seq_axis_of(plan_named("tp2d"), mesh, 15) is None          # 2 does not divide 15
    assert spmd.seq_axis_of(plan_named("tp2d"), SH.Mesh(("data", "model"), (2, 1)), 16) is None
    assert [build_model(get_config(a).reduced()).sequence_split
            for a in ("llama3-405b", "gemma-7b", "qwen3-moe-30b-a3b", "internvl2-1b",
                      "rwkv6-3b", "zamba2-1.2b", "seamless-m4t-medium")] == [True] * 7


@pytest.mark.parametrize("mesh_shape,plans", [((2, 2), ("tp2d", "zero3_sp")),
                                              ((1, 2), ("sequence_parallel",))])
def test_sequence_split_steps_and_prefill_match_the_unsharded_step(mesh_shape, plans,
                                                                   tmp_path):
    cases = []
    for arch in ARCHS:
        _, start, batches, prompt, *_ = _setup(arch)
        for name, obj in (("state", start), ("batches", batches), ("prompt", prompt)):
            torch.save(obj, tmp_path / f"{name}-{arch}.pt")
        cases += [{"name": f"{arch}-{plan}", "arch": arch, "plan": plan,
                   "reduced": dict(ARCHS[arch]), "state": f"state-{arch}.pt",
                   "batches": f"batches-{arch}.pt", "prompt": f"prompt-{arch}.pt",
                   "steps": STEPS} for plan in plans]
    spawn({"mode": "local", "mesh": list(mesh_shape), "cases": cases, "tcfg": TCFG,
           "kernels": "cuda"}, tmp_path)
    for case in cases:
        arch, plan = case["arch"], case["plan"]
        api, _, _, _, want_losses, want, want_logits, want_cache = _setup(arch)
        cfg = api.cfg
        for rank in range(math.prod(mesh_shape)):
            got = torch.load(tmp_path / f"{case['name']}.rank{rank}.pt", weights_only=False)
            what = f"{case['name']} {mesh_shape} rank {rank}"
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
            # the prompt pass: this rank's token block, K2 at its offset
            o = got["coords"]["model"] * PROMPT // mesh_shape[1]
            assert got["q_offsets"] == [o] * cfg.n_layers, (what, got["q_offsets"])
            torch.testing.assert_close(got["prefill_logits"], want_logits, rtol=2e-2,
                                       atol=2e-2, msg=lambda m: f"{what} logits: {m}")
            assert got["cache_index"] == PROMPT
            c_sh = SH.Sharding(mesh, plan_named(plan).spec(
                ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                tuple(want_cache["k"].shape), mesh))
            assert c_sh.spec[2] == "model", (what, c_sh.spec)
            for name in ("k", "v"):
                torch.testing.assert_close(got["cache"][name], c_sh.local(want_cache[name]),
                                           rtol=1e-5, atol=1e-5,
                                           msg=lambda m: f"{what} cache {name}: {m}")
            # the collectives of the two train steps
            assert got["scattered"].get("model", 0.0) > 0.0, what
            if plan == "tp2d":
                assert got["gathered"].get("data", 0.0) == 0.0, (what, got["gathered"])
                assert got["reduced"].get("data", 0.0) > 0.0, what
                want_bytes = STEPS * (_weights_over_model(cfg, mesh_shape[1], mesh_shape[0])
                                      + _kv_over_model(cfg))
                assert got["gathered"].get("model", 0.0) == want_bytes, (what, got["gathered"])


_BACKWARD_OUTSIDE = r"""
import torch
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding as SH, spmd
dryrun.fake_world(2, 1)
mesh = dryrun.world_mesh(("data", "model"), (1, 2), 1)
step = spmd.Step(SH.sequence_parallel_plan(), mesh, None, 2, seq_axis="model")
x = torch.randn(2, 4, 3, requires_grad=True)
with spmd.step_context(step):
    assert spmd.seq_range(4) == (4, 4)
    y = spmd.gather_seq(x, 1, keep=8)
assert spmd.current() is None and y.shape == (2, 8, 3)
y.sum().backward()             # outside the step, as the card's autograd thread runs it
assert x.grad.shape == x.shape
print("ok")
"""


def test_gather_seq_backward_runs_outside_the_step_context():
    """The K/V gather's backward keeps its mesh: on the card the autograd
    engine runs it on its own thread, where no step is current (a no-op
    ``fake`` world of two ranks, in a subprocess: a pytest worker must not
    keep a default process group)."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-c", _BACKWARD_OUTSIDE], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), (r.stdout + r.stderr)[-3000:]


def test_reduced_llama3_405b_loss_and_gradients_match_the_reference():
    """The port's unsharded loss and gradients of reduced llama3-405b in
    float32, from the reference's initial weights (``models/convert.
    from_reference``), against the reference's ``jax.value_and_grad`` on its
    XLA path: the loss within 1e-5 relative, every gradient within 1e-4 of
    its leaf's largest entry."""
    overrides = dict(ARCHS["llama3-405b"])
    ref_cfg = replace(ref_get_config("llama3-405b").reduced(**overrides),
                      compute_dtype="float32")
    ref_api = ref_build_model(ref_cfg)
    api = build_model(replace(get_config("llama3-405b").reduced(**overrides),
                              compute_dtype="float32"))
    ref_params = ref_api.init(jax.random.PRNGKey(0))
    source = pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=ref_cfg.vocab_size),
                                  api.cfg)
    batch = source.batch_at(0, B, S)
    ref_batch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_api.loss_fn(p, ref_batch)[0]))(ref_params)
    params = from_reference(jax.tree.map(np.asarray, ref_params), "cpu")
    loss, _, grads = TS.value_and_grad(api, params, train_launch.to_device(batch, "cpu"))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    want = dict(C._flatten_with_paths(from_reference(jax.tree.map(np.asarray, ref_grads),
                                                     "cpu")))
    for k, g in C._flatten_with_paths(grads):
        scale = float(want[k].abs().max())
        torch.testing.assert_close(g, want[k], rtol=0, atol=1e-4 * max(scale, 1e-6),
                                   msg=lambda m: f"{k}: {m}")
