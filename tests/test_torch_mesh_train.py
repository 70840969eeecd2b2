"""Plan-sharded training of the port over several ranks, on the CPU.

Each test starts one ``gloo`` rank per mesh position
(``tests/torch_mesh_worker.py``, a ``file://`` store under ``tmp_path``: no
port, no network), all running ``train_step.jit_train_step`` on their shards
for two steps, the plans looped inside one start per mesh shape.  Every rank
starts from the reference's initial weights (``init_state`` of the reference,
carried across as ``train_state_from_reference`` does), whole, which the step
slices as ``jax.jit``'s in_shardings would.  The results are held here:

* the loss of each step within 1e-5 relative of the port's unsharded step,
  and within 1e-4 of the reference's (its XLA ``make_train_step``);
* every rank's updated shards equal to the matching slice of the unsharded
  state within 1e-5 (at learning rate 1e-4: an entry whose gradient is zero
  in exact arithmetic, such as the key bias under softmax's shift
  invariance, moves by lr x sign(rounding noise) under AdamW);
* split leaves under Adafactor (float32 and bfloat16 state) and AdamW with
  int8 compression on 2x2: every rank's shards of the whole state
  (parameters, factored moments, residual) equal the unsharded step's;
* ``zero3_sp`` and ``tp2d`` (the sequence over ``model``) run the dense
  model on each rank's token block (``tests/test_torch_seq_parallel.py``)
  and again on the whole-activation path, both held as above;
* the MoE's expert-parallel branch taken with each rank's expert slice,
  split exactly when the ``model`` axis holds more than one rank; under
  ``pure_dp`` (no expert axis) the MoE gathers the global batch and
  matches the unsharded step.

Where the batch is split (``data`` > 1), the MoE's expert-parallel branch
routes, caps and balances each batch shard's tokens by themselves, as the
reference's ``shard_map`` does (its capacity is that of the local tokens and
its load-balancing loss the mean of the shards'): the oracle is then the
unsharded step's loss and gradient averaged over the batch shards, in both
packages.  The dense model's mean loss is the same either way.
"""
import functools
import math
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import build_model as ref_build_model
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.parallel import sharding as SH
from repro_torch.train import optimizer as opt, train_step as TS
from torch_mesh_worker import plan_named, spawn

B, S, STEPS = 4, 16, 2
TCFG = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
DENSE, MOE = "qwen2.5-3b", "qwen3-moe-30b-a3b"
CASES = [(DENSE, p) for p in ("megatron_tp", "zero3", "pure_dp", "zero3_sp", "tp2d")] + \
        [(MOE, p) for p in ("expert_parallel", "expert_parallel_zero3", "pure_dp")]
# the plans that split the sequence run the dense model on its rank's tokens
# (above) and, as a case of its own, on the whole-activation path (the
# worker's "local_compute": false): each case's name and its worker options
RUNS = [(arch, plan, f"{arch}-{plan}", {}) for arch, plan in CASES] + \
       [(DENSE, p, f"{DENSE}-{p}-whole", {"local_compute": False})
        for p in ("zero3_sp", "tp2d")]


def _spawn(job: dict, tmp_path: Path) -> None:
    spawn(dict(job, tcfg=TCFG), tmp_path)


# ----------------------------------------------------------------- oracles
@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reduced model in float32 in both packages, the reference's
    initial state, its port counterpart and the batches."""
    ref_cfg = replace(ref_get_config(arch).reduced(), compute_dtype="float32")
    cfg = replace(get_config(arch).reduced(), compute_dtype="float32")
    ref_api, api = ref_build_model(ref_cfg), build_model(cfg)
    ref_state = ref_ts.init_state(ref_api, RefTrainConfig(**TCFG), jax.random.PRNGKey(0))
    source = pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=cfg.vocab_size), cfg)
    batches = [source.batch_at(i, B, S) for i in range(STEPS)]
    return ref_api, api, ref_state, batches


def _port_state(arch):
    _, _, ref_state, _ = _pair(arch)
    opt_np = {k: jax.tree.map(np.asarray, v) for k, v in ref_state.opt_state._asdict().items()}
    return TS.train_state_from_reference(jax.tree.map(np.asarray, ref_state.params), opt_np,
                                         None, "cpu")


def _rows(batch, dp, i):
    n = batch["tokens"].shape[0] // dp
    return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _port_oracle(arch, dp):
    """The port's unsharded steps; with ``dp`` > 1 the loss and gradient
    averaged over the batch shards before the optimizer."""
    _, api, _, batches = _pair(arch)
    tcfg = TrainConfig(**TCFG)
    state, losses = _port_state(arch), []
    step = TS.make_train_step(api, tcfg)
    for b in batches:
        b = train_launch.to_device(b, "cpu")
        if dp == 1:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            continue
        grads, loss = TS.zero_grads(state.params, torch.float32), 0.0
        for i in range(dp):
            loss += float(TS.accumulate_grad(api, state.params, _rows(b, dp, i), grads)[0]) / dp
        for g in opt._leaves(grads):
            g.div_(dp)
        params, opt_state, _ = opt.opt_update(grads, state.opt_state, state.params, tcfg)
        state = TS.TrainState(params, opt_state)
        losses.append(loss)
    return state, losses


@functools.lru_cache(maxsize=None)
def _ref_losses(arch, dp):
    """The reference's unsharded steps (its XLA path), the same way."""
    ref_api, _, ref_state, batches = _pair(arch)
    tcfg = RefTrainConfig(**TCFG)
    step = jax.jit(ref_ts.make_train_step(ref_api, tcfg))
    vg = jax.jit(jax.value_and_grad(lambda p, b: ref_api.loss_fn(p, b)[0]))
    state, losses = ref_state, []
    for b in batches:
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if dp == 1:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            continue
        parts = [vg(state.params, _rows(b, dp, i)) for i in range(dp)]
        grads = jax.tree.map(lambda *g: sum(g) / dp, *[g for _, g in parts])
        params, opt_state, _ = ref_opt.opt_update(grads, state.opt_state, state.params, tcfg)
        state = ref_ts.TrainState(params, opt_state, None)
        losses.append(float(sum(l for l, _ in parts)) / dp)
    return losses


def _batch_shards(plan_name, mesh_shape):
    mesh = SH.Mesh(("data", "model"), mesh_shape)
    spec = TS.batch_shardings({"tokens": torch.empty(B, S, device="meta")},
                              plan_named(plan_name), mesh)["tokens"].spec
    return math.prod(mesh.shape[a] for a in SH.part_axes(spec[0]))


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_jit_train_step_over_gloo_ranks_matches_unsharded_and_reference(mesh_shape, tmp_path):
    cases = []
    for arch in (DENSE, MOE):
        torch.save(_port_state(arch), tmp_path / f"state-{arch}.pt")
    torch.save([train_launch.to_device(b, "cpu") for b in _pair(DENSE)[3]],
               tmp_path / "batches.pt")
    for arch, plan, name, extra in RUNS:
        cases.append(dict({"name": name, "arch": arch, "plan": plan,
                           "state": f"state-{arch}.pt", "steps": STEPS}, **extra))
    # both models' batches are the same draws
    for a, b in zip(_pair(MOE)[3], _pair(DENSE)[3]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    _spawn({"mode": "train", "mesh": list(mesh_shape), "cases": cases}, tmp_path)
    world = math.prod(mesh_shape)
    for arch, plan, name, _ in RUNS:
        dp = _batch_shards(plan, mesh_shape)
        # the expert-parallel branch works per batch shard; pure_dp maps no
        # experts, so the MoE dispatches the global batch, as unsharded
        oracle_dp = dp if arch == MOE and plan_named(plan).mesh_axes("experts") else 1
        want_state, want_losses = _port_oracle(arch, oracle_dp)
        ref_losses = _ref_losses(arch, oracle_dp)
        api = _pair(arch)[1]
        E = api.cfg.n_experts
        for rank in range(world):
            got = torch.load(tmp_path / f"{name}.rank{rank}.pt", weights_only=False)
            losses = [h["loss"] for h in got["history"]]
            assert losses == pytest.approx(want_losses, rel=1e-5), (plan, rank)
            assert losses == pytest.approx(ref_losses, rel=1e-4, abs=1e-4), (plan, rank)
            mesh = SH.Mesh(("data", "model"), mesh_shape, rank=rank)
            sh = TS.state_shardings(api, TrainConfig(**TCFG), plan_named(plan), mesh)
            by_key = dict(C._flatten_with_paths(sh, is_leaf=lambda x: isinstance(x, SH.Sharding)))
            for k, w in C._flatten_with_paths(want_state.params):
                g = dict(C._flatten_with_paths(got["state"].params))[k]
                assert g.shape == by_key["0/" + k].local_shape(w.shape), (plan, rank, k)
                torch.testing.assert_close(g, by_key["0/" + k].local(w), rtol=0, atol=1e-5,
                                           msg=lambda m: f"{plan} rank {rank} {k}: {m}")
            assert int(got["state"].opt_state.step) == STEPS
            assert got["dtensor_checked"] > 0
            if arch == MOE and plan == "pure_dp":
                assert got["ep_trace"] == []
            elif arch == MOE:
                ep = mesh_shape[1]
                m = got["coords"]["model"]
                assert got["ep_trace"] and set(got["ep_trace"]) == {(m * E // ep, E // ep)}
                assert (E // ep < E) == (ep > 1)
            else:
                assert got["ep_trace"] == []


def test_sharded_checkpoint_saved_on_one_mesh_restores_on_another(tmp_path):
    """A state trained one step on a 1x2 mesh is saved fully gathered (rank
    0 writes, in the reference's format) and restored onto a 2x1 mesh with
    ``restore(shardings=)``: every rank's leaves are bit-equal to its slice
    of the gathered checkpoint, which is the 1x2 ranks' shards put
    together."""
    torch.save(_port_state(MOE), tmp_path / "state.pt")
    torch.save([train_launch.to_device(b, "cpu") for b in _pair(MOE)[3]],
               tmp_path / "batches.pt")
    case = {"name": "ckpt", "arch": MOE, "plan": "expert_parallel_zero3", "state": "state.pt",
            "steps": 1}
    ckpt = str(tmp_path / "ckpt")
    _spawn({"mode": "save", "mesh": [1, 2], "cases": [case], "ckpt": ckpt}, tmp_path)
    _spawn({"mode": "restore", "mesh": [2, 1], "cases": [case], "ckpt": ckpt}, tmp_path)
    stored, manifest = C.restore(C.latest(ckpt))
    assert manifest["step"] == 1
    api, tcfg = _pair(MOE)[1], TrainConfig(**TCFG)
    plan = plan_named("expert_parallel_zero3")
    saved = [torch.load(tmp_path / f"saved.rank{r}.pt", weights_only=False) for r in range(2)]
    for r in range(2):
        sh = dict(C._flatten_with_paths(
            TS.state_shardings(api, tcfg, plan, SH.Mesh(("data", "model"), (1, 2), rank=r)),
            is_leaf=lambda x: isinstance(x, SH.Sharding)))
        for k, t in C._flatten_with_paths(saved[r]["state"]):
            assert torch.equal(t, sh[k].local(stored[k])), (r, k)
    split = 0
    for r in range(2):
        got = torch.load(tmp_path / f"restored.rank{r}.pt", weights_only=False)
        assert got["step"] == 1
        sh = dict(C._flatten_with_paths(
            TS.state_shardings(api, tcfg, plan, SH.Mesh(("data", "model"), (2, 1), rank=r)),
            is_leaf=lambda x: isinstance(x, SH.Sharding)))
        for k, t in C._flatten_with_paths(got["state"]):
            want = sh[k].local(stored[k])
            assert torch.equal(t, want) and t.is_contiguous(), (r, k)
            split += t.shape != stored[k].shape
    assert split > 0


# ------------------------------------------------- split-leaf optimizers
# int8 at learning rate 1e-5: an entry whose gradient lies within rounding
# noise of a quantisation boundary lands on either neighbouring step in the
# sharded and the unsharded sum, and AdamW's first steps move it by about
# lr x sign, so at 1e-4 one entry in 32,768 ends 1.3e-5 away.  The int8
# cases run the whole-activation path: head-, ffn- and vocabulary-local
# compute sums each product in parts over the ranks, which moves a few
# gradient entries of each step across a quantisation boundary (one residual
# entry a quantisation step, 2.8e-4, away); tests/test_torch_local_compute.py
# holds int8 under local compute to the unsharded step's losses
SPLIT_OPT = {"adafactor": {"optimizer": "adafactor"},
             "adafactor_bf16": {"optimizer": "adafactor", "opt_state_dtype": "bfloat16"},
             "adamw_int8": {"grad_compression": "int8", "learning_rate": 1e-5}}


@functools.lru_cache(maxsize=None)
def _split_opt_oracle(name):
    """The reference's initial state under ``SPLIT_OPT[name]`` and the port's
    copy, the port's unsharded state after STEPS steps and its losses, and
    the reference's losses (its XLA ``make_train_step``)."""
    ref_api, api, _, batches = _pair(DENSE)
    extra = SPLIT_OPT[name]
    ref_tcfg, tcfg = RefTrainConfig(**dict(TCFG, **extra)), TrainConfig(**dict(TCFG, **extra))
    ref_state = ref_ts.init_state(ref_api, ref_tcfg, jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    opt_np = {k: to_np(v) for k, v in ref_state.opt_state._asdict().items()}
    res = None if ref_state.residual is None else to_np(ref_state.residual)
    start = TS.train_state_from_reference(to_np(ref_state.params), opt_np, res, "cpu")
    state = TS.train_state_from_reference(to_np(ref_state.params), opt_np, res, "cpu")
    step, losses = TS.make_train_step(api, tcfg), []
    ref_step, ref_losses = jax.jit(ref_ts.make_train_step(ref_api, ref_tcfg)), []
    for b in batches:
        state, m = step(state, train_launch.to_device(b, "cpu"))
        losses.append(float(m["loss"]))
        ref_state, rm = ref_step(ref_state, {k: jnp.asarray(v) for k, v in b.items()})
        ref_losses.append(float(rm["loss"]))
    return start, state, losses, ref_losses


def test_split_leaf_adafactor_and_int8_match_the_unsharded_step_on_2x2(tmp_path):
    """Reduced qwen2.5-3b on a 2x2 ``gloo`` mesh under megatron_tp and zero3
    (both split leaves over ``model``, zero3 also over ``data``), two steps
    with Adafactor, Adafactor with bfloat16 state and AdamW with int8
    compression: the losses within 1e-5 relative of the port's unsharded
    step and 1e-4 of the reference's, every rank's block of every state leaf
    within 1e-5 of the unsharded state's."""
    torch.save([train_launch.to_device(b, "cpu") for b in _pair(DENSE)[3]],
               tmp_path / "batches.pt")
    cases = []
    for name, extra in SPLIT_OPT.items():
        torch.save(_split_opt_oracle(name)[0], tmp_path / f"state-{name}.pt")
        cases += [{"name": f"{name}-{plan}", "arch": DENSE, "plan": plan,
                   "state": f"state-{name}.pt", "steps": STEPS, "tcfg": extra}
                  for plan in ("megatron_tp", "zero3")]
    # the int8 cases last: their worker turns local compute off for the rest
    for case in cases:
        if "grad_compression" in case["tcfg"]:
            case["local_compute"] = False
    cases.sort(key=lambda c: "local_compute" in c)
    _spawn({"mode": "train", "mesh": [2, 2], "cases": cases}, tmp_path)
    api = _pair(DENSE)[1]
    split = 0
    for case in cases:
        name = case["name"].rsplit("-", 1)[0]
        _, want, want_losses, ref_losses = _split_opt_oracle(name)
        tcfg = TrainConfig(**dict(TCFG, **SPLIT_OPT[name]))
        for rank in range(4):
            got = torch.load(tmp_path / f"{case['name']}.rank{rank}.pt", weights_only=False)
            losses = [h["loss"] for h in got["history"]]
            assert losses == pytest.approx(want_losses, rel=1e-5), (case, rank)
            assert losses == pytest.approx(ref_losses, rel=1e-4, abs=1e-4), (case, rank)
            mesh = SH.Mesh(("data", "model"), (2, 2), rank=rank)
            sh = dict(C._flatten_with_paths(
                TS.state_shardings(api, tcfg, plan_named(case["plan"]), mesh),
                is_leaf=lambda x: isinstance(x, SH.Sharding)))
            have = dict(C._flatten_with_paths(got["state"]))
            for k, w in C._flatten_with_paths(want):
                if k == "1/step":
                    assert int(have[k]) == STEPS
                    continue
                assert have[k].shape == sh[k].local_shape(w.shape), (case, rank, k)
                torch.testing.assert_close(have[k].float(), sh[k].local(w).float(), rtol=0,
                                           atol=1e-5,
                                           msg=lambda m: f"{case['name']} {rank} {k}: {m}")
                split += have[k].shape != w.shape
    assert split > 0
