"""Every family split over the sequence, on the CPU over ``gloo`` ranks
(``tests/torch_mesh_worker.py``, mode ``families``).

* The MoE under ``sequence_parallel`` (no ``experts`` axis): each rank
  routes its block of the tokens and the ranks exchange per-row, per-expert
  pair counts (``moe._queue_offsets``), so the capacity, the queue order and
  the load-balancing loss are the global batch's without a token gathered.
  ``moe_mlp`` alone on 1x2 and 2x2 meshes is held against the reference's
  single-shard ``moe_mlp`` on the same numpy inputs and weights, with
  capacity binding: outputs within the MoE parity tolerance (1e-4 in
  float32), the kept (token, slot) pairs equal to the reference's, the
  router's gradient equal to the unsharded one, and the only all-gather
  that of the counts.  A pin that orders the queue rank by rank instead of
  interleaving the ranks' blocks inside each batch row keeps other pairs.
* The MoE under ``zero3_sp`` (experts and sequence on ``model``): the rank
  gathers its data shard's sequence, runs the expert-parallel branch and
  reduce-scatters the output.  As in the reference, each data shard routes
  its rows alone, so it is held against the unsharded steps with the loss
  and gradient averaged over the data shards (``test_torch_mesh_train.py``'s
  oracle for expert parallelism) and the prompt prefilled shard by shard:
  on 1x2, the unsharded step and prefill.
* The VLM: patches ahead of the prompt in one sequence split evenly, so
  ranks hold different numbers of text positions (here one holds none, and
  the boundary falls inside another's block).  Its split forward is held
  against the reference's ``vlm.forward`` (1e-5 in float32, 2e-2 in bf16)
  and its loss, each rank's share of the global mean, against the
  unsharded loss (1e-5 relative); the mean of per-rank means disagrees.
* The encoder-decoder: frames and prompt split over the one axis; its
  split forward is held against the reference's ``encdec.forward``; a pin
  whose cross-attention reads only the rank's block of the memory
  disagrees.
* Steps and prefills: reduced internvl2-1b, qwen3-moe-30b-a3b (capacity
  factor 0.5: pairs drop) and seamless-m4t-medium take two float32 steps
  under ``sequence_parallel`` and ``zero3_sp`` and one prompt pass through
  ``serve_step.jit_serve_step``; rwkv6-3b and zamba2-1.2b under ``tp2d`` on
  2x2 (``embed`` split over ``data``).  Against the port's unsharded step
  and prefill (the MoE under ``zero3_sp``: per data shard, as above), at
  ``test_torch_local_recurrent.py``'s tolerances: losses
  1e-5 relative, parameter shards by its rule, the first step's gradient
  shards within 1e-4 of each leaf's largest entry, logits 2e-2, the rank's
  cache slice; the tally: under ``tp2d`` no weight gathered over ``data``
  but rwkv6's ``w0``, ``wB`` and ``ln_x`` (named ``embed``, they index the
  heads' channels, which every rank computes whole), and of activations
  only the gradient of rwkv6's channel-mix gate; under
  ``sequence_parallel`` the MoE gathers only the counts and K/V.
"""
import functools
import json
import math
import os
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import build_model, moe
from repro_torch.models.convert import from_reference
from repro_torch.parallel import sharding as SH
from repro_torch.train import optimizer as opt, serve_step as SS, train_step as TS
from test_torch_local_recurrent import NOISE, PROMPT, STEPS, TCFG, _setup
from torch_mesh_worker import plan_named, spawn

MOE, VLM, ENCDEC = "qwen3-moe-30b-a3b", "internvl2-1b", "seamless-m4t-medium"
DROPS = (("capacity_factor", 0.5),)
# moe_mlp alone: the load-balancing loss weighed up, so that its share of the
# router's gradient is not lost in the tolerance
ALONE = DROPS + (("router_aux_weight", 1.0),)
SPLIT = ("sequence_parallel", "zero3_sp")
STEP_CASES = [(VLM, p, ()) for p in SPLIT] + [(MOE, p, DROPS) for p in SPLIT] \
    + [(ENCDEC, p, ()) for p in SPLIT]
TP2D_CASES = [("rwkv6-3b", "tp2d", ()), ("zamba2-1.2b", "tp2d", ())]
XB, XS = 4, 16                     # moe_mlp alone, and the forwards
VLM_TEXT = (8, 24)                 # 16 patches ahead: rank 0 of 2 holds no text at 8


def _f32(arch, extra=()):
    return (replace(get_config(arch).reduced(**dict(extra)), compute_dtype="float32"),
            replace(ref_get_config(arch).reduced(**dict(extra)), compute_dtype="float32"))


# ------------------------------------------------------------------ oracles
@functools.lru_cache(maxsize=None)
def _moe_data():
    """moe_mlp's inputs (numpy, seed 0) and the reference's single-shard
    output, aux, kept pairs and router gradient of ``sum(y * c) + aux``;
    the port's unsharded router gradient."""
    cfg, ref_cfg = _f32(MOE, ALONE)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    rng = np.random.default_rng(0)
    arr = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    p = {"router": arr(d, E), "w_gate": arr(E, d, f), "w_up": arr(E, d, f),
         "w_down": arr(E, f, d)}
    x, c = arr(XB, XS, d), arr(XB, XS, d)

    def objective(pj):
        y, aux = ref_moe.moe_mlp(pj, jnp.asarray(x), ref_cfg)
        return jnp.sum(y * c) + aux, (y, aux)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    (_, (y, aux)), g = jax.value_and_grad(objective, has_aux=True)(pj)
    _, idx, _ = ref_moe._router(jnp.asarray(x.reshape(-1, d)), pj["router"], ref_cfg)
    idx = np.asarray(idx).reshape(-1)
    cap = ref_moe._capacity(XB * XS, ref_cfg)
    seen = np.zeros(E, np.int64)
    keep = np.zeros(idx.shape, bool)
    for i, e in enumerate(idx):                 # the reference's stable sort, in order
        keep[i] = seen[e] < cap
        seen[e] += 1
    assert not keep.all(), "capacity must bind"
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    yt, auxt = moe.moe_mlp(pt, torch.from_numpy(x), cfg)
    (torch.sum(yt * torch.from_numpy(c)) + auxt).backward()
    data = {"x": torch.from_numpy(x), "c": torch.from_numpy(c),
            "p": {k: torch.from_numpy(v) for k, v in p.items()}}
    return data, np.asarray(y), float(aux), keep.reshape(XB, XS, -1), \
        np.asarray(g["router"]), pt["router"].grad


@functools.lru_cache(maxsize=None)
def _forward_data(arch, dtype, S):
    """A reduced model's reference weights (seed 0) and a batch of ``S``
    text tokens (numpy, seed 1), the reference's logits and the port's
    unsharded loss."""
    ref_cfg = replace(ref_get_config(arch).reduced(), compute_dtype=dtype)
    ref_api = ref_build_model(ref_cfg)
    params = ref_api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(1, ref_cfg.vocab_size, size=(XB, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    name = {"vlm": "patches", "audio": "frames"}[ref_cfg.family]
    batch[name] = (rng.standard_normal((XB, ref_cfg.frontend_len, ref_cfg.frontend_dim))
                   * 0.02).astype(np.float32)
    want = np.asarray(ref_api.logits_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}
                                        ).astype(jnp.float32))
    port = build_model(replace(get_config(arch).reduced(), compute_dtype=dtype))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    with torch.no_grad():
        loss = float(port.loss_fn(tparams, tb)[0])
    return {"params": tparams, "batch": tb}, want, loss


@functools.lru_cache(maxsize=None)
def _first_grads(arch, extra=()):
    api, start, batches = _setup(arch, extra)[:3]
    return dict(C._flatten_with_paths(TS.value_and_grad(api, start.params, batches[0])[2]))


def _shard_rows(x, dp, i):
    n = x.shape[0] // dp
    return x[i * n:(i + 1) * n]


@functools.lru_cache(maxsize=None)
def _oracle(arch, extra, dp):
    """The port's unsharded steps and prefill with each of ``dp`` batch
    shards on its own, as the expert-parallel branch routes each data
    shard's rows alone: the loss and gradient averaged over the shards
    before the optimizer, the prompt prefilled shard by shard.  The losses,
    final state, first gradient (flat), prefill logits, cache and the
    entries whose gradient is float32 noise; with ``dp`` 1, ``_setup``'s."""
    api, start, batches, prompt, losses, state, logits, cache, noisy = _setup(arch, extra)
    if dp == 1:
        return losses, state, _first_grads(arch, extra), logits, cache, noisy
    tcfg = TrainConfig(**TCFG)
    state = TS.init_state(api, tcfg, torch.Generator().manual_seed(0), device="cpu")
    losses, first, noisy = [], None, None
    for b in batches:
        grads, loss = TS.zero_grads(state.params, torch.float32), 0.0
        for i in range(dp):
            part = {k: _shard_rows(v, dp, i) for k, v in b.items()}
            loss += float(TS.accumulate_grad(api, state.params, part, grads)[0]) / dp
        for g in opt._leaves(grads):
            g.div_(dp)
        flat = {k: g.clone() for k, g in C._flatten_with_paths(grads)}
        first = flat if first is None else first
        small = {k: g.abs() <= NOISE * g.abs().max() for k, g in flat.items()}
        noisy = small if noisy is None else {k: noisy[k] | small[k] for k in small}
        params, opt_state, _ = opt.opt_update(grads, state.opt_state, state.params, tcfg)
        state = TS.TrainState(params, opt_state)
        losses.append(loss)
    inputs = dict(prompt)
    tokens = inputs.pop("tokens")
    parts = []
    for i in range(dp):
        part = api.init_cache(api.cfg, tokens.shape[0] // dp, api.prefix_len() + PROMPT + 4,
                              dtype=torch.float32, device="cpu")
        with torch.no_grad():
            parts.append(api.prefill(start.params, _shard_rows(tokens, dp, i), part,
                                     **{k: _shard_rows(v, dp, i) for k, v in inputs.items()}))
    whole = dict(cache)
    for k, w in cache.items():
        if isinstance(w, torch.Tensor):
            leaves = [c[k] for _, c in parts]
            dim = next(d for d, (a, b) in enumerate(zip(leaves[0].shape, w.shape)) if a != b)
            whole[k] = torch.cat(leaves, dim=dim)
    return losses, state, first, torch.cat([lg for lg, _ in parts]), whole, noisy


def _gathered_over_data(cfg, mesh_shape) -> float:
    """Float32 bytes a tp2d step of two STEPS gathers over ``data``: no
    weight but rwkv6's ``w0``, ``ln_x`` (d each) and ``wB`` (64 x d), whole
    in each layer's forward and recomputation, and the gradient of its
    channel mix's gate, (4 rows, the rank's 16 / model positions, d), in
    each layer's backward (the reduce-scatter's)."""
    if cfg.family != "ssm":
        return 0.0
    weights = (2 + 64) * cfg.d_model * 2
    gate = 4 * 16 // mesh_shape[1] * cfg.d_model
    return 4.0 * (weights + gate) * cfg.n_layers * STEPS


def _moe_gathers(cfg, mesh_shape, rows: int) -> float:
    """Bytes a sequence_parallel step of two STEPS gathers over ``model``:
    the int32 counts (global rows x ranks x experts) and K and V (rows x S
    x kv heads x head dim, float32), a layer's forward and recomputation."""
    counts = 4 * rows * mesh_shape[0] * mesh_shape[1] * cfg.n_experts
    kv = 2 * 4 * rows * 16 * cfg.n_kv_heads * cfg.head_dim_
    return float((counts + kv) * cfg.n_layers * 2 * STEPS)


# ------------------------------------------------------------------- tests
def test_every_family_splits_the_sequence_and_the_recurrent_ones_tp2d():
    """``sequence_split`` is true for all six families and ``embed_split``
    for the dense family, rwkv6 and zamba2; the VLM divides its patches and
    prompt together (16 + 16 over 2 and 4, 16 + 6 over 2 only), the
    encoder-decoder its frames too."""
    mesh = SH.Mesh(("data", "model"), (2, 2))
    wide = SH.Mesh(("data", "model"), (1, 4))
    for arch in (MOE, VLM, ENCDEC, "rwkv6-3b", "zamba2-1.2b", "qwen2.5-3b"):
        api = build_model(get_config(arch).reduced())
        assert api.sequence_split and api.block_inputs == (arch != VLM)
        assert api.embed_split == (arch in ("rwkv6-3b", "zamba2-1.2b", "qwen2.5-3b"))
        tp2d = TS.seq_split_axis(api, plan_named("tp2d"), mesh, 16)
        assert tp2d == ("model" if api.embed_split else None), arch
    vlm = build_model(get_config(VLM).reduced())
    assert vlm.seq_lengths(16) == (32,)
    assert TS.seq_split_axis(vlm, plan_named("sequence_parallel"), wide, 16) == "model"
    assert TS.seq_split_axis(vlm, plan_named("sequence_parallel"), wide, 6) is None
    assert TS.seq_split_axis(vlm, plan_named("sequence_parallel"), mesh, 6) == "model"
    audio = build_model(get_config(ENCDEC).reduced(frontend_len=5))
    assert TS.seq_split_axis(audio, plan_named("sequence_parallel"), mesh, 16) is None


# the head positions of each rank of a fake world (a no-op process group)
_HEAD_POSITIONS = """
import json, sys
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import sequence_parallel_plan
apis = [build_model(get_config(a).reduced()) for a in sys.argv[1:]]
out = {}
for sizes, S in (((1, 4), 16), ((1, 2), 8), ((2, 2), 6)):
    ranks = []
    for r in range(sizes[0] * sizes[1]):
        dryrun.fake_world(sizes[0] * sizes[1], r)
        mesh = dryrun.world_mesh(("data", "model"), sizes, r)
        step = spmd.Step(sequence_parallel_plan(), mesh, "data", 4, seq_axis="model")
        with spmd.step_context(step):
            ranks.append([api.head_positions(S) for api in apis])
        dist.destroy_process_group()
    out[f"{sizes} {S}"] = ranks
print(json.dumps(out))
"""


def test_the_vlm_head_takes_the_text_positions_of_the_ranks_block():
    """``ModelAPI.head_positions`` (what the dry run counts the logits by):
    the VLM's text positions in the rank's block of its 16 patches and the
    prompt, which the step hands it whole; every other family's tokens as
    the step hands them.  Outside a step, the whole prompt."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", _HEAD_POSITIONS, VLM, MOE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    # (1, 4): 32 positions, 8 a rank, the text from rank 2 on; (1, 2) at 8
    # tokens: 12 a rank, rank 1 holding patches 12-16 and the 8 tokens;
    # (2, 2) at 6 tokens: 11 a rank, rank 1 (and 3) holding the 6 tokens
    assert got == {"(1, 4) 16": [[0, 16], [0, 16], [8, 16], [8, 16]],
                   "(1, 2) 8": [[0, 8], [8, 8]],
                   "(2, 2) 6": [[0, 6], [6, 6], [0, 6], [6, 6]]}
    assert build_model(get_config(VLM).reduced()).head_positions(8) == 8


def _moe_cases():
    return [{"name": f"moe-{pin}", "kind": "moe", "arch": MOE, "plan": "sequence_parallel",
             "reduced": dict(ALONE), "data": "moe.pt", "pin": pin}
            for pin in ("none", "whole_ranks")]


def _forward_cases(tmp_path):
    cases = []
    for arch, dtype, S in [(VLM, "float32", s) for s in VLM_TEXT] + [(VLM, "bfloat16", 8),
                                                                       (ENCDEC, "float32", 16)]:
        tag = f"{arch}-{dtype}-{S}"
        torch.save(_forward_data(arch, dtype, S)[0], tmp_path / f"{tag}.pt")
        pins = ("none", "cross_block") if arch == ENCDEC else ("none",)
        cases += [{"name": f"{tag}-{pin}", "kind": "forward", "arch": arch, "dtype": dtype,
                   "plan": "sequence_parallel", "data": f"{tag}.pt", "pin": pin, "S": S}
                  for pin in pins]
    return cases


def _step_cases(tmp_path, checked):
    cases = []
    for arch, plan, extra in checked:
        _, start, batches, prompt, *_ = _setup(arch, extra)
        for name, obj in (("state", start), ("batches", batches), ("prompt", prompt)):
            torch.save(obj, tmp_path / f"{name}-{arch}.pt")
        case = {"name": f"{arch}-{plan}", "kind": "local", "arch": arch, "plan": plan,
                "reduced": dict(extra), "state": f"state-{arch}.pt",
                "batches": f"batches-{arch}.pt", "prompt": f"prompt-{arch}.pt",
                "steps": STEPS}
        cases.append(case)
    return cases


def _check_moe(tmp_path, mesh_shape):
    data, want_y, want_aux, want_keep, ref_grad, port_grad = _moe_data()
    for rank in range(math.prod(mesh_shape)):
        got = torch.load(tmp_path / f"moe-none.rank{rank}.pt", weights_only=False)
        pin = torch.load(tmp_path / f"moe-whole_ranks.rank{rank}.pt", weights_only=False)
        dp, m = got["coords"]["data"], got["coords"]["model"]
        rows = slice(dp * XB // mesh_shape[0], (dp + 1) * XB // mesh_shape[0])
        cols = slice(m * XS // mesh_shape[1], (m + 1) * XS // mesh_shape[1])
        what = f"{mesh_shape} rank {rank}"
        np.testing.assert_allclose(got["y"].numpy(), want_y[rows, cols], rtol=1e-4, atol=1e-4,
                                   err_msg=what)
        assert got["aux"] == pytest.approx(want_aux, rel=1e-5), what
        keep = want_keep[rows, cols].reshape(-1, want_keep.shape[-1])
        assert np.array_equal(got["keep"][0].numpy(), keep), what
        assert not np.array_equal(pin["keep"][0].numpy(), keep), what
        E, rows_here = data["p"]["router"].shape[1], XB // mesh_shape[0]
        assert got["buffers"] == [(E, min(moe._capacity(XB * XS, _f32(MOE, ALONE)[0]),
                                          rows_here * XS // mesh_shape[1]), 128)], what
        scale = float(np.abs(ref_grad).max())
        np.testing.assert_allclose(got["router_grad"].numpy(), ref_grad, rtol=0,
                                   atol=1e-4 * scale, err_msg=what)
        torch.testing.assert_close(got["router_grad"], port_grad, rtol=0, atol=1e-5 * scale)
        # the only all-gather: every rank's (rows, experts) int32 counts
        counts = 4.0 * XB * mesh_shape[1] * E
        assert got["gathered"] == {a: counts for a in ("data", "model")}, (what, got["gathered"])


def _check_forwards(tmp_path, mesh_shape):
    for arch, dtype, S in [(VLM, "float32", s) for s in VLM_TEXT] + [(VLM, "bfloat16", 8),
                                                                       (ENCDEC, "float32", 16)]:
        _, want, loss = _forward_data(arch, dtype, S)
        tag = f"{arch}-{dtype}-{S}"
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        blocks, pinned, shares = {}, {}, []
        for rank in range(math.prod(mesh_shape)):
            got = torch.load(tmp_path / f"{tag}-none.rank{rank}.pt", weights_only=False)
            assert got["seq"] == "model"
            key = (got["coords"]["data"], got["coords"]["model"])
            blocks[key] = got["logits"].float().numpy()
            if dtype == "float32":
                assert got["loss"] == pytest.approx(loss, rel=1e-5), (tag, rank)
            shares.append(got["mean_of_means"])
            if arch == ENCDEC:
                pinned[key] = torch.load(tmp_path / f"{tag}-cross_block.rank{rank}.pt",
                                         weights_only=False)["logits"].numpy()
        for name, parts in (("split", blocks), ("pin", pinned)):
            if not parts:
                continue
            whole = np.concatenate([np.concatenate([parts[(dp, m)] for m in range(mesh_shape[1])],
                                                   axis=1) for dp in range(mesh_shape[0])])
            if name == "split":
                np.testing.assert_allclose(whole, want, rtol=tol, atol=tol, err_msg=tag)
            else:
                assert not np.allclose(whole, want, rtol=1e-2, atol=1e-2), tag
        if arch == VLM and S == 24:
            # both ranks hold text, 4 and 16 positions: the mean of their means is off
            assert all(s is not None and math.isfinite(s) for s in shares)
            assert shares[0] != pytest.approx(loss, rel=1e-3)
        if arch == VLM and S == 8:
            assert blocks[(0, 0)].shape[1] == 0 and blocks[(0, 1)].shape[1] == 8


def _check_steps(tmp_path, mesh_shape, checked):
    for arch, plan, extra in checked:
        api = _setup(arch, extra)[0]
        # the expert-parallel branch routes each data shard alone
        dp = mesh_shape[0] if arch == MOE and plan_named(plan).mesh_axes("experts") else 1
        losses, want, want_grads, logits, want_cache, noisy = _oracle(arch, extra, dp)
        for rank in range(math.prod(mesh_shape)):
            got = torch.load(tmp_path / f"{arch}-{plan}.rank{rank}.pt", weights_only=False)
            what = f"{arch} {plan} {mesh_shape} rank {rank}"
            mesh = SH.Mesh(("data", "model"), mesh_shape, rank=rank)
            sh = dict(C._flatten_with_paths(
                TS.state_shardings(api, TrainConfig(**TCFG), plan_named(plan), mesh),
                is_leaf=lambda x: isinstance(x, SH.Sharding)))
            params = {k: sh["0/" + k].local(w) for k, w in C._flatten_with_paths(want.params)}
            grads = {k: sh["0/" + k].local(g) for k, g in want_grads.items()}
            c_sh = SS.cache_shardings(api, want_cache, plan_named(plan), mesh)
            cache = {k: c_sh[k].local(w) for k, w in want_cache.items()
                     if isinstance(w, torch.Tensor)}
            assert [h["loss"] for h in got["history"]] == pytest.approx(losses, rel=1e-5), what
            have = dict(C._flatten_with_paths(got["state"].params))
            for k, w in params.items():
                assert have[k].shape == w.shape, (what, k)
                diff = (have[k] - w).abs()
                bound = torch.where(sh["0/" + k].local(noisy[k]),
                                    2 * TCFG["learning_rate"] * STEPS, 1e-5)
                assert bool((diff <= bound).all()), (what, k, diff.max().item())
            for k, g in grads.items():
                scale = max(float(want_grads[k].abs().max()), 1e-6)
                torch.testing.assert_close(got["grads"][k], g, rtol=0, atol=1e-4 * scale,
                                           msg=lambda m: f"{what} grad {k}: {m}")
            torch.testing.assert_close(got["prefill_logits"], logits, rtol=2e-2, atol=2e-2,
                                       msg=lambda m: f"{what} logits: {m}")
            assert got["cache_index"] == api.prefix_len() + PROMPT
            for name, w in cache.items():
                torch.testing.assert_close(got["cache"][name], w, rtol=1e-5,
                                           atol=1e-5 * max(1.0, float(w.abs().max())),
                                           msg=lambda m: f"{what} cache {name}: {m}")
            assert got["scattered"].get("model", 0.0) > 0.0, what
            if plan == "tp2d":
                want_data = _gathered_over_data(api.cfg, mesh_shape)
                assert got["gathered"].get("data", 0.0) == want_data, (what, got["gathered"])
                assert got["reduced"].get("data", 0.0) > 0.0, what
            if arch == MOE and plan == "sequence_parallel":
                want_bytes = _moe_gathers(api.cfg, mesh_shape, 4 // mesh_shape[0])
                assert got["gathered"].get("model", 0.0) == want_bytes, (what, got["gathered"])


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_split_families_match_the_reference_and_the_unsharded_steps(mesh_shape, tmp_path):
    torch.save(_moe_data()[0], tmp_path / "moe.pt")
    checked = STEP_CASES + (TP2D_CASES if mesh_shape == (2, 2) else [])
    cases = _moe_cases() + _forward_cases(tmp_path) + _step_cases(tmp_path, checked)
    spawn({"mode": "families", "mesh": list(mesh_shape), "cases": cases, "tcfg": TCFG},
          tmp_path)
    _check_moe(tmp_path, mesh_shape)
    _check_forwards(tmp_path, mesh_shape)
    _check_steps(tmp_path, mesh_shape, checked)
