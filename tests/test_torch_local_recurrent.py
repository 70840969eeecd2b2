"""rwkv6, zamba2 and the encoder-decoder computed in parts, on the CPU over
``gloo`` ranks (``tests/torch_mesh_worker.py``, mode ``local``).

* Head- and ffn-local rules (``megatron_tp``, ``zero3``): rwkv6's time mix
  over the rank's heads (K5 on its rows, ``w0`` / ``wB`` / ``ln_x`` sliced
  to its heads' channels) and its channel mix (``wk`` column-parallel,
  ``wv`` reduce-scattered to the rank's ``wr`` block of embed channels,
  gated there and gathered); Mamba2 over the rank's heads with ``in_proj``
  and the conv used whole; zamba2's shared block and seamless's encoder,
  decoder and cross-attention through the dense rules and
  ``layers._cross_local``.
* Sequence-split rules (``sequence_parallel``, ``zero3_sp``) for rwkv6 and
  zamba2: each rank computes its token block; the recurrent state entering
  it is the fold of the earlier blocks' own final states
  (``spmd.carry_states``), the token shifts and the causal conv read the
  previous rank's last rows (``spmd.seq_edges``).

Reduced rwkv6-3b (4 heads of 32), zamba2-1.2b (4 Mamba2 heads of 64, two
layers a group, the shared attention block at two sites) and
seamless-m4t-medium (2 + 2 layers, 4 heads) take two steps and one prefill
on 1x2 and 2x2 meshes (on 1x2 also rwkv6 with one head of 128 and zamba2
with three Mamba2 heads, whose split cuts a head: that layer runs whole),
held against the port's unsharded step and prefill in float32, at
``test_torch_local_compute.py``'s tolerances:

* every rank's loss within 1e-5 relative, every shard of the updated
  parameters within 1e-5;
* the prefill's last-token logits within 2e-2, each rank's slice of every
  cache leaf equal to its slice of the unsharded cache up to float32
  rounding (1e-5 of the leaf's largest entry, at least 1e-5: rwkv6's
  states reach 9.5, and the split prompt folds them in another order);
* the collective tally: under the local rules no all-gather on ``model``
  of a leaf the rule keeps split, only of the Mamba2 leaves it uses whole
  (``in_proj`` and the conv) and of rwkv6's gated channel-mix output, in
  each layer's forward and recomputation; and all-reduces on ``model``;
  under the sequence split, reduce-scatters on ``model`` (the gathered
  states' and rows' backward).
"""
import functools
import math
from dataclasses import replace

import pytest
import torch

from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, mamba2
from repro_torch.parallel import sharding as SH
from repro_torch.train import serve_step as SS, train_step as TS
from torch_mesh_worker import plan_named, spawn

B, S, STEPS, PROMPT = 4, 16, 2, 16
TCFG = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
# AdamW moves an entry by about the learning rate whatever its gradient's
# size, so an entry whose gradient is within float32 summation noise of 0
# (here below 1e-5 of its leaf's largest) may move either way on two correct
# paths: such entries are held to the update's bound, 2 x lr a step
NOISE = 1e-5
LOCAL = ("megatron_tp", "zero3")
SPLIT = ("sequence_parallel", "zero3_sp")
CASES = [(a, p, ()) for a in ("rwkv6-3b", "zamba2-1.2b") for p in LOCAL + SPLIT]
CASES += [("seamless-m4t-medium", p, ()) for p in LOCAL]
# splits that cut a head (rwkv6: one head of 128 over two ranks; Mamba2: three
# heads of 64, out_proj's 192 rows in two): the layer runs whole
# (``spmd.unsplit``), the rest of the model in parts
CUT = [("rwkv6-3b", "megatron_tp", (("head_dim", 128),)),
       ("zamba2-1.2b", "megatron_tp", (("d_model", 96),))]


@functools.lru_cache(maxsize=None)
def _setup(arch, extra=()):
    """The reduced model (with the sizes ``extra`` overrides) in float32, its
    initial state from seed 0, the batches, a prompt (with its frontend
    input), the unsharded steps' losses and final state, and the unsharded
    prefill of the prompt."""
    api = build_model(replace(get_config(arch).reduced(**dict(extra)),
                              compute_dtype="float32"))
    tcfg = TrainConfig(**TCFG)
    start = TS.init_state(api, tcfg, torch.Generator().manual_seed(0), device="cpu")
    source = pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=api.cfg.vocab_size), api.cfg)
    batches = [train_launch.to_device(source.batch_at(i, B, S), "cpu") for i in range(STEPS)]
    prompt = train_launch.to_device(source.batch_at(STEPS, B, PROMPT), "cpu")
    prompt.pop("labels")
    state = TS.init_state(api, tcfg, torch.Generator().manual_seed(0), device="cpu")
    step, losses, noisy = TS.make_train_step(api, tcfg), [], None
    for b in batches:
        grads = dict(C._flatten_with_paths(TS.value_and_grad(api, state.params, b)[2]))
        small = {k: g.abs() <= NOISE * g.abs().max() for k, g in grads.items()}
        noisy = small if noisy is None else {k: noisy[k] | small[k] for k in small}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    inputs = dict(prompt)
    tokens = inputs.pop("tokens")
    cache = api.init_cache(api.cfg, B, api.prefix_len() + PROMPT + 4, dtype=torch.float32,
                           device="cpu")
    with torch.no_grad():
        logits, cache = api.prefill(start.params, tokens, cache, **inputs)
    return api, start, batches, prompt, losses, state, logits, cache, noisy


def _gathered_a_step(cfg, rows: int) -> int:
    """Float32 bytes a local step gathers over ``model``, in each layer's
    forward and, with remat, again in its recomputation: zamba2's Mamba2
    leaves used whole (in_proj, conv_w, conv_b); rwkv6's gated channel-mix
    output, (rows, S, d) (an activation: its ``wk``, ``wv`` and ``wr`` stay
    split); nothing for seamless."""
    per_layer = 0
    if cfg.family == "hybrid":
        d_inner, H, dh, ds = mamba2.dims(cfg)
        conv_dim = d_inner + 2 * ds
        per_layer = cfg.d_model * (2 * d_inner + 2 * ds + H) + (cfg.conv_kernel + 1) * conv_dim
    elif cfg.family == "ssm":
        per_layer = rows * S * cfg.d_model
    return 4 * per_layer * cfg.n_layers * (2 if cfg.remat else 1)


def test_every_family_has_local_rules_and_the_recurrent_ones_split_the_sequence():
    """Every family has local rules (a megatron plan's step has a local
    axis for all six) and splits the sequence under every plan that splits
    it: under tp2d (the residual's embed split too) as under
    sequence_parallel and zero3_sp, all six get the ``model`` axis."""
    archs = ("qwen2.5-3b", "qwen3-moe-30b-a3b", "internvl2-1b", "rwkv6-3b", "zamba2-1.2b",
             "seamless-m4t-medium")
    apis = [build_model(get_config(a).reduced()) for a in archs]
    mesh = SH.Mesh(("data", "model"), (2, 2))
    for api in apis:
        for name in ("tp2d",) + SPLIT:
            assert TS.seq_split_axis(api, plan_named(name), mesh, S) == "model", \
                (api.cfg.name, name)
        for name in LOCAL:
            assert TS.seq_split_axis(api, plan_named(name), mesh, S) is None, api.cfg.name


def test_mamba2_takes_its_heads_columns():
    """The plan splits in_proj's 2 d_inner + 2 ds + H columns contiguously
    (zamba2-1.2b: 8,384 over 8 ranks, 1,048 each), which does not line up
    with z | xin | B | C | dt.  A rank's heads read their z, xin and dt
    columns and every B and C column, and the conv's xin channels of those
    heads and every B and C channel.  (The multi-rank test below runs the
    rank's contiguous block of columns in their place too, and the step then
    disagrees with the unsharded one.)"""
    cfg = get_config("zamba2-1.2b")
    d_inner, H, dh, ds = mamba2.dims(cfg)
    n = 2 * d_inner + 2 * ds + H
    assert (d_inner, H, dh, ds, n) == (4096, 64, 64, 64, 8384)
    cols, ch = mamba2.mamba2_head_columns(cfg, 8, 8)          # rank 1 of 8
    want = list(range(8 * dh, 16 * dh)) + list(range(d_inner + 8 * dh, d_inner + 16 * dh)) \
        + list(range(2 * d_inner, 2 * d_inner + 2 * ds)) + list(range(n - H + 8, n - H + 16))
    assert cols.tolist() == want
    assert ch.tolist() == list(range(8 * dh, 16 * dh)) + list(range(d_inner, d_inner + 2 * ds))
    assert cols.tolist() != list(range(n // 8, 2 * n // 8))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_local_and_sequence_split_steps_and_prefill_match_the_unsharded_ones(mesh_shape,
                                                                             tmp_path):
    cases = []
    checked = CASES + (CUT if mesh_shape == (1, 2) else [])
    for arch, plan, extra in checked:
        _, start, batches, prompt, *_ = _setup(arch, extra)
        tag = f"{arch}{len(extra)}"
        for name, obj in (("state", start), ("batches", batches), ("prompt", prompt)):
            torch.save(obj, tmp_path / f"{name}-{tag}.pt")
        cases.append({"name": f"{tag}-{plan}", "arch": arch, "plan": plan,
                      "reduced": dict(extra), "state": f"state-{tag}.pt",
                      "batches": f"batches-{tag}.pt", "prompt": f"prompt-{tag}.pt",
                      "steps": STEPS})
    if mesh_shape == (1, 2):
        # the pin: zamba2's Mamba2 reading the rank's contiguous block of in_proj
        cases.append(dict(cases[len(LOCAL + SPLIT)], name="contiguous", columns="contiguous"))
    spawn({"mode": "local", "mesh": list(mesh_shape), "cases": cases, "tcfg": TCFG}, tmp_path)
    if mesh_shape == (1, 2):
        want_losses = _setup("zamba2-1.2b")[4]
        for rank in range(2):
            got = torch.load(tmp_path / f"contiguous.rank{rank}.pt", weights_only=False)
            assert got["history"][0]["loss"] != pytest.approx(want_losses[0], rel=1e-3)
    for arch, plan, extra in checked:
        api, _, _, _, want_losses, want, want_logits, want_cache, noisy = _setup(arch, extra)
        for rank in range(math.prod(mesh_shape)):
            got = torch.load(tmp_path / f"{arch}{len(extra)}-{plan}.rank{rank}.pt",
                             weights_only=False)
            what = f"{arch} {extra} {plan} {mesh_shape} rank {rank}"
            assert [h["loss"] for h in got["history"]] == pytest.approx(want_losses,
                                                                          rel=1e-5), what
            mesh = SH.Mesh(("data", "model"), mesh_shape, rank=rank)
            sh = dict(C._flatten_with_paths(
                TS.state_shardings(api, TrainConfig(**TCFG), plan_named(plan), mesh),
                is_leaf=lambda x: isinstance(x, SH.Sharding)))
            have = dict(C._flatten_with_paths(got["state"].params))
            for k, w in C._flatten_with_paths(want.params):
                assert have[k].shape == sh["0/" + k].local_shape(w.shape), (what, k)
                diff = (have[k] - sh["0/" + k].local(w)).abs()
                bound = torch.where(sh["0/" + k].local(noisy[k]), 2 * TCFG["learning_rate"]
                                    * STEPS, 1e-5)
                assert bool((diff <= bound).all()), (what, k, diff.max().item(),
                                                     int((diff > 1e-5).sum()))
            gathered = got["gathered"].get("model", 0.0)
            if plan in LOCAL:
                if not extra:
                    want_gathered = _gathered_a_step(api.cfg, B // mesh_shape[0]) * STEPS
                    assert gathered == want_gathered, (what, got["gathered"])
                assert got["reduced"].get("model", 0.0) > 0.0, what
            else:
                assert got["scattered"].get("model", 0.0) > 0.0, what
            torch.testing.assert_close(got["prefill_logits"], want_logits, rtol=2e-2,
                                       atol=2e-2, msg=lambda m: f"{what} logits: {m}")
            assert got["cache_index"] == PROMPT
            c_sh = SS.cache_shardings(api, want_cache, plan_named(plan), mesh)
            for name, w in want_cache.items():
                if not isinstance(w, torch.Tensor):
                    continue
                torch.testing.assert_close(got["cache"][name], c_sh[name].local(w),
                                           rtol=1e-5, atol=1e-5 * max(1.0, w.abs().max()),
                                           msg=lambda m: f"{what} cache {name}: {m}")
