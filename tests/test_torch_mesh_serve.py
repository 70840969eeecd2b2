"""The plan-sharded serve step of the port over several ranks, on the CPU.

K3's two stages first: a float32 kv buffer cut into R rank pieces (one of
them with no valid key), the partials of each piece gathered and folded by
the combine equal the whole buffer's decode, and the reference's
``flash_decode_partials`` + ``combine_partials`` (interpret mode) on the
same pieces.

Then ``serve_step.jit_serve_step`` on ``gloo`` ranks
(``tests/torch_mesh_worker.py``, mode ``serve``, a ``file://`` store under
``tmp_path``, one start per mesh shape with the plans looped inside it):
every family reduced, in float32 (the dense model with 2 kv heads, so
that ``megatron_tp`` splits them on a 2-wide ``model`` axis; rwkv6's state
split over heads, zamba2's SSD state over heads and its conv state over
channels, the encoder-decoder's cross K/V over ``kv_seq`` or kv heads),
its cache filled
by the unsharded steps and handed over whole, four decode steps
teacher-forced on the same ids from a 70-token prompt in a 256-key buffer:
some rank of a split cache holds no valid key, and on 1x2 one rank holds
more than the kernel's 64-key tile and the other none, so a split count
taken from the valid keys would differ between them.  The CPU splits the
keys as a card of 132 SMs would.  Held here:

* every rank's logits within 1e-5 of the port's unsharded ``decode_step``
  and within 1e-4 of the reference's ``make_serve_step`` (its prompt fed
  token by token: its multi-token prefill is not causal);
* every rank's cache slice equal to its slice of the unsharded cache;
* K3's partials path (``ops.flash_decode_partials`` and
  ``flash_decode.combine_partials``) taken exactly when the plan splits ``kv_seq``,
  the one-launch decode (``ops.flash_decode``) exactly when it does not.

Prompt passes into a split cache: the same step given the empty cache and
the 70-token prompt, under ``kv_sequence_split`` (the prompt computed whole
on every rank, each rank writing the positions of its ``kv_seq`` block),
``sequence_parallel`` (each rank's 35 tokens, K/V gathered over ``model``)
and, for the encoder-decoder, ``kv_sequence_split`` and ``megatron_tp``
(its cross K/V split over ``kv_seq`` or kv heads: projected whole, each rank
storing its block; and once with the prompt pass reading the split cross
K/V from the cache, which it gathers): every rank's cache block after the prompt equals its
block of the unsharded prefill's cache, the prompt's last-token logits and
the decode steps that follow equal the unsharded ones (1e-5).

The placements ``jit_serve_step`` uses (tokens, parameters, cache) equal
the reference's ``jit_serve_step`` in-shardings on the fake-device meshes
of ``tests/test_torch_parallel.py``.
"""
import functools
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.flash_decode import combine_partials as ref_combine
from repro.kernels.flash_decode import flash_decode_partials as ref_partials
from repro.models import build_model as ref_build_model
from repro.train import serve_step as ref_ss
from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as FD, ops
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference
from repro_torch.parallel import sharding as SH
from repro_torch.train import serve_step as SS
from torch_mesh_worker import plan_named, spawn

B, PROMPT, STEPS, BUFFER = 2, 70, 4, 256
DENSE, MOE = "qwen2.5-3b", "qwen3-moe-30b-a3b"
RWKV, HYBRID, VLM, ENCDEC = "rwkv6-3b", "zamba2-1.2b", "internvl2-1b", "seamless-m4t-medium"
REDUCED = {DENSE: {"n_kv_heads": 2}}
# the plans each family is held under: kv_seq split, heads or channels split
# (megatron_tp: kv heads, rwkv6's state over q_heads, zamba2's SSD state over
# its heads and its conv state over channels), nothing but the batch split
PLANS = {DENSE: ("kv_sequence_split", "kv_split_zero3", "megatron_tp", "pure_dp"),
         MOE: ("expert_parallel", "kv_sequence_split"),
         RWKV: ("megatron_tp", "pure_dp"),
         HYBRID: ("kv_sequence_split", "megatron_tp", "pure_dp"),
         VLM: ("kv_sequence_split",),
         ENCDEC: ("kv_sequence_split", "megatron_tp")}


# ------------------------------------------------------- partials + combine
@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_partials_of_rank_pieces_combine_to_the_whole_decode(ranks):
    """A 48-key buffer, 19 valid, cut into ``ranks`` equal pieces: the last
    piece holds no valid key.  Each piece's partials (2 splits), gathered
    along the split dim and combined, equal the one-piece decode within
    1e-6 and the reference's kernel + combine over the same pieces' valid
    keys."""
    rng = np.random.default_rng(ranks)
    BH, G, T, d, valid = 8, 2, 48, 32, 19
    q = rng.standard_normal((BH, 1, d)).astype(np.float32)
    k = rng.standard_normal((BH // G, T, d)).astype(np.float32)
    v = rng.standard_normal((BH // G, T, d)).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    want = FD.flash_decode_plain(qt, kt, vt, kv_valid_len=valid, q_per_kv=G)
    piece = T // ranks
    parts, ref_parts, empty = [], [], 0
    for r in range(ranks):
        lo = r * piece
        n = min(max(valid - lo, 0), piece)
        empty += n == 0
        parts.append(ops.flash_decode_partials(qt, kt[:, lo:lo + piece], vt[:, lo:lo + piece],
                                               kv_valid_len=n, q_per_kv=G, kv_splits=2))
        if n:
            kr = np.repeat(k[:, lo:lo + n], G, axis=0)
            vr = np.repeat(v[:, lo:lo + n], G, axis=0)
            ref_parts.append(ref_partials(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                                          kv_splits=1, block_kv=n, interpret=True))
    assert empty >= 1
    m, l, acc = (torch.cat([p[i] for p in parts], dim=1) for i in range(3))
    assert m.shape == (BH, 2 * ranks, 1, 1)
    got = FD.combine_partials(m, l, acc)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    rm, rl, racc = (jnp.concatenate([p[i] for p in ref_parts], axis=1) for i in range(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_combine(rm, rl, racc)),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------------ the serve step
@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reduced model in float32 in both packages, the reference's
    weights and their port copy, the prompt and the decode ids."""
    over = REDUCED.get(arch, {})
    ref_cfg = replace(ref_get_config(arch).reduced(**over), compute_dtype="float32")
    cfg = replace(get_config(arch).reduced(**over), compute_dtype="float32", kernels="cuda")
    ref_api, api = ref_build_model(ref_cfg), build_model(cfg)
    ref_params = ref_api.init(jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, ref_params), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, cfg.vocab_size, size=(B, PROMPT + STEPS)).astype(np.int64)
    frames = rng.standard_normal((B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32) \
        * 0.02 if cfg.family == "audio" else None
    return ref_cfg, ref_api, ref_params, api, params, tokens, frames


@functools.lru_cache(maxsize=None)
def _unsharded(arch):
    """The port's float32 cache after the prompt (copied before decoding),
    each unsharded decode step's logits and the final cache.  The prompt is
    fed token by token, as the reference's loop feeds it: the MoE's
    one-pass prefill dispatches the whole prompt at once and may drop
    tokens at its capacity."""
    _, _, _, api, params, tokens, frames = _pair(arch)
    cache = api.init_cache(api.cfg, B, BUFFER, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        if frames is not None:
            from repro_torch.models import encdec
            memory = encdec.encode(params, torch.from_numpy(frames), api.cfg)
            cache = encdec.prepare_cross(params, memory, api.cfg, cache)
        for t in range(PROMPT):
            _, cache = api.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]), cache)
        start = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in cache.items()}
        logits = []
        for t in range(PROMPT, PROMPT + STEPS):
            out, cache = api.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]), cache)
            logits.append(out)
    return start, logits, cache


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's serve step over the same ids, the prompt fed token
    by token, its cache float32: the logits of the decode steps."""
    ref_cfg, ref_api, ref_params, _, _, tokens, frames = _pair(arch)
    step = jax.jit(ref_ss.make_serve_step(ref_api))
    cache = ref_api.init_cache(ref_cfg, B, BUFFER, jnp.float32)
    if frames is not None:
        from repro.models import encdec as ref_encdec
        memory = ref_encdec.encode(ref_params, jnp.asarray(frames), ref_cfg)
        cache = ref_encdec.prepare_cross(ref_params, memory, ref_cfg, cache)
    out = []
    for t in range(PROMPT + STEPS):
        logits, cache = step(ref_params, jnp.asarray(tokens[:, t:t + 1], jnp.int32), cache)
        if t >= PROMPT:
            out.append(np.asarray(logits))
    return out


def _attention_sites(arch, plan_name, mesh_shape):
    """(attention calls a decode step makes, whether the plan splits their
    caches over ``kv_seq``): the leading dim of every cache leaf with a
    ``kv_seq`` axis (k and cross_k, not their v)."""
    mesh = SH.Mesh(("data", "model"), mesh_shape)
    api = _pair(arch)[3]
    cache = api.init_cache(api.cfg, B, BUFFER, device="meta")
    axes = api.cache_axes()
    sh = SS.cache_shardings(api, cache, plan_named(plan_name), mesh)
    keys = [k for k in cache if "kv_seq" in axes[k] and not k.endswith("v")]
    split = {sh[k].shard_counts(5)[axes[k].index("kv_seq")] > 1 for k in keys}
    assert len(split) <= 1
    return sum(cache[k].shape[0] for k in keys), split == {True}


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_jit_serve_step_over_gloo_ranks_matches_unsharded_and_reference(mesh_shape, tmp_path):
    cases = []
    for arch, plans in PLANS.items():
        start, _, _ = _unsharded(arch)
        tokens = _pair(arch)[5]
        ids = [torch.from_numpy(tokens[:, t:t + 1]) for t in range(PROMPT, PROMPT + STEPS)]
        torch.save({"params": _pair(arch)[4], "cache": start, "ids": ids},
                   tmp_path / f"data-{arch}.pt")
        cases += [{"name": f"{arch}-{p}", "arch": arch, "plan": p, "data": f"data-{arch}.pt",
                   "reduced": REDUCED.get(arch, {})} for p in plans]
    # the CPU splits the keys as a card of 132 SMs would: ranks with more and
    # fewer valid keys must still gather partials of one shape
    spawn({"mode": "serve", "mesh": list(mesh_shape), "cases": cases, "kernels": "cuda",
           "sm_count": 132}, tmp_path)
    world = math.prod(mesh_shape)
    zero_valid_seen = False
    for case in cases:
        arch, plan = case["arch"], case["plan"]
        _, want_logits, want_cache = _unsharded(arch)
        ref_logits = _reference(arch)
        api = _pair(arch)[3]
        sites, kv_split = _attention_sites(arch, plan, mesh_shape)
        for rank in range(world):
            got = torch.load(tmp_path / f"{case['name']}.rank{rank}.pt", weights_only=False)
            assert len(got["logits"]) == STEPS
            for s in range(STEPS):
                assert got["logits"][s].shape == want_logits[s].shape
                torch.testing.assert_close(got["logits"][s], want_logits[s], rtol=0, atol=1e-5,
                                           msg=lambda m: f"{plan} rank {rank} step {s}: {m}")
                np.testing.assert_allclose(got["logits"][s].numpy(), ref_logits[s], rtol=0,
                                           atol=1e-4, err_msg=f"{plan} rank {rank} step {s}")
            assert got["index"] == PROMPT + STEPS
            mesh = SH.Mesh(("data", "model"), mesh_shape, rank=rank)
            c_sh = SS.cache_shardings(api, want_cache, plan_named(plan), mesh)
            for k, t in got["cache"].items():
                torch.testing.assert_close(t, c_sh[k].local(want_cache[k]), rtol=0, atol=1e-5,
                                           msg=lambda m: f"{plan} rank {rank} {k}: {m}")
            calls = got["calls"]
            if kv_split:
                assert calls["flash_decode_partials"] == calls["combine_partials"] \
                    == sites * STEPS and calls["flash_decode"] == 0, (arch, plan, calls)
                key = "attn_k" if arch == HYBRID else "k"
                off = c_sh[key].index(want_cache[key].shape)[2].start
                zero_valid_seen |= off >= PROMPT + STEPS
            else:
                assert calls["flash_decode"] == sites * STEPS and \
                    calls["flash_decode_partials"] == calls["combine_partials"] == 0, \
                    (arch, plan, calls)
    if mesh_shape[1] > 1:
        assert zero_valid_seen


# the plans each family's prompt pass into a split cache is held under
PREFILL_PLANS = {DENSE: ("kv_sequence_split", "sequence_parallel"),
                 ENCDEC: ("kv_sequence_split", "megatron_tp")}


@functools.lru_cache(maxsize=None)
def _prefilled(arch):
    """The port's unsharded one-pass prefill of the prompt into an empty
    float32 cache (its last-token logits and a copy of the cache), then
    each decode step's logits and the final cache."""
    _, _, _, api, params, tokens, frames = _pair(arch)
    inputs = {} if frames is None else {"frames": torch.from_numpy(frames)}
    cache = api.init_cache(api.cfg, B, BUFFER, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        first, cache = api.prefill(params, torch.from_numpy(tokens[:, :PROMPT]), cache,
                                   **inputs)
        after = {k: v.clone() for k, v in cache.items() if isinstance(v, torch.Tensor)}
        logits = []
        for t in range(PROMPT, PROMPT + STEPS):
            out, cache = api.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]), cache)
            logits.append(out)
    return first, after, logits, cache


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_prompt_pass_into_a_split_cache_matches_the_unsharded_prefill(mesh_shape, tmp_path):
    cases = []
    for arch, plans in PREFILL_PLANS.items():
        _, _, _, api, params, tokens, frames = _pair(arch)
        empty = api.init_cache(api.cfg, B, BUFFER, dtype=torch.float32, device="cpu")
        ids = [torch.from_numpy(tokens[:, t:t + 1]) for t in range(PROMPT, PROMPT + STEPS)]
        inputs = {} if frames is None else {"frames": torch.from_numpy(frames)}
        torch.save({"params": params, "cache": empty, "ids": ids, "inputs": inputs,
                    "prompt": torch.from_numpy(tokens[:, :PROMPT])},
                   tmp_path / f"prompt-{arch}.pt")
        cases += [{"name": f"{arch}-{p}", "arch": arch, "plan": p, "data": f"prompt-{arch}.pt",
                   "reduced": REDUCED.get(arch, {})} for p in plans]
    # a prompt pass handed a cross K/V split over kv_seq that it did not project
    cases.append(dict(cases[-2], name=f"{ENCDEC}-gather-cross", gather_cross=True))
    assert cases[-1]["plan"] == "kv_sequence_split"
    spawn({"mode": "serve", "mesh": list(mesh_shape), "cases": cases, "kernels": "cuda",
           "sm_count": 132}, tmp_path)
    for case in cases:
        arch, plan = case["arch"], case["plan"]
        first, after, want_logits, want_cache = _prefilled(arch)
        api = _pair(arch)[3]
        for rank in range(math.prod(mesh_shape)):
            got = torch.load(tmp_path / f"{case['name']}.rank{rank}.pt", weights_only=False)
            what = f"{arch} {plan} {mesh_shape} rank {rank}"
            mesh = SH.Mesh(("data", "model"), mesh_shape, rank=rank)
            c_sh = SS.cache_shardings(api, after, plan_named(plan), mesh)
            pre = got["prefill"]
            assert pre["index"] == PROMPT, what
            split = [k for k, t in pre["cache"].items() if t.shape != after[k].shape]
            assert split, (what, "the plan splits no cache leaf")
            for k, t in pre["cache"].items():
                torch.testing.assert_close(t, c_sh[k].local(after[k]), rtol=0, atol=1e-5,
                                           msg=lambda m: f"{what} prefill {k}: {m}")
            torch.testing.assert_close(pre["logits"], first, rtol=0, atol=1e-5,
                                       msg=lambda m: f"{what} prefill logits: {m}")
            for s in range(STEPS):
                torch.testing.assert_close(got["logits"][s], want_logits[s], rtol=0, atol=1e-5,
                                           msg=lambda m: f"{what} step {s}: {m}")
            for k, t in got["cache"].items():
                torch.testing.assert_close(t, c_sh[k].local(want_cache[k]), rtol=0, atol=1e-5,
                                           msg=lambda m: f"{what} {k}: {m}")


@pytest.mark.parametrize("mesh_shape", [(16, 16), (32, 8)])
def test_serve_step_placements_match_reference_jit_serve_step(mesh_shape, monkeypatch):
    """Token, parameter and cache specs of the port's serve step equal the
    in-shardings the reference's ``jit_serve_step`` hands ``jax.jit`` at the
    decode cell's shapes, for the decode plans and every family with a
    cache (``jax.jit`` is replaced by a recorder: nothing is compiled)."""
    from repro.configs.shapes import DECODE_32K as REF_DECODE
    from repro_torch.configs.shapes import DECODE_32K
    from test_torch_parallel import _port_specs, _ref_mesh, _ref_specs
    seen = {}
    monkeypatch.setattr(ref_ss.jax, "jit", lambda fn, **kw: seen.update(kw) or fn)
    ref_mesh = _ref_mesh(mesh_shape)
    mesh = SH.Mesh(("data", "model"), mesh_shape)
    for arch in ("qwen2.5-3b", "qwen3-moe-30b-a3b", "rwkv6-3b", "zamba2-1.2b",
                 "seamless-m4t-medium"):
        ref_api, api = ref_build_model(ref_get_config(arch)), build_model(get_config(arch))
        ref_specs, specs = ref_api.input_specs(REF_DECODE), api.input_specs(DECODE_32K)
        tshape = tuple(specs["tokens"].shape)
        for name in ("kv_sequence_split", "kv_split_zero3", "megatron_tp", "pure_dp"):
            ref_ss.jit_serve_step(ref_api, _ref_plan(name), ref_mesh, ref_specs["cache"],
                                  tokens_shape=tshape)
            p_in, t_in, c_in = seen["in_shardings"]
            plan = plan_named(name)
            assert tuple(SS.token_sharding(plan, mesh, tshape).spec) == tuple(t_in.spec)
            assert _port_specs(SS.param_shardings(api, plan, mesh)) == _ref_specs(p_in), \
                (arch, name)
            assert _port_specs(SS.cache_shardings(api, specs["cache"], plan, mesh)) == \
                _ref_specs(c_in), (arch, name)
            assert seen["out_shardings"][0] is None and seen["donate_argnums"] == (2,)


def _ref_plan(name):
    from repro.configs.shapes import DECODE_32K as REF_DECODE
    from repro.parallel import planner_bridge as RPB
    from repro.parallel import sharding as RSH
    if name in RSH.FIXED_PLANS:
        return RSH.FIXED_PLANS[name]()
    return next(p for p in RPB.candidate_plans(ref_get_config(DENSE), REF_DECODE)
                if p.name == name)
