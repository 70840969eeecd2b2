"""The port's MoE family and its grouped-GEMM wrapper against the reference, on
the CPU: the kernel wrapper, the MoE functions one by one (``_capacity``,
``_router`` with its aux loss, ``_dispatch_ffn_combine`` with and without
dropped tokens), the whole reduced models, prefill, serve, and how
``serve.load_params`` and the port's init draw the weights.  Inputs are made
with numpy from a seed; weights come from the reference's ``api.init`` and are
carried across through numpy.  The reference runs with ``kernels="pallas"``
(its grouped matmul in interpret mode), so the path the port's kernel
replaces is the one held against.  float32 at 1e-4 (the frameworks sum in
another order), bfloat16 at 2e-2."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import moe_gmm as ref_moe_gmm
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.kernels import moe_gmm, ops, ref
from repro_torch.launch import common, serve
from repro_torch.models import build_model, moe
from repro_torch.models import param as P
from repro_torch.models.convert import from_reference

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]
B, S = 2, 8


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _drops(expert_idx, n_experts: int, cap: int) -> int:
    """(token, slot) pairs beyond capacity for one dispatch."""
    counts = np.bincount(np.asarray(expert_idx).reshape(-1), minlength=n_experts)
    return int(np.maximum(counts - cap, 0).sum())


# ------------------------------------------------------------- K4 wrapper
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_matches_reference_kernel(dtype):
    """The sweep of tests/test_kernels.py plus two ragged caps (24 and the
    decode cap of 8) and a d_out that 128 does not divide."""
    rng = np.random.default_rng(0)
    for E, cap, din, dout in [(4, 128, 128, 128), (8, 256, 128, 256), (4, 24, 128, 128),
                              (3, 8, 64, 192)]:
        xj, xt = _pair(rng, (E, cap, din), dtype)
        wj, wt = _pair(rng, (E, din, dout), dtype)
        want = ref_moe_gmm.grouped_matmul(
            xj, wj, block=(128, 128 if dout % 128 == 0 else 64, 128),
            out_dtype=jnp.float32, interpret=True)
        got = ops.grouped_matmul(xt, wt, out_dtype=torch.float32)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
        direct = moe_gmm.grouped_matmul(xt, wt, block=(64, 64, 32), out_dtype=torch.float32)
        np.testing.assert_allclose(_np(direct), _np(want), **_tol(dtype))
        np.testing.assert_allclose(
            _np(ref.grouped_matmul_ref(xt, wt, out_dtype=torch.float32)), _np(want),
            **_tol(dtype))


def test_grouped_matmul_checks_and_keeps_the_dtype():
    x = torch.randn(2, 8, 16, dtype=torch.bfloat16)
    w = torch.randn(2, 16, 24, dtype=torch.bfloat16)
    assert ops.grouped_matmul(x, w).dtype == torch.bfloat16
    assert ops.grouped_matmul(x, w, out_dtype=torch.float32).dtype == torch.float32
    before = moe_gmm.launches
    with pytest.raises(ValueError, match="E, cap, d_in"):
        moe_gmm.grouped_matmul(x, w[:, :8])
    with pytest.raises(TypeError):
        moe_gmm.grouped_matmul(x, w.float())
    # a transpose of a contiguous tensor is taken as it lies (the backward's
    # operands); any other strided layout is refused
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(moe_gmm.grouped_matmul(xt, w), moe_gmm.grouped_matmul(x, w))
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.grouped_matmul(torch.randn(2, 8, 32, dtype=torch.bfloat16)[:, :, ::2], w)
    assert moe_gmm.launches == before          # the CPU runs the plain version


# ------------------------------------------------------ MoE functions alone
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_capacity_matches_reference(arch, reduced):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    for tokens in (1, 4, 8, 9, 64, 100, 2048, 4096):
        for cf in (0.25, 1.0, 1.25, 4.0):
            got = moe._capacity(tokens, replace(cfg, capacity_factor=cf))
            want = ref_moe._capacity(tokens, replace(ref_cfg, capacity_factor=cf))
            assert got == want and got % 8 == 0, (tokens, cf)
    assert moe._capacity(4 * 512, get_config("qwen3-moe-30b-a3b")) == 160
    assert moe._capacity(4, get_config("qwen3-moe-30b-a3b")) == 8


def _router_inputs(arch, T=64, seed=1):
    ref_cfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    xj, xt = _pair(rng, (T, cfg.d_model), "float32")
    rj, rt = _pair(rng, (cfg.d_model, cfg.n_experts), "float32", scale=0.3)
    return cfg, ref_cfg, xj, xt, rj, rt


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_reference_with_aux_loss(arch):
    cfg, ref_cfg, xj, xt, rj, rt = _router_inputs(arch)
    gv_r, idx_r, aux_r = ref_moe._router(xj, rj, ref_cfg)
    gv, idx, aux = moe._router(xt, rt, cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_allclose(_np(gv), _np(gv_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)
    assert aux.dtype == torch.float32 and float(aux) > 0


def _dispatch_pair(arch, kernels, cf, dtype="float32", T=64):
    cfg, ref_cfg, xj, xt, rj, rt = _router_inputs(arch, T=T)
    cfg = replace(cfg, kernels=kernels, capacity_factor=cf)
    ref_cfg = replace(ref_cfg, kernels="pallas" if kernels == "cuda" else "xla",
                      capacity_factor=cf)
    rng = np.random.default_rng(2)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    ws = [_pair(rng, shape, "float32", scale=shape[1] ** -0.5)
          for shape in ((E, d, f), (E, d, f), (E, f, d))]
    gv_r, idx_r, _ = ref_moe._router(xj, rj, ref_cfg)
    gv, idx = torch.from_numpy(np.array(gv_r)), torch.from_numpy(np.array(idx_r))
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    cap = moe._capacity(T, cfg)
    want = ref_moe._dispatch_ffn_combine(xj, *(w[0] for w in ws), gv_r, idx_r, ref_cfg,
                                         0, E, cap)
    got = moe._dispatch_ffn_combine(xt, *(w[1] for w in ws), gv, idx, cfg, 0, E, cap)
    return got, want, _drops(idx_r, E, cap)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernels", ["cuda", "plain"])
def test_dispatch_ffn_combine_matches_reference(arch, kernels):
    got, want, drops = _dispatch_pair(arch, kernels, cf=4.0)
    assert drops == 0
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_ffn_combine_matches_reference_when_tokens_drop(arch):
    got, want, drops = _dispatch_pair(arch, "cuda", cf=0.25)
    assert drops > 0
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    # a dropped (token, slot) pair contributes nothing: some rows lose weight
    full, _, _ = _dispatch_pair(arch, "cuda", cf=4.0)
    assert np.abs(_np(full) - _np(got)).max() > 1e-3


def test_dispatch_ffn_combine_bfloat16_matches_reference():
    got, want, _ = _dispatch_pair("qwen3-moe-30b-a3b", "cuda", cf=1.25, dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


# ----------------------------------------------------------- whole model
class Pair:
    """One MoE architecture, reduced, in both packages with the same weights."""

    def __init__(self, arch, compute="float32", capacity_factor=1.25):
        base = dict(compute_dtype=compute, capacity_factor=capacity_factor)
        self.ref_cfg = replace(ref_get_config(arch).reduced(), kernels="pallas", **base)
        self.cfg = replace(get_config(arch).reduced(), kernels="cuda", **base)
        self.ref_api = ref_build_model(self.ref_cfg)
        self.api = build_model(self.cfg)
        self.ref_params = self.ref_api.init(jax.random.PRNGKey(0))
        self.params = from_reference(jax.tree.map(np.asarray, self.ref_params), "cpu")
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(1, self.cfg.vocab_size, size=(B, S)).astype(np.int32)
        self.ref_decode = jax.jit(self.ref_api.decode_step)

    def ref_forward(self, tokens):
        return jax.jit(lambda p, t: ref_moe.forward(p, t, self.ref_cfg))(
            self.ref_params, jnp.asarray(tokens))

    def ref_loop(self, tokens, max_len):
        """The reference's serving prefill: the prompt fed token by token."""
        cache = self.ref_api.init_cache(self.ref_cfg, tokens.shape[0], max_len,
                                        jnp.float32)
        all_logits = []
        for t in range(tokens.shape[1]):
            logits, cache = self.ref_decode(self.ref_params,
                                            jnp.asarray(tokens[:, t:t + 1]), cache)
            all_logits.append(logits)
        return all_logits, cache

    def prefill(self, tokens):
        cache = self.api.init_cache(self.cfg, tokens.shape[0], tokens.shape[1] + 2,
                                    dtype=torch.float32, device="cpu")
        with torch.no_grad():
            return self.api.prefill(self.params, torch.from_numpy(tokens).long(), cache)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_moe_weights_carry_across(pair):
    got, spec = _flat(pair.params), _flat(pair.api.spec)
    assert set(got) == set(spec)
    assert all(tuple(got[k].shape) == spec[k].shape for k in spec)
    assert pair.api.n_params() == pair.ref_api.n_params()
    moe_p = pair.params["blocks"]["moe"]
    assert moe_p["w_gate"].shape == (pair.cfg.n_layers, pair.cfg.n_experts,
                                     pair.cfg.d_model, pair.cfg.moe_d_ff)
    assert ("shared" in moe_p) == bool(pair.cfg.n_shared_experts)


def test_forward_logits_and_aux_match_reference(pair):
    want, want_aux = pair.ref_forward(pair.tokens)
    with torch.no_grad():
        got, aux = pair.api.logits_fn(pair.params,
                                      {"tokens": torch.from_numpy(pair.tokens).long()}), \
            moe.forward(pair.params, torch.from_numpy(pair.tokens).long(), pair.cfg)[1]
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)


def test_decode_steps_and_cache_match_reference_for_six_tokens(pair):
    all_ref, ref_cache = pair.ref_loop(pair.tokens[:, :6], max_len=9)
    cache = pair.api.init_cache(pair.cfg, B, 9, dtype=torch.float32, device="cpu")
    step = serve.make_serve_step(pair.api)
    for t in range(6):
        logits, cache = step(pair.params, torch.from_numpy(pair.tokens[:, t:t + 1]).long(),
                             cache)
        np.testing.assert_allclose(_np(logits), _np(all_ref[t]), rtol=1e-4, atol=1e-4)
    assert cache["index"] == int(ref_cache["index"]) == 6
    np.testing.assert_allclose(_np(cache["k"]), _np(ref_cache["k"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(cache["v"]), _np(ref_cache["v"]), rtol=1e-5, atol=1e-5)


def test_prefill_equals_reference_forward_last_token(pair):
    want, _ = pair.ref_forward(pair.tokens)
    logits, cache = pair.prefill(pair.tokens)
    assert logits.shape == (B, 1, pair.cfg.padded_vocab) and cache["index"] == S
    np.testing.assert_allclose(_np(logits[:, 0]), _np(want[:, -1]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_token_by_token_loop_when_nothing_drops(arch):
    """capacity_factor = E / k lets one expert take every prompt token."""
    cfg = get_config(arch).reduced()
    p = Pair(arch, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    all_ref, ref_cache = p.ref_loop(p.tokens, max_len=S + 2)
    logits, cache = p.prefill(p.tokens)
    np.testing.assert_allclose(_np(logits), _np(all_ref[-1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(cache["k"]), _np(ref_cache["k"][:, :, :S + 2]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_differs_from_token_by_token_loop_when_tokens_drop(arch, monkeypatch):
    """The capacity trap: a whole-prompt pass drops tokens the loop keeps."""
    p = Pair(arch, capacity_factor=0.25)
    routed = []
    real = moe._router

    def spy(xf, router_w, cfg):
        out = real(xf, router_w, cfg)
        routed.append(out[1])
        return out

    monkeypatch.setattr(moe, "_router", spy)
    logits, _ = p.prefill(p.tokens)
    cap = moe._capacity(B * S, p.cfg)
    assert len(routed) == p.cfg.n_layers
    assert sum(_drops(idx.numpy(), p.cfg.n_experts, cap) for idx in routed) > 0
    want, _ = p.ref_forward(p.tokens)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(want[:, -1]), rtol=1e-4, atol=1e-4)
    all_ref, _ = p.ref_loop(p.tokens, max_len=S + 2)
    assert np.abs(_np(logits) - _np(all_ref[-1])).max() > 1e-3


def _coarse(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` in float32 rounded (half away from zero) to ``bits`` explicit
    mantissa bits; bfloat16 keeps 7."""
    drop = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_forward_matches_reference_on_its_routing(arch, monkeypatch):
    """In bfloat16 a near-flat random router turns rounding differences into
    other top-k experts, so the port replays the reference's routing (the
    chip's kernel-vs-plain comparison does the same) and only the rest of
    the model is compared; most choices agree even without it.

    Both bfloat16 paths are held against the same model computed in float32
    (the port's plain path on the bfloat16-rounded weights, the same
    routing): the port may be at most 1.25 x as far from it as the
    reference is, in the largest difference (plus 2e-2) and in the root
    mean square.  A control whose expert products keep 5 mantissa bits
    instead of bfloat16's 7 must fail that bound."""
    p = Pair(arch, compute="bfloat16")
    recorded = []
    ref_router = ref_moe._router

    def ref_spy(xf, router_w, cfg):
        out = ref_router(xf, router_w, cfg)
        jax.debug.callback(lambda g, i: recorded.append((np.array(g), np.array(i))),
                           out[0], out[1], ordered=True)
        return out

    monkeypatch.setattr(ref_moe, "_router", ref_spy)
    want, _ = p.ref_forward(p.tokens)
    jax.effects_barrier()
    assert len(recorded) == p.cfg.n_layers
    port_router, agree = moe._router, []

    def port_forward(cfg, params):
        replay = iter(recorded)

        def replaying(xf, router_w, c):
            _, idx, aux = port_router(xf, router_w, c)
            gate_vals, expert_idx = next(replay)
            agree.append(float((idx.numpy() == expert_idx).mean()))
            return torch.from_numpy(gate_vals), torch.from_numpy(expert_idx).long(), aux

        monkeypatch.setattr(moe, "_router", replaying)
        with torch.no_grad():
            return moe.forward(params, torch.from_numpy(p.tokens).long(), cfg)[0]

    got = port_forward(p.cfg, p.params)
    assert got.dtype == torch.bfloat16
    exact = port_forward(replace(p.cfg, kernels="plain", compute_dtype="float32"),
                         P.tree_map(lambda t: t.to(torch.bfloat16).float(), p.params,
                                    is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert min(agree) > 0.5

    plain = moe_gmm.grouped_matmul_plain

    def five_bits(x, w, *, block=None, out_dtype=None):
        return _coarse(plain(x, w, out_dtype=torch.float32), 5).to(out_dtype or x.dtype)

    monkeypatch.setattr(moe_gmm, "grouped_matmul_plain", five_bits)
    control = port_forward(p.cfg, p.params)

    def within(x):
        diff, base = _np(x) - _np(exact), _np(want) - _np(exact)
        return np.abs(diff).max() <= 1.25 * np.abs(base).max() + 2e-2 and \
            np.sqrt((diff ** 2).mean()) <= 1.25 * np.sqrt((base ** 2).mean())

    assert within(got)
    assert not within(control)


def test_decode_step_takes_one_token_per_sequence(pair):
    cache = pair.api.init_cache(pair.cfg, B, S, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="one token per sequence"):
        moe.decode_step(pair.params, torch.from_numpy(pair.tokens[:, :2]).long(), cache,
                        pair.cfg)


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu_serves_the_moe(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--tokens", "4", "--seed", "1"])
    out = capsys.readouterr().out
    assert res.generated.shape == (2, 4)
    assert "kernel launches:" in out and "grouped_matmul=0" in out
    assert f"{arch}-reduced on cpu" in out


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2.5-3b"])
def test_load_params_draws_every_leaf_in_the_compute_dtype(arch, monkeypatch):
    asked = []
    real = P._init_leaf

    def spy(generator, spec, device):
        asked.append(spec)
        return real(generator, spec, device)

    monkeypatch.setattr(P, "_init_leaf", spy)
    cfg = common.launch_config(arch, reduced=True)
    api = build_model(cfg)
    params = serve.load_params(api, "cpu", seed=0)
    leaves = P.tree_leaves(params, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(asked) == len(leaves) == len(P.tree_leaves(api.spec))
    assert {s.dtype for s in asked} == {torch.bfloat16}
    assert {t.dtype for t in leaves} == {torch.bfloat16}
    again = serve.load_params(api, "cpu", seed=0)
    first = P.tree_leaves(again, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert all(torch.equal(a, b) for a, b in zip(leaves, first))


def test_expert_weights_are_drawn_as_the_reference_draws_them():
    """The port's init draws every leaf with the reference's scale: the fan-in
    is the first non-layer dimension, so the stacked expert weights (E, d, f)
    and (E, f, d) take std E ** -0.5, as ``repro.models.param`` gives them."""
    cfg = replace(get_config("qwen3-moe-30b-a3b").reduced(), n_experts=64, d_model=256,
                  moe_d_ff=32)
    ref_cfg = replace(ref_get_config("qwen3-moe-30b-a3b").reduced(), n_experts=64,
                      d_model=256, moe_d_ff=32)
    got = _flat(build_model(cfg).init(torch.Generator().manual_seed(0), "cpu"))
    want = _flat(ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    assert set(got) == set(want)
    for key, w in want.items():
        w, g = np.asarray(w, np.float32), _np(got[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if w.size >= 4096:
            assert abs(g.std() - w.std()) <= 0.03 * w.std() + 1e-6, (key, g.std(), w.std())
            assert abs(g.mean() - w.mean()) <= 0.03 * w.std() + 1e-6, key
    assert abs(float(want[("blocks", "moe", "w_gate")].std()) * 64 ** 0.5 - 1.0) < 0.02
