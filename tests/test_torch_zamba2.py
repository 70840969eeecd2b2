"""The port's Mamba2 block and zamba2 hybrid against the reference, on the CPU:
the chunked SSD scan (against a step-by-step recurrence and the reference's),
the causal conv, both branches of ``mamba2_apply``, the reduced model's
weights, forward logits, decode steps, one-pass prefill and cache.  Inputs
are made with numpy from a seed; weights come from the reference's
``api.init`` (with the biases, the skip ``D`` and the decays drawn at random,
so that they matter) and are carried across through numpy.  The reference
runs ``kernels="xla"`` and ``kernels="pallas"`` (its Pallas kernels in
interpret mode), beside the port's ``plain`` and ``cuda`` paths (on CPU
tensors the kernel wrappers run their plain versions).  Tolerances: the scan
and the block at 1e-5 in float32; the model at 1e-4 in float32 (the two
frameworks sum in another order); bfloat16 by the float32 rule stated in
:func:`test_bfloat16_forward_is_as_close_to_float32_as_the_reference`."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import mamba2 as ref_mamba2
from repro.models import zamba2 as ref_zamba2
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model, mamba2, zamba2
from repro_torch.models import param as P
from repro_torch.models.convert import cache_from_reference, from_reference

ARCH = "zamba2-1.2b"
B, S = 2, 8


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _ssd_inputs(rng, Bsz, T, H, dh, ds):
    x = rng.standard_normal((Bsz, T, H, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, T, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((Bsz, T, ds)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, T, ds)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _ssd_steps(x, dt, A, Bm, Cm, h0):
    """The recurrence one token at a time, in float64."""
    h = h0.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        decay = np.exp(dt[:, t] * A[None, :])                       # (B,H)
        upd = np.einsum("bhd,bs->bhds", x[:, t] * dt[:, t][..., None], Bm[:, t])
        h = h * decay[:, :, None, None] + upd
        ys.append(np.einsum("bs,bhds->bhd", Cm[:, t], h))
    return np.stack(ys, axis=1), h


# ------------------------------------------------------------ SSD scan
@pytest.mark.parametrize("T,chunk,with_h0", [(64, 32, False), (64, 16, True), (24, 32, True),
                                             (8, 4, False)])
def test_ssd_chunked_matches_recurrence_and_reference(T, chunk, with_h0):
    """float32 at 1e-5: the chunked scan's output and final state against the
    token-by-token recurrence (float64) and against the reference's scan,
    from zero or from a carried state ``h0``.  T 24 runs one chunk of 24."""
    rng = np.random.default_rng(T + chunk)
    Bsz, H, dh, ds = 2, 3, 8, 4
    xs = _ssd_inputs(rng, Bsz, T, H, dh, ds)
    h0 = rng.standard_normal((Bsz, H, dh, ds)).astype(np.float32) if with_h0 \
        else np.zeros((Bsz, H, dh, ds), np.float32)
    y, h = mamba2.ssd_chunked(*map(_t, xs), h0=_t(h0) if with_h0 else None, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32 and y.shape == (Bsz, T, H, dh)
    want_y, want_h = _ssd_steps(*xs, h0)
    np.testing.assert_allclose(_np(y), want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h), want_h, rtol=1e-5, atol=1e-5)
    ref_y, ref_h = ref_mamba2.ssd_chunked(*map(jnp.asarray, xs),
                                          h0=jnp.asarray(h0) if with_h0 else None,
                                          chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(ref_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h), _np(ref_h), rtol=1e-5, atol=1e-5)


def test_ssd_chunked_stays_finite_when_decays_are_strong():
    """The clamp before ``exp``: with dt A down to -40 a step, the masked
    upper triangle's e^{cum[t] - cum[s]} would overflow to inf and inf * 0
    would give nan; the scan stays finite and equal to the recurrence."""
    rng = np.random.default_rng(3)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 32, 2, 4, 4)
    dt = dt * 20.0
    y, h = mamba2.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want_y, _ = _ssd_steps(x, dt, A, Bm, Cm, np.zeros((1, 2, 4, 4)))
    np.testing.assert_allclose(_np(y), want_y, rtol=1e-5, atol=1e-5)


def test_ssd_chunked_refuses_a_length_its_chunk_does_not_divide():
    """The reference asserts ``T % min(chunk, T) == 0``; the port raises a
    ValueError at the same lengths."""
    xs = _ssd_inputs(np.random.default_rng(0), 1, 40, 2, 4, 4)
    with pytest.raises(ValueError, match="divisible"):
        mamba2.ssd_chunked(*map(_t, xs), chunk=32)
    with pytest.raises(AssertionError):
        ref_mamba2.ssd_chunked(*map(jnp.asarray, xs), chunk=32)
    y, _ = mamba2.ssd_chunked(*map(_t, xs), chunk=8)
    assert y.shape == (1, 40, 2, 4)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(int(with_state))
    x = rng.standard_normal((2, 6, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    state = rng.standard_normal((2, 3, 10)).astype(np.float32) if with_state else None
    y, new = mamba2._causal_conv(_t(x), _t(w), _t(b), None if state is None else _t(state))
    ref_y, ref_new = ref_mamba2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                             None if state is None else jnp.asarray(state))
    np.testing.assert_allclose(_np(y), _np(ref_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(new), _np(ref_new))
    np.testing.assert_array_equal(_np(new), x[:, -3:])


# ----------------------------------------------------------- whole model
class Pair:
    """zamba2-1.2b reduced (4 Mamba2 layers in 2 groups of 2, d_model 128, 4
    SSD heads of 64, state 16) in both packages with the same weights.
    ``path`` is the reference's kernel switch: "pallas" pairs with the
    port's "cuda", "xla" with "plain"."""

    def __init__(self, path="pallas", compute="float32"):
        self.ref_cfg = replace(ref_get_config(ARCH).reduced(), kernels=path,
                               compute_dtype=compute)
        self.cfg = replace(get_config(ARCH).reduced(),
                           kernels="cuda" if path == "pallas" else "plain",
                           compute_dtype=compute)
        self.ref_api = ref_build_model(self.ref_cfg)
        self.api = build_model(self.cfg)
        weights = jax.tree.map(np.asarray, self.ref_api.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(3)
        m = weights["blocks"]["mamba"]
        for name in ("conv_b", "dt_bias", "D"):
            m[name] = (rng.standard_normal(m[name].shape) * 0.5).astype(m[name].dtype)
        self.weights = weights
        self.ref_params = jax.tree.map(jnp.asarray, weights)
        self.params = from_reference(weights, "cpu")
        self.tokens = np.random.default_rng(0).integers(
            1, self.cfg.vocab_size, size=(B, 64)).astype(np.int32)
        self.ref_decode = jax.jit(self.ref_api.decode_step)
        self.ref_fwd = jax.jit(lambda p, t: ref_zamba2.forward(p, t, self.ref_cfg))

    def forward(self, tokens, cfg=None, params=None):
        with torch.no_grad():
            return zamba2.forward(self.params if params is None else params,
                                  torch.from_numpy(tokens).long(), cfg or self.cfg)

    def ref_loop(self, tokens, max_len, dtype=jnp.float32):
        """The reference's serving prefill: the prompt fed token by token."""
        cache = self.ref_api.init_cache(self.ref_cfg, tokens.shape[0], max_len, dtype)
        all_logits = []
        for t in range(tokens.shape[1]):
            logits, cache = self.ref_decode(self.ref_params, jnp.asarray(tokens[:, t:t + 1]),
                                            cache)
            all_logits.append(logits)
        return all_logits, cache

    def prefill(self, tokens, max_len, dtype=torch.float32):
        cache = self.api.init_cache(self.cfg, tokens.shape[0], max_len, dtype=dtype,
                                    device="cpu")
        with torch.no_grad():
            return self.api.prefill(self.params, torch.from_numpy(tokens).long(), cache)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_mamba2_apply_both_branches_match_reference(pair):
    """One layer's block in float32 at 1e-5: the chunked prompt branch (its
    output and the (ssd, conv) pair it ends with) and the single-token
    recurrence from a random state."""
    rng = np.random.default_rng(11)
    p_ref = jax.tree.map(lambda w: w[1, 0], pair.ref_params["blocks"]["mamba"])
    p = P.tree_map(lambda w: w[1, 0], pair.params["blocks"]["mamba"],
                   is_leaf=lambda t: isinstance(t, torch.Tensor))
    x = rng.standard_normal((B, 32, pair.cfg.d_model)).astype(np.float32)
    got, (ssd, conv) = mamba2.mamba2_apply(p, _t(x), pair.cfg)
    want, (ref_ssd, ref_conv) = ref_mamba2.mamba2_apply(p_ref, jnp.asarray(x), pair.ref_cfg)
    for a, b in ((got, want), (ssd, ref_ssd), (conv, ref_conv)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    x1 = x[:, :1]
    state = rng.standard_normal(ref_ssd.shape).astype(np.float32)
    cstate = rng.standard_normal(ref_conv.shape).astype(np.float32)
    got, (ssd, conv) = mamba2.mamba2_apply(p, _t(x1), pair.cfg, ssd_state=_t(state),
                                           conv_state=_t(cstate))
    want, (ref_ssd, ref_conv) = ref_mamba2.mamba2_apply(
        p_ref, jnp.asarray(x1), pair.ref_cfg, ssd_state=jnp.asarray(state),
        conv_state=jnp.asarray(cstate))
    assert ssd.dtype == torch.float32
    for a, b in ((got, want), (ssd, ref_ssd), (conv, ref_conv)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


def test_zamba2_weights_carry_across(pair):
    """The (G, A, ...) stacked Mamba2 blocks and the one shared attention
    tree, with no per-site copy, carry across unchanged."""
    got, spec = _flat(pair.params), _flat(pair.api.spec)
    assert set(got) == set(spec) == set(_flat(pair.weights))
    assert all(tuple(got[k].shape) == spec[k].shape for k in spec)
    for k, w in _flat(pair.weights).items():
        np.testing.assert_array_equal(_np(got[k]), w)
    assert pair.params["blocks"]["mamba"]["in_proj"].shape[:2] == (2, 2)
    assert pair.params["shared_attn"]["attn"]["wq"].shape == (128, 4, 32)
    assert pair.api.n_params() == pair.ref_api.n_params()
    assert build_model(get_config(ARCH)).n_params() == 1_170_473_856


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_forward_logits_match_reference_in_float32(path, pair):
    p = pair if path == "pallas" else Pair(path)
    tokens = p.tokens[:, :32]
    want = p.ref_fwd(p.ref_params, jnp.asarray(tokens))
    got = p.forward(tokens)
    assert got.shape == want.shape == (B, 32, p.cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_bfloat16_forward_is_as_close_to_float32_as_the_reference():
    """Two correct bfloat16 paths through this hybrid end a few bfloat16 ulps
    apart, so the port's bfloat16 logits are held, with the reference's,
    against the same model in float32 (the port's plain path on the
    bfloat16-rounded weights): the port at most 1.25 x as far from it as the
    reference, in the largest difference (plus 2e-2) and in the root mean
    square."""
    p = Pair("pallas", compute="bfloat16")
    tokens = p.tokens[:, :32]
    want = _np(p.ref_fwd(p.ref_params, jnp.asarray(tokens)))
    got = p.forward(tokens)
    assert got.dtype == torch.bfloat16
    exact = _np(p.forward(tokens, replace(p.cfg, kernels="plain", compute_dtype="float32"),
                          P.tree_map(lambda t: t.to(torch.bfloat16).float(), p.params,
                                     is_leaf=lambda t: isinstance(t, torch.Tensor))))
    diff, base = _np(got) - exact, want - exact
    assert np.abs(diff).max() <= 1.25 * np.abs(base).max() + 2e-2
    assert np.sqrt((diff ** 2).mean()) <= 1.25 * np.sqrt((base ** 2).mean())


def test_decode_steps_and_cache_match_reference_for_six_tokens(pair):
    """float32 with a float32 cache: logits at 1e-4, the SSD and conv states
    and every attention site's KV slot at 1e-4."""
    all_ref, ref_cache = pair.ref_loop(pair.tokens[:, :6], max_len=9)
    cache = pair.api.init_cache(pair.cfg, B, 9, dtype=torch.float32, device="cpu")
    assert cache["ssd"].dtype == torch.float32 and cache["attn_k"].shape[0] == 2
    step = serve.make_serve_step(pair.api)
    for t in range(6):
        logits, cache = step(pair.params, torch.from_numpy(pair.tokens[:, t:t + 1]).long(),
                             cache)
        np.testing.assert_allclose(_np(logits), _np(all_ref[t]), rtol=1e-4, atol=1e-4)
    assert cache["index"] == int(ref_cache["index"]) == 6
    for name in ("ssd", "conv", "attn_k", "attn_v"):
        np.testing.assert_allclose(_np(cache[name]), _np(ref_cache[name]), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("prompt_len", [8, 64])
def test_prefill_equals_reference_token_by_token_loop(pair, prompt_len):
    """The port's one-pass prefill (each layer's chunked scan and the pair it
    ends with, each site's KV written by the cached prompt pass) equals the
    reference's serving prefill, which feeds the prompt to ``decode_step``
    token by token: the same SSD and conv states, KV contents, index and last
    logits, in float32 with a float32 cache, at 1e-4.  64 tokens run the scan
    as two chunks of 32."""
    tokens = pair.tokens[:, :prompt_len]
    all_ref, ref_cache = pair.ref_loop(tokens, max_len=prompt_len + 3)
    logits, cache = pair.prefill(tokens, prompt_len + 3)
    assert logits.shape == (B, 1, pair.cfg.padded_vocab)
    assert cache["index"] == prompt_len == int(ref_cache["index"])
    np.testing.assert_allclose(_np(logits), _np(all_ref[-1]), rtol=1e-4, atol=1e-4)
    for name in ("ssd", "conv", "attn_k", "attn_v"):
        np.testing.assert_allclose(_np(cache[name]), _np(ref_cache[name]), rtol=1e-4,
                                   atol=1e-4)


def test_bfloat16_cache_gap_is_the_reference_s_own(pair):
    """Pins a property of the reference, so that it is not taken for a port
    fault: in float32 the reference's ``forward`` and its own token loop
    with the default bfloat16 cache (the conv state and KV rounded at every
    step) end 1e-3 to 1e-1 apart on the last logits (0.0031 with these
    weights at batch 2, T 64; 0.013 with the reference's plain init), and
    within 1e-4 with a float32 cache.  The port's prefill and its own token
    loop with a bfloat16 cache end as far apart (0.0048)."""
    tokens = pair.tokens
    fwd = _np(pair.ref_fwd(pair.ref_params, jnp.asarray(tokens))[:, -1:])
    gaps = {}
    for name, dtype in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32)):
        all_ref, _ = pair.ref_loop(tokens, max_len=67, dtype=dtype)
        gaps[name] = np.abs(_np(all_ref[-1]) - fwd).max()
    assert 1e-3 < gaps["bfloat16"] < 0.1, gaps
    assert gaps["float32"] < 1e-4, gaps
    cache = pair.api.init_cache(pair.cfg, B, 67, device="cpu")
    step = serve.make_serve_step(pair.api)
    for t in range(tokens.shape[1]):
        logits, cache = step(pair.params, torch.from_numpy(tokens[:, t:t + 1]).long(), cache)
    prefilled, _ = pair.prefill(tokens, 67)
    port_gap = np.abs(_np(logits) - _np(prefilled)).max()
    assert 1e-3 < port_gap < 0.1, port_gap


def test_prefill_refuses_what_it_cannot_fill(pair):
    tokens = torch.from_numpy(pair.tokens).long()
    cache = pair.api.init_cache(pair.cfg, B, 70, device="cpu")
    _, cache = pair.api.decode_step(pair.params, tokens[:, :1], cache)
    with pytest.raises(ValueError, match="empty cache"):
        pair.api.prefill(pair.params, tokens[:, :8], cache)
    with pytest.raises(ValueError, match="one token per sequence"):
        pair.api.decode_step(pair.params, tokens[:, :2], cache)
    with pytest.raises(ValueError, match="divisible"):
        pair.api.prefill(pair.params, tokens[:, :40],
                         pair.api.init_cache(pair.cfg, B, 70, device="cpu"))


def test_reference_cache_carries_across_and_decoding_continues(pair):
    """``cache_from_reference`` takes the reference's hybrid cache (SSD and
    conv states stacked (G, A, ...), one KV slot per site) as it is; the
    port's decode step continues from it as the reference's does."""
    _, ref_cache = pair.ref_loop(pair.tokens[:, :4], max_len=8)
    cache = cache_from_reference(jax.tree.map(np.asarray, ref_cache), "cpu")
    assert cache["index"] == 4 and set(cache) == {"ssd", "conv", "attn_k", "attn_v", "index"}
    nxt = pair.tokens[:, 4:5]
    want, ref_next = pair.ref_decode(pair.ref_params, jnp.asarray(nxt), ref_cache)
    with torch.no_grad():
        got, cache = pair.api.decode_step(pair.params, torch.from_numpy(nxt).long(), cache)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(cache["ssd"]), _np(ref_next["ssd"]), rtol=1e-4, atol=1e-4)
    assert cache["index"] == 5


def test_serve_main_on_cpu_serves_zamba2(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--tokens", "4", "--seed", "1"])
    out = capsys.readouterr().out
    assert res.generated.shape == (2, 4)
    assert torch.isfinite(res.last_logits).all()
    assert "flash_attention=0" in out and f"{ARCH}-reduced on cpu" in out
