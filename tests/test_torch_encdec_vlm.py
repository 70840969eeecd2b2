"""The port's cross-attention modes, encoder-decoder (seamless-m4t-medium) and
VLM (internvl2-1b) against the reference, on the CPU: ``attention``'s
``kv_input`` and ``precomputed_kv`` modes, the reduced encoder-decoder's
``encode``, ``forward``, ``prepare_cross``, ``decode_step`` and one-pass
``prefill``, the reduced VLM's ``forward``, ``prefill`` with image patches
and teacher-forced decode steps, and the stub frontend input made from a
seed.  Inputs are made with numpy from a seed; weights come from the
reference's ``api.init`` (biases drawn at random, so that they matter) and
are carried across through numpy.  The reference runs ``kernels="xla"`` and
``kernels="pallas"`` (its Pallas kernels in interpret mode) beside the
port's ``plain`` and ``cuda`` paths (on CPU tensors the kernel wrappers run
their plain versions).  Tolerances: float32 at 1e-4 (the two frameworks sum
in another order), decode steps against a forward over the longer sequence
at 1e-4 as well."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.models import vlm as ref_vlm
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model, encdec, layers
from repro_torch.models.convert import cache_from_reference, from_reference

ENCDEC, VLM = "seamless-m4t-medium", "internvl2-1b"
B, S = 2, 8
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


class Pair:
    """One architecture, reduced, in both packages with the same weights and
    the same stub frontend input (numpy, seeded)."""

    def __init__(self, arch, path="pallas"):
        self.ref_cfg = replace(ref_get_config(arch).reduced(), kernels=path,
                               compute_dtype="float32")
        self.cfg = replace(get_config(arch).reduced(), compute_dtype="float32",
                           kernels="cuda" if path == "pallas" else "plain")
        self.ref_api = ref_build_model(self.ref_cfg)
        self.api = build_model(self.cfg)
        weights = jax.tree.map(np.asarray, self.ref_api.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(4)
        for path_, w in _flat(weights).items():
            if path_[-1] == "b":
                node = weights
                for k in path_[:-1]:
                    node = node[k]
                node["b"] = (rng.standard_normal(w.shape) * 0.1).astype(w.dtype)
        self.weights = weights
        self.ref_params = jax.tree.map(jnp.asarray, weights)
        self.params = from_reference(weights, "cpu")
        self.tokens = rng.integers(1, self.cfg.vocab_size, size=(B, S + 6)).astype(np.int32)
        self.front = rng.standard_normal(
            (B, self.cfg.frontend_len, self.cfg.frontend_dim)).astype(np.float32)
        self.ref_decode = jax.jit(self.ref_api.decode_step)


@pytest.fixture(scope="module")
def seamless():
    return Pair(ENCDEC)


@pytest.fixture(scope="module")
def internvl():
    return Pair(VLM)


# ------------------------------------------------------- cross-attention
@pytest.mark.parametrize("arch", [ENCDEC, VLM])
@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("Sq", [5, 1])
def test_cross_attention_modes_match_reference(arch, path, Sq):
    """``kv_input`` (k/v projected from another sequence, no RoPE, no mask)
    and ``precomputed_kv`` (projected k/v handed over) against the
    reference's, with query heads sharing kv heads (internvl2 reduced: 4 on
    1) and not (seamless reduced: 4 on 4); Sq 1 takes the decode kernel's
    path on the port's ``cuda`` side.  float32 at 1e-4."""
    ref_cfg = replace(ref_get_config(arch).reduced(), kernels=path, compute_dtype="float32",
                      qkv_bias=True)
    cfg = replace(get_config(arch).reduced(), compute_dtype="float32", qkv_bias=True,
                  kernels="cuda" if path == "pallas" else "plain")
    spec = ref_layers.attention_spec(ref_cfg)
    rng = np.random.default_rng(Sq)
    w = {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32) for k, s in spec.items()}
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    wj = {k: jnp.asarray(v) for k, v in w.items()}
    wt = {k: _t(v) for k, v in w.items()}
    want, _ = ref_layers.attention(wj, jnp.asarray(x), ref_cfg, kv_input=jnp.asarray(mem),
                                   causal=False)
    got, cache = layers.attention(wt, _t(x), cfg, kv_input=_t(mem), causal=False)
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    kv = [rng.standard_normal((B, 12, cfg.n_kv_heads, cfg.head_dim_)).astype(np.float32)
          for _ in range(2)]
    want, _ = ref_layers.attention(wj, jnp.asarray(x), ref_cfg,
                                   precomputed_kv=tuple(map(jnp.asarray, kv)))
    got, _ = layers.attention(wt, _t(x), cfg, precomputed_kv=tuple(map(_t, kv)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    with pytest.raises(ValueError, match="no cache"):
        layers.attention(wt, _t(x), cfg, kv_input=_t(mem), kv_cache=tuple(map(_t, kv)),
                         cache_index=0)


# --------------------------------------------------- encoder-decoder
def test_encdec_weights_and_parameter_count(seamless):
    got, spec = _flat(seamless.params), _flat(seamless.api.spec)
    assert set(got) == set(spec) == set(_flat(seamless.weights))
    assert all(tuple(got[k].shape) == spec[k].shape for k in spec)
    assert seamless.api.n_params() == seamless.ref_api.n_params()
    assert build_model(get_config(ENCDEC)).n_params() == 978_025_472


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_encode_and_forward_match_reference(path, seamless):
    p = seamless if path == "pallas" else Pair(ENCDEC, path)
    frames, tokens = p.front, p.tokens[:, :S]
    want_mem = ref_encdec.encode(p.ref_params, jnp.asarray(frames), p.ref_cfg)
    want = ref_encdec.forward(p.ref_params, jnp.asarray(frames), jnp.asarray(tokens), p.ref_cfg)
    with torch.no_grad():
        mem = encdec.encode(p.params, _t(frames), p.cfg)
        got = p.api.logits_fn(p.params, {"frames": _t(frames),
                                         "tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(_np(mem), _np(want_mem), **TOL)
    assert got.shape == want.shape == (B, S, p.cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _ref_encdec_loop(p, tokens, max_len):
    """The reference's serving decode: cross K/V from the encoded frames,
    then the tokens fed one by one."""
    cache = p.ref_api.init_cache(p.ref_cfg, B, max_len, jnp.float32)
    mem = ref_encdec.encode(p.ref_params, jnp.asarray(p.front), p.ref_cfg)
    cache = ref_encdec.prepare_cross(p.ref_params, mem, p.ref_cfg, cache)
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = p.ref_decode(p.ref_params, jnp.asarray(tokens[:, t:t + 1]), cache)
        out.append(logits)
    return out, cache


def test_prepare_cross_and_decode_steps_match_reference(seamless):
    """``prepare_cross`` fills every layer's cross K/V as the reference's does,
    and six decode steps give the reference's logits and self-attention
    KV, in float32 with a float32 cache."""
    p = seamless
    want, ref_cache = _ref_encdec_loop(p, p.tokens[:, :6], max_len=9)
    cache = p.api.init_cache(p.cfg, B, 9, dtype=torch.float32, device="cpu")
    assert cache["cross_k"].shape == (p.cfg.n_layers, B, p.cfg.frontend_len,
                                      p.cfg.n_kv_heads, p.cfg.head_dim_)
    with torch.no_grad():
        cache = encdec.prepare_cross(p.params, encdec.encode(p.params, _t(p.front), p.cfg),
                                     p.cfg, cache)
    step = serve.make_serve_step(p.api)
    for t in range(6):
        logits, cache = step(p.params, torch.from_numpy(p.tokens[:, t:t + 1]).long(), cache)
        np.testing.assert_allclose(_np(logits), _np(want[t]), **TOL)
    assert cache["index"] == int(ref_cache["index"]) == 6
    for name in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(_np(cache[name]), _np(ref_cache[name]), **TOL)


def test_encdec_prefill_equals_forward_and_decode_loop(seamless):
    """The port's prefill (encode, cross K/V into the cache, the decoder's
    causal prompt pass with cross-attention over the cached K/V) returns the
    reference ``forward``'s last-position logits and leaves the cache the
    reference's token loop leaves; decoding then continues as the loop
    does.  float32, float32 cache."""
    p = seamless
    tokens = p.tokens[:, :S]
    fwd = ref_encdec.forward(p.ref_params, jnp.asarray(p.front), jnp.asarray(tokens),
                             p.ref_cfg)
    want, ref_cache = _ref_encdec_loop(p, p.tokens[:, :S + 1], max_len=S + 3)
    cache = p.api.init_cache(p.cfg, B, S + 3, dtype=torch.float32, device="cpu")
    inputs = {"frames": _t(p.front)}
    with torch.no_grad():
        logits, cache = p.api.prefill(p.params, torch.from_numpy(tokens).long(), cache,
                                      **inputs)
    assert logits.shape == (B, 1, p.cfg.padded_vocab) and cache["index"] == S
    np.testing.assert_allclose(_np(logits), _np(fwd[:, -1:]), **TOL)
    np.testing.assert_allclose(_np(logits), _np(want[S - 1]), **TOL)
    logits, cache = p.api.decode_step(p.params, torch.from_numpy(p.tokens[:, S:S + 1]).long(),
                                      cache)
    np.testing.assert_allclose(_np(logits), _np(want[S]), **TOL)
    for name in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(_np(cache[name]), _np(ref_cache[name]), **TOL)
    with pytest.raises(ValueError, match="empty cache"):
        p.api.prefill(p.params, torch.from_numpy(tokens).long(), cache, **inputs)


def test_encdec_reference_cache_carries_across(seamless):
    """``cache_from_reference`` takes the reference's cache, cross K/V
    included, as it is; the port's decode step continues from it."""
    p = seamless
    _, ref_cache = _ref_encdec_loop(p, p.tokens[:, :3], max_len=6)
    cache = cache_from_reference(jax.tree.map(np.asarray, ref_cache), "cpu")
    assert set(cache) == {"k", "v", "cross_k", "cross_v", "index"} and cache["index"] == 3
    nxt = p.tokens[:, 3:4]
    want, _ = p.ref_decode(p.ref_params, jnp.asarray(nxt), ref_cache)
    with torch.no_grad():
        got, _ = p.api.decode_step(p.params, torch.from_numpy(nxt).long(), cache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ------------------------------------------------------------------ VLM
def test_vlm_weights_and_parameter_count(internvl):
    got, spec = _flat(internvl.params), _flat(internvl.api.spec)
    assert set(got) == set(spec) == set(_flat(internvl.weights))
    assert ("connector", "w") in got
    assert internvl.api.n_params() == internvl.ref_api.n_params()
    full = get_config(VLM)
    assert full.padded_vocab == 151808
    assert build_model(full).n_params() == 494_808_832


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_vlm_forward_matches_reference(path, internvl):
    p = internvl if path == "pallas" else Pair(VLM, path)
    tokens = p.tokens[:, :S]
    want = ref_vlm.forward(p.ref_params, jnp.asarray(tokens), jnp.asarray(p.front), p.ref_cfg)
    with torch.no_grad():
        got = p.api.logits_fn(p.params, {"patches": _t(p.front),
                                         "tokens": torch.from_numpy(tokens).long()})
    assert got.shape == want.shape == (B, S, p.cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_vlm_prefill_and_teacher_forced_decode_match_reference_forward(internvl):
    """The reference's serve loop never sees the patches, so its ``forward``
    is the oracle: the port's prefill over [connector(patches); prompt]
    gives ``forward``'s last text position, and each decode step, fed the
    next ids, gives ``forward`` over the longer text at its new position
    (RoPE positions counting the image prefix).  float32, float32 cache."""
    p = internvl
    n_new = 5
    tokens = p.tokens[:, :S + n_new]
    want = _np(ref_vlm.forward(p.ref_params, jnp.asarray(tokens), jnp.asarray(p.front),
                               p.ref_cfg))
    max_len = p.api.prefix_len() + S + n_new + 1
    assert p.api.prefix_len() == p.cfg.frontend_len
    cache = p.api.init_cache(p.cfg, B, max_len, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, cache = p.api.prefill(p.params, torch.from_numpy(tokens[:, :S]).long(), cache,
                                      patches=_t(p.front))
    assert logits.shape == (B, 1, p.cfg.padded_vocab)
    assert cache["index"] == p.cfg.frontend_len + S
    np.testing.assert_allclose(_np(logits)[:, 0], want[:, S - 1], **TOL)
    step = serve.make_serve_step(p.api)
    for i in range(n_new):
        logits, cache = step(p.params, torch.from_numpy(tokens[:, S + i:S + i + 1]).long(),
                             cache)
        np.testing.assert_allclose(_np(logits)[:, 0], want[:, S + i], **TOL)


# ------------------------------------------------------ frontend input
@pytest.mark.parametrize("arch,name", [(VLM, "patches"), (ENCDEC, "frames"),
                                       ("qwen2.5-3b", None), ("zamba2-1.2b", None)])
def test_frontend_inputs_from_a_seed(arch, name):
    cfg = get_config(arch).reduced()
    api = build_model(cfg)
    make = lambda seed: api.frontend_inputs(3, torch.Generator().manual_seed(seed), "cpu")
    got = make(5)
    if name is None:
        assert got == {} and api.prefix_len() == 0
        return
    assert set(got) == {name}
    x = got[name]
    assert x.shape == (3, cfg.frontend_len, cfg.frontend_dim) and x.dtype == torch.bfloat16
    torch.testing.assert_close(x, make(5)[name], rtol=0, atol=0)
    assert not torch.equal(x, make(6)[name])
    assert 0.01 < x.float().std().item() < 0.03            # 0.02 x standard normal
    assert api.prefix_len() == (cfg.frontend_len if arch == VLM else 0)


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_serve_main_on_cpu_serves_the_frontend_families(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--tokens", "3", "--seed", "1"])
    out = capsys.readouterr().out
    assert res.generated.shape == (2, 3)
    assert torch.isfinite(res.last_logits).all()
    assert f"{arch}-reduced on cpu" in out and "flash_attention=0" in out


def test_generate_cache_holds_the_image_prefix(internvl):
    """``serve.generate`` sizes the VLM's cache for the image prefix, the
    prompt and every new token; a cache one prefix short would not hold
    them."""
    p = internvl
    prompts = torch.from_numpy(p.tokens[:, :S]).long()
    res = serve.generate(p.api, p.params, prompts, 4, inputs={"patches": _t(p.front)})
    assert res.generated.shape == (B, 4)
    short = p.api.init_cache(p.cfg, B, S + 4, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="cannot take"):
        p.api.prefill(p.params, prompts, short, patches=_t(p.front))
