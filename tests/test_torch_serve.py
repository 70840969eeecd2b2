"""The port's dense model and serve loop against the reference, on the CPU, with
the reference's own weights carried across through numpy.  float32 compute at
1e-4 (the two frameworks sum in another order); one bfloat16 case at 2e-2."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import cache_from_reference, from_reference

ARCHS = ["qwen2.5-3b", "gemma-7b"]
B, S = 2, 8


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


class Pair:
    """One architecture, reduced, in both packages with the same weights."""

    def __init__(self, arch, compute="float32"):
        self.ref_cfg = replace(ref_get_config(arch).reduced(), compute_dtype=compute)
        self.cfg = replace(get_config(arch).reduced(), compute_dtype=compute,
                           kernels="cuda")
        self.ref_api = ref_build_model(self.ref_cfg)
        self.api = build_model(self.cfg)
        self.ref_params = self.ref_api.init(jax.random.PRNGKey(0))
        self.params = from_reference(jax.tree.map(np.asarray, self.ref_params), "cpu")
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(1, self.cfg.vocab_size, size=(B, S)).astype(np.int32)
        self.ref_decode = jax.jit(self.ref_api.decode_step)

    def ref_loop(self, tokens, max_len, dtype=jnp.float32):
        """The reference's serving prefill: the prompt fed token by token."""
        cache = self.ref_api.init_cache(self.ref_cfg, tokens.shape[0], max_len, dtype)
        logits, all_logits = None, []
        for t in range(tokens.shape[1]):
            logits, cache = self.ref_decode(self.ref_params,
                                            jnp.asarray(tokens[:, t:t + 1]), cache)
            all_logits.append(logits)
        return all_logits, cache


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


def test_weights_carry_across_with_keys_shapes_and_dtypes(pair):
    ref = _flat(jax.tree.map(np.asarray, pair.ref_params))
    got = _flat(pair.params)
    spec = _flat(pair.api.spec)
    assert set(got) == set(ref) == set(spec)
    for path, leaf in spec.items():
        assert tuple(got[path].shape) == tuple(ref[path].shape) == tuple(leaf.shape), path
        assert got[path].dtype == leaf.dtype == torch.float32, path
        np.testing.assert_array_equal(got[path].numpy(), ref[path])
    assert pair.api.n_params() == pair.ref_api.n_params()
    assert pair.params["blocks"]["attn"]["wq"].shape[0] == pair.cfg.n_layers


def test_forward_logits_match_reference(pair):
    want = ref_transformer.forward(pair.ref_params, jnp.asarray(pair.tokens),
                                   pair.ref_cfg)
    with torch.no_grad():
        got = transformer.forward(pair.params, torch.from_numpy(pair.tokens).long(),
                                  pair.cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_decode_steps_match_reference_for_six_tokens(pair):
    all_ref, ref_cache = pair.ref_loop(pair.tokens[:, :6], max_len=9)
    cache = pair.api.init_cache(pair.cfg, B, 9, dtype=torch.float32, device="cpu")
    step = serve.make_serve_step(pair.api)
    for t in range(6):
        tok = torch.from_numpy(pair.tokens[:, t:t + 1]).long()
        logits, cache = step(pair.params, tok, cache)
        np.testing.assert_allclose(_np(logits), _np(all_ref[t]), rtol=1e-4, atol=1e-4)
    assert cache["index"] == int(ref_cache["index"]) == 6
    np.testing.assert_allclose(_np(cache["k"]), _np(ref_cache["k"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(cache["v"]), _np(ref_cache["v"]), rtol=1e-5, atol=1e-5)


def test_causal_prefill_equals_reference_token_by_token_loop(pair):
    """The port's one-pass prefill equals the reference's serving loop, which
    feeds the prompt token by token (the reference's own multi-token
    ``prefill`` is not causal inside the prompt and is not what it serves)."""
    all_ref, ref_cache = pair.ref_loop(pair.tokens, max_len=S + 3)
    cache = pair.api.init_cache(pair.cfg, B, S + 3, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, cache = pair.api.prefill(pair.params,
                                         torch.from_numpy(pair.tokens).long(), cache)
    assert logits.shape == (B, 1, pair.cfg.padded_vocab)
    np.testing.assert_allclose(_np(logits), _np(all_ref[-1]), rtol=1e-4, atol=1e-4)
    assert cache["index"] == int(ref_cache["index"]) == S
    np.testing.assert_allclose(_np(cache["k"]), _np(ref_cache["k"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(cache["v"]), _np(ref_cache["v"]), rtol=1e-5, atol=1e-5)


def test_reference_multi_token_prefill_is_not_causal(pair):
    """Pins the reference trap the port does not copy, from an empty cache
    and for a chunk into one that holds 3 tokens (its ``decode_step`` given
    several tokens): the port's prefill of the same chunk is causal."""
    all_ref, _ = pair.ref_loop(pair.tokens, max_len=S + 3)
    cache = pair.ref_api.init_cache(pair.ref_cfg, B, S + 3, jnp.float32)
    logits, _ = ref_transformer.prefill(pair.ref_params, jnp.asarray(pair.tokens), cache,
                                        pair.ref_cfg)
    first = np.abs(_np(logits[:, 0]) - _np(all_ref[0][:, 0])).max()
    assert first > 1e-3          # token 0 already sees later tokens there
    c = 3
    _, held = pair.ref_loop(pair.tokens[:, :c], max_len=S + 3)
    chunk, _ = pair.ref_decode(pair.ref_params, jnp.asarray(pair.tokens[:, c:]), held)
    first = np.abs(_np(chunk[:, 0]) - _np(all_ref[c][:, 0])).max()
    assert first > 1e-3          # the chunk's first token sees the chunk's later ones
    port = pair.api.init_cache(pair.cfg, B, S + 3, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(pair.tokens).long()
    with torch.no_grad():
        _, port = pair.api.prefill(pair.params, tokens[:, :c], port)
        got, port = pair.api.prefill(pair.params, tokens[:, c:c + 1], port)
    np.testing.assert_allclose(_np(got[:, 0]), _np(all_ref[c][:, 0]), rtol=1e-5, atol=1e-5)


def test_serve_greedy_ids_equal_reference_loop(pair):
    prompts_np = serve.make_prompts(pair.cfg, B, S, "cpu").numpy().astype(np.int32)
    from repro.data import DataConfig, make_source
    ref_prompts = make_source(DataConfig(vocab_size=pair.ref_cfg.vocab_size),
                              pair.ref_cfg).batch_at(0, B, S)["tokens"]
    np.testing.assert_array_equal(prompts_np, ref_prompts)

    n_new = 8
    V = pair.ref_cfg.vocab_size
    all_ref, cache = pair.ref_loop(ref_prompts, max_len=S + n_new + 1, dtype=jnp.bfloat16)
    logits = all_ref[-1]
    tok = jnp.argmax(logits[:, -1:, :V], axis=-1).astype(jnp.int32)
    out = []
    for _ in range(n_new):
        out.append(tok)
        logits, cache = pair.ref_decode(pair.ref_params, tok, cache)
        tok = jnp.argmax(logits[:, -1:, :V], axis=-1).astype(jnp.int32)
    want = np.asarray(jnp.concatenate(out, axis=1))

    res = serve.generate(pair.api, pair.params, torch.from_numpy(prompts_np).long(), n_new)
    np.testing.assert_array_equal(res.generated.numpy(), want)
    np.testing.assert_allclose(_np(res.last_logits), _np(logits[:, -1, :V]),
                               rtol=2e-2, atol=2e-2)
    assert res.generated.shape == (B, n_new) and res.launches["flash_attention"] == 0


def test_kernel_path_equals_plain_path_inside_the_port(pair):
    """cfg.kernels == "cuda" (the kernels' plain versions on CPU tensors, with
    un-repeated strided k/v and a valid length) against the dense path."""
    plain_api = build_model(replace(pair.cfg, kernels="plain"))
    prompts = torch.from_numpy(pair.tokens).long()
    a = serve.generate(pair.api, pair.params, prompts, 5, keep_step_logits=True)
    b = serve.generate(plain_api, pair.params, prompts, 5, keep_step_logits=True,
                       forced_ids=a.generated)
    np.testing.assert_allclose(_np(a.prefill_logits), _np(b.prefill_logits),
                               rtol=1e-4, atol=1e-4)
    for x, y in zip(a.step_logits, b.step_logits):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-4)


def test_cache_defaults_to_bfloat16_and_converts(pair):
    ref_cache = pair.ref_api.init_cache(pair.ref_cfg, B, 5)
    cache = pair.api.init_cache(pair.cfg, B, 5, device="cpu")
    assert ref_cache["k"].dtype == jnp.bfloat16 and cache["k"].dtype == torch.bfloat16
    assert tuple(cache["k"].shape) == tuple(ref_cache["k"].shape)
    _, filled = pair.ref_loop(pair.tokens[:, :3], max_len=5, dtype=jnp.bfloat16)
    conv = cache_from_reference(jax.tree.map(np.asarray, filled), "cpu")
    assert conv["index"] == 3 and conv["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(conv["v"]), _np(filled["v"]))


def test_prefill_refuses_a_second_chunk(pair):
    """A second chunk is taken only where the cache has room for it (the
    chunked prefill itself: ``tests/test_torch_chunked_prefill.py``), and
    ``decode_step`` stays one token a row."""
    cache = pair.api.init_cache(pair.cfg, B, 6, device="cpu")
    prompts = torch.from_numpy(pair.tokens).long()
    with torch.no_grad():
        _, cache = pair.api.prefill(pair.params, prompts[:, :4], cache)
        with pytest.raises(ValueError, match="cannot take"):
            pair.api.prefill(pair.params, prompts[:, 4:], cache)
        assert cache["index"] == 4
        _, cache = pair.api.prefill(pair.params, prompts[:, 4:6], cache)
        assert cache["index"] == 6
        with pytest.raises(ValueError):
            pair.api.decode_step(pair.params, prompts[:, :2], cache)


def test_bfloat16_compute_matches_reference():
    p = Pair("qwen2.5-3b", compute="bfloat16")
    want = ref_transformer.forward(p.ref_params, jnp.asarray(p.tokens), p.ref_cfg)
    with torch.no_grad():
        got = transformer.forward(p.params, torch.from_numpy(p.tokens).long(), p.cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_serve_main_on_cpu_prints_blocks_and_launches(capsys):
    res = serve.main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--tokens", "4", "--seed", "3"])
    out = capsys.readouterr().out
    assert res.generated.shape == (2, 4)
    assert "planner flash_blocks" in out and "kernel launches:" in out
    assert "tok/s" in out and "sample generation (ids)" in out
    again = serve.main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                        "--tokens", "4", "--seed", "3"])
    np.testing.assert_array_equal(res.generated.numpy(), again.generated.numpy())
