"""The port's plain attention for long sequences against the reference's, on
the CPU: ``layers._sdpa_plain_chunked`` (online softmax over KV blocks)
against the reference's ``_sdpa_xla_chunked``, and the dispatch rule
(``_sdpa_plain`` against ``_sdpa_xla``: chunked for a multi-token pass over
all keys whose S x T exceeds ``CHUNKED_ATTN_THRESHOLD`` squared, dense
otherwise), with the threshold lowered on both sides so that small inputs
cross it.  Inputs from a numpy seed; float32 at 1e-5 per call and 1e-4 for a
model's logits (the frameworks sum in another order)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import from_reference


def _qkv(seed, B, S, T, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, T, H, D), (B, T, H, D))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,kv_block", [(32, 32, 8), (16, 48, 8), (24, 40, 16), (8, 12, 8)])
def test_plain_chunked_attention_matches_reference(S, T, kv_block, causal):
    """Sq <= Skv (queries aligned to the last keys when causal), several KV
    blocks; a T with no power-of-two block of 8 (12) goes dense on both
    sides."""
    xs = _qkv(S + T, 2, S, T, 3, 16)
    want = ref_layers._sdpa_xla_chunked(*(jnp.asarray(x) for x in xs), causal, 0.25,
                                        kv_block=kv_block)
    got = L._sdpa_plain_chunked(*(torch.from_numpy(x) for x in xs), causal, 0.25,
                                kv_block=kv_block)
    assert got.shape == (2, S, 3, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_attention_dispatches_to_chunks_above_the_threshold(monkeypatch):
    """With the threshold lowered to 16 on both sides (S x T > 256 chunks):
    the port takes the chunked form exactly where the reference does and
    agrees with it, per call and through a reduced qwen2.5-3b forward on
    the plain path (``kernels="xla"`` on the reference's side)."""
    assert L.CHUNKED_ATTN_THRESHOLD == ref_layers.CHUNKED_ATTN_THRESHOLD == 8192
    monkeypatch.setattr(L, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(ref_layers, "CHUNKED_ATTN_THRESHOLD", 16)
    chunked, real = [], L._sdpa_plain_chunked

    def spy(*args, **kw):
        chunked.append(kw.get("kv_block"))
        return real(*args, **kw)

    monkeypatch.setattr(L, "_sdpa_plain_chunked", spy)
    for S, T, valid, want_chunked in ((32, 32, None, True), (1, 512, None, False),
                                      (16, 16, None, False), (8, 64, 40, False)):
        chunked.clear()
        xs = _qkv(S * T, 2, S, T, 2, 16)
        want = ref_layers._sdpa_xla(*(jnp.asarray(x) for x in xs), S > 1, 0.25,
                                    kv_valid_len=valid)
        got = L._sdpa_plain(*(torch.from_numpy(x) for x in xs), S > 1, 0.25,
                            kv_valid_len=valid)
        assert chunked == ([1024] if want_chunked else []), (S, T, valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    ref_cfg = replace(ref_get_config("qwen2.5-3b").reduced(), kernels="xla",
                      compute_dtype="float32")
    cfg = replace(get_config("qwen2.5-3b").reduced(), kernels="plain", compute_dtype="float32")
    weights = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    want = ref_build_model(ref_cfg).logits_fn(jax.tree.map(jnp.asarray, weights),
                                              {"tokens": jnp.asarray(tokens)})
    chunked.clear()
    with torch.no_grad():
        got = build_model(cfg).logits_fn(from_reference(weights, "cpu"),
                                         {"tokens": torch.from_numpy(tokens).long()})
    assert len(chunked) == cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
