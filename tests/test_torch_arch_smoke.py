"""Per-architecture smoke tests of the port, the counterpart of
``tests/test_arch_smoke.py`` over all ten configs: a REDUCED config of each
builds, runs a forward pass on the CPU (logits of the padded vocabulary's
width, finite) and serves: ``prefill`` then two decode steps advance its
cache, and a decode step that has history differs from one that has none.
Port only; weights from a seeded ``torch.Generator``, the stub frontend
input from ``ModelAPI.frontend_inputs``."""
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import build_model

B, S = 2, 32


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    cfg = ARCHS[request.param].reduced()
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    inputs = api.frontend_inputs(B, torch.Generator().manual_seed(2), "cpu")
    return api, params, tokens, inputs


def test_all_ten_configs_build():
    assert len(ARCHS) == 10
    families = {build_model(cfg.reduced()).cfg.family for cfg in ARCHS.values()}
    assert families == {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}


@torch.no_grad()
def test_smoke_forward(model):
    api, params, tokens, inputs = model
    logits = api.logits_fn(params, dict(inputs, tokens=tokens))
    assert logits.shape == (B, S, api.cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()
    assert api.n_params() == sum(t.numel() for t in _leaves(params))


@torch.no_grad()
def test_smoke_prefill_and_decode_advance_the_cache(model):
    api, params, tokens, inputs = model
    cfg = api.cfg
    max_len = api.prefix_len() + S + 4
    cache = api.init_cache(cfg, B, max_len, device="cpu")
    logits, cache = api.prefill(params, tokens, cache, **inputs)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert cache["index"] == api.prefix_len() + S
    t0 = torch.full((B, 1), 7, dtype=torch.long)
    t1 = torch.full((B, 1), 23, dtype=torch.long)
    for i, tok in enumerate((t0, t1)):
        logits, cache = api.decode_step(params, tok, cache)
        assert logits.shape == (B, 1, cfg.padded_vocab)
        assert torch.isfinite(logits.float()).all()
        assert cache["index"] == api.prefix_len() + S + i + 1
    # the same token on a freshly prefilled cache of a shorter prompt: the
    # cache carries the past, so the logits differ
    fresh = api.init_cache(cfg, B, max_len, device="cpu")
    _, fresh = api.prefill(params, tokens[:, :16], fresh, **inputs)
    other, _ = api.decode_step(params, t1, fresh)
    assert not torch.allclose(other.float(), logits.float(), atol=1e-3)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
