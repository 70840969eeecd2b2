"""Chunked prefill: a prompt written into a KV cache in chunks, each a causal
pass at the cache's index (K2 with the query offset of that index over the
keys ahead of it; on the CPU its plain version), for the four families
whose reference ``decode_step`` takes several tokens at any index: the
dense family (reduced qwen2.5-3b and gemma-7b), the MoE (reduced
qwen3-moe-30b-a3b), the VLM (reduced internvl2-1b) and the encoder-decoder
(reduced seamless-m4t-medium).  The port keeps ``decode_step`` one token a
row; the chunks go through ``api.prefill`` and the plan-sharded serve step.

A prompt of 16 tokens goes in as chunks of 3, 1, 4 and 8, in float32:

* after each chunk, the last token's logits and the cache against the
  reference's ``decode_step`` fed the same tokens one at a time, 1e-5 (the
  VLM: its first pass carries the image patches, which no reference path
  writes into a cache, so its logits are held against the reference's
  ``forward`` over [patches; the tokens so far] after every chunk, and its
  cache against the reference's loop from the first pass's cache on);
* the same chunks through a 1x2 ``gloo`` ``megatron_tp`` serve step (the
  cache split over ``kv_heads``, head-local attention) against the unsplit
  chunked pass, and under ``kv_sequence_split`` (the cache split over
  ``kv_seq``) the second chunk raises ``NotImplementedError``;
* a chunk past the cache's end raises ``ValueError``, and so does a chunk
  into rwkv6's or zamba2's non-empty state (the reference decodes them one
  token at a time);
* ``serve.generate(..., prefill_chunks=)`` gives a one-pass run's ids and
  logits;
* the MoE's capacity is the chunk's, ``_capacity(B * S_chunk)``: with a
  capacity factor of 4 nothing drops (above), and with 0.5 each chunk's
  kept (token, slot) pairs are the reference's ``_capacity`` and stable
  queue order over that chunk's routing.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
from repro_torch.models.convert import from_reference
from repro_torch.parallel import sharding as SH
from repro_torch.train import serve_step as SS
from torch_mesh_worker import plan_named, spawn

MOE, VLM, ENCDEC = "qwen3-moe-30b-a3b", "internvl2-1b", "seamless-m4t-medium"
# two kv heads where the reduced config has one, so that megatron_tp splits the cache
ARCHS = {"qwen2.5-3b": (("n_kv_heads", 2),), "gemma-7b": (),
         MOE: (("n_kv_heads", 2), ("capacity_factor", 4.0)),
         VLM: (("n_kv_heads", 2),), ENCDEC: ()}
B, CHUNKS = 2, (3, 1, 4, 8)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


class Pair:
    """One reduced architecture in both packages, float32, on the reference's
    initial weights, with a 16-token prompt and (VLM, encoder-decoder) its
    frontend input, numpy from seed 0."""

    def __init__(self, arch, extra=()):
        self.ref_cfg = replace(ref_get_config(arch).reduced(**dict(extra)),
                               compute_dtype="float32")
        self.cfg = replace(get_config(arch).reduced(**dict(extra)), compute_dtype="float32",
                           kernels="cuda")
        self.ref_api, self.api = ref_build_model(self.ref_cfg), build_model(self.cfg)
        self.ref_params = self.ref_api.init(jax.random.PRNGKey(0))
        self.params = from_reference(jax.tree.map(np.asarray, self.ref_params), "cpu")
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(1, self.cfg.vocab_size, size=(B, sum(CHUNKS))).astype(np.int32)
        self.front = None
        if self.cfg.family in ("vlm", "audio"):
            self.front = (rng.standard_normal((B, self.cfg.frontend_len, self.cfg.frontend_dim))
                          * 0.02).astype(np.float32)
        self.max_len = self.api.prefix_len() + sum(CHUNKS) + 2
        self.ref_decode = jax.jit(self.ref_api.decode_step)

    def inputs(self):
        name = {"vlm": "patches", "audio": "frames"}.get(self.cfg.family)
        return {} if name is None else {name: torch.from_numpy(self.front)}

    def chunks(self):
        out, at = [], 0
        for n in CHUNKS:
            out.append(torch.from_numpy(self.tokens[:, at:at + n]).long())
            at += n
        return out

    def chunked(self, chunks=None):
        """The port's chunked prefill: after each chunk its logits and a copy
        of the cache."""
        cache = self.api.init_cache(self.cfg, B, self.max_len, dtype=torch.float32,
                                    device="cpu")
        out = []
        with torch.no_grad():
            for i, ids in enumerate(chunks or self.chunks()):
                logits, cache = self.api.prefill(self.params, ids, cache,
                                                 **(self.inputs() if i == 0 else {}))
                out.append((logits, {k: v.clone() if isinstance(v, torch.Tensor) else v
                                     for k, v in cache.items()}))
        return out

    def ref_cache(self):
        cache = self.ref_api.init_cache(self.ref_cfg, B, self.max_len, jnp.float32)
        if self.cfg.family == "audio":
            memory = ref_encdec.encode(self.ref_params, jnp.asarray(self.front), self.ref_cfg)
            cache = ref_encdec.prepare_cross(self.ref_params, memory, self.ref_cfg, cache)
        return cache

    def ref_loop(self, cache, first, last):
        """The reference's decode_step over tokens [first, last), one at a
        time: the last logits and the cache."""
        logits = None
        for t in range(first, last):
            logits, cache = self.ref_decode(self.ref_params,
                                            jnp.asarray(self.tokens[:, t:t + 1]), cache)
        return logits, cache


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chunks_equal_the_reference_token_loop(arch):
    p = Pair(arch, ARCHS[arch])
    got = p.chunked()
    if p.cfg.family == "vlm":
        P = p.cfg.frontend_len
        logits0, cache0 = got[0]
        ref = {k: jnp.asarray(_np(v)) for k, v in cache0.items() if k != "index"}
        ref["index"] = jnp.asarray(P + CHUNKS[0], jnp.int32)
        at, start = 0, CHUNKS[0]
    else:
        ref, at, start = p.ref_cache(), 0, 0
    for i, n in enumerate(CHUNKS):
        logits, cache = got[i]
        end = at + n
        what = f"{arch} chunk {i} ({at}:{end})"
        assert logits.shape == (B, 1, p.cfg.padded_vocab) and cache["index"] \
            == p.api.prefix_len() + end, what
        if p.cfg.family == "vlm":
            want = p.ref_api.logits_fn(p.ref_params, {"tokens": jnp.asarray(p.tokens[:, :end]),
                                                      "patches": jnp.asarray(p.front)})
            _close(logits[:, 0], want[:, -1], what)
        if end > start:
            want, ref = p.ref_loop(ref, max(at, start), end)
            if p.cfg.family != "vlm":
                _close(logits[:, 0], want[:, -1], what)
            for name in ("k", "v"):
                _close(cache[name], ref[name], f"{what} cache {name}")
        at = end
    one = p.api.init_cache(p.cfg, B, p.max_len, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        whole, one = p.api.prefill(p.params, torch.from_numpy(p.tokens).long(), one,
                                   **p.inputs())
    # the chunks leave the one-pass prefill's logits and cache
    _close(got[-1][0], whole, f"{arch} one pass")
    for name in one:
        if name != "index":
            _close(got[-1][1][name], one[name], f"{arch} one pass {name}")


def _chunk_case(p, arch, plan, chunks, tmp_path):
    data = {"params": p.params, "chunks": chunks, "inputs": p.inputs(),
            "cache": p.api.init_cache(p.cfg, B, p.max_len, dtype=torch.float32, device="cpu")}
    torch.save(data, tmp_path / f"chunks-{plan}.pt")
    return {"name": plan, "arch": arch, "reduced": dict(ARCHS[arch]), "plan": plan,
            "data": f"chunks-{plan}.pt", "chunked": True}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_head_local_chunks_equal_the_unsplit_ones_and_a_kv_seq_split_refuses(arch, tmp_path):
    p = Pair(arch, ARCHS[arch])
    want = p.chunked()
    ids = p.chunks()
    # under kv_sequence_split the second chunk has more than one token: a
    # single token decodes
    cases = [_chunk_case(p, arch, "megatron_tp", ids, tmp_path),
             _chunk_case(p, arch, "kv_sequence_split", [ids[0], torch.cat(ids[1:3], dim=1)],
                         tmp_path)]
    spawn({"mode": "serve", "mesh": [1, 2], "cases": cases, "kernels": "cuda"}, tmp_path)
    for rank in range(2):
        mesh = SH.Mesh(("data", "model"), (1, 2), rank=rank)
        got = torch.load(tmp_path / f"megatron_tp.rank{rank}.pt", weights_only=False)
        assert got["error"] is None and len(got["chunks"]) == len(CHUNKS)
        for i, ((logits, cache), part) in enumerate(zip(want, got["chunks"])):
            what = f"{arch} rank {rank} chunk {i}"
            _close(part["logits"], logits, what)
            assert part["index"] == cache["index"], what
            c_sh = SS.cache_shardings(p.api, cache, plan_named("megatron_tp"), mesh)
            for name, w in cache.items():
                if name == "index":
                    continue
                assert c_sh[name].spec[3] == "model", (what, name, c_sh[name].spec)
                _close(part["cache"][name], c_sh[name].local(w), f"{what} cache {name}")
        split = torch.load(tmp_path / f"kv_sequence_split.rank{rank}.pt", weights_only=False)
        assert len(split["chunks"]) == 1 and "kv_seq" in split["error"], split["error"]
        _close(split["chunks"][0]["logits"], want[0][0], f"{arch} rank {rank} kv_seq")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", MOE, VLM, ENCDEC])
def test_generate_in_chunks_equals_one_pass(arch):
    """``serve.generate(..., prefill_chunks=)``, the entry point the smoke
    drives a chunked prompt through: the same ids and, at 1e-5, the same
    prefill and step logits as a one-pass prefill; ``chunk_logits`` ends
    with the prefill's; sizes that do not cover the prompt raise."""
    from repro_torch.launch import serve
    p = Pair(arch, ARCHS[arch])
    prompts = torch.from_numpy(p.tokens).long()
    one = serve.generate(p.api, p.params, prompts, 3, inputs=p.inputs(),
                         keep_step_logits=True)
    got = serve.generate(p.api, p.params, prompts, 3, inputs=p.inputs(),
                         keep_step_logits=True, prefill_chunks=CHUNKS)
    assert len(got.chunk_logits) == len(CHUNKS) and one.chunk_logits == []
    assert got.chunk_logits[-1] is got.prefill_logits
    assert torch.equal(got.generated, one.generated)
    for i, (a, b) in enumerate(zip([got.prefill_logits, *got.step_logits],
                                   [one.prefill_logits, *one.step_logits], strict=True)):
        _close(a, b, f"{arch} logits {i}")
    with pytest.raises(ValueError, match="do not cover"):
        serve.generate(p.api, p.params, prompts, 1, inputs=p.inputs(), prefill_chunks=(3, 1))


def test_a_chunk_past_the_cache_or_into_a_recurrent_state_raises():
    p = Pair("qwen2.5-3b")
    cache = p.api.init_cache(p.cfg, B, 6, dtype=torch.float32, device="cpu")
    ids = p.chunks()
    with torch.no_grad():
        _, cache = p.api.prefill(p.params, ids[0], cache)
        with pytest.raises(ValueError, match="cannot take"):
            p.api.prefill(p.params, torch.cat(ids[1:3], dim=1), cache)
        for arch in ("rwkv6-3b", "zamba2-1.2b"):
            api = build_model(replace(get_config(arch).reduced(), compute_dtype="float32"))
            params = api.init(torch.Generator().manual_seed(0), "cpu")
            state = api.init_cache(api.cfg, B, 8, dtype=torch.float32, device="cpu")
            _, state = api.prefill(params, ids[0], state)
            with pytest.raises(ValueError, match="one token at a time"):
                api.prefill(params, ids[3], state)


def test_moe_chunk_keeps_the_reference_capacity_and_queue_order(monkeypatch):
    """Capacity factor 0.5, so that a chunk drops pairs: every dispatch of
    each chunk keeps the pairs the reference's ``_capacity(B * S_chunk)``
    and stable (token, slot) queue order keep for the experts the chunk's
    router chose."""
    p = Pair(MOE, (("capacity_factor", 0.5),))
    routed = []
    router = moe._router

    def recording(xf, w, cfg):
        out = router(xf, w, cfg)
        routed.append(out[1].reshape(-1).numpy())
        return out
    monkeypatch.setattr(moe, "_router", recording)
    moe.DISPATCH_TRACE = []
    try:
        p.chunked()
        trace = moe.DISPATCH_TRACE
    finally:
        moe.DISPATCH_TRACE = None
    sizes = [n for n in CHUNKS for _ in range(p.cfg.n_layers)]
    assert len(trace) == len(routed) == len(sizes)
    drops = 0
    for idx, t, n in zip(routed, trace, sizes):
        cap = ref_moe._capacity(B * n, p.ref_cfg)
        seen = np.zeros(p.cfg.n_experts, np.int64)
        keep = np.zeros(idx.shape, bool)
        for i, e in enumerate(idx):
            keep[i] = seen[e] < cap
            seen[e] += 1
        assert t["buffer"][1] == cap
        np.testing.assert_array_equal(t["keep"].reshape(-1).numpy(), keep)
        drops += int((~keep).sum())
    assert drops > 0, "capacity must bind"
