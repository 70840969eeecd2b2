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
  ``kv_seq`` in two blocks, the boundary inside the last chunk) against the
  unsplit chunked pass into the same buffer, followed by two decode steps:
  each rank attends with every row of a later chunk over its own block (K2
  with its log-sum-exp at the chunk's offset in the block) and K3' folds
  the ranks; the third chunk leaves rank 1 with no visible key, the fourth
  straddles the boundary, and a case whose cache holds garbage past the
  prefix shows that no key past it is read.  The serving step splits only a
  prompt from index 0 over a sequence axis, so no case splits a later
  chunk's tokens;
* the rank fold alone (two key blocks' partials folded by K3''s plain
  version) equals K2's plain version over the whole prefix, rows that one
  block masks wholly included;
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

    def cache(self, max_len=None, garbage=False):
        """An empty float32 cache of ``max_len`` positions (the pair's by
        default); with ``garbage`` its self-attention K/V filled with
        random values (seed 1), which only positions past the prefix keep."""
        cache = self.api.init_cache(self.cfg, B, max_len or self.max_len,
                                    dtype=torch.float32, device="cpu")
        if garbage:
            gen = torch.Generator().manual_seed(1)
            for name in ("k", "v"):
                cache[name].copy_(torch.randn(cache[name].shape, generator=gen))
        return cache

    def chunked(self, chunks=None, cache=None, decode=()):
        """The port's chunked prefill into ``cache`` (an empty one of the
        pair's length by default), then a decode step for each of the
        ``decode`` ids: after each chunk and step its logits and a copy of
        the cache."""
        cache = self.cache() if cache is None else cache
        out = []
        with torch.no_grad():
            for i, ids in enumerate(chunks or self.chunks()):
                logits, cache = self.api.prefill(self.params, ids, cache,
                                                 **(self.inputs() if i == 0 else {}))
                out.append((logits, {k: v.clone() if isinstance(v, torch.Tensor) else v
                                     for k, v in cache.items()}))
            for ids in decode:
                logits, cache = self.api.decode_step(self.params, ids, cache)
                out.append((logits, {k: v.clone() if isinstance(v, torch.Tensor) else v
                                     for k, v in cache.items()}))
        return out

    def kv_split_len(self):
        """A buffer of two kv_seq blocks whose boundary falls inside the last
        chunk, after the third: 16 + 4 positions past the prefix in blocks
        of ``prefix + 10``."""
        return 2 * (self.api.prefix_len() + 10)

    def decode_ids(self, n=2):
        rng = np.random.default_rng(2)
        return [torch.from_numpy(rng.integers(1, self.cfg.vocab_size, size=(B, 1))).long()
                for _ in range(n)]

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


def _chunk_case(p, arch, plan, chunks, tmp_path, name=None, cache=None, decode=()):
    name = name or plan
    data = {"params": p.params, "chunks": chunks, "inputs": p.inputs(),
            "cache": p.cache() if cache is None else cache, "decode": list(decode)}
    torch.save(data, tmp_path / f"chunks-{name}.pt")
    return {"name": name, "arch": arch, "reduced": dict(ARCHS[arch]), "plan": plan,
            "data": f"chunks-{name}.pt", "chunked": True}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chunks_split_over_heads_or_kv_seq_equal_the_unsplit_ones(arch, tmp_path):
    p = Pair(arch, ARCHS[arch])
    want = {"megatron_tp": p.chunked()}
    ids, decode = p.chunks(), p.decode_ids()
    cases = [_chunk_case(p, arch, "megatron_tp", ids, tmp_path)]
    T = p.kv_split_len()
    for name, garbage in (("kv_sequence_split", False), ("kv_seq_garbage_tail", True)):
        cache = p.cache(T, garbage)
        cases.append(_chunk_case(p, arch, "kv_sequence_split", ids, tmp_path, name=name,
                                 cache=cache, decode=decode))
        want[name] = p.chunked(cache=p.cache(T, garbage), decode=decode)
    spawn({"mode": "serve", "mesh": [1, 2], "cases": cases, "kernels": "cuda"}, tmp_path)
    P = p.api.prefix_len()
    for case in cases:
        name, plan = case["name"], plan_named(case["plan"])
        for rank in range(2):
            mesh = SH.Mesh(("data", "model"), (1, 2), rank=rank)
            got = torch.load(tmp_path / f"{name}.rank{rank}.pt", weights_only=False)
            assert got["error"] is None and len(got["chunks"]) == len(want[name]), got["error"]
            for i, ((logits, cache), part) in enumerate(zip(want[name], got["chunks"])):
                what = f"{arch} {name} rank {rank} step {i}"
                _close(part["logits"], logits, what)
                assert part["index"] == cache["index"], what
                c_sh = SS.cache_shardings(p.api, cache, plan, mesh)
                for leaf, w in cache.items():
                    if leaf == "index":
                        continue
                    split = {"megatron_tp": 3}.get(name, 2)
                    if leaf in ("k", "v") or name == "megatron_tp":
                        assert c_sh[leaf].spec[split] == "model", (what, leaf, c_sh[leaf].spec)
                    _close(part["cache"][leaf], c_sh[leaf].local(w), f"{what} cache {leaf}")
        if name != "megatron_tp":
            # the blocks split at prefix + 10: after the third chunk (prefix
            # + 8 positions) rank 1 holds no key, the fourth straddles it
            assert T // 2 == P + 10 and P + sum(CHUNKS[:3]) < T // 2 < P + sum(CHUNKS)


def test_rank_fold_equals_attention_over_the_whole_prefix():
    """:func:`layers._block_partials` of two key blocks, stacked as the
    gather over the ranks stacks them and folded by K3''s plain version,
    against K2's plain version over the whole prefix at the chunk's index.
    The chunk (rows at positions 5-12) against blocks [0, 8) and [8, 16):
    rows 0-2 lie ahead of the second block, which masks them wholly; keys
    past position 12 are garbage that the causal mask must skip."""
    from repro_torch.kernels import flash_attention as FA, flash_decode as FD
    from repro_torch.models import layers as L
    cfg = replace(get_config("qwen2.5-3b").reduced(n_kv_heads=2), compute_dtype="float32",
                  kernels="cuda")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    gen = torch.Generator().manual_seed(0)
    index, S, block = 5, 8, 8
    q = torch.randn(B, S, H, D, generator=gen)
    ck, cv = (torch.randn(B, 2 * block, Hkv, D, generator=gen) for _ in range(2))
    parts = [L._block_partials(q, ck[:, b * block:(b + 1) * block],
                               cv[:, b * block:(b + 1) * block], index - b * block, cfg)
             for b in range(2)]
    m, l, acc = (torch.cat(t, dim=1) for t in zip(*parts))
    # the second block's rows ahead of it: the empty split's form
    m2, l2 = parts[1][0].reshape(B, H, S), parts[1][1].reshape(B, H, S)
    assert (m2[..., :block - index] == FA.NEG_INF).all() and (l2[..., :block - index] == 0).all()
    assert (l2[..., block - index:] == 1).all()
    got = FD.combine_partials_plain(m, l, acc).reshape(B, H, S, D)
    qf = q.permute(0, 2, 1, 3).reshape(B * H, S, D)
    want, _ = FA.flash_attention_plain(qf, ck.permute(0, 2, 1, 3), cv.permute(0, 2, 1, 3),
                                       sm_scale=D ** -0.5, causal=True, q_per_kv=H // Hkv,
                                       q_offset=index, return_lse=True)
    _close(got, want.reshape(B, H, S, D), "fold of two blocks")
    # a chunk wholly ahead of a block launches nothing: its rows take K2's
    # wholly-masked log-sum-exp (+1e30), mapped to the empty split's form so
    # that their zero output takes no weight
    lone = L._block_partials(q[:, :1], ck[:, :block], cv[:, :block], -1, cfg)
    assert lone[0].eq(FA.NEG_INF).all() and lone[1].eq(0).all() and lone[2].eq(0).all()


def test_a_later_chunk_into_a_cache_not_split_over_kv_seq_refuses():
    """The later-chunk branch of :func:`layers._prompt_into_split` folds
    the ranks' blocks along ``kv_seq``; handed a cache without that split
    (no serving plan routes one there) it raises before writing a key."""
    from repro_torch.models import layers as L
    cfg = replace(get_config("qwen2.5-3b").reduced(n_kv_heads=2), compute_dtype="float32")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, 4, H, D, generator=gen)
    k, v = (torch.randn(B, 4, Hkv, D, generator=gen) for _ in range(2))
    ck, cv = torch.zeros(B, 16, Hkv, D), torch.zeros(B, 16, Hkv, D)
    with pytest.raises(NotImplementedError, match="item 2c"):
        L._prompt_into_split(q, k, v, ck, cv, 3, None, True, cfg)
    assert not ck.any() and not cv.any()


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
