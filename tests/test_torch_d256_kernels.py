"""Head dim 256 (gemma-7b's): which body K2 and K2-bwd run, what the TMA +
``wgmma`` bodies take, and what the planner ranks, on the CPU.

An aligned bf16 call at d 256 runs the Hopper bodies
(``csrc/flash_attention_tma.cu``, ``csrc/flash_attention_bwd_tma.cu``); an
unaligned one, float32, or any other head dim keeps its body.  The choice is
``flash_attention.body_of`` of the call's dtype, head dim, k/v strides and
pointers, made before the launch; the kernels themselves run only on the card
(``tests/test_torch_gpu.py``).  The plain versions that a CPU tensor takes are
held against the reference's Pallas kernel in interpret mode and against
``jax.grad`` of its ``attention_ref`` at the shapes the new bodies serve
(float32 1e-4, bfloat16 2e-2, the tolerances of tests/test_kernels.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as ref_flash_attention
from repro_torch import kernels, plancache
from repro_torch.core import lower_torch as LT
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FAB
from repro_torch.kernels import ops

BF16, F32 = torch.bfloat16, torch.float32
ALIGNED = [0x7f0000000000, 0x7f0000010000, 0x7f0000020000]


@pytest.mark.parametrize("case", [
    # dtype, d, strides (elements), pointers, body
    (BF16, 256, [512 * 256, 512 * 256, 256] * 2, ALIGNED, "tma"),     # contiguous (B, H, S, d)
    (BF16, 256, [512 * 16 * 256, 256, 16 * 256] * 2, ALIGNED, "tma"),  # (B, S, H, d) viewed
    (BF16, 256, [0, 512 * 256, 256] * 2, ALIGNED, "tma"),             # a broadcast batch
    (BF16, 256, [512 * 256, 512 * 256, 256] * 2, [ALIGNED[0] + 2] + ALIGNED[1:], "mma"),
    (BF16, 256, [512 * 260, 512 * 260, 260] * 2, ALIGNED, "mma"),     # rows of 260
    (BF16, 256, [512 * 256, 512 * 256, 256] * 2, ALIGNED[:2] + [ALIGNED[2] + 8], "mma"),
    (BF16, 128, [512 * 128, 512 * 128, 128] * 2, ALIGNED, "mma"),
    (BF16, 64, [512 * 64, 512 * 64, 64] * 2, ALIGNED, "mma"),
    (BF16, 32, [512 * 32, 512 * 32, 32] * 2, ALIGNED, "mma"),
    (F32, 256, [512 * 256, 512 * 256, 256] * 2, ALIGNED, "f32"),
    (F32, 128, [512 * 128, 512 * 128, 128] * 2, ALIGNED, "f32"),
])
def test_body_is_a_function_of_dtype_head_dim_strides_and_alignment(case):
    """Aligned bf16 at d 256 takes the TMA body; a pointer or a k/v stride
    off TMA's 16-byte rule, float32, or d up to 128 the body it had."""
    dtype, d, strides, pointers, body = case
    assert FA.body_of(dtype, d, strides, pointers) == body


def _kv_view(n_kv, Skv, d, offset):
    """(1, n_kv, Skv, d) view of a (1, Skv, n_kv, d) bf16 buffer starting
    ``offset`` elements into its storage (1: not 16-byte aligned)."""
    buf = torch.zeros(offset + Skv * n_kv * d, dtype=BF16)
    return buf[offset:].view(1, Skv, n_kv, d).permute(0, 2, 1, 3)


@pytest.mark.parametrize("offset,body", [(0, "tma"), (1, "mma"), (8, "tma")])
def test_body_of_the_views_the_layers_hand_over(offset, body):
    """The serving path's k/v, a (B, Hkv, S, d) view of the (B, S, Hkv, d)
    projection, takes the TMA body when its storage is 16-byte aligned (an
    offset of 8 bf16 elements is 16 bytes)."""
    q = torch.zeros(16, 40, 256, dtype=BF16)
    k, v = _kv_view(16, 40, 256, offset), _kv_view(16, 40, 256, offset)
    strides = [*k.stride()[:3], *v.stride()[:3]]
    got = FA.body_of(q.dtype, 256, strides, [t.data_ptr() for t in (q, k, v)])
    assert got == body


def test_cpu_calls_run_the_plain_versions_and_count_no_body():
    kernels.reset_launch_counts()
    q = torch.randn(4, 24, 256).to(BF16)
    k, v = torch.randn(4, 24, 256).to(BF16), torch.randn(4, 24, 256).to(BF16)
    out, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
    FAB.flash_attention_bwd(q, k, v, out, lse, torch.randn_like(q), causal=True)
    by_body = kernels.launches_by_body()
    assert by_body["flash_attention"] == {"tma": 0, "mma": 0, "f32": 0}
    assert by_body["flash_attention_bwd"] == {"tma": 0, "mma": 0, "f32": 0}
    assert kernels.launch_counts()["flash_attention"] == 0


def test_reset_clears_the_attention_bodies():
    FA.launches_by_body["tma"] = 3
    FAB.launches_by_body["mma"] = 2
    kernels.reset_launch_counts()
    assert set(FA.launches_by_body.values()) == {0}
    assert set(FAB.launches_by_body.values()) == {0}


def test_tma_footprints_leave_every_tile_to_the_planner():
    """Unpadded rows under the 128-byte swizzle: the four tiles take
    (bq + 4 bkv) x 512 bytes of Q, K and V, 1 KB of alignment and seven
    mbarriers, all within a block's 227 KB; (64, 32) fits twice an SM."""
    for bq, bkv in FA.COMPILED_TILES:
        got = FA.flash_smem_bytes(bq, bkv, 256, 2)
        assert got == 1024 + (bq + 4 * bkv) * 512 + 56
        assert got < FA.flash_smem_bytes(bq, bkv, 256, 2, "mma") <= FA.MAX_SMEM
    assert FA.flash_smem_bytes(128, 64, 256, 2) == 197688
    assert FA.legal_tiles(256, 2) == FA.COMPILED_TILES
    assert 2 * (FA.flash_smem_bytes(64, 32, 256, 2) + 1024) <= FA.SM_SMEM
    assert FA.tma_blocks_per_sm(64, 32) == 2 and FA.tma_blocks_per_sm(128, 64) == 1


@pytest.fixture()
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    plancache.reset_store()
    LT.clear_block_caches()
    yield plancache.get_store()
    plancache.reset_store()
    LT.clear_block_caches()


def test_planner_ranks_the_four_d256_tiles_by_their_tma_footprints(store, fast_search,
                                                                   monkeypatch):
    """gemma-7b's prefill (512 x 512, d 256, bf16): the planner ranks one
    program a compiled tile, all four, and keys its choice by each tile's
    footprint on the TMA body, which an aligned call runs."""
    seen = {}
    real_key, real_multi = plancache.request_key, LT.plan_kernel_multi

    def key(template, params, hw, budget, extra=None):
        if template == "flash_blocks":
            seen["tiles"] = extra["tiles"]
        return real_key(template, params, hw, budget, extra=extra)

    def multi(progs, *a, **kw):
        seen["programs"] = len(progs)
        return real_multi(progs, *a, **kw)

    monkeypatch.setattr(plancache, "request_key", key)
    monkeypatch.setattr(LT, "plan_kernel_multi", multi)
    block = LT.plan_flash_blocks(512, 512, 256, BF16)
    assert block in FA.COMPILED_TILES
    assert seen["programs"] == 4
    assert seen["tiles"] == [[64, 32, 99384], [64, 64, 164920], [128, 32, 132152],
                             [128, 64, 197688]]
    assert LT.resolved_blocks()[("flash_blocks", (512, 512, 256, 2))] == (block, "search")
    assert LT.planner_fallback_count() == 0


@pytest.mark.parametrize("case", [
    # BH, q_per_kv, Sq, Skv, q_offset, dq grid, dK/dV grid, first key tile's work
    (64, 1, 512, 512, 0, (64, 4), (64, 8), 8),       # gemma-7b's training pass
    (16, 1, 128, 320, 64, (16, 1), (16, 5), 2),      # rows at a kv_seq block's offset
    (8, 4, 200, 136, 0, (8, 2), (2, 3), 16),         # grouped, Sq > Skv
    (6, 3, 77, 150, 0, (6, 1), (2, 3), 6),           # ragged
])
def test_tma_bwd_geometry(case):
    """The TMA body's two launches: one dQ block per (query head, 128-row
    tile), one dK/dV block per (kv head, 64-key tile) walking every query
    tile that sees its keys for each head of the group; both walk the same
    (64 x 64) tile pairs."""
    BH, g, Sq, Skv, off, dq_grid, dkv_grid, first = case
    geo = FAB.bwd_geometry(BH, Sq, Skv, 256, g, causal=True, q_offset=off)
    assert geo["dq"]["grid"] == dq_grid and geo["dkv"]["grid"] == dkv_grid
    assert geo["dkv"]["heads_per_block"] == g and geo["dkv"]["cluster"] == 1
    assert geo["dkv"]["work"][0] == first == max(geo["dkv"]["work"])
    assert sum(geo["dq"]["work"]) == sum(geo["dkv"]["work"])


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(BF16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(3, 128, 128, True), (1, 64, 192, False), (4, 64, 64, True)])
def test_grouped_d256_attention_matches_reference_kernel(case, dtype):
    """The d-256 shapes the TMA body serves, grouped (the reference repeats
    k/v before its kernel), through ``ops.attention`` on the CPU against the
    reference's Pallas kernel in interpret mode."""
    g, Sq, Skv, causal = case
    BH, d = 2 * g, 256
    rng = np.random.default_rng(31)
    qj, qt = _pair(rng, (BH, Sq, d), dtype)
    kj, kt = _pair(rng, (BH // g, Skv, d), dtype)
    vj, vt = _pair(rng, (BH // g, Skv, d), dtype)
    want = ref_flash_attention(qj, jnp.repeat(kj, g, axis=0), jnp.repeat(vj, g, axis=0),
                               causal=causal, block_q=64, block_kv=64, interpret=True)
    got = ops.attention(qt, kt, vt, causal=causal, q_per_kv=g, block_q=64, block_kv=32)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("case", [(3, 77, 150, True), (1, 150, 77, True), (2, 77, 150, False)])
def test_ragged_d256_attention_matches_reference(case):
    """Ragged lengths no tile divides, Sq != Skv, causal by absolute
    position: ``ops.attention`` with its log-sum-exp against the reference's
    ``attention_ref``."""
    g, Sq, Skv, causal = case
    BH, d = 2 * g, 256
    rng = np.random.default_rng(32)
    qj, qt = _pair(rng, (BH, Sq, d), "float32")
    kj, kt = _pair(rng, (BH // g, Skv, d), "float32")
    vj, vt = _pair(rng, (BH // g, Skv, d), "float32")
    want = jref.attention_ref(qj, jnp.repeat(kj, g, axis=0), jnp.repeat(vj, g, axis=0),
                              causal=causal)
    got = ops.attention(qt, kt, vt, causal=causal, q_per_kv=g)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", [(1, 64, 64, 0), (1, 48, 112, 64), (3, 40, 72, 0)])
def test_d256_bwd_plain_matches_jax_grad_of_reference(case):
    """K2-bwd's plain version at d 256, from the forward's log-sum-exp,
    against ``jax.grad`` of the reference's ``attention_ref``; a query offset
    (rows at positions ``off + r`` against the prefix of keys) is the
    reference's mask on the last ``Sq`` rows of a sequence of ``off + Sq``."""
    g, Sq, Skv, off = case
    BH, d = 2 * g, 256
    rng = np.random.default_rng(41)
    qj, qt = _pair(rng, (BH, Sq, d), "float32")
    kj, kt = _pair(rng, (BH // g, Skv, d), "float32")
    vj, vt = _pair(rng, (BH // g, Skv, d), "float32")
    dj, dt = _pair(rng, (BH, Sq, d), "float32")
    q_full = jnp.pad(qj, ((0, 0), (off, 0), (0, 0))) if off else qj
    mask = np.zeros((BH, off + Sq, d), np.float32)
    mask[:, off:] = 1.0
    d_full = jnp.pad(dj, ((0, 0), (off, 0), (0, 0))) if off else dj

    def f(q, k, v):
        out = jref.attention_ref(q, jnp.repeat(k, g, axis=0), jnp.repeat(v, g, axis=0),
                                 causal=True)
        return jnp.sum(out * d_full * mask)

    assert off + Sq <= Skv
    k_used, v_used = kj[:, :off + Sq], vj[:, :off + Sq]
    want_q, want_k, want_v = jax.grad(f, argnums=(0, 1, 2))(q_full, k_used, v_used)
    out, lse = FA.flash_attention_plain(qt, kt, vt, causal=True, q_per_kv=g,
                                        return_lse=True, q_offset=off)
    dq, dk, dv = FAB.flash_attention_bwd(qt, kt, vt, out, lse, dt, causal=True, q_per_kv=g,
                                         q_offset=off)
    np.testing.assert_allclose(_np(dq), np.asarray(want_q)[:, off:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(dk)[:, :off + Sq], np.asarray(want_k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(dv)[:, :off + Sq], np.asarray(want_v), rtol=1e-4, atol=1e-4)
    assert not dk[:, off + Sq:].any() and not dv[:, off + Sq:].any()
