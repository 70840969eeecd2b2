"""Head dim 256 in K3 (gemma-7b's decode) and K3', on the CPU.

An aligned bf16 call at d 256 runs the Hopper body of
``csrc/flash_decode_tma.cu``; an unaligned one, float32, or any other head
dim keeps its body.  The choice is ``flash_decode.body_of`` of the call's
dtype, head dim, k/v strides and pointers, made before the launch, and the
split count follows the body (``choose_splits``).  The kernels themselves run
only on the card (``tests/test_torch_gpu.py``).  The plain versions that a
CPU tensor takes are held against the reference's Pallas kernel in interpret
mode where the splits divide the buffer, else against attention over the
valid keys, at the shapes and split counts the new body serves (float32
1e-4, bfloat16 2e-2, the tolerances of tests/test_kernels.py); K3''s plain
version against the reference's ``combine_partials``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import combine_partials as ref_combine
from repro.kernels.flash_decode import flash_decode_partials as ref_partials
from repro_torch import kernels
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ops, ref

BF16, F32 = torch.bfloat16, torch.float32
ALIGNED = [0x7f0000000000, 0x7f0000010000, 0x7f0000020000]
H100_SMS = 132
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(BF16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------- the body
@pytest.mark.parametrize("case", [
    # dtype, d, k/v strides (elements), q/k/v pointers, body
    (BF16, 256, [545 * 16 * 256, 256, 16 * 256] * 2, ALIGNED, "tma"),   # the cache, viewed
    (BF16, 256, [16 * 545 * 256, 545 * 256, 256] * 2, ALIGNED, "tma"),  # contiguous
    (BF16, 256, [545 * 16 * 256, 256, 16 * 256] * 2, [ALIGNED[0] + 2] + ALIGNED[1:], "mma"),
    (BF16, 256, [545 * 16 * 256, 256, 16 * 256] * 2, ALIGNED[:2] + [ALIGNED[2] + 4], "mma"),
    (BF16, 256, [545 * 16 * 260, 260, 16 * 260] * 2, ALIGNED, "mma"),   # rows of 260
    (BF16, 256, [545 * 16 * 256, 256, 16 * 256 + 4] * 2, ALIGNED, "mma"),
    (BF16, 128, [545 * 2 * 128, 128, 2 * 128] * 2, ALIGNED, "mma"),
    (BF16, 64, [545 * 32 * 64, 64, 32 * 64] * 2, ALIGNED, "mma"),
    (BF16, 32, [545 * 32, 32, 32] * 2, ALIGNED, "mma"),
    (F32, 256, [545 * 16 * 256, 256, 16 * 256] * 2, ALIGNED, "f32"),
    (F32, 128, [545 * 2 * 128, 128, 2 * 128] * 2, ALIGNED, "f32"),
])
def test_decode_body_is_a_function_of_dtype_head_dim_strides_and_alignment(case):
    """Aligned bf16 at d 256 takes the TMA body; a pointer or a k/v stride
    off TMA's 16-byte rule, float32, or d up to 128 the body it had."""
    dtype, d, strides, pointers, body = case
    assert FD.body_of(dtype, d, strides, pointers) == body


def _cache_view(B, T, n_kv, d, offset, dtype=BF16):
    """(B, n_kv, T, d) view of a (B, T, n_kv, d) cache starting ``offset``
    elements into its storage: what ``layers._sdpa_kernel`` hands over."""
    buf = torch.zeros(offset + B * T * n_kv * d, dtype=dtype)
    return buf[offset:].view(B, T, n_kv, d).permute(0, 2, 1, 3)


@pytest.mark.parametrize("offset,body", [(0, "tma"), (1, "mma"), (8, "tma")])
def test_decode_body_of_the_views_the_layers_hand_over(offset, body):
    """gemma-7b's decode step: q (4 x 16, 1, 256) contiguous, k/v the
    cache's (B, Hkv, T, d) views; 8 bf16 elements are 16 bytes."""
    q = torch.zeros(64, 1, 256, dtype=BF16)
    k, v = _cache_view(4, 545, 16, 256, offset), _cache_view(4, 545, 16, 256, offset)
    assert FD.body_for(q, k, v) == body
    assert FD.body_for(q.float(), k.float(), v.float()) == "f32"
    assert FD.body_for(q[:, :, :128].contiguous(), k[..., :128], v[..., :128]) == "mma"


# ------------------------------------------------------------- the splits
def test_tma_splits_fill_whole_waves_at_gemmas_decode():
    """gemma-7b's 64 groups (4 sequences x 16 kv heads): 2 splits on an
    H100, 128 blocks in one wave of one block an SM (132), the same through
    all 32 decode steps (513 to 544 valid keys); strips of 257 keys."""
    for valid in range(513, 545):
        s = FD.choose_splits(valid, 64, H100_SMS, FD.MAX_CLUSTER_SPLITS, "tma")
        assert s == 2
        assert 64 * s <= H100_SMS < 64 * (s + 1)
        assert -(-valid // s) >= FD.TMA_TILE_KEYS
    assert -(-513 // 2) == 257
    # the mma.sync body's rule at the same shape: 5 splits, 2.4 waves of 132
    assert FD.choose_splits(513, 64, H100_SMS, FD.MAX_CLUSTER_SPLITS) == 5


@pytest.mark.parametrize("groups", [1, 4, 16, 33, 64, 132, 264, 300])
@pytest.mark.parametrize("valid", [0, 1, 31, 32, 63, 64, 129, 513, 4096, 100_000])
def test_tma_split_rule(groups, valid):
    """At most one wave of one block an SM, at most 8 splits with the
    one-launch epilogue (one cluster) and 64 without, and no strip shorter
    than the 32-key tile (a strip of fewer valid keys is the only one)."""
    slots = H100_SMS
    for cap in (FD.MAX_CLUSTER_SPLITS, FD.MAX_SPLITS):
        s = FD.choose_splits(valid, groups, H100_SMS, cap, "tma")
        assert 1 <= s <= cap
        assert groups * s <= max(slots, groups)
        if s > 1:
            assert -(-valid // s) >= FD.TMA_TILE_KEYS
            assert groups * s <= slots
        if s < cap and valid // FD.TMA_TILE_KEYS > s:
            assert groups * (s + 1) > slots            # a wave could take no more


# (groups, valid keys) -> (capped, uncapped) splits of every served decode
# shape on the mma.sync body: qwen2.5-3b, the MoE, zamba2-1.2b, internvl2-1b
# and seamless's cross step at their first decode step on an H100
SERVED_MMA_SPLITS = {"qwen2.5-3b": ((8, 513), (8, 9)),
                     "qwen3-moe-30b-a3b": ((16, 513), (8, 9)),
                     "zamba2-1.2b": ((128, 513), (3, 3)),
                     "internvl2-1b": ((8, 769), (8, 13)),
                     "seamless-m4t-medium cross": ((64, 1024), (5, 5))}


@pytest.mark.parametrize("arch", sorted(SERVED_MMA_SPLITS))
@pytest.mark.parametrize("body", ["mma", "f32"])
def test_mma_and_f32_split_counts_are_kept(arch, body):
    (groups, valid), (capped, uncapped) = SERVED_MMA_SPLITS[arch]
    assert FD.choose_splits(valid, groups, H100_SMS, FD.MAX_CLUSTER_SPLITS, body) == capped
    assert FD.choose_splits(valid, groups, H100_SMS, body=body) == uncapped
    assert FD.choose_splits(valid, groups, H100_SMS) == uncapped


def test_ops_takes_the_split_rule_of_the_body_it_runs(monkeypatch):
    """``ops.flash_decode`` asks ``choose_splits`` for the body its tensors
    choose: "tma" for gemma's aligned bf16 cache, "mma" one element off."""
    seen = []
    rule = FD.choose_splits

    def spy(*args, **kw):
        seen.append(args[4] if len(args) > 4 else kw.get("body", "mma"))
        return rule(*args, **kw)

    monkeypatch.setattr(FD, "choose_splits", spy)
    q = torch.randn(8, 1, 256).to(BF16)
    for offset in (0, 1):
        k, v = _cache_view(1, 40, 8, 256, offset), _cache_view(1, 40, 8, 256, offset)
        ops.flash_decode(q, k, v, kv_valid_len=33)
        ops.flash_decode_partials(q, k, v, kv_valid_len=33)
    assert seen == ["tma", "tma", "mma", "mma"]


# ------------------------------------------------------------- footprints
def test_tma_footprint_fits_two_blocks_an_sm():
    """1 KB of alignment, three stages of a 32-key K and V tile (16 KB
    each), 16 query rows of 264, two 16 x 40 float32 score buffers and six
    mbarriers: 112,944 bytes, two blocks an SM; the result reuses the ring."""
    got = FD.decode_smem_bytes(256, 2, "tma")
    assert got == 1024 + 3 * 2 * 32 * 256 * 2 + 16 * 264 * 2 + 2 * 16 * 40 * 4 + 48 == 112944
    assert FD.TMA_BLOCKS_PER_SM * (got + 1024) <= FA.SM_SMEM
    assert (2 * 16 + 16 * 256) * 4 <= FD.TMA_STAGES * 2 * FD.TMA_TILE_KEYS * 256 * 2
    # the other bodies' footprints, by name and by default, as before
    assert FD.decode_smem_bytes(256, 2, "mma") == FD.decode_smem_bytes(256, 2) == 160128
    assert FD.decode_smem_bytes(256, 4, "f32") == FD.decode_smem_bytes(256, 4) == 149632
    assert got < FD.decode_smem_bytes(256, 2)


# ------------------------------------------------------------- counts
def test_cpu_calls_count_no_decode_body():
    kernels.reset_launch_counts()
    q = torch.randn(4, 1, 256).to(BF16)
    k, v = torch.randn(4, 40, 256).to(BF16), torch.randn(4, 40, 256).to(BF16)
    ops.flash_decode(q, k, v, kv_valid_len=33)
    FD.combine_partials(*ops.flash_decode_partials(q, k, v, kv_valid_len=33))
    assert kernels.launches_by_body()["flash_decode"] == {"tma": 0, "mma": 0, "f32": 0}
    assert sum(kernels.launch_counts().values()) == 0


def test_reset_clears_the_decode_bodies():
    FD.launches_by_body["tma"] = 5
    FD.launches_by_body["f32"] = 1
    kernels.reset_launch_counts()
    assert set(FD.launches_by_body.values()) == {0}


# ------------------------------------------------------------- plain versions
@pytest.mark.parametrize("g,skv,splits", [(1, 512, 4), (8, 512, 4), (1, 256, 8), (8, 256, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_d256_plain_versions_match_the_reference_kernel(g, skv, splits, dtype):
    """Whole buffers whose splits divide them (the reference's rule): the
    one-launch decode and partials + K3' at G 1 and 8 against the
    reference's partials (interpret mode) and combine."""
    n_kv, d = 2, 256
    BH = n_kv * g
    rng = np.random.default_rng(33 + g + splits)
    qj, qt = _pair(rng, (BH, 1, d), dtype)
    kj, kt = _pair(rng, (n_kv, skv, d), dtype)
    vj, vt = _pair(rng, (n_kv, skv, d), dtype)
    m, l, acc = ref_partials(qj, jnp.repeat(kj, g, axis=0), jnp.repeat(vj, g, axis=0),
                             kv_splits=splits, block_kv=64, interpret=True)
    want = ref_combine(m, l, acc)
    got = ops.flash_decode(qt, kt, vt, kv_splits=splits, q_per_kv=g)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    mt, lt, acct = FD.flash_decode_partials(qt, kt, vt, kv_splits=splits, q_per_kv=g)
    np.testing.assert_allclose(_np(FD.combine_partials(mt, lt, acct)), _np(want), **_tol(dtype))


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_d256_plain_versions_at_a_ragged_valid_length(g, dtype):
    """513 valid keys of a 545-key cache in the TMA body's split counts (2,
    gemma's, 4, and 5 and 17, whose strips do not divide anything) against
    attention over the valid keys (``kernels/ref.py``)."""
    B, n_kv, T, valid, d = 2, 2, 545, 513, 256
    rng = np.random.default_rng(44 + g)
    _, q = _pair(rng, (B * n_kv * g, 1, d), dtype)
    _, kc = _pair(rng, (B, T, n_kv, d), dtype)
    _, vc = _pair(rng, (B, T, n_kv, d), dtype)
    k, v = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    kr = k[:, :, :valid].reshape(B * n_kv, valid, d).repeat_interleave(g, dim=0)
    vr = v[:, :, :valid].reshape(B * n_kv, valid, d).repeat_interleave(g, dim=0)
    want = ref.decode_ref(q.float(), kr.float(), vr.float())
    assert FD.choose_splits(valid, B * n_kv * 8, H100_SMS, FD.MAX_CLUSTER_SPLITS, "tma") == 4
    for splits in (2, 4, 5, 17):
        if splits <= FD.MAX_CLUSTER_SPLITS:
            got = ops.flash_decode(q, k, v, kv_splits=splits, kv_valid_len=valid, q_per_kv=g)
            np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
        m, l, acc = FD.flash_decode_partials(q, k, v, kv_splits=splits, kv_valid_len=valid,
                                             q_per_kv=g)
        assert m.shape == (B * n_kv * g, splits, 1, 1)
        np.testing.assert_allclose(_np(FD.combine_partials(m, l, acc, out_dtype=q.dtype)),
                                   _np(want), **_tol(dtype))


# ------------------------------------------------------------- K3'
@pytest.mark.parametrize("rows,splits,d", [(64, 16, 128), (8192, 2, 128), (64, 9, 128),
                                           (64, 5, 256)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_combine_plain_matches_the_reference_with_empty_splits(rows, splits, d, out):
    """K3''s plain version against the reference's ``combine_partials`` on
    partials with empty splits (-1e30, 0, 0) in every eighth row and one
    row that is all empty (output 0): mesh_serve's decode step (64 rows,
    16 splits) and qwen2.5-3b's chunk rows folded over two kv_seq ranks."""
    rng = np.random.default_rng(rows + splits + d)
    m = (rng.standard_normal((rows, splits, 1, 1)) * 4).astype(np.float32)
    l = (rng.random((rows, splits, 1, 1)) + 0.5).astype(np.float32)
    acc = rng.standard_normal((rows, splits, 1, d)).astype(np.float32)
    m[::8, 0], l[::8, 0], acc[::8, 0] = -1e30, 0.0, 0.0
    m[3], l[3], acc[3] = -1e30, 0.0, 0.0
    jdt, tdt = (jnp.float32, F32) if out == "float32" else (jnp.bfloat16, BF16)
    want = ref_combine(jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc), out_dtype=jdt)
    got = FD.combine_partials(torch.from_numpy(m), torch.from_numpy(l), torch.from_numpy(acc),
                              out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (rows, 1, d)
    assert torch.all(got[3] == 0)
    tol = dict(rtol=1e-5, atol=1e-5) if out == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
