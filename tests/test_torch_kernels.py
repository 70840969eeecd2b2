"""The port's plain kernel versions against the reference's Pallas kernels run
in interpret mode, over the reference's own sweeps.  Inputs are made with numpy
from a seed and handed to both sides; float32 at 1e-4, bfloat16 at 2e-2 (the
tolerances of tests/test_kernels.py: summation order differs, and bf16 rounds
at other places in the two frameworks)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention as ref_flash_attention
from repro.kernels.flash_decode import combine_partials as ref_combine
from repro.kernels.flash_decode import flash_decode_partials as ref_partials
from repro.kernels.gemm import gemm as ref_gemm
from repro.models.layers import _sdpa_xla_dense
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops, ref

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)
        return j, t
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -------------------------------------------------------------------- GEMM
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384),
                                   (128, 256, 128), (512, 256, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_matches_reference_kernel(shape, dtype):
    M, N, K = shape
    rng = np.random.default_rng(0)
    aj, at = _pair(rng, (M, K), dtype)
    bj, bt = _pair(rng, (K, N), dtype)
    want = ref_gemm(aj, bj, block=(128, 128, 128), out_dtype=jnp.float32,
                    interpret=True)
    got = G.gemm(at, bt, block=(128, 128, 32), out_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(ref.gemm_ref(at, bt, out_dtype=torch.float32)),
                               _np(want), **_tol(dtype))


def test_gemm_ops_wrapper_fits_blocks():
    rng = np.random.default_rng(1)
    aj, at = _pair(rng, (96, 160), "float32")
    bj, bt = _pair(rng, (160, 64), "float32")
    want = ref_ops.matmul(aj, bj, block=(128, 128, 128))
    got = ops.matmul(at, bt, block=(128, 128, 128))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_gemm_out_dtype_follows_input_by_default():
    at = torch.randn(64, 32).to(torch.bfloat16)
    bt = torch.randn(32, 48).to(torch.bfloat16)
    assert ops.matmul(at, bt, block=(64, 64, 16)).dtype == torch.bfloat16
    assert ops.matmul(at, bt, block=(64, 64, 16),
                      out_dtype=torch.float32).dtype == torch.float32


# --------------------------------------------------------- FlashAttention
@pytest.mark.parametrize("seq,blocks", [(256, (128, 128)), (256, (64, 128)),
                                        (512, (128, 256))])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_reference_kernel(seq, blocks, causal, dtype):
    BH, d = 4, 64
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (BH, seq, d), dtype)
    kj, kt = _pair(rng, (BH, seq, d), dtype)
    vj, vt = _pair(rng, (BH, seq, d), dtype)
    want = ref_flash_attention(qj, kj, vj, causal=causal, block_q=blocks[0],
                               block_kv=blocks[1], interpret=True)
    got = ops.attention(qt, kt, vt, causal=causal, block_q=blocks[0],
                        block_kv=blocks[1])
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(ref.attention_ref(qt, kt, vt, causal=causal)),
                               _np(want), **_tol(dtype))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_at_d256_matches_reference_kernel(causal, dtype):
    """Head dim 256 (gemma-7b's): the reference kernel only blocks over d."""
    BH, seq, d = 2, 128, 256
    rng = np.random.default_rng(21)
    qj, qt = _pair(rng, (BH, seq, d), dtype)
    kj, kt = _pair(rng, (BH, seq, d), dtype)
    vj, vt = _pair(rng, (BH, seq, d), dtype)
    want = ref_flash_attention(qj, kj, vj, causal=causal, block_q=64, block_kv=64,
                               interpret=True)
    got = ops.attention(qt, kt, vt, causal=causal, block_q=64, block_kv=32)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(ref.attention_ref(qt, kt, vt, causal=causal)),
                               _np(want), **_tol(dtype))


def test_flash_attention_cross_attention_shapes():
    """Sq != Skv (encoder-decoder cross attention)."""
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, (2, 128, 64), "float32")
    kj, kt = _pair(rng, (2, 384, 64), "float32")
    vj, vt = _pair(rng, (2, 384, 64), "float32")
    want = ref_flash_attention(qj, kj, vj, block_q=128, block_kv=128, interpret=True)
    got = ops.attention(qt, kt, vt, block_q=128, block_kv=128)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q_per_kv", [2, 4])
def test_flash_attention_grouped_strided_kv_equals_repeated(q_per_kv):
    """Un-repeated k/v as a strided (batch, kv_heads, T, d) view give what the
    reference computes on k/v repeated with jnp.repeat."""
    B, Hkv, S, d = 2, 2, 64, 32
    H = Hkv * q_per_kv
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, (B * H, S, d), "float32")
    kj, kt = _pair(rng, (B, S, Hkv, d), "float32")
    vj, vt = _pair(rng, (B, S, Hkv, d), "float32")
    rep = lambda x: jnp.repeat(x, q_per_kv, axis=2).transpose(0, 2, 1, 3).reshape(
        B * H, S, d)
    want = ref_flash_attention(qj, rep(kj), rep(vj), causal=True, block_q=32,
                               block_kv=32, interpret=True)
    got = ops.attention(qt, kt.permute(0, 2, 1, 3), vt.permute(0, 2, 1, 3),
                        causal=True, q_per_kv=q_per_kv)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_flash_attention_fully_masked_rows_give_zero():
    """The plain version keeps the kernel's l == 0 -> 1 rule: a causal row
    that sees no key (Sq > Skv cannot happen; an empty causal prefix can when
    queries are offset) is 0, never NaN."""
    q = torch.randn(1, 4, 32)
    k = torch.randn(1, 4, 32)
    v = torch.randn(1, 4, 32)
    out = FA.flash_attention_plain(q, k, v, causal=True)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_np(out[:, 0]), _np(v[:, 0]), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ FlashDecode
@pytest.mark.parametrize("skv,splits", [(1024, 4), (2048, 8), (512, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_matches_reference_kernel(skv, splits, dtype):
    BH, d = 4, 64
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (BH, 1, d), dtype)
    kj, kt = _pair(rng, (BH, skv, d), dtype)
    vj, vt = _pair(rng, (BH, skv, d), dtype)
    m, l, acc = ref_partials(qj, kj, vj, kv_splits=splits, block_kv=256,
                             interpret=True)
    want = ref_combine(m, l, acc)
    got = ops.flash_decode(qt, kt, vt, kv_splits=splits)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(ref.decode_ref(qt, kt, vt)), _np(want), **_tol(dtype))


@pytest.mark.parametrize("skv,splits", [(512, 4), (256, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_at_d256_matches_reference_kernel(skv, splits, dtype):
    """K3 at head dim 256, one launch and partials + combine, against the
    reference's partials and combine."""
    BH, d = 4, 256
    rng = np.random.default_rng(22)
    qj, qt = _pair(rng, (BH, 1, d), dtype)
    kj, kt = _pair(rng, (BH, skv, d), dtype)
    vj, vt = _pair(rng, (BH, skv, d), dtype)
    m, l, acc = ref_partials(qj, kj, vj, kv_splits=splits, block_kv=128, interpret=True)
    want = ref_combine(m, l, acc)
    got = ops.flash_decode(qt, kt, vt, kv_splits=splits)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    mt, lt, acct = FD.flash_decode_partials(qt, kt, vt, kv_splits=splits)
    np.testing.assert_allclose(_np(FD.combine_partials(mt, lt, acct)), _np(want), **_tol(dtype))


@pytest.mark.parametrize("skv,splits", [(1024, 4), (2048, 8), (512, 1)])
def test_partials_and_combine_match_reference_kernel(skv, splits):
    """The port's partials equal the reference kernel's split by split, and
    its combine, fed the reference kernel's own partials, equals the
    reference's combine."""
    BH, d = 4, 64
    rng = np.random.default_rng(6)
    qj, qt = _pair(rng, (BH, 1, d), "float32")
    kj, kt = _pair(rng, (BH, skv, d), "float32")
    vj, vt = _pair(rng, (BH, skv, d), "float32")
    m, l, acc = ref_partials(qj, kj, vj, kv_splits=splits, block_kv=256,
                             interpret=True)
    mt, lt, acct = FD.flash_decode_partials(qt, kt, vt, kv_splits=splits)
    assert mt.shape == m.shape and lt.shape == l.shape and acct.shape == acc.shape
    np.testing.assert_allclose(_np(mt), _np(m), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(lt), _np(l), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(acct), _np(acc), rtol=1e-4, atol=1e-4)
    as_t = lambda x: torch.from_numpy(np.asarray(x))
    got = FD.combine_partials(as_t(m), as_t(l), as_t(acc))
    np.testing.assert_allclose(_np(got), _np(ref_combine(m, l, acc)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 7, 513])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_valid_length_matches_reference_masked_path(n, dtype):
    """kv_valid_len on an odd 545-long buffer against the masked dense path
    the reference's serving loop takes."""
    B, H, Hkv, T, d = 2, 4, 2, 545, 32
    g = H // Hkv
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (B, 1, H, d), dtype)
    kj, kt = _pair(rng, (B, T, Hkv, d), dtype)
    vj, vt = _pair(rng, (B, T, Hkv, d), dtype)
    want = _sdpa_xla_dense(qj, jnp.repeat(kj, g, axis=2), jnp.repeat(vj, g, axis=2),
                           False, d ** -0.5, kv_valid_len=n)          # (B,1,H,d)
    q3 = qt.permute(0, 2, 1, 3).reshape(B * H, 1, d)
    got = ops.flash_decode(q3, kt.permute(0, 2, 1, 3), vt.permute(0, 2, 1, 3),
                           kv_valid_len=n, q_per_kv=g)
    got = got.reshape(B, H, 1, d).permute(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("n,splits", [(513, 9), (7, 3), (64, 64), (0, 2)])
def test_flash_decode_split_count_never_changes_the_result(n, splits):
    """Strips wholly beyond the valid length return (m, l, acc) =
    (-1e30, 0, 0) and the combine ignores them."""
    rng = np.random.default_rng(8)
    _, q = _pair(rng, (3, 1, 32), "float32")
    _, k = _pair(rng, (3, 545, 32), "float32")
    _, v = _pair(rng, (3, 545, 32), "float32")
    one = ops.flash_decode(q, k, v, kv_splits=1, kv_valid_len=n)
    many = ops.flash_decode(q, k, v, kv_splits=splits, kv_valid_len=n)
    np.testing.assert_allclose(_np(many), _np(one), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(many).all()


def test_choose_splits_follows_the_valid_length():
    sms = 132                                           # an H100's
    assert FD.choose_splits(1, 8, sms) == 1
    assert FD.choose_splits(513, 8, sms) == 9
    assert FD.choose_splits(100_000, 8, sms) == 33
    assert FD.choose_splits(100_000, 1, sms) == FD.MAX_SPLITS
    assert FD.choose_splits(545, 1024, sms) == 1
    assert FD.choose_splits(100_000, 8, FD.sm_count(torch.device("cpu"))) == 1


@pytest.mark.parametrize("skv,splits", [(1024, 4), (2048, 8), (512, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_launch_decode_wrapper_matches_reference_kernel(skv, splits, dtype):
    """``flash_decode.flash_decode`` (both stages, one launch on the card;
    its plain version on the CPU) equals the reference's partials and
    combine."""
    BH, d = 4, 64
    rng = np.random.default_rng(9)
    qj, qt = _pair(rng, (BH, 1, d), dtype)
    kj, kt = _pair(rng, (BH, skv, d), dtype)
    vj, vt = _pair(rng, (BH, skv, d), dtype)
    m, l, acc = ref_partials(qj, kj, vj, kv_splits=splits, block_kv=256,
                             interpret=True)
    got = FD.flash_decode(qt, kt, vt, kv_splits=splits)
    assert got.dtype == qt.dtype and got.shape == (BH, 1, d)
    np.testing.assert_allclose(_np(got), _np(ref_combine(m, l, acc)), **_tol(dtype))


SERVED_DECODE_GROUPS = {"qwen2.5-3b": 4 * 2, "qwen3-moe-30b-a3b": 4 * 4}


@pytest.mark.parametrize("arch", sorted(SERVED_DECODE_GROUPS))
@pytest.mark.parametrize("n,want", [(0, 1), (1, 1), (64, 1), (65, 2), (513, 8)])
def test_capped_split_rule_at_the_served_decode_shapes(arch, n, want):
    """The one-launch decode's splits form one cluster, so ``ops.flash_decode``
    caps the split rule at 8 on an H100 (132 SMs); the uncapped rule would
    give 9 at 513 keys.  The capped count changes nothing in the result."""
    groups = SERVED_DECODE_GROUPS[arch]
    got = FD.choose_splits(n, groups, 132, FD.MAX_CLUSTER_SPLITS)
    assert got == want <= FD.MAX_CLUSTER_SPLITS
    assert FD.choose_splits(n, groups, 132) == (9 if n == 513 else want)
    rng = np.random.default_rng(n)
    _, q = _pair(rng, (2 * 8, 1, 32), "float32")
    _, k = _pair(rng, (2, 545, 32), "float32")
    _, v = _pair(rng, (2, 545, 32), "float32")
    one = ops.flash_decode(q, k, v, kv_splits=1, kv_valid_len=n, q_per_kv=8)
    capped = ops.flash_decode(q, k, v, kv_splits=got, kv_valid_len=n, q_per_kv=8)
    np.testing.assert_allclose(_np(capped), _np(one), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_decode_footprints_fit_one_block(d):
    """The decode bodies' shared memory (mirrored from csrc/flash_decode.cu):
    bf16 holds 16 query rows, four warps' rings of two 16-key K and V
    chunks (rows padded by 16 bytes) and the split's float32 result; at d
    128 that is 82,304 bytes, two blocks an SM; at d 256 160,128, one.
    float32 holds one 128-key K and V tile (64-key at d 256, where 128 keys
    would take 282,752 bytes) and the result."""
    result = (32 + 16 * d) * 4
    tile = 128 if d <= 128 else 64
    assert FD.f32_tile(d) == tile
    assert FD.decode_smem_bytes(d, 2) == 16 * (d + 8) * 2 + 4 * 2 * 2 * 16 * (d + 8) * 2 + result
    assert FD.decode_smem_bytes(d, 4) == 2 * tile * (d + 4) * 4 + result
    assert max(FD.decode_smem_bytes(d, 2), FD.decode_smem_bytes(d, 4)) <= FA.MAX_SMEM
    if d == 128:
        assert FD.decode_smem_bytes(d, 2) == 82304
        assert 2 * (82304 + 1024) <= 228 * 1024
    if d == 256:
        assert (FD.decode_smem_bytes(d, 2), FD.decode_smem_bytes(d, 4)) == (160128, 149632)
        assert 2 * (160128 + 1024) > 228 * 1024
        assert 2 * 128 * (d + 4) * 4 + result == 282752 > FA.MAX_SMEM


# ------------------------------------------------------------ the wrappers
@pytest.mark.parametrize("n", [1, 7, 8, 96, 160, 545, 1024, 4096])
@pytest.mark.parametrize("desired", [1, 8, 128, 512])
def test_fit_block_equals_reference(n, desired):
    assert ops.fit_block(n, desired) == ref_ops.fit_block(n, desired)


def test_snap_tile_picks_compiled_sizes():
    assert G.snap_tile(128, G.TILE_M) == 128
    assert G.snap_tile(100, G.TILE_M) == 64
    assert G.snap_tile(32, G.TILE_M) == 64
    assert G.snap_tile(512, G.TILE_K) == 32


@pytest.mark.parametrize("es", [2, 4])
def test_smem_footprints_bound_the_tile_sets(es):
    """Every GEMM tile of the body that takes it at this element size fits
    that body's limit: the TMA body's bf16 tiles the 227 KB of dynamic
    shared memory, the staged body's the 48 KB of static shared memory; the
    flash tiles are pruned by the block limit (float32 d=128 loses the
    largest)."""
    tiles = G.COMPILED_TILES if es == 2 else G.STAGED_TILES
    assert all(G.gemm_smem_bytes(*t, es) <= G.smem_limit(t) for t in tiles)
    assert all(G.gemm_smem_bytes(*t, es) <= G.MAX_STATIC_SMEM for t in G.STAGED_TILES)
    legal = FA.legal_tiles(128, es)
    assert legal and all(FA.flash_smem_bytes(*t, 128, es) <= FA.MAX_SMEM for t in legal)
    assert ((128, 64) in legal) == (es == 2)


@pytest.mark.parametrize("tile", [(64, 64, 64), (64, 128, 64), (64, 256, 64),
                                  (128, 64, 64), (128, 128, 64), (128, 256, 64)])
def test_tma_tiles_take_the_deepest_ring_that_fits(tile):
    """The TMA body's footprint: 1 KB of alignment slack and STAGES stages of
    the A box (BM x 64), the B boxes (64 x BN) and two 8-byte mbarriers;
    STAGES is at least 3 and one more would not fit 232,448 bytes."""
    bm, bn, bk = tile
    assert tile in G.TMA_TILES and G.tile_body(tile) == "tma"
    stages = G.tma_stages(bm, bn)
    per_stage = (bm + bn) * 64 * 2 + 16
    assert stages >= 3
    assert G.gemm_smem_bytes(*tile, 2) == 1024 + stages * per_stage <= G.MAX_DYNAMIC_SMEM
    assert 1024 + (stages + 1) * per_stage > G.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("case", [
    (torch.bfloat16, 2048, 11008, (0, 0), "tma"),
    (torch.bfloat16, 768, 2048, (256, 4096), "tma"),
    (torch.bfloat16, 45, 64, (0, 0), "staged"),          # K % 8
    (torch.bfloat16, 64, 77, (0, 0), "staged"),          # N % 8
    (torch.bfloat16, 64, 64, (2, 0), "staged"),          # a's base 2 bytes off
    (torch.bfloat16, 64, 64, (0, 8), "staged"),          # b's base 8 bytes off
    (torch.float32, 2048, 11008, (0, 0), "staged"),
    (torch.float16, 64, 64, (0, 0), "staged")])
def test_gemm_body_selection(case):
    dtype, K, N, ptrs, body = case
    assert G.gemm_body(dtype, K, N, *ptrs) == body
    if ptrs == (0, 0):
        assert G.shape_body(dtype, K, N) == body


def test_nearest_tile_stays_in_the_body():
    assert G.nearest_tile((128, 128, 32), "tma") == (128, 128, 64)
    assert G.nearest_tile((128, 256, 64), "staged") == (128, 128, 32)
    assert G.nearest_tile((32, 512, 16), "tma") == (64, 256, 64)
    for body in G.BODIES:
        for t in G.COMPILED_TILES:
            assert G.nearest_tile(t, body) in G.body_tiles(body)
        for t in G.body_tiles(body):
            assert G.nearest_tile(t, body) == t


def test_grouped_wrapper_keeps_the_row_tile_at_cap_160():
    """The TMA body masks its own edges, so ``ops`` no longer cuts the row
    tile to a power-of-two divisor of the capacity (fit_block(160, 128) is
    32, which the staged body snaps to 64); the staged body keeps that rule."""
    assert ops.fit_block(160, 128) == 32
    for d_in, d_out in ((2048, 768), (768, 2048)):
        assert ops.gemm_launch_block(160, d_out, d_in, torch.bfloat16,
                                     (128, 128, 64)) == (128, 128, 64)
        assert ops.gemm_launch_block(160, d_out, d_in, torch.float32,
                                     (128, 128, 32)) == (64, 128, 32)
    assert ops.gemm_launch_block(8, 768, 2048, torch.bfloat16, (64, 256, 64)) == (64, 256, 64)
    assert ops.gemm_launch_block(64, 64, 45, torch.bfloat16, (128, 128, 64)) == (64, 64, 16)


def test_cpu_grouped_matmul_counts_no_body():
    from repro_torch import kernels
    from repro_torch.kernels import moe_gmm
    kernels.reset_launch_counts()
    x = torch.randn(2, 8, 16).to(torch.bfloat16)
    w = torch.randn(2, 16, 24).to(torch.bfloat16)
    got = ops.grouped_matmul(x, w, block=(128, 128, 64))
    torch.testing.assert_close(got.float(), moe_gmm.grouped_matmul_plain(x, w).float())
    assert kernels.launches_by_body() == {"gemm": {"tma": 0, "staged": 0},
                                          "grouped_matmul": {"tma": 0, "staged": 0},
                                          "flash_attention": {"tma": 0, "mma": 0, "f32": 0},
                                          "flash_attention_bwd": {"tma": 0, "mma": 0, "f32": 0},
                                          "flash_decode": {"tma": 0, "mma": 0, "f32": 0}}


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_bf16_flash_footprint_is_q_and_two_kv_stages(d):
    """bf16 keeps scores, probabilities and output in registers: a block
    holds the Q tile and two stages of K and V, and every compiled tile fits
    one block.  The mma.sync body pads rows by 16 bytes; the TMA body (d 256,
    aligned) keeps them unpadded under the 128-byte swizzle, with 1 KB for
    its alignment and seven 8-byte mbarriers."""
    for bq, bkv in FA.COMPILED_TILES:
        padded = (bq + 4 * bkv) * (d + 8) * 2
        assert FA.flash_smem_bytes(bq, bkv, d, 2, "mma") == padded
        want = 1024 + (bq + 4 * bkv) * d * 2 + 56 if d == 256 else padded
        assert FA.flash_smem_bytes(bq, bkv, d, 2) == want
        assert FA.flash_smem_bytes(bq, bkv, d, 2) <= FA.MAX_SMEM
    assert FA.legal_tiles(d, 2) == FA.COMPILED_TILES


def test_flash_footprints_at_d256():
    """Head dim 256 (gemma-7b): every bf16 tile fits one block on the TMA
    body ((64, 32) 99,384 bytes, two an SM; (128, 64) 197,688, one) as on the
    mma.sync body that unaligned calls take ((64, 32) 101,376; (128, 64)
    202,752), and in float32 only (64, 32) does (208,896 bytes), so the
    planner's candidates are exactly those."""
    got = {t: FA.flash_smem_bytes(*t, 256, 2) for t in FA.COMPILED_TILES}
    assert got == {(64, 32): 99384, (64, 64): 164920, (128, 32): 132152, (128, 64): 197688}
    assert [FA.tma_blocks_per_sm(*t) for t in FA.COMPILED_TILES] == [2, 1, 1, 1]
    old = {t: FA.flash_smem_bytes(*t, 256, 2, "mma") for t in FA.COMPILED_TILES}
    assert old == {(64, 32): 101376, (64, 64): 168960, (128, 32): 135168, (128, 64): 202752}
    assert FA.flash_smem_bytes(64, 32, 256, 4) == 208896
    assert FA.legal_tiles(256, 4) == ((64, 32),)
    assert 256 in FA.COMPILED_HEAD_DIMS


def test_served_bf16_flash_tile_fits_twice_on_an_sm():
    """The served tile (128, 64), d 128: Q 34,816 bytes plus two stages of K
    and V 69,632; two blocks (each with the 1 KB the runtime reserves) fit
    an H100 SM's 228 KB of shared memory."""
    served = FA.flash_smem_bytes(128, 64, 128, 2)
    assert served == 34816 + 69632
    assert 2 * (served + 1024) <= 228 * 1024


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        G.gemm(torch.zeros(4, 4, dtype=torch.float16), torch.zeros(4, 4, dtype=torch.float16))
    with pytest.raises(ValueError):
        G.gemm(torch.zeros(4, 5), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        FD.flash_decode_partials(torch.zeros(2, 2, 8), torch.zeros(2, 4, 8),
                                 torch.zeros(2, 4, 8))
    with pytest.raises(ValueError):
        ops.flash_decode(torch.zeros(2, 1, 8), torch.zeros(2, 4, 8), torch.zeros(2, 4, 8),
                         kv_valid_len=5)
    with pytest.raises(ValueError):
        ops.attention(torch.zeros(4, 8, 8), torch.zeros(3, 8, 8), torch.zeros(3, 8, 8),
                      block_q=64, block_kv=64, q_per_kv=2)


def test_cpu_tensors_never_count_as_launches():
    from repro_torch import kernels
    kernels.reset_launch_counts()
    ops.matmul(torch.randn(8, 8), torch.randn(8, 8), block=(64, 64, 16))
    ops.flash_decode(torch.randn(2, 1, 32), torch.randn(2, 9, 32), torch.randn(2, 9, 32))
    assert set(kernels.launch_counts().values()) == {0}


def test_launch_counts_carry_the_one_launch_decode():
    """``flash_decode`` counts the one-launch decode, beside the partials and
    combine counters, and a reset zeroes it."""
    from repro_torch import kernels
    assert {"flash_decode", "flash_decode_partials",
            "flash_decode_combine"} <= set(kernels.launch_counts())
    FD.launches = 3
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["flash_decode"] == 0 == FD.launches


# ------------------------------------------------------ backward (training)
# The reference cannot differentiate its Pallas kernels (jax.grad through
# ops.matmul / ops.attention / ops.grouped_matmul raises), so the oracle of
# every gradient here is jax.grad of the kernel's ref.py function.
import jax  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as FAB  # noqa: E402
from repro_torch.kernels import moe_gmm  # noqa: E402


def _attention_grads_ref(qj, kj, vj, dj, g, causal):
    """jax.grad of <attention_ref(q, repeat(k), repeat(v)), dout>: the
    query heads of a group share (and sum into) one kv head."""
    def f(q, k, v):
        out = jref.attention_ref(q, jnp.repeat(k, g, axis=0), jnp.repeat(v, g, axis=0),
                                 causal=causal)
        return jnp.sum(out.astype(jnp.float32) * dj.astype(jnp.float32))
    return jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)


ATTN_BWD_CASES = [
    # BH, q_per_kv, Sq, Skv, d, causal
    (4, 1, 64, 64, 32, True),          # no grouping
    (14, 7, 48, 48, 64, True),         # internvl2's 7 query heads a kv head
    (16, 8, 64, 64, 32, True),         # qwen2.5-3b's 8
    (16, 8, 40, 72, 32, False),        # Sq != Skv, not causal (cross-attention)
    (4, 2, 72, 40, 32, True),          # Sq > Skv, causal by absolute position
    (2, 1, 37, 53, 64, True),          # ragged: no tile divides either length
    (6, 3, 100, 100, 32, False),       # ragged, not causal
    (4, 1, 48, 48, 256, True),         # gemma-7b's head dim 256, MHA
    (4, 2, 40, 72, 256, False),        # d 256, grouped, Sq != Skv
]


@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_attention_bwd_plain_matches_jax_grad_of_reference(case):
    BH, g, Sq, Skv, d, causal = case
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng, (BH, Sq, d), "float32")
    kj, kt = _pair(rng, (BH // g, Skv, d), "float32")
    vj, vt = _pair(rng, (BH // g, Skv, d), "float32")
    dj, dt = _pair(rng, (BH, Sq, d), "float32")
    want = _attention_grads_ref(qj, kj, vj, dj, g, causal)
    out, lse = FA.flash_attention_plain(qt, kt, vt, causal=causal, q_per_kv=g,
                                        return_lse=True)
    got = FAB.flash_attention_bwd(qt, kt, vt, out, lse, dt, causal=causal, q_per_kv=g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == tuple(b.shape), name
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_gradient_through_strided_kv_matches_reference(dtype, causal):
    """``ops.attention`` is an autograd Function: k/v as the (B, Hkv, T, d)
    view of a (B, T, Hkv, d) projection, as the layers hand them over."""
    B, H, Hkv, S, d = 2, 8, 2, 48, 32
    g = H // Hkv
    rng = np.random.default_rng(12)
    qj, qt = _pair(rng, (B * H, S, d), dtype)
    kj, kt = _pair(rng, (B, S, Hkv, d), dtype)
    vj, vt = _pair(rng, (B, S, Hkv, d), dtype)
    dj, dt = _pair(rng, (B * H, S, d), dtype)
    to3 = lambda x: jnp.transpose(x, (0, 2, 1, 3)).reshape(B * Hkv, S, d)
    want = _attention_grads_ref(qj, to3(kj), to3(vj), dj, g, causal)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    q, k, v = leaves
    out = ops.attention(q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), causal=causal,
                        q_per_kv=g)
    got = torch.autograd.grad(out, leaves, dt)
    back = lambda t: t.permute(0, 2, 1, 3).reshape(B * Hkv, S, d)
    for name, a, b in zip(("dq", "dk", "dv"), (got[0], back(got[1]), back(got[2])), want):
        assert a.dtype == qt.dtype
        np.testing.assert_allclose(_np(a), _np(b), **_tol(dtype), err_msg=name)


def test_attention_bwd_row_with_every_key_masked_has_zero_gradient():
    """A row whose scores all fall at or below the -1e30 sentinel is a fully
    masked row to the forward (output 0, log-sum-exp +1e30).  Its gradient
    is 0 and nothing is NaN; the rest is the gradient of the forward's own
    function (autograd through the plain forward).  The reference's
    ``attention_ref`` masks with -inf and has no such row, so it is not the
    oracle here."""
    BH, S, d = 2, 16, 32
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(BH, S, d, generator=gen)
    k = torch.randn(BH, S, d, generator=gen)
    v = torch.randn(BH, S, d, generator=gen)
    dout = torch.randn(BH, S, d, generator=gen)
    q[:, :, 0] = 0.0
    k[:, :, 0] = 1e16
    q[:, 5, 0] = -1e16                  # row 5: every score about -1e32 * scale
    out, lse = FA.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    assert torch.all(out[:, 5] == 0) and torch.all(lse[:, 5] == FA.LSE_MASKED)
    dq, dk, dv = FAB.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert torch.all(dq[:, 5] == 0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(FA.flash_attention_plain(*leaves, causal=True), leaves, dout)
    # dq[..., 0] is 1e16 * scale * sum_j dS_ij, a sum that is 0 up to rounding:
    # both sides are finite there, and compared everywhere else
    torch.testing.assert_close(dq[..., 1:], want[0][..., 1:], rtol=1e-4, atol=1e-4)
    for a, b in zip((dk, dv), want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(96, 64, 160), (128, 256, 128)])
def test_matmul_gradient_matches_jax_grad_of_reference(dtype, shape):
    M, N, K = shape
    rng = np.random.default_rng(13)
    aj, at = _pair(rng, (M, K), dtype)
    bj, bt = _pair(rng, (K, N), dtype)
    cj, ct = _pair(rng, (M, N), dtype)
    want = jax.grad(lambda a, b: jnp.sum(jref.gemm_ref(a, b).astype(jnp.float32)
                                         * cj.astype(jnp.float32)), argnums=(0, 1))(aj, bj)
    a, b = at.clone().requires_grad_(), bt.clone().requires_grad_()
    got = torch.autograd.grad(ops.matmul(a, b), (a, b), ct)
    for x, y in zip(got, want):
        assert x.dtype == at.dtype
        np.testing.assert_allclose(_np(x), _np(y), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_gradient_matches_jax_grad_of_reference(dtype):
    E, cap, d_in, d_out = 4, 24, 64, 96
    rng = np.random.default_rng(14)
    xj, xt = _pair(rng, (E, cap, d_in), dtype)
    wj, wt = _pair(rng, (E, d_in, d_out), dtype)
    yj, yt = _pair(rng, (E, cap, d_out), dtype)
    want = jax.grad(lambda x, w: jnp.sum(jref.grouped_matmul_ref(x, w).astype(jnp.float32)
                                         * yj.astype(jnp.float32)), argnums=(0, 1))(xj, wj)
    x, w = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    before = moe_gmm.launches
    got = torch.autograd.grad(ops.grouped_matmul(x, w), (x, w), yt)
    assert moe_gmm.launches == before            # the CPU runs the plain versions
    for a, b in zip(got, want):
        assert a.dtype == xt.dtype
        np.testing.assert_allclose(_np(a), _np(b), **_tol(dtype))


def test_serving_attention_records_nothing_and_keeps_no_lse():
    """Under ``torch.no_grad`` (the serving path) ``ops.attention`` is the
    plain forward call: no autograd node, no log-sum-exp."""
    q, k, v = (torch.randn(4, 32, 32, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        out = ops.attention(q, k, v, causal=True)
    assert out.grad_fn is None and isinstance(out, torch.Tensor)
    out = ops.attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
