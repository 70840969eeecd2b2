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
    """Every GEMM tile fits the kernel's static shared memory; the flash
    tiles are pruned by the block limit (float32 d=128 loses the largest)."""
    assert all(G.gemm_smem_bytes(*t, es) <= G.MAX_STATIC_SMEM for t in G.COMPILED_TILES)
    legal = FA.legal_tiles(128, es)
    assert legal and all(FA.flash_smem_bytes(*t, 128, es) <= FA.MAX_SMEM for t in legal)
    assert ((128, 64) in legal) == (es == 2)


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
