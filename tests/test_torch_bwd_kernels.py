"""The backward kernels' geometry and operand hand-over, on the CPU.

K2-bwd's bf16 launches (``flash_attention_bwd.bwd_geometry``: grids,
cluster, shared memory) are a Python mirror of ``csrc/flash_attention_bwd.cu``
(``tests/test_torch_gpu.py`` holds the mirror against the compiled
library); here they are held to filling the card at the training shapes.
K4-bwd hands the forward's operands to the grouped GEMM as transposed views,
which the TMA body reads as they are stored: the hand-over is recorded, and
the gradient is held against ``jax.grad`` of the reference's
``grouped_matmul_ref`` (float32 1e-4, bfloat16 2e-2, the tolerances of
tests/test_kernels.py).  K1-bwd does the same with ``.t()`` views of the
forward's 2-D operands (``gemm.operand_layouts``), held against ``jax.grad``
of ``gemm_ref``."""
import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.lower_torch import H100_SMS
from repro_torch.kernels import flash_attention_bwd as FAB
from repro_torch.kernels import gemm as G
from repro_torch.kernels import moe_gmm, ops

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    return x.detach().float().numpy()


def _makespan(work, slots):
    """Finish time of blocks handed, in launch order, to the first free of
    ``slots`` block slots."""
    free = [0] * slots
    for w in work:
        heapq.heappush(free, heapq.heappop(free) + w)
    return max(free)


# ------------------------------------------------------------------- K2-bwd
# (BH, Sq, Skv, d, q_per_kv): qwen2.5-3b's and the MoE's training passes
# (4 sequences), zamba2's (G 1, d 64) and internvl2's (G 7, 768 positions)
TRAINING_PASSES = [(64, 512, 512, 128, 8), (128, 512, 512, 128, 8),
                   (128, 512, 512, 64, 1), (56, 768, 768, 64, 7)]


@pytest.mark.parametrize("shape", TRAINING_PASSES)
def test_flash_bwd_grids_fill_the_card_evenly(shape):
    """Each bf16 launch has at least a wave of blocks for the H100's 132
    SMs, two blocks an SM, and launched heaviest first the last block ends
    within 10 % of an even split of the work; the dK/dV launch's clusters
    are whole kv-head groups.  The float32 body's dK/dV grid (one block per
    kv head and 32-key tile, looping over the group) did not: 128 blocks at
    qwen2.5-3b's shape, the first 16x the last one's work."""
    BH, Sq, Skv, d, g = shape
    geo = FAB.bwd_geometry(BH, Sq, Skv, d, g, causal=True)
    for launch in ("dq", "dkv"):
        info = geo[launch]
        slots = H100_SMS * info["blocks_per_sm"]
        assert info["blocks_per_sm"] == 2
        assert info["grid"][0] * info["grid"][1] == len(info["work"]) >= slots
        ideal = sum(info["work"]) / slots
        assert _makespan(info["work"], slots) <= 1.1 * max(ideal, max(info["work"]))
    dkv = geo["dkv"]
    assert dkv["cluster"] * dkv["heads_per_block"] == g
    assert dkv["grid"][0] % dkv["cluster"] == 0
    assert dkv["work"][0] == max(dkv["work"])          # the first key tile sees most queries
    assert sum(geo["dq"]["work"]) == sum(dkv["work"])  # both walk every visible tile pair


@pytest.mark.parametrize("g,cluster", [(1, 1), (3, 3), (4, 4), (7, 7), (8, 8), (12, 6),
                                       (16, 8), (11, 1)])
def test_flash_bwd_cluster_is_the_largest_divisor_up_to_eight(g, cluster):
    assert FAB.bwd_cluster(g) == cluster
    geo = FAB.bwd_geometry(2 * g, 100, 77, 64, g, causal=True)
    assert geo["dkv"]["grid"] == (2 * cluster, 2)
    assert geo["dkv"]["heads_per_block"] * cluster == g


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bwd_blocks_fit_two_an_sm(d):
    """The bf16 blocks take at most half an SM's shared memory (less the
    1 KB kept per block); the float32 body's footprints are the first
    kernel's (149 KB and 116 KB at d 128)."""
    for kernel in ("dq", "dkv"):
        assert FAB.bwd_smem_bytes(d, kernel, 2) <= FAB.SM_SMEM // 2 - 1024
    assert FAB.bwd_smem_bytes(128, "dq", 4) == 149248
    assert FAB.bwd_smem_bytes(128, "dkv", 4) == 116480


def test_flash_bwd_blocks_at_d256_fit_one_an_sm():
    """Head dim 256: a block of the TMA body (aligned bf16) takes about
    195-225 KB, so one block an SM: the dQ block 128 rows of Q and dO and two
    ring stages of 32 keys of K and V (its delta is summed in registers); the dK/dV block
    64 rows of K and V, two ring stages of 64 rows of Q and dO and two 8 KB
    bf16 tiles each of P^T and dS^T.  No third grid axis, no cluster.  The
    mma.sync body (unaligned calls) keeps its 202,752 / 203,776 bytes and its
    two column parts over the grid; float32's dQ block takes 32 query rows so
    that it fits (64 rows would take 280,320 bytes)."""
    assert FAB.bwd_smem_bytes(256, "dq", 2) == 1024 + 2 * 65536 + 4 * 16384 + 40 == 197672
    assert FAB.bwd_smem_bytes(256, "dkv", 2) == 1024 + 6 * 32768 + 4 * 8192 + 40 == 230440
    assert FAB.bwd_smem_bytes(256, "dq", 2, "mma") == 202752
    assert FAB.bwd_smem_bytes(256, "dkv", 2, "mma") == 203776
    assert FAB.bwd_smem_bytes(256, "dq", 4) == 205952
    assert FAB.bwd_smem_bytes(256, "dkv", 4) == 214784
    for kernel in ("dq", "dkv"):
        for es, body in ((2, None), (2, "mma"), (4, None)):
            assert FAB.SM_SMEM // 2 - 1024 < FAB.bwd_smem_bytes(256, kernel, es, body) <= 232448
    assert FAB.bwd_column_splits(256) == 1
    assert FAB.bwd_column_splits(256, "mma") == 2
    assert [FAB.bwd_column_splits(d) for d in (32, 64, 128)] == [1, 1, 1]
    # gemma-7b's training pass: 64 heads (G 1), 512 x 512 causal
    geo = FAB.bwd_geometry(64, 512, 512, 256, 1, causal=True)
    for launch in ("dq", "dkv"):
        info = geo[launch]
        assert info["blocks_per_sm"] == 1 and info["cluster"] == 1
        assert info["grid"][0] * info["grid"][1] == len(info["work"]) >= H100_SMS
    assert geo["dq"]["grid"] == (64, 4) and geo["dkv"]["grid"] == (64, 8)
    assert sum(geo["dq"]["work"]) == sum(geo["dkv"]["work"]) == 64 * 36
    old = FAB.bwd_geometry(64, 512, 512, 256, 1, causal=True, body="mma")
    assert old["dq"]["grid"] == (64, 8, 2) and old["dkv"]["grid"] == (64, 8, 2)
    assert sum(old["dq"]["work"]) == 2 * sum(geo["dq"]["work"])
    # a group of 16 (two heads a cluster block on the mma.sync body): one TMA
    # block per (kv head, key tile) walks all 16 heads
    grouped = FAB.bwd_geometry(32, 130, 160, 256, 16, causal=True)["dkv"]
    assert grouped["grid"] == (2, 3) and grouped["heads_per_block"] == 16
    assert grouped["work"][0] == 16 * 3


def test_flash_bwd_geometry_of_a_causal_pass_with_more_keys_than_queries():
    """Keys past the last query see none under the causal mask: their
    blocks do no work (the kernel writes zero gradients there)."""
    geo = FAB.bwd_geometry(8, 100, 300, 64, 4, causal=True)
    assert geo["dkv"]["grid"] == (8, 5)
    per_tile = [geo["dkv"]["work"][i * 8] for i in range(5)]
    assert per_tile == [2, 1, 0, 0, 0]
    assert FAB.bwd_geometry(8, 100, 300, 64, 4, causal=False)["dkv"]["work"][-1] == 2


# ------------------------------------------------------------------- K4-bwd
def test_grouped_matmul_backward_reads_the_forward_operands_in_place(monkeypatch):
    """The backward hands ``moe_gmm.grouped_matmul`` the saved ``w`` and
    ``x`` as transposed views of their own storage (no copy), and the TMA
    body takes both as they lie: dX with B stored (E, d_out, d_in), dW with
    A stored (E, d_in, cap)."""
    x = torch.randn(4, 24, 96, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(4, 96, 160, dtype=torch.bfloat16, requires_grad=True)
    dy = torch.randn(4, 24, 160, dtype=torch.bfloat16)
    calls, real = [], moe_gmm.grouped_matmul

    def recording(a, b, **kw):
        calls.append((a, b))
        return real(a, b, **kw)

    out = ops.grouped_matmul(x, w)
    monkeypatch.setattr(moe_gmm, "grouped_matmul", recording)
    torch.autograd.grad(out, (x, w), dy)
    (dx_a, dx_b), (dw_a, dw_b) = calls
    assert dx_b.data_ptr() == w.data_ptr() and dx_b.stride() == (96 * 160, 1, 160)
    assert dw_a.data_ptr() == x.data_ptr() and dw_a.stride() == (24 * 96, 1, 96)
    assert dx_a.is_contiguous() and dw_b.is_contiguous()
    assert moe_gmm.operand_layouts(dx_a, dx_b) == (False, True)
    assert moe_gmm.operand_layouts(dw_a, dw_b) == (True, False)
    assert moe_gmm.grouped_body(dx_a, dx_b) == moe_gmm.grouped_body(dw_a, dw_b) == "tma"


def test_grouped_body_follows_dtype_shape_layout_and_alignment():
    x = torch.zeros(2, 24, 96, dtype=torch.bfloat16)
    w = torch.zeros(2, 96, 160, dtype=torch.bfloat16)
    assert moe_gmm.grouped_body(x, w) == "tma"
    assert moe_gmm.grouped_body(x.float(), w.float()) == "staged"
    xt = torch.zeros(2, 96, 20, dtype=torch.bfloat16).transpose(1, 2)   # cap 20 as stored rows
    assert moe_gmm.grouped_body(xt, w) == "staged"
    wt = torch.zeros(2, 160, 96, dtype=torch.bfloat16).transpose(1, 2)
    both = torch.zeros(2, 96, 24, dtype=torch.bfloat16).transpose(1, 2)
    assert moe_gmm.grouped_body(x, wt) == "tma"
    assert moe_gmm.grouped_body(both, wt) == "staged"   # one transposed operand at most
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.operand_layouts(x[:, ::2], w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 24, 96, 160), (2, 160, 64, 96)])
def test_grouped_matmul_backward_matches_jax_grad_at_ragged_caps(shape, dtype):
    """K4-bwd through ``ops.grouped_matmul`` (its plain version on the CPU)
    against ``jax.grad`` of the reference's ``grouped_matmul_ref``, at a
    ragged cap of 24 with d_in 96 (neither a multiple of 64) and at the
    MoE's prefill cap of 160."""
    E, cap, d_in, d_out = shape
    rng = np.random.default_rng(cap + d_in)
    xj, xt = _pair(rng, (E, cap, d_in), dtype)
    wj, wt = _pair(rng, (E, d_in, d_out), dtype)
    yj, yt = _pair(rng, (E, cap, d_out), dtype)
    want = jax.grad(lambda x, w: jnp.sum(jref.grouped_matmul_ref(x, w).astype(jnp.float32)
                                         * yj.astype(jnp.float32)), argnums=(0, 1))(xj, wj)
    x, w = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    got = torch.autograd.grad(ops.grouped_matmul(x, w), (x, w), yt)
    for a, b in zip(got, want):
        assert a.dtype == xt.dtype
        np.testing.assert_allclose(_np(a), np.asarray(b.astype(jnp.float32)), **_tol(dtype))


@pytest.mark.parametrize("tile", G.TMA_TILES)
def test_short_k_ring_lets_two_blocks_share_an_sm(tile):
    """At K = 160 (three k-steps: dW at the MoE's prefill) every tile whose
    two-block ring holds three stages takes the short-K ring, whose
    footprint lets two blocks share an SM ((64, 256) holds two, (128, 256)
    has none); at K = 2048 every tile keeps its deep ring, as before."""
    bm, bn, bk = tile
    short = G.gemm_smem_bytes(bm, bn, bk, 2, K=160)
    deep = G.gemm_smem_bytes(bm, bn, bk, 2)
    assert G.gemm_smem_bytes(bm, bn, bk, 2, K=2048) == deep <= G.MAX_DYNAMIC_SMEM
    assert not G.tma_shallow(bm, bn, 2048)
    if bn == 256:
        assert not G.tma_shallow(bm, bn, 160) and short == deep
    else:
        assert G.tma_shallow(bm, bn, 160)
        assert short == 1024 + 3 * ((bm + bn) * 64 * 2 + 16) <= G.SM_SMEM // 2 - 1024


# ------------------------------------------------------------------- K1-bwd
def test_matmul_backward_reads_the_forward_operands_in_place(monkeypatch):
    """The backward hands ``gemm.gemm`` the saved ``b`` and ``a`` as ``.t()``
    views of their own storage (no copy), and the TMA body takes both as
    they lie: dA = dC B^T with B stored (N, K), dB = A^T dC with A stored
    (K, M)."""
    a = torch.randn(96, 160, dtype=torch.bfloat16, requires_grad=True)
    b = torch.randn(160, 64, dtype=torch.bfloat16, requires_grad=True)
    dc = torch.randn(96, 64, dtype=torch.bfloat16)
    calls, real = [], G.gemm

    def recording(x, y, **kw):
        calls.append((x, y))
        return real(x, y, **kw)

    out = ops.matmul(a, b)
    monkeypatch.setattr(G, "gemm", recording)
    torch.autograd.grad(out, (a, b), dc)
    (da_a, da_b), (db_a, db_b) = calls
    assert da_b.data_ptr() == b.data_ptr() and da_b.shape == (64, 160) \
        and da_b.stride() == (1, 64)
    assert db_a.data_ptr() == a.data_ptr() and db_a.shape == (160, 96) \
        and db_a.stride() == (1, 160)
    assert da_a.is_contiguous() and db_b.is_contiguous()
    assert G.operand_layouts(da_a, da_b) == (False, True)
    assert G.operand_layouts(db_a, db_b) == (True, False)
    assert G.operand_body(da_a, da_b) == G.operand_body(db_a, db_b) == "tma"


def _stored(shape, transposed, dtype=torch.bfloat16, offset=0):
    """A 2-D operand of logical ``shape``: row-major, or the ``.t()`` of a
    row-major tensor; ``offset`` elements into its storage."""
    rows, cols = shape[::-1] if transposed else shape
    t = torch.zeros(offset + rows * cols, dtype=dtype)[offset:].view(rows, cols)
    return t.t() if transposed else t


@pytest.mark.parametrize("case", [
    # (M, K, N, a_t, b_t, dtype, a's offset, body)
    (96, 160, 64, False, False, torch.bfloat16, 0, "tma"),
    (96, 160, 64, True, False, torch.bfloat16, 0, "tma"),     # dB = A^T dC
    (96, 160, 64, False, True, torch.bfloat16, 0, "tma"),     # dA = dC B^T
    (2048, 2048, 11008, True, False, torch.bfloat16, 0, "tma"),
    (2048, 11008, 2048, False, True, torch.bfloat16, 0, "tma"),
    (100, 160, 64, True, False, torch.bfloat16, 0, "staged"),  # A's rows as stored: M % 8
    (100, 160, 64, False, True, torch.bfloat16, 0, "tma"),     # B's rows are K: fine
    (96, 160, 64, True, True, torch.bfloat16, 0, "staged"),   # one transposed operand at most
    (96, 160, 64, True, False, torch.bfloat16, 8, "tma"),     # 16 bytes in: aligned
    (96, 160, 64, True, False, torch.bfloat16, 1, "staged"),  # 2 bytes off
    (96, 164, 64, False, True, torch.bfloat16, 0, "staged"),  # K % 8
    (96, 160, 64, True, False, torch.float32, 0, "staged")])
def test_gemm_operand_layout_rule(case):
    """Which 2-D layouts go to which body: the TMA body reads a transposed
    operand as stored when its rows as stored are whole 16-byte pieces at an
    aligned base, and at most one operand is transposed; everything else
    runs the staged body (which copies a transposed operand first)."""
    M, K, N, a_t, b_t, dtype, offset, body = case
    a = _stored((M, K), a_t, dtype, offset)
    b = _stored((K, N), b_t, dtype)
    assert a.shape == (M, K) and b.shape == (K, N)
    assert G.operand_layouts(a, b) == (a_t, b_t)
    assert G.operand_body(a, b) == body
    assert G.gemm_body(dtype, K, N, a.data_ptr(), b.data_ptr(), M=M, a_t=a_t,
                       b_t=b_t) == body


def test_gemm_refuses_other_strides():
    """A slice with a row step, or a column-sliced view, is neither
    row-major nor the ``.t()`` of a row-major tensor: ``gemm`` raises
    before any body is chosen, on the CPU as on the card."""
    a = torch.zeros(64, 64, dtype=torch.bfloat16)
    b = torch.zeros(64, 32, dtype=torch.bfloat16)
    for bad_a, bad_b in ((a[::2], b), (a, torch.zeros(64, 64, dtype=torch.bfloat16)[:, :32]),
                         (torch.zeros(64, 128, dtype=torch.bfloat16)[:, ::2], b)):
        with pytest.raises(ValueError, match="transposes of contiguous ones"):
            G.gemm(bad_a, bad_b)
        with pytest.raises(ValueError, match="transposes of contiguous ones"):
            G.operand_layouts(bad_a, bad_b)
    assert G.gemm(a.t().contiguous().t(), b).shape == (64, 32)     # a .t() view is fine


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["row-major", "a transposed", "b transposed"])
def test_matmul_backward_matches_jax_grad_with_transposed_operands(layout, dtype):
    """K1-bwd through ``ops.matmul`` (its plain version on the CPU) against
    ``jax.grad`` of the reference's ``gemm_ref``, at a ragged shape (M 100,
    K 72, N 40), with the forward's operands row-major or one of them a
    ``.t()`` view: the backward then hands a row-major operand to the
    product that reads the transposed one's storage."""
    M, K, N = 100, 72, 40
    rng = np.random.default_rng(M + K + N)
    aj, at = _pair(rng, (M, K), dtype)
    bj, bt = _pair(rng, (K, N), dtype)
    cj, ct = _pair(rng, (M, N), dtype)
    want = jax.grad(lambda a, b: jnp.sum(jref.gemm_ref(a, b).astype(jnp.float32)
                                         * cj.astype(jnp.float32)), argnums=(0, 1))(aj, bj)
    a = (at.t().contiguous().t() if layout == "a transposed" else at.clone()).requires_grad_()
    b = (bt.t().contiguous().t() if layout == "b transposed" else bt.clone()).requires_grad_()
    assert G.operand_layouts(a, b) == (layout == "a transposed", layout == "b transposed")
    got = torch.autograd.grad(ops.matmul(a, b), (a, b), ct)
    for x, y in zip(got, want):
        assert x.dtype == at.dtype
        np.testing.assert_allclose(_np(x), np.asarray(y.astype(jnp.float32)), **_tol(dtype))
