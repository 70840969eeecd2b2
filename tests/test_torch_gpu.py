"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no interpret
mode); elsewhere they skip.  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
``chip_smoke.py`` makes the same comparisons at the serving shapes."""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384), (512, 256, 256),
                                   (96, 64, 160), (100, 77, 33)])
def test_gemm_kernel_every_tile(cuda, shape, dtype):
    from repro_torch.kernels import gemm as G
    M, N, K = shape
    a = torch.randn(M, K, device=cuda).to(dtype)
    b = torch.randn(K, N, device=cuda).to(dtype)
    want = G.gemm_plain(a, b, out_dtype=torch.float32)
    before = G.launches
    for tile in G.COMPILED_TILES:
        got = G.gemm(a, b, block=tile, out_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **_tol(dtype))
    assert G.launches == before + len(G.COMPILED_TILES)


@pytest.mark.parametrize("shape", [(96, 64, 160), (256, 128, 384), (128, 128, 96),
                                   (200, 136, 160), (8, 2048, 768), (2048, 11008, 2048)])
def test_gemm_tma_body_every_tile(cuda, shape):
    """The TMA + wgmma body at each of its tiles against the plain version:
    ragged M and N, K tails that 64 does not divide (96, 160), the MoE's
    decode rows and the served K1 shape; both output types."""
    from repro_torch.kernels import gemm as G
    M, N, K = shape
    gen = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = (torch.randn(M, K, generator=gen, device=cuda) * K ** -0.5).to(torch.bfloat16)
    b = torch.randn(K, N, generator=gen, device=cuda).to(torch.bfloat16)
    assert G.gemm_body(a.dtype, K, N, a.data_ptr(), b.data_ptr()) == "tma"
    want = G.gemm_plain(a, b, out_dtype=torch.float32)
    before = G.launches_by_body["tma"]
    for tile in G.TMA_TILES:
        for out_dtype in (torch.float32, torch.bfloat16):
            got = G.gemm_on_body(a, b, "tma", block=tile, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype
            torch.testing.assert_close(got.float(), want, **_tol(out_dtype))
    assert G.launches_by_body["tma"] == before + 2 * len(G.TMA_TILES)


@pytest.mark.parametrize("shape", [(96, 64, 160), (256, 128, 384), (100, 77, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_staged_body_every_tile(cuda, shape, dtype):
    """The staged body at each of its tiles, aligned bf16 (its cp.async
    path) included, as a caller that compares the two bodies runs it."""
    from repro_torch.kernels import gemm as G
    M, N, K = shape
    a = torch.randn(M, K, device=cuda).to(dtype)
    b = torch.randn(K, N, device=cuda).to(dtype)
    want = G.gemm_plain(a, b, out_dtype=torch.float32)
    before = G.launches_by_body["staged"]
    for tile in G.STAGED_TILES:
        got = G.gemm_on_body(a, b, "staged", block=tile, out_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **_tol(dtype))
    assert G.launches_by_body["staged"] == before + len(G.STAGED_TILES)


def test_gemm_body_follows_dtype_shape_and_alignment(cuda):
    """(100, 77, 33) and float32 take the staged body; a bf16 operand whose
    base is 2 bytes off 16-byte alignment, at a shape the planner sizes for
    the TMA body, runs the staged body at its nearest tile, and is right."""
    from repro_torch.kernels import gemm as G, ops
    a = torch.randn(100, 33, device=cuda).to(torch.bfloat16)
    b = torch.randn(33, 77, device=cuda).to(torch.bfloat16)
    before = dict(G.launches_by_body)
    torch.testing.assert_close(ops.matmul(a, b, out_dtype=torch.float32),
                               G.gemm_plain(a, b, out_dtype=torch.float32), rtol=2e-2, atol=2e-2)
    assert G.launches_by_body == dict(before, staged=before["staged"] + 1)
    buf = torch.randn(1 + 256 * 128, device=cuda).to(torch.bfloat16)
    a = buf[1:].view(256, 128)
    b = torch.randn(128, 192, device=cuda).to(torch.bfloat16)
    assert a.data_ptr() % 16 == 2
    assert G.gemm_body(a.dtype, 128, 192, a.data_ptr(), b.data_ptr()) == "staged"
    block = ops.gemm_launch_block(256, 192, 128, a.dtype, (128, 256, 64))
    assert block == (128, 256, 64)
    before = dict(G.launches_by_body)
    got = G.gemm(a, b, block=block, out_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, G.gemm_plain(a, b, out_dtype=torch.float32),
                               rtol=2e-2, atol=2e-2)
    assert G.launches_by_body == dict(before, staged=before["staged"] + 1)
    with pytest.raises(ValueError, match="TMA body"):
        G.gemm_on_body(a, b, "tma", block=block)
    x = torch.randn(64, 64, device=cuda)
    before = dict(G.launches_by_body)
    G.gemm(x, x, block=(128, 128, 64))
    torch.cuda.synchronize()
    assert G.launches_by_body == dict(before, staged=before["staged"] + 1)


@pytest.mark.parametrize("cap", [8, 13, 160])
@pytest.mark.parametrize("dims", [(2048, 768), (768, 2048)])
def test_grouped_gemm_tma_body_at_the_moe_shapes(cuda, cap, dims):
    """K4's TMA body with 128 experts at the decode capacity 8, a ragged 13
    (boxes of 64 or 128 rows, taller than each expert's rows) and the
    prefill capacity 160, every tile, both output types; each expert's
    zero-fill stops at its own rows."""
    from repro_torch.kernels import gemm as G, moe_gmm
    d_in, d_out = dims
    gen = torch.Generator(device=cuda).manual_seed(cap + d_in)
    x = torch.randn(128, cap, d_in, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn(128, d_in, d_out, generator=gen, device=cuda) * d_in ** -0.5
         ).to(torch.bfloat16)
    want = moe_gmm.grouped_matmul_plain(x, w, out_dtype=torch.float32)
    before = moe_gmm.launches_by_body["tma"]
    for tile in G.TMA_TILES:
        for out_dtype in (torch.float32, torch.bfloat16):
            got = moe_gmm.grouped_matmul(x, w, block=tile, out_dtype=out_dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want, **_tol(out_dtype))
    assert moe_gmm.launches_by_body["tma"] == before + 2 * len(G.TMA_TILES)


@pytest.mark.parametrize("layout", ["a_t", "b_t"])
@pytest.mark.parametrize("K", [24, 160, 768])
def test_grouped_gemm_tma_body_reads_transposed_operands(cuda, layout, K):
    """The TMA body with A stored (E, K, M) (``x`` handed over as a
    transposed view: the transpose-A descriptors) or B stored (E, N, K)
    (``w`` transposed: K-major B), every tile, at depths that take the
    short-K ring (24, 160) and the deep ring (768), against the plain
    product; no operand is copied (the launch reads the views' storage)."""
    from repro_torch.kernels import gemm as G, moe_gmm
    gen = torch.Generator(device=cuda).manual_seed(K)
    E, M, N = 6, 136, 200
    x = torch.randn(E, M, K, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn(E, K, N, generator=gen, device=cuda) * K ** -0.5).to(torch.bfloat16)
    if layout == "a_t":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    assert moe_gmm.operand_layouts(x, w) == (layout == "a_t", layout == "b_t")
    want = moe_gmm.grouped_matmul_plain(x, w, out_dtype=torch.float32)
    before = moe_gmm.launches_by_body["tma"]
    for tile in G.TMA_TILES:
        got = moe_gmm.grouped_matmul(x, w, block=tile, out_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **_tol(torch.bfloat16))
    assert moe_gmm.launches_by_body["tma"] == before + len(G.TMA_TILES)


@pytest.mark.parametrize("layout", ["a_t", "b_t"])
@pytest.mark.parametrize("K", [24, 160, 768])
def test_gemm_tma_body_reads_transposed_operands(cuda, layout, K):
    """K1's TMA body with A stored (K, M) (``a`` handed over as ``.t()`` of a
    contiguous tensor: the transpose-A descriptors) or B stored (N, K)
    (``b`` transposed: K-major B), every tile, both output types, at ragged
    M (136) and N (200) and at depths that take the short-K ring (24, 160)
    and the deep ring (768), against the plain product; no operand is
    copied (the launch reads the views' storage).  The staged body takes
    the same views (float32), and a transposed A whose rows as stored are
    not 16-byte pieces (M 100)."""
    from repro_torch.kernels import gemm as G
    gen = torch.Generator(device=cuda).manual_seed(K)
    M, N = 136, 200
    a = (torch.randn(M, K, generator=gen, device=cuda) * K ** -0.5).to(torch.bfloat16)
    b = torch.randn(K, N, generator=gen, device=cuda).to(torch.bfloat16)
    if layout == "a_t":
        a = a.t().contiguous().t()
    else:
        b = b.t().contiguous().t()
    assert G.operand_layouts(a, b) == (layout == "a_t", layout == "b_t")
    assert G.operand_body(a, b) == "tma"
    want = G.gemm_plain(a, b, out_dtype=torch.float32)
    before = G.launches_by_body["tma"]
    for tile in G.TMA_TILES:
        for out_dtype in (torch.float32, torch.bfloat16):
            got = G.gemm(a, b, block=tile, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype
            torch.testing.assert_close(got.float(), want, **_tol(out_dtype))
    assert G.launches_by_body["tma"] == before + 2 * len(G.TMA_TILES)
    before = dict(G.launches_by_body)
    af, bf = a.float(), b.float()
    af, bf = (af.t().contiguous().t(), bf) if layout == "a_t" else (af, bf.t().contiguous().t())
    torch.testing.assert_close(G.gemm(af, bf, block=(128, 128, 32)),
                               G.gemm_plain(af, bf), **_tol(torch.float32))
    ragged = a[:100] if layout == "b_t" else \
        torch.randn(K, 100, generator=gen, device=cuda).to(torch.bfloat16).t()
    assert G.operand_body(ragged, b) == ("tma" if layout == "b_t" else "staged")
    torch.testing.assert_close(G.gemm(ragged, b, block=(64, 64, 64), out_dtype=torch.float32),
                               G.gemm_plain(ragged, b, out_dtype=torch.float32),
                               **_tol(torch.bfloat16))
    torch.cuda.synchronize()
    assert G.launches_by_body["staged"] == before["staged"] + 1 + (layout == "a_t")


def test_served_gemm_shapes_run_on_the_tma_body(cuda):
    """The planner's tiles at the served K1 shape and the MoE's four K4
    shapes launch the TMA body, and a misaligned expert buffer the staged
    one."""
    from repro_torch import kernels
    from repro_torch.kernels import moe_gmm, ops
    kernels.reset_launch_counts()
    a = torch.randn(2048, 2048, device=cuda).to(torch.bfloat16)
    b = torch.randn(2048, 11008, device=cuda).to(torch.bfloat16)
    ops.matmul(a, b)
    for cap in (8, 160):
        for d_in, d_out in ((2048, 768), (768, 2048)):
            x = torch.randn(128, cap, d_in, device=cuda).to(torch.bfloat16)
            w = torch.randn(128, d_in, d_out, device=cuda).to(torch.bfloat16)
            ops.grouped_matmul(x, w)
    buf = torch.randn(1 + 4 * 8 * 64, device=cuda).to(torch.bfloat16)
    x = buf[1:].view(4, 8, 64)
    w = torch.randn(4, 64, 96, device=cuda).to(torch.bfloat16)
    got = ops.grouped_matmul(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, moe_gmm.grouped_matmul_plain(x, w, out_dtype=torch.float32),
                               rtol=2e-2, atol=2e-2)
    assert kernels.launches_by_body() == {"gemm": {"tma": 1, "staged": 0},
                                          "grouped_matmul": {"tma": 4, "staged": 1},
                                          "flash_attention": {"tma": 0, "mma": 0, "f32": 0},
                                          "flash_attention_bwd": {"tma": 0, "mma": 0, "f32": 0},
                                          "flash_decode": {"tma": 0, "mma": 0, "f32": 0}}


def _kv_view(n_kv, Skv, d, dtype, device, offset):
    """(1, n_kv, Skv, d) view of a (1, Skv, n_kv, d) buffer that starts
    ``offset`` elements into its storage (1: not 16-byte aligned)."""
    buf = torch.randn(offset + Skv * n_kv * d, device=device).to(dtype)
    return buf[offset:].view(1, Skv, n_kv, d).permute(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(4, 1, 256, 256, 64, False, 0),
                                  (4, 1, 256, 256, 64, True, 0),
                                  (2, 1, 128, 384, 64, False, 0),
                                  (8, 4, 100, 100, 32, True, 0),
                                  (16, 8, 512, 512, 128, True, 0),
                                  (128, 8, 512, 512, 128, True, 0),    # the MoE's prefill
                                  (8, 4, 200, 136, 128, True, 1),      # vec_ok == 0
                                  (6, 3, 77, 150, 64, False, 1)])
def test_flash_attention_kernel_every_tile(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as FA
    BH, g, Sq, Skv, d, causal, offset = case
    q = torch.randn(BH, Sq, d, device=cuda).to(dtype)
    k = _kv_view(BH // g, Skv, d, dtype, cuda, offset)
    v = _kv_view(BH // g, Skv, d, dtype, cuda, offset)
    assert (k.data_ptr() % 16 == 0) == (offset == 0)
    want = FA.flash_attention_plain(q, k, v, causal=causal, q_per_kv=g)
    for bq, bkv in FA.legal_tiles(d, q.element_size()):
        got = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                                 q_per_kv=g)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(4, 1, 1024, None, 64, 4), (4, 1, 2048, None, 64, 8),
                                  (4, 1, 512, None, 64, 1), (16, 8, 545, 513, 128, None),
                                  (16, 8, 545, 1, 128, None), (12, 3, 300, 7, 32, 5),
                                  (16, 8, 545, 0, 128, 2), (128, 8, 545, 513, 128, None),
                                  (32, 16, 545, 513, 128, None), (16, 8, 2048, None, 128, 8),
                                  (16, 8, 545, 0, 128, None), (16, 8, 545, 1, 128, 8)])
def test_flash_decode_kernels(cuda, case, dtype):
    """``ops.flash_decode`` against its plain version, one launch a call
    (the MoE's decode shape, G = 16, splits at the cluster's 8, valid 0
    and 1 among the cases)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_decode as FD, ops
    BH, g, Skv, valid, d, splits = case
    q = torch.randn(BH, 1, d, device=cuda).to(dtype)
    k = torch.randn(1, Skv, BH // g, d, device=cuda).to(dtype).permute(0, 2, 1, 3)
    v = torch.randn(1, Skv, BH // g, d, device=cuda).to(dtype).permute(0, 2, 1, 3)
    kernels.reset_launch_counts()
    got = ops.flash_decode(q, k, v, kv_splits=splits, kv_valid_len=valid, q_per_kv=g)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_decode"] == 1 and sum(counts.values()) == 1
    want = FD.flash_decode_plain(q, k, v, kv_valid_len=valid, q_per_kv=g)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_flash_decode_on_a_strided_cache_view(cuda, dtype, offset):
    """The serving cache (B, T, Hkv, d) read in place through a permuted
    view, whole or one element off 16-byte alignment (the scalar copies)."""
    from repro_torch.kernels import flash_decode as FD, ops
    B, H, Hkv, T, d = 4, 16, 2, 545, 128
    q = torch.randn(B * H, 1, d, device=cuda).to(dtype)
    kc = torch.randn(B, T, Hkv, d + offset, device=cuda).to(dtype)[..., offset:]
    vc = torch.randn(B, T, Hkv, d + offset, device=cuda).to(dtype)[..., offset:]
    k, v = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    got = ops.flash_decode(q, k, v, kv_valid_len=513, q_per_kv=H // Hkv)
    torch.cuda.synchronize()
    want = FD.flash_decode_plain(q, k, v, kv_valid_len=513, q_per_kv=H // Hkv)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(64, 8, 545, 513, 128, 9), (128, 8, 545, 513, 128, 9),
                                  (16, 16, 300, 7, 64, 5), (8, 2, 2048, None, 32, 16)])
def test_flash_decode_partials_epilogue(cuda, case, dtype):
    """``flash_decode_partials`` (the decode body's partials epilogue, any
    split count) against its plain version through the exact float32
    combine, since a split's (m, l, acc) are defined up to a common scale;
    and ``combine_partials`` on the plain partials."""
    from repro_torch.kernels import flash_decode as FD
    BH, g, Skv, valid, d, splits = case
    q = torch.randn(BH, 1, d, device=cuda).to(dtype)
    k = torch.randn(1, Skv, BH // g, d, device=cuda).to(dtype).permute(0, 2, 1, 3)
    v = torch.randn(1, Skv, BH // g, d, device=cuda).to(dtype).permute(0, 2, 1, 3)
    m, l, acc = FD.flash_decode_partials(q, k, v, kv_splits=splits, kv_valid_len=valid,
                                         q_per_kv=g)
    mp, lp, accp = FD.flash_decode_partials_plain(q, k, v, kv_splits=splits,
                                                  kv_valid_len=valid, q_per_kv=g)
    torch.cuda.synchronize()
    torch.testing.assert_close(FD.combine_partials_plain(m, l, acc),
                               FD.combine_partials_plain(mp, lp, accp), **_tol(dtype))
    torch.testing.assert_close(FD.combine_partials(mp, lp, accp, out_dtype=dtype).float(),
                               FD.combine_partials_plain(mp, lp, accp, out_dtype=dtype).float(),
                               **_tol(dtype))


def test_flash_decode_refuses_more_splits_than_a_cluster(cuda):
    from repro_torch.kernels import flash_decode as FD
    q = torch.randn(8, 1, 64, device=cuda)
    k = torch.randn(8, 256, 64, device=cuda)
    with pytest.raises(ValueError, match="at most 8 splits"):
        FD.flash_decode(q, k, k, kv_splits=9)


def test_serve_reduced_on_the_card_matches_the_plain_path(cuda):
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model
    cfg = common.launch_config("qwen2.5-3b", reduced=True)
    api = build_model(cfg)
    params = serve.load_params(api, cuda, seed=0)
    prompts = serve.make_prompts(cfg, 2, 64, cuda)
    kernels.reset_launch_counts()
    res = serve.generate(api, params, prompts, 8, keep_step_logits=True)
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    assert kernels.launch_counts()["flash_decode"] == cfg.n_layers * 8
    assert kernels.launch_counts()["flash_decode_partials"] == 0
    ref = serve.generate(build_model(replace(cfg, kernels="plain")), params, prompts, 8,
                         keep_step_logits=True, forced_ids=res.generated)
    for a, b in zip([res.prefill_logits, *res.step_logits],
                    [ref.prefill_logits, *ref.step_logits]):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)


def test_serve_with_observation_on_the_card_serves_the_same(cuda, tmp_path, monkeypatch):
    """The four observation flags change nothing served on the card: the
    same ids, kernel launches and planned blocks as without them."""
    from repro_torch import kernels
    from repro_torch.core import lower_torch
    from repro_torch.launch import serve
    from repro_torch.obs import flightrec, slo
    monkeypatch.delenv(flightrec.FLIGHTREC_ENV, raising=False)
    monkeypatch.setattr(flightrec.RECORDER, "on", False)
    monkeypatch.setattr(flightrec.RECORDER, "path", None)
    monkeypatch.setattr(slo.TRACKER, "on", False)
    dump = tmp_path / "fr.json"
    argv = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "2", "--prompt-len", "64",
            "--tokens", "8"]
    runs = []
    for extra in ([], ["--introspect-port", "0", "--introspect-hold", "0",
                       "--flightrec", str(dump), "--plan-budget-ms", "10"]):
        lower_torch.clear_block_caches()
        kernels.reset_launch_counts()
        res = serve.main(argv + extra)
        runs.append((res.generated.cpu(), kernels.launch_counts(),
                     {k: b for k, (b, _) in res.blocks.items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] and runs[0][1]["flash_attention"] > 0
    assert runs[0][2] == runs[1][2] and runs[0][2]
    assert any(e["kind"] == "plan_request" for e in flightrec.load_dump(str(dump))["events"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 128, 128, 128), (8, 256, 128, 256), (128, 8, 256, 192),
                                   (3, 24, 96, 160), (5, 13, 45, 51), (2, 160, 768, 256)])
def test_grouped_gemm_kernel_every_tile(cuda, shape, dtype):
    from repro_torch.kernels import moe_gmm
    E, cap, d_in, d_out = shape
    x = torch.randn(E, cap, d_in, device=cuda).to(dtype)
    w = (torch.randn(E, d_in, d_out, device=cuda) * d_in ** -0.5).to(dtype)
    want = moe_gmm.grouped_matmul_plain(x, w, out_dtype=torch.float32)
    before = moe_gmm.launches
    for tile in moe_gmm.COMPILED_TILES:
        for out_dtype in (torch.float32, dtype):
            got = moe_gmm.grouped_matmul(x, w, block=tile, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype
            torch.testing.assert_close(got.float(), want, **_tol(out_dtype))
    assert moe_gmm.launches == before + 2 * len(moe_gmm.COMPILED_TILES)


def test_serve_moe_reduced_on_the_card_matches_the_plain_path(cuda, monkeypatch):
    """The plain run replays the kernel run's routing: on near-flat random
    routers a bf16 difference in attention picks other experts.  Both bf16
    runs are held against the same loop in float32 (same ids, routing and
    bf16 weights): the kernel path may be at most 1.25 x as far from it as
    the plain path, plus 2e-2 in the largest difference; a control whose
    expert products keep 5 mantissa bits must fail that bound."""
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.kernels import moe_gmm
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model, moe
    cfg = common.launch_config("qwen3-moe-30b-a3b", reduced=True)
    api = build_model(cfg)
    params = serve.load_params(api, cuda, seed=0)
    prompts = serve.make_prompts(cfg, 2, 64, cuda)
    routed = []
    real = moe._router

    def record(xf, router_w, c):
        out = real(xf, router_w, c)
        routed.append(out[:2])
        return out

    monkeypatch.setattr(moe, "_router", record)
    kernels.reset_launch_counts()
    res = serve.generate(api, params, prompts, 8, keep_step_logits=True)
    counts = kernels.launch_counts()
    assert counts["grouped_matmul"] == 3 * cfg.n_layers * 9
    assert counts["flash_attention"] == cfg.n_layers and counts["gemm"] == 0

    def replayed(run_cfg):
        replay = iter(routed)
        monkeypatch.setattr(moe, "_router",
                            lambda xf, router_w, c: (*next(replay), real(xf, router_w, c)[2]))
        out = serve.generate(build_model(run_cfg), params, prompts, 8, keep_step_logits=True,
                             forced_ids=res.generated)
        assert next(replay, None) is None
        return torch.cat([x.float().flatten() for x in [out.prefill_logits, *out.step_logits]])

    plain = replayed(replace(cfg, kernels="plain"))
    exact = replayed(replace(cfg, kernels="plain", compute_dtype="float32"))
    plain_products = moe_gmm.grouped_matmul_plain

    def five_bits(x, w, *, block=None, out_dtype=None):
        i = plain_products(x, w, out_dtype=torch.float32).view(torch.int32)
        return ((i + (1 << 17)) & -(1 << 18)).view(torch.float32).to(out_dtype or x.dtype)

    monkeypatch.setattr(moe_gmm, "grouped_matmul_plain", five_bits)
    control = replayed(replace(cfg, kernels="plain"))
    got = torch.cat([x.float().flatten() for x in [res.prefill_logits, *res.step_logits]])

    def within(run):
        diff, base = run - exact, plain - exact
        return bool(diff.abs().max() <= 1.25 * base.abs().max() + 2e-2
                    and diff.square().mean().sqrt() <= 1.25 * base.square().mean().sqrt())

    assert within(got)
    assert not within(control)


def _wkv_inputs(BH, T, d, dtype, device, floor=False):
    """r, k, v, log_w, u on the card; ``floor`` draws log w in [-4, 0], the
    model's decay floor, which at chunk 32 drives a masked score's two
    factors past float32's range."""
    gen = torch.Generator(device=device).manual_seed(BH * 1000 + T + d)
    r, k, v = (torch.randn(BH, T, d, generator=gen, device=device) for _ in range(3))
    if floor:
        log_w = -4.0 * torch.rand(BH, T, d, generator=gen, device=device)
    else:
        log_w = -torch.exp(torch.randn(BH, T, d, generator=gen, device=device) * 0.5 - 1.0)
    u = torch.randn(BH, d, generator=gen, device=device) * 0.5
    return [x.to(dtype) for x in (r, k, v, log_w, u)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(3, 64, 32, 32, False), (3, 128, 32, 32, False),
                                  (3, 96, 32, 16, False), (2, 64, 16, 32, False),
                                  (160, 512, 64, 16, False), (4, 100, 64, 4, False),
                                  (2, 7, 32, 1, False), (5, 96, 64, 32, True),
                                  (6, 48, 16, 24, True), (160, 512, 64, 32, True),
                                  (4, 1, 64, 16, False)])
def test_wkv6_kernel(cuda, case, dtype):
    """K5 against its plain version: o at 2e-3 in float32 (the reference's
    kernel tolerance) and 2e-2 in bfloat16, the final state at 2e-3
    relative to its largest entry."""
    from repro_torch.kernels import rwkv6 as K
    BH, T, d, chunk, floor = case
    xs = _wkv_inputs(BH, T, d, dtype, cuda, floor)
    before = K.launches
    o, state = K.wkv6(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want_o, want_state = K.wkv6_plain(*xs, chunk=chunk)
    assert torch.isfinite(o.float()).all() and torch.isfinite(state).all()
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    scale = want_state.abs().max().item()
    torch.testing.assert_close(state, want_state, rtol=2e-3, atol=2e-3 * scale)


def test_wkv6_kernel_refuses_what_is_not_compiled(cuda):
    from repro_torch.kernels import ops, rwkv6 as K
    xs = _wkv_inputs(2, 64, 128, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dimension 128 is not compiled"):
        K.wkv6(*xs, chunk=16)
    xs = _wkv_inputs(2, 128, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="chunk 64 is not compiled"):
        K.wkv6(*xs, chunk=64)
    with pytest.raises(TypeError, match="one type"):
        K.wkv6(*xs[:4], xs[4].to(torch.bfloat16), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        K.wkv6(xs[0].transpose(1, 2).contiguous().transpose(1, 2), *xs[1:], chunk=16)
    o, _ = ops.wkv6(*xs, chunk=64)                # ops snaps the chunk to 32
    torch.cuda.synchronize()
    assert o.shape == xs[0].shape


def _wkv_bwd_inputs(BH, T, d, dtype, device, floor=False):
    """The forward's inputs and an output gradient ``do`` ~ N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(BH * 1000 + T + d + 1)
    do = torch.randn(BH, T, d, generator=gen, device=device).to(dtype)
    return _wkv_inputs(BH, T, d, dtype, device, floor) + [do]


def _within_share_of_largest(got, want, rel):
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g.float()).all(), name
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=rel, atol=rel * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [1, 8, 16, 32])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wkv6_bwd_kernel(cuda, d, chunk, dtype):
    """K5-bwd against its plain version on the same inputs, every compiled
    head dim at chunks 1 / 8 / 16 / 32 (chunk 1 at an odd T): each gradient
    within 2e-3 (float32) or 2e-2 (bfloat16) of its largest entry, and the
    same bits on a second call (no atomics)."""
    from repro_torch.kernels import rwkv6_bwd as KB
    T = 37 if chunk == 1 else 96
    xs = _wkv_bwd_inputs(6, T, d, dtype, cuda)
    before = KB.launches
    got = KB.wkv6_bwd(*xs, chunk=chunk)
    again = KB.wkv6_bwd(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert KB.launches == before + 2
    _within_share_of_largest(got, KB.wkv6_bwd_plain(*xs, chunk=chunk),
                             2e-3 if dtype == torch.float32 else 2e-2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(160, 512, 64, 16, False), (5, 96, 64, 32, True),
                                  (160, 512, 64, 32, True), (4, 100, 64, 4, False)])
def test_wkv6_bwd_kernel_at_the_training_shape_and_the_decay_floor(cuda, case, dtype):
    """rwkv6-3b's training shape (160 rows, T 512, d 64, chunk 16), decays
    at the model's floor with chunk 32 (a masked product's factors past
    float32's range) and a ragged chunk of 4."""
    from repro_torch.kernels import rwkv6_bwd as KB
    BH, T, d, chunk, floor = case
    xs = _wkv_bwd_inputs(BH, T, d, dtype, cuda, floor)
    got = KB.wkv6_bwd(*xs, chunk=chunk)
    torch.cuda.synchronize()
    _within_share_of_largest(got, KB.wkv6_bwd_plain(*xs, chunk=chunk),
                             2e-3 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_bwd_kernel_reads_unaligned_operands(cuda, dtype):
    """Operands that start one element past a 16-byte boundary (contiguous
    views into a larger buffer) take the kernel's plain-load path instead
    of ``cp.async`` (bf16) or the L2 prefetch (float32): the same gradients,
    bit for bit across two calls, within the kernel's tolerance of its
    plain version."""
    from repro_torch.kernels import rwkv6_bwd as KB
    xs = _wkv_bwd_inputs(4, 48, 64, dtype, cuda)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    ys = [shifted(x) for x in xs]
    assert all(y.is_contiguous() and y.data_ptr() % 16 for y in ys)
    got = KB.wkv6_bwd(*ys, chunk=16)
    again = KB.wkv6_bwd(*ys, chunk=16)
    torch.cuda.synchronize()
    _within_share_of_largest(got, KB.wkv6_bwd_plain(*xs, chunk=16),
                             2e-3 if dtype == torch.float32 else 2e-2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    aligned = KB.wkv6_bwd(*xs, chunk=16)
    _within_share_of_largest(got, aligned, 2e-3 if dtype == torch.float32 else 2e-2)


def _wkv_state(BH, d, device, seed=7):
    """An initial state of the size a scan leaves (a plain scan of another
    block), and a final-state gradient ~ N(0, 1), both float32."""
    from repro_torch.kernels import rwkv6 as K
    _, state0 = K.wkv6_plain(*_wkv_inputs(BH, 64, d, torch.float32, device), chunk=16)
    gen = torch.Generator(device=device).manual_seed(seed)
    return state0, torch.randn(BH, d, d, generator=gen, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(160, 512, 64, 16), (6, 96, 32, 32), (4, 37, 16, 1),
                                  (5, 96, 64, 8)])
def test_wkv6_kernels_from_an_initial_state(cuda, case, dtype):
    """K5 from a nonzero ``state0`` and K5-bwd with nonzero ``state0`` and
    final-state gradient ``dstate`` against their plain versions: o at 2e-3
    (float32) / 2e-2 (bf16), the final state at 2e-3 of its largest entry;
    each gradient, the initial state's too, within 2e-3 / 2e-2 of its
    largest entry, the same bits on a second call.  A scan in two blocks,
    the second from the first's final state, equals the scan of the whole
    at the same tolerance."""
    from repro_torch.kernels import rwkv6 as K, rwkv6_bwd as KB
    BH, T, d, chunk = case
    xs = _wkv_bwd_inputs(BH, T, d, dtype, cuda)
    state0, dstate = _wkv_state(BH, d, cuda)
    o, state = K.wkv6(*xs[:5], chunk=chunk, state0=state0)
    want_o, want_state = K.wkv6_plain(*xs[:5], chunk=chunk, state0=state0)
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=2e-3,
                               atol=2e-3 * want_state.abs().max().item())
    got = KB.wkv6_bwd(*xs, chunk=chunk, state0=state0, dstate=dstate)
    again = KB.wkv6_bwd(*xs, chunk=chunk, state0=state0, dstate=dstate)
    want = KB.wkv6_bwd_plain(*xs, chunk=chunk, state0=state0, dstate=dstate)
    torch.cuda.synchronize()
    assert len(got) == 6 and got[5].dtype == torch.float32
    _within_share_of_largest(got[:5], want[:5], tol)
    scale = want[5].abs().max().item()
    torch.testing.assert_close(got[5], want[5], rtol=tol, atol=tol * scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if T % 2 == 0 and (T // 2) % chunk == 0:
        h = T // 2
        o1, s1 = K.wkv6(*(x[:, :h].contiguous() for x in xs[:4]), xs[4], chunk=chunk)
        o2, s2 = K.wkv6(*(x[:, h:].contiguous() for x in xs[:4]), xs[4], chunk=chunk,
                        state0=s1)
        whole, ws = K.wkv6(*xs[:5], chunk=chunk)
        torch.testing.assert_close(torch.cat([o1, o2], 1).float(), whole.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(s2, ws, rtol=2e-3, atol=2e-3 * ws.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernels_with_a_zero_state_equal_no_state(cuda, dtype):
    """A zero ``state0`` and a zero ``dstate`` run the added loads and the
    added dlog_w term on zeros: K5's output and state and K5-bwd's five
    gradients equal the calls without them, bit for bit, and the initial
    state's gradient is finite."""
    from repro_torch.kernels import rwkv6 as K, rwkv6_bwd as KB
    xs = _wkv_bwd_inputs(8, 128, 64, dtype, cuda)
    zero = torch.zeros(8, 64, 64, device=cuda)
    assert all(torch.equal(a, b) for a, b in zip(K.wkv6(*xs[:5], chunk=16),
                                                  K.wkv6(*xs[:5], chunk=16, state0=zero)))
    got = KB.wkv6_bwd(*xs, chunk=16, state0=zero, dstate=zero)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[:5], KB.wkv6_bwd(*xs, chunk=16)))
    assert torch.isfinite(got[5]).all()


def test_wkv6_bwd_training_grid_is_resident_on_the_card(cuda):
    """The card holds every cluster of the training shape's launch at once
    (cudaOccupancyMaxActiveClusters: 160 rows of 4 blocks at d 64, chunk
    16, bf16), as the mirror's one wave says for 132 SMs."""
    from repro_torch.kernels import _build, rwkv6_bwd as KB
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    geo = KB.wkv6_bwd_geometry(160, 64, 16, 2, sms=sms)
    clusters = _build.lib().repro_wkv6_bwd_max_clusters(64, 16, 1)
    assert geo["waves"] == 1
    assert clusters >= 160, f"the card holds {clusters} clusters of 4 at once, not 160"


def test_wkv6_bwd_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import rwkv6_bwd as KB
    xs = _wkv_bwd_inputs(2, 64, 128, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dimension 128 is not compiled"):
        KB.wkv6_bwd(*xs, chunk=16)
    xs = _wkv_bwd_inputs(2, 128, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="chunk 64 is not compiled"):
        KB.wkv6_bwd(*xs, chunk=64)
    with pytest.raises(TypeError, match="one type"):
        KB.wkv6_bwd(*xs[:5], xs[5].to(torch.bfloat16), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        KB.wkv6_bwd(xs[0].transpose(1, 2).contiguous().transpose(1, 2), *xs[1:], chunk=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_wkv6_gradient_on_the_card_matches_the_cpu(cuda, dtype):
    """``ops.wkv6`` under autograd on the card (K5 once, K5-bwd once) against
    the same call on CPU copies (the plain forward and backward)."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    xs = _wkv_bwd_inputs(8, 128, 64, dtype, cuda)

    def grads(device):
        leaves = [x.detach().to(device).requires_grad_() for x in xs[:5]]
        o, state = ops.wkv6(*leaves, chunk=16)
        assert state.requires_grad
        return torch.autograd.grad(o, leaves, xs[5].to(device))

    kernels.reset_launch_counts()
    got = grads(cuda)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["wkv6"] == 1 and counts["wkv6_bwd"] == 1 and sum(counts.values()) == 2
    want = [g.to(cuda) for g in grads("cpu")]
    _within_share_of_largest(got, want, 2e-3 if dtype == torch.float32 else 2e-2)


def test_serve_rwkv6_reduced_on_the_card_is_as_close_to_float32_as_plain(cuda, monkeypatch):
    """rwkv6-3b reduced: K5 once per layer in prefill.  The plain run is the
    same bf16 loop with the kernel's plain version in its place, fed the
    kernel run's ids; both are held against the loop in float32 (same ids
    and bf16 weights): the kernel path may be at most 1.25 x as far from it
    as the plain path (largest difference plus 2e-2, and RMS).  That bound
    mostly sees the bf16 rounding of the other tensors, so every K5 call of
    a prefill is also held against its plain version on the same inputs,
    within one bf16 step; a control whose WKV output keeps 5 mantissa bits
    must fail the two together (chip_smoke.py's rwkv phase does the same at
    full size)."""
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.kernels import rwkv6 as K
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model
    cfg = common.launch_config("rwkv6-3b", reduced=True)
    api = build_model(cfg)
    params = serve.load_params(api, cuda, seed=0)
    prompts = serve.make_prompts(cfg, 2, 64, cuda)
    kernels.reset_launch_counts()
    res = serve.generate(api, params, prompts, 8, keep_step_logits=True)
    counts = kernels.launch_counts()
    assert counts["wkv6"] == cfg.n_layers
    assert sum(counts.values()) == cfg.n_layers
    kernel, plain_scan = K.wkv6, K.wkv6_plain

    def run(run_cfg, scan):
        monkeypatch.setattr(K, "wkv6", scan)
        out = serve.generate(build_model(run_cfg), params, prompts, 8, keep_step_logits=True,
                             forced_ids=res.generated)
        return torch.cat([x.float().flatten() for x in [out.prefill_logits, *out.step_logits]])

    def five_bits(*args, chunk):
        o, state = plain_scan(*args, chunk=chunk)
        i = o.float().contiguous().view(torch.int32)
        return ((i + (1 << 17)) & -(1 << 18)).view(torch.float32).to(o.dtype), state

    def per_call_within(scan) -> bool:
        ok = []

        def checked(*args, chunk):
            o, state = scan(*args, chunk=chunk)
            po, pstate = plain_scan(*args, chunk=chunk)
            diff, ref = (o.float() - po.float()).abs(), po.float().abs()
            ok.append(bool((diff <= 2 ** -7 * ref + 1e-4 * ref.max()).all()) and
                      bool((state - pstate).abs().max() <= 2e-3 * pstate.abs().max()))
            return o, state

        monkeypatch.setattr(K, "wkv6", checked)
        with torch.no_grad():
            api.prefill(params, prompts, api.init_cache(cfg, 2, 65, device=cuda))
        return len(ok) == cfg.n_layers and all(ok)

    plain = run(cfg, plain_scan)
    exact = run(replace(cfg, compute_dtype="float32"), plain_scan)
    control = run(cfg, five_bits)
    got = torch.cat([x.float().flatten() for x in [res.prefill_logits, *res.step_logits]])
    assert torch.isfinite(got).all()

    def within(x):
        diff, base = x - exact, plain - exact
        return bool(diff.abs().max() <= 1.25 * base.abs().max() + 2e-2
                    and diff.square().mean().sqrt() <= 1.25 * base.square().mean().sqrt())

    assert within(got) and per_call_within(kernel)
    assert not (within(control) and per_call_within(five_bits))


def test_python_footprints_mirror_the_compiled_kernels(cuda):
    """The shared-memory formulas the planner prunes with are the kernels'
    own, for the TMA body's tiles (deep and short-K rings) and the staged
    body's alike; so are the decode bodies' and the WKV scan's, forward and
    backward, and K2-bwd's blocks and dK/dV cluster."""
    from repro_torch.kernels import _build, flash_attention as FA, flash_decode as FD, gemm as G
    from repro_torch.kernels import rwkv6 as K, rwkv6_bwd as KB
    lib = _build.lib()
    for d in FA.COMPILED_HEAD_DIMS:
        assert lib.repro_flash_decode_smem_bytes(d, 1) == FD.decode_smem_bytes(d, 2)
        assert lib.repro_flash_decode_smem_bytes(d, 0) == FD.decode_smem_bytes(d, 4)
    assert lib.repro_flash_decode_smem_bytes(256, 2) == FD.decode_smem_bytes(256, 2, "tma")
    assert lib.repro_flash_decode_tma_occupancy() == FD.TMA_BLOCKS_PER_SM
    for d in K.COMPILED_HEAD_DIMS:
        for chunk in (1, 16, 24, 32):
            assert lib.repro_wkv6_smem_bytes(d, chunk) == K.wkv6_smem_bytes(d, chunk)
            for is_bf16, elem in ((1, 2), (0, 4)):
                assert lib.repro_wkv6_bwd_smem_bytes(d, chunk, is_bf16) == \
                    KB.wkv6_bwd_smem_bytes(d, chunk, elem)
                geo = KB.wkv6_bwd_geometry(1, d, chunk, elem)
                assert lib.repro_wkv6_bwd_min_blocks(d, chunk, is_bf16) == geo["blocks_per_sm"]
        assert lib.repro_wkv6_bwd_split(d) == KB.wkv6_bwd_geometry(1, d, 16)["split"]
    for tile in G.COMPILED_TILES:
        for K in (0, 24, 160, 384, 2048):
            assert lib.repro_gemm_smem_bytes(*tile, 1, K) == G.gemm_smem_bytes(*tile, 2, K=K)
            assert lib.repro_gemm_smem_bytes(*tile, 0, K) == G.gemm_smem_bytes(*tile, 4, K=K)
    from repro_torch.kernels import flash_attention_bwd as FAB
    for d in FA.COMPILED_HEAD_DIMS:
        for i, kernel in enumerate(("dq", "dkv")):
            assert lib.repro_flash_bwd_smem_bytes(d, i, 1) == \
                FAB.bwd_smem_bytes(d, kernel, 2, "mma")
            assert lib.repro_flash_bwd_smem_bytes(d, i, 0) == FAB.bwd_smem_bytes(d, kernel, 4)
    for i, kernel in enumerate(("dq", "dkv")):       # the TMA bodies at d 256
        assert lib.repro_flash_bwd_tma_smem_bytes(i) == FAB.bwd_smem_bytes(256, kernel, 2)
    for g in range(1, 33):
        assert lib.repro_flash_bwd_cluster(g) == FAB.bwd_cluster(g)
    for d in FA.COMPILED_HEAD_DIMS:
        for tile in FA.COMPILED_TILES:
            assert lib.repro_flash_smem_bytes_bf16(*tile, d) == \
                FA.flash_smem_bytes(*tile, d, 2, "mma")
            assert lib.repro_flash_smem_bytes_f32(*tile, d) == FA.flash_smem_bytes(*tile, d, 4)
    for tile in FA.COMPILED_TILES:
        assert lib.repro_flash_tma_smem_bytes(*tile, 0) == FA.flash_smem_bytes(*tile, 256, 2)
        assert lib.repro_flash_tma_smem_bytes(*tile, 1) == FA.tma_blocks_per_sm(*tile)
        # the runtime finds room for as many blocks as the launch bounds ask for
        assert lib.repro_flash_tma_occupancy(*tile) == FA.tma_blocks_per_sm(*tile)
    geo = FAB.bwd_geometry(64, 512, 512, 256, 1)
    for i, kernel in enumerate(("dq", "dkv")):
        assert lib.repro_flash_bwd_tma_occupancy(i) == geo[kernel]["blocks_per_sm"] == 1


def test_gemm_kernel_unaligned_operands_take_the_scalar_path(cuda):
    """K and N that are not multiples of 8 (no 16-byte alignment of rows)."""
    from repro_torch.kernels import gemm as G
    a = torch.randn(70, 45, device=cuda).to(torch.bfloat16)
    b = torch.randn(45, 51, device=cuda).to(torch.bfloat16)
    got = G.gemm(a, b, block=(64, 64, 32), out_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, G.gemm_plain(a, b, out_dtype=torch.float32),
                               rtol=2e-2, atol=2e-2)


# the attention shapes the zamba2, internvl2 and seamless serves give K2 and
# K3 at batch 4, prompt 512, 32 new tokens (head dim 64): (batch, q heads,
# kv heads, Sq, Skv, causal) and (batch, q heads, kv heads, buffer, valid)
SERVED_FLASH_D64 = [(4, 32, 32, 512, 512, True),      # zamba2-1.2b prefill
                    (4, 14, 2, 768, 768, True),       # internvl2-1b: 256 patches + 512
                    (4, 16, 16, 1024, 1024, False),   # seamless encoder
                    (4, 16, 16, 512, 1024, False)]    # seamless cross prompt pass
SERVED_DECODE_D64 = [(4, 32, 32, 545, 513),           # zamba2-1.2b
                     (4, 14, 2, 801, 769),            # internvl2-1b
                     (4, 16, 16, 1024, None)]         # seamless cross, every key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED_FLASH_D64)
def test_flash_attention_at_the_d64_served_shapes(cuda, case, dtype):
    """K2 through ``ops.attention`` (the planner's tile) and at every legal
    tile, on k/v read through the serving layout's strided view, against
    its plain version: non-causal with Sq != Skv among them."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, ops
    B, H, Hkv, Sq, Skv, causal = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + Skv + H)
    q = torch.randn(B * H, Sq, 64, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(B, Skv, Hkv, 64, generator=gen, device=cuda).to(dtype)
            .permute(0, 2, 1, 3) for _ in range(2))
    want = FA.flash_attention_plain(q, k, v, causal=causal, q_per_kv=H // Hkv)
    kernels.reset_launch_counts()
    got = ops.attention(q, k, v, causal=causal, q_per_kv=H // Hkv)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    for bq, bkv in FA.legal_tiles(64, q.element_size()):
        got = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                                 q_per_kv=H // Hkv)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED_DECODE_D64)
def test_flash_decode_at_the_d64_served_shapes(cuda, case, dtype):
    """K3 in one launch at group sizes 1 and 7 and over a whole cross memory
    (no valid length), against its plain version."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_decode as FD, ops
    B, H, Hkv, T, valid = case
    gen = torch.Generator(device=cuda).manual_seed(T + H)
    q = torch.randn(B * H, 1, 64, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(B, T, Hkv, 64, generator=gen, device=cuda).to(dtype)
            .permute(0, 2, 1, 3) for _ in range(2))
    kernels.reset_launch_counts()
    got = ops.flash_decode(q, k, v, kv_valid_len=valid, q_per_kv=H // Hkv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_decode"] == 1 and sum(counts.values()) == 1
    want = FD.flash_decode_plain(q, k, v, kv_valid_len=valid, q_per_kv=H // Hkv)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


# reduced prompt passes through K2 and decode-step attentions through K3 per
# family: zamba2 2 shared-attention sites, internvl2 2 layers, seamless 2
# encoder + 2 decoder self + 2 cross prompt passes and 2 + 2 per step
FAMILY_LAUNCHES = {"zamba2-1.2b": (2, 2), "internvl2-1b": (2, 2),
                   "seamless-m4t-medium": (6, 4)}


@pytest.mark.parametrize("arch", sorted(FAMILY_LAUNCHES))
def test_serve_new_families_reduced_on_the_card(cuda, arch):
    """Each new family's prefill and decode on the card at its reduced size,
    with exact K2/K3 launch counts and nothing else launched; the kernel
    run and the plain run (fed the kernel run's ids) are held against the
    same loop in float32: the kernel path at most 1.25 x as far from it as
    the plain path (largest difference plus 2e-2, and RMS)."""
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model
    cfg = common.launch_config(arch, reduced=True)
    api = build_model(cfg)
    params = serve.load_params(api, cuda, seed=0)
    prompts = serve.make_prompts(cfg, 2, 64, cuda)
    inputs = api.frontend_inputs(2, torch.Generator(device=cuda).manual_seed(0), cuda)
    kernels.reset_launch_counts()
    res = serve.generate(api, params, prompts, 8, inputs=inputs, keep_step_logits=True)
    prompt_passes, per_step = FAMILY_LAUNCHES[arch]
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == prompt_passes
    assert counts["flash_decode"] == per_step * 8
    assert sum(counts.values()) == prompt_passes + per_step * 8

    def run(run_cfg):
        out = serve.generate(build_model(run_cfg), params, prompts, 8, inputs=inputs,
                             keep_step_logits=True, forced_ids=res.generated)
        return torch.cat([x.float().flatten() for x in [out.prefill_logits, *out.step_logits]])

    plain = run(replace(cfg, kernels="plain"))
    exact = run(replace(cfg, kernels="plain", compute_dtype="float32"))
    got = torch.cat([x.float().flatten() for x in [res.prefill_logits, *res.step_logits]])
    assert torch.isfinite(got).all()
    diff, base = got - exact, plain - exact
    assert diff.abs().max() <= 1.25 * base.abs().max() + 2e-2
    assert diff.square().mean().sqrt() <= 1.25 * base.square().mean().sqrt()


# ---------------------------------------------------------------- training
BWD_CASES = [  # BH, q_per_kv, Sq, Skv, d, causal, offset of the k/v storage
    (4, 1, 64, 64, 32, True, 0),
    (16, 8, 512, 512, 128, True, 0),        # qwen2.5-3b's training pass, one sequence
    (14, 7, 384, 384, 64, True, 0),         # internvl2's group of 7
    (8, 4, 200, 136, 128, True, 1),         # Sq > Skv, unaligned k/v
    (8, 8, 512, 1024, 64, False, 0),        # seamless's cross pass
    (6, 3, 77, 150, 64, False, 1),          # ragged, not causal
    (2, 1, 37, 53, 32, True, 0),
    (128, 8, 512, 512, 128, True, 0),       # the MoE's training pass (4 sequences)
    (32, 16, 130, 160, 64, True, 0),        # G 16: clusters of 8, two heads a block
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_kernel(cuda, case, dtype):
    """K2-bwd against its plain version from the forward kernel's output and
    log-sum-exp (itself held against the plain forward's), and the same
    result bit for bit on a second call (no atomics)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
    BH, g, Sq, Skv, d, causal, offset = case
    q = torch.randn(BH, Sq, d, device=cuda).to(dtype)
    k = _kv_view(BH // g, Skv, d, dtype, cuda, offset)
    v = _kv_view(BH // g, Skv, d, dtype, cuda, offset)
    dout = torch.randn(BH, Sq, d, device=cuda).to(dtype)
    out, lse = FA.flash_attention(q, k, v, causal=causal, block_q=64, block_kv=64,
                                  q_per_kv=g, return_lse=True)
    _, plse = FA.flash_attention_plain(q, k, v, causal=causal, q_per_kv=g, return_lse=True)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    kernels.reset_launch_counts()
    got = FAB.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, q_per_kv=g)
    again = FAB.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, q_per_kv=g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == 2
    want = FAB.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal, q_per_kv=g)
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape and a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **_tol(dtype))
        assert torch.equal(a, c)


# head dim 256 (gemma-7b: 16 heads, MHA): batch x heads, q_per_kv, Sq, Skv,
# causal, offset of the k/v storage (1: not 16-byte aligned)
D256_FLASH = [(64, 1, 512, 512, True, 0),         # gemma-7b's prefill, 4 sequences
              (8, 4, 200, 136, True, 1),          # grouped, Sq > Skv, unaligned k/v
              (6, 3, 77, 150, False, 0)]          # ragged, not causal
D256_DECODE = [(64, 1, 545, 513, None),           # gemma-7b's decode step: G 1
               (16, 8, 545, 513, None),           # a group of 8
               (12, 3, 300, 7, 5), (16, 1, 545, 0, 2)]


def _d256_body(dtype, offset) -> str:
    """The body a d-256 call takes: float32's, the mma.sync body where the
    k/v storage is not 16-byte aligned, else the TMA + wgmma body."""
    return "f32" if dtype == torch.float32 else ("mma" if offset else "tma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", D256_FLASH)
def test_flash_attention_kernel_at_d256(cuda, case, dtype):
    """K2 at head dim 256 at every tile that fits a block (bf16 all four,
    float32 (64, 32)) and through ``ops.attention``'s planned tile, against
    its plain version, with the log-sum-exp the backward reads; each call on
    the body its arguments choose (``launches_by_body``)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, ops
    BH, g, Sq, Skv, causal, offset = case
    q = torch.randn(BH, Sq, 256, device=cuda).to(dtype)
    k = _kv_view(BH // g, Skv, 256, dtype, cuda, offset)
    v = _kv_view(BH // g, Skv, 256, dtype, cuda, offset)
    want, plse = FA.flash_attention_plain(q, k, v, causal=causal, q_per_kv=g, return_lse=True)
    tiles = FA.legal_tiles(256, q.element_size())
    assert len(tiles) == (4 if dtype == torch.bfloat16 else 1)
    body = _d256_body(dtype, offset)
    for bq, bkv in tiles:
        kernels.reset_launch_counts()
        got, lse = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                                      q_per_kv=g, return_lse=True)
        torch.cuda.synchronize()
        assert kernels.launches_by_body()["flash_attention"][body] == 1
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    kernels.reset_launch_counts()
    got = ops.attention(q, k, v, causal=causal, q_per_kv=g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    assert kernels.launches_by_body()["flash_attention"][body] == 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_d256_row_with_every_key_masked(cuda):
    """On the TMA bodies, a row whose scores all fall at or below the -1e30
    sentinel: output 0 and log-sum-exp +1e30 at every tile, zero gradient,
    nothing NaN; the rest against the plain versions (dq's column 0, a sum
    of 1e16-sized terms that cancel, only finite)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
    BH, S, d = 8, 200, 256
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, dout = (torch.randn(BH, S, d, generator=gen, device=cuda) for _ in range(4))
    q[:, :, 0] = 0.0
    k[:, :, 0] = 1e16
    q[:, 70, 0] = -1e16                 # row 70: every score about -6e30
    q, k, v, dout = (t.to(torch.bfloat16) for t in (q, k, v, dout))
    want, plse = FA.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    kernels.reset_launch_counts()
    for bq, bkv in FA.legal_tiles(d, 2):
        out, lse = FA.flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bkv,
                                      return_lse=True)
        torch.cuda.synchronize()
        assert torch.all(out[:, 70] == 0) and torch.all(lse[:, 70] == FA.LSE_MASKED)
        torch.testing.assert_close(out.float(), want.float(), **_tol(torch.bfloat16))
        torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    grads = FAB.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    assert kernels.launches_by_body()["flash_attention"]["tma"] == len(FA.legal_tiles(d, 2))
    assert kernels.launches_by_body()["flash_attention_bwd"]["tma"] == 1
    assert all(torch.isfinite(t.float()).all() for t in grads)
    assert torch.all(grads[0][:, 70] == 0)
    plain = FAB.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True)
    torch.testing.assert_close(grads[0][..., 1:].float(), plain[0][..., 1:].float(),
                               **_tol(torch.bfloat16))
    for a, b in zip(grads[1:], plain[1:]):
        torch.testing.assert_close(a.float(), b.float(), **_tol(torch.bfloat16))


def test_d256_rows_at_a_kv_seq_blocks_offset(cuda):
    """A later chunk's rows on one rank of a cache split over ``kv_seq``: 128
    rows at offset 64 of a 320-key block (the keys after the rows' last
    position unseen), K2 with its log-sum-exp at every tile and K2-bwd, on
    the TMA bodies, against the plain versions; K2-bwd bit-equal on a second
    call and zero dK/dV for the keys no row sees."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
    BH, Sq, Skv, d, off = 16, 128, 320, 256, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(BH, Sq, d, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (_kv_view(BH, Skv, d, torch.bfloat16, cuda, 0) for _ in range(2))
    dout = torch.randn(BH, Sq, d, generator=gen, device=cuda).to(torch.bfloat16)
    want, plse = FA.flash_attention_plain(q, k, v, causal=True, return_lse=True, q_offset=off)
    kernels.reset_launch_counts()
    for bq, bkv in FA.legal_tiles(d, 2):
        out, lse = FA.flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bkv,
                                      return_lse=True, q_offset=off)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(), **_tol(torch.bfloat16))
        torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    grads = FAB.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, q_offset=off)
    again = FAB.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, q_offset=off)
    torch.cuda.synchronize()
    assert kernels.launches_by_body()["flash_attention"] == {"tma": 4, "mma": 0, "f32": 0}
    assert kernels.launches_by_body()["flash_attention_bwd"] == {"tma": 2, "mma": 0, "f32": 0}
    plain = FAB.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True, q_offset=off)
    for a, b, c in zip(grads, plain, again):
        torch.testing.assert_close(a.float(), b.float(), **_tol(torch.bfloat16))
        assert torch.equal(a, c)
    assert not grads[1][:, :, off + Sq:].any() and not grads[2][:, :, off + Sq:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", D256_DECODE)
def test_flash_decode_kernels_at_d256(cuda, case, dtype):
    """K3 at head dim 256: the one-launch decode (one launch a call) on the
    serving cache's strided view, and the partials kernel with K3' over the
    plain partials, each against its plain version."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_decode as FD, ops
    BH, g, Skv, valid, splits = case
    q = torch.randn(BH, 1, 256, device=cuda).to(dtype)
    k = torch.randn(1, Skv, BH // g, 256, device=cuda).to(dtype).permute(0, 2, 1, 3)
    v = torch.randn(1, Skv, BH // g, 256, device=cuda).to(dtype).permute(0, 2, 1, 3)
    kernels.reset_launch_counts()
    got = ops.flash_decode(q, k, v, kv_splits=splits, kv_valid_len=valid, q_per_kv=g)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_decode"] == 1 and sum(counts.values()) == 1
    want = FD.flash_decode_plain(q, k, v, kv_valid_len=valid, q_per_kv=g)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    n = 9 if splits is None else splits
    m, l, acc = FD.flash_decode_partials(q, k, v, kv_splits=n, kv_valid_len=valid, q_per_kv=g)
    mp, lp, accp = FD.flash_decode_partials_plain(q, k, v, kv_splits=n, kv_valid_len=valid,
                                                  q_per_kv=g)
    torch.cuda.synchronize()
    torch.testing.assert_close(FD.combine_partials_plain(m, l, acc),
                               FD.combine_partials_plain(mp, lp, accp), **_tol(dtype))
    torch.testing.assert_close(FD.combine_partials(mp, lp, accp, out_dtype=dtype).float(),
                               FD.combine_partials_plain(mp, lp, accp, out_dtype=dtype).float(),
                               **_tol(dtype))


D256_BWD = [(16, 1, 512, 512, True, 0),           # gemma-7b's training pass, one sequence
            (8, 4, 200, 136, True, 1),            # grouped, Sq > Skv, unaligned k/v
            (6, 3, 77, 150, False, 0),            # ragged, not causal
            (16, 16, 130, 160, True, 0)]          # G 16: clusters of 8, two heads a block


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", D256_BWD)
def test_flash_attention_bwd_kernel_at_d256(cuda, case, dtype):
    """K2-bwd at head dim 256 (bf16 aligned: the TMA body, its two
    warpgroups each holding half of the output columns; unaligned: the
    mma.sync body, the columns split in two over the grid; float32: 32-row
    dQ blocks) against its plain version from the forward kernel's output
    and log-sum-exp, and bit-equal on a second call."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
    BH, g, Sq, Skv, causal, offset = case
    q = torch.randn(BH, Sq, 256, device=cuda).to(dtype)
    k = _kv_view(BH // g, Skv, 256, dtype, cuda, offset)
    v = _kv_view(BH // g, Skv, 256, dtype, cuda, offset)
    dout = torch.randn(BH, Sq, 256, device=cuda).to(dtype)
    bq, bkv = FA.legal_tiles(256, q.element_size())[0]
    out, lse = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                                  q_per_kv=g, return_lse=True)
    kernels.reset_launch_counts()
    got = FAB.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, q_per_kv=g)
    again = FAB.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, q_per_kv=g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == 2
    assert kernels.launches_by_body()["flash_attention_bwd"][_d256_body(dtype, offset)] == 2
    want = FAB.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal, q_per_kv=g)
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape and a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **_tol(dtype))
        assert torch.equal(a, c)


# context-parallel blocks (a rank's queries against the keys before its last
# one): batch x heads, q_per_kv, Sq, Skv, head dim, q_offset
OFFSET_CASES = [(8, 4, 128, 640, 64, 500),        # an offset no tile divides
                (8, 4, 128, 640, 128, 512),       # the last block: Skv - Sq
                (8, 1, 100, 300, 32, 64),         # ragged block
                (4, 1, 96, 640, 256, 64),         # keys after the last query: dK, dV 0
                (16, 8, 512, 4096, 128, 3584)]    # llama3-405b's last rank of 8 at 4096


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", OFFSET_CASES)
def test_flash_attention_kernels_with_q_offset(cuda, case, dtype):
    """K2 at every tile that fits a block and K2-bwd with a query offset,
    against their plain versions given the same offset; K2-bwd bit-equal on
    a second call, and zero dK/dV for keys no query of the block sees."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
    BH, g, Sq, Skv, d, off = case
    gen = torch.Generator(device=cuda).manual_seed(BH + Sq + off)
    q = torch.randn(BH, Sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(BH // g, Skv, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(BH // g, Skv, d, generator=gen, device=cuda).to(dtype)
    dout = torch.randn(BH, Sq, d, generator=gen, device=cuda).to(dtype)
    want, plse = FA.flash_attention_plain(q, k, v, causal=True, q_per_kv=g, return_lse=True,
                                          q_offset=off)
    for bq, bkv in FA.legal_tiles(d, q.element_size()):
        got, lse = FA.flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bkv,
                                      q_per_kv=g, return_lse=True, q_offset=off)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    kernels.reset_launch_counts()
    grads = FAB.flash_attention_bwd(q, k, v, got, lse, dout, causal=True, q_per_kv=g,
                                    q_offset=off)
    again = FAB.flash_attention_bwd(q, k, v, got, lse, dout, causal=True, q_per_kv=g,
                                    q_offset=off)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == 2
    if d == 256:                        # aligned: the TMA bodies
        body = _d256_body(dtype, 0)
        assert kernels.launches_by_body()["flash_attention_bwd"][body] == 2
    plain = FAB.flash_attention_bwd_plain(q, k, v, got, lse, dout, causal=True, q_per_kv=g,
                                          q_offset=off)
    for a, b, c in zip(grads, plain, again):
        torch.testing.assert_close(a.float(), b.float(), **_tol(dtype))
        assert torch.equal(a, c)
    if off + Sq < Skv:
        assert not grads[1][:, off + Sq:].any() and not grads[2][:, off + Sq:].any()


@pytest.mark.parametrize("d,body,G", [(64, "mma", 1), (64, "mma", 7), (128, "mma", 8),
                                     (256, "tma", 1), (256, "mma", 1)])
def test_flash_attention_bwd_sums_delta_from_its_own_p(cuda, d, body, G, record_property):
    """Keys and values nearly alike (seamless-m4t-medium's cross pass over a
    uniform encoder memory, at its first step): each bf16 body's dQ, dK
    and dV against float64 autograd of attention.  dQ is a small remainder
    of cancelling terms there: delta = rowsum(dO o) of the bf16 o put it
    off by more than its own size (tests/test_torch_attention_delta.py);
    each body sums delta from the P it recomputes.  The mma.sync bodies,
    whose dS enters dQ as two bf16 parts, keep dQ within the plain
    version's bound (0.05); the TMA body at d 256 rounds dS to one bf16
    (its design: one bf16 for P and for dS) and keeps it within 0.2 (0.15 measured on an H100
    80GB HBM3, 700 W).  The unaligned case (k and v one element off) runs
    the mma.sync body at d 256."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
    g = torch.Generator(device=cuda).manual_seed(1)
    BH, Sq, Skv = 4 * G, 64, 128
    q = torch.randn(BH, Sq, d, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(BH // G, Skv, d, generator=g, device=cuda)
    v = torch.randn(BH // G, Skv, d, generator=g, device=cuda)
    pad = 1 if body == "mma" and d == 256 else 0
    kv = []
    for t in (k, v):
        near = (t[:, :1] + 0.01 * t).to(torch.bfloat16)
        buf = torch.zeros(near.numel() + pad, dtype=torch.bfloat16, device=cuda)
        kv.append(buf[pad:].view(near.shape).copy_(near))
    k, v = kv
    dout = torch.randn(BH, Sq, d, generator=g, device=cuda).to(torch.bfloat16)
    out, lse = FA.flash_attention(q, k, v, q_per_kv=G, return_lse=True)
    kernels.reset_launch_counts()
    dq, dk, dv = FAB.flash_attention_bwd(q, k, v, out, lse, dout, q_per_kv=G)
    assert kernels.launches_by_body()["flash_attention_bwd"][body] == 1
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    kr, vr = (t.repeat_interleave(G, dim=0) for t in (kd, vd))
    od = torch.softmax(qd @ kr.transpose(1, 2) * d ** -0.5, dim=-1) @ vr
    want = torch.autograd.grad(od, (qd, kd, vd), dout.double())
    rel = lambda a, b: float((a.double() - b).norm() / b.norm())
    record_property("dq_rel", rel(dq, want[0]))     # the reading, in --junitxml's report
    assert rel(dq, want[0]) < (0.2 if body == "tma" else 0.05), rel(dq, want[0])
    assert rel(dk, want[1]) < 2.0 ** -8 and rel(dv, want[2]) < 2.0 ** -8, \
        (rel(dk, want[1]), rel(dv, want[2]))


def test_flash_attention_bwd_refuses_what_is_not_compiled(cuda):
    from repro_torch.kernels import flash_attention_bwd as FAB
    q = torch.randn(2, 16, 48, device=cuda)
    lse = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="not compiled"):
        FAB.flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.randn(2, 16, 64, device=cuda).half()
    with pytest.raises(TypeError):
        FAB.flash_attention_bwd(q, q, q, q, torch.zeros(2, 16, device=cuda), q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_and_grouped_matmul_backward_launch_their_kernels(cuda, dtype):
    """K1-bwd and K4-bwd: two launches of their kernel each, against the
    plain products; K4's dW (K = cap) on the body the counters report."""
    from repro_torch import kernels
    from repro_torch.kernels import gemm as G, moe_gmm, ops
    a = torch.randn(96, 160, device=cuda).to(dtype).requires_grad_()
    b = torch.randn(160, 64, device=cuda).to(dtype).requires_grad_()
    dc = torch.randn(96, 64, device=cuda).to(dtype)
    out = ops.matmul(a, b)
    kernels.reset_launch_counts()
    da, db = torch.autograd.grad(out, (a, b), dc)
    assert kernels.launch_counts()["gemm"] == 2
    torch.testing.assert_close(da.float(), G.gemm_plain(dc, b.detach().t()).float(), **_tol(dtype))
    torch.testing.assert_close(db.float(), G.gemm_plain(a.detach().t(), dc).float(), **_tol(dtype))
    # the MoE's prefill cap (dW at K 160: the short-K ring), and a ragged cap
    # of 24 with d_in 96 (dX rows and dW rows not multiples of 64)
    for cap, d_in, d_out in ((160, 128, 96), (24, 96, 160)):
        x = torch.randn(8, cap, d_in, device=cuda).to(dtype).requires_grad_()
        w = (torch.randn(8, d_in, d_out, device=cuda) * 0.1).to(dtype).requires_grad_()
        dy = torch.randn(8, cap, d_out, device=cuda).to(dtype)
        out = ops.grouped_matmul(x, w)
        kernels.reset_launch_counts()
        dx, dw = torch.autograd.grad(out, (x, w), dy)
        assert kernels.launch_counts()["grouped_matmul"] == 2
        body = kernels.launches_by_body()["grouped_matmul"]
        assert sum(body.values()) == 2 and (body["tma"] == 2) == (dtype == torch.bfloat16)
        plain = moe_gmm.grouped_matmul_plain
        torch.testing.assert_close(dx.float(), plain(dy, w.detach().transpose(1, 2)).float(),
                                   **_tol(dtype))
        torch.testing.assert_close(
            dw.float(), plain(x.detach().transpose(1, 2), dy, out_dtype=torch.float32),
            **_tol(dtype))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "rwkv6-3b", "zamba2-1.2b",
                                  "internvl2-1b", "seamless-m4t-medium"])
def test_train_step_reduced_on_the_card_launches_exactly(cuda, arch):
    """One reduced train step through ``launch/train.py``'s loop: with remat
    K2 runs twice an attention call and K2-bwd once (attention calls are
    layers for the dense, MoE and VLM families, the shared block's sites for
    zamba2, the encoder's layers and the decoder's self and cross passes for
    the encoder-decoder), every one on the ``mma`` body (bf16, head dim
    below 256); the MoE's expert products three times forward, three times
    again in the recompute and six times in the backward; RWKV6's WKV scan
    (K5) twice a layer and K5-bwd once.  Finite loss and gradient norm."""
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as TL
    from repro_torch.launch.common import launch_config
    from repro_torch.models import attention_calls, build_model
    cfg = launch_config(arch, reduced=True)
    api = build_model(cfg)
    tcfg = TrainConfig(total_steps=1, warmup_steps=1)
    kernels.reset_launch_counts()
    res = TL.run(api, tcfg, 1, 2, 64, cuda, log=lambda line: None)
    L, A = cfg.n_layers, attention_calls(cfg)
    rwkv = cfg.family == "ssm"
    assert res.launches["flash_attention"] == 2 * A
    assert res.launches["flash_attention_bwd"] == A
    assert res.launches["grouped_matmul"] == (12 * L if cfg.family == "moe" else 0)
    assert res.launches["wkv6"] == (2 * L if rwkv else 0)
    assert res.launches["wkv6_bwd"] == (L if rwkv else 0)
    body = kernels.launches_by_body()
    assert body["flash_attention"] == {"tma": 0, "mma": 2 * A, "f32": 0}
    assert body["flash_attention_bwd"] == {"tma": 0, "mma": A, "f32": 0}
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in res.history)
    assert torch.isfinite(torch.tensor(res.history[0]["grad_norm"]))


def test_train_main_on_the_card_restores_in_place_and_replays(cuda, tmp_path, monkeypatch):
    """The reduced model trained on the card through ``launch.train.main``:
    a checkpoint at step 2, the third step fails after its in-place update,
    the driver restores the checkpoint into the live tensors (on the card,
    at the same addresses) and replays; the losses match the uninterrupted
    run at 1e-5 relative, and a second ``main`` resumes from step 2."""
    from repro_torch.ckpt import checkpoint as C, manager as M
    from repro_torch.launch import train as TL
    from repro_torch.train import train_step as TS
    args = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "64", "--save-every", "2"]
    whole = TL.main(args + ["--ckpt-dir", str(tmp_path / "whole")])
    real_step, real_restore = TS.make_train_step, M.CheckpointManager.restore_latest
    calls, restored = {"n": 0}, []

    def make(api, tcfg):
        step = real_step(api, tcfg)

        def failing(state, batch):
            out = step(state, batch)
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("injected failure after the update")
            return out
        return failing

    def restore_latest(self, target_tree=None, shardings=None, device="cuda"):
        ptrs = [t.data_ptr() for t in C.leaves(target_tree)]
        tree, step = real_restore(self, target_tree, shardings, device)
        if tree is not None:
            restored.append((ptrs, [(t.data_ptr(), t.device.type) for t in C.leaves(tree)]))
        return tree, step

    monkeypatch.setattr(TS, "make_train_step", make)
    monkeypatch.setattr(M.CheckpointManager, "restore_latest", restore_latest)
    res = TL.main(args + ["--ckpt-dir", str(tmp_path / "failed")])
    assert [e.kind for e in res.events] == ["restart"]
    assert C.list_steps(tmp_path / "failed" / "qwen2.5-3b-reduced") == [2]
    assert len(restored) == 1
    ptrs, after = restored[0]
    assert [p for p, _ in after] == ptrs and {d for _, d in after} == {"cuda"}
    torch.testing.assert_close(torch.tensor([h["loss"] for h in res.history]),
                               torch.tensor([h["loss"] for h in whole.history]),
                               rtol=1e-5, atol=0)
    monkeypatch.setattr(TS, "make_train_step", real_step)
    again = TL.main(args + ["--ckpt-dir", str(tmp_path / "failed")])
    assert len(again.history) == 1 and int(again.state.opt_state.step) == 3
    torch.testing.assert_close(again.history[0]["loss"], whole.history[2]["loss"],
                               rtol=1e-5, atol=0)


def test_mesh_train_step_over_a_world_1_nccl_group_equals_the_unsharded_step(cuda, tmp_path):
    """``jit_train_step`` on a 1x1 mesh over a world-1 NCCL process group
    (``file://`` store): two reduced qwen2.5-3b steps under megatron_tp, the
    same losses and parameters, bit for bit, as the unsharded step from the
    same seed, with K2 twice a layer and K2-bwd once a layer each step."""
    import datetime

    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import train as TL
    from repro_torch.launch.common import launch_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import megatron_tp_plan
    from repro_torch.train import train_step as TS
    cfg = launch_config("qwen2.5-3b", reduced=True)
    api, tcfg = build_model(cfg), TrainConfig(total_steps=2, warmup_steps=1)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batches = [TL.to_device(source.batch_at(i, 2, 64), cuda) for i in range(2)]
    plain, want = TS.init_state(api, tcfg, device=cuda), []
    step = TS.make_train_step(api, tcfg)
    for b in batches:
        plain, m = step(plain, b)
        want.append(float(m["loss"]))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(1, 1)
        assert mesh.device_mesh.device_type == "cuda"
        sh = TS.state_shardings(api, tcfg, megatron_tp_plan(), mesh)
        state = TS.init_state(api, tcfg, device=cuda, shardings=sh)
        sharded = TS.jit_train_step(api, tcfg, megatron_tp_plan(), mesh, batches[0])
        kernels.reset_launch_counts()
        got = []
        for b in batches:
            state, m = sharded(state, b)
            got.append(float(m["loss"]))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
    assert got == want
    from repro_torch.ckpt.checkpoint import leaves
    for a, b in zip(leaves(state.params), leaves(plain.params)):
        assert torch.equal(a, b)
    L = cfg.n_layers
    assert launches["flash_attention"] == 2 * 2 * L
    assert launches["flash_attention_bwd"] == 2 * L


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)])
def test_mesh_train_step_over_two_gloo_ranks_on_the_card(cuda, tmp_path, mesh_shape):
    """Two ranks on the one card over ``gloo`` (which carries CUDA tensors;
    NCCL refuses two ranks on one device): reduced models in float32
    through ``jit_train_step`` with the card's kernels, two steps, each
    rank's losses within 1e-5 relative of the unsharded step on the card;
    K2 / K2-bwd launched on each rank; the MoE through its expert-parallel
    branch with 4 of 8 experts a rank on 1x2; shards within 1e-5 of the
    matching slices of the unsharded state."""
    from dataclasses import replace

    from repro_torch.ckpt import checkpoint as C
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import train as TL
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import train_step as TS
    from torch_mesh_worker import plan_named, spawn
    tc = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
    cases = [("qwen2.5-3b", "megatron_tp"), ("qwen2.5-3b", "zero3")]
    if mesh_shape == (1, 2):
        cases.append(("qwen3-moe-30b-a3b", "expert_parallel"))
    want, jobs = {}, []
    for arch, plan in cases:
        cfg = replace(get_config(arch).reduced(), compute_dtype="float32", kernels="cuda")
        api, tcfg = build_model(cfg), TrainConfig(**tc)
        source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
        batches = [TL.to_device(source.batch_at(i, 4, 64), cuda) for i in range(2)]
        state = TS.init_state(api, tcfg, device=cuda)
        torch.save(C.map_leaves(lambda t: t.cpu(), state), tmp_path / f"state-{arch}.pt")
        torch.save([{k: v.cpu() for k, v in b.items()} for b in batches], tmp_path / "batches.pt")
        step, losses = TS.make_train_step(api, tcfg), []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        want[arch, plan] = (api, tcfg, losses, state)
        jobs.append({"name": f"{arch}-{plan}", "arch": arch, "plan": plan,
                     "state": f"state-{arch}.pt", "steps": 2})
    spawn({"mode": "train", "mesh": list(mesh_shape), "cases": jobs, "tcfg": tc,
           "device": "cuda", "kernels": "cuda"}, tmp_path)
    for arch, plan in cases:
        api, tcfg, losses, state = want[arch, plan]
        L = api.cfg.n_layers
        for rank in range(2):
            got = torch.load(tmp_path / f"{arch}-{plan}.rank{rank}.pt", weights_only=False,
                             map_location="cpu")
            assert [h["loss"] for h in got["history"]] == pytest.approx(losses, rel=1e-5)
            assert got["launches"]["flash_attention"] == 2 * 2 * L
            assert got["launches"]["flash_attention_bwd"] == 2 * L
            mesh = SH.Mesh(("data", "model"), mesh_shape, rank=rank)
            sh = dict(C._flatten_with_paths(TS.state_shardings(api, tcfg, plan_named(plan), mesh),
                                            is_leaf=lambda x: isinstance(x, SH.Sharding)))
            mine = dict(C._flatten_with_paths(got["state"]))
            for k, w in C._flatten_with_paths(state.params):
                torch.testing.assert_close(mine["0/" + k], sh["0/" + k].local(w.cpu()),
                                           rtol=0, atol=1e-5, msg=lambda m: f"{plan} {k}: {m}")
            if arch.startswith("qwen3-moe"):
                E = api.cfg.n_experts
                assert set(got["ep_trace"]) == {(rank * E // 2, E // 2)}
                assert got["launches"]["grouped_matmul"] == 2 * 12 * L


def test_mesh_serve_over_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two ranks on the one card over ``gloo`` (a 1x2 mesh): reduced
    qwen2.5-3b (2 kv heads) in float32 through ``jit_serve_step`` with the
    card's kernels, four decode steps from a 3-token prompt in a 16-key
    buffer, so rank 1's half of the cache holds no valid key.  Under
    kv_sequence_split every layer of every step launches K3's partials
    kernel and K3' on each rank and never the one-launch K3; under pure_dp
    the reverse.  Each rank's logits within 1e-4 of the unsharded decode on
    the card, its cache slice equal to the unsharded cache's."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import serve_step as SS
    from torch_mesh_worker import plan_named, spawn
    cfg = replace(get_config("qwen2.5-3b").reduced(n_kv_heads=2), compute_dtype="float32",
                  kernels="cuda")
    api = build_model(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, cfg.vocab_size, (2, 7), generator=gen)
    cache = api.init_cache(cfg, 2, 16, dtype=torch.float32, device=cuda)
    with torch.no_grad():
        _, cache = api.prefill(params, tokens[:, :3].to(cuda), cache)
        start = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in cache.items()}
        want = []
        for t in range(3, 7):
            out, cache = api.decode_step(params, tokens[:, t:t + 1].to(cuda), cache)
            want.append(out)
    to_cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t
    torch.save({"params": {k: v for k, v in _tree_cpu(params).items()},
                "cache": {k: to_cpu(v) for k, v in start.items()},
                "ids": [tokens[:, t:t + 1] for t in range(3, 7)]}, tmp_path / "data.pt")
    plans = ("kv_sequence_split", "pure_dp")
    jobs = [{"name": p, "arch": "qwen2.5-3b", "plan": p, "data": "data.pt",
             "reduced": {"n_kv_heads": 2}} for p in plans]
    spawn({"mode": "serve", "mesh": [1, 2], "cases": jobs, "device": "cuda",
           "kernels": "cuda"}, tmp_path)
    n = cfg.n_layers * 4
    for p in plans:
        for rank in range(2):
            got = torch.load(tmp_path / f"{p}.rank{rank}.pt", weights_only=False)
            for s in range(4):
                torch.testing.assert_close(got["logits"][s].cpu(), want[s].cpu(), rtol=0,
                                           atol=1e-4)
            mesh = SH.Mesh(("data", "model"), (1, 2), rank=rank)
            c_sh = SS.cache_shardings(api, cache, plan_named(p), mesh)
            for k, t in got["cache"].items():
                torch.testing.assert_close(t.cpu(), c_sh[k].local(cache[k]).cpu(), rtol=0,
                                           atol=1e-4)
            launches = got["launches"]
            split = p == "kv_sequence_split"
            assert launches["flash_decode_partials"] == launches["flash_decode_combine"] \
                == (n if split else 0), (p, launches)
            assert launches["flash_decode"] == (0 if split else n), (p, launches)


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def test_dry_run_cell_runs_on_the_card(cuda, tmp_path):
    """``launch.dryrun.run_cell`` as rank 0 of a 256-rank ``fake`` world on
    the card: reduced qwen2.5-3b at a small decode cell; the row has a
    measured time and peak, and the kernels launched are counted."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    script = (
        "import sys\n"
        "from pathlib import Path\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch import dryrun\n"
        "registry.ARCHS['qwen2.5-3b'] = registry.ARCHS['qwen2.5-3b'].reduced()\n"
        "registry.SHAPES['decode_32k'] = ShapeConfig('decode_32k', 256, 128, 'decode')\n"
        "dryrun.run_cell('qwen2.5-3b', 'decode_32k', False, out_dir=Path(sys.argv[1]))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"), REPRO_PLANNER_WORKERS="1",
               REPRO_PLAN_CACHE_DIR=str(tmp_path / "plancache"))
    r = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    row = json.loads((tmp_path / "qwen2.5-3b_decode_32k_32x8.json").read_text())
    assert row["device"].startswith("cuda") and row["measured_ms"] > 0
    assert row["per_device_bytes"] > 0 and row["fits_hbm"] is True
    assert row["counted"]["kernel_flops"] > 0 and row["counted"]["by_kernel"]


def test_serve_one_sequence_on_the_card_matches_the_plain_path(cuda):
    """Batch 1: the permuted query's reshape is a view, not a copy; the
    kernel path still takes it (prefill through K2, decode through K3) and
    matches the plain path."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("qwen2.5-3b").reduced(), compute_dtype="float32", kernels="cuda")
    api, plain = build_model(cfg), build_model(replace(cfg, kernels="plain"))
    params = api.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(1, cfg.vocab_size, (1, 24), generator=torch.Generator().manual_seed(0))
    outs = []
    for a in (api, plain):
        cache = a.init_cache(cfg, 1, 32, dtype=torch.float32, device=cuda)
        with torch.no_grad():
            first, cache = a.prefill(params, tokens[:, :20].to(cuda), cache)
            step, _ = a.decode_step(params, tokens[:, 20:21].to(cuda), cache)
        outs.append((first, step))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# the attention blocks of the families split over the sequence: batch x heads,
# q_per_kv, Sq, Skv, head dim, causal, q_offset
FAMILY_BLOCKS = [(4 * 14, 7, 384, 768, 64, True, 384),   # internvl2-1b: rank 1 of 2 of [256; 512]
                 (4 * 16, 1, 512, 1024, 64, False, 0),   # seamless's encoder: 512 of 1024 frames
                 (4 * 16, 1, 256, 1024, 64, False, 0),   # its cross-attention: 256 tokens
                 (4 * 32, 8, 256, 512, 128, True, 256),  # qwen3-moe under tp2d: rank 1 of 2
                 # chunked prefill: a chunk's queries at the cache's index over
                 # the keys ahead of it (qwen2.5-3b's second and third chunks of
                 # 128, 128, 256; qwen3-moe's second of 256, 256)
                 (4 * 16, 8, 128, 256, 128, True, 128),
                 (4 * 16, 8, 256, 512, 128, True, 256),
                 (4 * 32, 8, 256, 512, 128, True, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FAMILY_BLOCKS)
def test_flash_attention_kernels_at_the_split_families_blocks(cuda, case, dtype):
    """K2 and K2-bwd through ``ops.attention`` at a rank's block of the
    VLM's combined sequence (causal, at its offset), of the
    encoder-decoder's frames and prompt (no mask, against every gathered
    key) and of the MoE's prompt, and at a later chunk of a chunked
    prefill (causal, at the cache's index), against their plain versions."""
    from repro_torch.kernels import flash_attention as FA, ops
    BH, g, Sq, Skv, d, causal, off = case
    gen = torch.Generator(device=cuda).manual_seed(BH + Sq + Skv)
    q = torch.randn(BH, Sq, d, generator=gen, device=cuda).to(dtype).requires_grad_()
    k = torch.randn(BH // g, Skv, d, generator=gen, device=cuda).to(dtype).requires_grad_()
    v = torch.randn(BH // g, Skv, d, generator=gen, device=cuda).to(dtype).requires_grad_()
    dout = torch.randn(BH, Sq, d, generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, q_per_kv=g, **({"q_offset": off} if off else {}))
    got = ops.attention(q, k, v, **kw)
    grads = torch.autograd.grad(got, (q, k, v), dout)
    want = FA.flash_attention_plain(q, k, v, **kw)
    plain = torch.autograd.grad(want, (q, k, v), dout)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    for a, b in zip(grads, plain):
        torch.testing.assert_close(a.float(), b.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 24, 128, 64), (128, 160, 2048, 768),
                                   (64, 160, 1024, 768), (64, 160, 768, 1024)])
def test_grouped_matmul_on_a_rank_buffer(cuda, shape, dtype):
    """K4 and K4-bwd through ``ops.grouped_matmul`` on a rank's expert
    buffer of ``min(capacity, tokens)`` rows (a reduced MoE's 24; the
    full MoE's 160; under tp2d on 2x2 a rank's 64 experts over its half
    of the embed channels, gate and up from it, down into it), against the
    plain grouped products."""
    from repro_torch.kernels import moe_gmm, ops
    E, rows, d_in, d_out = shape
    gen = torch.Generator(device=cuda).manual_seed(E + rows)
    x = (torch.randn(E, rows, d_in, generator=gen, device=cuda) * d_in ** -0.5).to(dtype)
    w = torch.randn(E, d_in, d_out, generator=gen, device=cuda).to(dtype)
    dy = torch.randn(E, rows, d_out, generator=gen, device=cuda).to(dtype)
    x.requires_grad_()
    w.requires_grad_()
    got = ops.grouped_matmul(x, w)
    grads = torch.autograd.grad(got, (x, w), dy)
    want = moe_gmm.grouped_matmul_plain(x, w)
    plain = torch.autograd.grad(want, (x, w), dy)
    tol = _tol(dtype) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    for a, b in zip(grads, plain):
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_moe_split_over_the_sequence_on_the_card(cuda, tmp_path, mesh_shape):
    """``moe_mlp`` under sequence_parallel on ``gloo`` ranks of the one card,
    through K4 (reduced qwen3-moe-30b-a3b, capacity factor 0.5, float32):
    each rank's output block within 1e-4 of the unsharded pass on the
    card, its kept (token, slot) pairs equal, the router's gradient within
    1e-4 of its largest entry, and only the counts all-gathered."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from torch_mesh_worker import spawn
    extra = {"capacity_factor": 0.5, "router_aux_weight": 1.0}
    cfg = replace(get_config("qwen3-moe-30b-a3b").reduced(**extra), compute_dtype="float32",
                  kernels="cuda")
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    gen = torch.Generator().manual_seed(0)
    arr = lambda *s: torch.randn(s, generator=gen) * 0.2
    data = {"x": arr(4, 16, d), "c": arr(4, 16, d),
            "p": {"router": arr(d, E), "w_gate": arr(E, d, f), "w_up": arr(E, d, f),
                  "w_down": arr(E, f, d)}}
    torch.save(data, tmp_path / "moe.pt")
    p = {k: v.to(cuda).requires_grad_() for k, v in data["p"].items()}
    moe.DISPATCH_TRACE = []
    y, aux = moe.moe_mlp(p, data["x"].to(cuda), cfg)
    (torch.sum(y * data["c"].to(cuda)) + aux).backward()
    trace, moe.DISPATCH_TRACE = moe.DISPATCH_TRACE, None
    keep = trace[0]["keep"].view(4, 16, -1).cpu()
    assert not keep.all()
    spawn({"mode": "families", "mesh": list(mesh_shape), "device": "cuda", "kernels": "cuda",
           "tcfg": {}, "cases": [{"name": "moe", "kind": "moe", "arch": "qwen3-moe-30b-a3b",
                                  "plan": "sequence_parallel", "reduced": extra,
                                  "data": "moe.pt"}]}, tmp_path)
    for rank in range(mesh_shape[0] * mesh_shape[1]):
        got = torch.load(tmp_path / f"moe.rank{rank}.pt", weights_only=False,
                         map_location="cpu")
        dp, m = got["coords"]["data"], got["coords"]["model"]
        rows = slice(dp * 4 // mesh_shape[0], (dp + 1) * 4 // mesh_shape[0])
        cols = slice(m * 8, (m + 1) * 8)
        torch.testing.assert_close(got["y"], y.detach().cpu()[rows, cols], rtol=1e-4, atol=1e-4)
        assert torch.equal(got["keep"][0].cpu(), keep[rows, cols].reshape(-1, keep.shape[-1]))
        scale = float(p["router"].grad.abs().max())
        torch.testing.assert_close(got["router_grad"].cpu(), p["router"].grad.cpu(), rtol=0,
                                   atol=1e-4 * scale)
        counts = 4.0 * 4 * mesh_shape[1] * E
        assert got["gathered"] == {"data": counts, "model": counts}


# K3's TMA body at d 256: (batch x query heads, q_per_kv, buffer, valid keys)
D256_TMA_DECODE = [(64, 1, 545, 513), (16, 1, 545, 1), (32, 2, 545, 31), (16, 8, 545, 513),
                   (32, 16, 4200, 4096), (16, 16, 545, 1), (8, 2, 4200, 4096), (64, 8, 300, 31)]


@pytest.mark.parametrize("case", D256_TMA_DECODE)
def test_flash_decode_tma_body_at_d256(cuda, case):
    """K3's TMA body (aligned bf16 at d 256) on the cache's strided view: the
    one-launch decode at the split count ``ops.flash_decode`` chooses and at
    1, 3 and 8 splits, and the partials epilogue at its own count and at 16,
    each against its plain version (the partials through the exact float32
    combine), every launch on the TMA body; G 1 to 16, valid 1 to 4,096."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_decode as FD, ops
    BH, g, T, valid = case
    gen = torch.Generator(device=cuda).manual_seed(BH + g + valid)
    q = torch.randn(BH, 1, 256, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(1, T, BH // g, 256, generator=gen, device=cuda).to(torch.bfloat16)
            .permute(0, 2, 1, 3) for _ in range(2))
    assert FD.body_for(q, k, v, g) == "tma"
    want = FD.flash_decode_plain(q, k, v, kv_valid_len=valid, q_per_kv=g)
    kernels.reset_launch_counts()
    for splits in (None, 1, 3, 8):
        got = ops.flash_decode(q, k, v, kv_splits=splits, kv_valid_len=valid, q_per_kv=g)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_tol(torch.bfloat16))
    for splits in (None, 16):
        m, l, acc = ops.flash_decode_partials(q, k, v, kv_splits=splits, kv_valid_len=valid,
                                              q_per_kv=g)
        n = m.shape[1]
        mp, lp, accp = FD.flash_decode_partials_plain(q, k, v, kv_splits=n, kv_valid_len=valid,
                                                      q_per_kv=g)
        torch.cuda.synchronize()
        torch.testing.assert_close(FD.combine_partials_plain(m, l, acc),
                                   FD.combine_partials_plain(mp, lp, accp),
                                   **_tol(torch.bfloat16))
        # a split past the valid keys is (-1e30, 0, 0) in both
        torch.testing.assert_close(l == 0, lp == 0)
    assert kernels.launches_by_body()["flash_decode"] == {"tma": 6, "mma": 0, "f32": 0}
    counts = kernels.launch_counts()
    assert counts["flash_decode"] == 4 and counts["flash_decode_partials"] == 2


def test_flash_decode_tma_body_at_gemmas_decode_fills_one_wave(cuda):
    """gemma-7b's decode step: 64 groups in 2 splits, 128 blocks in one wave
    of one block an SM; the result is the plain one and a second call is
    bit-equal (no atomics)."""
    from repro_torch.kernels import flash_decode as FD, ops
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    q = torch.randn(64, 1, 256, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(4, 545, 16, 256, device=cuda).to(torch.bfloat16).permute(0, 2, 1, 3)
            for _ in range(2))
    splits = FD.choose_splits(513, 64, sms, FD.MAX_CLUSTER_SPLITS, FD.body_for(q, k, v))
    assert 64 * splits <= sms < 64 * (splits + 1)
    got = ops.flash_decode(q, k, v, kv_valid_len=513)
    again = ops.flash_decode(q, k, v, kv_valid_len=513)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = FD.flash_decode_plain(q, k, v, kv_valid_len=513)
    torch.testing.assert_close(got.float(), want.float(), **_tol(torch.bfloat16))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 9, 16, 64, 65, 130])
@pytest.mark.parametrize("rows,d", [(64, 128), (8192, 128), (37, 256), (5, 33)])
def test_combine_kernel_with_empty_splits(cuda, rows, d, splits, out_dtype):
    """K3' against its plain version on partials with an empty split
    (-1e30, 0, 0) in every eighth row and one row all empty (output 0):
    16-byte vectors where d allows them (d 128, 256), scalar columns else
    (d 33); more than one window of 64 splits (65, 130) too."""
    from repro_torch.kernels import flash_decode as FD
    gen = torch.Generator(device=cuda).manual_seed(rows + d + splits)
    m = torch.randn(rows, splits, 1, 1, generator=gen, device=cuda) * 4
    l = torch.rand(rows, splits, 1, 1, generator=gen, device=cuda) + 0.5
    acc = torch.randn(rows, splits, 1, d, generator=gen, device=cuda)
    m[::8, 0], l[::8, 0], acc[::8, 0] = -1e30, 0.0, 0.0
    m[3], l[3], acc[3] = -1e30, 0.0, 0.0
    got = FD.combine_partials(m, l, acc, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = FD.combine_partials_plain(m, l, acc, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.all(got[3] == 0)
    torch.testing.assert_close(got.float(), want.float(), **_tol(out_dtype))
