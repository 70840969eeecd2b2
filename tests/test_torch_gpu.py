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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(4, 1, 256, 256, 64, False), (4, 1, 256, 256, 64, True),
                                  (2, 1, 128, 384, 64, False), (8, 4, 100, 100, 32, True),
                                  (16, 8, 512, 512, 128, True)])
def test_flash_attention_kernel_every_tile(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as FA
    BH, g, Sq, Skv, d, causal = case
    q = torch.randn(BH, Sq, d, device=cuda).to(dtype)
    k = torch.randn(1, Skv, BH // g, d, device=cuda).to(dtype).permute(0, 2, 1, 3)
    v = torch.randn(1, Skv, BH // g, d, device=cuda).to(dtype).permute(0, 2, 1, 3)
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
                                  (16, 8, 545, 0, 128, 2)])
def test_flash_decode_kernels(cuda, case, dtype):
    from repro_torch.kernels import flash_decode as FD, ops
    BH, g, Skv, valid, d, splits = case
    q = torch.randn(BH, 1, d, device=cuda).to(dtype)
    k = torch.randn(1, Skv, BH // g, d, device=cuda).to(dtype).permute(0, 2, 1, 3)
    v = torch.randn(1, Skv, BH // g, d, device=cuda).to(dtype).permute(0, 2, 1, 3)
    got = ops.flash_decode(q, k, v, kv_splits=splits, kv_valid_len=valid, q_per_kv=g)
    torch.cuda.synchronize()
    want = FD.flash_decode_plain(q, k, v, kv_valid_len=valid, q_per_kv=g)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_serve_reduced_on_the_card_matches_the_plain_path(cuda):
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = serve.serve_config("qwen2.5-3b", reduced=True)
    api = build_model(cfg)
    params = serve.load_params(api, cuda, seed=0)
    prompts = serve.make_prompts(cfg, 2, 64, cuda)
    kernels.reset_launch_counts()
    res = serve.generate(api, params, prompts, 8, keep_step_logits=True)
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    assert kernels.launch_counts()["flash_decode_partials"] == cfg.n_layers * 8
    ref = serve.generate(build_model(replace(cfg, kernels="plain")), params, prompts, 8,
                         keep_step_logits=True, forced_ids=res.generated)
    for a, b in zip([res.prefill_logits, *res.step_logits],
                    [ref.prefill_logits, *ref.step_logits]):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)


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
    from repro_torch.launch import serve
    from repro_torch.models import build_model, moe
    cfg = serve.serve_config("qwen3-moe-30b-a3b", reduced=True)
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


def test_python_footprints_mirror_the_compiled_kernels(cuda):
    """The shared-memory formulas the planner prunes with are the kernels' own."""
    from repro_torch.kernels import _build, flash_attention as FA, gemm as G
    lib = _build.lib()
    for tile in G.COMPILED_TILES:
        assert lib.repro_gemm_smem_bytes(*tile, 1) == G.gemm_smem_bytes(*tile, 2)
        assert lib.repro_gemm_smem_bytes(*tile, 0) == G.gemm_smem_bytes(*tile, 4)
    for d in FA.COMPILED_HEAD_DIMS:
        for tile in FA.COMPILED_TILES:
            assert lib.repro_flash_smem_bytes_bf16(*tile, d) == FA.flash_smem_bytes(*tile, d, 2)
            assert lib.repro_flash_smem_bytes_f32(*tile, d) == FA.flash_smem_bytes(*tile, d, 4)


def test_gemm_kernel_unaligned_operands_take_the_scalar_path(cuda):
    """K and N that are not multiples of 8 (no 16-byte alignment of rows)."""
    from repro_torch.kernels import gemm as G
    a = torch.randn(70, 45, device=cuda).to(torch.bfloat16)
    b = torch.randn(45, 51, device=cuda).to(torch.bfloat16)
    got = G.gemm(a, b, block=(64, 64, 32), out_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, G.gemm_plain(a, b, out_dtype=torch.float32),
                               rtol=2e-2, atol=2e-2)
