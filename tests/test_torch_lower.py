"""Block planning against the H100 description: the planner only ever returns
tile shapes the CUDA kernels are compiled for and that fit a block's shared
memory; repeat shapes are served from the plan registry without planning; an
infeasible request serves the fallback and is counted."""
import pytest
import torch

from repro_torch import plancache
from repro_torch.core import lower_torch as LT
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gemm as G


@pytest.fixture()
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    plancache.reset_store()
    LT.clear_block_caches()
    yield plancache.get_store()
    plancache.reset_store()
    LT.clear_block_caches()


@pytest.fixture()
def counting(monkeypatch):
    calls = {"n": 0}
    real = LT.plan_kernel_multi

    def wrapped(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(LT, "plan_kernel_multi", wrapped)
    return calls


def test_h100_description_matches_the_data_sheet():
    hw = LT.h100_sm()
    assert hw.n_cores == 132
    assert hw.peak_flops() == pytest.approx(989e12, rel=1e-9)
    assert hw.peak_vec_elems_per_core() * 2 * 132 == pytest.approx(67e12, rel=1e-9)
    assert hw.local_capacity() == 227 * 1024 == FA.MAX_SMEM
    assert hw.global_mem.size_bytes == 80e9 and hw.global_mem.bandwidth_gbps == 3350.0
    assert "df.spatial_dim 132" in hw.df_text()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4096, 4096, 4096), (2048, 11008, 2048),
                                   (96, 64, 160)])
def test_gemm_blocks_are_compiled_tiles_and_fit_shared_memory(store, fast_search,
                                                              shape, dtype):
    block = LT.plan_gemm_blocks(*shape, dtype)
    assert block in G.COMPILED_TILES
    assert G.gemm_smem_bytes(*block, LT.dtype_bytes(dtype)) <= G.MAX_STATIC_SMEM
    assert LT.planner_fallback_count() == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4096, 4096, 128), (512, 512, 128), (128, 384, 64),
                                   (256, 256, 32)])
def test_flash_blocks_are_compiled_tiles_and_fit_shared_memory(store, fast_search,
                                                               shape, dtype):
    bq, bkv = LT.plan_flash_blocks(*shape, dtype)
    es = LT.dtype_bytes(dtype)
    assert (bq, bkv) in FA.COMPILED_TILES
    assert FA.flash_smem_bytes(bq, bkv, shape[2], es) <= 227 * 1024
    assert LT.planner_fallback_count() == 0


def test_tile_options_are_pruned_by_the_real_footprint():
    assert LT.flash_tile_options(128, 2) == FA.COMPILED_TILES
    assert (128, 64) not in LT.flash_tile_options(128, 4)      # 232 KB > 227 KB
    assert LT.flash_tile_options(128, 4)
    assert LT.flash_tile_options(96, 2) == ()
    assert LT.gemm_tile_options(2) == G.COMPILED_TILES


def test_gemm_blocks_cold_then_disk_hit(store, counting, fast_search):
    cold = LT.plan_gemm_blocks(1024, 1024, 1024)
    assert counting["n"] == 1
    assert store.n_entries() == 1
    assert LT.resolved_blocks()[("gemm_blocks", (1024, 1024, 1024, 2))] == (cold, "search")
    assert LT.plan_gemm_blocks(1024, 1024, 1024) == cold       # lru tier
    assert counting["n"] == 1
    # "fresh process": drop both in-memory tiers, keep the disk
    LT.clear_block_caches()
    store.clear_memory()
    warm = LT.plan_gemm_blocks(1024, 1024, 1024)
    assert warm == cold
    assert counting["n"] == 1                                   # planner not invoked
    assert store.stats.hits_disk >= 1
    assert LT.resolved_blocks()[("gemm_blocks", (1024, 1024, 1024, 2))] == (cold, "cache")


def test_flash_blocks_cold_then_disk_hit(store, counting, fast_search):
    cold = LT.plan_flash_blocks(1024, 1024, 128)
    LT.clear_block_caches()
    store.clear_memory()
    assert LT.plan_flash_blocks(1024, 1024, 128) == cold
    assert counting["n"] == 1


def test_float32_and_bfloat16_requests_do_not_share_an_entry(store, counting,
                                                             fast_search):
    LT.plan_flash_blocks(512, 512, 128, torch.bfloat16)
    LT.plan_flash_blocks(512, 512, 128, torch.float32)
    assert counting["n"] == 2 and store.n_entries() == 2


def test_infeasible_request_serves_the_fallback_and_counts(store, counting, caplog):
    import logging
    assert LT.planner_fallback_count() == 0
    with caplog.at_level(logging.WARNING, logger=LT.log.name):
        assert LT.plan_flash_blocks(256, 256, 96) == LT.FLASH_FALLBACK   # d not compiled
    assert counting["n"] == 0
    assert LT.planner_fallback_count() == 1
    assert LT.planner_fallback_count("flash_blocks") == 1
    assert any("planner fallback" in r.getMessage() for r in caplog.records)
    LT.clear_block_caches()
    assert LT.planner_fallback_count() == 0


def test_planner_failure_serves_the_fallback_and_counts(store, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("no feasible plan")

    monkeypatch.setattr(LT, "plan_kernel_multi", boom)
    assert LT.plan_gemm_blocks(640, 640, 640) == LT.GEMM_FALLBACK
    assert LT.plan_gemm_blocks(768, 640, 640) == LT.GEMM_FALLBACK
    assert LT.planner_fallback_count("gemm_blocks") == 2
    assert LT.resolved_blocks()[("gemm_blocks", (640, 640, 640, 2))][1] == "fallback"
    assert store.n_entries() == 0                               # nothing persisted
    LT.reset_planner_fallbacks()
    assert LT.planner_fallback_count() == 0


def test_fallback_warns_once_per_cause_but_counts_all(store, caplog):
    import logging
    with caplog.at_level(logging.WARNING, logger=LT.log.name):
        for msg in ("boom", "boom", "other"):
            LT._note_fallback("gemm_blocks", (64, 64, 64), RuntimeError(msg), (64, 64, 16))
    assert LT.planner_fallback_count() == 3
    warned = [r for r in caplog.records if "planner fallback" in r.getMessage()]
    assert len(warned) == 2


def test_ops_matmul_without_a_block_goes_through_the_planner(store, counting,
                                                             fast_search):
    from repro_torch.kernels import ops
    a = torch.randn(256, 192)
    b = torch.randn(192, 320)
    out = ops.matmul(a, b)
    assert counting["n"] == 1
    torch.testing.assert_close(out, a @ b, rtol=1e-4, atol=1e-4)
