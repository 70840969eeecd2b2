"""The port's plan-registry CLI (``python -m repro_torch.plancache``) against
the reference's (``repro.plancache``), under fast search:

* ``warm`` builds the reference's job list (``warmjobs.run_jobs``
  captured in both packages): the same kinds and payloads in the same
  order, from the registry, the benchmark tables, ``--wormhole``,
  ``--faults`` and ``--pipeline``;
* the benchmark tables the port copies equal the ``benchmarks`` package's
  (which imports the reference, so the port reads its own copies);
* the jobs that plan on the text-copied planner and the Wormhole models
  (``wh_gemm``, ``wh_flash``, ``pipeline``, ``fault_gemm``) print the
  reference's lines, each package on a store of its own;
* ``warm`` of one GEMM on the H100 tables, then ``ls``, ``stats``,
  ``stats --json`` and ``prune`` in a temporary store; ``--jobs 2`` leaves
  the entries ``--jobs 1`` leaves, and a fresh request then resolves from
  the store.
"""
import dataclasses
import json

import pytest

from repro import plancache as ref_pc
from repro.plancache import __main__ as ref_cli
from repro.plancache import warmjobs as ref_jobs
from repro_torch import plancache
from repro_torch.core import lower_torch
from repro_torch.plancache import __main__ as cli
from repro_torch.plancache import warmjobs


@pytest.fixture()
def stores(tmp_path, monkeypatch, fast_search):
    """A store directory for each package: ``use(pkg, name)`` points that
    package's process-wide store at ``tmp_path/name``."""
    def use(pc, name):
        monkeypatch.setenv(pc.ENV_DIR, str(tmp_path / name))
        pc.reset_store()
        return pc.get_store()
    monkeypatch.delenv(plancache.ENV_TOGGLE, raising=False)
    lower_torch.clear_block_caches()
    yield use
    lower_torch.clear_block_caches()
    plancache.reset_store()
    ref_pc.reset_store()


def _jobs(cli_mod, jobs_mod, argv, monkeypatch):
    seen = []

    def capture(jobs, n_jobs):
        seen.extend(jobs)
        return []
    monkeypatch.setattr(jobs_mod, "run_jobs", capture)
    assert cli_mod.main(argv) == 0
    return seen


def test_warm_builds_the_reference_job_list(stores, monkeypatch):
    argv = ["warm", "--wormhole", "--faults", "--pipeline", "mlp2:256x128x512"]
    stores(ref_pc, "ref")
    want = _jobs(ref_cli, ref_jobs, argv, monkeypatch)
    stores(plancache, "port")
    got = _jobs(cli, warmjobs, argv, monkeypatch)
    kinds = [k for k, _ in got]
    assert {"gemm", "flash", "mesh", "wh_gemm", "wh_flash", "pipeline", "fault_gemm"} \
        == set(kinds)
    assert got == want
    # the fuller tables on one Wormhole mesh, for two archs, no rankings
    argv = ["warm", "--wormhole", "--full", "--hw", "wormhole_4x8", "--skip-mesh",
            "--archs", "gemma-7b,rwkv6-3b"]
    stores(ref_pc, "ref")
    want = _jobs(ref_cli, ref_jobs, argv, monkeypatch)
    stores(plancache, "port")
    assert _jobs(cli, warmjobs, argv, monkeypatch) == want


def test_copied_benchmark_tables_equal_the_suite():
    from benchmarks import common, flash_table, gemm_table, topk_table
    for full in (False, True):
        assert warmjobs.gemm_shape_table(full) == gemm_table.shape_table(full)
    assert warmjobs.TOPK_SHAPES == topk_table.SHAPES
    assert warmjobs.flash_shape_table() == flash_table.shape_table()
    assert warmjobs.FLASH_TOTAL_TOKENS == flash_table.TOTAL_TOKENS
    assert dataclasses.asdict(warmjobs.DEFAULT_BUDGET) == dataclasses.asdict(
        common.DEFAULT_BUDGET)
    assert warmjobs.HW_CONFIGS == common.HW_CONFIGS


@pytest.mark.parametrize("job", [
    ("wh_gemm", ("wormhole_1x8", (1024, 1024, 4096))),
    ("wh_gemm", ("wormhole_8x8", (4096, 16384, 4096))),
    ("wh_flash", (1024, 512, 64)),
    ("wh_flash", (128, 8192, 64)),
    ("pipeline", ("mlp2:256x128x512", "wormhole_8x8")),
    ("pipeline", ("attn:4x256x256x64", "wormhole_8x8")),
    ("fault_gemm", ("wormhole_8x8", (256, 256, 256), (0, 0))),
    ("fault_gemm", ("wormhole_8x8", (512, 1024, 512), (3, 5))),
], ids=lambda j: j[0])
def test_wormhole_jobs_print_the_reference_lines(job, stores):
    stores(ref_pc, "ref")
    want = ref_jobs.run_job(job)
    stores(plancache, "port")
    assert warmjobs.run_job(job) == want


def _entries(store):
    return sorted((e["key"], tuple(e["payload"]["blocks"])) for e in store.entries())


def test_warm_ls_stats_prune_and_sharded_warm(stores, capsys):
    one = stores(plancache, "one")
    assert cli.main(["warm", "--fast", "--gemm", "512x512x512", "--skip-flash",
                     "--skip-mesh"]) == 0
    out = capsys.readouterr().out
    assert "[warm] gemm 512x512x512 -> blocks (" in out and "1 new entries" in out
    assert cli.main(["ls"]) == 0
    out = capsys.readouterr().out
    assert "gemm_blocks" in out and "hw=h100_sm" in out and "1 entries in" in out
    assert cli.main(["stats"]) == 0
    out = capsys.readouterr().out
    assert "entries: 1" in out and "gemm_blocks: 1" in out and "1 puts" in out
    assert cli.main(["stats", "--json"]) == 0
    blob = json.loads(capsys.readouterr().out)
    assert blob["store"]["entries"] == 1 and "_meta" in blob["metrics"]
    # --jobs 2 leaves the entries --jobs 1 leaves
    argv = ["warm", "--gemm", "768x768x768", "--flash", "512x512x128", "--skip-mesh"]
    assert cli.main(argv + ["--jobs", "1"]) == 0
    capsys.readouterr()
    inline = _entries(one)
    assert len(inline) == 3
    two = stores(plancache, "two")
    lower_torch.clear_block_caches()
    assert cli.main(argv + ["--gemm", "512x512x512", "--jobs", "2"]) == 0
    out = capsys.readouterr().out
    assert "across 2 jobs" in out and out.count("[warm] gemm") == 2
    assert _entries(two) == inline
    # a fresh request at a warmed shape resolves from the store
    two.clear_memory()
    lower_torch.clear_block_caches()
    blocks = lower_torch.plan_gemm_blocks(768, 768, 768)
    assert lower_torch.resolved_blocks()[("gemm_blocks", (768, 768, 768, 2))] \
        == (blocks, "cache")
    assert cli.main(["prune", "--max-entries", "1"]) == 0
    assert "pruned 2 entries; 1 remain" in capsys.readouterr().out
