"""The PyTorch port's scaffold: it never imports jax or the reference package,
its framework-free modules are text copies of the reference's, its planner
plans what the reference's plans, and its entry point refuses to run on the
CPU unasked."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

COPIED = (
    [f"configs/{p.name}" for p in sorted((SRC / "repro" / "configs").glob("*.py"))]
    + [f"obs/{n}.py" for n in ("context", "metrics", "trace", "flightrec", "slo", "expo",
                               "explain", "__main__", "__init__")]
    + [f"core/{n}.py" for n in ("affine", "hw", "program", "mapping", "reuse", "plan",
                                "perfmodel", "simulator", "batch_cost", "planner",
                                "templates", "__init__")]
    + ["parallel/search_exec.py"]
    + [f"plancache/{n}.py" for n in ("serialize", "keying", "store", "validate",
                                     "cache", "warmstart", "__init__")]
    + [f"pipeline/{n}.py" for n in ("__init__", "graph", "forwarding", "cost", "planner")]
    + [f"runtime/{n}.py" for n in ("__init__", "faults", "replan", "fault_tolerance")]
    + [f"planservice/{n}.py" for n in ("__init__", "fallback", "family", "service")]
    + [f"tenancy/{n}.py" for n in ("__init__", "partition", "qos", "validator", "runtime")]
)


def test_copied_module_list_is_complete():
    assert len(COPIED) == 61 and len([c for c in COPIED if c.startswith("configs/")]) == 14


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_text_identical_after_rename(rel):
    original = (SRC / "repro" / rel).read_text()
    renamed = re.sub(r"\brepro\.", "repro_torch.", original)
    assert (SRC / "repro_torch" / rel).read_text() == renamed


def test_importing_every_module_loads_neither_jax_nor_reference(tmp_path):
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = ['repro_torch'] + [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'triton'"
        " or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
        "print(len(names)); print(bad)\n"
        "assert not bad, bad\n"
        "assert len(names) > 60, names\n"
        "assert {'repro_torch.models.moe', 'repro_torch.kernels.moe_gmm',\n"
        "        'repro_torch.models.rwkv6', 'repro_torch.kernels.rwkv6',\n"
        "        'repro_torch.models.mamba2', 'repro_torch.models.zamba2',\n"
        "        'repro_torch.models.encdec', 'repro_torch.models.vlm',\n"
        "        'repro_torch.kernels.flash_attention_bwd', 'repro_torch.train.optimizer',\n"
        "        'repro_torch.train.grad_compress', 'repro_torch.train.train_step',\n"
        "        'repro_torch.launch.train', 'repro_torch.launch.common',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.kernels.rwkv6_bwd',\n"
        "        'repro_torch.pipeline.planner', 'repro_torch.planservice.service',\n"
        "        'repro_torch.obs.expo', 'repro_torch.obs.explain',\n"
        "        'repro_torch.obs.__main__', 'repro_torch.runtime.replan',\n"
        "        'repro_torch.runtime.fault_tolerance', 'repro_torch.ckpt.checkpoint',\n"
        "        'repro_torch.ckpt.manager', 'repro_torch.tenancy.partition',\n"
        "        'repro_torch.tenancy.qos', 'repro_torch.tenancy.validator',\n"
        "        'repro_torch.tenancy.runtime', 'repro_torch.parallel.sharding',\n"
        "        'repro_torch.parallel.planner_bridge', 'repro_torch.parallel.spmd',\n"
        "        'repro_torch.launch.mesh', 'repro_torch.runtime.elastic',\n"
        "        'repro_torch.launch.dryrun', 'repro_torch.launch.roofline',\n"
        "        'repro_torch.launch.report', 'repro_torch.train.serve_step',\n"
        "        'repro_torch.kernels.work'} <= set(names)\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "usage:" not in out.stdout + out.stderr      # importing obs.__main__ ran no CLI


def test_no_source_line_imports_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = list((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "kernel_ab.py", "wkv6_bwd_profile.py",
                                 "mesh_probe.py")]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not hits, hits


def test_planner_agrees_with_reference_on_wormhole(fast_search):
    import repro.core as ref_core
    import repro.plancache as ref_pc
    import repro_torch.core as port_core
    import repro_torch.plancache as port_pc

    def plan(core, pc):
        progs = [core.matmul_program(512, 512, 512, bm=bm, bn=bn, bk=bk)
                 for bm, bn, bk in core.block_shape_candidates(512, 512, 512)][:6]
        res = core.plan_kernel_multi(progs, core.get_hw("wormhole_8x8"), profile=False)
        return pc.keying.digest_of(pc.plan_to_dict(res.best.plan)), res.best.cost

    ref_digest, ref_cost = plan(ref_core, ref_pc)
    port_digest, port_cost = plan(port_core, port_pc)
    assert port_digest == ref_digest
    assert port_cost.total_s == ref_cost.total_s
    assert port_cost.dram_bytes == ref_cost.dram_bytes


def test_h100_digest_forks_plan_registry_keys():
    from repro_torch import plancache
    from repro_torch.core import get_hw, lower_torch
    h100 = plancache.hw_digest(lower_torch.h100_sm())
    assert h100 != plancache.hw_digest(get_hw("tpu_v5e_chip"))
    assert h100 != plancache.hw_digest(get_hw("wormhole_8x8"))


def test_serve_main_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main([])


def test_entry_points_without_gpu_raise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    api = build_model(get_config("qwen2.5-3b").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        api.init(torch.Generator().manual_seed(0))


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
