"""The port's four examples (``examples/torch_*.py``), each in a process of
its own on the CPU, with fast search and a plan store of its own:

* ``torch_quickstart`` prints the reference quickstart's text line for line
  (both plan on the text-copied planner and the Wormhole model), but for
  the search's wall time (``plan_time=``);
* ``torch_serve_decode --device cpu`` serves its reduced gemma and exits 0.
  Its ids are not held against ``serve_decode.py``'s: the reference's serve
  prefill is not causal (ROADMAP Queue 3), the port's is;
* ``torch_train_lm --device cpu`` trains 3 steps with a checkpoint after
  step 2, and a second run into the same directory resumes from it;
* ``torch_plan_explorer qwen2.5-3b`` prints the plan chosen for each of the
  three shapes and the TileLoom view of the train plan.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, tmp_path, store="store"):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_FAST_SEARCH="1",
               REPRO_PLANNER_WORKERS="1", REPRO_PLAN_CACHE_DIR=str(tmp_path / store))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_quickstart_prints_the_reference_text(tmp_path):
    wall = re.compile(r"plan_time=\S+")
    ref = _run("quickstart.py", tmp_path=tmp_path, store="ref").splitlines()
    port = _run("torch_quickstart.py", tmp_path=tmp_path, store="port").splitlines()
    assert len(port) == len(ref) > 30
    assert any("plan_time=" in line for line in port)
    for a, b in zip(port, ref):
        assert wall.sub("plan_time=", a) == wall.sub("plan_time=", b)


def test_serve_decode_runs_on_the_cpu(tmp_path):
    out = _run("torch_serve_decode.py", "--device", "cpu", tmp_path=tmp_path)
    assert "[serve] gemma-7b-reduced on cpu" in out
    assert "decode 24 tok x4" in out
    ids = re.search(r"sample generation \(ids\): \[([^\]]*)\]", out)
    assert ids and len(ids.group(1).split(",")) == 16       # the first 16 of 24


def test_train_lm_saves_and_resumes(tmp_path):
    ck = tmp_path / "ckpt"
    args = ("--device", "cpu", "--steps", "3", "--save-every", "2", "--ckpt-dir", str(ck))
    first = _run("torch_train_lm.py", *args, tmp_path=tmp_path)
    assert "[train] fresh start" in first and "done: 3 steps" in first
    assert (ck / "qwen2.5-3b-reduced" / "step_00000002").is_dir()
    again = _run("torch_train_lm.py", *args, tmp_path=tmp_path)
    assert "[train] resumed from step 2" in again and "done: 1 steps" in again
    loss = lambda out: re.search(r"step +2 loss=(\S+)", out).group(1)
    assert loss(again) == loss(first)


def test_plan_explorer_ranks_on_the_h100_cluster(tmp_path):
    out = _run("torch_plan_explorer.py", "qwen2.5-3b", tmp_path=tmp_path)
    assert "=== qwen2.5-3b (" in out
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert re.search(rf"^{shape} +-> \S+ +dominant=\S+ +est= *[\d.]+ ms/step "
                         rf"hbm= *[\d.]+ GB/chip$", out, re.M), (shape, out)
    assert "TileLoom view of the chosen train plan:" in out
    assert "// TileLoom mapping of C[tokens,ffn]" in out
