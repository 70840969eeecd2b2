"""The port's serving front on the CPU: the plan service's ranking line, the
introspection endpoint scraped during ``--introspect-hold``, the flight
recorder's dump rendered by ``python -m repro_torch.obs incident``, and the
rule that observation changes nothing that is served (ids, kernel launches,
planned blocks)."""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest
import torch

from repro_torch import kernels
from repro_torch.core import lower_torch
from repro_torch.launch import serve
from repro_torch.obs import __main__ as obs_main
from repro_torch.obs import expo, flightrec, slo

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--tokens", "4", "--seed", "1"]
ENDPOINTS = ("/metrics", "/healthz", "/slo", "/plans", "/tenants")
HOLD = re.compile(r"holding introspection open \S+ at (http://\S+)")
RANKING = re.compile(r"^\[serve\] qwen2\.5-3b-reduced: decode plan ranking "
                     r"\(rung=(search|cache) [0-9.]+ms\): \w+(, \w+)*$", re.M)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


class _Watched(io.StringIO):
    """Captured stdout that scrapes every endpoint once the hold line shows."""

    def __init__(self):
        super().__init__()
        self.scraped, self.done = {}, threading.Event()

    def write(self, text):
        m = HOLD.search(text)
        if m is not None and not self.done.is_set():
            self.scraped.update({p: _get(m.group(1) + p) for p in ENDPOINTS})
            self.done.set()
        return super().write(text)


@pytest.fixture()
def observation_off_after(monkeypatch):
    """serve.main arms the process-wide recorder and SLO tracker; put both
    back as they were after the test (and disarm the recorder's exit dump)."""
    monkeypatch.delenv(flightrec.FLIGHTREC_ENV, raising=False)
    monkeypatch.setattr(flightrec.RECORDER, "on", False)
    monkeypatch.setattr(flightrec.RECORDER, "path", None)
    monkeypatch.setattr(slo.TRACKER, "on", False)
    yield
    flightrec.clear()
    slo.clear()


def _served(argv):
    """One serve.main run from cleared in-process block tiers, so that each
    run resolves its blocks again; launch counts read around it."""
    lower_torch.clear_block_caches()
    kernels.reset_launch_counts()
    res = serve.main(argv)
    return res, kernels.launch_counts(), {k: b for k, (b, _) in res.blocks.items()}


def test_observation_changes_nothing_served(tmp_path, observation_off_after, capsys):
    plain, plain_launches, plain_blocks = _served(SMALL)
    capsys.readouterr()
    dump = tmp_path / "fr.json"
    out = _Watched()
    with contextlib.redirect_stdout(out):
        res, launches, blocks = _served(SMALL + [
            "--introspect-port", "0", "--introspect-hold", "0.5",
            "--flightrec", str(dump), "--plan-budget-ms", "10"])
    assert torch.equal(res.generated, plain.generated)
    assert launches == plain_launches and res.launches == plain.launches
    assert blocks == plain_blocks and blocks

    assert out.done.is_set()
    code, ctype, body = out.scraped["/metrics"]
    assert code == 200 and ctype == expo.CONTENT_TYPE
    assert expo.validate_exposition(body) == []
    assert re.search(r'^planservice_requests_total\{(?=.*rung="(search|cache)")'
                     r'(?=.*outcome="ok")', body, re.M)
    assert re.search(r"^plancache_get_total\{", body, re.M)
    code, _, body = out.scraped["/healthz"]
    assert code == 200 and json.loads(body)["ok"] is True
    rep = json.loads(out.scraped["/slo"][2])
    assert rep["enabled"] and rep["rungs"].get("search", 0) + rep["rungs"].get("cache", 0) >= 1
    plans = json.loads(out.scraped["/plans"][2])
    assert {(e["template"], tuple(e["request"])): tuple(e["blocks"])
            for e in plans["resolved"]} == blocks
    assert {"entries", "by_template", "process"} <= set(plans)
    assert json.loads(out.scraped["/tenants"][2]) == {"mode": "model", "tenants": []}

    assert RANKING.search(out.getvalue())
    doc = flightrec.load_dump(str(dump))
    mesh = [e for e in doc["events"] if e["kind"] == "plan_request" and e["mode"] == "mesh"]
    assert [(e["rung"] in ("search", "cache"), e["outcome"], e["deadline_ms"]) for e in mesh] \
        == [(True, "ok", 10.0)]
    assert obs_main.main(["incident", str(dump)]) == 0
    rendered = capsys.readouterr().out
    assert re.search(r"plan_request rung=(search|cache) outcome=ok", rendered)


def test_serve_cli_with_observation_flags(tmp_path, observation_off_after, capsys):
    """The launcher as a user runs it, in its own process: the ranking line,
    a valid /metrics scraped during the hold, a dump that
    ``python -m repro_torch.obs incident`` renders, and the ids printed
    without the flags."""
    plain, _, _ = _served(SMALL)
    capsys.readouterr()
    dump = tmp_path / "fr.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), HOME=str(tmp_path),
               REPRO_PLAN_CACHE_DIR=str(tmp_path / "plancache"),
               REPRO_PLANNER_WORKERS="1", REPRO_FAST_SEARCH="1")
    env.pop(flightrec.FLIGHTREC_ENV, None)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *SMALL,
           "--introspect-port", "0", "--introspect-hold", "2",
           "--flightrec", str(dump), "--plan-budget-ms", "10"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=tmp_path)
    lines, metrics_ = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            m = HOLD.search(line)
            if m is not None:
                metrics_ = _get(m.group(1) + "/metrics")
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    printed = "".join(lines)
    assert rc == 0, printed + proc.stderr.read()
    assert RANKING.search(printed)
    assert metrics_ is not None and metrics_[0] == 200
    assert expo.validate_exposition(metrics_[2]) == []
    ids = re.search(r"sample generation \(ids\): (\[.*\])", printed).group(1)
    assert json.loads(ids) == plain.generated[0, :16].tolist()

    inc = subprocess.run([sys.executable, "-m", "repro_torch.obs", "incident", str(dump)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert inc.returncode == 0, inc.stderr
    assert re.search(r"plan_request rung=(search|cache) outcome=ok", inc.stdout)
