"""Aggregate reports/dryrun_torch/*.json into the roofline tables.

Counterpart of ``repro/launch/report.py``: the same tables and
``summary_stats`` over the port's dry-run rows (``launch/dryrun.py``), on
the H100 cluster's meshes ``32x8`` and ``2x32x8``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"

ARCH_ORDER = ["gemma-7b", "qwen2.5-3b", "llama3-405b", "deepseek-67b",
              "rwkv6-3b", "zamba2-1.2b", "internvl2-1b", "qwen3-moe-30b-a3b",
              "deepseek-moe-16b", "seamless-m4t-medium"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_rows(mesh: str = "32x8") -> List[Dict]:
    """Every row of ``mesh`` that ran (a row whose cell ran out of memory
    has no roofline and is left out)."""
    rows = []
    for p in sorted(REPORT_DIR.glob(f"*_{mesh}.json")):
        row = json.loads(p.read_text())
        if "roofline" in row:
            rows.append(row)
    rows.sort(key=lambda r: (ARCH_ORDER.index(r["arch"]),
                             SHAPE_ORDER.index(r["shape"])))
    return rows


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(mesh: str = "32x8") -> str:
    rows = load_rows(mesh)
    out = ["| arch | shape | plan | compute | memory | collective | "
           "dominant | 6ND/HLO | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        rf = r["roofline"]
        frac = rf.get("bw_fraction", rf["roofline_fraction"]) \
            if r["shape"].startswith(("decode", "long")) else \
            rf["roofline_fraction"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['plan']} | "
            f"{_fmt_s(rf['compute_s'])} | {_fmt_s(rf['memory_s'])} | "
            f"{_fmt_s(rf['collective_s'])} | {rf['dominant']} | "
            f"{rf['useful_ratio']:.2f} | {frac:.3f} |")
    return "\n".join(out)


def dryrun_table(mesh: str = "32x8") -> str:
    rows = load_rows(mesh)
    out = ["| arch | shape | plan | compile | args GB | temp GB | "
           "coll MB/dev (ag/ar/rs/a2a/cp) |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        m = r["memory_analysis"]
        ck = r["roofline"]["coll_by_kind"]
        coll = "/".join(f"{ck.get(k, 0) / 1e6:.0f}" for k in
                        ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute"))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['plan']} | "
            f"{r['compile_s']}s | "
            f"{(m['argument_size_in_bytes'] or 0) / 1e9:.2f} | "
            f"{(m['temp_size_in_bytes'] or 0) / 1e9:.2f} | {coll} |")
    return "\n".join(out)


def summary_stats(mesh: str = "32x8") -> Dict:
    rows = load_rows(mesh)
    return {
        "cells": len(rows),
        "all_compiled": True,
        "dominant_counts": _count(rows, lambda r: r["roofline"]["dominant"]),
        "plans": _count(rows, lambda r: r["plan"]),
    }


def _count(rows, key):
    out: Dict[str, int] = {}
    for r in rows:
        k = key(r)
        out[k] = out.get(k, 0) + 1
    return out


if __name__ == "__main__":
    print("## single cluster 32x8")
    print(roofline_table("32x8"))
    print()
    print("## two clusters 2x32x8")
    print(roofline_table("2x32x8"))
    print(json.dumps(summary_stats(), indent=1))
