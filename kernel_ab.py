#!/usr/bin/env python3
"""Time the backward kernels, and the forward GEMMs that share K4's core, of
several checkouts in turns on one card.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` is this one; an older
commit unpacked with ``git archive`` into ``_parent/`` is another).  Each
runs in a fresh process that builds that checkout's kernels into
``TREE/build/ab-kernels`` and runs this checkout's ``chip_smoke.py`` cases
(its timer, shapes and checks) on that checkout's ``repro_torch``, and
prints one JSON line of kernel times; the script prints the card's name and
power limit last.  Name the trees as parent, change, change, parent to see
the drift across the call.  Needs one NVIDIA GPU.

The rows, bf16 unless marked: K2-bwd at the training passes of every attention
family, K4-bwd at the MoE's prefill (with its dX, dW and copy pieces as that
checkout's backward launches them), K1-bwd (with its dA, dB and copy pieces
likewise) and K1 at qwen2.5-3b's projection, K4 at the MoE's four served
shapes, and K5-bwd at every shape ``chip_smoke.py`` times it (rwkv6-3b's
training pass, 160 rows x T 512 x d 64 at chunk 16, in bf16 and float32;
head dims 16 and 32; an odd T at chunk 1; decays at the floor at chunk 32).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one(tree: str) -> dict:
    sys.path.insert(0, HERE)
    import chip_smoke as S             # puts this checkout's src on the path first
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import lower_torch
    from repro_torch.models import moe
    if not os.path.samefile(moe.__file__, os.path.join(tree, "src", "repro_torch", "models",
                                                       "moe.py")):
        raise RuntimeError(f"repro_torch came from {moe.__file__}, not from {tree}")

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    timer = S.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg, mcfg = get_config(S.ARCH), get_config(S.MOE_ARCH)
    M, K, N = S.BATCH * S.PROMPT, cfg.d_model, cfg.d_ff
    E, d, f = mcfg.n_experts, mcfg.d_model, mcfg.moe_d_ff
    caps = (moe._capacity(S.BATCH, mcfg), moe._capacity(S.BATCH * S.PROMPT, mcfg))
    attention = [(c.name, S.BATCH, c.n_heads, c.n_kv_heads, S.PROMPT, S.PROMPT, c.head_dim_,
                  True) for c in (cfg, mcfg)]
    attention += [(model, B, H, Hkv, Sq, Skv, 64, causal)
                  for model, B, H, Hkv, Sq, Skv, causal in S.served_flash_d64()]
    cases = [S.flash_bwd_case(timer, gen, B, H, Hkv, Sq, Skv, hd, causal, bf16, True, model)
             for model, B, H, Hkv, Sq, Skv, hd, causal in attention]
    cases += [S.grouped_bwd_case(timer, gen, E, caps[1], a, b, bf16, True)
              for a, b in ((d, f), (f, d))]
    cases.append(S.gemm_bwd_case(timer, gen, M, N, K, bf16, True))
    cases.append(S.gemm_case(timer, gen, M, N, K, bf16,
                             lower_torch.plan_gemm_blocks(M, N, K, bf16), True))
    cases += [S.grouped_case(timer, gen, E, cap, a, b, bf16, True)
              for cap in caps for a, b in ((d, f), (f, d))]
    cases += S.wkv6_bwd_cases(timer, gen)
    keep = ("kernel_ms", "dx_ms", "dw_ms", "dA_ms", "dB_ms", "copy_ms", "launched",
            "library_ms", "bound_ms", "max_active_clusters")
    rows = {f"{c['name']} {c.get('model') or ''} {c['shape']} {c['dtype']}".replace("  ", " "):
            {k: c[k] for k in keep if k in c} for c in cases}
    return {"tree": tree, "rows": rows}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(one(os.path.abspath(argv[1]))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not argv:
        print("kernel_ab: needs one NVIDIA GPU and at least one checkout", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    for i, tree in enumerate(argv):
        tree = os.path.abspath(tree)
        env = dict(os.environ,
                   REPRO_TORCH_BUILD_DIR=os.path.join(tree, "build", "ab-kernels"),
                   REPRO_PLAN_CACHE_DIR=os.path.join(tree, "build", f"ab-plancache-{i}"),
                   REPRO_PLANNER_WORKERS="1")
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              env=env, capture_output=True, text=True, timeout=1200)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return done.returncode
        run = dict(json.loads(done.stdout.strip().splitlines()[-1]), order=i)
        print(json.dumps(run), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
