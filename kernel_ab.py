#!/usr/bin/env python3
"""Time the backward kernels, and the forward GEMMs that share K4's core, of
several checkouts in turns on one card; or, with ``--digests``, compare
their K2 and K2-bwd outputs bit for bit.

    python3 kernel_ab.py [--digests] TREE [TREE ...]

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
shapes, K5 at rwkv6-3b's training pass from a zero state, and K5-bwd at
every shape ``chip_smoke.py`` times it (rwkv6-3b's
training pass, 160 rows x T 512 x d 64 at chunk 16, in bf16 and float32;
head dims 16 and 32; an odd T at chunk 1; decays at the floor at chunk 32).

With ``--digests`` each checkout instead runs its own K2 (``flash_attention``:
bf16 and float32, every compiled head dim, causal and not, at every tile
that fits a block) and K2-bwd on inputs made from one seed, without a query
offset (the argument an older checkout does not have; a checkout whose K2
takes one also runs the chunked prefill's offset shapes, bf16, every tile,
with their log-sum-exp),
its K3' (``combine_partials``) on partials with empty splits, and its K5
(``wkv6``) and K5-bwd (``wkv6_bwd``) from a zero state (no ``state0``, no
final-state gradient: the arguments an older checkout does not have) at
every compiled head dim, bf16 and float32, chunks 1, 16 and 32 and
rwkv6-3b's training pass, into a fresh build directory
``TREE/build/ab-digests-<i>``.  Each tree's line then gives
``outputs_equal`` (every output's SHA-256 equal to the first tree's, with
the ones that differ) and, apart from it, ``spill_growth``: the K2, K2-bwd,
K5 and K5-bwd kernels whose ``ptxas`` spilled bytes exceed the first tree's
(keyed by kernel and template arguments: the parameter lists may differ).
The script exits 1 when an output differs.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the --digests inputs: batch x heads, q_per_kv, Sq, Skv
DIGEST_SHAPES = [(16, 4, 320, 320), (8, 2, 200, 136), (4, 1, 77, 150)]
# the --digests inputs with a query offset, where the checkout's K2 takes
# one: the chunked prefill's later chunks (qwen2.5-3b's 128 at 128 and
# 256 at 256; qwen3-moe's 256 at 256; qwen2.5-3b's last chunk over the
# second of two kv_seq blocks of 320, its rows at offset 64 of the block) --
# batch x heads, q_per_kv, Sq, Skv, d, offset
OFFSET_DIGEST_SHAPES = [(64, 8, 128, 256, 128, 128), (64, 8, 256, 512, 128, 256),
                        (128, 8, 256, 512, 128, 256), (64, 8, 128, 320, 128, 64)]
# the K3' (combine_partials) --digests inputs: rows, splits, d, bf16 output
# (the chunk rows of qwen2.5-3b folded over two kv_seq ranks; a decode step
# over 16 splits; d 256)
COMBINE_DIGEST_SHAPES = [(8192, 2, 128, True), (64, 16, 128, True), (64, 5, 256, False)]
# the K5 / K5-bwd --digests inputs: rows, T, chunk (every compiled head dim),
# and rwkv6-3b's training pass at d 64
WKV_DIGEST_SHAPES = [(8, 128, 16), (6, 96, 32), (4, 101, 1)]
WKV_TRAIN_SHAPE = (160, 512, 64, 16)


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
    cases.append(S.wkv6_train_case(timer, gen))
    cases += S.wkv6_bwd_cases(timer, gen)
    keep = ("kernel_ms", "dx_ms", "dw_ms", "dA_ms", "dB_ms", "copy_ms", "launched",
            "library_ms", "bound_ms", "max_active_clusters")
    rows = {f"{c['name']} {c.get('model') or ''} {c['shape']} {c['dtype']}".replace("  ", " "):
            {k: c[k] for k in keep if k in c} for c in cases}
    return {"tree": tree, "rows": rows}


def _digest(t) -> str:
    import torch
    raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def one_digests(tree: str) -> dict:
    """The SHA-256 of every K2 / K2-bwd output of checkout ``tree`` on the
    DIGEST_SHAPES inputs, and the registers and spilled bytes ``ptxas``
    reported for its K2 and K2-bwd kernels."""
    sys.path.insert(0, HERE)
    from chip_smoke import ptxas_usage
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.kernels import _build, flash_attention as FA, flash_attention_bwd as FAB
    if not os.path.samefile(FA.__file__, os.path.join(tree, "src", "repro_torch", "kernels",
                                                      "flash_attention.py")):
        raise RuntimeError(f"repro_torch came from {FA.__file__}, not from {tree}")

    dev = torch.device("cuda", 0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for d in FA.COMPILED_HEAD_DIMS:
            for BH, g, Sq, Skv in DIGEST_SHAPES:
                gen = torch.Generator(device=dev).manual_seed(BH + Sq + Skv + d)
                q = torch.randn(BH, Sq, d, generator=gen, device=dev).to(dtype)
                k = torch.randn(BH // g, Skv, d, generator=gen, device=dev).to(dtype)
                v = torch.randn(BH // g, Skv, d, generator=gen, device=dev).to(dtype)
                dout = torch.randn(BH, Sq, d, generator=gen, device=dev).to(dtype)
                for causal in (True, False):
                    tag = f"{str(dtype)[6:]} d{d} BH{BH} g{g} {Sq}x{Skv} causal={causal}"
                    for bq, bkv in FA.legal_tiles(d, q.element_size()):
                        o, lse = FA.flash_attention(q, k, v, causal=causal, block_q=bq,
                                                    block_kv=bkv, q_per_kv=g, return_lse=True)
                        out[f"fwd {tag} tile {bq}x{bkv}"] = _digest(o) + _digest(lse)
                    grads = FAB.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal,
                                                    q_per_kv=g)
                    out[f"bwd {tag}"] = "".join(_digest(x) for x in grads)
    import inspect
    if "q_offset" in inspect.signature(FA.flash_attention).parameters:
        for BH, g, Sq, Skv, d, off in OFFSET_DIGEST_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(BH + Sq + Skv + off)
            q, k, v = (torch.randn(n, s, d, generator=gen, device=dev).to(torch.bfloat16)
                       for n, s in ((BH, Sq), (BH // g, Skv), (BH // g, Skv)))
            for bq, bkv in FA.legal_tiles(d, q.element_size()):
                o, lse = FA.flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bkv,
                                            q_per_kv=g, q_offset=off, return_lse=True)
                out[f"fwd bf16 d{d} BH{BH} g{g} {Sq}x{Skv} offset {off} tile {bq}x{bkv}"] = \
                    _digest(o) + _digest(lse)
    out.update(wkv_digests(dev))
    out.update(combine_digests(dev))
    torch.cuda.synchronize()
    usage = ptxas_usage(_build.build_info().get("compiler_output", ""))
    kernels = {n.split("Ev")[0]: u for n, u in usage.items()
               if any(k in n for k in ("flash_fwd", "flash_bwd", "wkv6_kernel", "wkv6_bwd"))}
    if not kernels:
        raise RuntimeError(f"{tree}: no K2 / K2-bwd / K5 / K5-bwd kernel in this process's build")
    return {"tree": tree, "digests": out, "ptxas": kernels}


def combine_digests(dev) -> dict:
    """The SHA-256 of K3''s output (``flash_decode.combine_partials``) on
    partials made from one seed at COMBINE_DIGEST_SHAPES, an empty split
    ((-1e30, 0, 0), as a rank whose block a row cannot see hands over) in
    every eighth row."""
    import torch

    from repro_torch.kernels import flash_decode as FD
    out = {}
    for rows, splits, d, bf16 in COMBINE_DIGEST_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(rows + splits + d)
        m = torch.randn(rows, splits, 1, 1, generator=gen, device=dev) * 4
        l = torch.rand(rows, splits, 1, 1, generator=gen, device=dev) + 0.5
        acc = torch.randn(rows, splits, 1, d, generator=gen, device=dev)
        m[::8, 0], l[::8, 0], acc[::8, 0] = -1e30, 0.0, 0.0
        got = FD.combine_partials(m, l, acc,
                                  out_dtype=torch.bfloat16 if bf16 else torch.float32)
        out[f"combine rows{rows} splits{splits} d{d} {'bf16' if bf16 else 'f32'}"] = \
            _digest(got)
    return out


def wkv_digests(dev) -> dict:
    """The SHA-256 of K5's output and final state and of K5-bwd's five
    gradients from a zero state, at WKV_DIGEST_SHAPES for every compiled
    head dim and at WKV_TRAIN_SHAPE, bf16 and float32."""
    import torch

    from repro_torch.kernels import rwkv6 as K5, rwkv6_bwd as K5B
    shapes = [(BH, T, d, c) for d in K5.COMPILED_HEAD_DIMS for BH, T, c in WKV_DIGEST_SHAPES]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for BH, T, d, c in shapes + [WKV_TRAIN_SHAPE]:
            gen = torch.Generator(device=dev).manual_seed(BH + T + d + c)
            r, k, v, dout = (torch.randn(BH, T, d, generator=gen, device=dev) for _ in range(4))
            lw = (-torch.exp(torch.randn(BH, T, d, generator=gen, device=dev))).clamp(min=-4.0)
            u = torch.randn(BH, d, generator=gen, device=dev) * 0.5
            xs = [x.to(dtype) for x in (r, k, v, lw, u)]
            tag = f"{str(dtype)[6:]} d{d} BH{BH} T{T} chunk{c}"
            o, state = K5.wkv6(*xs, chunk=c)
            out[f"wkv6 {tag}"] = _digest(o) + _digest(state)
            grads = K5B.wkv6_bwd(*xs, dout.to(dtype), chunk=c)
            out[f"wkv6_bwd {tag}"] = "".join(_digest(x) for x in grads)
    return out


def compare_digests(rows) -> bool:
    """One line a tree: its outputs against the first tree's, and apart from
    that its K2 / K2-bwd kernels that spill more than the first tree's.
    True when every output is equal."""
    base, base_ptxas = rows[0]["digests"], rows[0]["ptxas"]
    equal = True
    for row in rows:
        differ = sorted(k for k in base if row["digests"].get(k) != base[k])
        growth = {n: {"spill_bytes": u.get("spill_bytes", 0),
                      "first_tree": base_ptxas.get(n, {}).get("spill_bytes", 0)}
                  for n, u in row["ptxas"].items()
                  if u.get("spill_bytes", 0) > base_ptxas.get(n, {}).get("spill_bytes", 0)}
        print(json.dumps({"tree": row["tree"], "order": row["order"],
                          "outputs": len(row["digests"]), "outputs_equal": not differ,
                          "differ_from_first": differ, "kernels": len(row["ptxas"]),
                          "spill_growth": growth,
                          "max_registers": max(u.get("registers", 0)
                                               for u in row["ptxas"].values())}), flush=True)
        equal = equal and not differ
    return equal


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] in ("--one", "--one-digests"):
        run = one if argv[0] == "--one" else one_digests
        print(json.dumps(run(os.path.abspath(argv[1]))), flush=True)
        return 0
    digests = bool(argv) and argv[0] == "--digests"
    trees = argv[1:] if digests else argv
    import torch
    if not torch.cuda.is_available() or not trees:
        print("kernel_ab: needs one NVIDIA GPU and at least one checkout", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    rows = []
    for i, tree in enumerate(trees):
        tree = os.path.abspath(tree)
        build = f"ab-digests-{i}" if digests else "ab-kernels"
        env = dict(os.environ,
                   REPRO_TORCH_BUILD_DIR=os.path.join(tree, "build", build),
                   REPRO_PLAN_CACHE_DIR=os.path.join(tree, "build", f"ab-plancache-{i}"),
                   REPRO_PLANNER_WORKERS="1")
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one-digests" if digests else "--one", tree],
                              env=env, capture_output=True, text=True, timeout=1200)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return done.returncode
        run = dict(json.loads(done.stdout.strip().splitlines()[-1]), order=i)
        if digests:
            rows.append(run)
        else:
            print(json.dumps(run), flush=True)
    equal = compare_digests(rows) if digests else True
    print(card, flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
