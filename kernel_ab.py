#!/usr/bin/env python3
"""Time the backward kernels, the forward GEMMs that share K4's core, and
K3 and K3' at their served shapes, of several checkouts in turns on one
card; or, with ``--digests``, compare their K2, K2-bwd, K3, K3', K5 and
K5-bwd outputs bit for bit.

    python3 kernel_ab.py [--digests] TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` is this one; an older
commit unpacked with ``git archive`` into ``_parent/`` is another).  Each
runs in a fresh process that builds that checkout's kernels into
``TREE/build/ab-kernels`` and runs this checkout's ``chip_smoke.py`` cases
(its timer, shapes and checks) on that checkout's ``repro_torch``, and
prints one JSON line of kernel times; the script prints the card's name and
power limit last.  Name the trees as parent, change, change, parent to see
the drift across the call.  Needs one NVIDIA GPU.

The rows, bf16 unless marked: K2 and K2-bwd at gemma-7b's prefill and
training pass (head dim 256, each row naming the body it timed: ``tma`` or
``mma``, the mma.sync body of a checkout that counts no bodies), K2-bwd at
the training passes of every other attention family, K4-bwd at the MoE's prefill (with its dX, dW and copy pieces as that
checkout's backward launches them), K1-bwd (with its dA, dB and copy pieces
likewise) and K1 at qwen2.5-3b's projection, K4 at the MoE's four served
shapes, K5 at rwkv6-3b's training pass from a zero state, K5-bwd at
every shape ``chip_smoke.py`` times it (rwkv6-3b's
training pass, 160 rows x T 512 x d 64 at chunk 16, in bf16 and float32;
head dims 16 and 32; an odd T at chunk 1; decays at the floor at chunk 32),
K3 at gemma-7b's decode step (one launch, and the partials epilogue with
K3' on its partials; each row naming the body it timed), K3' at
mesh_serve's decode fold (64 rows, 16 splits, d 128) and at the chunk rows
(8,192 rows, 2 splits), K3 at gemma-7b's 64 groups at fixed split counts
(513 and 4,096 valid keys), the timer's floor (an empty kernel) and its read
rate (``torch.sum`` over the 513-key call's K/V bytes, contiguous).

With ``--digests`` each checkout instead runs its own K2 (``flash_attention``:
bf16 and float32, every compiled head dim, causal and not, at every tile
that fits a block) and K2-bwd on inputs made from one seed, without a query
offset (the argument an older checkout does not have; a checkout whose K2
takes one also runs the chunked prefill's offset shapes, bf16, every tile,
with their log-sum-exp),
its K3' (``combine_partials``) on partials with empty splits, its K3
(``flash_decode`` and ``flash_decode_partials``, keyed by body) at every
compiled head dim, bf16 and float32, on the cache's strided view at
DECODE_DIGEST_SHAPES with explicit split counts, and its K5
(``wkv6``) and K5-bwd (``wkv6_bwd``) from a zero state (no ``state0``, no
final-state gradient: the arguments an older checkout does not have) at
every compiled head dim, bf16 and float32, chunks 1, 16 and 32 and
rwkv6-3b's training pass, into a fresh build directory
``TREE/build/ab-digests-<i>``.  Each K2 / K2-bwd output is keyed with the
body that computed it.  Each tree's line then gives ``outputs_equal``
(every output's SHA-256 equal to the first tree's where both trees ran the
same body, with the ones that differ), ``differ_by_body`` (the outputs that
differ because another body computed them) and, apart from it,
``spill_growth``: the K2, K2-bwd, K3, K3', K5 and K5-bwd kernels whose ``ptxas``
spilled bytes exceed the first tree's (keyed by kernel and template
arguments: the parameter lists may differ).  The script exits 1 when an
output of the same body differs.
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
# over 16 splits; d 256; more splits than one window of 64)
COMBINE_DIGEST_SHAPES = [(8192, 2, 128, True), (64, 16, 128, True), (64, 5, 256, False),
                         (37, 130, 128, False)]
# the K3 --digests inputs: batch x query heads, q_per_kv, buffer, valid keys,
# splits (gemma-7b's decode step in the TMA body's 4 splits and the mma.sync
# body's 5; a group of 8; a ragged short strip; G 16 at one valid key)
DECODE_DIGEST_SHAPES = [(64, 1, 545, 513, 4), (64, 1, 545, 513, 5), (16, 8, 545, 513, 8),
                        (12, 3, 300, 7, 5), (16, 16, 545, 1, 2)]
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
    gcfg = get_config(S.GEMMA_ARCH)
    gemma = (S.BATCH, gcfg.n_heads, gcfg.n_kv_heads, S.PROMPT, S.PROMPT, gcfg.head_dim_, True,
             bf16, True, gcfg.name)
    cases = [S.flash_case(timer, gen, *gemma), S.flash_bwd_case(timer, gen, *gemma)]
    cases += [S.flash_bwd_case(timer, gen, B, H, Hkv, Sq, Skv, hd, causal, bf16, True, model)
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
    cases += S.decode_cases(timer, gen, S.BATCH, gcfg.n_heads, gcfg.n_kv_heads,
                            S.PROMPT + S.NEW_TOKENS + 1, S.PROMPT + 1, gcfg.head_dim_, bf16,
                            True, model=gcfg.name)
    cases += S.k3_combine_cases(timer, gen)
    keep = ("body", "kernel_ms", "dx_ms", "dw_ms", "dA_ms", "dB_ms", "copy_ms", "launched",
            "library_ms", "bound_ms", "max_active_clusters", "host_us", "mma_host_us")
    rows = {f"{c['name']} {c.get('model') or ''} {c['shape']} {c['dtype']}".replace("  ", " "):
            {k: c[k] for k in keep if k in c} for c in cases}
    rows["timer floor"] = {"kernel_ms": S.timer_floor_ms(timer)}
    rows.update(decode_split_rows(S, timer, gen, gcfg))
    return {"tree": tree, "rows": rows}


def decode_split_rows(S, timer, gen, gcfg) -> dict:
    """K3's one-launch decode at gemma-7b's 64 groups at fixed split counts,
    513 and 4,096 valid keys of a 4,200-key cache (what the split rule
    chooses between), and the read rate under the same timer: one
    ``torch.sum`` over a contiguous bf16 tensor of the 513-key call's K/V
    bytes."""
    import torch

    from repro_torch.kernels import ops
    dev = timer.flush.device
    H, Hkv, d = gcfg.n_heads, gcfg.n_kv_heads, gcfg.head_dim_
    q, k4, v4 = S._qkv(gen, dev, S.BATCH, H, Hkv, 1, 4200, d, torch.bfloat16)
    rows = {}
    for valid, counts in ((S.PROMPT + 1, (2, 3, 4, 5, 8)), (4096, (2, 4, 8))):
        for splits in counts:
            run = lambda: ops.flash_decode(q, k4, v4, kv_splits=splits, kv_valid_len=valid)
            rows[f"flash_decode {gcfg.name} valid={valid} splits={splits}"] = {
                "kernel_ms": timer.ms(run)}
    flat = torch.zeros(2 * S.BATCH * Hkv * (S.PROMPT + 1) * d, dtype=torch.bfloat16, device=dev)
    rows["read floor: torch.sum of the 513-key K/V bytes"] = {
        "kernel_ms": timer.ms(lambda: flat.sum()), "bytes": flat.numel() * 2}
    return rows


def _digest(t) -> str:
    import torch
    raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def one_digests(tree: str) -> dict:
    """The SHA-256 of every K2 / K2-bwd output of checkout ``tree`` on the
    DIGEST_SHAPES inputs, and the registers and spilled bytes ``ptxas``
    reported for its K2 and K2-bwd kernels."""
    sys.path.insert(0, HERE)
    from chip_smoke import attention_body, ptxas_usage
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.kernels import _build, flash_attention as FA, flash_attention_bwd as FAB
    if not os.path.samefile(FA.__file__, os.path.join(tree, "src", "repro_torch", "kernels",
                                                      "flash_attention.py")):
        raise RuntimeError(f"repro_torch came from {FA.__file__}, not from {tree}")

    dev = torch.device("cuda", 0)
    out, bodies = {}, {}
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
                        key = f"fwd {tag} tile {bq}x{bkv}"
                        bodies[key], (o, lse) = attention_body(FA, lambda: FA.flash_attention(
                            q, k, v, causal=causal, block_q=bq, block_kv=bkv, q_per_kv=g,
                            return_lse=True), dtype)
                        out[key] = _digest(o) + _digest(lse)
                    bodies[f"bwd {tag}"], grads = attention_body(
                        FAB, lambda: FAB.flash_attention_bwd(q, k, v, o, lse, dout,
                                                             causal=causal, q_per_kv=g), dtype)
                    out[f"bwd {tag}"] = "".join(_digest(x) for x in grads)
    import inspect
    if "q_offset" in inspect.signature(FA.flash_attention).parameters:
        for BH, g, Sq, Skv, d, off in OFFSET_DIGEST_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(BH + Sq + Skv + off)
            q, k, v = (torch.randn(n, s, d, generator=gen, device=dev).to(torch.bfloat16)
                       for n, s in ((BH, Sq), (BH // g, Skv), (BH // g, Skv)))
            for bq, bkv in FA.legal_tiles(d, q.element_size()):
                key = f"fwd bf16 d{d} BH{BH} g{g} {Sq}x{Skv} offset {off} tile {bq}x{bkv}"
                bodies[key], (o, lse) = attention_body(FA, lambda: FA.flash_attention(
                    q, k, v, causal=True, block_q=bq, block_kv=bkv, q_per_kv=g, q_offset=off,
                    return_lse=True), q.dtype)
                out[key] = _digest(o) + _digest(lse)
    out.update(wkv_digests(dev))
    out.update(combine_digests(dev))
    digests, by_body = decode_digests(dev)
    out.update(digests)
    bodies.update(by_body)
    torch.cuda.synchronize()
    usage = ptxas_usage(_build.build_info().get("compiler_output", ""))
    kernels = {n.split("Ev")[0]: u for n, u in usage.items()
               if any(k in n for k in ("flash_fwd", "flash_bwd", "wkv6_kernel", "wkv6_bwd",
                                       "decode_"))}
    if not kernels:
        raise RuntimeError(f"{tree}: no K2 / K2-bwd / K5 / K5-bwd kernel in this process's build")
    return {"tree": tree, "digests": out, "bodies": bodies, "ptxas": kernels}


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


def decode_digests(dev) -> tuple:
    """The SHA-256 of K3's outputs (``flash_decode``, both stages in one
    launch, and ``flash_decode_partials``' m, l and acc) at
    DECODE_DIGEST_SHAPES for every compiled head dim, bf16 and float32, k/v
    strided (batch, kv head, key, d) views of a (batch, key, kv head, d)
    cache, with the body each call ran."""
    import torch
    sys.path.insert(0, HERE)
    from chip_smoke import attention_body

    from repro_torch.kernels import flash_decode as FD
    out, bodies = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for d in FD.COMPILED_HEAD_DIMS:
            for BH, g, T, valid, splits in DECODE_DIGEST_SHAPES:
                gen = torch.Generator(device=dev).manual_seed(BH + T + valid + d + splits)
                q = torch.randn(BH, 1, d, generator=gen, device=dev).to(dtype)
                k, v = (torch.randn(1, T, BH // g, d, generator=gen, device=dev).to(dtype)
                        .permute(0, 2, 1, 3) for _ in range(2))
                tag = f"{str(dtype)[6:]} d{d} BH{BH} g{g} {valid}/{T} splits{splits}"
                key = f"decode {tag}"
                bodies[key], o = attention_body(FD, lambda: FD.flash_decode(
                    q, k, v, kv_splits=splits, kv_valid_len=valid, q_per_kv=g), dtype)
                out[key] = _digest(o)
                key = f"decode_partials {tag}"
                bodies[key], parts = attention_body(FD, lambda: FD.flash_decode_partials(
                    q, k, v, kv_splits=splits, kv_valid_len=valid, q_per_kv=g), dtype)
                out[key] = "".join(_digest(x) for x in parts)
    return out, bodies


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
    """One line a tree: its outputs against the first tree's, those that
    another body computed apart, and apart from that its K2 / K2-bwd kernels
    that spill more than the first tree's.  True when every output of the
    same body is equal."""
    base, base_ptxas = rows[0]["digests"], rows[0]["ptxas"]
    base_bodies = rows[0].get("bodies", {})
    equal = True
    for row in rows:
        bodies = row.get("bodies", {})
        changed = sorted(k for k in base if row["digests"].get(k) != base[k])
        by_body = [k for k in changed if bodies.get(k) != base_bodies.get(k)]
        differ = [k for k in changed if k not in by_body]
        growth = {n: {"spill_bytes": u.get("spill_bytes", 0),
                      "first_tree": base_ptxas.get(n, {}).get("spill_bytes", 0)}
                  for n, u in row["ptxas"].items()
                  if u.get("spill_bytes", 0) > base_ptxas.get(n, {}).get("spill_bytes", 0)}
        print(json.dumps({"tree": row["tree"], "order": row["order"],
                          "outputs": len(row["digests"]), "outputs_equal": not differ,
                          "differ_from_first": differ, "differ_by_body": by_body,
                          "bodies": {b: sum(1 for x in bodies.values() if x == b)
                                     for b in sorted(set(bodies.values()))},
                          "kernels": len(row["ptxas"]),
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
