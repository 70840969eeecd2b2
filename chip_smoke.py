#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on an H100.

    python3 chip_smoke.py

Needs one NVIDIA GPU with ``nvcc`` on the machine; without a GPU it exits
non-zero and prints no result.  It imports ``repro_torch`` only and runs
these phases, each printing one JSON line; any failure raises:

1. device   the card's name and power limit, torch and CUDA versions;
2. build    compile ``src/repro_torch/kernels/csrc/*.cu`` and load the library;
3. kernels  every kernel against its plain PyTorch version on the card, at
            the serving shapes (K2 at qwen2.5-3b's and at the MoE's
            prefill, K3 at both models' decode, K4 at the MoE's four, K5 at
            rwkv6-3b's prefill; at head dim 64 K2 at zamba2-1.2b's and
            internvl2-1b's prefill, seamless-m4t-medium's encoder and its
            cross prompt pass, K3 at zamba2's and internvl2's decode and
            seamless's cross step) and at one ragged shape each, in
            bf16 and float32 (tolerances 2e-2 and 1e-4, those of the
            reference's kernel tests; 2e-3 for the WKV scan in float32 and
            for its final state), each timed with CUDA events (median of 25
            single launches, the L2 cache flushed before each) beside its
            plain version, one PyTorch library call where one computes the
            same function, and the roofline bound; at the served bf16 K1 and
            K4 shapes also the staged GEMM body's fastest tile and the host
            microseconds per call of each body;
4. planner  ``ops.matmul`` with no block at the model's projection shape:
            planner -> GEMM kernel on the TMA body, search then registry
            hit, no fallback; every compiled bf16 GEMM tile (both bodies)
            and flash tile timed at the served shape (d 128, and d 64 at
            zamba2's prefill and seamless's encoder), and every TMA tile at
            the MoE's two K4 prefill shapes (forward, and the backward's dX
            and dW products) and at K1's backward products (dA = dC B^T and
            dB = A^T dC, each reading its operand as stored), with the rank
            of the planner's tiles and their time over the fastest tile's;
            and (line ``plan_service``) the plan service on the served GEMM
            and flash programs on the H100 model: a full-budget resolve,
            then one at the default deadline that must answer from the
            registry, each with its rung, seconds and blocks;
5. serve    ``qwen2.5-3b`` at full width and depth with random weights:
            batch 4, prompt 512, 32 greedy tokens through
            ``repro_torch.launch.serve``, compared step by step with the same
            loop run on the plain PyTorch attention;
   serve_obs the same model and run through ``serve.main`` with
            ``--introspect-port 0 --introspect-hold 5 --flightrec PATH
            --plan-budget-ms 10``: ids, launches and blocks equal the serve
            phase's; ``/metrics`` (validated exposition, the plan service's
            fallback/error request, the planner's counters), ``/healthz``,
            ``/slo``, ``/plans`` (the registry hits of the served blocks) and
            ``/tenants`` scraped from a thread during the hold; the
            flight-recorder dump loads and renders its mesh ``plan_request``;
6. rwkv     ``rwkv6-3b`` at full width and depth, the prompt's WKV scan
            through the chunked-WKV kernel once per layer; the kernel run and
            the plain run (the kernel's plain version in its place, the
            kernel run's ids) are held against the same loop in float32, and
            every kernel call of a prefill against its plain version on the
            same inputs, with controls that must fail;
7. hybrid   ``zamba2-1.2b``, 8. vlm ``internvl2-1b`` (256 stub image patches
   ahead of the prompt), 9. encdec ``seamless-m4t-medium`` (1024 stub audio
            frames through the encoder, the decoder's cross-attention over
            them): each at full width and depth, every prompt pass through
            K2 and every decode-step attention through K3 with exact launch
            counts; the kernel run and the plain run (the kernel run's ids)
            are held against the same loop in float32, every K2 and K3 call
            of a prefill and a decode step against its plain version on the
            same inputs, and a control whose K2/K3 outputs keep 5 mantissa
            bits must fail;
10. moe     ``qwen3-moe-30b-a3b`` at full width and depth (30.5 B
            parameters, 61 GB in bf16), its experts through the grouped-GEMM
            kernel, every launch on the TMA body; the kernel run and the
            plain run, both fed the kernel run's ids and routing (a near-flat
            random router turns bf16 differences into other experts), are
            held against the same loop in float32, with a control that must
            fail; the share of prefill expert choices that agree when the
            plain run routes by itself is reported;
11. train   ``qwen2.5-3b`` trained at full width and depth (float32 master
            weights from seed 0, bf16 compute, remat, AdamW, batch 4 x 512):
            the first step's gradient through the kernels, through the plain
            path and in float32, the kernel path at most 1.25 x as far from
            float32 as the plain path (worst leaf and overall); every K2-bwd
            call of that step against its plain version on the same inputs,
            with a 5-bit control that must be rejected; then three AdamW
            steps through ``repro_torch.launch.train`` with exact launch
            counts (K2 twice a layer with remat, K2-bwd once), finite losses,
            peak memory, step time, tok/s and one traced step;
12. moe_train ``qwen3-moe-30b-a3b`` at full width and 2 of its 48 layers:
            one gradient step, every expert product forward, recomputed and
            backward through K4 (its backward launches counted inside
            ``ops.grouped_matmul``'s backward, split by body), the float32
            rule on gradients with the kernel run's experts replayed, and
            one traced gradient step;
13. rwkv_train ``rwkv6-3b`` trained at full width and depth (as ``train``):
            the first step's gradient through K5 and K5-bwd, through the
            plain path (both patched to their plain versions, the bf16 casts
            of the decays and the bonus kept) and in float32, the float32
            rule on gradients; every K5-bwd call of that step against its
            plain version on the same inputs, with a 5-bit control that must
            be rejected; three AdamW steps with exact launch counts (K5
            twice a layer, K5-bwd once), finite losses, peak memory, step
            time, tok/s and one traced step.

The kernels phase also holds the backward kernels against their plain
versions: K2-bwd (dq, dk, dv; the forward kernel's log-sum-exp too; bf16 on
the tensor cores, its dK/dV launch one cluster per kv-head group) at the
training passes of every attention family and one ragged shape, K1-bwd at
qwen2.5-3b's projection and K4-bwd at the MoE's prefill (its pieces read
from a ``torch.profiler`` trace of one backward: the dX and dW launches,
which read ``w`` and ``x`` as stored, dW at K = cap on the short-K ring,
and any other kernel it launches, such as a transposing copy), each beside
the library's backward (SDPA's, two ``torch.matmul`` / ``torch.bmm``), and
K5-bwd (dr, dk, dv, dlog_w, du) at rwkv6-3b's training pass in bf16 and
float32, at head dims 16 and 32, at an odd T (chunk 1) and at the decay
floor with chunk 32 (no library call computes a WKV backward).

Then one line ``{"kernels": [...]}`` with each kernel's launches on the main
path and its measured times (the reference's two decode functions,
``flash_decode_partials`` and ``combine_partials``, are checked and timed
but marked off the main path: ``ops.flash_decode`` computes both in one
launch), the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from dataclasses import replace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

ARCH = "qwen2.5-3b"
MOE_ARCH = "qwen3-moe-30b-a3b"
RWKV_ARCH = "rwkv6-3b"
HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH = "zamba2-1.2b", "internvl2-1b", "seamless-m4t-medium"
BATCH, PROMPT, NEW_TOKENS = 4, 512, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median time of single launches, the 50 MB L2 flushed before each by
    writing 1 GiB; that write also keeps the card busy long enough for the
    host to have the timed launch queued behind it, so the events bracket the
    kernel and not the wrapper's Python."""

    def __init__(self, device):
        self.flush = torch.empty(1024 * 1024 * 1024, dtype=torch.uint8, device=device)

    def ms(self, fn, n: int = 25, warm: int = 3) -> float:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def ptxas_usage(compiler_output: str) -> dict:
    """Registers and spilled bytes of every compiled kernel, from the
    ``-Xptxas -v`` lines of the build."""
    usage, name = {}, None
    for line in compiler_output.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            usage[name] = {}
        elif name and "spill stores" in line:
            usage[name]["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line)[1])
        elif name and "Used" in line and "registers" in line:
            usage[name]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    return usage


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, byts: float, dtype) -> dict:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": byts}


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype, tol=None) -> float:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or "
                             f"non-finite values")
    err = (g - w).abs().max().item()
    tol = tol or TOL[dtype]
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel and plain version disagree, max abs err "
                             f"{err} at tolerance {tol}")
    return err


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --------------------------------------------------------------------- cases
def gemm_case(timer, gen, M, N, K, dtype, block, serving):
    from repro_torch.kernels import gemm as G, ops
    dev = timer.flush.device
    a = (torch.randn(M, K, generator=gen, device=dev) * K ** -0.5).to(dtype)
    b = torch.randn(K, N, generator=gen, device=dev).to(dtype)
    run = lambda: ops.matmul(a, b, block=block)
    out = run()
    err = compare(f"gemm {M}x{N}x{K} {dname(dtype)}", out, G.gemm_plain(a, b), dtype)
    body = G.gemm_body(dtype, K, N, a.data_ptr(), b.data_ptr())
    res = {"name": "gemm", "shape": f"({M},{K})@({K},{N})", "dtype": dname(dtype),
           "serving": serving, "block": list(block) if block else None, "body": body,
           "max_abs_err": err, "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(lambda: G.gemm_plain(a, b)),
           "library_ms": timer.ms(lambda: torch.matmul(a, b))}
    res.update(bound(2.0 * M * N * K, nbytes(a, b, out), dtype))
    if serving and body == "tma":
        on_body = lambda body, t: G.gemm_on_body(a, b, body, block=t)
        res.update(staged_body(timer, on_body, G.gemm_plain(a, b), dtype, block))
    return res


def staged_body(timer, on_body, want, dtype, block) -> dict:
    """The staged body (the first kernels' design) on the same inputs, each
    of its tiles checked and timed: the fastest is the time to beat.  And
    the host microseconds per call of each body, at the served tile and at
    that fastest tile."""
    from repro_torch.kernels import gemm as G
    times = {}
    for t in G.STAGED_TILES:
        compare(f"staged body {t}", on_body("staged", t), want, dtype)
        times[t] = timer.ms(lambda t=t: on_body("staged", t), n=10)
    best = min(times, key=times.get)
    return {"staged_ms": times[best], "staged_block": list(best),
            "host_us": host_us(lambda: on_body("tma", block)),
            "staged_host_us": host_us(lambda: on_body("staged", best))}


def host_us(launch, n: int = 200) -> float:
    """Host microseconds per call of ``launch`` (the wrapper's Python, the
    tensor maps' encoding, the launch), taken while the card drains a queue
    that the calls keep ahead of it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _qkv(gen, dev, B, H, Hkv, Sq, Skv, d, dtype):
    """q as the layers hand it over, k/v as strided views of (B, T, Hkv, d)."""
    q = torch.randn(B * H, Sq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hkv, d, generator=gen, device=dev).to(dtype)
    return q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def flash_case(timer, gen, B, H, Hkv, Sq, Skv, d, causal, dtype, serving, model=None):
    from repro_torch.kernels import flash_attention as FA, ops
    dev = timer.flush.device
    g = H // Hkv
    q, k4, v4 = _qkv(gen, dev, B, H, Hkv, Sq, Skv, d, dtype)
    run = lambda: ops.attention(q, k4, v4, causal=causal, q_per_kv=g)
    plain = lambda: FA.flash_attention_plain(q, k4, v4, causal=causal, q_per_kv=g)
    out = run()
    err = compare(f"flash_attention {Sq}x{Skv} d={d} {dname(dtype)}", out, plain(), dtype)
    q4 = q.reshape(B, H, Sq, d)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                                 enable_gqa=g > 1)
    compare("library attention", lib().reshape(B * H, Sq, d), plain(), dtype, tol=2e-2)
    visible = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    res = {"name": "flash_attention", "shape": f"BH={B * H} kv_heads={B * Hkv} "
           f"Sq={Sq} Skv={Skv} d={d} causal={causal}", "dtype": dname(dtype),
           "serving": serving, "model": model, "max_abs_err": err, "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    res.update(bound(4.0 * B * H * visible * d, nbytes(q, k4, v4, out), dtype))
    return res


def decode_cases(timer, gen, B, H, Hkv, Skv, valid, d, dtype, serving, splits=None,
                 model=None, stages=True):
    """The decode as ``ops.flash_decode`` runs it (both stages in one
    launch, the splits capped at one cluster's 8), and, with ``stages``, the
    reference's two functions on their own (partials and combine, at the
    uncapped split count ``flash_decode_partials`` is used with)."""
    from repro_torch.kernels import flash_decode as FD, ops
    dev = timer.flush.device
    g = H // Hkv
    q, k4, v4 = _qkv(gen, dev, B, H, Hkv, 1, Skv, d, dtype)
    n = Skv if valid is None else valid
    s = splits or FD.choose_splits(n, B * Hkv, FD.sm_count(dev), FD.MAX_CLUSTER_SPLITS)
    run = lambda: ops.flash_decode(q, k4, v4, kv_splits=splits, kv_valid_len=valid,
                                   q_per_kv=g)
    plain = lambda: FD.flash_decode_plain(q, k4, v4, kv_valid_len=valid, q_per_kv=g)
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = run()
    if kernels.launch_counts()["flash_decode"] != 1 or sum(kernels.launch_counts().values()) != 1:
        raise AssertionError(f"ops.flash_decode made {kernels.launch_counts()} launches")
    label = f"BH={B * H} kv_heads={B * Hkv} buffer={Skv} valid={n} d={d} splits={s}"
    err = compare(f"flash_decode {label} {dname(dtype)}", out, plain(), dtype)
    q4 = q.reshape(B, H, 1, d)
    lib = lambda: F.scaled_dot_product_attention(q4, k4[:, :, :n], v4[:, :, :n],
                                                 enable_gqa=g > 1)
    compare("library decode", lib().reshape(B * H, 1, d), plain(), dtype, tol=2e-2)
    kv_bytes = 2 * B * Hkv * n * d * q.element_size()
    both = {"name": "flash_decode", "shape": label, "dtype": dname(dtype),
            "serving": serving, "model": model, "max_abs_err": err,
            "kernel_ms": timer.ms(run), "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    both.update(bound(4.0 * B * H * n * d, kv_bytes + nbytes(q, out), dtype))
    if not stages:
        return [both]

    s = splits or FD.choose_splits(n, B * Hkv, FD.sm_count(dev))
    label = f"BH={B * H} kv_heads={B * Hkv} buffer={Skv} valid={n} d={d} splits={s}"
    part = lambda: FD.flash_decode_partials(q, k4, v4, kv_splits=s, kv_valid_len=valid,
                                            q_per_kv=g)
    part_plain = lambda: FD.flash_decode_partials_plain(q, k4, v4, kv_splits=s,
                                                        kv_valid_len=valid, q_per_kv=g)
    m, l, acc = part()
    mp, lp, accp = part_plain()
    # compare the partials through the exact float32 combine: (m, l, acc) of
    # one split are only defined up to a common rescaling
    err_p = compare("flash_decode_partials " + label,
                    FD.combine_partials_plain(m, l, acc),
                    FD.combine_partials_plain(mp, lp, accp), dtype)
    partials = {"name": "flash_decode_partials", "shape": label, "dtype": dname(dtype),
                "serving": serving, "max_abs_err": err_p, "kernel_ms": timer.ms(part),
                "plain_ms": timer.ms(part_plain), "library_ms": None}
    partials.update(bound(4.0 * B * H * n * d, kv_bytes + nbytes(q, m, l, acc), dtype))

    comb = lambda: FD.combine_partials(mp, lp, accp, out_dtype=dtype)
    comb_plain = lambda: FD.combine_partials_plain(mp, lp, accp, out_dtype=dtype)
    err_c = compare("flash_decode_combine " + label, comb(), comb_plain(), dtype)
    combine = {"name": "flash_decode_combine", "shape": label, "dtype": dname(dtype),
               "serving": serving, "max_abs_err": err_c, "kernel_ms": timer.ms(comb),
               "plain_ms": timer.ms(comb_plain), "library_ms": None}
    combine.update(bound(3.0 * B * H * s * d, nbytes(mp, lp, accp, out), torch.float32))
    return [both, partials, combine]


def grouped_case(timer, gen, E, cap, d_in, d_out, dtype, serving):
    from repro_torch.core import lower_torch
    from repro_torch.kernels import gemm as G, moe_gmm, ops
    dev = timer.flush.device
    x = torch.randn(E, cap, d_in, generator=gen, device=dev).to(dtype)
    w = (torch.randn(E, d_in, d_out, generator=gen, device=dev) * d_in ** -0.5).to(dtype)
    run = lambda: ops.grouped_matmul(x, w)
    out = run()
    want = moe_gmm.grouped_matmul_plain(x, w)
    err = compare(f"grouped_matmul E={E} cap={cap} {d_in}->{d_out} {dname(dtype)}", out,
                  want, dtype)
    planned = lower_torch.plan_gemm_blocks(cap, d_out, d_in, dtype)
    body = G.gemm_body(dtype, d_in, d_out, x.data_ptr(), w.data_ptr())
    res = {"name": "grouped_matmul", "shape": f"E={E} cap={cap} {d_in}->{d_out}",
           "dtype": dname(dtype), "serving": serving,
           "block": list(ops.gemm_launch_block(cap, d_out, d_in, dtype, planned)),
           "body": body, "max_abs_err": err, "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(lambda: moe_gmm.grouped_matmul_plain(x, w)),
           "library_ms": timer.ms(lambda: torch.bmm(x, w))}
    res.update(bound(2.0 * E * cap * d_in * d_out, nbytes(x, w, out), dtype))
    if serving and body == "tma":
        on_body = lambda body, t: moe_gmm.grouped_matmul_on_body(x, w, body, block=t)
        res.update(staged_body(timer, on_body, want, dtype, tuple(res["block"])))
    return res


def wkv6_inputs(gen, dev, BH, T, d, dtype, floor=False):
    """r, k, v ~ N(0, 1), u ~ N(0, 1/4) and log-decays as the model draws
    them (``-exp`` of a normal, floored at -4); ``floor`` puts every decay in
    [-4, 0], which at chunk 32 drives a masked score past float32's range."""
    r, k, v = (torch.randn(BH, T, d, generator=gen, device=dev) for _ in range(3))
    if floor:
        log_w = -4.0 * torch.rand(BH, T, d, generator=gen, device=dev)
    else:
        log_w = (-torch.exp(torch.randn(BH, T, d, generator=gen, device=dev))).clamp(min=-4.0)
    u = torch.randn(BH, d, generator=gen, device=dev) * 0.5
    return [x.to(dtype) for x in (r, k, v, log_w, u)]


def compare_state(name: str, got: torch.Tensor, want: torch.Tensor, rel: float = 2e-3):
    """Largest difference of two float32 states relative to the largest entry."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: state shape {tuple(got.shape)} or non-finite values")
    err = ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
    if err > rel:
        raise AssertionError(f"{name}: final states disagree, relative error {err} > {rel}")
    return err


def wkv6_case(timer, gen, BH, T, d, chunk, dtype, serving, floor=False):
    """K5 through ``ops.wkv6`` (chunk fitted to T) against its plain version.
    No single PyTorch call computes this function, so there is no library
    time.  The bound counts the bytes of the five inputs, the output and the
    final state, and the float32 multiply-adds the chunked scan needs (the
    state read and update, 4 C d^2 a chunk, and the strictly lower
    triangle of the scores and their product with v, 2 C (C - 1) d), at the
    float32 rate: the function is defined with float32 arithmetic inside."""
    from repro_torch.kernels import ops, rwkv6 as K
    dev = timer.flush.device
    xs = wkv6_inputs(gen, dev, BH, T, d, dtype, floor)
    c = ops.fit_block(T, chunk)
    run = lambda: ops.wkv6(*xs, chunk=chunk)
    plain = lambda: K.wkv6_plain(*xs, chunk=c)
    (o, state), (po, pstate) = run(), plain()
    label = f"BH={BH} T={T} d={d} chunk={c}" + (" decays in [-4, 0]" if floor else "")
    tol = 2e-3 if dtype == torch.float32 else TOL[dtype]
    err = compare(f"wkv6 {label} {dname(dtype)}", o, po, dtype, tol=tol)
    state_err = compare_state(f"wkv6 {label} {dname(dtype)}", state, pstate)
    res = {"name": "wkv6", "shape": label, "dtype": dname(dtype), "serving": serving,
           "max_abs_err": err, "state_rel_err": state_err, "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(plain), "library_ms": None}
    flops = 2.0 * BH * (T // c) * (2 * c * d * d + c * (c - 1) * d)
    res.update(bound(flops, nbytes(*xs, o, state), torch.float32))
    return res


def wkv6_bwd_flops(BH: int, T: int, d: int, c: int) -> float:
    """Float32 operations the chunked backward needs, per chunk of c steps:
    five (c x d) by (d x d) products (the state recomputed, dO S0^T,
    v G1^T, KC G1, A^T dO) and five over the strictly lower triangle of the
    pairs (dP, P, dP KS, dP^T RS, P^T dO), two operations a multiply-add."""
    return 2.0 * BH * (T // c) * (5 * c * d * d + 5 * (c * (c - 1) // 2) * d)


def wkv6_bwd_case(timer, gen, BH, T, d, chunk, dtype, serving, floor=False):
    """K5-bwd (dr, dk, dv, dlog_w, du) against its plain version on the same
    inputs and output gradient: each output within 2e-3 (float32) or 2e-2
    (bf16) of its largest entry.  No PyTorch call computes a WKV backward,
    so there is no library time.  The bound counts the bytes of the six
    inputs and five outputs (the kernel's float32 scratch row is its own)
    and :func:`wkv6_bwd_flops` at the float32 rate."""
    from repro_torch.kernels import ops, rwkv6_bwd as KB
    dev = timer.flush.device
    xs = wkv6_inputs(gen, dev, BH, T, d, dtype, floor)
    xs.append(torch.randn(BH, T, d, generator=gen, device=dev).to(dtype))
    c = ops.fit_block(T, chunk)
    run = lambda: KB.wkv6_bwd(*xs, chunk=c)
    plain = lambda: KB.wkv6_bwd_plain(*xs, chunk=c)
    got, want = run(), plain()
    label = f"BH={BH} T={T} d={d} chunk={c}" + (" decays in [-4, 0]" if floor else "")
    rel = 2e-3 if dtype == torch.float32 else TOL[dtype]
    errs = {}
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        scale = max(w.float().abs().max().item(), 1e-30)
        errs[name] = compare(f"wkv6_bwd {name} {label} {dname(dtype)}", g.float() / scale,
                             w.float() / scale, dtype, tol=rel) * scale
    res = {"name": "wkv6_bwd", "shape": label, "dtype": dname(dtype), "serving": serving,
           "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
           "kernel_ms": timer.ms(run), "plain_ms": timer.ms(plain, n=5), "library_ms": None,
           "library": "none: no PyTorch call computes a WKV backward"}
    res.update(bound(wkv6_bwd_flops(BH, T, d, c), nbytes(*xs, *got), torch.float32))
    res.update(wkv6_bwd_residency(BH, d, c, dtype))
    return res


def wkv6_bwd_cases(timer, gen) -> list:
    """K5-bwd at rwkv6-3b's training pass (bf16 first: the shape the kernels
    line reports), the other head dims, an odd T (chunk 1) and decays at the
    floor with chunk 32."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    rcfg = get_config(RWKV_ARCH)
    rH, rd = rwkv6._n_heads(rcfg), rwkv6._head_dim(rcfg)
    cases = [wkv6_bwd_case(timer, gen, BATCH * rH, PROMPT, rd, rwkv6.WKV_CHUNK, dtype,
                           serving=dtype == torch.bfloat16)
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [wkv6_bwd_case(timer, gen, 8, 128, d_, 16, torch.float32, False) for d_ in (16, 32)]
    cases += [wkv6_bwd_case(timer, gen, 8, 101, rd, rwkv6.WKV_CHUNK, dtype, False)
              for dtype in (torch.bfloat16, torch.float32)]
    cases.append(wkv6_bwd_case(timer, gen, 16, 256, rd, 32, torch.float32, False, floor=True))
    return cases


def wkv6_bwd_residency(BH: int, d: int, c: int, dtype) -> dict:
    """K5-bwd's launch as its Python mirror gives it (blocks a row, shared
    memory, blocks an SM, waves on this card's SMs) and the clusters the
    card holds at once (cudaOccupancyMaxActiveClusters); empty for a
    checkout without them."""
    from repro_torch.kernels import _build, rwkv6_bwd as KB
    if not hasattr(KB, "wkv6_bwd_geometry"):
        return {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = KB.wkv6_bwd_geometry(BH, d, c, torch.empty((), dtype=dtype).element_size(), sms=sms)
    clusters = _build.lib().repro_wkv6_bwd_max_clusters(d, c, int(dtype == torch.bfloat16))
    return {"geometry": geo, "max_active_clusters": clusters,
            "resident_at_once": clusters >= BH}


def flash_bwd_case(timer, gen, B, H, Hkv, Sq, Skv, d, causal, dtype, serving, model=None):
    """K2-bwd (dq, dk, dv) against its plain version, from the forward
    kernel's output and log-sum-exp (itself checked against the plain
    forward's).  Library time: the backward alone of
    scaled_dot_product_attention on the same inputs.  The bound counts the
    five products over the visible (query, key) pairs (S and dP again, dV,
    dQ, dK) and the bytes of q, k, v, o, dout, lse, dq, dk, dv."""
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
    dev = timer.flush.device
    g = H // Hkv
    q, k4, v4 = _qkv(gen, dev, B, H, Hkv, Sq, Skv, d, dtype)
    dout = torch.randn(B * H, Sq, d, generator=gen, device=dev).to(dtype)
    out, lse = FA.flash_attention(q, k4, v4, causal=causal, q_per_kv=g, block_q=64,
                                  block_kv=64, return_lse=True)
    pout, plse = FA.flash_attention_plain(q, k4, v4, causal=causal, q_per_kv=g,
                                          return_lse=True)
    lse_err = compare("flash_attention lse", lse, plse, torch.float32, tol=1e-4)
    compare("flash_attention with lse", out, pout, dtype)
    run = lambda: FAB.flash_attention_bwd(q, k4, v4, out, lse, dout, causal=causal,
                                          q_per_kv=g)
    plain = lambda: FAB.flash_attention_bwd_plain(q, k4, v4, out, lse, dout, causal=causal,
                                                  q_per_kv=g)
    label = (f"BH={B * H} kv_heads={B * Hkv} Sq={Sq} Skv={Skv} d={d} causal={causal}")
    err = max(compare(f"flash_attention_bwd {name} {label} {dname(dtype)}", a, b, dtype)
              for name, a, b in zip(("dq", "dk", "dv"), run(), plain()))
    q4 = q.reshape(B, H, Sq, d).detach().requires_grad_()
    kl, vl = (t.detach().contiguous().requires_grad_() for t in (k4, v4))
    lib_out = F.scaled_dot_product_attention(q4, kl, vl, is_causal=causal, enable_gqa=g > 1)
    dout4 = dout.reshape(B, H, Sq, d)
    lib = lambda: torch.autograd.grad(lib_out, (q4, kl, vl), dout4, retain_graph=True)
    visible = Sq * (Sq + 1) // 2 if causal and Sq <= Skv else Sq * Skv
    if causal and Sq > Skv:
        visible = Skv * (Skv + 1) // 2 + (Sq - Skv) * Skv
    res = {"name": "flash_attention_bwd", "shape": label, "dtype": dname(dtype),
           "serving": serving, "model": model, "max_abs_err": err, "lse_max_abs_err": lse_err,
           "kernel_ms": timer.ms(run), "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    res.update(bound(5 * 2.0 * B * H * visible * d,
                     nbytes(q, k4, v4, out, lse, dout) + nbytes(q, k4, v4), dtype))
    return res


def gemm_bwd_case(timer, gen, M, N, K, dtype, serving):
    """K1-bwd: dA = dC B^T and dB = A^T dC through ``ops.matmul``'s
    backward (two planner-blocked K1 launches that read ``b`` and ``a`` as
    stored: dA with B stored (N, K), dB with A stored (K, M), on the TMA
    body in bf16), against the plain products; library: two
    ``torch.matmul``.  The backward's pieces are read from a trace of its
    call (:func:`launched_kernels`): ``dA_ms`` and ``dB_ms`` the first and
    second product it launches, ``copy_ms`` every other kernel, such as a
    transposing copy of an operand (none where both are read in place).
    ``body`` names each product's body and operand layouts as
    ``gemm.operand_body`` / ``operand_layouts`` give them for the views the
    backward hands over."""
    from repro_torch.kernels import gemm as G, ops
    dev = timer.flush.device
    a = (torch.randn(M, K, generator=gen, device=dev) * K ** -0.5).to(dtype).requires_grad_()
    b = torch.randn(K, N, generator=gen, device=dev).to(dtype).requires_grad_()
    dc = torch.randn(M, N, generator=gen, device=dev).to(dtype)
    out = ops.matmul(a, b)
    run = lambda: torch.autograd.grad(out, (a, b), dc, retain_graph=True)
    at, bt = a.detach().t(), b.detach().t()
    plain = lambda: (G.gemm_plain(dc, bt), G.gemm_plain(at, dc))
    label = f"({M},{K})@({K},{N})"
    err = max(compare(f"gemm_bwd {n} {label} {dname(dtype)}", x, y, dtype)
              for n, x, y in zip(("da", "db"), run(), plain()))
    lib = lambda: (torch.matmul(dc, bt), torch.matmul(at, dc))
    launched = launched_kernels(timer, run)
    products = [k["ms"] for k in launched if "gemm" in k["name"]]
    if len(products) != 2:
        raise AssertionError(f"K1-bwd {label}: {len(products)} products launched, not 2: "
                             f"{launched}")
    body = {name: {"body": G.operand_body(x, y), "transposed": G.operand_layouts(x, y)}
            for name, x, y in (("dA", dc, bt), ("dB", at, dc))
            if hasattr(G, "operand_body")}             # a checkout before the layout rule: none
    res = {"name": "gemm_bwd", "shape": label, "dtype": dname(dtype), "serving": serving,
           "body": body, "max_abs_err": err, "kernel_ms": timer.ms(run),
           "dA_ms": products[0], "dB_ms": products[1],
           "copy_ms": sum((k["ms"] for k in launched if "gemm" not in k["name"]), 0.0),
           "launched": [k["name"][:96] for k in launched],
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    res.update(bound(2 * 2.0 * M * N * K, nbytes(a, b, dc) + nbytes(a, b), dtype))
    return res


def launched_kernels(timer, fn, n: int = 10) -> list:
    """The kernels one call of ``fn`` launches, in launch order, each with
    its median device time (ms) over ``n`` calls traced by ``torch.profiler``,
    the L2 flushed before each: what a wrapper's call is made of, whatever
    the checkout's design.  A trace now and then misses some of the call's
    kernels, so up to 3 n calls are traced and the launch sequence that most
    traces agree on (the longest, between two as common) is the call's; at
    least n traces must agree on it."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile
    fn()
    runs = []
    for _ in range(3 * n):
        timer.flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted((ev for ev in prof.events()
                          if "cuda" in str(getattr(ev, "device_type", "")).lower()
                          and ev.device_time_total > 0), key=lambda ev: ev.time_range.start)
        runs.append([(ev.name, ev.device_time_total / 1e3) for ev in kernels])
        seqs = Counter(tuple(name for name, _ in run) for run in runs if run)
        if seqs and seqs.most_common(1)[0][1] >= n:
            break
    seqs = Counter(tuple(name for name, _ in run) for run in runs if run)
    if not seqs:
        raise AssertionError(f"no trace of {len(runs)} recorded any kernel")
    names, count = max(seqs.items(), key=lambda kv: (kv[1], len(kv[0])))
    if count < n:
        raise AssertionError(f"one call launched different kernels from call to call: "
                             f"{dict(seqs)}")
    agree = [run for run in runs if tuple(name for name, _ in run) == names]
    return [{"name": name, "ms": statistics.median(run[i][1] for run in agree)}
            for i, name in enumerate(names)]


def grouped_bwd_case(timer, gen, E, cap, d_in, d_out, dtype, serving):
    """K4-bwd: dX_e = dY_e W_e^T and dW_e = X_e^T dY_e, each rounded once to
    the operands' dtype, through ``ops.grouped_matmul``'s backward, against
    the plain products; library: two ``torch.bmm``.  The dW product has
    K = cap; which body it runs on is read from the launch counters, not
    assumed.  The backward's pieces are read from a trace of its call
    (:func:`launched_kernels`): ``dx_ms`` and ``dw_ms`` the first and second
    product it launches, ``copy_ms`` every other kernel, such as a
    transposing copy of an operand (none where the TMA body reads ``w`` and
    ``x`` as they are stored)."""
    from repro_torch import kernels
    from repro_torch.kernels import moe_gmm, ops
    dev = timer.flush.device
    x = torch.randn(E, cap, d_in, generator=gen, device=dev).to(dtype).requires_grad_()
    w = (torch.randn(E, d_in, d_out, generator=gen, device=dev)
         * d_in ** -0.5).to(dtype).requires_grad_()
    dy = torch.randn(E, cap, d_out, generator=gen, device=dev).to(dtype)
    out = ops.grouped_matmul(x, w)
    run = lambda: torch.autograd.grad(out, (x, w), dy, retain_graph=True)
    xt, wt = x.detach().transpose(1, 2), w.detach().transpose(1, 2)
    plain = lambda: (moe_gmm.grouped_matmul_plain(dy, wt),
                     moe_gmm.grouped_matmul_plain(xt, dy))
    label = f"E={E} cap={cap} {d_in}->{d_out}"
    before = kernels.launches_by_body()["grouped_matmul"]
    got = run()
    after = kernels.launches_by_body()["grouped_matmul"]
    err = max(compare(f"grouped_matmul_bwd {n} {label} {dname(dtype)}", a, b, dtype)
              for n, a, b in zip(("dx", "dw"), got, plain()))
    lib = lambda: (torch.bmm(dy, wt), torch.bmm(xt, dy))
    launched = launched_kernels(timer, run)
    products = [k["ms"] for k in launched if "gemm" in k["name"]]
    if len(products) != 2:
        raise AssertionError(f"K4-bwd {label}: {len(products)} products launched, not 2: "
                             f"{launched}")
    res = {"name": "grouped_matmul_bwd", "shape": label, "dtype": dname(dtype),
           "serving": serving, "launches_by_body": {k: after[k] - before[k] for k in after},
           "max_abs_err": err, "kernel_ms": timer.ms(run), "dx_ms": products[0],
           "dw_ms": products[1],
           "copy_ms": sum((k["ms"] for k in launched if "gemm" not in k["name"]), 0.0),
           "launched": [k["name"][:96] for k in launched],
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    res.update(bound(2 * 2.0 * E * cap * d_in * d_out,
                     nbytes(x, w, dy) + nbytes(x, w), dtype))
    return res


# -------------------------------------------------------------------- phases
def phase_kernels(timer, gen):
    from repro_torch.configs import get_config
    from repro_torch.core import lower_torch
    cfg = get_config(ARCH)
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    M, K, N = BATCH * PROMPT, cfg.d_model, cfg.d_ff
    buffer_len = PROMPT + NEW_TOKENS + 1
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        block = lower_torch.plan_gemm_blocks(M, N, K, dtype)
        cases.append(gemm_case(timer, gen, M, N, K, dtype, block, serving=True))
        cases.append(gemm_case(timer, gen, 96, 64, 160, dtype, (128, 128, 128), False))
        cases.append(flash_case(timer, gen, BATCH, H, Hkv, PROMPT, PROMPT, d, True, dtype,
                                serving=True, model=cfg.name))
        cases.append(flash_case(timer, gen, 1, 2, 2, 128, 384, 64, False, dtype, False))
        cases += decode_cases(timer, gen, BATCH, H, Hkv, buffer_len, PROMPT + 1, d, dtype,
                              serving=True, model=cfg.name)
        cases += decode_cases(timer, gen, 1, 4, 4, 2048, None, 64, dtype, False, splits=8)
    # K2 at the MoE's prefill (32 query heads on 4 kv heads per sequence)
    from repro_torch.models import moe
    mcfg = get_config(MOE_ARCH)
    cases.append(flash_case(timer, gen, BATCH, mcfg.n_heads, mcfg.n_kv_heads, PROMPT, PROMPT,
                            mcfg.head_dim_, True, torch.bfloat16, serving=True, model=mcfg.name))
    # K3 at the MoE's decode (32 query heads on 4 kv heads per sequence)
    cases += decode_cases(timer, gen, BATCH, mcfg.n_heads, mcfg.n_kv_heads, buffer_len,
                          PROMPT + 1, mcfg.head_dim_, torch.bfloat16, serving=True,
                          model=mcfg.name)
    # K2 and K3 at head dim 64, at the shapes the hybrid, VLM and
    # encoder-decoder serves give them: group sizes 1 and 7, a prompt pass
    # of 256 patches + 512 tokens, and non-causal passes with Sq != Skv
    for model, B_, H_, Hkv_, Sq, Skv, causal in served_flash_d64():
        cases.append(flash_case(timer, gen, B_, H_, Hkv_, Sq, Skv, 64, causal,
                                torch.bfloat16, serving=True, model=model))
    for model, B_, H_, Hkv_, T, valid in served_decode_d64():
        cases += decode_cases(timer, gen, B_, H_, Hkv_, T, valid, 64, torch.bfloat16,
                              serving=True, model=model, stages=False)
    # the grouped GEMM at the MoE's served shapes, decode gate/up first (the
    # shape with most launches, the one the kernels line reports), then at
    # deepseek-moe-16b's prefill shapes and one ragged float32 shape
    E, d, f = mcfg.n_experts, mcfg.d_model, mcfg.moe_d_ff
    for cap in (moe._capacity(BATCH, mcfg), moe._capacity(BATCH * PROMPT, mcfg)):
        cases.append(grouped_case(timer, gen, E, cap, d, f, torch.bfloat16, True))
        cases.append(grouped_case(timer, gen, E, cap, f, d, torch.bfloat16, True))
    dcfg = get_config("deepseek-moe-16b")
    dcap = moe._capacity(BATCH * PROMPT, dcfg)
    for d_in, d_out in ((dcfg.d_model, dcfg.moe_d_ff), (dcfg.moe_d_ff, dcfg.d_model)):
        cases.append(grouped_case(timer, gen, dcfg.n_experts, dcap, d_in, d_out,
                                  torch.bfloat16, False))
    cases.append(grouped_case(timer, gen, 8, 24, 96, 160, torch.float32, False))
    # K5 at rwkv6-3b's prefill (40 heads of 64 per sequence, chunk 16), the
    # reference's sweep shapes, a ragged T (100 -> chunk 4) and decays at
    # the floor with chunk 32
    from repro_torch.models import rwkv6
    rcfg = get_config(RWKV_ARCH)
    rH, rd = rwkv6._n_heads(rcfg), rwkv6._head_dim(rcfg)
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(wkv6_case(timer, gen, BATCH * rH, PROMPT, rd, rwkv6.WKV_CHUNK, dtype,
                               serving=True))
    for T, chunk in ((64, 32), (128, 32), (96, 16)):
        cases.append(wkv6_case(timer, gen, 3, T, 32, chunk, torch.float32, False))
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(wkv6_case(timer, gen, 8, 100, rd, rwkv6.WKV_CHUNK, dtype, False))
    cases.append(wkv6_case(timer, gen, 16, 256, rd, 32, torch.float32, False, floor=True))
    cases += wkv6_bwd_cases(timer, gen)
    # the backward kernels: K2-bwd at the prompt passes training runs (d 128:
    # qwen2.5-3b first, the shape with the most launches, then the MoE; d 64:
    # zamba2, internvl2, seamless's encoder and cross pass) and one ragged
    # shape, K1-bwd at qwen2.5-3b's projection, K4-bwd at the MoE's prefill
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(flash_bwd_case(timer, gen, BATCH, H, Hkv, PROMPT, PROMPT, cfg.head_dim_,
                                    True, dtype, serving=dtype == torch.bfloat16,
                                    model=cfg.name))
        cases.append(flash_bwd_case(timer, gen, 1, 6, 2, 100, 77, 64, True, dtype, False))
    cases.append(flash_bwd_case(timer, gen, BATCH, mcfg.n_heads, mcfg.n_kv_heads, PROMPT,
                                PROMPT, mcfg.head_dim_, True, torch.bfloat16, serving=True,
                                model=mcfg.name))
    for model, B_, H_, Hkv_, Sq, Skv, causal in served_flash_d64():
        cases.append(flash_bwd_case(timer, gen, B_, H_, Hkv_, Sq, Skv, 64, causal,
                                    torch.bfloat16, serving=True, model=model))
    cases.append(gemm_bwd_case(timer, gen, M, N, K, torch.bfloat16, True))
    cases.append(gemm_bwd_case(timer, gen, 96, 64, 160, torch.float32, False))
    for d_in, d_out in ((d, f), (f, d)):
        cases.append(grouped_bwd_case(timer, gen, E, moe._capacity(BATCH * PROMPT, mcfg), d_in,
                                      d_out, torch.bfloat16, True))
    cases.append(grouped_bwd_case(timer, gen, 8, 24, 96, 160, torch.float32, False))
    emit({"phase": "kernels", "timing": "median of 25 single launches, L2 flushed "
          "before each, CUDA events", "cases": cases, "plain_modules": [ssd_case(timer, gen)]})
    return cases


def ssd_case(timer, gen) -> dict:
    """The Mamba2 SSD scan, plain PyTorch as in the reference (no kernel of
    the port runs it), at zamba2-1.2b's prefill shape, once per Mamba2 layer
    of a prompt pass.  Its CUDA-event time brackets the host issuing some
    hundred small operations, so the device's busy time of one call is read
    from ``torch.profiler`` as well."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import mamba2
    cfg = get_config(HYBRID_ARCH)
    dev = timer.flush.device
    _, H, dh, ds = mamba2.dims(cfg)
    x = torch.randn(BATCH, PROMPT, H, dh, generator=gen, device=dev).to(torch.bfloat16)
    dt = F.softplus(torch.randn(BATCH, PROMPT, H, generator=gen, device=dev))
    A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.5)
    Bm, Cm = (torch.randn(BATCH, PROMPT, ds, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    scan = lambda: mamba2.ssd_chunked(x, dt, A, Bm, Cm)
    ms = timer.ms(scan, n=10)
    traced = serve._traced(scan, dev, 3)
    return {"name": "ssd_chunked", "model": cfg.name, "route": "plain PyTorch",
            "shape": f"B={BATCH} T={PROMPT} H={H} dh={dh} ds={ds} chunk=32",
            "ms": ms, "device_busy_ms": traced["device_busy_ms"],
            "calls_per_prefill": cfg.n_layers,
            "device_busy_ms_per_prefill": traced["device_busy_ms"] * cfg.n_layers}


def served_flash_d64():
    """(model, batch, q heads, kv heads, Sq, Skv, causal) of every K2 call
    shape of the three head-dim-64 serves."""
    from repro_torch.configs import get_config
    z, i, s = (get_config(a) for a in (HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH))
    vlm_len = i.frontend_len + PROMPT
    return [(z.name, BATCH, z.n_heads, z.n_kv_heads, PROMPT, PROMPT, True),
            (i.name, BATCH, i.n_heads, i.n_kv_heads, vlm_len, vlm_len, True),
            (s.name + " encoder", BATCH, s.n_heads, s.n_kv_heads, s.frontend_len,
             s.frontend_len, False),
            (s.name + " cross", BATCH, s.n_heads, s.n_kv_heads, PROMPT, s.frontend_len, False)]


def served_decode_d64():
    """(model, batch, q heads, kv heads, buffer, valid) of every K3 call
    shape of the three head-dim-64 serves at their first decode step."""
    from repro_torch.configs import get_config
    z, i, s = (get_config(a) for a in (HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH))
    return [(z.name, BATCH, z.n_heads, z.n_kv_heads, PROMPT + NEW_TOKENS + 1, PROMPT + 1),
            (i.name, BATCH, i.n_heads, i.n_kv_heads,
             i.frontend_len + PROMPT + NEW_TOKENS + 1, i.frontend_len + PROMPT + 1),
            (s.name + " cross", BATCH, s.n_heads, s.n_kv_heads, s.frontend_len, None)]


def phase_planner(timer, gen):
    from repro_torch import kernels, plancache
    from repro_torch.configs import get_config
    from repro_torch.core import lower_torch
    from repro_torch.kernels import flash_attention as FA, gemm as G, ops
    cfg = get_config(ARCH)
    M, K, N = BATCH * PROMPT, cfg.d_model, cfg.d_ff
    dev = timer.flush.device
    dtype = torch.bfloat16
    shape = (M, N, K)
    request = ("gemm_blocks", shape + (2,))            # 2-byte elements
    first_blocks, first_source = lower_torch.resolved_blocks()[request]
    # the kernels phase planned every serving shape; clearing the caches
    # also clears the fallback counter, so read it first
    first_fallbacks = lower_torch.planner_fallback_count()
    # a "fresh process": drop the in-process tiers, keep the registry on disk
    lower_torch.clear_block_caches()
    plancache.get_store().clear_memory()
    a = (torch.randn(M, K, generator=gen, device=dev) * K ** -0.5).to(dtype)
    b = torch.randn(K, N, generator=gen, device=dev).to(dtype)
    kernels.reset_launch_counts()
    out = ops.matmul(a, b)
    launches = kernels.launch_counts()["gemm"]
    by_body = kernels.launches_by_body()["gemm"]
    err = compare("planner -> gemm", out, G.gemm_plain(a, b), dtype)
    blocks, source = lower_torch.resolved_blocks()[request]
    fallbacks = first_fallbacks + lower_torch.planner_fallback_count()
    if launches != 1 or by_body != {"tma": 1, "staged": 0} or fallbacks != 0 \
            or blocks != first_blocks:
        raise AssertionError(f"planner phase: launches={launches} by body {by_body} "
                             f"fallbacks={fallbacks} blocks {first_blocks} -> {blocks}")
    if (first_source, source) != ("search", "cache"):
        raise AssertionError(f"expected a search then a registry hit, got "
                             f"{first_source} then {source}")
    # how good was the choice: every compiled bf16 tile of both bodies at the
    # same shape
    tiles = {str(t): timer.ms(lambda t=t: G.gemm_on_body(a, b, G.tile_body(t), block=t), n=10)
             for t in G.COMPILED_TILES}
    gemm_ranked = sorted(tiles, key=tiles.get)
    # and K4's: every TMA tile at the MoE's two prefill shapes, forward and
    # the backward's dX = dY W^T and dW = X^T dY (operands as the backward
    # hands them over), against the tile the planner gives each product
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import moe
    mcfg = get_config(MOE_ARCH)
    cap = moe._capacity(BATCH * PROMPT, mcfg)

    def tile_ranks(product, M, N, K):
        chosen = ops.gemm_launch_block(M, N, K, dtype,
                                       lower_torch.plan_gemm_blocks(M, N, K, dtype))
        times = {str(t): timer.ms(lambda t=t: product(t), n=10) for t in G.TMA_TILES}
        order = sorted(times, key=times.get)
        return {"blocks": list(chosen), "tile_ms": times,
                "blocks_rank": order.index(str(chosen)) + 1,
                "blocks_vs_fastest": times[str(chosen)] / times[order[0]]}

    grouped = {}
    for d_in, d_out in ((mcfg.d_model, mcfg.moe_d_ff), (mcfg.moe_d_ff, mcfg.d_model)):
        x = torch.randn(mcfg.n_experts, cap, d_in, generator=gen, device=dev).to(dtype)
        w = torch.randn(mcfg.n_experts, d_in, d_out, generator=gen, device=dev).to(dtype)
        dy = torch.randn(mcfg.n_experts, cap, d_out, generator=gen, device=dev).to(dtype)
        xt, wt = x.transpose(1, 2), w.transpose(1, 2)
        res = tile_ranks(lambda t: moe_gmm.grouped_matmul(x, w, block=t), cap, d_out, d_in)
        res["backward"] = {
            "dx": tile_ranks(lambda t: moe_gmm.grouped_matmul(dy, wt, block=t), cap, d_in, d_out),
            "dw": tile_ranks(lambda t: moe_gmm.grouped_matmul(xt, dy, block=t), d_in, d_out, cap)}
        grouped[f"E={mcfg.n_experts} cap={cap} {d_in}->{d_out}"] = res
        del x, w, dy, xt, wt
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k4, v4 = _qkv(gen, dev, BATCH, H, Hkv, PROMPT, PROMPT, d, dtype)
    flash_blocks = lower_torch.plan_flash_blocks(PROMPT, PROMPT, d, dtype)
    flash_tiles = {str(t): timer.ms(lambda t=t: FA.flash_attention(
        q, k4, v4, causal=True, block_q=t[0], block_kv=t[1], q_per_kv=H // Hkv), n=10)
        for t in lower_torch.flash_tile_options(d, 2)}
    ranked = sorted(flash_tiles, key=flash_tiles.get)
    chosen = str(tuple(flash_blocks))
    plan_service_line(lower_torch.gemm_programs(M, N, K, dtype),
                      lower_torch.flash_programs(PROMPT, PROMPT, d, dtype), blocks, flash_blocks)
    # and at head dim 64: zamba2's causal prefill and seamless's encoder
    flash_d64 = {}
    for model, B_, H_, Hkv_, Sq, Skv, causal in served_flash_d64()[::2]:
        q, k4, v4 = _qkv(gen, dev, B_, H_, Hkv_, Sq, Skv, 64, dtype)
        planned = str(tuple(lower_torch.plan_flash_blocks(Sq, Skv, 64, dtype)))
        times = {str(t): timer.ms(lambda t=t: FA.flash_attention(
            q, k4, v4, causal=causal, block_q=t[0], block_kv=t[1], q_per_kv=H_ // Hkv_), n=10)
            for t in lower_torch.flash_tile_options(64, 2)}
        order = sorted(times, key=times.get)
        flash_d64[model] = {"shape": [Sq, Skv, 64], "causal": causal, "blocks": planned,
                            "tile_ms": times, "blocks_rank": order.index(planned) + 1,
                            "blocks_vs_fastest": times[planned] / times[order[0]]}
    # the second entry point's gradient: ops.matmul's backward, two
    # planner-blocked K1 launches that read b and a as stored
    a_, b_ = a.detach().requires_grad_(), b.detach().requires_grad_()
    dc = torch.randn(M, N, generator=gen, device=dev).to(dtype)
    gemm_bwd_tiles = {
        "dA": tile_ranks(lambda t: G.gemm(dc, b.t(), block=t), M, K, N),
        "dB": tile_ranks(lambda t: G.gemm(a.t(), dc, block=t), K, N, M)}
    with backward_launches() as bwd:
        ops.matmul(a_, b_).backward(dc)
    bwd_err = max(compare("planner -> gemm backward dA", a_.grad, G.gemm_plain(dc, b.t()), dtype),
                  compare("planner -> gemm backward dB", b_.grad, G.gemm_plain(a.t(), dc), dtype))
    if bwd["gemm_bwd"] != 2:
        raise AssertionError(f"planner phase: ops.matmul's backward made {bwd} launches")
    emit({"phase": "planner", "gemm_shape": list(shape), "gemm_blocks": list(blocks),
          "gemm_bwd_launches": bwd["gemm_bwd"], "gemm_bwd_max_abs_err": bwd_err,
          "gemm_bwd_tiles": gemm_bwd_tiles,
          "first": first_source, "second": source, "planner_fallbacks": fallbacks,
          "gemm_launches": launches, "gemm_launches_by_body": by_body, "max_abs_err": err,
          "gemm_tile_ms": tiles, "gemm_blocks_rank": gemm_ranked.index(str(tuple(blocks))) + 1,
          "gemm_blocks_vs_fastest": tiles[str(tuple(blocks))] / tiles[gemm_ranked[0]],
          "grouped_prefill_tiles": grouped,
          "flash_shape": [PROMPT, PROMPT, d], "flash_blocks": list(flash_blocks),
          "flash_tile_ms": flash_tiles, "flash_blocks_rank": ranked.index(chosen) + 1,
          "flash_blocks_vs_fastest": flash_tiles[chosen] / flash_tiles[ranked[0]],
          "flash_d64": flash_d64})
    return launches, by_body, bwd["gemm_bwd"]


def plan_service_line(gemm_progs, flash_progs, gemm_blocks, flash_blocks) -> None:
    """The plan service on the served programs and the H100 model: one
    full-budget resolve to warm its registry key (bit-identical to
    ``plan_kernel_multi``), then one at the default deadline, with the rung,
    seconds and blocks of each beside the block tables' choice."""
    from repro_torch.core import lower_torch
    from repro_torch.planservice import PlanRequest, PlanService
    hw, svc = lower_torch.h100_sm(), PlanService()
    line = {"phase": "plan_service", "hw": hw.name}
    for name, progs, blocks_of, planned in (
            ("gemm", gemm_progs, lower_torch.gemm_blocks_of, gemm_blocks),
            ("flash", flash_progs, lower_torch.flash_blocks_of, flash_blocks)):
        row = {"n_programs": len(progs), "planned_blocks": list(planned)}
        for step, budget_ms in (("full", float("inf")), ("deadline", None)):
            resp = svc.resolve(PlanRequest(progs, hw, budget=lower_torch.chip_budget(),
                                           budget_ms=budget_ms, profile=False,
                                           background=False))
            if not resp.ok:
                raise AssertionError(f"plan service: {name} {step} answered {resp.outcome}")
            row[step] = {"rung": resp.rung, "outcome": resp.outcome, "seconds": resp.seconds,
                         "deadline_ms": resp.deadline_ms,
                         "blocks": list(blocks_of(resp.result))}
        if row["deadline"]["rung"] != "cache":
            raise AssertionError(f"plan service: the warm {name} request answered from "
                                 f"{row['deadline']['rung']}, not the registry")
        row["blocks_equal_planned"] = row["deadline"]["blocks"] == list(planned)
        line[name] = row
    emit(line)


class WatchedStdout(io.TextIOBase):
    """Standard output passed through unchanged and kept line by line;
    :attr:`seen` is set when a printed line first matches ``pattern``."""

    def __init__(self, out, pattern: str):
        self.out, self.pattern = out, re.compile(pattern)
        self.lines, self.match, self.seen = [], None, threading.Event()

    def write(self, text: str) -> int:
        self.out.write(text)
        self.lines.append(text)
        if self.match is None:
            self.match = self.pattern.search(text)
            if self.match is not None:
                self.seen.set()
        return len(text)

    def flush(self) -> None:
        self.out.flush()


SCRAPED = ("/metrics", "/healthz", "/slo", "/plans", "/tenants")
OBS_HOLD_S = 5.0


def scrape(url: str, path: str) -> dict:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url + path, timeout=10) as r:
        body = r.read().decode()
        return {"code": r.status, "type": r.headers.get("Content-Type"), "body": body,
                "ms": (time.perf_counter() - t0) * 1e3}


def phase_serve_obs(served: dict) -> dict:
    """``serve`` again through ``serve.main`` with the four observation
    flags; the endpoint is scraped from a thread during the hold.  Ids,
    launches and blocks must equal the ``serve`` phase's, every scrape must
    answer and validate, and the flight-recorder dump must load and render."""
    from repro_torch import kernels, plancache
    from repro_torch.core import lower_torch
    from repro_torch.launch import serve
    from repro_torch.obs import expo, flightrec, slo
    dump = os.path.join(ROOT, "build", f"flightrec-{os.getpid()}.json")
    # a fresh process's in-process tiers: the served blocks come from the
    # plan registry on disk, as /plans must show
    lower_torch.clear_block_caches()
    store = plancache.get_store()
    store.clear_memory()
    hits_before = store.stats.hits_disk
    out = WatchedStdout(sys.stdout, r"holding introspection open \S+ at (http://\S+)")
    scraped, failed = {}, []

    def scraper():
        out.seen.wait()
        if out.match is None:                # serve.main raised before its hold
            return
        try:
            for path in SCRAPED:
                scraped[path] = scrape(out.match.group(1), path)
        except Exception as err:  # noqa: BLE001 - reported below as a failure
            failed.append(repr(err))

    thread = threading.Thread(target=scraper, name="serve_obs-scraper")
    thread.start()
    kernels.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(out):
            res = serve.main(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                              "--tokens", str(NEW_TOKENS), "--seed", "0",
                              "--introspect-port", "0", "--introspect-hold", str(OBS_HOLD_S),
                              "--flightrec", dump, "--plan-budget-ms", "10"])
        launches = kernels.launch_counts()
    finally:
        out.seen.set()
        thread.join()
        flightrec.disable()
        slo.disable()
    if failed or set(scraped) != set(SCRAPED):
        raise AssertionError(f"serve_obs: scrapes failed: {failed}, answered {sorted(scraped)}")

    if not torch.equal(res.generated.cpu(), served["ids"]):
        raise AssertionError("serve_obs: the ids differ from the serve phase's")
    if launches != served["launches"] or res.launches != launches:
        raise AssertionError(f"serve_obs: launches {launches} ({res.launches} inside the run), "
                             f"serve phase {served['launches']}")
    blocks = {k: list(b) for k, (b, _) in res.blocks.items()}
    sources = {src for _, src in res.blocks.values()}
    if not blocks or sources != {"cache"} or any(
            served["blocks"].get(k) != tuple(b) for k, b in blocks.items()):
        raise AssertionError(f"serve_obs: blocks {res.blocks}, serve phase {served['blocks']}")

    metrics_ = scraped["/metrics"]
    samples = metrics_["body"].splitlines()
    problems = expo.validate_exposition(metrics_["body"])
    wanted = {
        "planservice fallback/error": lambda l: l.startswith("planservice_requests_total{")
        and 'rung="fallback"' in l and 'outcome="error"' in l,
        "plancache hit_disk": lambda l: l.startswith("plancache_get_total{")
        and 'result="hit_disk"' in l,
        "planner searches": lambda l: l.startswith("planner_searches_total")}
    missing = [k for k, f in wanted.items() if not any(f(l) for l in samples)]
    if metrics_["code"] != 200 or metrics_["type"] != expo.CONTENT_TYPE or problems or missing:
        raise AssertionError(f"serve_obs: /metrics {metrics_['code']} {metrics_['type']}: "
                             f"{problems} missing {missing}")
    health = scraped["/healthz"]
    if health["code"] != 200 or json.loads(health["body"])["ok"] is not True:
        raise AssertionError(f"serve_obs: /healthz {health}")
    slo_rep = json.loads(scraped["/slo"]["body"])
    if not slo_rep["enabled"] or slo_rep["rungs"].get("fallback", 0) < 1:
        raise AssertionError(f"serve_obs: /slo {slo_rep}")
    plans = json.loads(scraped["/plans"]["body"])
    hits = plans["process"]["hits_disk"] - hits_before
    shown = {(e["template"], tuple(e["request"])): e["blocks"] for e in plans["resolved"]
             if e["source"] == "cache"}
    if hits < len(blocks) or shown != blocks:
        raise AssertionError(f"serve_obs: /plans shows {hits} registry hits and {shown}, "
                             f"served {blocks}")
    tenants = json.loads(scraped["/tenants"]["body"])
    if tenants != {"mode": "model", "tenants": []}:
        raise AssertionError(f"serve_obs: /tenants {tenants}")

    doc = flightrec.load_dump(dump)
    mesh = [e for e in doc["events"] if e["kind"] == "plan_request" and e.get("mode") == "mesh"]
    rendered = flightrec.render_incident(doc)
    if not mesh or "plan_request" not in rendered:
        raise AssertionError(f"serve_obs: the dump holds {doc['meta']}, no mesh plan_request")
    printed = "".join(out.lines)
    ranking = re.search(rf"\[serve\] {re.escape(ARCH)}: decode plan ranking "
                        rf"\(rung=(\w+) ([0-9.]+)ms\)", printed)
    if ranking is None:
        raise AssertionError("serve_obs: no ranking line")
    emit({"phase": "serve_obs", "arch": ARCH, "batch": BATCH, "prompt_len": PROMPT,
          "new_tokens": NEW_TOKENS, "flags": ["--introspect-port 0",
                                              f"--introspect-hold {OBS_HOLD_S}",
                                              "--flightrec", "--plan-budget-ms 10"],
          "prefill_ms": res.prefill_s * 1e3,
          "decode_ms_per_token": res.decode_s * 1e3 / NEW_TOKENS,
          "tok_per_s": BATCH * NEW_TOKENS / res.decode_s,
          "serve_prefill_ms": served["prefill_ms"],
          "serve_decode_ms_per_token": served["decode_ms_per_token"],
          "serve_tok_per_s": served["tok_per_s"],
          "ranking": {"rung": ranking.group(1), "printed_ms": float(ranking.group(2)),
                      "seconds": mesh[0]["seconds"], "outcome": mesh[0]["outcome"]},
          "scrape_ms": {p: scraped[p]["ms"] for p in SCRAPED},
          "metrics_bytes": len(metrics_["body"]), "plans_registry_hits": hits,
          "dump_events": len(doc["events"]), "ids_equal": True, "launches": launches,
          "blocks": {f"{t}{list(r)}": b for (t, r), b in blocks.items()}})
    return launches


def phase_serve(device):
    from repro_torch import kernels
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model
    cfg = common.launch_config(ARCH, kernels_path="cuda")
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = serve.load_params(api, device, seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)

    serve.generate(api, params, prompts, 2)            # warm-up: planner, allocator
    kernels.reset_launch_counts()
    res = serve.generate(api, params, prompts, NEW_TOKENS, keep_step_logits=True)
    launches = kernels.launch_counts()

    L = cfg.n_layers
    want = {"gemm": 0, "flash_attention": L, "flash_decode": L * NEW_TOKENS,
            "flash_decode_partials": 0, "flash_decode_combine": 0, "grouped_matmul": 0,
            "wkv6": 0, "flash_attention_bwd": 0, "wkv6_bwd": 0}
    if launches != want:
        raise AssertionError(f"serve: kernel launches {launches}, expected {want}")
    check_outputs("serve", res, cfg)
    fallbacks = check_planner("serve", res)

    # the same loop on the plain PyTorch attention, fed the kernel path's ids
    # so that one tie broken the other way cannot send the two runs apart
    plain_api = build_model(replace(cfg, kernels="plain"))
    ref = serve.generate(plain_api, params, prompts, NEW_TOKENS, keep_step_logits=True,
                         forced_ids=res.generated)
    agreement = against_plain("serve", res, ref)
    emit({"phase": "serve", "arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
          "n_params": api.n_params(), "batch": BATCH, "prompt_len": PROMPT,
          "new_tokens": NEW_TOKENS, "compute_dtype": cfg.compute_dtype,
          "load_s": load_s, "prefill_ms": res.prefill_s * 1e3,
          "decode_ms_per_token": res.decode_s * 1e3 / NEW_TOKENS,
          "tok_per_s": BATCH * NEW_TOKENS / res.decode_s,
          "plain_prefill_ms": ref.prefill_s * 1e3,
          "plain_decode_ms_per_token": ref.decode_s * 1e3 / NEW_TOKENS,
          "peak_bytes": res.peak_bytes, "launches": launches,
          "planner_fallbacks": fallbacks,
          **agreement, "first_ids": res.generated[0, :16].tolist(),
          "blocks": {f"{t}{list(s)}": [list(b), src]
                     for (t, s), (b, src) in res.blocks.items()}})
    return launches, {"ids": res.generated.cpu(), "launches": launches,
                      "blocks": {k: b for k, (b, _) in res.blocks.items()},
                      "prefill_ms": res.prefill_s * 1e3,
                      "decode_ms_per_token": res.decode_s * 1e3 / NEW_TOKENS,
                      "tok_per_s": BATCH * NEW_TOKENS / res.decode_s}


def against_plain(phase: str, res, ref) -> dict:
    """Every prefill and step logit of the kernel run within 2e-2 of the
    plain run, and every id the kernel run chose the plain run's argmax or
    tied with it that closely."""
    tol = TOL[torch.bfloat16]
    kern = [res.prefill_logits, *res.step_logits]
    plain = [ref.prefill_logits, *ref.step_logits]
    errs = [(a - b).abs().max().item() for a, b in zip(kern, plain)]
    if max(errs) > tol:
        raise AssertionError(f"{phase}: logits of the kernel and plain paths differ by "
                             f"{max(errs)} (tolerance {tol})")
    same = 0
    for i, logits in enumerate(plain[:-1]):
        chosen = logits.gather(1, res.generated[:, i:i + 1]).squeeze(1)
        gap = (logits.max(dim=1).values - chosen).max().item()
        same += int((logits.argmax(dim=1) == res.generated[:, i]).sum())
        if gap > tol:
            raise AssertionError(f"{phase}: step {i} chose an id {gap} below the plain "
                                 f"path's best logit")
    return {"max_logit_err_vs_plain": max(errs), "prefill_logit_err_vs_plain": errs[0],
            "ids_equal_plain_argmax": f"{same}/{BATCH * NEW_TOKENS}"}


def check_outputs(phase: str, res, cfg) -> None:
    if res.generated.shape != (BATCH, NEW_TOKENS) or \
            res.prefill_logits.shape != (BATCH, cfg.vocab_size):
        raise AssertionError(f"{phase}: unexpected output shapes")
    if not all(torch.isfinite(x).all() for x in [res.prefill_logits, *res.step_logits]):
        raise AssertionError(f"{phase}: non-finite logits")


def check_planner(phase: str, res) -> int:
    from repro_torch.core import lower_torch
    fallbacks = lower_torch.planner_fallback_count()
    fell_back = [k for k, (_, src) in res.blocks.items() if src == "fallback"]
    if fallbacks or fell_back:
        raise AssertionError(f"{phase}: the planner fell back {fallbacks} times, "
                             f"for {fell_back}")
    return fallbacks


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` inside the block: the script wraps the
    package's functions this way, the package has no knob for it."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def recorded_run(api, params, prompts, ids=None):
    """``serve.generate`` that records every routing decision, in call order."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    router, routed = moe._router, []

    def recording(xf, router_w, c):
        out = router(xf, router_w, c)
        routed.append(out[:2])
        return out

    with patched(moe, "_router", recording):
        res = serve.generate(api, params, prompts, NEW_TOKENS, keep_step_logits=True,
                             forced_ids=ids)
    return res, routed


def replayed_run(api, params, prompts, ids, routed):
    """``serve.generate`` fed ``ids`` and the routing another run recorded."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    router, replay = moe._router, iter(routed)
    with patched(moe, "_router",
                 lambda xf, router_w, c: (*next(replay), router(xf, router_w, c)[2])):
        res = serve.generate(api, params, prompts, NEW_TOKENS, keep_step_logits=True,
                             forced_ids=ids)
    if next(replay, None) is not None:
        raise AssertionError("moe: a replayed run made fewer router calls than the "
                             "recorded one")
    return res


def coarse(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded (half away from zero) to ``bits`` explicit mantissa bits
    in float32, returned in its own type."""
    drop = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32).to(x.dtype)


def coarse_products(bits: int):
    """The plain expert products rounded to ``bits`` explicit mantissa bits
    instead of bf16's 7: a control that a correct check must reject."""
    from repro_torch.kernels import moe_gmm
    plain = moe_gmm.grouped_matmul_plain

    def products(x, w, *, block=None, out_dtype=None):
        return coarse(plain(x, w, out_dtype=torch.float32), bits).to(out_dtype or x.dtype)

    return products


def from_float32(run, exact) -> tuple:
    """Largest and root-mean-square difference of every prefill and step
    logit of ``run`` from the float32 run."""
    diff = torch.cat([(a.float() - b.float()).flatten() for a, b in zip(
        [run.prefill_logits, *run.step_logits], [exact.prefill_logits, *exact.step_logits])])
    return diff.abs().max().item(), diff.square().mean().sqrt().item()


def within(dist, base) -> bool:
    """``dist`` from the float32 run at most 1.25 x the plain path's ``base``,
    plus 2e-2 in the largest difference.  On the card the kernel path reads
    1.00 x and 0.99 x (largest, root mean square); a control whose expert
    products keep 6 mantissa bits 1.22 x and 1.13 x, which passes; one with
    5 bits 1.65 x and 1.56 x, which fails (PERF.md)."""
    return dist[0] <= 1.25 * base[0] + 2e-2 and dist[1] <= 1.25 * base[1]


def float32_rule(res, plain_run, exact_run, greedy, controls=None) -> dict:
    """The kernel run ``res`` and the plain bf16 path against the same loop
    computed in float32 (same bf16 weights and frontend input).
    ``plain_run(ids)`` and ``exact_run(ids)`` run the plain and float32 loops
    fed ``res``'s ids (and whatever else the kernel run chose, such as its
    routing); ``controls`` maps mantissa bits to a run of a deliberately
    coarsened path, each measured against the same float32 run.  Where
    ``res`` chose its ids (``greedy``), each must be the float32 run's best
    or close enough to it that the bound on the logits allows it."""
    ids = res.generated
    ref, exact = plain_run(ids), exact_run(ids)
    kern, plain = from_float32(res, exact), from_float32(ref, exact)
    chosen_ok, same = True, 0
    for i, logits in enumerate([exact.prefill_logits, *exact.step_logits][:-1]
                               if greedy else []):
        best = logits.float().max(dim=1).values
        chosen = logits.float().gather(1, ids[:, i:i + 1]).squeeze(1)
        # both within the bound of the kernel's logits, so at most twice it apart
        chosen_ok &= bool(((best - chosen) <= 2 * (1.25 * plain[0] + 2e-2)).all())
        same += int((logits.argmax(dim=1) == ids[:, i]).sum())
    coarser = {}
    for bits, run in (controls or {}).items():
        dist = from_float32(run(ids), exact)
        coarser[bits] = {"vs_float32_max": dist[0], "vs_float32_rms": dist[1],
                         "max_ratio": dist[0] / plain[0], "rms_ratio": dist[1] / plain[1],
                         "float32_rule_rejects": not within(dist, plain)}
    return {"kernel_vs_float32_max": kern[0], "plain_vs_float32_max": plain[0],
            "kernel_vs_float32_rms": kern[1], "plain_vs_float32_rms": plain[1],
            "max_ratio": kern[0] / plain[0], "rms_ratio": kern[1] / plain[1],
            "within": within(kern, plain) and chosen_ok,
            "ids_equal_float32_argmax": f"{same}/{BATCH * NEW_TOKENS}" if greedy else None,
            "kernel_vs_plain_max": max((a - b).abs().max().item() for a, b in zip(
                [res.prefill_logits, *res.step_logits],
                [ref.prefill_logits, *ref.step_logits])),
            "max_abs_float32_logit": max(x.abs().max().item() for x in
                                         [exact.prefill_logits, *exact.step_logits]),
            "plain_prefill_ms": ref.prefill_s * 1e3,
            "plain_decode_ms_per_token": ref.decode_s * 1e3 / NEW_TOKENS,
            "_controls": coarser}


def coarse_wkv6(bits: int):
    """The plain WKV scan with its output ``o`` rounded to ``bits`` mantissa
    bits instead of bf16's 7: a control that a correct check must reject."""
    from repro_torch.kernels import rwkv6 as K
    plain = K.wkv6_plain

    def scan(*args, chunk):
        o, state = plain(*args, chunk=chunk)
        return coarse(o, bits), state

    return scan


BF16_ULP = 2.0 ** -7                  # bf16's spacing relative to a value, at most


def per_call_check(api, params, prompts, scan=None) -> dict:
    """One prefill in which every call of the WKV scan (the kernel, or
    ``scan`` in its place) is held against the plain version on the same
    inputs.  Both compute in float32 and round ``o`` to bf16 once, so they
    may differ by one bf16 step where a value lies near a rounding
    boundary: ``|o - plain| <= 2^-7 |plain| + 1e-4 max |plain|`` (the second
    term for sums that cancel), and the final state at 2e-3 relative.  A
    flat 2e-2 would pass an output with 5 mantissa bits (at most 1.6 %
    off)."""
    from repro_torch.kernels import rwkv6 as K
    kernel = scan or K.wkv6
    errs = []

    def checked(*args, chunk):
        o, state = kernel(*args, chunk=chunk)
        po, pstate = K.wkv6_plain(*args, chunk=chunk)
        diff, ref = (o.float() - po.float()).abs(), po.float().abs()
        slack = BF16_ULP * ref + 1e-4 * ref.max()
        s_err = ((state - pstate).abs().max() / pstate.abs().max().clamp(min=1e-30)).item()
        errs.append((diff.max().item(), (diff / slack).max().item(),
                     bool((diff <= slack).all()) and s_err <= 2e-3, s_err))
        return o, state

    cache = api.init_cache(api.cfg, prompts.shape[0], prompts.shape[1] + 1,
                           device=prompts.device)
    with torch.no_grad(), patched(K, "wkv6", checked):
        api.prefill(params, prompts, cache)
    return {"calls": len(errs), "o_max_abs_err": max(e[0] for e in errs),
            "o_max_share_of_bound": max(e[1] for e in errs),
            "state_max_rel_err": max(e[3] for e in errs),
            "within": len(errs) == api.cfg.n_layers and all(e[2] for e in errs)}


def phase_rwkv(device):
    """rwkv6-3b served at full size, the prompt's WKV scan through K5.

    Two correct bf16 paths end a few bf16 ulps apart, so the kernel run is
    held, with the plain run (the same loop with the kernel's plain version
    in its place, fed the kernel run's ids), against the same loop in
    float32: the kernel path may be at most 1.25 x as far from it as the
    plain path (:func:`within`), on the greedy ids and on teacher-forced
    random ids.  A logit-level bound mostly sees the bf16 rounding of every
    other tensor, so every K5 call of a prefill is also held against its
    plain version on the same inputs (:func:`per_call_check`).  A control
    whose WKV output keeps 5 mantissa bits must fail the two together; the
    share of each is reported, with 6- and 4-bit controls."""
    from repro_torch import kernels
    from repro_torch.kernels import rwkv6 as K
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model
    cfg = common.launch_config(RWKV_ARCH, kernels_path="cuda")
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = serve.load_params(api, device, seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)
    serve.generate(api, params, prompts, 2)            # warm-up: allocator, kernel build

    kernels.reset_launch_counts()
    res = serve.generate(api, params, prompts, NEW_TOKENS, keep_step_logits=True)
    launches = kernels.launch_counts()
    L = cfg.n_layers
    want = {"gemm": 0, "flash_attention": 0, "flash_decode": 0, "flash_decode_partials": 0,
            "flash_decode_combine": 0, "grouped_matmul": 0, "wkv6": L, "flash_attention_bwd": 0,
            "wkv6_bwd": 0}
    if launches != want:
        raise AssertionError(f"rwkv: kernel launches {launches}, expected {want}")
    check_outputs("rwkv", res, cfg)

    f32_api = build_model(replace(cfg, compute_dtype="float32"))

    def run(run_api, ids, scan=K.wkv6_plain):
        with patched(K, "wkv6", scan):
            return serve.generate(run_api, params, prompts, NEW_TOKENS, keep_step_logits=True,
                                  forced_ids=ids)

    def against(kern_res, greedy) -> dict:
        controls = {bits: (lambda ids, bits=bits: run(api, ids, coarse_wkv6(bits)))
                    for bits in ((6, 5, 4) if greedy else ())}
        return float32_rule(kern_res, lambda ids: run(api, ids), lambda ids: run(f32_api, ids),
                            greedy, controls)

    greedy = against(res, True)
    controls = greedy.pop("_controls")
    rand_ids = torch.randint(1, cfg.vocab_size, (BATCH, NEW_TOKENS), device=device,
                             generator=torch.Generator(device=device).manual_seed(1))
    forced = against(serve.generate(api, params, prompts, NEW_TOKENS, keep_step_logits=True,
                                    forced_ids=rand_ids), False)
    del forced["_controls"]
    per_call = per_call_check(api, params, prompts)
    for bits, ctl in controls.items():
        ctl["per_call"] = per_call_check(api, params, prompts, coarse_wkv6(bits))
        ctl["rejected"] = ctl["float32_rule_rejects"] or not ctl["per_call"]["within"]
    emit({"phase": "rwkv", "arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
          "n_params": api.n_params(), "batch": BATCH, "prompt_len": PROMPT,
          "new_tokens": NEW_TOKENS, "compute_dtype": cfg.compute_dtype, "load_s": load_s,
          "prefill_ms": res.prefill_s * 1e3,
          "decode_ms_per_token": res.decode_s * 1e3 / NEW_TOKENS,
          "tok_per_s": BATCH * NEW_TOKENS / res.decode_s, "peak_bytes": res.peak_bytes,
          "launches": launches,
          "check": "kernel path's distance from float32 at most 1.25 x the plain path's "
                   "(max + 2e-2, rms), same ids; every K5 call of a prefill within one bf16 "
                   "step (o) and 2e-3 relative (state) of its plain version on the same "
                   "inputs",
          "greedy_ids": greedy, "forced_random_ids": forced, "per_call": per_call,
          "controls": {f"{b}_mantissa_bits": c for b, c in controls.items()},
          "distinct_greedy_ids": int(res.generated.unique().numel()),
          "first_ids": res.generated[0, :16].tolist()})
    for name, check in (("greedy", greedy), ("forced random", forced)):
        if not check["within"]:
            raise AssertionError(f"rwkv ({name} ids): the kernel path is further from "
                                 f"float32 than the plain path allows: {check}")
    if not per_call["within"]:
        raise AssertionError(f"rwkv: a K5 call of the prefill disagrees with its plain "
                             f"version: {per_call}")
    if not controls[5]["rejected"]:
        raise AssertionError("rwkv: the checks did not reject the 5-bit control")
    return launches


# relative root-mean-square difference of a bf16 K2/K3 output from its plain
# version on the same inputs that a call may show: half of bf16's largest
# relative step.  Two bf16 results of the same float32 function differ by a
# step on part of the elements; an output with 5 mantissa bits is about
# 2^-5 / sqrt(12 x 2.2) = 0.0061 off on its own
ATTN_REL_RMS = 2.0 ** -8


def coarse_attention(bits: int) -> dict:
    """K2's and K3's wrappers with their outputs rounded to ``bits``
    explicit mantissa bits instead of bf16's 7: a control that a correct
    check must reject."""
    from repro_torch.kernels import ops
    attn, dec = ops.attention, ops.flash_decode
    return {"attention": lambda *a, **k: coarse(attn(*a, **k), bits),
            "flash_decode": lambda *a, **k: coarse(dec(*a, **k), bits)}


@contextlib.contextmanager
def attention_kernels(replacement: dict):
    """``ops.attention`` / ``ops.flash_decode`` replaced inside the block."""
    from repro_torch.kernels import ops
    with contextlib.ExitStack() as stack:
        for name, fn in replacement.items():
            stack.enter_context(patched(ops, name, fn))
        yield


def attention_per_call(api, params, prompts, inputs, replacement=None) -> dict:
    """One prefill and one decode step in which every K2 and K3 call (the
    kernel, or ``replacement``'s in its place) is held against the kernel's
    plain version on the same inputs: within 2e-2 (the reference's kernel
    tolerance) and at most :data:`ATTN_REL_RMS` apart in relative root mean
    square."""
    from repro_torch.kernels import flash_attention as FA, flash_decode as FD, ops
    kernels_ = {"attention": ops.attention, "flash_decode": ops.flash_decode,
                **(replacement or {})}
    stats = {"attention": [], "flash_decode": []}

    def checked(name, plain):
        def call(q, k, v, **kw):
            out = kernels_[name](q, k, v, **kw)
            want = plain(q, k, v, **kw).float()
            diff = out.float() - want
            stats[name].append((diff.abs().max().item(),
                                (diff.norm() / want.norm().clamp(min=1e-30)).item(),
                                bool(torch.allclose(out.float(), want, rtol=2e-2, atol=2e-2))))
            return out
        return call

    cfg = api.cfg
    cache = api.init_cache(cfg, prompts.shape[0], api.prefix_len() + prompts.shape[1] + 2,
                           device=prompts.device)
    with torch.no_grad(), attention_kernels({
            "attention": checked("attention", FA.flash_attention_plain),
            "flash_decode": checked("flash_decode", FD.flash_decode_plain)}):
        logits, cache = api.prefill(params, prompts, cache, **inputs)
        api.decode_step(params, torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1), cache)
    out = {}
    for name, rows in stats.items():
        out[name] = {"calls": len(rows), "max_abs_err": max(r[0] for r in rows),
                     "max_rel_rms": max(r[1] for r in rows),
                     "within_2e-2": all(r[2] for r in rows)}
    out["within"] = all(r[2] and r[1] <= ATTN_REL_RMS for rows in stats.values() for r in rows)
    return out


def phase_attention_family(device, phase: str, arch: str, prompt_passes: int,
                           per_step: int) -> dict:
    """One of the head-dim-64 families (zamba2's hybrid, internvl2's VLM,
    seamless's encoder-decoder) served at full size through K2 and K3, with
    its stub frontend input drawn from seed 0.

    Launch counts are exact: ``prompt_passes`` K2 calls and ``per_step`` K3
    calls a decode step, nothing else.  Two correct bf16 paths through these
    depths end apart by more than a flat 2e-2 allows, so the kernel run and
    the plain run (fed the kernel run's ids) are held against the same loop
    in float32: the kernel path at most 1.25 x as far from it as the plain
    path (:func:`within`), on the greedy ids and on teacher-forced random
    ids.  Every K2 and K3 call of a prefill and a decode step is held
    against its plain version on the same inputs
    (:func:`attention_per_call`).  A control whose K2 and K3 outputs keep 5
    mantissa bits must fail the two together; one with 6 bits is reported."""
    from repro_torch import kernels
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model
    cfg = common.launch_config(arch, kernels_path="cuda")
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = serve.load_params(api, device, seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)
    inputs = api.frontend_inputs(BATCH, torch.Generator(device=device).manual_seed(0), device)

    def run(run_api, ids=None, replacement=None):
        with attention_kernels(replacement or {}):
            return serve.generate(run_api, params, prompts, NEW_TOKENS, inputs=inputs,
                                  keep_step_logits=True, forced_ids=ids)

    serve.generate(api, params, prompts, 2, inputs=inputs)   # warm-up: planner, allocator
    kernels.reset_launch_counts()
    res = run(api)
    launches = kernels.launch_counts()
    want = {"gemm": 0, "flash_attention": prompt_passes, "flash_decode": per_step * NEW_TOKENS,
            "flash_decode_partials": 0, "flash_decode_combine": 0, "grouped_matmul": 0,
            "wkv6": 0, "flash_attention_bwd": 0, "wkv6_bwd": 0}
    if launches != want:
        raise AssertionError(f"{phase}: kernel launches {launches}, expected {want}")
    check_outputs(phase, res, cfg)
    fallbacks = check_planner(phase, res)

    plain_api = build_model(replace(cfg, kernels="plain"))
    f32_api = build_model(replace(cfg, kernels="plain", compute_dtype="float32"))

    def against(kern_res, greedy) -> dict:
        controls = {bits: (lambda ids, bits=bits: run(api, ids, coarse_attention(bits)))
                    for bits in ((6, 5) if greedy else ())}
        return float32_rule(kern_res, lambda ids: run(plain_api, ids),
                            lambda ids: run(f32_api, ids), greedy, controls)

    greedy = against(res, True)
    controls = greedy.pop("_controls")
    rand_ids = torch.randint(1, cfg.vocab_size, (BATCH, NEW_TOKENS), device=device,
                             generator=torch.Generator(device=device).manual_seed(1))
    forced = against(run(api, rand_ids), False)
    del forced["_controls"]
    per_call = attention_per_call(api, params, prompts, inputs)
    for bits, ctl in controls.items():
        ctl["per_call"] = attention_per_call(api, params, prompts, inputs,
                                             coarse_attention(bits))
        ctl["rejected"] = ctl["float32_rule_rejects"] or not ctl["per_call"]["within"]
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "head_dim": cfg.head_dim_, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "n_params": api.n_params(), "batch": BATCH, "prompt_len": PROMPT,
          "frontend_input": {k: list(v.shape) for k, v in inputs.items()},
          "new_tokens": NEW_TOKENS, "compute_dtype": cfg.compute_dtype, "load_s": load_s,
          "prefill_ms": res.prefill_s * 1e3,
          "decode_ms_per_token": res.decode_s * 1e3 / NEW_TOKENS,
          "tok_per_s": BATCH * NEW_TOKENS / res.decode_s, "peak_bytes": res.peak_bytes,
          "launches": launches, "planner_fallbacks": fallbacks,
          "check": "kernel path's distance from float32 at most 1.25 x the plain path's "
                   "(max + 2e-2, rms), same ids; every K2/K3 call of a prefill and a decode "
                   f"step within 2e-2 and {ATTN_REL_RMS} relative rms of its plain version "
                   "on the same inputs",
          "greedy_ids": greedy, "forced_random_ids": forced, "per_call": per_call,
          "controls": {f"{b}_mantissa_bits": c for b, c in controls.items()},
          "distinct_greedy_ids": int(res.generated.unique().numel()),
          "first_ids": res.generated[0, :16].tolist(),
          "blocks": {f"{t}{list(s)}": [list(b), src]
                     for (t, s), (b, src) in res.blocks.items()}})
    for name, check in (("greedy", greedy), ("forced random", forced)):
        if not check["within"]:
            raise AssertionError(f"{phase} ({name} ids): the kernel path is further from "
                                 f"float32 than the plain path allows: {check}")
    if not per_call["within"] or per_call["attention"]["calls"] != prompt_passes \
            or per_call["flash_decode"]["calls"] != per_step:
        raise AssertionError(f"{phase}: a K2/K3 call disagrees with its plain version, or "
                             f"the calls were not counted: {per_call}")
    if not controls[5]["rejected"]:
        raise AssertionError(f"{phase}: the checks did not reject the 5-bit control")
    return launches


def phase_moe(device):
    """qwen3-moe-30b-a3b served at full size through the kernels.

    Two correct bf16 paths through 48 layers of a random MoE end apart by
    far more than bf16's ulp, so the kernel run is not held to the plain run
    directly: both, fed the kernel run's ids and routing, are held against
    the same loop computed in float32, and the kernel path may be at most
    1.25 x as far from it as the plain path (:func:`within`).  A control
    whose expert products keep 5 mantissa bits must fail that check.  The
    check is made again with the ids teacher-forced from a seeded random
    stream, so that it does not rest on the ids one greedy run chose."""
    from repro_torch import kernels
    from repro_torch.kernels import moe_gmm
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model, moe
    free_before, total = torch.cuda.mem_get_info(device)
    cfg = common.launch_config(MOE_ARCH, kernels_path="cuda")
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = serve.load_params(api, device, seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)
    serve.generate(api, params, prompts, 2)            # warm-up: planner, allocator

    kernels.reset_launch_counts()
    res, routed = recorded_run(api, params, prompts)
    launches = kernels.launch_counts()
    by_body = kernels.launches_by_body()
    L = cfg.n_layers
    want = {"gemm": 0, "flash_attention": L, "flash_decode": L * NEW_TOKENS,
            "flash_decode_partials": 0, "flash_decode_combine": 0,
            "grouped_matmul": 3 * L * (1 + NEW_TOKENS), "wkv6": 0, "flash_attention_bwd": 0,
            "wkv6_bwd": 0}
    if launches != want:
        raise AssertionError(f"moe: kernel launches {launches}, expected {want}")
    if by_body["grouped_matmul"] != {"tma": want["grouped_matmul"], "staged": 0}:
        raise AssertionError(f"moe: the expert products did not all run on the TMA body: "
                             f"{by_body}")
    check_outputs("moe", res, cfg)
    fallbacks = check_planner("moe", res)

    plain_api = build_model(replace(cfg, kernels="plain"))
    f32_api = build_model(replace(cfg, kernels="plain", compute_dtype="float32"))

    def against(kern_res, routing, greedy) -> dict:
        def replay(run_api, ids):
            return replayed_run(run_api, params, prompts, ids, routing)

        def coarser(bits):
            def run(ids):
                with patched(moe_gmm, "grouped_matmul_plain", coarse_products(bits)):
                    return replay(plain_api, ids)
            return run

        return float32_rule(kern_res, lambda ids: replay(plain_api, ids),
                            lambda ids: replay(f32_api, ids), greedy,
                            {bits: coarser(bits) for bits in ((6, 5) if greedy else ())})

    greedy = against(res, routed, True)
    controls = {f"{bits}_mantissa_bits": dict(c, rejected=c.pop("float32_rule_rejects"))
                for bits, c in greedy.pop("_controls").items()}
    rand_ids = torch.randint(1, cfg.vocab_size, (BATCH, NEW_TOKENS), device=device,
                             generator=torch.Generator(device=device).manual_seed(1))
    forced_res, forced_routed = recorded_run(api, params, prompts, rand_ids)
    forced = against(forced_res, forced_routed, False)
    del forced["_controls"], forced_res, forced_routed

    # for information: the plain prefill routing by itself
    _, own = recorded_run(plain_api, params, prompts)
    prefill_routed, decode_routed = routed[:L], routed[L:]
    # a plain (token, slot) choice agrees when the kernel run sent the same
    # token to the same expert in any slot
    agree = [float((plain[1][:, :, None] == kern[1][:, None, :]).any(-1).float().mean())
             for plain, kern in zip(own, prefill_routed)]

    def per_expert(idx):
        return torch.zeros(cfg.n_experts, dtype=torch.long, device=device).scatter_add_(
            0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))

    cap = moe._capacity(BATCH * PROMPT, cfg)
    drops = sum(int((per_expert(i) - cap).clamp(min=0).sum()) for _, i in prefill_routed)
    occupied = [int((per_expert(i) > 0).sum()) for _, i in decode_routed]
    emit({"phase": "moe", "arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
          "n_experts": cfg.n_experts, "experts_per_token": cfg.experts_per_token,
          "n_params": api.n_params(), "batch": BATCH, "prompt_len": PROMPT,
          "new_tokens": NEW_TOKENS, "compute_dtype": cfg.compute_dtype,
          "free_bytes_before_load": free_before, "total_bytes": total,
          "load_s": load_s, "prefill_ms": res.prefill_s * 1e3,
          "decode_ms_per_token": res.decode_s * 1e3 / NEW_TOKENS,
          "tok_per_s": BATCH * NEW_TOKENS / res.decode_s,
          "peak_bytes": res.peak_bytes, "launches": launches,
          "grouped_matmul_launches_by_body": by_body["grouped_matmul"],
          "planner_fallbacks": fallbacks,
          "check": "kernel path's distance from float32 at most 1.25 x the plain path's "
                   "(max + 2e-2, rms), same ids and routing",
          "greedy_ids": greedy, "forced_random_ids": forced, "controls": controls,
          "distinct_greedy_ids": int(res.generated.unique().numel()),
          "prefill_capacity": cap, "decode_capacity": moe._capacity(BATCH, cfg),
          "prefill_dropped_pairs": drops,
          "prefill_dropped_share": drops / (L * BATCH * PROMPT * cfg.experts_per_token),
          "free_routing_prefill_agreement": sum(agree) / len(agree),
          "free_routing_agreement_first_last_layer": [agree[0], agree[-1]],
          "decode_experts_holding_a_token_mean": sum(occupied) / len(occupied),
          "decode_experts_holding_a_token_max": max(occupied),
          "first_ids": res.generated[0, :16].tolist(),
          "blocks": {f"{t}{list(s)}": [list(b), src]
                     for (t, s), (b, src) in res.blocks.items()}})
    for name, check in (("greedy", greedy), ("forced random", forced)):
        if not check["within"]:
            raise AssertionError(f"moe ({name} ids): the kernel path is further from "
                                 f"float32 than the plain path allows: {check}")
    if not controls["5_mantissa_bits"]["rejected"]:
        raise AssertionError("moe: the float32 check did not reject the 5-bit control")
    return launches, by_body["grouped_matmul"]


# ------------------------------------------------------------------ training
@contextlib.contextmanager
def backward_launches():
    """Counts the K1 and K4 launches made inside ``ops.matmul``'s and
    ``ops.grouped_matmul``'s backward (K1-bwd, K4-bwd): the wrappers count
    their kernel's launches whatever calls them, so the script reads the
    counters around each backward."""
    from repro_torch.kernels import gemm as G, moe_gmm, ops
    counts = {"gemm_bwd": 0, "grouped_matmul_bwd": 0}

    def counting(fn, module, name):
        def backward(ctx, grad):
            before = module.launches
            out = fn(ctx, grad)
            counts[name] += module.launches - before
            return out
        return staticmethod(backward)

    saved = {cls: cls.__dict__["backward"] for cls in (ops._Matmul, ops._GroupedMatmul)}
    ops._Matmul.backward = counting(ops._Matmul.backward, G, "gemm_bwd")
    ops._GroupedMatmul.backward = counting(ops._GroupedMatmul.backward, moe_gmm,
                                           "grouped_matmul_bwd")
    try:
        yield counts
    finally:
        for cls, fn in saved.items():
            cls.backward = fn


def leaf_distances(grads, exact) -> dict:
    """Each gradient leaf's RMS distance from the float32 run's, relative to
    that leaf's RMS there, the worst of them, and the distance of all
    gradients together relative to the float32 run's overall RMS."""
    from repro_torch.models.param import tree_leaves
    is_t = lambda x: isinstance(x, torch.Tensor)
    per, num, den = [], 0.0, 0.0
    for g, e in zip(tree_leaves(grads, is_leaf=is_t), tree_leaves(exact, is_leaf=is_t)):
        d2 = (g.float() - e.float()).square().sum().item()
        e2 = e.float().square().sum().item()
        num, den = num + d2, den + e2
        if e2 > 0:
            per.append((d2 / e2) ** 0.5)
    return {"worst_leaf": max(per), "overall": (num / den) ** 0.5, "per_leaf": per}


def gradient_rule(kern: dict, plain: dict) -> dict:
    """The float32 rule on gradients: the kernel path at most 1.25 x as far
    from the float32 gradients as the plain path, in the worst leaf and
    overall."""
    return {"kernel_worst_leaf": kern["worst_leaf"], "plain_worst_leaf": plain["worst_leaf"],
            "kernel_overall": kern["overall"], "plain_overall": plain["overall"],
            "worst_leaf_ratio": kern["worst_leaf"] / plain["worst_leaf"],
            "overall_ratio": kern["overall"] / plain["overall"],
            "largest_per_leaf_ratio": max(k / max(p, 1e-30) for k, p in
                                          zip(kern["per_leaf"], plain["per_leaf"])),
            "within": kern["worst_leaf"] <= 1.25 * plain["worst_leaf"]
            and kern["overall"] <= 1.25 * plain["overall"]}


def bwd_per_call(stats: list, kernel, plain, bits: int = 5, of_largest: bool = False):
    """A backward kernel's wrapper that records, for every call, how far
    each output is from the plain version on the same inputs (within 2e-2,
    of its largest entry when ``of_largest``; the relative RMS, which
    :func:`summarize_per_call` bounds) and how far a control, the kernel's
    outputs rounded to ``bits`` mantissa bits, is from the same plain
    outputs.  The relative RMS of each output is kept too, in the order the
    kernel returns them."""

    def call(*args, **kw):
        outs = kernel(*args, **kw)
        wants = plain(*args, **kw)
        row = {"max_abs_err": 0.0, "max_rel_rms": 0.0, "within_2e-2": True,
               "control_max_rel_rms": 0.0, "rel_rms": []}
        for out, want in zip(outs, wants):
            w = want.float()
            diff = out.float() - w
            norm = w.norm().clamp(min=1e-30)
            atol = 2e-2 * (w.abs().max().item() if of_largest else 1.0)
            row["max_abs_err"] = max(row["max_abs_err"], diff.abs().max().item())
            row["rel_rms"].append((diff.norm() / norm).item())
            row["max_rel_rms"] = max(row["max_rel_rms"], row["rel_rms"][-1])
            row["within_2e-2"] &= bool(torch.allclose(out.float(), w, rtol=2e-2, atol=atol))
            row["control_max_rel_rms"] = max(
                row["control_max_rel_rms"],
                ((coarse(out, bits).float() - w).norm() / norm).item())
        stats.append(row)
        return outs

    return call


def summarize_per_call(stats: list, rel_rms: float = ATTN_REL_RMS) -> dict:
    return {"calls": len(stats), "max_abs_err": max(r["max_abs_err"] for r in stats),
            "max_rel_rms": max(r["max_rel_rms"] for r in stats),
            "max_rel_rms_by_output": [max(r["rel_rms"][i] for r in stats)
                                      for i in range(len(stats[0]["rel_rms"]))],
            "rel_rms_bound": rel_rms,
            "within": all(r["within_2e-2"] and r["max_rel_rms"] <= rel_rms for r in stats),
            "control_5_bits_max_rel_rms": max(r["control_max_rel_rms"] for r in stats),
            "control_5_bits_rejected": any(r["control_max_rel_rms"] > rel_rms
                                           for r in stats)}


def phase_train(device):
    """qwen2.5-3b trained at full width and depth: float32 master weights
    from seed 0, bf16 compute, remat, AdamW with float32 state, SyntheticLM
    batches of 4 x 512.

    (a) The first step's gradient three ways: through the kernels, through
    the plain path (dense PyTorch attention under autograd) and in float32;
    the float32 rule on gradients (:func:`gradient_rule`).  (b) Every K2-bwd
    call of the kernel run against its plain version on the same inputs,
    (c) with a 5-bit control that the per-call check must reject.  Both
    before the optimizer state exists.  (d) Three AdamW steps through
    ``launch/train.py``'s loop with exact launch counts (K2 forward twice a
    layer a step with remat, K2-bwd once: the counter counts calls, each two
    kernel launches), finite losses and gradient norms, and one traced step
    for the device's busy time."""
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.launch import common, serve, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt, train_step as TS
    cfg = common.launch_config(ARCH)
    api = build_model(cfg)
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batch = TL.to_device(source.batch_at(0, BATCH, PROMPT), device)

    f32_api = build_model(replace(cfg, kernels="plain", compute_dtype="float32"))
    plain_api = build_model(replace(cfg, kernels="plain"))
    f32_loss, _, exact = TS.value_and_grad(f32_api, params, batch)
    stats = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with patched(FAB, "flash_attention_bwd", bwd_per_call(stats, FAB.flash_attention_bwd,
                                                           FAB.flash_attention_bwd_plain)):
        kern_loss, _, grads = TS.value_and_grad(api, params, batch)
    torch.cuda.synchronize()
    checked_step_s = time.perf_counter() - t0
    grad_launches = kernels.launch_counts()
    kern = leaf_distances(grads, exact)
    del grads
    plain_loss, _, grads = TS.value_and_grad(plain_api, params, batch)
    plain = leaf_distances(grads, exact)
    del grads, exact
    rule = gradient_rule(kern, plain)
    per_call = summarize_per_call(stats)
    gc.collect()
    torch.cuda.empty_cache()

    steps = 3
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=steps, warmup_steps=max(1, steps // 20))
    state = TS.TrainState(params, opt.opt_init(params, tcfg))
    lines = []
    kernels.reset_launch_counts()
    res = TL.run(api, tcfg, steps, BATCH, PROMPT, device, state=state, log_every=1,
                 log=lines.append)
    launches = res.launches
    want = {"gemm": 0, "flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps,
            "flash_decode": 0, "flash_decode_partials": 0, "flash_decode_combine": 0,
            "grouped_matmul": 0, "wkv6": 0, "wkv6_bwd": 0}
    data = TL.to_device(source.batch_at(steps, BATCH, PROMPT), device)
    step_fn = TS.make_train_step(api, tcfg)
    holder = {"state": res.state}

    def one_step():
        holder["state"] = step_fn(holder["state"], data)[0]

    traced = serve._traced(one_step, device, 1)
    # where the host time of a step goes (CPU activity only, self time), and
    # the step split into gradient and optimizer, each synchronised
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        one_step()
        torch.cuda.synchronize()
    host_ops = [{"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                 "calls": e.count}
                for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = TS.value_and_grad(api, holder["state"].params, data)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.opt_update(grads, holder["state"].opt_state, holder["state"].params, tcfg)
    torch.cuda.synchronize()
    split = {"gradient_ms": (t1 - t0) * 1e3, "optimizer_ms": (time.perf_counter() - t1) * 1e3}
    del grads
    finite = all(math.isfinite(h[k]) for h in res.history for k in ("loss", "grad_norm"))
    emit({"phase": "train", "arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
          "n_params": api.n_params(), "batch": BATCH, "seq": PROMPT,
          "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
          "remat": cfg.remat, "optimizer": tcfg.optimizer, "load_s": load_s,
          "first_step_loss": {"kernel": float(kern_loss), "plain": float(plain_loss),
                              "float32": float(f32_loss)},
          "gradient_check": "kernel path's gradient distance from float32 (RMS relative to "
                            "each leaf's RMS) at most 1.25 x the plain path's, in the worst "
                            "leaf and over all leaves",
          "gradients": rule, "grad_launches": grad_launches,
          "checked_grad_step_s": checked_step_s,
          "per_call_check": f"every K2-bwd call of the step within 2e-2 and {ATTN_REL_RMS} "
                            "relative rms of its plain version on the same inputs (dq, dk, "
                            "dv); control: the outputs with 5 mantissa bits",
          "per_call": per_call, "steps": steps, "step_lines": lines,
          "history": res.history, "step_ms": [t * 1e3 for t in res.step_s],
          "tok_per_s": [BATCH * PROMPT / t for t in res.step_s],
          "peak_bytes": res.peak_bytes, "launches": launches,
          "launch_unit": "flash_attention counts forward launches; flash_attention_bwd "
                         "counts wrapper calls, each two kernel launches (dQ, then dK/dV)",
          "traced_step": traced, "host_top_ops": host_ops, "step_split": split})
    if launches != want:
        raise AssertionError(f"train: kernel launches {launches}, expected {want}")
    if not finite:
        raise AssertionError(f"train: a loss or gradient norm is not finite: {res.history}")
    if not rule["within"]:
        raise AssertionError(f"train: the kernel path's gradients are further from float32 "
                             f"than the plain path allows: {rule}")
    if not per_call["within"] or per_call["calls"] != L:
        raise AssertionError(f"train: a K2-bwd call disagrees with its plain version, or "
                             f"the calls were not counted: {per_call}")
    if not per_call["control_5_bits_rejected"]:
        raise AssertionError("train: the per-call check did not reject the 5-bit control")
    del holder, res, state, params
    return launches


def replaying_router(recorded):
    """``moe._router`` with the experts another run chose (in call order);
    the gate weights and the load-balancing loss come from this run's own
    router probabilities, so the router keeps its gradient."""
    replay = iter(recorded)

    def router(xf, router_w, cfg):
        idx = next(replay)
        logits = torch.einsum("td,de->te", xf, router_w.to(xf.dtype))
        probs = torch.softmax(logits.float(), dim=-1)
        gate = probs.gather(1, idx)
        gate = gate / torch.sum(gate, dim=-1, keepdim=True)
        chosen = torch.zeros_like(probs).scatter_add_(1, idx, torch.ones_like(gate))
        aux = cfg.n_experts * torch.sum(probs.mean(0) * chosen.mean(0)) * cfg.router_aux_weight
        return gate, idx, aux

    return router


MOE_TRAIN_LAYERS = 2


def phase_moe_train(device):
    """qwen3-moe-30b-a3b at full width and MOE_TRAIN_LAYERS of its 48
    layers (full depth needs about 489 GB of float32 weights, gradients and
    AdamW state): one gradient step through the kernels, every expert
    product forward (and its remat recompute) and backward through K4, K4's
    backward launches counted inside ``ops.grouped_matmul``'s backward and
    split by GEMM body.  The kernel run's expert choices are replayed in the
    plain and float32 runs; the float32 rule on gradients; one traced
    gradient step for the device's busy time."""
    from repro_torch import kernels
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import common, serve, train as TL
    from repro_torch.models import build_model, moe
    from repro_torch.train import train_step as TS
    cfg = replace(common.launch_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    api = build_model(cfg)
    L = cfg.n_layers
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batch = TL.to_device(source.batch_at(0, BATCH, PROMPT), device)
    TS.value_and_grad(api, params, batch)                  # warm-up: planner, allocator
    recorded, router = [], moe._router

    def recording(xf, router_w, c):
        out = router(xf, router_w, c)
        recorded.append(out[1].detach())
        return out

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(moe, "_router", recording), backward_launches() as bwd:
        loss, metrics, grads = TS.value_and_grad(api, params, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    by_body = kernels.launches_by_body()["grouped_matmul"]
    bwd = dict(bwd)
    want = {"gemm": 0, "flash_attention": 2 * L, "flash_attention_bwd": L,
            "flash_decode": 0, "flash_decode_partials": 0, "flash_decode_combine": 0,
            "grouped_matmul": 12 * L, "wkv6": 0, "wkv6_bwd": 0}

    def replayed(run_api):
        with patched(moe, "_router", replaying_router(recorded)):
            out = TS.value_and_grad(run_api, params, batch)
        return out

    f32_loss, _, exact = replayed(build_model(replace(cfg, kernels="plain",
                                                      compute_dtype="float32")))
    kern = leaf_distances(grads, exact)
    del grads
    plain_loss, _, grads = replayed(build_model(replace(cfg, kernels="plain")))
    plain = leaf_distances(grads, exact)
    del grads, exact
    rule = gradient_rule(kern, plain)
    # one traced gradient step (the model's own routing) for the device's busy time
    traced = serve._traced(lambda: TS.value_and_grad(api, params, batch), device, 1)
    emit({"phase": "moe_train", "arch": cfg.name, "n_layers": L, "of_layers": 48,
          "d_model": cfg.d_model, "n_experts": cfg.n_experts, "n_params": api.n_params(),
          "batch": BATCH, "seq": PROMPT, "remat": cfg.remat,
          "capacity": moe._capacity(BATCH * PROMPT, cfg),
          "loss": {"kernel": float(loss), "plain": float(plain_loss), "float32": float(f32_loss)},
          "aux_loss": float(metrics["aux_loss"]), "grad_step_ms": step_s * 1e3,
          "launches": launches, "grouped_matmul_launches_by_body": by_body,
          "backward_launches": bwd,
          "gradient_check": "kernel path's gradient distance from float32 (RMS relative to "
                            "each leaf's RMS) at most 1.25 x the plain path's, in the worst "
                            "leaf and over all leaves; the kernel run's expert choices "
                            "replayed in both",
          "gradients": rule, "traced_step": traced})
    if launches != want or bwd["grouped_matmul_bwd"] != 6 * L:
        raise AssertionError(f"moe_train: kernel launches {launches} (backward {bwd}), "
                             f"expected {want} and {6 * L} in the backward")
    if not math.isfinite(float(loss)) or not rule["within"]:
        raise AssertionError(f"moe_train: the loss is not finite, or the kernel path's "
                             f"gradients are further from float32 than the plain path "
                             f"allows: {rule}")
    del params
    return dict(launches, grouped_matmul_bwd=bwd["grouped_matmul_bwd"])


# relative RMS difference a K5-bwd output may show from its plain version on
# the same inputs: both compute in float32 and round to bf16 once (1.6e-4 at
# rwkv6-3b's first step on an H100); an output with 5 mantissa bits is 9.6e-3
# off
WKV_BWD_REL_RMS = 2.0 ** -10


def rwkv_gradients(cfg, params, batch, stats=None) -> dict:
    """rwkv6 config ``cfg``'s first-step gradient three ways: through K5 and
    K5-bwd (every K5-bwd call checked into ``stats`` when given), through
    the plain path (the same model with K5 and K5-bwd patched to their
    plain versions, the kernel path's bf16 casts of the decays and the bonus
    kept; ``kernels="plain"`` would drop them) and in float32; the float32
    rule on gradients (:func:`gradient_rule`), the losses, each run's
    gradient norm and the kernel run's launches."""
    from repro_torch import kernels
    from repro_torch.kernels import rwkv6 as K, rwkv6_bwd as KB
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves
    from repro_torch.train import train_step as TS
    is_t = lambda x: isinstance(x, torch.Tensor)
    norm = lambda g: math.sqrt(sum(x.float().square().sum().item()
                                   for x in tree_leaves(g, is_leaf=is_t)))
    api = build_model(cfg)
    f32_loss, _, exact = TS.value_and_grad(
        build_model(replace(cfg, kernels="plain", compute_dtype="float32")), params, batch)
    checked = KB.wkv6_bwd if stats is None else bwd_per_call(
        stats, KB.wkv6_bwd, KB.wkv6_bwd_plain, of_largest=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with patched(KB, "wkv6_bwd", checked):
        kern_loss, _, grads = TS.value_and_grad(api, params, batch)
    torch.cuda.synchronize()
    out = {"checked_grad_step_s": time.perf_counter() - t0,
           "launches": kernels.launch_counts()}
    kern, norms = leaf_distances(grads, exact), {"kernel": norm(grads), "float32": norm(exact)}
    del grads
    with patched(K, "wkv6", K.wkv6_plain), patched(KB, "wkv6_bwd", KB.wkv6_bwd_plain):
        plain_loss, _, grads = TS.value_and_grad(api, params, batch)
    plain = leaf_distances(grads, exact)
    norms["plain"] = norm(grads)
    del grads, exact
    out.update(loss={"kernel": float(kern_loss), "plain": float(plain_loss),
                     "float32": float(f32_loss)},
               gradients=gradient_rule(kern, plain), grad_norm=norms)
    return out


def phase_rwkv_train(device):
    """rwkv6-3b trained at full width and depth: float32 master weights from
    seed 0, bf16 compute, remat, AdamW with float32 state, SyntheticLM
    batches of 4 x 512; every prompt-length WKV scan through K5 and its
    gradient through K5-bwd.

    (a) The first step's gradient three ways (:func:`rwkv_gradients`) and
    the float32 rule on gradients.  At full depth that rule is met but
    says little: the model's first-step gradient is chaotic there (the
    float32 and bf16 gradient norms differ by two orders of magnitude, their
    cosine is near 0; PERF.md), so both bf16 paths lie about 1.0 from
    float32.  So the rule is also held at 1 layer of full width, where bf16
    is within a few tens of percent of float32.  (b) Every K5-bwd call of
    the full-depth kernel run against its plain version on the same inputs
    (each of dr, dk, dv, dlog_w and du within 2e-2 of its largest entry and
    at most WKV_BWD_REL_RMS relative RMS), (c) with a 5-bit control that
    this check must reject.  (d) Three AdamW steps through
    ``launch/train.py``'s loop with exact launch counts (K5 twice a layer a
    step with remat, K5-bwd once, nothing else), finite losses and gradient
    norms, and one traced step for the device's busy time."""
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import common, serve, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt, train_step as TS
    cfg = common.launch_config(RWKV_ARCH)
    L = cfg.n_layers
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batch = TL.to_device(source.batch_at(0, BATCH, PROMPT), device)
    shallow_cfg = replace(cfg, n_layers=1)
    shallow_params = build_model(shallow_cfg).init(
        torch.Generator(device=device).manual_seed(0), device)
    shallow = rwkv_gradients(shallow_cfg, shallow_params, batch)
    del shallow_params
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stats = []
    full = rwkv_gradients(cfg, params, batch, stats)
    per_call = summarize_per_call(stats, WKV_BWD_REL_RMS)
    gc.collect()
    torch.cuda.empty_cache()

    steps = 3
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=steps, warmup_steps=max(1, steps // 20))
    state = TS.TrainState(params, opt.opt_init(params, tcfg))
    lines = []
    kernels.reset_launch_counts()
    res = TL.run(api, tcfg, steps, BATCH, PROMPT, device, state=state, log_every=1,
                 log=lines.append)
    launches = res.launches
    zero = {name: 0 for name in launches}
    want = dict(zero, wkv6=2 * L * steps, wkv6_bwd=L * steps)
    want_grad = {n: dict(zero, wkv6=2 * n, wkv6_bwd=n) for n in (L, 1)}
    data = TL.to_device(source.batch_at(steps, BATCH, PROMPT), device)
    step_fn = TS.make_train_step(api, tcfg)
    holder = {"state": res.state}

    def one_step():
        holder["state"] = step_fn(holder["state"], data)[0]

    traced = serve._traced(one_step, device, 1)
    finite = all(math.isfinite(h[k]) for h in res.history for k in ("loss", "grad_norm"))
    emit({"phase": "rwkv_train", "arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
          "n_params": api.n_params(), "batch": BATCH, "seq": PROMPT,
          "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
          "remat": cfg.remat, "optimizer": tcfg.optimizer, "load_s": load_s,
          "gradient_check": "kernel path's gradient distance from float32 (RMS relative to "
                            "each leaf's RMS) at most 1.25 x the plain path's (K5 and K5-bwd "
                            "patched to their plain versions, the bf16 casts kept), in the "
                            "worst leaf and over all leaves; at full depth and at 1 layer",
          "first_step": full, "first_step_1_layer": shallow,
          "per_call_check": f"every K5-bwd call of the step within 2e-2 of each output's "
                            f"largest entry and {WKV_BWD_REL_RMS} relative rms of its plain "
                            "version on the same inputs (dr, dk, dv, dlog_w, du); control: "
                            "the outputs with 5 mantissa bits",
          "per_call": per_call, "steps": steps, "step_lines": lines,
          "history": res.history, "step_ms": [t * 1e3 for t in res.step_s],
          "tok_per_s": [BATCH * PROMPT / t for t in res.step_s],
          "peak_bytes": res.peak_bytes, "launches": launches, "traced_step": traced})
    if launches != want or full["launches"] != want_grad[L] \
            or shallow["launches"] != want_grad[1]:
        raise AssertionError(f"rwkv_train: kernel launches {launches} (first gradient "
                             f"{full['launches']}, at 1 layer {shallow['launches']}), "
                             f"expected {want} ({want_grad})")
    if not finite:
        raise AssertionError(f"rwkv_train: a loss or gradient norm is not finite: "
                             f"{res.history}")
    for name, check in (("full depth", full), ("1 layer", shallow)):
        if not check["gradients"]["within"]:
            raise AssertionError(f"rwkv_train ({name}): the kernel path's gradients are "
                                 f"further from float32 than the plain path allows: {check}")
    if not per_call["within"] or per_call["calls"] != L:
        raise AssertionError(f"rwkv_train: a K5-bwd call disagrees with its plain version, "
                             f"or the calls were not counted: {per_call}")
    if not per_call["control_5_bits_rejected"]:
        raise AssertionError("rwkv_train: the per-call check did not reject the 5-bit "
                             "control")
    del holder, res, state, params
    return launches


SOURCES = {
    "gemm": ("src/repro_torch/kernels/csrc/gemm_sm90.cuh", "src/repro/kernels/gemm.py:26"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cuh",
                        "src/repro/kernels/flash_attention.py:28"),
    # both stages in one launch, as ``ops.flash_decode`` runs them: the
    # function that one library call (scaled_dot_product_attention) computes
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:62"),
    "flash_decode_partials": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                              "src/repro/kernels/flash_decode.py:31"),
    "flash_decode_combine": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_decode.py:103"),
    "grouped_matmul": ("src/repro_torch/kernels/csrc/gemm_sm90.cuh",
                       "src/repro/kernels/moe_gmm.py:23"),
    "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu", "src/repro/kernels/rwkv6.py:39"),
    # the backward of K2 (the reference has none: jax.grad through its
    # Pallas call fails), and K1's and K4's backward through their own kernels
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:28"),
    "gemm_bwd": ("src/repro_torch/kernels/csrc/gemm_sm90.cuh", "src/repro/kernels/gemm.py:26"),
    "grouped_matmul_bwd": ("src/repro_torch/kernels/csrc/gemm_sm90.cuh",
                           "src/repro/kernels/moe_gmm.py:23"),
    # the backward of K5 (the reference has none: jax.grad through its
    # Pallas call fails)
    "wkv6_bwd": ("src/repro_torch/kernels/csrc/wkv6_bwd.cu", "src/repro/kernels/rwkv6.py:39"),
}
# the reference's two decode functions, kept and checked, but no longer on the
# served path: ``ops.flash_decode`` computes both in one launch
OFF_MAIN_PATH = ("flash_decode_partials", "flash_decode_combine")
# the bodies redesigned last: their registers and spills go in the build line
REDESIGNED = ("decode_mma_kernel", "decode_f32_kernel", "wkv6_kernel", "flash_bwd_dq_mma_kernel",
              "flash_bwd_dkv_mma_kernel", "wkv6_bwd_kernel")
# the TMA GEMM core's instantiations end their mangled template arguments with
# GROUPED, A_T, B_T and MINB: MINB 1 the deep ring, 2 the short-K ring
RING = re.compile(r"ELi([12])EEEv")
LAYOUT = re.compile(r"Lb([01])ELb([01])ELb([01])ELi[12]EEEv")


def ring_of(name: str) -> str:
    found = RING.search(name)
    return {"1": "deep", "2": "short_k"}[found.group(1)] if found else "?"


def layout_of(name: str) -> str:
    """The product a TMA GEMM instantiation computes: K1 or K4, and which
    operand it reads as stored transposed."""
    found = LAYOUT.search(name)
    if not found:
        return "?"
    grouped, a_t, b_t = found.groups()
    return ("K4" if grouped == "1" else "K1") + {"00": "", "10": " a_t", "01": " b_t"}.get(
        a_t + b_t, " ?")


def build_failure(err: Exception) -> None:
    """The last 40 lines of what the compiler printed, on a JSON line, when
    the kernel library cannot be built or loaded."""
    emit({"phase": "build", "error": type(err).__name__,
          "compiler_tail": str(err).splitlines()[-40:]})



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # keep the plan registry and the kernel build inside the checkout
    os.environ.setdefault("REPRO_PLAN_CACHE_DIR",
                          os.path.join(ROOT, "build", f"plancache-{os.getpid()}"))
    from repro_torch.kernels import _build

    device = torch.device("cuda", 0)
    card = smi_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    try:
        _build.lib()
    except Exception as err:
        build_failure(err)
        raise
    info = _build.build_info()
    ptxas = ptxas_usage(str(info.get("compiler_output", "")))
    redesigned = {k: v for k, v in ptxas.items() if any(b in k for b in REDESIGNED)}
    redesigned.update({k: dict(v, ring=ring_of(k), layout=layout_of(k))
                       for k, v in ptxas.items() if "gemm_tma_kernel" in k
                       and (ring_of(k) == "short_k" or layout_of(k) in ("K1 a_t", "K1 b_t"))})
    # float32 products in full float32, as the reference's tolerances assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled_here": bool(info.get("built")), "library": info.get("path"),
          "sources": [p.name for p in _build.sources()], "ptxas": ptxas,
          "redesigned": redesigned})
    spilled = {k: v for k, v in ptxas.items()
               if "gemm_tma_kernel" in k and v.get("spill_bytes")}
    if info.get("built") and (spilled or not any("gemm_tma_kernel" in k for k in ptxas)
                              or not all(any(b in k for k in ptxas) for b in REDESIGNED)):
        raise AssertionError(f"the TMA GEMM instantiations spill, or a GEMM, decode, WKV or "
                             f"K2-bwd instantiation is missing: {spilled}")
    if info.get("built") and not any(ring_of(k) == "short_k" for k in ptxas
                                     if "gemm_tma_kernel" in k):
        raise AssertionError("no short-K instantiation of the TMA GEMM core was compiled")
    if info.get("built") and not {"K1 a_t", "K1 b_t"} <= {layout_of(k) for k in ptxas}:
        raise AssertionError("K1's transposed-operand instantiations were not compiled")

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    seconds, t_phase = {}, time.perf_counter()

    def lap(name):
        nonlocal t_phase
        seconds[name] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()

    cases = phase_kernels(timer, gen)
    lap("kernels")
    gemm_launches, gemm_by_body, gemm_bwd_launches = phase_planner(timer, gen)
    lap("planner")
    del timer
    torch.cuda.empty_cache()
    serve_launches, served = phase_serve(device)
    lap("serve")
    gc.collect()
    torch.cuda.empty_cache()
    serve_obs_launches = phase_serve_obs(served)
    lap("serve_obs")
    gc.collect()
    torch.cuda.empty_cache()                # the dense model's weights go first
    rwkv_launches = phase_rwkv(device)
    lap("rwkv")
    # the head-dim-64 families: prompt passes through K2 and decode-step
    # attentions through K3 (zamba2: 19 shared-attention sites; internvl2:
    # 24 layers; seamless: 12 encoder + 12 decoder self + 12 cross passes,
    # 12 self + 12 cross a step)
    by_path = {"serve": serve_launches, "serve_obs": serve_obs_launches,
               "rwkv": rwkv_launches}
    for phase, arch, passes, per_step in (("hybrid", HYBRID_ARCH, 19, 19),
                                          ("vlm", VLM_ARCH, 24, 24),
                                          ("encdec", ENCDEC_ARCH, 36, 24)):
        gc.collect()
        torch.cuda.empty_cache()                # the last model's weights go first
        by_path[phase] = phase_attention_family(device, phase, arch, passes, per_step)
        lap(phase)
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, moe_by_body = phase_moe(device)
    by_path["moe"] = moe_launches
    lap("moe")
    # training last: every served model's weights go first
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train"] = phase_train(device)
    lap("train")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["moe_train"] = phase_moe_train(device)
    lap("moe_train")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["rwkv_train"] = phase_rwkv_train(device)
    lap("rwkv_train")
    emit({"phase_seconds": seconds})
    by_path["planner"] = {"gemm_bwd": gemm_bwd_launches}

    launches = dict(serve_launches, gemm=gemm_launches,
                    grouped_matmul=moe_launches["grouped_matmul"],
                    wkv6=rwkv_launches["wkv6"],
                    flash_attention_bwd=by_path["train"]["flash_attention_bwd"],
                    gemm_bwd=gemm_bwd_launches,
                    grouped_matmul_bwd=by_path["moe_train"]["grouped_matmul_bwd"],
                    wkv6_bwd=by_path["rwkv_train"]["wkv6_bwd"])
    kernels_line = []
    for c in cases:
        if not (c["serving"] and c["dtype"] == "bfloat16" and c["name"] in SOURCES) \
                or any(k["name"] == c["name"] for k in kernels_line):
            continue
        source, replaces = SOURCES[c["name"]]
        on_path = c["name"] not in OFF_MAIN_PATH
        if on_path and launches[c["name"]] < 1:
            raise AssertionError(f"{c['name']} was never launched on the main path")
        kernels_line.append({
            "name": c["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[c["name"]], "max_abs_err": c["max_abs_err"],
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"], "dtype": c["dtype"], "main_path": on_path,
            "launches_by_path": {p: n[c["name"]] for p, n in by_path.items()
                                 if n.get(c["name"])}})
        if "staged_ms" in c:
            kernels_line[-1].update(
                block=c["block"], staged_ms=c["staged_ms"], host_us=c["host_us"],
                staged_host_us=c["staged_host_us"],
                launches_by_body=gemm_by_body if c["name"] == "gemm" else moe_by_body)
        served = [x for x in cases if x["serving"] and x["name"] == c["name"]
                  and x["dtype"] == "bfloat16"]
        if len(served) > 1:
            kernels_line[-1]["served_shapes"] = [
                {k: x[k] for k in ("model", "shape", "block", "body", "kernel_ms", "staged_ms",
                                   "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err", "host_us", "staged_host_us") if k in x}
                for x in served]
    if len(kernels_line) != len(SOURCES):
        raise AssertionError("a kernel of the main path is missing from the report")
    emit({"kernels": kernels_line})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
