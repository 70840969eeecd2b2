#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on an H100.

    python3 chip_smoke.py

Needs one NVIDIA GPU with ``nvcc`` on the machine; without a GPU it exits
non-zero and prints no result.  It imports ``repro_torch`` only and runs
these phases, each printing one JSON line; any failure raises:

1. device   the card's name and power limit, torch and CUDA versions;
2. build    compile ``src/repro_torch/kernels/csrc/*.cu`` and load the library;
3. kernels  every kernel against its plain PyTorch version on the card, at
            the serving shapes and at one ragged shape each, in bf16 and
            float32 (tolerances 2e-2 and 1e-4, those of the reference's
            kernel tests), each timed with CUDA events (median of 25 single
            launches, the L2 cache flushed before each) beside its plain
            version, one PyTorch library call and the roofline bound;
4. planner  ``ops.matmul`` with no block at the model's projection shape:
            planner -> GEMM kernel, search then registry hit, no fallback;
5. serve    ``qwen2.5-3b`` at full width and depth with random weights:
            batch 4, prompt 512, 32 greedy tokens through
            ``repro_torch.launch.serve``, compared step by step with the same
            loop run on the plain PyTorch attention;
6. moe      ``qwen3-moe-30b-a3b`` at full width and depth (30.5 B
            parameters, 61 GB in bf16), its experts through the grouped-GEMM
            kernel; the kernel run and the plain run, both fed the kernel
            run's ids and routing (a near-flat random router turns bf16
            differences into other experts), are held against the same loop
            in float32, with a control that must fail; the share of prefill
            expert choices that agree when the plain run routes by itself
            is reported.

Then one line ``{"kernels": [...]}`` with each kernel's launches on the main
path and its measured times, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
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
    res = {"name": "gemm", "shape": f"({M},{K})@({K},{N})", "dtype": dname(dtype),
           "serving": serving, "block": list(block) if block else None,
           "max_abs_err": err, "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(lambda: G.gemm_plain(a, b)),
           "library_ms": timer.ms(lambda: torch.matmul(a, b))}
    res.update(bound(2.0 * M * N * K, nbytes(a, b, out), dtype))
    return res


def _qkv(gen, dev, B, H, Hkv, Sq, Skv, d, dtype):
    """q as the layers hand it over, k/v as strided views of (B, T, Hkv, d)."""
    q = torch.randn(B * H, Sq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hkv, d, generator=gen, device=dev).to(dtype)
    return q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def flash_case(timer, gen, B, H, Hkv, Sq, Skv, d, causal, dtype, serving):
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
           "serving": serving, "max_abs_err": err, "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    res.update(bound(4.0 * B * H * visible * d, nbytes(q, k4, v4, out), dtype))
    return res


def decode_cases(timer, gen, B, H, Hkv, Skv, valid, d, dtype, serving, splits=None):
    """The two-stage decode as ``ops.flash_decode`` runs it, and each stage
    on its own."""
    from repro_torch.kernels import flash_decode as FD, ops
    dev = timer.flush.device
    g = H // Hkv
    q, k4, v4 = _qkv(gen, dev, B, H, Hkv, 1, Skv, d, dtype)
    n = Skv if valid is None else valid
    s = splits or FD.choose_splits(n, B * Hkv, FD.sm_count(dev))
    run = lambda: ops.flash_decode(q, k4, v4, kv_splits=splits, kv_valid_len=valid,
                                   q_per_kv=g)
    plain = lambda: FD.flash_decode_plain(q, k4, v4, kv_valid_len=valid, q_per_kv=g)
    out = run()
    label = f"BH={B * H} kv_heads={B * Hkv} buffer={Skv} valid={n} d={d} splits={s}"
    err = compare(f"flash_decode {label} {dname(dtype)}", out, plain(), dtype)
    q4 = q.reshape(B, H, 1, d)
    lib = lambda: F.scaled_dot_product_attention(q4, k4[:, :, :n], v4[:, :, :n],
                                                 enable_gqa=g > 1)
    compare("library decode", lib().reshape(B * H, 1, d), plain(), dtype, tol=2e-2)
    kv_bytes = 2 * B * Hkv * n * d * q.element_size()
    both = {"name": "flash_decode", "shape": label, "dtype": dname(dtype),
            "serving": serving, "max_abs_err": err, "kernel_ms": timer.ms(run),
            "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    both.update(bound(4.0 * B * H * n * d, kv_bytes + nbytes(q, out), dtype))

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
    from repro_torch.kernels import moe_gmm, ops
    dev = timer.flush.device
    x = torch.randn(E, cap, d_in, generator=gen, device=dev).to(dtype)
    w = (torch.randn(E, d_in, d_out, generator=gen, device=dev) * d_in ** -0.5).to(dtype)
    run = lambda: ops.grouped_matmul(x, w)
    out = run()
    err = compare(f"grouped_matmul E={E} cap={cap} {d_in}->{d_out} {dname(dtype)}", out,
                  moe_gmm.grouped_matmul_plain(x, w), dtype)
    res = {"name": "grouped_matmul", "shape": f"E={E} cap={cap} {d_in}->{d_out}",
           "dtype": dname(dtype), "serving": serving, "max_abs_err": err,
           "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(lambda: moe_gmm.grouped_matmul_plain(x, w)),
           "library_ms": timer.ms(lambda: torch.bmm(x, w))}
    res.update(bound(2.0 * E * cap * d_in * d_out, nbytes(x, w, out), dtype))
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
                                serving=True))
        cases.append(flash_case(timer, gen, 1, 2, 2, 128, 384, 64, False, dtype, False))
        cases += decode_cases(timer, gen, BATCH, H, Hkv, buffer_len, PROMPT + 1, d, dtype,
                              serving=True)
        cases += decode_cases(timer, gen, 1, 4, 4, 2048, None, 64, dtype, False, splits=8)
    # the grouped GEMM at the MoE's served shapes, decode gate/up first (the
    # shape with most launches, the one the kernels line reports), then at
    # deepseek-moe-16b's prefill shapes and one ragged float32 shape
    from repro_torch.models import moe
    mcfg = get_config(MOE_ARCH)
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
    emit({"phase": "kernels", "timing": "median of 25 single launches, L2 flushed "
          "before each, CUDA events", "cases": cases})
    return cases


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
    err = compare("planner -> gemm", out, G.gemm_plain(a, b), dtype)
    blocks, source = lower_torch.resolved_blocks()[request]
    fallbacks = first_fallbacks + lower_torch.planner_fallback_count()
    if launches != 1 or fallbacks != 0 or blocks != first_blocks:
        raise AssertionError(f"planner phase: launches={launches} fallbacks={fallbacks} "
                             f"blocks {first_blocks} -> {blocks}")
    if (first_source, source) != ("search", "cache"):
        raise AssertionError(f"expected a search then a registry hit, got "
                             f"{first_source} then {source}")
    # how good was the choice: every compiled tile at the same shape
    tiles = {str(t): timer.ms(lambda t=t: G.gemm(a, b, block=t), n=10)
             for t in lower_torch.gemm_tile_options(2)}
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k4, v4 = _qkv(gen, dev, BATCH, H, Hkv, PROMPT, PROMPT, d, dtype)
    flash_blocks = lower_torch.plan_flash_blocks(PROMPT, PROMPT, d, dtype)
    flash_tiles = {str(t): timer.ms(lambda t=t: FA.flash_attention(
        q, k4, v4, causal=True, block_q=t[0], block_kv=t[1], q_per_kv=H // Hkv), n=10)
        for t in lower_torch.flash_tile_options(d, 2)}
    emit({"phase": "planner", "gemm_shape": list(shape), "gemm_blocks": list(blocks),
          "first": first_source, "second": source, "planner_fallbacks": fallbacks,
          "gemm_launches": launches, "max_abs_err": err, "gemm_tile_ms": tiles,
          "flash_shape": [PROMPT, PROMPT, d], "flash_blocks": list(flash_blocks),
          "flash_tile_ms": flash_tiles})
    return launches


def phase_serve(device):
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = serve.serve_config(ARCH, kernels_path="cuda")
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
    want = {"gemm": 0, "flash_attention": L, "flash_decode_partials": L * NEW_TOKENS,
            "flash_decode_combine": L * NEW_TOKENS, "grouped_matmul": 0}
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
    return launches


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


def coarse_products(bits: int):
    """The plain expert products rounded (half away from zero) to ``bits``
    explicit mantissa bits instead of bf16's 7: a control that a correct
    check must reject."""
    from repro_torch.kernels import moe_gmm
    plain = moe_gmm.grouped_matmul_plain
    drop = 23 - bits

    def products(x, w, *, block=None, out_dtype=None):
        i = plain(x, w, out_dtype=torch.float32).view(torch.int32)
        out = ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)
        return out.to(out_dtype or x.dtype)

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


def against_float32(plain_api, f32_api, params, prompts, res, routed, greedy) -> dict:
    """The kernel run ``res`` and the plain bf16 path, both fed ``res``'s ids
    and routing, against the same loop computed in float32 (same bf16
    weights, ids and routing).  Where ``res`` chose its ids (``greedy``), each
    must be the float32 run's best or close enough to it that the bound on
    the logits allows it."""
    ids = res.generated
    ref = replayed_run(plain_api, params, prompts, ids, routed)
    exact = replayed_run(f32_api, params, prompts, ids, routed)
    kern, plain = from_float32(res, exact), from_float32(ref, exact)
    chosen_ok, same = True, 0
    for i, logits in enumerate([exact.prefill_logits, *exact.step_logits][:-1]
                               if greedy else []):
        best = logits.float().max(dim=1).values
        chosen = logits.float().gather(1, ids[:, i:i + 1]).squeeze(1)
        # both within the bound of the kernel's logits, so at most twice it apart
        chosen_ok &= bool(((best - chosen) <= 2 * (1.25 * plain[0] + 2e-2)).all())
        same += int((logits.argmax(dim=1) == ids[:, i]).sum())
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
            "_plain": plain, "_exact": exact}


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
    from repro_torch.launch import serve
    from repro_torch.models import build_model, moe
    free_before, total = torch.cuda.mem_get_info(device)
    cfg = serve.serve_config(MOE_ARCH, kernels_path="cuda")
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
    L = cfg.n_layers
    want = {"gemm": 0, "flash_attention": L, "flash_decode_partials": L * NEW_TOKENS,
            "flash_decode_combine": L * NEW_TOKENS,
            "grouped_matmul": 3 * L * (1 + NEW_TOKENS)}
    if launches != want:
        raise AssertionError(f"moe: kernel launches {launches}, expected {want}")
    check_outputs("moe", res, cfg)
    fallbacks = check_planner("moe", res)

    plain_api = build_model(replace(cfg, kernels="plain"))
    f32_api = build_model(replace(cfg, kernels="plain", compute_dtype="float32"))
    greedy = against_float32(plain_api, f32_api, params, prompts, res, routed, True)
    ref, exact = greedy.pop("_plain"), greedy.pop("_exact")
    controls = {}
    for bits in (6, 5):
        with patched(moe_gmm, "grouped_matmul_plain", coarse_products(bits)):
            run = replayed_run(plain_api, params, prompts, res.generated, routed)
        dist = from_float32(run, exact)
        controls[f"{bits}_mantissa_bits"] = {
            "vs_float32_max": dist[0], "vs_float32_rms": dist[1],
            "max_ratio": dist[0] / ref[0], "rms_ratio": dist[1] / ref[1],
            "rejected": not within(dist, ref)}
        del run
    del exact
    rand_ids = torch.randint(1, cfg.vocab_size, (BATCH, NEW_TOKENS), device=device,
                             generator=torch.Generator(device=device).manual_seed(1))
    forced_res, forced_routed = recorded_run(api, params, prompts, rand_ids)
    forced = against_float32(plain_api, f32_api, params, prompts, forced_res, forced_routed,
                             False)
    del forced["_plain"], forced["_exact"], forced_res, forced_routed

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
    return launches


SOURCES = {
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cuh", "src/repro/kernels/gemm.py:26"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cuh",
                        "src/repro/kernels/flash_attention.py:28"),
    # both stages as ``ops.flash_decode`` runs them: the function that one
    # library call (scaled_dot_product_attention) also computes
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:62"),
    "flash_decode_partials": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                              "src/repro/kernels/flash_decode.py:31"),
    "flash_decode_combine": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_decode.py:103"),
    "grouped_matmul": ("src/repro_torch/kernels/csrc/grouped_gemm.cuh",
                       "src/repro/kernels/moe_gmm.py:23"),
}


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
    _build.lib()
    info = _build.build_info()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled_here": bool(info.get("built")), "library": info.get("path"),
          "sources": [p.name for p in _build.sources()]})

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    cases = phase_kernels(timer, gen)
    gemm_launches = phase_planner(timer, gen)
    del timer
    torch.cuda.empty_cache()
    serve_launches = phase_serve(device)
    gc.collect()
    torch.cuda.empty_cache()                # the dense model's weights go first
    moe_launches = phase_moe(device)

    launches = dict(serve_launches, gemm=gemm_launches,
                    grouped_matmul=moe_launches["grouped_matmul"])
    launches["flash_decode"] = min(launches["flash_decode_partials"],
                                   launches["flash_decode_combine"])
    kernels_line = []
    for c in cases:
        if not (c["serving"] and c["dtype"] == "bfloat16" and c["name"] in SOURCES) \
                or any(k["name"] == c["name"] for k in kernels_line):
            continue
        source, replaces = SOURCES[c["name"]]
        if launches[c["name"]] < 1:
            raise AssertionError(f"{c['name']} was never launched on the main path")
        kernels_line.append({
            "name": c["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[c["name"]], "max_abs_err": c["max_abs_err"],
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"], "dtype": c["dtype"]})
        served = [x for x in cases if x["serving"] and x["name"] == c["name"]
                  and x["dtype"] == "bfloat16"]
        if len(served) > 1:
            kernels_line[-1]["served_shapes"] = [
                {k: x[k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err")} for x in served]
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
