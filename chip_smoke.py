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
            seamless's cross step; at head dim 256 K2, K3 (with the partials
            kernel and K3') and K2-bwd at gemma-7b's prefill, decode and
            training pass; K2 and K2-bwd with a query offset at
            llama3-405b's context-parallel block, the last of 8 ranks at
            train_4k: 4 x 128 heads on 8 kv heads, 512 queries at offset
            3,584 against 4,096 keys, d 128, the library's time SDPA with
            the offset's mask) and at one ragged shape each, in
            bf16 and float32 (tolerances 2e-2 and 1e-4, those of the
            reference's kernel tests; 2e-3 for the WKV scan in float32 and
            for its final state), each timed with CUDA events (median of 25
            single launches, the L2 cache flushed before each) beside its
            plain version, one PyTorch library call where one computes the
            same function, and the roofline bound; at the served bf16 K1 and
            K4 shapes also the staged GEMM body's fastest tile and the host
            microseconds per call of each body; K5 and K5-bwd at rwkv6-3b's
            shape from a nonzero initial state (and K5-bwd from a nonzero
            final-state gradient), held by the per-call bounds (one bf16
            step for K5's output; 2e-2 of each gradient's largest entry and
            2^-10 relative RMS for K5-bwd's six), with 5-bit controls that
            must be rejected;
4. planner  ``ops.matmul`` with no block at the model's projection shape:
            planner -> GEMM kernel on the TMA body, search then registry
            hit, no fallback; every compiled bf16 GEMM tile (both bodies)
            and flash tile timed at the served shape (d 128, and d 64 at
            zamba2's prefill and seamless's encoder, d 256 at gemma-7b's), and every TMA tile at
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
   chunked_prefill the same weights and prompt written in chunks of 128,
            128 and 256 tokens (``serve.generate(..., prefill_chunks=)``),
            then 32 decode steps: K2 36 x 3 times at offsets 0, 128, 256
            over 128, 256, 512 keys, every call against its plain version
            with a 5-bit control rejected; the logits after each chunk and
            the cache within 2e-2 of one-pass prefills; the ids equal to
            ``serve``'s, or the logits at the first that differs within
            2e-2;
   serve_obs the same model and run through ``serve.main`` with
            ``--introspect-port 0 --introspect-hold 5 --flightrec PATH
            --plan-budget-ms 10``: ids, launches and blocks equal the serve
            phase's; ``/metrics`` (validated exposition, the plan service's
            mesh request answered ok by the mesh planner, the planner's
            counters), ``/healthz``,
            ``/slo``, ``/plans`` (the registry hits of the served blocks) and
            ``/tenants`` scraped from a thread during the hold; the
            flight-recorder dump loads and renders its mesh ``plan_request``;
   tenants  ``serve.main --tenants 2 --tenant-kill 0,0`` (the reference's
            multi-tenant mode: kernel tenants planned onto disjoint
            partitions of a wormhole_8x8 fabric, a core killed, containment
            asserted; no kernel launched) under ``REPRO_FAST_SEARCH=1`` and
            the reference smoke's 5 s plan deadline, with ``/tenants``
            scraped during the hold: both tenants, their QoS and rectangles,
            and the kill's owner, rung, blast radius and seconds;
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
   gemma    ``gemma-7b`` (head dim 256, MHA, GeGLU) at full width and depth
            (28 layers, 8.54 B parameters, 17.1 GB in bf16) as ``serve``
            runs qwen2.5-3b: K2 28 (all on its TMA + wgmma body) and K3
            28 x 32 launches exactly (all on its TMA body), no planner
            fallback, every logit within 2e-2 of the plain path's,
            every K2 and K3 call of a prefill and a decode step within its
            per-call bound of its plain version, and a control whose K2/K3
            outputs keep 5 mantissa bits rejected;
10. moe     ``qwen3-moe-30b-a3b`` at full width and depth (30.5 B
            parameters, 61 GB in bf16), its experts through the grouped-GEMM
            kernel, every launch on the TMA body; the kernel run and the
            plain run, both fed the kernel run's ids and routing (a near-flat
            random router turns bf16 differences into other experts), are
            held against the same loop in float32, with a control that must
            fail; the share of prefill expert choices that agree when the
            plain run routes by itself is reported; then (``moe_chunked``)
            the prompt in two chunks of 256, each dispatched at its own
            capacity, and 2 decode steps: every K2 and K4 call against its
            plain version, the float32 rule with the routing replayed;
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
   resilient the same model and setup through ``launch.train.main`` with
            ``--save-every 2 --ckpt-dir`` a fresh directory under ``build/``:
            the third step runs in full, updating the state in place, then
            raises once; the driver restores the step-2 checkpoint into the
            live tensors and replays.  One ``restart`` event, the step-2
            checkpoint on disk (37 GB: float32 weights and two AdamW
            moments), every restored leaf bit-equal (by digest) to the
            ``train`` run's state after step 2, the three losses within 1e-5
            relative of the ``train`` run's (bit-equality reported); a second
            ``main`` resumes from step 2 by itself and runs step 3 alone, to
            the same loss.  Checkpoint bytes and shards, snapshot, write and
            restore seconds, peak device memory across each restore, free
            disk and host memory before, the card's name and power limit;
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
            time, tok/s and one traced step;
   gemma_train ``gemma-7b`` at full width and 4 of its 28 layers (1.89 B
            parameters; full depth needs about 137 GB of float32 weights,
            gradients and AdamW state): as ``train``, the float32 rule on
            the first gradient, every K2-bwd call (d 256) within its bound
            with a 5-bit control rejected, three AdamW steps through
            ``launch.train`` with exact counts (K2 24, K2-bwd 12, every
            call on the TMA + wgmma bodies);
14. mesh_train plan-sharded training through ``train_step.jit_train_step`` on
            a 1x1 ``launch.mesh.make_host_mesh`` over a world-1 NCCL process
            group: ``qwen2.5-3b`` as in ``train``, three steps under
            megatron_tp and three under zero3, each plan's losses within
            1e-6 relative of the ``train`` phase's (a 1x1 mesh has no local
            axis, so the head-local layers are not entered), exact K2 / K2-bwd counts,
            step time, tok/s, peak memory beside the mesh planner's
            ``hbm_per_chip`` on a one-card ``h100_cluster(1, 1)``, the
            ranking line; then ``qwen3-moe-30b-a3b`` (2 layers) three steps
            under expert_parallel through the expert-parallel branch (all
            128 experts on the one rank), its first loss within 1e-6 of
            ``moe_train``'s, K4's backward launches per step equal to its;
15. mesh_serve the plan-sharded serve step (``serve_step.jit_serve_step``) on
            two ``gloo`` ranks of the one card, a 1x2 mesh, each rank a
            process (``chip_smoke.py --mesh-serve-rank``): ``qwen2.5-3b`` at
            full width and depth under kv_sequence_split, the prompt passed
            through the step into each rank's block of an empty cache split
            over ``kv_seq`` (logits and cache block within 2e-2 of the
            unsharded prefill's, K2 once a layer), then 32 steps in a buffer
            of 1024 keys (rank 0 holds the prompt, rank 1 the new tokens)
            and one in a buffer of 2048 (rank 1 holds no valid key),
            teacher-forced on the ``serve`` phase's ids: every step's logits
            within 2e-2 of the unsharded step's, K3's partials kernel and K3'
            36 x 33 launches a rank and the one-launch K3 none, the first
            step's partials and combines within their per-call bound of
            their plain versions; ms per token, peak memory per rank, the
            ranking line; ``rwkv``, ``hybrid``, ``vlm``, ``encdec``,
            ``gemma``, ``seq_parallel``, ``recurrent_parallel`` and the
            three family training phases run while its ranks run (they
            wait on ``gloo`` more than on the card);
   seq_parallel the plans that split the sequence on two ``gloo`` ranks
            (``chip_smoke.py --seq-parallel-rank``): ``qwen2.5-3b`` at full
            width and depth under sequence_parallel, the 4 x 512 prompt
            through ``jit_serve_step``, each rank's 256 tokens through K2 at
            query offset 0 or 256 (every call within 2e-2 and 2^-8 relative
            RMS of its plain version, a 5-bit control rejected), logits and
            cache block within 2e-2 of the unsharded prefill's; then 4 of
            its layers trained two steps under tp2d (the sequence over
            ``model``), losses within 1e-3 relative of the one-rank step's,
            K2 and K2-bwd counted exactly, every K2-bwd call of the first
            step within its bound, a 5-bit control rejected;
   recurrent_parallel rwkv6, zamba2 and the encoder-decoder computed in
            parts on two ``gloo`` ranks (``chip_smoke.py
            --recurrent-parallel-rank``): ``rwkv6-3b`` and ``zamba2-1.2b``
            at full width and depth, the 4 x 512 prompt through
            ``jit_serve_step`` under megatron_tp (each rank's heads and ffn
            columns) and under sequence_parallel (each rank's 256 tokens,
            the state entering them carried from the other rank's block),
            ``seamless-m4t-medium`` under megatron_tp; each prefill's logits,
            and each cache leaf's slice, at most 1.25 x as far from the
            unsharded float32 prefill's as the unsharded bf16 prefill's (the
            served phases' rule: two correct bf16 paths at full depth end
            far apart, rwkv6's states 25 % of their largest entry); K5
            launched L a rank under megatron_tp and 2 L under
            sequence_parallel, every call within one bf16 step of its plain
            version from the same initial state, a 5-bit control rejected;
            then rwkv6-3b at 4 layers trained two steps under zero3_sp and
            two under megatron_tp, and zamba2-1.2b at 4 Mamba2 layers (2
            sites) two under zero3_sp (float32, AdamW at 1e-4), losses
            within 1e-3 relative of the one-rank steps' and the first
            gradient's norm within 2e-2, every K5-bwd call within its
            bound (2e-2 of
            each output's largest entry, 2^-10 relative RMS) with a 5-bit
            control rejected;
   hybrid_train, vlm_train, encdec_train ``zamba2-1.2b`` (38 Mamba2
            layers, the shared attention at 19 sites), ``internvl2-1b`` (24
            layers, 256 stub patches ahead of the prompt) and
            ``seamless-m4t-medium`` (12 encoder layers over 1024 stub
            frames, 12 decoder layers with cross-attention) trained at full
            width and depth, one phase function for the three, as
            ``rwkv_train``: the float32 rule on the first gradient at full
            depth; every K2-bwd call of that step (d 64) within its bound,
            as many checked as launched, a 5-bit control rejected; three
            AdamW steps through ``launch.train.run``
            with exact counts (K2 114 / 144 / 216, K2-bwd 57 / 72 / 108,
            every call on the ``mma`` bodies, nothing else launched), the
            full parameter count, step ms, tok/s, peak bytes and one traced
            step; all three after ``recurrent_parallel``, while
            ``mesh_serve``'s ranks run;
   family_seq_parallel every family split over the sequence on ``gloo``
            ranks (``chip_smoke.py --family-seq-rank``): on a 1x2 mesh
            ``internvl2-1b`` (its 256 stub patches ahead of the prompt in
            one split sequence) and ``seamless-m4t-medium`` (its 1024 stub
            frames and the prompt each split) at full width and depth and
            ``qwen3-moe-30b-a3b`` at full width and 2 layers (routing
            replayed from the unsharded kernel run; the global capacity
            from the ranks' exchanged pair counts), the 4 x 512 prompt
            through ``jit_serve_step`` under sequence_parallel, held by the
            served phases' rule against the float32 prefill, the MoE's
            pairs routed to and kept by every expert over the ranks equal
            to the unsharded pass's; then float32 steps: 4 layers of
            internvl2-1b, 2 of the MoE (zero3_sp: the expert-parallel
            branch over the gathered sequence; sequence_parallel: the
            count exchange) and 2 + 2 of seamless under zero3_sp, and on a
            2x2 mesh the three prefills under tp2d (the MoE's pairs on each
            rank's slice of the experts as unsharded), 4 layers of rwkv6-3b
            and zamba2-1.2b under tp2d (the embed dim over ``data``) and one
            step each of internvl2, the MoE and seamless under tp2d,
            losses within 1e-3 relative of the
            one-rank steps' and first gradient norms within 2e-2; exact
            launches; every K2, K2-bwd, K4, K4-bwd, K5 and K5-bwd call held
            against its plain version, 5-bit controls rejected;
16. dryrun  ``python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape
            {train_4k,prefill_32k,decode_32k} --mesh single`` and
            ``--shape train_4k --plan tp2d --microbatches 8``, four
            processes, each one rank of a 256-rank no-op world at full width
            and depth (rank 0, or under a plan that splits the sequence the
            last rank along it), heads, ffn columns and vocabulary computed
            locally under megatron_tp, the embed dim split over ``data``
            under tp2d: each row's plan, rank, per-device bytes, roofline
            terms, measured ms and collective bytes (train_4k's all-gather
            on ``model`` must be 0 under megatron_tp: no head, ffn or
            vocabulary leaf is gathered; under tp2d nothing is gathered on
            ``data`` and the partial products are summed there); a failed
            cell fails the phase; the three qwen2.5-3b cells of the
            planner's choice run while ``resilient`` runs, the tp2d cell
            last.  llama3-405b's tp2d cells
            take longer than this script may (its prefill_32k 408 s): run
            them with the same command on their own; the chunked prompt's
            ranks (``mesh_chunked``) run beside the tp2d cell;
   mesh_chunked the chunked prompt into a cache split over ``kv_seq`` on
            two ``gloo`` ranks (``chip_smoke.py --mesh-chunk-rank``):
            ``qwen2.5-3b`` at full width and depth under
            kv_sequence_split, the 512-token prompt in chunks of 256, 128
            and 128 into a cache of 640 (blocks [0, 320) and [320, 640):
            the first chunk leaves rank 1 no visible key, the second
            straddles position 320), each rank's K2 with its log-sum-exp
            over its own block and K3' folding the ranks' rows, then a
            decode step: after every chunk and the step the logits and the
            rank's cache block within 2e-2 of the unsharded chunk loop's
            (made once, on rank 0) and under the float32 rule with a 5-bit
            control rejected, exact launches, every K2 call with its
            log-sum-exp and every K3' fold of chunk rows within its
            per-call bound of its plain version, 5-bit controls rejected;
   examples ``examples/torch_serve_decode.py`` and
            ``examples/torch_train_lm.py`` (each exits 0 with its kernels
            launched) and ``python -m repro_torch.plancache warm``, after
            which a fresh process resolves a warmed GEMM and flash request
            from the store, all while ``resilient`` runs.

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
floor with chunk 32 (no library call computes a WKV backward).  It also
times K3' at ``mesh_serve``'s decode fold (64 rows, 16 splits, d 128) and at
the chunk rows (8,192 rows, 2 splits), names the body of each K3 row (with
the host microseconds a call of the gemma-7b row's TMA body and of the
mma.sync body on the same cache one element off alignment), and gives the
timer's floor: ``torch.cuda._sleep(0)`` under the same flushed events.

Then one line ``{"kernels": [...]}`` with each kernel's launches on the main
path (the reference's two decode functions, ``flash_decode_partials`` and
``combine_partials``, on ``mesh_serve``'s: ``ops.flash_decode`` computes
both in one launch on the unsplit paths) and its measured times, the card's
name and power limit, and as the last line ``{"ok": true, "device": {...}}``.
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
GEMMA_ARCH = "gemma-7b"              # head dim 256
GEMMA_TRAIN_LAYERS = 4
BATCH, PROMPT, NEW_TOKENS = 4, 512, 32
# llama3-405b's context-parallel block at train_4k under tp2d on 32x8: the
# last rank's 512 of 4096 tokens, 4 rows a microbatch
CP_ARCH, CP_ROWS, CP_SEQ, CP_BLOCK = "llama3-405b", 4, 4096, 512


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


def work():
    """``repro_torch.kernels.work``: each kernel's operations and bytes, the
    formulas the kernel wrappers count launches with."""
    from repro_torch.kernels import work as W
    return W


def nbytes(*tensors) -> int:
    return work().nbytes(*tensors)


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
    res.update(bound(work().gemm_flops(M, N, K), nbytes(a, b, out), dtype))
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


def offset_mask(Sq: int, Skv: int, q_offset: int, device):
    """The boolean causal mask of a query block at ``q_offset`` (row r sees
    the keys up to position ``q_offset + r``), for the library's attention."""
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    return qi >= torch.arange(Skv, device=device)[None, :]


def _library_attention(q4, k4, v4, causal, q_offset, g):
    """``scaled_dot_product_attention`` as K2 computes it: causal from 0, or
    with the query offset's mask."""
    if causal and q_offset:
        mask = offset_mask(q4.shape[2], k4.shape[2], q_offset, q4.device)
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=g > 1)
    return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, enable_gqa=g > 1)


def _offset_kw(q_offset: int) -> dict:
    """``q_offset`` as a keyword only where it is not 0, so that these cases
    also run on a checkout whose K2 and K2-bwd take no offset
    (``kernel_ab.py``)."""
    return {"q_offset": q_offset} if q_offset else {}


def attention_body(module, fn, dtype):
    """Run ``fn`` once and name the body its one K2 (or K2-bwd) launch ran
    on: the key of ``module.launches_by_body`` that moved.  A checkout that
    counts no bodies ran every bf16 call on the mma.sync body."""
    counts = getattr(module, "launches_by_body", None)
    if counts is None:
        return ("mma" if dtype == torch.bfloat16 else "f32"), fn()
    before = dict(counts)
    out = fn()
    moved = [b for b in counts if counts[b] != before[b]]
    if len(moved) != 1 or counts[moved[0]] != before[moved[0]] + 1:
        raise AssertionError(f"{module.__name__}: one call moved the body counts {moved}")
    return moved[0], out


def flash_case(timer, gen, B, H, Hkv, Sq, Skv, d, causal, dtype, serving, model=None,
               q_offset=0):
    from repro_torch.kernels import flash_attention as FA, ops
    dev = timer.flush.device
    g = H // Hkv
    q, k4, v4 = _qkv(gen, dev, B, H, Hkv, Sq, Skv, d, dtype)
    off = _offset_kw(q_offset)
    run = lambda: ops.attention(q, k4, v4, causal=causal, q_per_kv=g, **off)
    plain = lambda: FA.flash_attention_plain(q, k4, v4, causal=causal, q_per_kv=g, **off)
    body, out = attention_body(FA, run, dtype)
    err = compare(f"flash_attention {Sq}x{Skv} d={d} q_offset={q_offset} {dname(dtype)}", out,
                  plain(), dtype)
    q4 = q.reshape(B, H, Sq, d)
    lib = lambda: _library_attention(q4, k4, v4, causal, q_offset, g)
    compare("library attention", lib().reshape(B * H, Sq, d), plain(), dtype, tol=2e-2)
    res = {"name": "flash_attention", "shape": f"BH={B * H} kv_heads={B * Hkv} "
           f"Sq={Sq} Skv={Skv} d={d} causal={causal}" + (f" q_offset={q_offset}"
                                                        if q_offset else ""),
           "dtype": dname(dtype), "q_offset": q_offset, "body": body,
           "serving": serving, "model": model, "max_abs_err": err, "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    res.update(bound(work().attention_flops(B * H, Sq, Skv, d, causal, **off),
                     nbytes(q, k4, v4, out), dtype))
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
    # the split rule of the body the call takes (a checkout that counts no
    # decode bodies has one rule)
    rule = {"body": FD.body_for(q, k4, v4, g)} if hasattr(FD, "body_for") else {}
    s = splits or FD.choose_splits(n, B * Hkv, FD.sm_count(dev), FD.MAX_CLUSTER_SPLITS, **rule)
    run = lambda: ops.flash_decode(q, k4, v4, kv_splits=splits, kv_valid_len=valid,
                                   q_per_kv=g)
    plain = lambda: FD.flash_decode_plain(q, k4, v4, kv_valid_len=valid, q_per_kv=g)
    from repro_torch import kernels
    kernels.reset_launch_counts()
    body, out = attention_body(FD, run, dtype)
    if kernels.launch_counts()["flash_decode"] != 1 or sum(kernels.launch_counts().values()) != 1:
        raise AssertionError(f"ops.flash_decode made {kernels.launch_counts()} launches")
    label = f"BH={B * H} kv_heads={B * Hkv} buffer={Skv} valid={n} d={d} splits={s}"
    err = compare(f"flash_decode {label} {dname(dtype)}", out, plain(), dtype)
    q4 = q.reshape(B, H, 1, d)
    lib = lambda: F.scaled_dot_product_attention(q4, k4[:, :, :n], v4[:, :, :n],
                                                 enable_gqa=g > 1)
    compare("library decode", lib().reshape(B * H, 1, d), plain(), dtype, tol=2e-2)
    kv_bytes = work().decode_kv_bytes(B * Hkv, n, d, q.element_size())
    both = {"name": "flash_decode", "shape": label, "dtype": dname(dtype), "body": body,
            "serving": serving, "model": model, "max_abs_err": err,
            "kernel_ms": timer.ms(run), "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    both.update(bound(work().decode_flops(B * H, n, d), kv_bytes + nbytes(q, out), dtype))
    if body == "tma":
        both.update(host_us=host_us(run), mma_host_us=host_us(mma_decode(q, k4, v4, valid, g)))
    if not stages:
        return [both]

    s = splits or FD.choose_splits(n, B * Hkv, FD.sm_count(dev), **rule)
    label = f"BH={B * H} kv_heads={B * Hkv} buffer={Skv} valid={n} d={d} splits={s}"
    part = lambda: FD.flash_decode_partials(q, k4, v4, kv_splits=s, kv_valid_len=valid,
                                            q_per_kv=g)
    part_plain = lambda: FD.flash_decode_partials_plain(q, k4, v4, kv_splits=s,
                                                        kv_valid_len=valid, q_per_kv=g)
    pbody, (m, l, acc) = attention_body(FD, part, dtype)
    mp, lp, accp = part_plain()
    # compare the partials through the exact float32 combine: (m, l, acc) of
    # one split are only defined up to a common rescaling
    err_p = compare("flash_decode_partials " + label,
                    FD.combine_partials_plain(m, l, acc),
                    FD.combine_partials_plain(mp, lp, accp), dtype)
    partials = {"name": "flash_decode_partials", "shape": label, "dtype": dname(dtype),
                "body": pbody, "model": model,
                "serving": serving, "max_abs_err": err_p, "kernel_ms": timer.ms(part),
                "plain_ms": timer.ms(part_plain), "library_ms": None}
    partials.update(bound(work().decode_flops(B * H, n, d), kv_bytes + nbytes(q, m, l, acc),
                          dtype))

    comb = lambda: FD.combine_partials(mp, lp, accp, out_dtype=dtype)
    comb_plain = lambda: FD.combine_partials_plain(mp, lp, accp, out_dtype=dtype)
    err_c = compare("flash_decode_combine " + label, comb(), comb_plain(), dtype)
    combine = {"name": "flash_decode_combine", "shape": label, "dtype": dname(dtype),
               "model": model,
               "serving": serving, "max_abs_err": err_c, "kernel_ms": timer.ms(comb),
               "plain_ms": timer.ms(comb_plain), "library_ms": None}
    combine.update(bound(work().combine_flops(B * H, s, d), nbytes(mp, lp, accp, out),
                         torch.float32))
    return [both, partials, combine]


def mma_decode(q, k4, v4, valid, g):
    """``ops.flash_decode`` on copies of k and v one element off 16-byte
    alignment, which take the mma.sync body: the other body's host cost."""
    from repro_torch.kernels import ops

    def off(x):
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
        B, H, T, d = x.shape
        view = buf[1:1 + x.numel()].view(B, T, H, d).permute(0, 2, 1, 3)
        view.copy_(x)
        return view

    ku, vu = off(k4), off(v4)
    return lambda: ops.flash_decode(q, ku, vu, kv_valid_len=valid, q_per_kv=g)


def combine_case(timer, gen, rows, splits, d, dtype, serving, model) -> dict:
    """K3' alone on random partials, an empty split (-1e30, 0, 0) in every
    eighth row: at mesh_serve's decode fold (64 rows, 2 ranks x 8 splits)
    and at the chunk rows a kv_seq split of two ranks folds."""
    from repro_torch.kernels import flash_decode as FD
    dev = timer.flush.device
    m = torch.randn(rows, splits, 1, 1, generator=gen, device=dev) * 4
    l = torch.rand(rows, splits, 1, 1, generator=gen, device=dev) + 0.5
    acc = torch.randn(rows, splits, 1, d, generator=gen, device=dev)
    m[::8, 0], l[::8, 0], acc[::8, 0] = -1e30, 0.0, 0.0
    comb = lambda: FD.combine_partials(m, l, acc, out_dtype=dtype)
    comb_plain = lambda: FD.combine_partials_plain(m, l, acc, out_dtype=dtype)
    out = comb()
    label = f"rows={rows} splits={splits} d={d}"
    err = compare(f"flash_decode_combine {label}", out, comb_plain(), dtype)
    res = {"name": "flash_decode_combine", "shape": label, "dtype": dname(dtype),
           "serving": serving, "model": model, "max_abs_err": err, "kernel_ms": timer.ms(comb),
           "plain_ms": timer.ms(comb_plain), "library_ms": None}
    res.update(bound(work().combine_flops(rows, splits, d), nbytes(m, l, acc, out),
                     torch.float32))
    return res


# qwen2.5-3b's chunked prefill into a cache split over kv_seq on two ranks
# (mesh_chunked, under mesh_serve's plan): a buffer of 640 positions in
# blocks of 320, the 512-token prompt in chunks of 256, 128 and 128, then a
# decode step
MESH_CHUNK_BUFFER, MESH_CHUNKS, MESH_CHUNK_STEPS = 640, (256, 128, 128), 1


def chunk_fold_cases(timer, gen) -> list:
    """K2 with its log-sum-exp and K3' as a chunk into a cache split over
    kv_seq runs them (``models/layers.py``: ``_block_partials``,
    ``_chunk_over_ranks``), at qwen2.5-3b's rank shape in mesh_serve: the
    last chunk (128 rows at positions 384-511) over rank 1's block of 320
    keys, its first row at offset 64 of the block; then K3' folding the two
    ranks' (output, log-sum-exp) rows, (4·16·128, 2, 1, 128), checked also
    against K2's plain version over both blocks whole.  K2's library time is
    SDPA with the same mask (which returns no log-sum-exp); no one PyTorch
    call computes the fold.  K2's bytes count the keys its rows can see.
    ``rounding`` reports where the fold's bf16 output departs from one
    attention over both blocks rounded once: with the blocks' outputs from
    K2 (bf16), from K2's plain version rounded to bf16, and from the plain
    version in float32 (no rounding before the fold)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA, flash_decode as FD, ops
    from repro_torch.models import layers as L
    dev = timer.flush.device
    cfg = replace(get_config(ARCH), kernels="cuda")
    B, H, Hkv, d = BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g, block, S = H // Hkv, MESH_CHUNK_BUFFER // 2, MESH_CHUNKS[-1]
    index = PROMPT - S
    off = index - block
    dtype = torch.bfloat16
    q, k4, v4 = _qkv(gen, dev, B, H, Hkv, S, block, d, dtype)
    kw = dict(sm_scale=d ** -0.5, causal=True, q_per_kv=g, q_offset=off, return_lse=True)
    run = lambda: ops.attention(q, k4, v4, **kw)
    plain = lambda: FA.flash_attention_plain(q, k4, v4, **kw)
    (out, lse), (pout, plse) = run(), plain()
    label = f"BH={B * H} kv_heads={B * Hkv} Sq={S} Skv={block} d={d} causal=True " \
            f"q_offset={off} return_lse"
    err = max(compare(f"flash_attention {label}", out, pout, dtype),
              compare(f"flash_attention {label} log-sum-exp", lse, plse, dtype))
    q4 = q.reshape(B, H, S, d)
    lib = lambda: _library_attention(q4, k4, v4, True, off, g)
    compare("library attention", lib().reshape(B * H, S, d), pout, dtype, tol=2e-2)
    seen = min(block, off + S)
    k2 = {"name": "flash_attention", "shape": label, "dtype": dname(dtype), "q_offset": off,
          "serving": True, "model": f"{cfg.name} chunk into a kv_seq block (rank 1 of 2)",
          "max_abs_err": err, "kernel_ms": timer.ms(run), "plain_ms": timer.ms(plain),
          "library_ms": timer.ms(lib)}
    k2.update(bound(work().attention_flops(B * H, S, block, d, True, off),
                    nbytes(q, out, lse) + 2 * B * Hkv * seen * d * q.element_size(), dtype))
    # the two ranks' rows: rank 0's block [0, 320) (every key visible) and
    # rank 1's above, as _block_partials hands them to the fold
    k0, v0 = (torch.randn(B, block, Hkv, d, generator=gen, device=dev).to(dtype)
              for _ in range(2))
    qs = q4.permute(0, 2, 1, 3)
    parts = [L._block_partials(qs, k0, v0, index, cfg),
             L._block_partials(qs, k4.permute(0, 2, 1, 3), v4.permute(0, 2, 1, 3), off, cfg)]
    m, l, acc = (torch.cat(t, dim=1).contiguous() for t in zip(*parts))
    fold = lambda: FD.combine_partials(m, l, acc, out_dtype=dtype)
    fold_plain = lambda: FD.combine_partials_plain(m, l, acc, out_dtype=dtype)
    flabel = f"rows={m.shape[0]} splits={m.shape[1]} d={d} (chunk rows of 2 ranks)"
    err_c = compare(f"flash_decode_combine {flabel}", fold(), fold_plain(), dtype)
    kk, vv = (torch.cat([a, b.permute(0, 2, 1, 3)], dim=1).permute(0, 2, 1, 3)
              for a, b in ((k0, k4), (v0, v4)))
    whole = FA.flash_attention_plain(q, kk, vv, sm_scale=d ** -0.5, causal=True, q_per_kv=g,
                                     q_offset=index)
    compare("the fold against attention over both blocks", fold().reshape(B * H, S, d),
            whole, dtype)
    plain_cfg = replace(cfg, kernels="plain")
    blocks = ((k0, v0, index), (k4.permute(0, 2, 1, 3), v4.permute(0, 2, 1, 3), off))

    def folded(to):
        parts = [L._block_partials(to(qs), to(kb), to(vb), o, plain_cfg) for kb, vb, o in blocks]
        m, l, acc = (torch.cat(t, dim=1).contiguous() for t in zip(*parts))
        return FD.combine_partials_plain(m, l, acc, out_dtype=dtype).reshape(B * H, S, d)

    rounding = {}
    for name, got in (("k2_bf16", fold().reshape(B * H, S, d)),
                      ("plain_bf16", folded(lambda t: t)),
                      ("plain_float32", folded(lambda t: t.float()))):
        rounding[name] = {"max_abs_err": (got.float() - whole.float()).abs().max().item(),
                          "elements_not_bit_equal": int((got != whole).sum().item())}
    k3 = {"name": "flash_decode_combine", "shape": flabel, "dtype": dname(dtype),
          "serving": True, "model": f"{cfg.name} chunk rows folded over 2 kv_seq ranks",
          "max_abs_err": err_c, "kernel_ms": timer.ms(fold), "plain_ms": timer.ms(fold_plain),
          "library_ms": None, "rounding": dict(rounding, elements=whole.numel())}
    k3.update(bound(work().combine_flops(m.shape[0], m.shape[1], d),
                    nbytes(m, l, acc, fold()), torch.float32))
    return [k2, k3]


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
    res.update(bound(work().gemm_flops(cap, d_out, d_in, E), nbytes(x, w, out), dtype))
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
    res.update(bound(work().wkv6_flops(BH, T, d, c), nbytes(*xs, o, state), torch.float32))
    return res


def wkv6_bwd_case(timer, gen, BH, T, d, chunk, dtype, serving, floor=False):
    """K5-bwd (dr, dk, dv, dlog_w, du) against its plain version on the same
    inputs and output gradient: each output within 2e-3 (float32) or 2e-2
    (bf16) of its largest entry.  No PyTorch call computes a WKV backward,
    so there is no library time.  The bound counts the bytes of the six
    inputs and five outputs (the kernel's float32 scratch row is its own)
    and ``kernels.work.wkv6_bwd_flops`` at the float32 rate."""
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
    res.update(bound(work().wkv6_bwd_flops(BH, T, d, c), nbytes(*xs, *got), torch.float32))
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


def wkv6_train_case(timer, gen) -> dict:
    """K5 at rwkv6-3b's training and serving pass (160 rows x T 512 x d 64,
    chunk 16, bf16) from a zero state."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    rcfg = get_config(RWKV_ARCH)
    return wkv6_case(timer, gen, BATCH * rwkv6._n_heads(rcfg), PROMPT, rwkv6._head_dim(rcfg),
                     rwkv6.WKV_CHUNK, torch.bfloat16, serving=True)


def wkv6_state_cases(timer, gen) -> list:
    """K5 from a nonzero initial state and K5-bwd from a nonzero initial
    state and final-state gradient, at rwkv6-3b's shape in bf16 (the
    sequence-split passes of ``recurrent_parallel``): the state is the
    final state of a plain scan of another block (the size a carried state
    has), the gradient ~ N(0, 1).  Held by the per-call bounds: K5's output
    within one bf16 step of its plain version and its final state within
    2e-3 (:func:`wkv6_step_errors`); each of K5-bwd's six gradients within
    2e-2 of its largest entry and WKV_BWD_REL_RMS relative RMS; a 5-bit
    control (the outputs rounded to 5 mantissa bits) rejected by each.  No
    PyTorch call computes either function.  The bounds count the state's
    bytes (read, and for K5-bwd the gradients' read and written) beside the
    zero-state cases'."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, rwkv6 as K, rwkv6_bwd as KB
    from repro_torch.models import rwkv6
    rcfg = get_config(RWKV_ARCH)
    BH, T, d, c = BATCH * rwkv6._n_heads(rcfg), PROMPT, rwkv6._head_dim(rcfg), rwkv6.WKV_CHUNK
    dev, dtype = timer.flush.device, torch.bfloat16
    xs = wkv6_inputs(gen, dev, BH, T, d, dtype)
    _, state0 = K.wkv6_plain(*wkv6_inputs(gen, dev, BH, T, d, torch.float32), chunk=c)
    dstate = torch.randn(BH, d, d, generator=gen, device=dev)
    label = f"BH={BH} T={T} d={d} chunk={c} from a state"
    run = lambda: ops.wkv6(*xs, chunk=c, state0=state0)
    plain = lambda: K.wkv6_plain(*xs, chunk=c, state0=state0)
    (o, state), (po, pstate) = run(), plain()
    torch.cuda.synchronize()
    err, share, ok, s_err = wkv6_step_errors(o, state, po, pstate)
    control = wkv6_step_errors(coarse(o, 5), state, po, pstate)
    if not ok or control[2]:
        raise AssertionError(f"wkv6 {label}: o {err} ({share} of one bf16 step), state "
                             f"{s_err}; 5-bit control within: {control[2]}")
    fwd = {"name": "wkv6", "shape": label, "dtype": dname(dtype), "serving": True,
           "from_state": True, "max_abs_err": err, "share_of_bf16_step": share,
           "state_rel_err": s_err, "control_5_bits_share": control[1],
           "control_5_bits_rejected": not control[2], "kernel_ms": timer.ms(run),
           "plain_ms": timer.ms(plain), "library_ms": None}
    fwd.update(bound(work().wkv6_flops(BH, T, d, c), nbytes(*xs, o, state, state0),
                     torch.float32))
    do = torch.randn(BH, T, d, generator=gen, device=dev).to(dtype)
    run = lambda: KB.wkv6_bwd(*xs, do, chunk=c, state0=state0, dstate=dstate)
    plain = lambda: KB.wkv6_bwd_plain(*xs, do, chunk=c, state0=state0, dstate=dstate)
    stats = []
    got = bwd_per_call(stats, KB.wkv6_bwd, KB.wkv6_bwd_plain, of_largest=True)(
        *xs, do, chunk=c, state0=state0, dstate=dstate)
    per_call = summarize_per_call(stats, WKV_BWD_REL_RMS)
    if len(got) != 6 or not per_call["within"] or not per_call["control_5_bits_rejected"]:
        raise AssertionError(f"wkv6_bwd {label}: {per_call}")
    bwd = {"name": "wkv6_bwd", "shape": label, "dtype": dname(dtype), "serving": True,
           "from_state": True, "max_abs_err": per_call["max_abs_err"], "per_call": per_call,
           "kernel_ms": timer.ms(run), "plain_ms": timer.ms(plain, n=5), "library_ms": None,
           "library": "none: no PyTorch call computes a WKV backward"}
    bwd.update(bound(work().wkv6_bwd_flops(BH, T, d, c),
                     nbytes(*xs, do, *got, state0, dstate), torch.float32))
    return [fwd, bwd]


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


def flash_bwd_case(timer, gen, B, H, Hkv, Sq, Skv, d, causal, dtype, serving, model=None,
                   q_offset=0):
    """K2-bwd (dq, dk, dv) against its plain version, from the forward
    kernel's output and log-sum-exp (itself checked against the plain
    forward's), with the query offset ``q_offset``.  Library time: the
    backward alone of scaled_dot_product_attention on the same inputs (with
    the offset's mask).  The bound counts the five products over the
    visible (query, key) pairs (S and dP again, dV, dQ, dK) and the bytes of
    q, k, v, dout, lse, dq, dk, dv, and of o for the float32 body only (the
    bf16 bodies never read it), as ``work.attention_bwd_bytes`` does."""
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
    dev = timer.flush.device
    g = H // Hkv
    q, k4, v4 = _qkv(gen, dev, B, H, Hkv, Sq, Skv, d, dtype)
    dout = torch.randn(B * H, Sq, d, generator=gen, device=dev).to(dtype)
    off = _offset_kw(q_offset)
    tiles = FA.legal_tiles(d, q.element_size())
    bq, bkv = (64, 64) if (64, 64) in tiles else tiles[0]     # float32 at d 256: (64, 32)
    out, lse = FA.flash_attention(q, k4, v4, causal=causal, q_per_kv=g, block_q=bq,
                                  block_kv=bkv, return_lse=True, **off)
    pout, plse = FA.flash_attention_plain(q, k4, v4, causal=causal, q_per_kv=g,
                                          return_lse=True, **off)
    lse_err = compare("flash_attention lse", lse, plse, torch.float32, tol=1e-4)
    compare("flash_attention with lse", out, pout, dtype)
    del pout, plse
    run = lambda: FAB.flash_attention_bwd(q, k4, v4, out, lse, dout, causal=causal,
                                          q_per_kv=g, **off)
    plain = lambda: FAB.flash_attention_bwd_plain(q, k4, v4, out, lse, dout, causal=causal,
                                                  q_per_kv=g, **off)
    label = (f"BH={B * H} kv_heads={B * Hkv} Sq={Sq} Skv={Skv} d={d} causal={causal}"
             + (f" q_offset={q_offset}" if q_offset else ""))
    body, grads = attention_body(FAB, run, dtype)
    err = max(compare(f"flash_attention_bwd {name} {label} {dname(dtype)}", a, b, dtype)
              for name, a, b in zip(("dq", "dk", "dv"), grads, plain()))
    q4 = q.reshape(B, H, Sq, d).detach().requires_grad_()
    kl, vl = (t.detach().contiguous().requires_grad_() for t in (k4, v4))
    lib_out = _library_attention(q4, kl, vl, causal, q_offset, g)
    dout4 = dout.reshape(B, H, Sq, d)
    lib = lambda: torch.autograd.grad(lib_out, (q4, kl, vl), dout4, retain_graph=True)
    res = {"name": "flash_attention_bwd", "shape": label, "dtype": dname(dtype),
           "q_offset": q_offset, "body": body,
           "serving": serving, "model": model, "max_abs_err": err, "lse_max_abs_err": lse_err,
           "kernel_ms": timer.ms(run), "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib)}
    res.update(bound(work().attention_bwd_flops(B * H, Sq, Skv, d, causal, **off),
                     nbytes(q, k4, v4, lse, dout, *((out,) if body == "f32" else ()))
                     + nbytes(q, k4, v4), dtype))
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
    res.update(bound(2 * work().gemm_flops(M, N, K), nbytes(a, b, dc) + nbytes(a, b), dtype))
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
    res.update(bound(2 * work().gemm_flops(cap, d_out, d_in, E),
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
    cases += wkv6_state_cases(timer, gen)
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
    # seamless's decoder self pass (512 causal, G 1), which training runs
    # and no served K2 case times
    scfg = get_config(ENCDEC_ARCH)
    cases.append(flash_bwd_case(timer, gen, BATCH, scfg.n_heads, scfg.n_kv_heads, PROMPT,
                                PROMPT, scfg.head_dim_, True, torch.bfloat16, serving=True,
                                model=scfg.name + " decoder self"))
    # head dim 256 at gemma-7b's shapes: its prefill (16 heads, MHA), its
    # decode (G 1) with the partials kernel and K3', its training pass
    gcfg = get_config(GEMMA_ARCH)
    gH, gHkv, gd = gcfg.n_heads, gcfg.n_kv_heads, gcfg.head_dim_
    for dtype in (torch.bfloat16, torch.float32):
        served = dtype == torch.bfloat16
        cases.append(flash_case(timer, gen, BATCH, gH, gHkv, PROMPT, PROMPT, gd, True, dtype,
                                serving=served, model=gcfg.name))
        cases += decode_cases(timer, gen, BATCH, gH, gHkv, buffer_len, PROMPT + 1, gd, dtype,
                              serving=served, model=gcfg.name)
        cases.append(flash_bwd_case(timer, gen, BATCH, gH, gHkv, PROMPT, PROMPT, gd, True,
                                    dtype, serving=served, model=gcfg.name))
    cases.append(flash_bwd_case(timer, gen, 1, 6, 2, 100, 77, gd, True, torch.bfloat16, False))
    # K2 and K2-bwd with a query offset at llama3-405b's context-parallel
    # block: the last of 8 ranks along `model` at train_4k (tp2d), 4 rows of
    # 512 queries at positions 3584-4095 against the 4096 keys before them
    lcfg = get_config(CP_ARCH)
    for dtype in (torch.bfloat16, torch.float32):
        for case in (flash_case, flash_bwd_case):
            cases.append(case(timer, gen, CP_ROWS, lcfg.n_heads, lcfg.n_kv_heads, CP_BLOCK,
                              CP_SEQ, lcfg.head_dim_, True, dtype,
                              serving=dtype == torch.bfloat16,
                              model=f"{lcfg.name} context-parallel block, last rank of 8",
                              q_offset=CP_SEQ - CP_BLOCK))
            gc.collect()
            torch.cuda.empty_cache()
    cases.append(gemm_bwd_case(timer, gen, M, N, K, torch.bfloat16, True))
    cases.append(gemm_bwd_case(timer, gen, 96, 64, 160, torch.float32, False))
    for d_in, d_out in ((d, f), (f, d)):
        cases.append(grouped_bwd_case(timer, gen, E, moe._capacity(BATCH * PROMPT, mcfg), d_in,
                                      d_out, torch.bfloat16, True))
    cases.append(grouped_bwd_case(timer, gen, 8, 24, 96, 160, torch.float32, False))
    cases += chunk_fold_cases(timer, gen)
    cases += k3_combine_cases(timer, gen)
    emit({"phase": "kernels", "timing": "median of 25 single launches, L2 flushed "
          "before each, CUDA events", "timer_floor_ms": timer_floor_ms(timer),
          "cases": cases, "plain_modules": [ssd_case(timer, gen)]})
    return cases


def k3_combine_cases(timer, gen) -> list:
    """K3' at mesh_serve's own decode fold (qwen2.5-3b's 64 query heads over
    2 ranks x 8 splits, d 128, bf16 out) and at mesh_chunked's chunk rows
    (4 x 16 heads x 128 rows, 2 ranks), on random partials."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    H, d = BATCH * cfg.n_heads, cfg.head_dim_
    return [combine_case(timer, gen, H, 2 * 8, d, torch.bfloat16, True,
                         f"{cfg.name} mesh_serve decode fold (2 ranks x 8 splits)"),
            combine_case(timer, gen, H * MESH_CHUNKS[-1], 2, d, torch.bfloat16, True,
                         f"{cfg.name} chunk rows folded over 2 kv_seq ranks")]


def timer_floor_ms(timer) -> float:
    """The least a timed launch reads: an empty kernel
    (``torch.cuda._sleep(0)``) under the same flushed events."""
    return timer.ms(lambda: torch.cuda._sleep(0))


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
    # and at head dim 64 (zamba2's causal prefill and seamless's encoder) and
    # 256 (gemma-7b's prefill)
    gcfg = get_config(GEMMA_ARCH)
    served = [(*c, 64) for c in served_flash_d64()[::2]]
    served.append((gcfg.name, BATCH, gcfg.n_heads, gcfg.n_kv_heads, PROMPT, PROMPT, True,
                   gcfg.head_dim_))
    flash_other = {}
    for model, B_, H_, Hkv_, Sq, Skv, causal, d_ in served:
        q, k4, v4 = _qkv(gen, dev, B_, H_, Hkv_, Sq, Skv, d_, dtype)
        planned = str(tuple(lower_torch.plan_flash_blocks(Sq, Skv, d_, dtype)))
        times = {str(t): timer.ms(lambda t=t: FA.flash_attention(
            q, k4, v4, causal=causal, block_q=t[0], block_kv=t[1], q_per_kv=H_ // Hkv_), n=10)
            for t in lower_torch.flash_tile_options(d_, 2)}
        order = sorted(times, key=times.get)
        flash_other[model] = {"shape": [Sq, Skv, d_], "causal": causal, "blocks": planned,
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
          "flash_d64": {m: r for m, r in flash_other.items() if r["shape"][2] == 64},
          "flash_d256": {m: r for m, r in flash_other.items() if r["shape"][2] == 256}})
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
        "planservice mesh ranking ok": lambda l: l.startswith("planservice_requests_total{")
        and ('rung="search"' in l or 'rung="cache"' in l) and 'outcome="ok"' in l,
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
    if not slo_rep["enabled"] or slo_rep["rungs"].get("search", 0) \
            + slo_rep["rungs"].get("cache", 0) < 1:
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
                        rf"\(rung=(search|cache) ([0-9.]+)ms\): (\w+(, \w+)*)", printed)
    if ranking is None or mesh[0]["outcome"] != "ok":
        raise AssertionError(f"serve_obs: no ranking line from the mesh planner, or its "
                             f"request did not answer ok: {mesh}")
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
                      "plans": ranking.group(3).split(", "),
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
    chunked = phase_chunked_prefill(api, params, prompts, res)
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
                      "tok_per_s": BATCH * NEW_TOKENS / res.decode_s}, chunked


CHUNKS = (128, 128, 256)          # the chunked prefill's chunks of the 512-token prompt


def phase_chunked_prefill(api, params, prompts, served) -> dict:
    """qwen2.5-3b on ``serve``'s weights and prompt, through
    ``serve.generate(..., prefill_chunks=CHUNKS)``: the prompt written in
    chunks of 128, 128 and 256 tokens, each a causal pass at the cache's
    index (K2 with the query offset 0, 128, 256 over the first 128, 256,
    512 keys), then NEW_TOKENS decode steps.  Launches exact (counted from
    0 around the run); every K2 call of the chunks, written again, held
    against its plain version on the same inputs (within 2e-2 of its
    largest entry and ATTN_REL_RMS, a 5-bit control rejected); the logits
    after each chunk within 2e-2 of a one-pass prefill of the same prefix,
    the whole cache within 2e-2 of the one-pass prefill's; the decoded ids
    equal to ``serve``'s, or at the first that differs the logits that chose
    it within 2e-2 of ``serve``'s."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, ops
    from repro_torch.launch import serve
    cfg, L = api.cfg, api.cfg.n_layers
    stats, offsets, keys = [], [], []
    attention = ops.attention

    def recording(q, k, v, **kw):
        offsets.append(kw.get("q_offset", 0))
        keys.append(k.shape[-2])
        return attention(q, k, v, **kw)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with patched(ops, "attention", recording):
        res = serve.generate(api, params, prompts, NEW_TOKENS, keep_step_logits=True,
                             prefill_chunks=CHUNKS)
    launches = kernels.launch_counts()
    # the chunks again, every K2 call held against its plain version
    with torch.no_grad(), patched(ops, "attention", one_output_per_call(
            stats, ops.attention, FA.flash_attention_plain)):
        chunked_cache, at = api.init_cache(cfg, BATCH, PROMPT + 2, device=prompts.device), 0
        for n in CHUNKS:
            _, chunked_cache = api.prefill(params, prompts[:, at:at + n], chunked_cache)
            at += n
    want = {"gemm": 0, "flash_attention": len(CHUNKS) * L, "flash_decode": L * NEW_TOKENS,
            "flash_decode_partials": 0, "flash_decode_combine": 0, "grouped_matmul": 0,
            "wkv6": 0, "flash_attention_bwd": 0, "wkv6_bwd": 0}
    bad = []
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    ends = [sum(CHUNKS[:i + 1]) for i in range(len(CHUNKS))]
    if offsets != [e - n for e, n in zip(ends, CHUNKS) for _ in range(L)] \
            or keys != [e for e in ends for _ in range(L)]:
        bad.append(f"K2 offsets {sorted(set(offsets))} over keys {sorted(set(keys))}")
    per_call = summarize_per_call(stats)
    if per_call["calls"] != want["flash_attention"] or not per_call["within"] \
            or not per_call["control_5_bits_rejected"]:
        bad.append(f"K2 per call {per_call}")
    # one-pass prefills of each chunk's prefix, off the counted run
    chunk_errs, cache_errs = [], {}
    with torch.no_grad():
        for e, got in zip(ends, res.chunk_logits):
            cache = api.init_cache(cfg, BATCH, PROMPT + 2, device=prompts.device)
            logits, cache = api.prefill(params, prompts[:, :e], cache)
            want_l = logits[:, -1, :cfg.vocab_size].float()
            chunk_errs.append((got - want_l).abs().max().item())
            if not torch.allclose(got, want_l, rtol=2e-2, atol=2e-2):
                bad.append(f"logits after {e} tokens {chunk_errs[-1]} from the one-pass's")
        for name in ("k", "v"):
            a, b = chunked_cache[name].float(), cache[name].float()
            cache_errs[name] = (a - b).abs().max().item()
            if not torch.allclose(a, b, rtol=2e-2, atol=2e-2):
                bad.append(f"cache {name} {cache_errs[name]} from the one-pass prefill's")
    flips = (res.generated != served.generated.to(res.generated.device)).any(dim=0)
    first = int(flips.nonzero()[0]) if bool(flips.any()) else None
    ids = {"equal_serve": first is None, "first_flip": first}
    if first is not None:
        mine = ([res.prefill_logits] + res.step_logits)[first]
        theirs = ([served.prefill_logits] + served.step_logits)[first]
        ids["logit_err_at_flip"] = (mine - theirs).abs().max().item()
        if ids["logit_err_at_flip"] > 2e-2:
            bad.append(f"ids flip at step {first} with logits {ids['logit_err_at_flip']} apart")
    out = {"phase": "chunked_prefill", "arch": cfg.name, "n_layers": L, "batch": BATCH,
           "prompt_len": PROMPT, "chunks": list(CHUNKS), "new_tokens": NEW_TOKENS,
           "prefill_ms": res.prefill_s * 1e3, "one_pass_prefill_ms": served.prefill_s * 1e3,
           "decode_ms_per_token": res.decode_s * 1e3 / NEW_TOKENS, "launches": launches,
           "k2_offsets": sorted(set(offsets)), "k2_keys": sorted(set(keys)),
           "per_call": per_call, "chunk_logit_err_vs_one_pass": chunk_errs,
           "cache_err_vs_one_pass": cache_errs, "ids": ids,
           "check": "exact launches; K2 at offsets 0/128/256 over 128/256/512 keys, every "
                    f"call within 2e-2 of its largest entry and {ATTN_REL_RMS} relative rms "
                    "of its plain version, 5-bit control rejected; logits after each chunk "
                    "and the cache within 2e-2 of one-pass prefills; ids equal serve's or "
                    "the logits at the first flip within 2e-2"}
    emit(out)
    if bad:
        raise AssertionError(f"chunked_prefill: {bad}")
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


def recorded_run(api, params, prompts, ids=None, chunks=None, tokens=NEW_TOKENS):
    """``serve.generate`` that records every routing decision, in call order
    (``chunks``: the prompt written in chunks of those sizes)."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    router, routed = moe._router, []

    def recording(xf, router_w, c):
        out = router(xf, router_w, c)
        routed.append(out[:2])
        return out

    with patched(moe, "_router", recording):
        res = serve.generate(api, params, prompts, tokens, keep_step_logits=True,
                             forced_ids=ids, prefill_chunks=chunks)
    return res, routed


def replayed_run(api, params, prompts, ids, routed, chunks=None, tokens=NEW_TOKENS):
    """``serve.generate`` fed ``ids`` and the routing another run recorded."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    router, replay = moe._router, iter(routed)
    with patched(moe, "_router",
                 lambda xf, router_w, c: (*next(replay), router(xf, router_w, c)[2])):
        res = serve.generate(api, params, prompts, tokens, keep_step_logits=True,
                             forced_ids=ids, prefill_chunks=chunks)
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
    """Largest and root-mean-square difference of every logit of ``run`` from
    the float32 run: after each prompt chunk (the last is the prefill's), and
    of each step."""
    def logits(r):
        return [*r.chunk_logits[:-1], r.prefill_logits, *r.step_logits]
    diff = torch.cat([(a.float() - b.float()).flatten()
                      for a, b in zip(logits(run), logits(exact), strict=True)])
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
            "ids_equal_float32_argmax": f"{same}/{ids.numel()}" if greedy else None,
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


def wkv6_step_errors(o, state, po, pstate) -> tuple:
    """One K5 call against its plain version on the same inputs: (largest
    difference of o, its largest share of the one-bf16-step bound
    ``2^-7 |plain| + 1e-4 max |plain|``, whether o is within that bound and
    the final state within 2e-3 of its largest entry, the state's error)."""
    diff, ref = (o.float() - po.float()).abs(), po.float().abs()
    slack = BF16_ULP * ref + 1e-4 * ref.max()
    s_err = ((state - pstate).abs().max() / pstate.abs().max().clamp(min=1e-30)).item()
    return (diff.max().item(), (diff / slack).max().item(),
            bool((diff <= slack).all()) and s_err <= 2e-3, s_err)


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
        errs.append(wkv6_step_errors(o, state, *K.wkv6_plain(*args, chunk=chunk)))
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


def phase_gemma(device) -> dict:
    """gemma-7b served at full width and depth, the first head-dim-256
    model: K2 on every layer's prompt pass (all on its TMA + wgmma body) and
    K3 on every decode-step attention, launch counts exact, no planner
    fallback; judged as
    ``serve`` judges qwen2.5-3b (every logit within 2e-2 of the plain
    path's, :func:`against_plain`), and every K2 and K3 call of a prefill
    and a decode step held against its plain version on the same inputs
    (:func:`attention_per_call`), where a control with 5 mantissa bits
    must be rejected."""
    from repro_torch import kernels
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model
    cfg = common.launch_config(GEMMA_ARCH, kernels_path="cuda")
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
    by_body = kernels.launches_by_body()["flash_attention"]
    L = cfg.n_layers
    want = {"gemm": 0, "flash_attention": L, "flash_decode": L * NEW_TOKENS,
            "flash_decode_partials": 0, "flash_decode_combine": 0, "grouped_matmul": 0,
            "wkv6": 0, "flash_attention_bwd": 0, "wkv6_bwd": 0}
    if launches != want:
        raise AssertionError(f"gemma: kernel launches {launches}, expected {want}")
    # every prompt pass (bf16, head dim 256, aligned) on K2's TMA + wgmma body
    if by_body != {"tma": L, "mma": 0, "f32": 0}:
        raise AssertionError(f"gemma: K2 launches by body {by_body}, expected all {L} on "
                             f"the TMA body")
    # every decode-step attention on K3's TMA body
    decode_by_body = kernels.launches_by_body()["flash_decode"]
    if decode_by_body != {"tma": L * NEW_TOKENS, "mma": 0, "f32": 0}:
        raise AssertionError(f"gemma: K3 launches by body {decode_by_body}, expected all "
                             f"{L * NEW_TOKENS} on the TMA body")
    check_outputs("gemma", res, cfg)
    fallbacks = check_planner("gemma", res)
    plain_api = build_model(replace(cfg, kernels="plain"))
    ref = serve.generate(plain_api, params, prompts, NEW_TOKENS, keep_step_logits=True,
                         forced_ids=res.generated)
    agreement = against_plain("gemma", res, ref)
    per_call = attention_per_call(api, params, prompts, {})
    control = attention_per_call(api, params, prompts, {}, coarse_attention(5))
    emit({"phase": "gemma", "arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
          "head_dim": cfg.head_dim_, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "n_params": api.n_params(), "batch": BATCH, "prompt_len": PROMPT,
          "new_tokens": NEW_TOKENS, "compute_dtype": cfg.compute_dtype, "load_s": load_s,
          "prefill_ms": res.prefill_s * 1e3,
          "decode_ms_per_token": res.decode_s * 1e3 / NEW_TOKENS,
          "tok_per_s": BATCH * NEW_TOKENS / res.decode_s,
          "plain_prefill_ms": ref.prefill_s * 1e3,
          "plain_decode_ms_per_token": ref.decode_s * 1e3 / NEW_TOKENS,
          "peak_bytes": res.peak_bytes, "launches": launches,
          "flash_attention_launches_by_body": by_body,
          "flash_decode_launches_by_body": decode_by_body, "planner_fallbacks": fallbacks,
          **agreement, "per_call": per_call, "control_5_mantissa_bits": control,
          "first_ids": res.generated[0, :16].tolist(),
          "blocks": {f"{t}{list(s)}": [list(b), src]
                     for (t, s), (b, src) in res.blocks.items()}})
    if not per_call["within"] or per_call["attention"]["calls"] != L \
            or per_call["flash_decode"]["calls"] != L:
        raise AssertionError(f"gemma: a K2/K3 call disagrees with its plain version, or the "
                             f"calls were not counted: {per_call}")
    if control["within"]:
        raise AssertionError("gemma: the per-call check did not reject the 5-bit control")
    del params
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
    chunked = moe_chunked_prefill(api, plain_api, f32_api, params, prompts)
    return launches, by_body["grouped_matmul"], chunked


MOE_CHUNKS, MOE_CHUNK_TOKENS = (256, 256), 2


def moe_chunked_prefill(api, plain_api, f32_api, params, prompts) -> dict:
    """The ``moe`` phase's weights and prompt written in chunks of 256 and
    256 tokens (``serve.generate(..., prefill_chunks=MOE_CHUNKS)``; each
    chunk dispatched with its own capacity, ``_capacity(B x 256)``), then
    MOE_CHUNK_TOKENS decode steps.  Launches exact (counted from 0 around
    the run); every K2 and K4 call held against its plain version on the
    same inputs (within 2e-2 of its largest entry and ATTN_REL_RMS, a 5-bit
    control rejected); the logits after each chunk and of each step held to
    the float32 rule with the kernel run's routing replayed in the plain and
    float32 runs, and a run whose expert products keep 5 mantissa bits
    rejected by the same rule."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, moe_gmm, ops
    from repro_torch.models import moe
    cfg, L = api.cfg, api.cfg.n_layers
    stats = {"flash_attention": [], "grouped_matmul": []}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    moe.DISPATCH_TRACE = []
    with patched(ops, "attention", one_output_per_call(
            stats["flash_attention"], ops.attention, FA.flash_attention_plain)), \
            patched(ops, "grouped_matmul", one_output_per_call(
                stats["grouped_matmul"], ops.grouped_matmul, moe_gmm.grouped_matmul_plain)):
        res, routed = recorded_run(api, params, prompts, chunks=MOE_CHUNKS,
                                   tokens=MOE_CHUNK_TOKENS)
    launches = kernels.launch_counts()
    trace, moe.DISPATCH_TRACE = moe.DISPATCH_TRACE, None
    passes = len(MOE_CHUNKS) + MOE_CHUNK_TOKENS
    want = {"gemm": 0, "flash_attention": len(MOE_CHUNKS) * L,
            "flash_decode": L * MOE_CHUNK_TOKENS, "flash_decode_partials": 0,
            "flash_decode_combine": 0, "grouped_matmul": 3 * L * passes, "wkv6": 0,
            "flash_attention_bwd": 0, "wkv6_bwd": 0}
    bad = [] if launches == want else [f"launches {launches}, expected {want}"]
    per_call = {k: summarize_per_call(v) for k, v in stats.items()}
    for name, pc in per_call.items():
        if pc["calls"] != want[name] or not (pc["within"] and pc["control_5_bits_rejected"]):
            bad.append(f"{name} per call {pc}")
    cap = moe._capacity(BATCH * MOE_CHUNKS[0], cfg)
    prefill = trace[:len(MOE_CHUNKS) * L]
    if any(t["buffer"][1] != cap for t in prefill):
        bad.append(f"chunk buffers {sorted({tuple(t['buffer']) for t in prefill})}, capacity {cap}")
    routed_pairs = sum(int(t["routed"].sum()) for t in prefill)
    kept_pairs = sum(int(t["kept"].sum()) for t in prefill)

    def replay(run_api):
        return lambda ids: replayed_run(run_api, params, prompts, ids, routed, MOE_CHUNKS,
                                        MOE_CHUNK_TOKENS)

    def coarser(ids):
        with patched(moe_gmm, "grouped_matmul_plain", coarse_products(5)):
            return replay(plain_api)(ids)
    rule = float32_rule(res, replay(plain_api), replay(f32_api), True, {5: coarser})
    control = dict(rule.pop("_controls")[5])
    rule["control_5_mantissa_bits"] = dict(control, rejected=control.pop("float32_rule_rejects"))
    if not rule["within"]:
        bad.append(f"the kernel path is further from float32 than the plain path allows: {rule}")
    if not rule["control_5_mantissa_bits"]["rejected"]:
        bad.append("the float32 check did not reject the 5-bit control")
    if not all(torch.isfinite(x).all() for x in [res.prefill_logits, *res.step_logits]):
        bad.append("non-finite logits")
    emit({"phase": "moe_chunked", "arch": cfg.name, "n_layers": L, "batch": BATCH,
          "prompt_len": PROMPT, "chunks": list(MOE_CHUNKS), "new_tokens": MOE_CHUNK_TOKENS,
          "prefill_ms": res.prefill_s * 1e3, "launches": launches, "per_call": per_call,
          "chunk_capacity": cap, "chunk_pairs_routed": routed_pairs,
          "chunk_pairs_dropped": routed_pairs - kept_pairs,
          "float32_rule": rule,
          "check": "exact launches; every K2 and K4 call within 2e-2 of its largest entry "
                   f"and {ATTN_REL_RMS} relative rms of its plain version, 5-bit control "
                   "rejected; each chunk dispatched at its own capacity; logits after "
                   "each chunk and of each step at most 1.25 x as far from the float32 "
                   "run as the plain run's (routing replayed), 5-bit control rejected"})
    if bad:
        raise AssertionError(f"moe_chunked: {bad}")
    return launches


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
            "max_rel_rms_by_output": [max(r["rel_rms"][i] for r in stats
                                          if i < len(r["rel_rms"]))
                                      for i in range(max(len(r["rel_rms"]) for r in stats))],
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
    for the device's busy time.  Returns the launches and, for the
    ``resilient`` phase, the three losses and a digest of every leaf of the
    state after step 2."""
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
    record = {}

    def after_step(step, state, metrics, dt):
        if step == RESUME_STEP:
            record["digests"] = state_digests(state)

    kernels.reset_launch_counts()
    res = TL.run(api, tcfg, steps, BATCH, PROMPT, device, state=state, log_every=1,
                 log=lines.append, on_step=after_step)
    launches = res.launches
    record["losses"] = [h["loss"] for h in res.history]
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
    return launches, record


RESUME_STEP = 2                 # the resilient phase's checkpoint: after step 2 of 3
DIGEST_CHUNK = 1 << 26
BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def leaf_digest(t: torch.Tensor) -> list:
    """Two sums of a leaf's bits read as integers, on the card: a plain one
    and one weighted by a hash of each position.  Equal digests of two
    leaves mean equal bits, short of a collision."""
    bits = t.detach().reshape(-1).view(BITS[t.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    weighted = torch.zeros((), dtype=torch.int64, device=t.device)
    for start in range(0, bits.numel(), DIGEST_CHUNK):
        x = bits[start:start + DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(start, start + x.numel(), dtype=torch.int64, device=t.device)
        total += x.sum()
        weighted += (x * ((pos * 2654435761) % 2147483647 + 1)).sum()
    return [int(total), int(weighted)]


def state_digests(state) -> list:
    from repro_torch.ckpt.checkpoint import leaves
    return [leaf_digest(t) for t in leaves(state)]


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return -1


def phase_resilient(device, uninterrupted: dict) -> dict:
    """qwen2.5-3b trained at full width and depth through
    ``launch.train.main`` with ``--save-every 2`` (the ``train`` phase's
    setup): the third step runs in full, updating the state in place, and
    then raises once, so only a real restore makes its replay right.  One
    ``restart`` event, the step-2 checkpoint on disk, every leaf the driver
    restored bit-equal (by digest) to the state after step 2 of the
    ``train`` phase's uninterrupted run, and the three losses within 1e-5
    relative of that run's (bit-equality reported).  Then a second ``main``
    with the same arguments resumes from step 2 by itself and runs step 3
    alone, to the same loss.  The snapshot, the file write and each restore
    are timed (the write on the manager's thread), with the peak device
    memory across each restore."""
    import shutil
    import tempfile
    from repro_torch import kernels
    from repro_torch.ckpt import checkpoint as C, manager as M
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import common, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import train_step as TS
    cfg = common.launch_config(ARCH)
    api = build_model(cfg)
    L = cfg.n_layers
    state_bytes = sum(t.numel() * t.element_size()
                      for t in C.leaves(TS.abstract_state(api, TrainConfig())))
    work = tempfile.mkdtemp(prefix=f"resilient-{os.getpid()}-",
                            dir=os.path.join(ROOT, "build"))
    timings = {"snapshot_s": [], "write_s": [], "wait_s": [], "restores": []}
    calls = {"n": 0}
    real_step = TS.make_train_step
    real_snapshot, real_save = M.snapshot, C.save
    real_wait, real_restore = M.CheckpointManager.wait, M.CheckpointManager.restore_latest

    def failing_step(api_, tcfg_):
        step = real_step(api_, tcfg_)

        def run_then_fail(state, batch):
            out = step(state, batch)
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("injected failure after the in-place update")
            return out
        return run_then_fail

    def timed_snapshot(tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = real_snapshot(tree)
        timings["snapshot_s"].append(time.perf_counter() - t0)
        return snap

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        out = real_save(*args, **kw)
        timings["write_s"].append(time.perf_counter() - t0)
        return out

    def timed_wait(self):
        pending = self._thread is not None
        t0 = time.perf_counter()
        real_wait(self)
        if pending:
            timings["wait_s"].append(time.perf_counter() - t0)

    def timed_restore(self, target_tree=None, shardings=None, device="cuda"):
        into = "meta" if all(t.device.type == "meta" for t in C.leaves(target_tree)) \
            else "live"
        ptrs = [t.data_ptr() for t in C.leaves(target_tree)]
        self.wait()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree, step = real_restore(self, target_tree, shardings, device)
        torch.cuda.synchronize()
        rec = {"into": into, "step": step, "seconds": time.perf_counter() - t0,
               "held_before_bytes": held, "peak_bytes": torch.cuda.max_memory_allocated()}
        if tree is not None:
            rec["digests"] = state_digests(tree)
            rec["in_place"] = into == "live" and ptrs == [t.data_ptr() for t in C.leaves(tree)]
        timings["restores"].append(rec)
        return tree, step

    args = ["--arch", ARCH, "--steps", "3", "--batch", str(BATCH), "--seq", str(PROMPT),
            "--save-every", str(RESUME_STEP), "--ckpt-dir", work, "--log-every", "1"]
    free_before = shutil.disk_usage(work).free
    host_before = host_available_bytes()
    try:
        if free_before < 1.5 * state_bytes:
            raise AssertionError(f"resilient: {free_before} bytes free under {work}, less than "
                                 f"1.5 x the checkpoint's {state_bytes} bytes")
        out = WatchedStdout(sys.stdout, r"\[train\] resumed from step (\d+)")
        launches = []
        with patched(M, "snapshot", timed_snapshot), patched(C, "save", timed_save), \
                patched(M.CheckpointManager, "wait", timed_wait), \
                patched(M.CheckpointManager, "restore_latest", timed_restore), \
                contextlib.redirect_stdout(out):
            with patched(TS, "make_train_step", failing_step):
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                first = TL.main(args)
                first_s = time.perf_counter() - t0
                launches.append(kernels.launch_counts())
            failed_run = {"losses": [h["loss"] for h in first.history],
                          "events": [(e.step, e.kind, e.detail) for e in first.events],
                          "peak_bytes": first.peak_bytes, "seconds": first_s}
            where = os.path.join(work, cfg.name)
            steps_on_disk = C.list_steps(where)
            manifest = C.load_manifest(C.latest(where))
            shard_bytes = sum(os.path.getsize(os.path.join(C.latest(where), name))
                              for name in manifest["shards"])
            del first
            gc.collect()
            torch.cuda.empty_cache()
            resumed_line_before = out.match
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            second = TL.main(args)
            second_s = time.perf_counter() - t0
            launches.append(kernels.launch_counts())
            resumed = {"losses": [h["loss"] for h in second.history],
                       "events": [(e.step, e.kind) for e in second.events],
                       "resumed_from": int(out.match.group(1)) if out.match else None,
                       "seconds": second_s}
            del second
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    want_losses = uninterrupted["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(failed_run["losses"], want_losses)]
    resumed_rel = [abs(a - b) / abs(b) for a, b in zip(resumed["losses"], want_losses[2:])]
    restarts = [e for e in failed_run["events"] if e[1] == "restart"]
    live = [r for r in timings["restores"] if r["into"] == "live" and "digests" in r]
    meta = [r for r in timings["restores"] if r["into"] == "meta" and "digests" in r]
    want_digests = uninterrupted["digests"]
    mismatched = {kind: [list(manifest["leaves"])[i] for i, (a, b) in
                         enumerate(zip(r["digests"], want_digests)) if a != b]
                  for kind, r in (("live", live[0] if live else None),
                                  ("meta", meta[0] if meta else None)) if r}
    per_call = {name: sum(c[name] for c in launches) for name in launches[0]}
    want_launches = {name: 0 for name in per_call}
    want_launches.update(flash_attention=2 * L * 5, flash_attention_bwd=L * 5)
    emit({"phase": "resilient", "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
          "batch": BATCH, "seq": PROMPT, "save_every": RESUME_STEP,
          "card": smi_line(), "state_bytes": state_bytes,
          "checkpoint": {"steps_on_disk": steps_on_disk, "bytes": shard_bytes,
                         "shards": len(manifest["shards"]), "leaves": len(manifest["leaves"])},
          "disk_free_before_bytes": free_before, "host_available_before_bytes": host_before,
          "snapshot_s": timings["snapshot_s"], "write_s": timings["write_s"],
          "wait_for_write_s": timings["wait_s"],
          "restores": [{k: v for k, v in r.items() if k != "digests"}
                       for r in timings["restores"]],
          "failed_run": failed_run, "restarts": len(restarts),
          "restored_state_bit_equal": {k: not v for k, v in mismatched.items()},
          "mismatched_leaves": mismatched,
          "losses": {"uninterrupted": want_losses, "failed_and_replayed": failed_run["losses"],
                     "rel": rel, "bit_equal": [a == b for a, b in
                                               zip(failed_run["losses"], want_losses)],
                     "resumed": resumed["losses"], "resumed_rel": resumed_rel,
                     "resumed_bit_equal": [a == b for a, b in
                                           zip(resumed["losses"], want_losses[2:])]},
          "resumed": resumed, "launches": per_call})
    if len(restarts) != 1 or len(failed_run["losses"]) != 3:
        raise AssertionError(f"resilient: events {failed_run['events']}, "
                             f"losses {failed_run['losses']}")
    if steps_on_disk != [RESUME_STEP] or manifest["step"] != RESUME_STEP:
        raise AssertionError(f"resilient: checkpoints on disk {steps_on_disk}")
    if not live or not live[0]["in_place"] or live[0]["step"] != RESUME_STEP or not meta:
        raise AssertionError(f"resilient: restores {timings['restores']}")
    if any(mismatched.values()):
        raise AssertionError(f"resilient: restored leaves differ from the state after step "
                             f"{RESUME_STEP}: {mismatched}")
    if max(rel) > 1e-5 or resumed["resumed_from"] != RESUME_STEP \
            or len(resumed["losses"]) != 1 or max(resumed_rel) > 1e-5 or resumed["events"]:
        raise AssertionError(f"resilient: losses {failed_run['losses']} / {resumed} against "
                             f"{want_losses}")
    if per_call != want_launches:
        raise AssertionError(f"resilient: kernel launches {per_call}, expected {want_launches}")
    if resumed_line_before is not None:
        raise AssertionError("resilient: the first call printed a resume line")
    return per_call


EXAMPLES_TIMEOUT_S = 600
# a shape the warm sweep plans for qwen2.5-3b (its down projection at 4,096
# tokens) and one of its flash cells
WARMED_GEMM, WARMED_FLASH = (4096, 2048, 11008), (4096, 4096, 128)


def start_examples() -> dict:
    """The examples phase's processes, started together (each its own, on
    the card but for the CPU-only sweep): ``examples/torch_serve_decode.py``
    as given, ``examples/torch_train_lm.py --steps 3 --save-every 2`` into a
    fresh checkpoint directory, and ``python -m repro_torch.plancache warm
    --fast --skip-mesh --archs qwen2.5-3b`` into a fresh plan store, all
    under ``build/``; when the sweep has ended, a fresh process with fast
    search on its store asks for a GEMM and a flash block plan at shapes
    the sweep planned and prints where each came from.
    :func:`finish_examples` waits for them."""
    import shlex
    work_dir = os.path.join(ROOT, "build", f"examples-{os.getpid()}")
    os.makedirs(work_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    store = os.path.join(work_dir, "plancache")
    probe = ("from repro_torch.core import lower_torch as LT\n"
             f"LT.plan_gemm_blocks(*{WARMED_GEMM}); LT.plan_flash_blocks(*{WARMED_FLASH})\n"
             "print(sorted((k[0], v[1]) for k, v in LT.resolved_blocks().items()))\n")
    warm = (shlex.join([sys.executable, "-m", "repro_torch.plancache", "warm", "--fast",
                        "--skip-mesh", "--archs", ARCH])
            + " && " + shlex.join([sys.executable, "-c", probe]))
    runs = {"serve_decode": ([sys.executable,
                              os.path.join(ROOT, "examples", "torch_serve_decode.py")], env),
            "train_lm": ([sys.executable, os.path.join(ROOT, "examples", "torch_train_lm.py"),
                          "--steps", "3", "--save-every", "2", "--ckpt-dir",
                          os.path.join(work_dir, "ckpt")], env),
            "warm": (["/bin/sh", "-c", warm],
                     dict(env, REPRO_PLAN_CACHE_DIR=store, REPRO_FAST_SEARCH="1"))}
    procs = {}
    for name, (args, run_env) in runs.items():
        log = open(os.path.join(work_dir, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(args, env=run_env, stdout=log,
                                        stderr=subprocess.STDOUT, cwd=ROOT,
                                        start_new_session=True), log)
    return {"dir": work_dir, "procs": procs, "t0": time.perf_counter()}


def stop_examples(started: dict) -> None:
    """Kill what is left of :func:`start_examples`' processes, each with the
    processes it started (its session)."""
    import signal
    for proc, _ in started["procs"].values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _launch_line(log: str, who: str) -> dict:
    """The counts an entry point prints on its ``[who] kernel launches:``
    line."""
    found = re.search(rf"\[{who}\] kernel launches: (.*)", log)
    return {} if not found else {k: int(v) for k, v in
                                 (kv.split("=") for kv in found.group(1).split())}


def finish_examples(started: dict) -> dict:
    """Wait for :func:`start_examples`' processes (killed at
    EXAMPLES_TIMEOUT_S); each must exit 0, the serve example with K2 and
    K3 launched, the training example with K2 and K2-bwd launched and its
    checkpoint of step 2 written, the warmed GEMM and flash requests
    resolved from the store, ``(cache)``."""
    out, bad = {}, []
    for name, (proc, log) in started["procs"].items():
        try:
            proc.wait(timeout=max(1.0, EXAMPLES_TIMEOUT_S
                                  - (time.perf_counter() - started["t0"])))
        except subprocess.TimeoutExpired:
            stop_examples(started)
        log.close()
        text = open(os.path.join(started["dir"], f"{name}.log")).read()
        out[name] = {"exit": proc.returncode, "tail": text.splitlines()[-4:]}
        if proc.returncode != 0:
            bad.append(f"{name} exited {proc.returncode}: {text[-2000:]}")
    out["serve_decode"]["launches"] = _launch_line(
        open(os.path.join(started["dir"], "serve_decode.log")).read(), "serve")
    out["train_lm"]["launches"] = _launch_line(
        open(os.path.join(started["dir"], "train_lm.log")).read(), "train")
    if not (out["serve_decode"]["launches"].get("flash_attention", 0) > 0
            and out["serve_decode"]["launches"].get("flash_decode", 0) > 0):
        bad.append(f"serve_decode launched {out['serve_decode']['launches']}")
    if not (out["train_lm"]["launches"].get("flash_attention", 0) > 0
            and out["train_lm"]["launches"].get("flash_attention_bwd", 0) > 0):
        bad.append(f"train_lm launched {out['train_lm']['launches']}")
    ckpt = os.path.join(started["dir"], "ckpt", f"{ARCH}-reduced", "step_00000002")
    if not os.path.isdir(ckpt):
        bad.append(f"no checkpoint at {ckpt}")
    out["warmed_request"] = out["warm"]["tail"][-1] if out["warm"]["tail"] else ""
    if out["warmed_request"] != str([("flash_blocks", "cache"), ("gemm_blocks", "cache")]):
        bad.append(f"a warmed request did not resolve from the store: "
                   f"{out['warmed_request']}")
    out["wall_s"] = time.perf_counter() - started["t0"]
    emit({"phase": "examples", **out,
          "check": "each exits 0; serve_decode launches K2 and K3, train_lm K2 and K2-bwd "
                   "and writes its step-2 checkpoint; after the warm sweep a fresh process "
                   "resolves a warmed GEMM and flash request (cache)"})
    if bad:
        raise AssertionError(f"examples: {bad}")
    return {"serve_decode": out["serve_decode"]["launches"],
            "train_lm": out["train_lm"]["launches"]}


TENANT_HOLD_S = 3.0


def phase_tenants() -> None:
    """``serve.main --tenants 2 --tenant-kill 0,0``: two kernel tenants
    planned onto disjoint partitions of a wormhole_8x8 fabric, a core of
    the first killed, the containment asserted; ``/tenants`` scraped during
    the hold.  Under ``REPRO_FAST_SEARCH=1`` and the 5 s plan deadline the
    reference's own smoke (``benchmarks/obs_serve_smoke.py``) runs this mode
    with.  No kernel is launched."""
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.obs import flightrec, slo
    out = WatchedStdout(sys.stdout, r"holding introspection open \S+ at (http://\S+)")
    scraped, failed = {}, []

    def scraper():
        out.seen.wait()
        if out.match is None:
            return
        try:
            scraped["/tenants"] = scrape(out.match.group(1), "/tenants")
        except Exception as err:  # noqa: BLE001 - reported below as a failure
            failed.append(repr(err))

    env = {"REPRO_FAST_SEARCH": "1", "REPRO_PLAN_DEADLINE_MS": "5000"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    thread = threading.Thread(target=scraper, name="tenants-scraper")
    thread.start()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            try:
                serve.main(["--tenants", "2", "--tenant-kill", "0,0", "--plan-budget-ms", "5000",
                            "--introspect-port", "0", "--introspect-hold", str(TENANT_HOLD_S)])
            except SystemExit as err:
                raise AssertionError(f"tenants: serve.main exited: {err}") from None
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        out.seen.set()
        thread.join()
        flightrec.disable()
        slo.disable()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    printed = "".join(out.lines)
    kill = re.search(r"core_kill \(0, 0\): owner=(\S+) rung=(\S+) blast_radius=(\d+) "
                     r"seconds=([0-9.]+)ms within_budget=(\w+)", printed)
    view = json.loads(scraped["/tenants"]["body"]) if "/tenants" in scraped else {}
    tenants = [{k: t[k] for k in ("tenant", "qos", "rect", "rung")}
               for t in view.get("tenants", [])]
    emit({"phase": "tenants", "flags": ["--tenants 2", "--tenant-kill 0,0",
                                        "--plan-budget-ms 5000", "--introspect-port 0",
                                        f"--introspect-hold {TENANT_HOLD_S}"],
          "env": env, "seconds": seconds, "containment_ok": "containment ok" in printed,
          "kill": (None if kill is None else
                   {"owner": kill.group(1), "rung": kill.group(2),
                    "blast_radius": int(kill.group(3)), "seconds": float(kill.group(4)) / 1e3,
                    "within_budget": kill.group(5) == "True"}),
          "scrape": {"hw": view.get("hw"), "tenants": tenants,
                     "incidents": view.get("incidents"), "failed": failed},
          "launches": {k: v for k, v in launches.items() if v}})
    if "containment ok" not in printed or kill is None:
        raise AssertionError("tenants: no containment line or no core_kill line")
    if failed or [(t["tenant"], t["qos"]) for t in tenants] \
            != [("tenant0", "guaranteed"), ("tenant1", "best_effort")] \
            or not all(re.fullmatch(r"\d+x\d+@\(\d+,\d+\)", t["rect"]) for t in tenants):
        raise AssertionError(f"tenants: /tenants {view}, failed {failed}")
    if any(launches.values()):
        raise AssertionError(f"tenants: the tenancy mode launched kernels: {launches}")


def replaying_router(recorded):
    """``moe._router`` with the experts another run chose (in call order);
    the gate weights and the load-balancing loss come from this run's own
    router probabilities, so the router keeps its gradient."""
    replay = iter(recorded)

    def router(xf, router_w, cfg):
        from repro_torch.models import layers as L
        idx = next(replay)
        # summed over the ranks' embed blocks where a tp2d step split them
        logits = L._proj_in("td,de->te", xf, router_w)
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
    return dict(launches, grouped_matmul_bwd=bwd["grouped_matmul_bwd"]), float(loss)


MESH_TRAIN_STEPS = 3


@contextlib.contextmanager
def world_1_nccl():
    """A world-1 NCCL process group (a ``file://`` store under ``build/``, no
    port), destroyed on the way out."""
    import datetime

    import torch.distributed as dist
    store = os.path.join(ROOT, "build", f"nccl-store-{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method="file://" + store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def mesh_steps(api, tcfg, plan, mesh, device, source, steps):
    """``steps`` steps of ``jit_train_step`` from the seed-0 state placed by
    the plan, on SyntheticLM batches 0 .. steps - 1: the history, the step
    times, the launches (counters reset just before the steps), K4's
    backward launches and the peak device memory."""
    from repro_torch import kernels
    from repro_torch.launch import train as TL
    from repro_torch.train import train_step as TS
    state = TS.init_state(api, tcfg, device=device,
                          shardings=TS.state_shardings(api, tcfg, plan, mesh))
    batches = [TL.to_device(source.batch_at(s, BATCH, PROMPT), device) for s in range(steps)]
    step = TS.jit_train_step(api, tcfg, plan, mesh, batches[0])
    history, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    with backward_launches() as bwd:
        for data in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, data)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in metrics.items()})
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    del state, step
    return history, step_s, dict(launches, grouped_matmul_bwd=bwd["grouped_matmul_bwd"]), peak


def phase_mesh_train(device, train_losses, moe_loss, moe_bwd_per_step):
    """Plan-sharded training through ``train_step.jit_train_step`` on a 1x1
    ``make_host_mesh`` over a world-1 NCCL process group (one card: NCCL
    refuses two ranks on one device).  qwen2.5-3b at full width and depth
    (the ``train`` phase's setup) three steps under megatron_tp, then three
    under zero3: each plan's losses equal to the ``train`` phase's within
    1e-6 relative, exact K2 / K2-bwd launch counts; step ms, tok/s, peak
    memory beside the mesh planner's ``hbm_per_chip`` for a one-card
    ``h100_cluster(1, 1)``, and the ranking line ``launch/train.py`` prints.
    Then qwen3-moe-30b-a3b at MOE_TRAIN_LAYERS layers under expert_parallel:
    the expert-parallel branch taken with the whole expert range (e_lo 0,
    n_local 128), the first loss equal to ``moe_train``'s within 1e-6
    relative, K4's backward launches per step equal to its."""
    from repro_torch import plancache
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core import lower_torch
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import common
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.parallel import planner_bridge as PB, sharding as SH
    steps = MESH_TRAIN_STEPS
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=steps, warmup_steps=max(1, steps // 20))
    cfg = common.launch_config(ARCH)
    api = build_model(cfg)
    L = cfg.n_layers
    shape = ShapeConfig("mesh_train", PROMPT, BATCH, "train")
    store = plancache.get_store()
    with plancache.lookup_source(store) as probe:
        ranking = PB.plan_mesh(api, shape, tcfg)
    ranking_line = (f"[train] {cfg.name}: {api.n_params():,} params; planner ranking "
                    f"({probe['source']}): "
                    + ", ".join(f"{r.plan.name}({r.cost.dominant})" for r in ranking[:3]))
    one_card = lower_torch.h100_cluster(1, 1)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    runs, total = {}, {}
    with world_1_nccl() as dist:
        mesh = make_host_mesh(1, 1)
        backend = dist.get_backend()
        for plan in (SH.megatron_tp_plan(), PB._zero3()):
            history, step_s, launches, peak = mesh_steps(api, tcfg, plan, mesh, device,
                                                         source, steps)
            est = PB.estimate_plan(api, shape, plan, tcfg, hw=one_card)
            losses = [h["loss"] for h in history]
            runs[plan.name] = {
                "history": history, "step_ms": [t * 1e3 for t in step_s],
                "tok_per_s": [BATCH * PROMPT / t for t in step_s], "peak_bytes": peak,
                "planner_hbm_per_chip": est.hbm_bytes_per_chip,
                "planner_feasible": est.feasible, "planner_total_s": est.total_s,
                "launches": launches,
                "loss_rel_diff_vs_train": [abs(a - b) / abs(b)
                                           for a, b in zip(losses, train_losses)]}
            want = {"flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps,
                    "grouped_matmul": 0, "grouped_matmul_bwd": 0}
            if any(launches[k] != n for k, n in want.items()):
                raise AssertionError(f"mesh_train {plan.name}: launches {launches}, "
                                     f"expected {want}")
            if max(runs[plan.name]["loss_rel_diff_vs_train"]) > 1e-6 or not all(
                    math.isfinite(h["grad_norm"]) for h in history):
                raise AssertionError(f"mesh_train {plan.name}: losses {losses}, the train "
                                     f"phase's {train_losses}")
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
        del api
        moe_cfg = replace(common.launch_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
        moe_api = build_model(moe_cfg)
        moe.EP_TRACE = []
        try:
            history, step_s, launches, peak = mesh_steps(
                moe_api, tcfg, SH.expert_parallel_plan(), mesh, device,
                make_source(DataConfig(vocab_size=moe_cfg.vocab_size), moe_cfg), steps)
            trace = moe.EP_TRACE
        finally:
            moe.EP_TRACE = None
        ml = moe_cfg.n_layers
        runs["expert_parallel"] = {
            "arch": moe_cfg.name, "n_layers": ml, "history": history,
            "step_ms": [t * 1e3 for t in step_s],
            "tok_per_s": [BATCH * PROMPT / t for t in step_s], "peak_bytes": peak,
            "launches": launches, "ep_dispatches": len(trace),
            "ep_slices": sorted(set(trace)),
            "first_loss_rel_diff_vs_moe_train": abs(history[0]["loss"] - moe_loss) / abs(moe_loss)}
        want = {"flash_attention": 2 * ml * steps, "flash_attention_bwd": ml * steps,
                "grouped_matmul": 12 * ml * steps,
                "grouped_matmul_bwd": moe_bwd_per_step * steps}
        if any(launches[k] != n for k, n in want.items()) \
                or set(trace) != {(0, moe_cfg.n_experts)} or len(trace) != 2 * ml * steps:
            raise AssertionError(f"mesh_train expert_parallel: launches {launches} (expected "
                                 f"{want}), expert-parallel dispatches {sorted(set(trace))} x "
                                 f"{len(trace)}")
        if runs["expert_parallel"]["first_loss_rel_diff_vs_moe_train"] > 1e-6:
            raise AssertionError(f"mesh_train expert_parallel: first loss "
                                 f"{history[0]['loss']}, moe_train's {moe_loss}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        del moe_api
    emit({"phase": "mesh_train", "backend": backend,
          "mesh": {"axes": list(mesh.axis_names), "sizes": list(mesh.sizes),
                   "device_mesh": str(mesh.device_mesh)},
          "arch": cfg.name, "n_layers": L, "batch": BATCH, "seq": PROMPT, "steps": steps,
          "train_losses": train_losses, "moe_train_loss": moe_loss,
          "ranking_line": ranking_line, "runs": runs, "card": smi_line()})
    return total


def start_ranks(flag: str, name: str, job: dict, world: int = 2) -> dict:
    """Start ``chip_smoke.py FLAG JOB R`` for each R of ``world`` ``gloo``
    ranks on the one card (NCCL refuses two ranks on one device), with
    ``job`` and a ``file://`` store under ``build/``; each writes
    ``JOB.rank<R>.json`` and its output to ``JOB.rank<R>.log``.  Returns
    what :func:`finish_ranks` waits on: the caller may work meanwhile."""
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    job_path = os.path.join(build, f"{name}-{os.getpid()}.json")
    store = os.path.join(build, f"{name}-store-{os.getpid()}")
    for f in [store] + [f"{job_path}.rank{r}.json" for r in range(world)]:
        if os.path.exists(f):
            os.remove(f)
    with open(job_path, "w") as f:
        json.dump(dict(job, store=store), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    logs = [open(f"{job_path}.rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, job_path,
                               str(r)], env=env, stdout=logs[r], stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    return {"name": name, "job_path": job_path, "procs": procs, "logs": logs,
            "t0": time.perf_counter()}


def finish_ranks(started: dict, timeout: int, meanwhile=None) -> tuple:
    """Run ``meanwhile`` (a callable, if given) here while the ranks
    :func:`start_ranks` started run, then wait for them (killing them after
    ``timeout`` seconds from their start, or at once if ``meanwhile``
    raises).  Returns the results with the wall seconds; raises with a
    rank's error and output tail when one failed."""
    procs, job_path = started["procs"], started["job_path"]
    try:
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - started["t0"])))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in started["logs"]:
            f.close()
    wall_s = time.perf_counter() - started["t0"]
    results, failed = [], []
    for r, p in enumerate(procs):
        path = f"{job_path}.rank{r}.json"
        res = json.load(open(path)) if os.path.exists(path) else {"ok": False}
        if p.returncode != 0 or not res.get("ok"):
            log = open(f"{job_path}.rank{r}.log").read()
            failed.append(f"rank {r} (exit {p.returncode}): {res.get('error', '')}\n"
                          f"{log[-2000:]}")
        results.append(res)
    if failed:
        raise AssertionError(f"{started['name']} failed on " + "\n".join(failed))
    return results, wall_s


def beside(main_fn, side_fn) -> tuple:
    """Run ``side_fn`` on a thread while ``main_fn`` runs here; both
    results, once both have ended (the side's error raised then)."""
    box = {}

    def run():
        try:
            box["out"] = side_fn()
        except BaseException as err:  # noqa: BLE001 - raised below
            box["err"] = err
    thread = threading.Thread(target=run)
    thread.start()
    try:
        result = main_fn()
    finally:
        thread.join()
    if "err" in box:
        raise box["err"]
    return result, box["out"]


def run_ranks(flag: str, name: str, job: dict, timeout: int, world: int = 2) -> tuple:
    """:func:`start_ranks`, then :func:`finish_ranks`."""
    return finish_ranks(start_ranks(flag, name, job, world), timeout)


MESH_SERVE_BUFFER, MESH_SERVE_EMPTY_BUFFER = 1024, 2048
MESH_SERVE_TIMEOUT_S = 600


def mesh_serve_rank(job_path: str, rank: int) -> None:
    """One rank of ``mesh_serve`` (``chip_smoke.py --mesh-serve-rank JOB R``):
    a ``gloo`` rank on card 0 of a 1x2 mesh, qwen2.5-3b at full size.  The
    unsharded prefill and loop first (the oracle, its logits and the rank's
    block of its cache kept), then the counts set to 0 and the plan-sharded
    steps through ``jit_serve_step`` under kv_sequence_split: in each buffer
    the prompt pass into an empty cache split over ``kv_seq`` (each rank
    writes the positions of its block), then the decode steps,
    teacher-forced on the serve phase's ids:
    32 steps in a buffer of MESH_SERVE_BUFFER keys and one in a buffer of
    MESH_SERVE_EMPTY_BUFFER, where rank 1 holds no valid key.  The first
    sharded decode step holds every partials call (through the exact float32
    combine) and every combine against their plain versions.  Writes its
    results to ``JOB.rank<R>.json``."""
    import datetime

    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.kernels import flash_decode as FD, ops
    from repro_torch.launch import common, serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import planner_bridge as PB
    from repro_torch.train import serve_step as SS, train_step as TS
    job = json.load(open(job_path))
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(1, 2)
        device = torch.device("cuda", 0)
        cfg = common.launch_config(ARCH)
        api = build_model(cfg)
        plan = PB.candidate_plans(cfg, mesh_serve_shape(MESH_SERVE_BUFFER))[0]
        if plan.name != "kv_sequence_split":
            raise AssertionError(f"the first decode candidate is {plan.name}")
        params = serve.load_params(api, device, seed=0)
        prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)
        ids = torch.load(job["ids"]).to(device)
        p_local = TS.place_tree(params, SS.param_shardings(api, plan, mesh),
                                api.abstract_params())
        runs = []
        for buffer, steps in ((MESH_SERVE_BUFFER, ids.shape[1]), (MESH_SERVE_EMPTY_BUFFER, 1)):
            cache = api.init_cache(cfg, BATCH, buffer, device=device)
            with torch.no_grad():
                first, cache = api.prefill(params, prompts, cache)
            c_sh = SS.cache_shardings(api, cache, plan, mesh)
            prefilled = {k: c_sh[k].local(v).clone() for k, v in cache.items() if k != "index"}
            empty = {k: (0 if k == "index" else
                         torch.zeros(c_sh[k].local_shape(v.shape), dtype=v.dtype, device=device))
                     for k, v in cache.items()}
            shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                      for k, v in cache.items() if k != "index"}
            offset = c_sh["k"].index(cache["k"].shape)[2].start
            want = []
            with torch.no_grad():
                for t in range(steps):
                    logits, cache = api.decode_step(params, ids[:, t:t + 1], cache)
                    want.append(logits.float().cpu())
            del cache
            step = SS.jit_serve_step(api, plan, mesh, shapes, tokens_shape=(BATCH, 1))
            runs.append((buffer, steps, empty, prefilled, first.float().cpu(), want, offset,
                         step))
        per_call = {"partials": [], "combine": []}
        partials, combine = ops.flash_decode_partials, FD.combine_partials

        def checked_partials(q, k, v, **kw):
            m, l, acc = partials(q, k, v, **kw)
            pm, pl, pacc = FD.flash_decode_partials_plain(
                q, k, v, kv_splits=m.shape[1], sm_scale=kw.get("sm_scale"),
                kv_valid_len=kw.get("kv_valid_len"), q_per_kv=kw.get("q_per_kv", 1))
            got = FD.combine_partials_plain(m, l, acc)
            w = FD.combine_partials_plain(pm, pl, pacc)
            per_call["partials"].append(_per_call_row(got, w))
            return m, l, acc

        def checked_combine(m, l, acc, out_dtype=torch.float32):
            got = combine(m, l, acc, out_dtype=out_dtype)
            w = FD.combine_partials_plain(m, l, acc, out_dtype=torch.float32)
            per_call["combine"].append(_per_call_row(got, w))
            return got

        rows, prefills, step_s = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        for buffer, steps, local, prefilled, first, want, off, step in runs:
            # the prompt pass into this rank's block of an empty split cache
            t0 = time.perf_counter()
            logits, local = step(p_local, prompts, local)
            torch.cuda.synchronize()
            prefills.append({
                "buffer": buffer, "ms": (time.perf_counter() - t0) * 1e3,
                "index": local["index"],
                "max_abs_err": (logits.float().cpu() - first).abs().max().item(),
                "finite": bool(torch.isfinite(logits).all()),
                "cache_block_max_abs_err": max((local[k].float() - prefilled[k].float())
                                               .abs().max().item() for k in prefilled),
                "cache_block_bit_equal": all(torch.equal(local[k], prefilled[k])
                                             for k in prefilled)})
            for t in range(steps):
                first = not rows
                ctx = contextlib.ExitStack()
                if first:
                    ctx.enter_context(patched(ops, "flash_decode_partials", checked_partials))
                    ctx.enter_context(patched(FD, "combine_partials", checked_combine))
                t0 = time.perf_counter()
                with ctx:
                    logits, local = step(p_local, ids[:, t:t + 1], local)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                logit_err = (logits.float().cpu() - want[t]).abs().max().item()
                valid = min(max(PROMPT + t + 1 - off, 0), local["k"].shape[2])
                rows.append({"buffer": buffer, "step": t, "max_abs_err": logit_err,
                             "finite": bool(torch.isfinite(logits).all()),
                             "local_valid_keys": valid})
        out.update(
            ok=True, plan=plan.name, rows=rows, prefills=prefills,
            launches=kernels.launch_counts(),
            step_ms=[x * 1e3 for x in step_s],
            peak_bytes=torch.cuda.max_memory_allocated(device),
            per_call={k: {"calls": len(v), "max_abs_err": max(r[0] for r in v),
                          "max_rel_rms": max(r[1] for r in v),
                          "within": all(r[2] and r[1] <= ATTN_REL_RMS for r in v)}
                      for k, v in per_call.items()},
            coords=mesh.coords(), backend=dist.get_backend())
    except Exception as err:  # noqa: BLE001 - reported to the parent, which fails
        import traceback
        out.update(ok=False, error=traceback.format_exc()[-3000:])
    finally:
        with open(f"{job_path}.rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


MESH_CHUNK_TIMEOUT_S = 420


def mesh_chunk_rank(job_path: str, rank: int) -> None:
    """One rank of ``mesh_chunked`` (``chip_smoke.py --mesh-chunk-rank JOB
    R``): a ``gloo`` rank on card 0 of a 1x2 mesh, qwen2.5-3b at full size
    under kv_sequence_split (``mesh_serve``'s plan).  Rank 0 makes the
    unsharded runs and hands rank 1 its part (:func:`mesh_chunk_oracle`),
    then both run the chunked prompt (:func:`mesh_chunked_run`).  Writes
    its results to ``JOB.rank<R>.json``, with the rank's peak memory
    before the chunks and from them on."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch import common, serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import planner_bridge as PB
    from repro_torch.train import serve_step as SS, train_step as TS
    job = json.load(open(job_path))
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(1, 2)
        device = torch.device("cuda", 0)
        cfg = common.launch_config(ARCH)
        api = build_model(cfg)
        plan = PB.candidate_plans(cfg, mesh_serve_shape(MESH_SERVE_BUFFER))[0]
        if plan.name != "kv_sequence_split":
            raise AssertionError(f"the first decode candidate is {plan.name}")
        params = serve.load_params(api, device, seed=0)
        prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)
        ids = torch.load(job["ids"]).to(device)
        oracle_path = f"{job_path}.oracle.pt"
        # rank 0 makes the unsharded runs before it takes its shards, rank 1
        # drops the whole weights before it waits for them: the ranks run
        # beside the tp2d dry-run cell's 50 GB
        if rank == 0:
            oracle = mesh_chunk_oracle(api, params, plan, mesh, prompts, ids, device,
                                       oracle_path)
        p_local = TS.place_tree(params, SS.param_shardings(api, plan, mesh),
                                api.abstract_params())
        del params
        torch.cuda.empty_cache()
        if rank != 0:
            oracle = mesh_chunk_oracle(api, None, plan, mesh, prompts, ids, device,
                                       oracle_path)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out.update(ok=True, plan=plan.name,
                   **mesh_chunked_run(api, plan, mesh, p_local, prompts, ids, oracle),
                   peak_bytes=torch.cuda.max_memory_allocated(device),
                   setup_peak_bytes=setup_peak,
                   coords=mesh.coords(), backend=dist.get_backend())
    except Exception as err:  # noqa: BLE001 - reported to the parent, which fails
        import traceback
        out.update(ok=False, error=traceback.format_exc()[-3000:])
    finally:
        with open(f"{job_path}.rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def mesh_chunk_loop(api, params, prompts, forced, c_shs) -> tuple:
    """The unsharded chunk loop ``mesh_chunked`` is held against: the prompt
    in chunks of MESH_CHUNKS into a cache of MESH_CHUNK_BUFFER, then a
    decode step for each of the ``forced`` ids, the calls
    ``serve.generate(..., prefill_chunks=MESH_CHUNKS, forced_ids=forced)``
    makes.  After each chunk and step the last token's logits (float32) and
    each rank's block (``c_shs``: the cache's shardings, one a rank) of the
    cache's K and V, on the host; the cache in float32 for a float32 model,
    else bf16."""
    cfg = api.cfg
    dtype = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16
    cache = api.init_cache(cfg, BATCH, MESH_CHUNK_BUFFER, dtype=dtype, device=prompts.device)
    logits_out, blocks, at = [], [], 0
    with torch.no_grad():
        for i in range(len(MESH_CHUNKS) + forced.shape[1]):
            if i < len(MESH_CHUNKS):
                logits, cache = api.prefill(params, prompts[:, at:at + MESH_CHUNKS[i]], cache)
                at += MESH_CHUNKS[i]
            else:
                t = i - len(MESH_CHUNKS)
                logits, cache = api.decode_step(params, forced[:, t:t + 1], cache)
            logits_out.append(logits[:, -1, :cfg.vocab_size].float().cpu())
            blocks.append([{k: c_sh[k].local(cache[k]).cpu() for k in ("k", "v")}
                           for c_sh in c_shs])
    return logits_out, blocks


def mesh_chunk_oracle(api, params, plan, mesh, prompts, ids, device, path: str) -> dict:
    """The unsharded runs ``mesh_chunked`` holds the sharded chunks against,
    made once, on rank 0 (``params``: the whole weights there, None on
    rank 1): :func:`mesh_chunk_loop` on the first MESH_CHUNK_STEPS ids
    through the kernels, and through the plain path in bf16 and in float32
    (the yardsticks of the float32 rule, :func:`within`).  Rank 0 writes
    rank 1's logits and blocks to ``path``; rank 1 reads them after a
    barrier.  They stay on the host.  Also the empty local cache, the
    cache's shapes the sharded step takes and the block's offset."""
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import serve_step as SS
    cfg = api.cfg
    full = api.init_cache(cfg, BATCH, MESH_CHUNK_BUFFER, device="meta")
    c_sh = SS.cache_shardings(api, full, plan, mesh)
    if mesh.rank == 0:
        c_shs = [SS.cache_shardings(api, full, plan, SH.Mesh(("data", "model"), (1, 2), rank=r))
                 for r in range(2)]
        forced = ids[:, :MESH_CHUNK_STEPS]
        runs = {name: mesh_chunk_loop(run_api, params, prompts, forced, c_shs)
                for name, run_api in (
                    ("kernels", api), ("plain", build_model(replace(cfg, kernels="plain"))),
                    ("float32", build_model(replace(cfg, kernels="plain",
                                                    compute_dtype="float32"))))}
        part = {r: {name: (logits, [b[r] for b in blocks])
                    for name, (logits, blocks) in runs.items()} for r in range(2)}
        torch.save(part[1], path)
        mine = part[0]
        dist.barrier()
    else:
        dist.barrier()
        mine = torch.load(path, map_location="cpu")
        os.remove(path)
    empty = {k: (0 if k == "index" else
                 torch.zeros(c_sh[k].local_shape(v.shape), dtype=v.dtype, device=device))
             for k, v in full.items()}
    return {"logits": mine["kernels"][0], "blocks": mine["kernels"][1],
            "runs": {k: mine[k] for k in ("plain", "float32")}, "empty": empty,
            "shapes": {k: v for k, v in full.items() if k != "index"},
            "offset": c_sh["k"].index(full["k"].shape)[2].start}


def _dist(got: list, want: list) -> tuple:
    """Largest and root-mean-square difference over the tensors of two
    lists, in float32."""
    diff = torch.cat([(a.float() - b.float()).flatten().cpu() for a, b in zip(got, want)])
    return diff.abs().max().item(), diff.square().mean().sqrt().item()


def float32_row(got_logits, got_block: dict, oracle: dict, i: int) -> dict:
    """The float32 rule (:func:`within`) for the logits and this rank's
    cache block after the ``i``-th chunk or step: their distance from the
    unsharded float32 run at most 1.25 x the unsharded plain bf16 path's,
    and, where the block holds a written key, a control (the block rounded
    to 5 mantissa bits) against it."""
    (f_logits, f_blocks), (p_logits, p_blocks) = (oracle["runs"][k] for k in ("float32",
                                                                            "plain"))
    names = sorted(got_block)
    block = lambda b: [b[k] for k in names]
    out = {}
    for what, got, plain, exact in (
            ("logits", [got_logits], [p_logits[i]], [f_logits[i]]),
            ("cache", block(got_block), block(p_blocks[i]), block(f_blocks[i]))):
        kern, base = _dist(got, exact), _dist(plain, exact)
        out[what] = {"vs_float32": kern, "plain_vs_float32": base,
                     "within": within(kern, base)}
    # the control where the block holds a written key (rank 1's is empty
    # before the prompt reaches it)
    if any(bool(t.any()) for t in block(got_block)):
        ctl = _dist([coarse(t, 5) for t in block(got_block)], block(f_blocks[i]))
        out["cache"]["control_5_bits_vs_float32"] = ctl
        out["cache"]["control_5_bits_rejected"] = not within(
            ctl, out["cache"]["plain_vs_float32"])
    return out


def mesh_chunked_run(api, plan, mesh, p_local, prompts, ids, oracle) -> dict:
    """The 512-token prompt in chunks of MESH_CHUNKS through
    ``jit_serve_step`` into this rank's block of an empty cache of
    MESH_CHUNK_BUFFER split over kv_seq (blocks [0, 320) and [320, 640)),
    then MESH_CHUNK_STEPS decode steps, with the counts set to 0 just before
    and read just after.  While the chunks run, every K2 call that returns
    its log-sum-exp and every K3' fold of chunk rows is held against its
    plain version on the same inputs (:func:`bwd_per_call`: within 2e-2 of
    the output's largest entry and ATTN_REL_RMS, a 5-bit control of the
    kernel's output), so a chunk's time includes those plain calls.  Each
    chunk and step: its time, the last token's logits and this rank's cache
    block against the unsharded kernel run's, and both under the float32
    rule (:func:`float32_row`)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, flash_decode as FD, ops
    from repro_torch.train import serve_step as SS
    cfg = api.cfg
    step = SS.jit_serve_step(api, plan, mesh, oracle["shapes"], tokens_shape=(BATCH, 1))
    forced = ids[:, :MESH_CHUNK_STEPS]
    k2_stats, fold_stats = [], []
    attention = ops.attention
    k2_check = bwd_per_call(k2_stats, attention, FA.flash_attention_plain, of_largest=True)
    fold_check = one_output_per_call(fold_stats, FD.combine_partials,
                                     FD.combine_partials_plain)

    def checked_attention(q, k, v, **kw):
        return k2_check(q, k, v, **kw) if kw.get("return_lse") else attention(q, k, v, **kw)

    calls, at = [], 0
    for n in MESH_CHUNKS:
        calls.append((n, prompts[:, at:at + n]))
        at += n
    calls += [(1, forced[:, t:t + 1]) for t in range(MESH_CHUNK_STEPS)]
    local = {k: (v if k == "index" else torch.zeros_like(v)) for k, v in oracle["empty"].items()}
    rows = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i, (n, tokens) in enumerate(calls):
        ctx = contextlib.ExitStack()
        if i < len(MESH_CHUNKS):
            ctx.enter_context(patched(ops, "attention", checked_attention))
            ctx.enter_context(patched(FD, "combine_partials", fold_check))
        t0 = time.perf_counter()
        with ctx:
            logits, local = step(p_local, tokens, local)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = logits[:, -1, :cfg.vocab_size].float().cpu()
        block = oracle["blocks"][i]
        mine = {k: local[k].cpu() for k in block}
        rows.append({
            "tokens": n, "index": local["index"], "ms": ms,
            "max_abs_err": (got - oracle["logits"][i]).abs().max().item(),
            "within": bool(torch.allclose(got, oracle["logits"][i], rtol=2e-2, atol=2e-2)),
            "finite": bool(torch.isfinite(got).all()),
            "cache_block_max_abs_err": max((mine[k].float() - block[k].float()).abs().max()
                                           .item() for k in block),
            "cache_block_bit_equal": all(torch.equal(mine[k], block[k]) for k in block),
            "float32_rule": float32_row(got, mine, oracle, i)})
    return {"rows": rows, "launches": kernels.launch_counts(), "offset": oracle["offset"],
            "prefill_ms": sum(r["ms"] for r in rows[:len(MESH_CHUNKS)]),
            "per_call": {"flash_attention_lse": summarize_per_call(k2_stats),
                         "flash_decode_combine": summarize_per_call(fold_stats)}}


def mesh_serve_shape(buffer: int):
    """The decode cell of the mesh_serve phase (batch 4, a cache of
    ``buffer``), whose first candidate plan the phase runs."""
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("mesh_serve", buffer, BATCH, "decode")


def _per_call_row(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max abs error, relative RMS, within 2e-2) of one call's output
    against its plain version's (a zero-key call's combined output is 0)."""
    diff = got.float() - want.float()
    rel = (diff.norm() / want.float().norm().clamp(min=1e-30)).item() \
        if want.float().norm() > 0 else diff.norm().item()
    return (diff.abs().max().item(), rel,
            bool(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)))


def check_mesh_chunked(rank: int, res: dict, L: int) -> dict:
    """The parent's checks of one rank's :func:`mesh_chunked_run`: exact
    launches (K2 once a layer a chunk, with its log-sum-exp for the two
    chunks at index > 0; K3' once a layer for each of those and each decode
    step; K3's partials once a layer a step; the one-launch K3 never);
    after every chunk and step the logits within 2e-2 (absolute and
    relative, as ``chunked_prefill`` holds a chunked run) of the unsharded
    kernel run's, and the logits and the rank's cache block under the
    float32 rule, a 5-bit control of the block rejected by it (a K2 output
    rounded to bf16 before the fold moves a later layer's keys by a few
    bf16 steps, some elements by more than 2e-2); both per-call checks
    within with their 5-bit controls rejected."""
    later, steps = len(MESH_CHUNKS) - 1, MESH_CHUNK_STEPS
    want = {"flash_attention": len(MESH_CHUNKS) * L, "flash_decode_partials": steps * L,
            "flash_decode_combine": (later + steps) * L, "flash_decode": 0}
    bad = []
    if any(res["launches"][k] != n for k, n in want.items()):
        bad.append(f"launches {res['launches']}, expected {want}")
    for row in res["rows"]:
        rule = row["float32_rule"]
        if not (row["within"] and row["finite"] and rule["logits"]["within"]
                and rule["cache"]["within"]
                and rule["cache"].get("control_5_bits_rejected", True)):
            bad.append(f"disagrees with the unsharded chunked run: {row}")
    if [r["index"] for r in res["rows"]] != [sum(MESH_CHUNKS[:i + 1]) for i in
                                             range(len(MESH_CHUNKS))] + [
            PROMPT + t + 1 for t in range(steps)]:
        bad.append(f"cache indices {[r['index'] for r in res['rows']]}")
    for name, pc in res["per_call"].items():
        if not (pc["calls"] == later * L and pc["within"] and pc["control_5_bits_rejected"]):
            bad.append(f"{name} per call {pc}")
    if not res["rows"][-1]["float32_rule"]["cache"].get("control_5_bits_rejected"):
        bad.append("the 5-bit control of the last cache block was not rejected")
    if bad:
        raise AssertionError(f"mesh_chunked rank {rank}: the chunked prompt into the "
                             f"kv_seq split cache: {bad}")
    return {"launches": {k: res["launches"][k] for k in want},
            "k2_with_lse_calls": res["per_call"]["flash_attention_lse"]["calls"],
            "k3_combine_chunk_row_calls": res["per_call"]["flash_decode_combine"]["calls"],
            **{k: res[k] for k in ("offset", "prefill_ms", "rows", "per_call")}}


def phase_mesh_chunked(served: dict, meanwhile) -> tuple:
    """The chunked prompt into a cache split over kv_seq on two ``gloo``
    ranks of the one card (:func:`mesh_chunk_rank`): qwen2.5-3b at full
    width and depth under kv_sequence_split, the 512-token prompt in chunks
    of 256, 128 and 128 into a cache of MESH_CHUNK_BUFFER (the first chunk
    wholly in rank 0's block, the second straddling position 320, the third
    seeing all of rank 0's block), then MESH_CHUNK_STEPS decode steps
    teacher-forced on the serve phase's ids; the parent's checks are
    :func:`check_mesh_chunked`.  ``meanwhile`` (a callable) runs here while
    the ranks run.  Returns rank 0's launches and what ``meanwhile``
    returned."""
    from repro_torch.launch import common
    cfg = common.launch_config(ARCH)
    ids_path = os.path.join(ROOT, "build", f"mesh-chunk-{os.getpid()}.ids.pt")
    os.makedirs(os.path.dirname(ids_path), exist_ok=True)
    torch.save(served["ids"][:, :MESH_CHUNK_STEPS].cpu(), ids_path)
    got = {}
    results, wall_s = finish_ranks(
        start_ranks("--mesh-chunk-rank", "mesh-chunk", {"ids": ids_path}),
        MESH_CHUNK_TIMEOUT_S, lambda: got.update(meanwhile=meanwhile()))
    summary = [{"rank": res["rank"], "coords": res["coords"], "backend": res["backend"],
                "plan": res["plan"], "peak_bytes": res["peak_bytes"],
                "setup_peak_bytes": res["setup_peak_bytes"],
                **check_mesh_chunked(res["rank"], res, cfg.n_layers)} for res in results]
    emit({"phase": "mesh_chunked", "arch": cfg.name, "n_layers": cfg.n_layers,
          "batch": BATCH, "prompt_len": PROMPT, "chunks": list(MESH_CHUNKS),
          "buffer": MESH_CHUNK_BUFFER, "decode_steps": MESH_CHUNK_STEPS, "mesh": [1, 2],
          "ranks": summary, "wall_s": wall_s, "overlapped_with": "dryrun (the tp2d cell)",
          "check": "exact launches; logits and the rank's cache block within 2e-2 of the "
                   "unsharded chunked run's after every chunk and step, and under the "
                   "float32 rule with a 5-bit control of the block rejected; every K2 call "
                   "with its log-sum-exp and every K3' fold of chunk rows within 2e-2 of "
                   f"the largest entry and {ATTN_REL_RMS} relative rms of its plain "
                   "version, 5-bit controls rejected",
          "card": smi_line()})
    return results[0]["launches"], got["meanwhile"]


def phase_mesh_serve(device, served: dict, meanwhile=None) -> dict:
    """The plan-sharded serve step on two ``gloo`` ranks of the one card (a
    1x2 mesh; NCCL refuses two ranks on one device): qwen2.5-3b at full
    width and depth under kv_sequence_split (the
    planner's first decode candidate), each rank a process of its own
    (:func:`mesh_serve_rank`).  Each buffer's prompt pass runs through the
    step into the rank's block of an empty cache: its last-token logits
    within 2e-2 of the unsharded prefill's, the rank's cache block equal to
    its block of the unsharded prefill's cache (within 2e-2; bit-equality
    reported), K2 once a layer.  Every decode step's logits within 2e-2 of
    the unsharded step's on the same ids; on each rank K3's partials kernel
    and K3' launched 36 x 33 = 1,188 times and the one-launch K3 never; the
    zero-valid-key step passes; the first decode step's per-call checks
    pass.  Reports prefill ms, decode ms per token, peak memory per rank and
    the ranking line.  ``meanwhile`` (a callable) runs here while the ranks
    run: they wait on ``gloo`` more than on the card."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import lower_torch
    from repro_torch.launch import common
    from repro_torch.models import build_model
    from repro_torch.parallel import planner_bridge as PB
    cfg = common.launch_config(ARCH)
    api = build_model(cfg)
    L = cfg.n_layers
    shape = mesh_serve_shape(MESH_SERVE_BUFFER)
    ranking = PB.plan_mesh(api, shape, TrainConfig(), hw=lower_torch.h100_cluster(1, 2),
                           cache=False)
    ranking_line = (f"[serve] {cfg.name}: planner ranking on h100_cluster(1, 2): "
                    + ", ".join(f"{r.plan.name}({r.cost.dominant})" for r in ranking[:3]))
    ids_path = os.path.join(ROOT, "build", f"mesh-serve-{os.getpid()}.ids.pt")
    os.makedirs(os.path.dirname(ids_path), exist_ok=True)
    torch.save(served["ids"].cpu(), ids_path)
    results, wall_s = finish_ranks(
        start_ranks("--mesh-serve-rank", "mesh-serve", {"ids": ids_path}),
        MESH_SERVE_TIMEOUT_S, meanwhile)
    steps = served["ids"].shape[1] + 1
    summary = []
    for res in results:
        errs = [row["max_abs_err"] for row in res["rows"]]
        zero = [row for row in res["rows"] if row["local_valid_keys"] == 0]
        dec = res["step_ms"][1:served["ids"].shape[1]]
        summary.append({
            "rank": res["rank"], "coords": res["coords"], "backend": res["backend"],
            "plan": res["plan"], "steps": len(res["rows"]),
            "max_logit_err_vs_unsharded": max(errs),
            "zero_valid_key_steps": len(zero),
            "zero_valid_key_step_err": [row["max_abs_err"] for row in zero],
            "local_valid_keys": [row["local_valid_keys"] for row in res["rows"]],
            "decode_ms_per_token": statistics.median(dec),
            "decode_ms_per_token_mean": sum(dec) / len(dec),
            "peak_bytes": res["peak_bytes"], "launches": res["launches"],
            "prefills": res["prefills"], "per_call": res["per_call"]})
        want = {"flash_decode_partials": L * steps, "flash_decode_combine": L * steps,
                "flash_decode": 0, "flash_attention": 2 * L}
        for pre in res["prefills"]:
            if not (pre["max_abs_err"] <= TOL[torch.bfloat16] and pre["finite"]
                    and pre["cache_block_max_abs_err"] <= TOL[torch.bfloat16]
                    and pre["index"] == PROMPT):
                raise AssertionError(f"mesh_serve rank {res['rank']}: the prompt pass into "
                                     f"the split cache disagrees with the unsharded "
                                     f"prefill: {pre}")
        if any(res["launches"][k] != n for k, n in want.items()):
            raise AssertionError(f"mesh_serve rank {res['rank']}: launches {res['launches']}, "
                                 f"expected {want}")
        if max(errs) > TOL[torch.bfloat16] or not all(r["finite"] for r in res["rows"]):
            raise AssertionError(f"mesh_serve rank {res['rank']}: logits {max(errs)} from the "
                                 f"unsharded step's (tolerance {TOL[torch.bfloat16]})")
        pc = res["per_call"]
        if not (pc["partials"]["within"] and pc["combine"]["within"]
                and pc["partials"]["calls"] == L and pc["combine"]["calls"] == L):
            raise AssertionError(f"mesh_serve rank {res['rank']}: per-call check {pc}")
    if not any(s["zero_valid_key_steps"] for s in summary):
        raise AssertionError("mesh_serve: no step ran with a rank holding zero valid keys")
    emit({"phase": "mesh_serve", "arch": cfg.name, "n_layers": L, "batch": BATCH,
          "prompt_len": PROMPT, "buffers": [MESH_SERVE_BUFFER, MESH_SERVE_EMPTY_BUFFER],
          "mesh": [1, 2], "ranks": summary, "wall_s": wall_s,
          "overlapped_with": getattr(meanwhile, "phases", None),
          "serve_decode_ms_per_token": served["decode_ms_per_token"],
          "ranking_line": ranking_line,
          "check": "prefill through the step: logits and the rank's cache block within "
                   "2e-2 of the unsharded prefill's; logits within 2e-2 of the unsharded "
                   "step; per call: partials through the exact float32 combine and the "
                   f"combine within 2e-2 and {ATTN_REL_RMS} relative rms of their plain "
                   "versions",
          "card": smi_line()})
    return results[0]["launches"]

# the seq_parallel phase: qwen2.5-3b's prompt at full depth under
# sequence_parallel, and its training at SEQ_TRAIN_LAYERS layers under tp2d
SEQ_TRAIN_LAYERS, SEQ_TRAIN_STEPS = 4, 2
SEQ_PARALLEL_TIMEOUT_S = 600


def seq_train_setup(device):
    """qwen2.5-3b at full width and SEQ_TRAIN_LAYERS layers (kernel path,
    bf16 compute, remat), its seed-0 train state, AdamW and the batches."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import common, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import train_step as TS
    cfg = replace(common.launch_config(ARCH), n_layers=SEQ_TRAIN_LAYERS)
    api = build_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=SEQ_TRAIN_STEPS, warmup_steps=1)
    state = TS.init_state(api, tcfg, device=device)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batches = [TL.to_device(source.batch_at(i, BATCH, PROMPT), device)
               for i in range(SEQ_TRAIN_STEPS)]
    return api, tcfg, state, batches


def seq_parallel_rank(job_path: str, rank: int) -> None:
    """One rank of ``seq_parallel`` (``chip_smoke.py --seq-parallel-rank JOB
    R``): a ``gloo`` rank on card 0 of a 1x2 mesh.

    1. qwen2.5-3b at full width and depth, random bf16 weights from seed 0:
       the unsharded prefill of the serve prompts (4 x 512) first (its
       last-token logits and the rank's block of its cache kept), then, with
       the counts set to 0, the prompt through ``jit_serve_step`` under
       sequence_parallel into an empty cache split over ``kv_seq``: this
       rank's 256 tokens, every K2 call (with its query offset) held against
       K2's plain version on the same inputs, with a 5-bit control.
    2. qwen2.5-3b at full width and SEQ_TRAIN_LAYERS layers under tp2d (the
       sequence over ``model``, heads, ffn and vocabulary gathered for use):
       SEQ_TRAIN_STEPS steps through ``jit_train_step`` from the seed-0
       state, every K2-bwd call of the first step against its plain
       version, with a 5-bit control.
    Writes its results to ``JOB.rank<R>.json``."""
    import datetime

    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB, ops
    from repro_torch.launch import common, serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import planner_bridge as PB, sharding as SH
    from repro_torch.train import serve_step as SS, train_step as TS
    job = json.load(open(job_path))
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(1, 2)
        device = torch.device("cuda", 0)
        cfg = common.launch_config(ARCH)
        api = build_model(cfg)
        plan = SH.sequence_parallel_plan()
        params = serve.load_params(api, device, seed=0)
        prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)
        cache = api.init_cache(cfg, BATCH, PROMPT + NEW_TOKENS, device=device)
        with torch.no_grad():
            want, cache = api.prefill(params, prompts, cache)
        c_sh = SS.cache_shardings(api, cache, plan, mesh)
        want_block = {k: c_sh[k].local(cache[k]).clone() for k in ("k", "v")}
        empty = {k: (0 if k == "index" else torch.zeros_like(v)) for k, v in cache.items()}
        shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in cache.items() if k != "index"}
        del cache
        step = SS.jit_serve_step(api, plan, mesh, shapes, tokens_shape=(BATCH, PROMPT))
        calls, attention = [], ops.attention

        def checked(q, k, v, **kw):
            got = attention(q, k, v, **kw)
            w = FA.flash_attention_plain(q, k, v, **kw).float()
            norm = w.norm().clamp(min=1e-30)
            diff = got.float() - w
            calls.append({"q_offset": kw.get("q_offset", 0), "Sq": q.shape[1],
                          "Skv": k.shape[-2], "max_abs_err": diff.abs().max().item(),
                          "rel_rms": (diff.norm() / norm).item(),
                          "within_2e-2": bool(torch.allclose(got.float(), w, rtol=2e-2,
                                                             atol=2e-2)),
                          "control_rel_rms": ((coarse(got, 5).float() - w).norm()
                                              / norm).item()})
            return got

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with patched(ops, "attention", checked):
            logits, local = step(params, prompts, empty)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = kernels.launch_counts()
        prefill = {
            "launches": prefill_launches, "ms_with_per_call_checks": prefill_ms,
            "index": local["index"], "finite": bool(torch.isfinite(logits).all()),
            "max_abs_err": (logits.float() - want.float()).abs().max().item(),
            "cache_block_max_abs_err": max((local[k].float() - want_block[k].float())
                                           .abs().max().item() for k in want_block),
            "q_offsets": sorted({c["q_offset"] for c in calls}),
            "per_call": {"calls": len(calls),
                         "max_abs_err": max(c["max_abs_err"] for c in calls),
                         "max_rel_rms": max(c["rel_rms"] for c in calls),
                         "within": all(c["within_2e-2"] and c["rel_rms"] <= ATTN_REL_RMS
                                       for c in calls),
                         "control_5_bits_max_rel_rms": max(c["control_rel_rms"]
                                                           for c in calls),
                         "control_5_bits_rejected": any(c["control_rel_rms"] > ATTN_REL_RMS
                                                        for c in calls)},
            "peak_bytes": torch.cuda.max_memory_allocated(device)}
        del params, local, logits, want, want_block, empty, step
        gc.collect()
        torch.cuda.empty_cache()

        api, tcfg, state, batches = seq_train_setup(device)
        plan = PB._tp2d()
        step = TS.jit_train_step(api, tcfg, plan, mesh, batches[0])
        stats, history, step_s = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        for i, b in enumerate(batches):
            ctx = contextlib.ExitStack()
            if i == 0:
                ctx.enter_context(patched(FAB, "flash_attention_bwd", bwd_per_call(
                    stats, FAB.flash_attention_bwd, FAB.flash_attention_bwd_plain)))
            t0 = time.perf_counter()
            with ctx:
                state, m = step(state, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in m.items()})
        out.update(
            ok=True, prefill=prefill, coords=mesh.coords(), backend=dist.get_backend(),
            train={"plan": plan.name, "n_layers": api.cfg.n_layers, "history": history,
                   "step_ms": [x * 1e3 for x in step_s],
                   "launches": kernels.launch_counts(),
                   "per_call": summarize_per_call(stats),
                   "peak_bytes": torch.cuda.max_memory_allocated(device)})
    except Exception as err:  # noqa: BLE001 - reported to the parent, which fails
        import traceback
        out.update(ok=False, error=traceback.format_exc()[-3000:])
    finally:
        with open(f"{job_path}.rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def phase_seq_parallel(device) -> dict:
    """Plans that split the sequence, on two ``gloo`` ranks of the one card
    (a 1x2 mesh, :func:`seq_parallel_rank`).  First, here, the one-rank
    training oracle: SEQ_TRAIN_STEPS steps of qwen2.5-3b at
    SEQ_TRAIN_LAYERS layers, unsharded.  Then on each rank: the
    sequence_parallel prompt pass at full depth, its logits within 2e-2 of
    the unsharded prefill's and its cache block within 2e-2 of the unsharded
    cache's, K2 launched once a layer and nothing else, at query offset 0 on
    rank 0 and 256 on rank 1, every call within 2e-2 and ATTN_REL_RMS of
    its plain version and the 5-bit control rejected; then the tp2d steps,
    losses within 1e-3 relative of the one-rank steps', K2 2 x L and K2-bwd
    L a step, every K2-bwd call of the first step within its bound, the
    control rejected.  Returns rank 1's launches (prefill and training)."""
    from repro_torch.train import train_step as TS
    api, tcfg, state, batches = seq_train_setup(device)
    step = TS.make_train_step(api, tcfg)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    L_train = api.cfg.n_layers
    del api, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    results, wall_s = run_ranks("--seq-parallel-rank", "seq-parallel", {},
                                SEQ_PARALLEL_TIMEOUT_S)
    from repro_torch.launch import common
    L = common.launch_config(ARCH).n_layers
    zero = {k: 0 for k in results[0]["prefill"]["launches"]}
    ranks = []
    for res in results:
        pre, tr = res["prefill"], res["train"]
        r = res["coords"]["model"]
        got = [h["loss"] for h in tr["history"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses))
        ranks.append({"rank": res["rank"], "coords": res["coords"], "backend": res["backend"],
                      "prefill": pre, "train": dict(tr, loss_rel_err_vs_one_rank=rel)})
        if pre["launches"] != dict(zero, flash_attention=L):
            raise AssertionError(f"seq_parallel rank {r}: prefill launches {pre['launches']}")
        if pre["q_offsets"] != [r * PROMPT // 2] or pre["per_call"]["calls"] != L:
            raise AssertionError(f"seq_parallel rank {r}: K2's query offsets "
                                 f"{pre['q_offsets']} over {pre['per_call']['calls']} calls")
        if not (pre["max_abs_err"] <= TOL[torch.bfloat16] and pre["finite"]
                and pre["cache_block_max_abs_err"] <= TOL[torch.bfloat16]
                and pre["index"] == PROMPT):
            raise AssertionError(f"seq_parallel rank {r}: the sequence-split prefill "
                                 f"disagrees with the unsharded one: {pre}")
        if not pre["per_call"]["within"] or not pre["per_call"]["control_5_bits_rejected"]:
            raise AssertionError(f"seq_parallel rank {r}: per-call K2 check {pre['per_call']}")
        want = dict(zero, flash_attention=2 * L_train * SEQ_TRAIN_STEPS,
                    flash_attention_bwd=L_train * SEQ_TRAIN_STEPS)
        if tr["launches"] != want:
            raise AssertionError(f"seq_parallel rank {r}: train launches {tr['launches']}, "
                                 f"expected {want}")
        if rel > 1e-3 or not all(math.isfinite(x) for x in got):
            raise AssertionError(f"seq_parallel rank {r}: tp2d losses {got} against the "
                                 f"one-rank step's {losses}")
        pc = tr["per_call"]
        if not pc["within"] or pc["calls"] != L_train or not pc["control_5_bits_rejected"]:
            raise AssertionError(f"seq_parallel rank {r}: per-call K2-bwd check {pc}")
    emit({"phase": "seq_parallel", "arch": ARCH, "mesh": [1, 2], "batch": BATCH,
          "prompt_len": PROMPT, "prefill_plan": "sequence_parallel", "prefill_layers": L,
          "train_plan": "tp2d", "train_layers": L_train, "train_steps": SEQ_TRAIN_STEPS,
          "one_rank_losses": losses, "ranks": ranks, "wall_s": wall_s,
          "check": "prefill logits and cache block within 2e-2 of the unsharded prefill's; "
                   f"each K2 call within 2e-2 and {ATTN_REL_RMS} relative rms of its plain "
                   "version, a 5-bit control rejected; tp2d losses within 1e-3 relative of "
                   "the one-rank step's; each K2-bwd call of the first step within its bound",
          "card": smi_line()})
    last = results[-1]
    return {k: last["prefill"]["launches"][k] + last["train"]["launches"][k]
            for k in last["prefill"]["launches"]}


# recurrent_parallel: the prefills (arch, plans) at full width and depth, and
# the training cases (arch, plan) at RECURRENT_TRAIN_LAYERS layers
RECURRENT_PREFILLS = ((RWKV_ARCH, ("megatron_tp", "sequence_parallel")),
                      (HYBRID_ARCH, ("megatron_tp", "sequence_parallel")),
                      (ENCDEC_ARCH, ("megatron_tp",)))
RECURRENT_TRAIN = ((RWKV_ARCH, "zero3_sp"), (RWKV_ARCH, "megatron_tp"),
                   (HYBRID_ARCH, "zero3_sp"))
RECURRENT_TRAIN_LAYERS, RECURRENT_TRAIN_STEPS = 4, 2
RECURRENT_TIMEOUT_S = 600


def gap(x: torch.Tensor, ref: torch.Tensor) -> tuple:
    """Largest and root-mean-square difference of ``x`` from ``ref``."""
    diff = x.float() - ref.float()
    return diff.abs().max().item(), diff.square().mean().sqrt().item()


def within_scaled(dist, base, scale: float) -> bool:
    """:func:`within` for a tensor of any size: ``dist`` from the float32
    run at most 1.25 x the unsharded path's ``base``, plus 2e-2 of the
    float32 tensor's largest entry in the largest difference."""
    return dist[0] <= 1.25 * base[0] + 2e-2 * scale and dist[1] <= 1.25 * base[1]


def recurrent_plan(name: str):
    """The fixed plan ``name``, or the planner's derived zero3_sp (megatron
    TP, ``embed`` over ``data``, the sequence over ``model``)."""
    from repro_torch.parallel import planner_bridge as PB, sharding as SH
    if name == "zero3_sp":
        return PB._rename(PB._zero3().with_rule("seq", "model").with_rule("kv_seq", "model"),
                          "zero3_sp")
    return SH.FIXED_PLANS[name]()


def recurrent_train_setup(device, arch):
    """``arch`` at full width and RECURRENT_TRAIN_LAYERS layers (zamba2: 4
    Mamba2 layers, 2 shared-attention sites; kernel path, remat) computing
    in float32, its seed-0 train state, AdamW and the batches.  float32:
    rwkv6-3b's gradient at this init is ill-conditioned, and in bf16 two
    correct paths, the kernels' and the plain one, give its embedding a
    gradient of norm 198 and 181, their head-local steps 102 and 279 (2
    layers; ``grad_probe.py``, PERF.md), so bf16 steps cannot be held to
    each other."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import common, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import train_step as TS
    cfg = replace(common.launch_config(arch), n_layers=RECURRENT_TRAIN_LAYERS,
                  compute_dtype="float32")
    api = build_model(cfg)
    # at 1e-3 the first AdamW step takes rwkv6's 4-layer model from a loss
    # of 11.6 to 28.7 (PERF.md): a diverging step, after which the loss
    # moves with the sign of every gradient entry near 0 and two correct
    # bf16 paths end 0.4 % apart; at 1e-4 the step is a step
    tcfg = TrainConfig(learning_rate=1e-4, total_steps=RECURRENT_TRAIN_STEPS, warmup_steps=1)
    state = TS.init_state(api, tcfg, device=device)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batches = [TL.to_device(source.batch_at(i, BATCH, PROMPT), device)
               for i in range(RECURRENT_TRAIN_STEPS)]
    return api, tcfg, state, batches


def checked_wkv6(errs: list):
    """K5's wrapper holding every call against its plain version on the
    same inputs (from the same initial state): one bf16 step for o, 2e-3
    for the final state, and the same bound on o rounded to 5 mantissa bits
    (a control that must fail on some call)."""
    from repro_torch.kernels import rwkv6 as K
    kernel = K.wkv6

    def call(*args, chunk, **kw):
        o, state = kernel(*args, chunk=chunk, **kw)
        po, pstate = K.wkv6_plain(*args, chunk=chunk, **kw)
        errs.append(wkv6_step_errors(o, state, po, pstate)
                    + (wkv6_step_errors(coarse(o, 5), state, po, pstate)[2],
                       "state0" in kw))
        return o, state

    return call


def summarize_wkv6(errs: list) -> dict:
    return {"calls": len(errs), "from_a_state": sum(e[5] for e in errs),
            "o_max_abs_err": max((e[0] for e in errs), default=0.0),
            "o_max_share_of_bound": max((e[1] for e in errs), default=0.0),
            "state_max_rel_err": max((e[3] for e in errs), default=0.0),
            "within": all(e[2] for e in errs),
            "control_5_bits_rejected": any(not e[4] for e in errs)}


def recurrent_parallel_rank(job_path: str, rank: int) -> None:
    """One rank of ``recurrent_parallel`` (``chip_smoke.py
    --recurrent-parallel-rank JOB R``): a ``gloo`` rank on card 0 of a 1x2
    mesh.

    1. For each of RECURRENT_PREFILLS, random bf16 weights from seed 0 at
       full width and depth: the unsharded prefill of the serve prompts (4 x
       512, the stub frontend input from seed 0) through the kernels, and
       the same in float32 on the plain path (the oracles); then for each
       plan, with the counts set to 0, the prompt through ``jit_serve_step``
       into an empty cache, every K5 call held against its plain version
       (:func:`checked_wkv6`).
    2. For each of RECURRENT_TRAIN: RECURRENT_TRAIN_STEPS steps through
       ``jit_train_step`` from the seed-0 state, every K5 and K5-bwd call of
       the first step against its plain version.
    Writes its results to ``JOB.rank<R>.json``."""
    import datetime

    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.kernels import rwkv6 as K, rwkv6_bwd as KB
    from repro_torch.launch import common, serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train import serve_step as SS, train_step as TS
    job = json.load(open(job_path))
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank, "prefill": {}, "train": {}, "seconds": {}}
    try:
        mesh = make_host_mesh(1, 2)
        device = torch.device("cuda", 0)
        for arch, plans in RECURRENT_PREFILLS:
            t_arch = time.perf_counter()
            cfg = common.launch_config(arch)
            api = build_model(cfg)
            params = serve.load_params(api, device, seed=0)
            prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)
            inputs = api.frontend_inputs(BATCH, torch.Generator(device=device).manual_seed(0),
                                         device)
            length = PROMPT + NEW_TOKENS
            cache = api.init_cache(cfg, BATCH, length, device=device)
            f32 = build_model(replace(cfg, kernels="plain", compute_dtype="float32"))
            with torch.no_grad():
                want, cache = api.prefill(params, prompts, cache, **inputs)
                exact, c32 = f32.prefill(params, prompts,
                                         f32.init_cache(f32.cfg, BATCH, length, device=device),
                                         **inputs)
            base = gap(want, exact)
            leaves = [k for k, v in cache.items() if isinstance(v, torch.Tensor)]
            for name in plans:
                plan = recurrent_plan(name)
                c_sh = SS.cache_shardings(api, cache, plan, mesh)
                empty = {k: (torch.zeros_like(v) if k in leaves else 0)
                         for k, v in cache.items()}
                shapes = {k: torch.empty(cache[k].shape, dtype=cache[k].dtype, device="meta")
                          for k in leaves}
                step = SS.jit_serve_step(api, plan, mesh, shapes, tokens_shape=(BATCH, PROMPT))
                errs = []
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                with patched(K, "wkv6", checked_wkv6(errs)):
                    logits, local = step(params, prompts, empty, **inputs)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                launches = kernels.launch_counts()
                dist_ = gap(logits, exact)
                cache_err = {}
                for k in leaves:
                    w, e = c_sh[k].local(cache[k]), c_sh[k].local(c32[k])
                    scale = e.float().abs().max().item()
                    got_, base_ = gap(local[k], e), gap(w, e)
                    cache_err[k] = {"vs_float32_max": got_[0], "vs_float32_rms": got_[1],
                                    "unsharded_vs_float32_max": base_[0],
                                    "unsharded_vs_float32_rms": base_[1],
                                    "vs_unsharded_max": gap(local[k], w)[0],
                                    "largest_float32": scale,
                                    "within": within_scaled(got_, base_, scale)}
                out["prefill"][f"{arch} {name}"] = {
                    "arch": arch, "plan": name, "launches": launches,
                    "ms_with_per_call_checks": ms, "index": local["index"],
                    "finite": bool(torch.isfinite(logits).all()),
                    "vs_float32_max": dist_[0], "vs_float32_rms": dist_[1],
                    "unsharded_vs_float32_max": base[0], "unsharded_vs_float32_rms": base[1],
                    "within": within(dist_, base),
                    "vs_unsharded_max": (logits.float() - want.float()).abs().max().item(),
                    "cache": cache_err, "wkv6_per_call": summarize_wkv6(errs),
                    "peak_bytes": torch.cuda.max_memory_allocated(device)}
                del step, local, logits, empty
            del api, f32, params, cache, want, exact, c32
            gc.collect()
            torch.cuda.empty_cache()
            out["seconds"][arch] = time.perf_counter() - t_arch
        for arch, name in RECURRENT_TRAIN:
            t_case = time.perf_counter()
            api, tcfg, state, batches = recurrent_train_setup(device, arch)
            step = TS.jit_train_step(api, tcfg, recurrent_plan(name), mesh, batches[0])
            errs, stats, history, step_s = [], [], [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            kernels.reset_launch_counts()
            for i, b in enumerate(batches):
                ctx = contextlib.ExitStack()
                if i == 0:
                    ctx.enter_context(patched(K, "wkv6", checked_wkv6(errs)))
                    ctx.enter_context(patched(KB, "wkv6_bwd", bwd_per_call(
                        stats, KB.wkv6_bwd, KB.wkv6_bwd_plain, of_largest=True)))
                t0 = time.perf_counter()
                with ctx:
                    state, m = step(state, b)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                history.append({k: float(v) for k, v in m.items()})
            out["train"][f"{arch} {name}"] = {
                "arch": arch, "plan": name, "n_layers": api.cfg.n_layers, "history": history,
                "step_ms": [x * 1e3 for x in step_s], "launches": kernels.launch_counts(),
                "wkv6_per_call": summarize_wkv6(errs),
                "wkv6_bwd_per_call": summarize_per_call(stats, WKV_BWD_REL_RMS) if stats
                else None,
                "peak_bytes": torch.cuda.max_memory_allocated(device)}
            del api, state, step, batches
            gc.collect()
            torch.cuda.empty_cache()
            out["seconds"][f"{arch} {name}"] = time.perf_counter() - t_case
        out.update(ok=True, coords=mesh.coords(), backend=dist.get_backend())
    except Exception:  # noqa: BLE001 - reported to the parent, which fails
        import traceback
        out.update(ok=False, error=traceback.format_exc()[-3000:])
    finally:
        with open(f"{job_path}.rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def phase_recurrent_parallel(device) -> dict:
    """rwkv6, zamba2 and the encoder-decoder computed in parts on two
    ``gloo`` ranks of the one card (a 1x2 mesh,
    :func:`recurrent_parallel_rank`).  First, here, the one-rank training
    oracles: each of RECURRENT_TRAIN's models unsharded for
    RECURRENT_TRAIN_STEPS steps.  Then on each rank the prefills and steps.
    Checks, for each rank: every prefill's logits finite, at most 1.25 x as
    far from the unsharded float32 prefill as the unsharded bf16 prefill
    (:func:`within`), every cache leaf's slice likewise against the
    float32 prefill's (:func:`within_scaled`), the index 512, the launches
    exact (K5 L
    a rank under megatron_tp and 2 L under sequence_parallel, K2 once a
    shared-attention site or an attention pass, nothing else); every K5
    call within one bf16 step of its plain version, from the same state,
    and the 5-bit control rejected; the steps' losses within 1e-3 relative
    of the one-rank steps' and the first gradient's norm within 2e-2 (in
    float32, :func:`recurrent_train_setup`; rwkv6-3b's gradient at this init
    amplifies a perturbation: two correct float32 paths, the one-rank step
    and a sharded one, agree leaf by leaf to 4e-5 at one layer and 7e-3 at
    four, where qwen2.5-3b's and zamba2-1.2b's agree to 3e-6 and 7e-6 at
    four (``grad_probe.py``, PERF.md); a rank's part of a gradient lost or
    summed twice is 30 % off or more), the
    launches exact, every K5-bwd call of the
    first step within its bound and its control rejected.  Returns rank 1's
    launches (prefills and steps)."""
    from repro_torch.launch import common
    from repro_torch.train import train_step as TS
    losses, norms = {}, {}
    t0 = time.perf_counter()
    for arch in dict(RECURRENT_TRAIN):
        api, tcfg, state, batches = recurrent_train_setup(device, arch)
        step = TS.make_train_step(api, tcfg)
        losses[arch] = []
        for b in batches:
            state, m = step(state, b)
            losses[arch].append(float(m["loss"]))
            norms.setdefault(arch, float(m["grad_norm"]))
        del api, state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
    oracle_s = time.perf_counter() - t0
    results, wall_s = run_ranks("--recurrent-parallel-rank", "recurrent-parallel", {},
                                RECURRENT_TIMEOUT_S)
    zero = {k: 0 for k in next(iter(results[0]["prefill"].values()))["launches"]}
    L = {arch: common.launch_config(arch).n_layers for arch, _ in RECURRENT_PREFILLS}
    sites = L[HYBRID_ARCH] // common.launch_config(HYBRID_ARCH).attn_every
    want_prefill = {RWKV_ARCH: lambda plan: dict(zero, wkv6=L[RWKV_ARCH] * (
                        2 if plan == "sequence_parallel" else 1)),
                    HYBRID_ARCH: lambda plan: dict(zero, flash_attention=sites),
                    ENCDEC_ARCH: lambda plan: dict(zero, flash_attention=3 * L[ENCDEC_ARCH])}
    Lt, n = RECURRENT_TRAIN_LAYERS, RECURRENT_TRAIN_STEPS
    want_train = {(RWKV_ARCH, "zero3_sp"): dict(zero, wkv6=4 * Lt * n, wkv6_bwd=2 * Lt * n),
                  (RWKV_ARCH, "megatron_tp"): dict(zero, wkv6=2 * Lt * n, wkv6_bwd=Lt * n),
                  (HYBRID_ARCH, "zero3_sp"): dict(zero, flash_attention=2 * (Lt // 2) * n,
                                                  flash_attention_bwd=(Lt // 2) * n)}
    for res in results:
        r = res["coords"]["model"]
        for key, pre in res["prefill"].items():
            bad = []
            if pre["launches"] != want_prefill[pre["arch"]](pre["plan"]):
                bad.append(f"launches {pre['launches']}")
            if not (pre["finite"] and pre["within"] and pre["index"] == PROMPT):
                bad.append("logits against the float32 prefill")
            if not all(c["within"] for c in pre["cache"].values()):
                bad.append(f"cache {pre['cache']}")
            pc = pre["wkv6_per_call"]
            if pre["arch"] == RWKV_ARCH and not (pc["within"] and pc["control_5_bits_rejected"]
                                                 and pc["calls"] == pre["launches"]["wkv6"]):
                bad.append(f"K5 per call {pc}")
            if bad:
                raise AssertionError(f"recurrent_parallel rank {r}, {key}: {bad}: {pre}")
        for key, tr in res["train"].items():
            arch, plan = tr["arch"], tr["plan"]
            got = [h["loss"] for h in tr["history"]]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses[arch]))
            tr["loss_rel_err_vs_one_rank"] = rel
            bad = []
            if tr["launches"] != want_train[(arch, plan)]:
                bad.append(f"launches {tr['launches']}")
            norm = abs(tr["history"][0]["grad_norm"] - norms[arch]) / norms[arch]
            tr["grad_norm_rel_err_vs_one_rank"] = norm
            if rel > 1e-3 or norm > 2e-2 or not all(math.isfinite(x) for x in got):
                bad.append(f"losses {got} against {losses[arch]}, first gradient norm "
                           f"{tr['history'][0]['grad_norm']} against {norms[arch]}")
            if arch == RWKV_ARCH:
                pc, pb = tr["wkv6_per_call"], tr["wkv6_bwd_per_call"]
                if not (pc["within"] and pc["control_5_bits_rejected"] and pb["within"]
                        and pb["control_5_bits_rejected"]):
                    bad.append(f"per call K5 {pc}, K5-bwd {pb}")
            if bad:
                raise AssertionError(f"recurrent_parallel rank {r}, {key}: {bad}")
    emit({"phase": "recurrent_parallel", "mesh": [1, 2], "batch": BATCH, "prompt_len": PROMPT,
          "prefills": {a: list(p) for a, p in RECURRENT_PREFILLS},
          "train": [list(c) for c in RECURRENT_TRAIN], "train_layers": RECURRENT_TRAIN_LAYERS,
          "train_steps": RECURRENT_TRAIN_STEPS, "one_rank_losses": losses,
          "ranks": results, "wall_s": wall_s, "one_rank_oracle_s": oracle_s,
          "check": "prefill logits and every cache leaf's slice at most 1.25 x as far from "
                   "the unsharded float32 prefill's as the unsharded bf16 prefill's (max + "
                   "2e-2, of the largest entry for a cache leaf; rms); exact "
                   "launches; every K5 call within one bf16 step of its plain version from "
                   "the same state, every K5-bwd call of the first step within 2e-2 of each "
                   f"output's largest entry and {WKV_BWD_REL_RMS} relative rms, 5-bit "
                   "controls rejected; losses within 1e-3 relative of the one-rank steps' "
                   "(float32, AdamW at 1e-4), the first gradient's norm within 2e-2",
          "card": smi_line()})
    last = results[-1]
    total = dict(zero)
    for part in list(last["prefill"].values()) + list(last["train"].values()):
        for k, v in part["launches"].items():
            total[k] += v
    return total


# family_seq_parallel: the prefills (arch, layers or None for full depth) under
# sequence_parallel on a 1x2 mesh, and the float32 training cases (mesh, arch,
# plan) of FAMILY_TRAIN_STEPS steps, each model cut to FAMILY_TRAIN_LAYERS
FAMILY_PREFILLS = ((VLM_ARCH, None), (ENCDEC_ARCH, None), (MOE_ARCH, MOE_TRAIN_LAYERS))
# the prompt passes' plan on each mesh: 2x2 runs tp2d (the residual's embed
# over data too)
FAMILY_PREFILL_PLAN = {(1, 2): "sequence_parallel", (2, 2): "tp2d"}
FAMILY_TRAIN = (((1, 2), VLM_ARCH, "zero3_sp"), ((1, 2), MOE_ARCH, "zero3_sp"),
                ((1, 2), MOE_ARCH, "sequence_parallel"), ((1, 2), ENCDEC_ARCH, "zero3_sp"),
                ((2, 2), RWKV_ARCH, "tp2d"), ((2, 2), HYBRID_ARCH, "tp2d"),
                ((2, 2), VLM_ARCH, "tp2d"), ((2, 2), MOE_ARCH, "tp2d"),
                ((2, 2), ENCDEC_ARCH, "tp2d"))
FAMILY_TRAIN_LAYERS = {VLM_ARCH: {"n_layers": 4}, MOE_ARCH: {"n_layers": MOE_TRAIN_LAYERS},
                       ENCDEC_ARCH: {"n_layers": 2, "n_encoder_layers": 2},
                       RWKV_ARCH: {"n_layers": 4}, HYBRID_ARCH: {"n_layers": 4}}
FAMILY_TRAIN_STEPS = 2
# the MoE, the VLM and the encoder-decoder take one step under tp2d
FAMILY_STEPS = {(a, "tp2d"): 1 for a in (VLM_ARCH, MOE_ARCH, ENCDEC_ARCH)}
FAMILY_TIMEOUT_S = 600


def family_plan(name: str):
    """The fixed plan ``name``, or the planner's derived zero3_sp or tp2d."""
    from repro_torch.parallel import planner_bridge as PB
    return PB._tp2d() if name == "tp2d" else recurrent_plan(name)


def family_train_setup(device, arch):
    """``arch`` at full width and the depth of FAMILY_TRAIN_LAYERS (kernel
    path, remat) computing in float32, its seed-0 train state, AdamW at
    1e-4 (the MoE: Adafactor, whose factored moments leave two ranks'
    whole float32 weights and gradients room on the one card, where
    AdamW's two moments of 1.9 B parameters would not) and the batches
    (with the stub frontend inputs)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import common, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import train_step as TS
    cfg = replace(common.launch_config(arch), compute_dtype="float32",
                  **FAMILY_TRAIN_LAYERS[arch])
    api = build_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-4, total_steps=FAMILY_TRAIN_STEPS, warmup_steps=1,
                       optimizer="adafactor" if arch == MOE_ARCH else "adamw")
    state = TS.init_state(api, tcfg, device=device)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batches = [TL.to_device(source.batch_at(i, BATCH, PROMPT), device)
               for i in range(FAMILY_TRAIN_STEPS)]
    return api, tcfg, state, batches


def one_output_per_call(stats: list, kernel, plain):
    """A forward wrapper of one output held against its plain version on
    the same inputs, computed without autograd (:func:`bwd_per_call`'s rows:
    within 2e-2 of the output's largest entry, the relative RMS, a 5-bit
    control)."""
    def plain_nograd(*a, **k):
        with torch.no_grad():
            return (plain(*a, **k),)
    check = bwd_per_call(stats, lambda *a, **k: (kernel(*a, **k),), plain_nograd,
                         of_largest=True)
    return lambda *a, **k: check(*a, **k)[0]


@contextlib.contextmanager
def checked_kernels(stats: dict):
    """Every K2, K2-bwd, K4, K4-bwd, K5 and K5-bwd call held against its
    plain version on the same inputs (rows in ``stats`` by kernel): K2 and
    K4 through their ``ops`` wrappers, K4-bwd inside
    ``ops._GroupedMatmul.backward`` (dX and dW against the plain grouped
    products), K5 by :func:`checked_wkv6`."""
    from repro_torch.kernels import (flash_attention as FA, flash_attention_bwd as FAB,
                                     moe_gmm, ops, rwkv6 as K, rwkv6_bwd as KB)
    real_bwd = ops._GroupedMatmul.backward

    def plain_bwd(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        with torch.no_grad():
            return (moe_gmm.grouped_matmul_plain(dy, w.transpose(1, 2), out_dtype=x.dtype),
                    moe_gmm.grouped_matmul_plain(x.transpose(1, 2), dy, out_dtype=w.dtype))

    class Saved:
        """The backward's context with its saved tensors unpacked once (a
        checkpointed forward's may be unpacked only once)."""

        def __init__(self, ctx):
            self._ctx, self.saved_tensors = ctx, ctx.saved_tensors

        def __getattr__(self, name):
            return getattr(self._ctx, name)

    check = bwd_per_call(stats["grouped_matmul_bwd"], lambda ctx, dy: real_bwd(ctx, dy)[:2],
                         plain_bwd, of_largest=True)

    def gmm_bwd(ctx, dy):
        return check(Saved(ctx), dy)
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(patched(ops, "attention", one_output_per_call(
            stats["flash_attention"], ops.attention, FA.flash_attention_plain)))
        ctx.enter_context(patched(ops, "grouped_matmul", one_output_per_call(
            stats["grouped_matmul"], ops.grouped_matmul, moe_gmm.grouped_matmul_plain)))
        ctx.enter_context(patched(FAB, "flash_attention_bwd", bwd_per_call(
            stats["flash_attention_bwd"], FAB.flash_attention_bwd,
            FAB.flash_attention_bwd_plain)))
        ctx.enter_context(patched(KB, "wkv6_bwd", bwd_per_call(
            stats["wkv6_bwd"], KB.wkv6_bwd, KB.wkv6_bwd_plain, of_largest=True)))
        ctx.enter_context(patched(K, "wkv6", checked_wkv6(stats["wkv6"])))
        saved = ops._GroupedMatmul.__dict__["backward"]
        ops._GroupedMatmul.backward = staticmethod(lambda c, dy: (*gmm_bwd(c, dy), None, None))
        try:
            yield
        finally:
            ops._GroupedMatmul.backward = saved


def summarize_checked(stats: dict) -> dict:
    """Each kernel's per-call rows: K5's by :func:`summarize_wkv6`, K5-bwd's
    with 2^-10, the others with :data:`ATTN_REL_RMS`."""
    out = {}
    for name, rows in stats.items():
        if not rows:
            continue
        if name == "wkv6":
            out[name] = summarize_wkv6(rows)
        else:
            out[name] = summarize_per_call(rows, WKV_BWD_REL_RMS if name == "wkv6_bwd"
                                           else ATTN_REL_RMS)
    return out


def new_stats() -> dict:
    return {k: [] for k in ("flash_attention", "flash_attention_bwd", "grouped_matmul",
                            "grouped_matmul_bwd", "wkv6", "wkv6_bwd")}


def block_router(recorded, rows: int, block: tuple):
    """``moe._router`` replaying another run's expert choices (in call
    order) on this rank's block ``(o, n)`` of each row's tokens: the
    recorded (rows x S, k) choices cut to the block."""
    o, n = block
    cut = [idx.view(rows, -1, idx.shape[-1])[:, o:o + n].reshape(-1, idx.shape[-1])
           for idx in recorded]
    return replaying_router(cut)


def family_prefill(arch, layers, mesh, device, plan_name="sequence_parallel") -> dict:
    """``arch`` (random bf16 weights from seed 0, at ``layers`` layers or its
    full depth) prefilled unsharded through the kernels, then on the plain
    path in bf16 and in float32 (the MoE's with the kernel run's routing
    replayed), then through ``jit_serve_step`` under ``plan_name``
    (sequence_parallel or tp2d) into an empty cache (the MoE's routing
    replayed on the rank's block of the tokens, or under tp2d, whose
    expert-parallel branch routes the gathered sequence, on all of them),
    every kernel call held against its plain version, the launches counted
    from 0; the MoE's pairs routed to and kept by each expert of the rank's
    slice."""
    from repro_torch import kernels
    from repro_torch.launch import common, serve
    from repro_torch.models import build_model, moe
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import serve_step as SS
    cfg = common.launch_config(arch)
    if layers:
        cfg = replace(cfg, n_layers=layers)
    api = build_model(cfg)
    params = serve.load_params(api, device, seed=0)
    prompts = serve.make_prompts(cfg, BATCH, PROMPT, device)
    inputs = api.frontend_inputs(BATCH, torch.Generator(device=device).manual_seed(0), device)
    length = api.prefix_len() + PROMPT + NEW_TOKENS
    cache = api.init_cache(cfg, BATCH, length, device=device)
    plain = build_model(replace(cfg, kernels="plain"))
    f32 = build_model(replace(cfg, kernels="plain", compute_dtype="float32"))
    routed, router = [], moe._router

    def recording(xf, router_w, c):
        out = router(xf, router_w, c)
        routed.append(out[1])
        return out

    moe.DISPATCH_TRACE = []
    with torch.no_grad(), patched(moe, "_router", recording):
        want, cache = api.prefill(params, prompts, cache, **inputs)
    unsharded, moe.DISPATCH_TRACE = moe.DISPATCH_TRACE, None
    with torch.no_grad(), patched(moe, "_router", replaying_router(routed)):
        base_logits, _ = plain.prefill(params, prompts, plain.init_cache(
            plain.cfg, BATCH, length, device=device), **inputs)
    with torch.no_grad(), patched(moe, "_router", replaying_router(routed)):
        exact, c32 = f32.prefill(params, prompts,
                                 f32.init_cache(f32.cfg, BATCH, length, device=device), **inputs)
    base = gap(base_logits, exact)
    plan = family_plan(plan_name)
    leaves = [k for k, v in cache.items() if isinstance(v, torch.Tensor)]
    c_sh = SS.cache_shardings(api, cache, plan, mesh)
    empty = {k: (torch.zeros_like(v) if k in leaves else 0) for k, v in cache.items()}
    shapes = {k: torch.empty(cache[k].shape, dtype=cache[k].dtype, device="meta")
              for k in leaves}
    step = SS.jit_serve_step(api, plan, mesh, shapes, tokens_shape=(BATCH, PROMPT))
    stats = new_stats()
    r = mesh.coords()["model"]
    moe.DISPATCH_TRACE = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    router = replaying_router(routed) if plan_name == "tp2d" else block_router(
        routed, BATCH, (r * PROMPT // 2, PROMPT // 2))
    with checked_kernels(stats), patched(moe, "_router", router):
        logits, local = step(params, prompts, empty, **inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    split, moe.DISPATCH_TRACE = moe.DISPATCH_TRACE, None
    dist_ = gap(logits, exact)
    cache_err = {}
    for k in leaves:
        w, e = c_sh[k].local(cache[k]), c_sh[k].local(c32[k])
        scale = e.float().abs().max().item()
        got_, base_ = gap(local[k], e), gap(w, e)
        cache_err[k] = {"vs_float32_max": got_[0], "vs_float32_rms": got_[1],
                        "unsharded_vs_float32_max": base_[0],
                        "unsharded_vs_float32_rms": base_[1],
                        "vs_unsharded_max": gap(local[k], w)[0], "largest_float32": scale,
                        "within": within_scaled(got_, base_, scale)}
    out = {"arch": arch, "plan": plan_name, "n_layers": cfg.n_layers, "launches": launches,
           "ms_with_per_call_checks": ms, "index": local["index"],
           "finite": bool(torch.isfinite(logits).all()),
           "vs_float32_max": dist_[0], "vs_float32_rms": dist_[1],
           "plain_vs_float32_max": base[0], "plain_vs_float32_rms": base[1],
           "unsharded_vs_float32_max": gap(want, exact)[0],
           "within": within(dist_, base),
           "vs_unsharded_max": (logits.float() - want.float()).abs().max().item(),
           "cache": cache_err, "per_call": summarize_checked(stats),
           "peak_bytes": torch.cuda.max_memory_allocated(device)}
    if unsharded:
        out["moe"] = {"unsharded_kept": [t["kept"].tolist() for t in unsharded],
                      "unsharded_routed": [t["routed"].tolist() for t in unsharded],
                      "kept": [t["kept"].tolist() for t in split],
                      "routed": [t["routed"].tolist() for t in split],
                      "buffers": [list(t["buffer"]) for t in split],
                      "unsharded_buffers": [list(t["buffer"]) for t in unsharded],
                      "capacity": moe._capacity(BATCH * PROMPT, cfg),
                      # the rank's expert slice: all of them but under tp2d
                      "e_lo": (r * split[0]["buffer"][0]
                               if split[0]["buffer"][0] < cfg.n_experts else 0)}
    return out


def family_seq_rank(job_path: str, rank: int) -> None:
    """One rank of ``family_seq_parallel`` (``chip_smoke.py
    --family-seq-rank JOB R``): a ``gloo`` rank on card 0 of the job's mesh
    (1x2 or 2x2).  Each of FAMILY_PREFILLS under the mesh's
    FAMILY_PREFILL_PLAN (:func:`family_prefill`); then each of
    FAMILY_TRAIN's cases on this mesh: FAMILY_TRAIN_STEPS (FAMILY_STEPS)
    float32 steps through ``jit_train_step`` from the seed-0 state, every
    kernel call of the first step held against its plain version.  Writes
    its results to ``JOB.rank<R>.json``."""
    import datetime

    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.train import train_step as TS
    job = json.load(open(job_path))
    shape = tuple(job["mesh"])
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=math.prod(shape),
                            timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank, "prefill": {}, "train": {}, "seconds": {}}
    try:
        mesh = make_host_mesh(*shape)
        device = torch.device("cuda", 0)
        for arch, layers in FAMILY_PREFILLS:
            t0 = time.perf_counter()
            out["prefill"][arch] = family_prefill(arch, layers, mesh, device,
                                                  FAMILY_PREFILL_PLAN[shape])
            gc.collect()
            torch.cuda.empty_cache()
            out["seconds"][arch] = time.perf_counter() - t0
        for mesh_shape, arch, name in FAMILY_TRAIN:
            if tuple(mesh_shape) != shape:
                continue
            t_case = time.perf_counter()
            api, tcfg, state, batches = family_train_setup(device, arch)
            batches = batches[:FAMILY_STEPS.get((arch, name), FAMILY_TRAIN_STEPS)]
            step = TS.jit_train_step(api, tcfg, family_plan(name), mesh, batches[0])
            stats, history, step_s = new_stats(), [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            kernels.reset_launch_counts()
            moe.DISPATCH_TRACE = []
            with backward_launches() as bwd:
                for i, b in enumerate(batches):
                    ctx = contextlib.ExitStack()
                    if i == 0:
                        ctx.enter_context(checked_kernels(stats))
                    t0 = time.perf_counter()
                    with ctx:
                        state, m = step(state, b)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    history.append({k: float(v) for k, v in m.items()})
            trace, moe.DISPATCH_TRACE = moe.DISPATCH_TRACE, None
            out["train"][f"{arch} {name}"] = {
                "arch": arch, "plan": name, "mesh": list(shape),
                "layers": FAMILY_TRAIN_LAYERS[arch],
                "history": history, "step_ms": [x * 1e3 for x in step_s],
                "launches": dict(kernels.launch_counts(), **dict(bwd)),
                "moe_buffers": sorted({tuple(t["buffer"]) for t in trace}),
                "per_call": summarize_checked(stats),
                "peak_bytes": torch.cuda.max_memory_allocated(device)}
            del api, state, step, batches
            gc.collect()
            torch.cuda.empty_cache()
            out["seconds"][f"{arch} {name}"] = time.perf_counter() - t_case
        out.update(ok=True, coords=mesh.coords(), backend=dist.get_backend())
    except Exception:  # noqa: BLE001 - reported to the parent, which fails
        import traceback
        out.update(ok=False, error=traceback.format_exc()[-3000:])
    finally:
        with open(f"{job_path}.rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def family_launches(arch: str, plan: str, zero: dict, n: int = FAMILY_TRAIN_STEPS) -> dict:
    """The kernel launches a rank makes in ``n`` steps of ``arch`` (remat:
    every forward kernel twice a step)."""
    L = FAMILY_TRAIN_LAYERS[arch]
    if arch == RWKV_ARCH:          # two K5 scans a layer: the block's own, then from the state
        return dict(zero, wkv6=4 * L["n_layers"] * n, wkv6_bwd=2 * L["n_layers"] * n)
    if arch == ENCDEC_ARCH:        # encoder self, decoder self and cross
        passes = L["n_encoder_layers"] + 2 * L["n_layers"]
    else:                          # zamba2: a shared-attention site every two layers
        passes = L["n_layers"] // (2 if arch == HYBRID_ARCH else 1)
    out = dict(zero, flash_attention=2 * passes * n, flash_attention_bwd=passes * n)
    if arch == MOE_ARCH:           # three expert products a layer; dX and dW of each,
        # which K4's counter counts too
        out.update(grouped_matmul=12 * L["n_layers"] * n,
                   grouped_matmul_bwd=6 * L["n_layers"] * n)
    return out


def checked_calls(launches: dict) -> dict:
    """The calls :func:`checked_kernels` holds against their plain versions
    where a rank launched ``launches``, by kernel: a K4-bwd call launches
    K4 twice (dX and dW), and K4's counter counts those launches too."""
    calls = {k: launches.get(k, 0) for k in new_stats()}
    calls["grouped_matmul"] -= calls["grouped_matmul_bwd"]
    calls["grouped_matmul_bwd"] //= 2
    return {k: v for k, v in calls.items() if v}


def phase_family_seq_parallel(device) -> dict:
    """Every family split over the sequence, on ``gloo`` ranks of the one
    card (:func:`family_seq_rank`): a 1x2 mesh, and a 2x2 mesh for tp2d,
    whose residual's ``embed`` is split over ``data`` too; here, while the
    ranks of one mesh run, the one-rank float32 steps of the models the
    other mesh trains.  Checks, for
    each rank: the internvl2-1b, seamless-m4t-medium and (2 layers)
    qwen3-moe-30b-a3b prompt passes, under sequence_parallel on 1x2 and
    tp2d on 2x2, with finite logits at most 1.25 x as far from the float32
    prefill's as the unsharded bf16 (the MoE: plain, routing replayed)
    prefill's, every cache leaf's slice likewise, exact launches, the MoE's
    pairs routed to and kept by every expert equal to the unsharded
    pass's (summed over the ranks' blocks of the tokens; under tp2d each
    rank's slice of the experts); the steps (under tp2d the three take
    one, FAMILY_STEPS) with losses within 1e-3 relative of the one-rank steps'
    and the first gradient's norm within 2e-2, exact launches; every
    kernel call (K2, K2-bwd, K4, K4-bwd, K5, K5-bwd) of a prefill and of a
    first step held against its plain version (as many calls as the
    launches, :func:`checked_calls`), within its bound, and a 5-bit control
    rejected.  Returns the launches of rank 1 of each mesh, summed."""
    from repro_torch.launch import common
    from repro_torch.train import train_step as TS
    losses, norms, oracle_s = {}, {}, 0.0

    def oracles(shape):
        # the one-rank steps of the models another mesh's ranks train, here
        # while those ranks run (they wait on gloo more than on the card)
        nonlocal oracle_s
        t0 = time.perf_counter()
        for arch in dict.fromkeys(a for m, a, _ in FAMILY_TRAIN
                                  if tuple(m) == shape and a not in losses):
            api, tcfg, state, batches = family_train_setup(device, arch)
            step = TS.make_train_step(api, tcfg)
            losses[arch] = []
            for b in batches:
                state, m = step(state, b)
                losses[arch].append(float(m["loss"]))
                norms.setdefault(arch, float(m["grad_norm"]))
            del api, state, step, batches
            gc.collect()
            torch.cuda.empty_cache()
        oracle_s += time.perf_counter() - t0

    from repro_torch.kernels import _build
    _build.lib()                 # built once here, before the ranks load it
    results, walls = {}, {}
    for shape, other in (((2, 2), (1, 2)), ((1, 2), (2, 2))):
        started = start_ranks("--family-seq-rank", f"family-seq-{shape[0]}x{shape[1]}",
                              {"mesh": list(shape)}, world=math.prod(shape))
        results[shape], walls[shape] = finish_ranks(started, FAMILY_TIMEOUT_S,
                                                    lambda: oracles(other))
    first = next(iter(results[(1, 2)][0]["prefill"].values()))["launches"]
    zero = {k: 0 for k in list(first) + ["gemm_bwd", "grouped_matmul_bwd"]}
    layers = {arch: (n or common.launch_config(arch).n_layers) for arch, n in FAMILY_PREFILLS}
    want_prefill = {VLM_ARCH: dict(zero, flash_attention=layers[VLM_ARCH]),
                    ENCDEC_ARCH: dict(zero, flash_attention=3 * layers[ENCDEC_ARCH]),
                    MOE_ARCH: dict(zero, flash_attention=layers[MOE_ARCH],
                                   grouped_matmul=3 * layers[MOE_ARCH])}
    kept = {}
    for shape, ranks in results.items():
        for res in ranks:
            r = res["rank"]
            for arch, pre in res["prefill"].items():
                bad = []
                got = {k: pre["launches"].get(k, 0) for k in zero}
                if got != want_prefill[arch]:
                    bad.append(f"launches {pre['launches']}")
                if not (pre["finite"] and pre["within"]
                        and pre["index"] == common.launch_config(arch).frontend_len
                        * (arch == VLM_ARCH) + PROMPT):
                    bad.append("logits against the float32 prefill")
                if not all(c["within"] for c in pre["cache"].values()):
                    bad.append(f"cache {pre['cache']}")
                calls = {k: pc["calls"] for k, pc in pre["per_call"].items()}
                if calls != checked_calls(pre["launches"]):
                    bad.append(f"checked calls {calls} for launches {pre['launches']}")
                for name, pc in pre["per_call"].items():
                    if not (pc["within"] and pc["control_5_bits_rejected"]):
                        bad.append(f"{name} per call {pc}")
                if "moe" in pre:
                    kept.setdefault(shape, []).append(pre["moe"])
                if bad:
                    raise AssertionError(f"family_seq_parallel {shape} rank {r}, {arch} "
                                         f"prefill: {bad}")
            for key, tr in res["train"].items():
                arch, plan = tr["arch"], tr["plan"]
                got = [h["loss"] for h in tr["history"]]
                rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses[arch]))
                norm = abs(tr["history"][0]["grad_norm"] - norms[arch]) / norms[arch]
                tr.update(loss_rel_err_vs_one_rank=rel, grad_norm_rel_err_vs_one_rank=norm)
                bad = []
                have = {k: tr["launches"].get(k, 0) for k in zero}
                steps = FAMILY_STEPS.get((arch, plan), FAMILY_TRAIN_STEPS)
                if have != family_launches(arch, plan, zero, n=steps):
                    bad.append(f"launches {tr['launches']}")
                if rel > 1e-3 or norm > 2e-2 or not all(math.isfinite(x) for x in got):
                    bad.append(f"losses {got} against {losses[arch]}, first gradient norm "
                               f"{tr['history'][0]['grad_norm']} against {norms[arch]}")
                # the first step's calls
                calls = {k: pc["calls"] for k, pc in tr["per_call"].items()}
                if calls != checked_calls(family_launches(arch, plan, zero, n=1)):
                    bad.append(f"checked calls {calls} in the first step")
                for name, pc in tr["per_call"].items():
                    if not (pc["within"] and pc["control_5_bits_rejected"]):
                        bad.append(f"{name} per call {pc}")
                if bad:
                    raise AssertionError(f"family_seq_parallel {shape} rank {r}, {key}: {bad}")
    # the MoE's pairs routed to and kept by each expert, over the ranks, as
    # unsharded: summed over the blocks of the tokens (sequence_parallel), or
    # each rank's slice of the experts over all of them (tp2d)
    moe_ranks = kept[(1, 2)]
    for layer, want_kept in enumerate(moe_ranks[0]["unsharded_kept"]):
        for what in ("kept", "routed"):
            total = [sum(m[what][layer][e] for m in moe_ranks)
                     for e in range(len(want_kept))]
            want = moe_ranks[0][f"unsharded_{what}"][layer]
            if total != want:
                raise AssertionError(f"family_seq_parallel: layer {layer}'s pairs {what} by "
                                     f"expert over the ranks {total}, unsharded {want}")
            for m in kept[(2, 2)]:
                got = m[what][layer]
                if got != m[f"unsharded_{what}"][layer][m["e_lo"]:m["e_lo"] + len(got)] \
                        or len(got) * 2 != len(want_kept):
                    raise AssertionError(f"family_seq_parallel tp2d: layer {layer}'s pairs "
                                         f"{what} by expert {got} from expert {m['e_lo']}")
    routed = sum(sum(x) for x in moe_ranks[0]["unsharded_routed"])
    dropped = routed - sum(sum(x) for x in moe_ranks[0]["unsharded_kept"])
    emit({"phase": "family_seq_parallel", "meshes": [[1, 2], [2, 2]], "batch": BATCH,
          "prompt_len": PROMPT, "prefills": [list(p) for p in FAMILY_PREFILLS],
          "prefill_plan": {f"{s[0]}x{s[1]}": p for s, p in FAMILY_PREFILL_PLAN.items()},
          "train_steps_of": {f"{a} {p}": n for (a, p), n in FAMILY_STEPS.items()},
          "train": [[list(m), a, p] for m, a, p in FAMILY_TRAIN],
          "train_layers": FAMILY_TRAIN_LAYERS, "train_steps": FAMILY_TRAIN_STEPS,
          "one_rank_losses": losses, "one_rank_grad_norms": norms,
          "moe_pairs": {"routed": routed, "dropped": dropped,
                        "dropped_share": dropped / routed,
                        "capacity": moe_ranks[0]["capacity"],
                        "unsharded_buffer": moe_ranks[0]["unsharded_buffers"][0],
                        "rank_buffers": [m["buffers"][0] for m in moe_ranks]},
          "ranks": {f"{s[0]}x{s[1]}": v for s, v in results.items()},
          "wall_s": {f"{s[0]}x{s[1]}": v for s, v in walls.items()},
          "one_rank_oracle_s": oracle_s,
          "check": "prefill logits and every cache leaf's slice at most 1.25 x as far from "
                   "the float32 prefill's as the unsharded bf16 prefill's (the MoE: the "
                   "plain path, routing replayed); exact launches; the MoE's routed and "
                   "kept pairs by expert over the ranks equal to the unsharded pass's; "
                   "every K2, K4, K2-bwd and K4-bwd call within 2e-2 of its largest entry "
                   f"and {ATTN_REL_RMS} relative rms of its plain version, K5 within one "
                   f"bf16 step, K5-bwd within {WKV_BWD_REL_RMS}, 5-bit controls rejected; "
                   "losses within 1e-3 relative of the one-rank steps' (float32, AdamW at "
                   "1e-4), the first gradient's norm within 2e-2",
          "card": smi_line()})
    total = dict(zero)
    for shape, ranks in results.items():
        last = ranks[-1]
        for part in list(last["prefill"].values()) + list(last["train"].values()):
            for k in total:
                total[k] += part["launches"].get(k, 0)
    return total


# (arch, shape, plan, microbatches) of the dry-run cells: qwen2.5-3b's three
# under the planner's choice (megatron_tp and kv_sequence_split), and its
# train_4k under tp2d, whose products over the embed blocks are summed over
# `data`.  tp2d splits no batch, so each rank takes all 256 rows: in the
# default 4 microbatches a microbatch's float32 logits (64 x 512 x 151,936)
# do not fit the H100 beside the rest; in 8 they do, and take half the host
# work of 16 (the step is bound by the operations the host issues).  llama3-405b's tp2d
# cells run through the same command on their own: on an H100 its
# prefill_32k took 408 s (192 s a step), more than this script's time allows
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", "auto", 0),
                ("qwen2.5-3b", "prefill_32k", "auto", 0),
                ("qwen2.5-3b", "decode_32k", "auto", 0),
                ("qwen2.5-3b", "train_4k", "tp2d", 8))
DRYRUN_TIMEOUT_S = 420
# the cells that run while resilient runs (10.5 GB of the card at most,
# beside its 57 GB); the tp2d cell (50 GB) runs last, alone (beside
# mesh_serve's 22 GB it ran out of memory)
DRYRUN_BESIDE = tuple(c for c in DRYRUN_CELLS if c[2] == "auto")


def phase_dryrun(cells=DRYRUN_CELLS, beside=None, out=emit) -> dict:
    """``python -m repro_torch.launch.dryrun --arch A --shape S --mesh
    single [--plan P --microbatches M]`` for each of ``cells``, each in
    its own process (``beside``: the phase that runs meanwhile, for the
    report; ``out`` takes the JSON lines): one rank of a 256-rank no-op
    world at full width and depth (rank 0, or under a plan that splits the
    sequence the last rank along it).  Prints each row's plan, rank,
    per-device bytes, roofline
    terms, measured ms and collective bytes by kind; fails if a cell fails
    (an out-of-memory with its measured bytes), if a megatron_tp train or
    prefill cell gathers on ``model``, or if a tp2d cell gathers on ``data``
    or sums nothing there.  Returns the kernels launched in the counted
    steps, summed over the cells."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    rows, total = [], {}
    report_dir = os.path.join(ROOT, "reports", "dryrun_torch")
    for arch, shape, plan, microbatches in cells:
        t0 = time.perf_counter()
        tag = [] if plan == "auto" else ["--plan", plan, "--tag", plan]
        tag += ["--microbatches", str(microbatches)] if microbatches else []
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                            "--shape", shape, "--mesh", "single"] + tag, env=env,
                           capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
        path = os.path.join(report_dir, f"{arch}_{shape}_32x8"
                            + ("" if plan == "auto" else f"_{plan}") + ".json")
        row = json.load(open(path)) if os.path.exists(path) else {}
        if r.returncode != 0:
            out({"phase": "dryrun", "arch": arch, "cell": shape, "failed": r.returncode,
                  "per_device_bytes": row.get("per_device_bytes"), "error": row.get("error"),
                  "tail": (r.stdout + r.stderr).strip().splitlines()[-20:]})
            raise AssertionError(f"dryrun {arch} {shape} failed (exit {r.returncode})")
        rf = row["roofline"]
        for k, v in row["counted"]["by_kernel"].items():
            total[k] = total.get(k, 0) + v["launches"]
        # heads, ffn columns and vocabulary computed locally: no leaf is
        # gathered over ``model`` in a train or prefill step under megatron_tp
        gathered_model = row["collectives"]["bytes"]["all-gather"].get("model", 0.0)
        if shape != "decode_32k" and row["plan"] == "megatron_tp" and gathered_model:
            raise AssertionError(f"dryrun {shape}: {gathered_model} bytes all-gathered on "
                                 f"model under megatron_tp")
        # tp2d sums the products over the embed blocks: nothing is gathered on data
        gathered_data = row["collectives"]["bytes"]["all-gather"].get("data", 0.0)
        summed_data = row["collectives"]["bytes"]["all-reduce"].get("data", 0.0)
        if row["plan"] == "tp2d" and (gathered_data or not summed_data):
            raise AssertionError(f"dryrun {arch} {shape}: under tp2d {gathered_data} bytes "
                                 f"all-gathered and {summed_data} all-reduced on data")
        rows.append({
            "arch": arch, "shape": shape, "plan": row["plan"], "rank": row.get("rank"),
            "coords": row.get("coords"), "seconds": time.perf_counter() - t0,
            "per_device_bytes": row["per_device_bytes"], "fits_hbm": row["fits_hbm"],
            "memory_analysis": row["memory_analysis"],
            "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
            "collective_s": rf["collective_s"], "dominant": rf["dominant"],
            "bound_ms": rf["bound_s"] * 1e3, "measured_ms": row["measured_ms"],
            "roofline_fraction": rf["roofline_fraction"],
            "coll_bytes_by_kind_per_device": {k: v / row["chips"]
                                              for k, v in rf["coll_by_kind"].items()},
            "coll_bytes_by_axis_per_device": {k: v / row["chips"]
                                              for k, v in rf.get("coll_by_axis", {}).items()},
            "rank_collective_bytes": row["collectives"]["bytes"],
            "counted": {k: row["counted"][k] for k in ("torch_flops", "torch_bytes",
                                                       "kernel_flops", "kernel_bytes")},
            "launches": {k: v["launches"] for k, v in row["counted"]["by_kernel"].items()},
            "bw_fraction": rf.get("bw_fraction"), "min_stream_bytes": rf.get("min_stream_bytes"),
            "planner_ranking": [(x["plan"], x["dominant"], x["hbm_gb"])
                                for x in row["planner_ranking"]][:3]})
    out({"phase": "dryrun", "mesh": "32x8", "world": 256, "cells": rows,
          "beside": beside, "this_process_reserved_bytes": torch.cuda.memory_reserved(),
          "card": smi_line()})
    return total


# relative RMS difference a K5-bwd output may show from its plain version on
# the same inputs: both compute in float32 and round to bf16 once (1.6e-4 at
# rwkv6-3b's first step on an H100); an output with 5 mantissa bits is 9.6e-3
# off
WKV_BWD_REL_RMS = 2.0 ** -10


def first_gradients(cfg, params, batch, module, name: str, stats=None, plain_cfg=None,
                    plain_patches=(), of_largest: bool = False) -> dict:
    """Config ``cfg``'s first-step gradient three ways: through the kernels
    (every call of the backward kernel's wrapper ``module.<name>`` checked
    against ``module.<name>_plain`` into ``stats`` when given, by
    :func:`bwd_per_call`), through the plain path (``plain_cfg``, by default
    ``cfg``, with ``plain_patches``' (module, name, value) in place: for
    attention ``kernels="plain"``, dense PyTorch attention under autograd;
    for rwkv6 K5 and K5-bwd patched to their plain versions, which keeps
    the kernel path's bf16 casts of the decays and the bonus that
    ``kernels="plain"`` would drop) and in float32; the float32 rule on
    gradients (:func:`gradient_rule`), the losses, each run's gradient
    norm, the kernel run's launches and, where that kernel counts its
    bodies, its launches by body."""
    from contextlib import ExitStack

    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves
    from repro_torch.train import train_step as TS
    is_t = lambda x: isinstance(x, torch.Tensor)
    norm = lambda g: math.sqrt(sum(x.float().square().sum().item()
                                   for x in tree_leaves(g, is_leaf=is_t)))
    f32_loss, _, exact = TS.value_and_grad(
        build_model(replace(cfg, kernels="plain", compute_dtype="float32")), params, batch)
    kernel = getattr(module, name)
    checked = kernel if stats is None else bwd_per_call(
        stats, kernel, getattr(module, name + "_plain"), of_largest=of_largest)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with patched(module, name, checked):
        kern_loss, _, grads = TS.value_and_grad(build_model(cfg), params, batch)
    torch.cuda.synchronize()
    out = {"checked_grad_step_s": time.perf_counter() - t0,
           "launches": kernels.launch_counts()}
    if name in kernels.launches_by_body():
        out["bwd_body"] = kernels.launches_by_body()[name]
    kern, norms = leaf_distances(grads, exact), {"kernel": norm(grads), "float32": norm(exact)}
    del grads
    with ExitStack() as stack:
        for mod, attr, value in plain_patches:
            stack.enter_context(patched(mod, attr, value))
        plain_loss, _, grads = TS.value_and_grad(build_model(plain_cfg or cfg), params, batch)
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

    (a) The first step's gradient three ways (:func:`first_gradients`) and
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
    from repro_torch.kernels import rwkv6 as K, rwkv6_bwd as KB
    from repro_torch.launch import common, serve, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt, train_step as TS
    cfg = common.launch_config(RWKV_ARCH)
    L = cfg.n_layers
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batch = TL.to_device(source.batch_at(0, BATCH, PROMPT), device)
    plain = ((K, "wkv6", K.wkv6_plain), (KB, "wkv6_bwd", KB.wkv6_bwd_plain))
    gradients = lambda c, p, stats=None: first_gradients(
        c, p, batch, KB, "wkv6_bwd", stats, plain_patches=plain, of_largest=True)
    shallow_cfg = replace(cfg, n_layers=1)
    shallow_params = build_model(shallow_cfg).init(
        torch.Generator(device=device).manual_seed(0), device)
    shallow = gradients(shallow_cfg, shallow_params)
    del shallow_params
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stats = []
    full = gradients(cfg, params, stats)
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


# the full models' parameter counts (float32 master weights, gradient and
# two AdamW moments: 16 bytes each, 18.7 / 7.9 / 15.6 GB of training state)
FAMILY_PARAMS = {HYBRID_ARCH: 1_170_473_856, VLM_ARCH: 494_808_832,
                 ENCDEC_ARCH: 978_025_472}


def phase_gemma_train(device) -> dict:
    """gemma-7b trained at full width and 4 of its 28 layers (full depth
    needs about 137 GB of float32 weights, gradients and AdamW state): the
    first step's gradient through the kernels (K2 and K2-bwd at head dim
    256), the plain path and float32, the float32 rule on it; every K2-bwd
    call of that step against its plain version on the same inputs with a
    5-bit control that must be rejected; three AdamW steps through
    ``launch.train.run`` with exact counts (K2 twice a layer a step with
    remat, K2-bwd once, every call on the TMA + wgmma bodies), finite
    losses."""
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.launch import common, train as TL
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt, train_step as TS
    cfg = replace(common.launch_config(GEMMA_ARCH), n_layers=GEMMA_TRAIN_LAYERS)
    api = build_model(cfg)
    L = cfg.n_layers
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batch = TL.to_device(source.batch_at(0, BATCH, PROMPT), device)
    stats = []
    first = first_gradients(cfg, params, batch, FAB, "flash_attention_bwd", stats,
                            plain_cfg=replace(cfg, kernels="plain"))
    rule, per_call_body = first["gradients"], first["bwd_body"]
    per_call = summarize_per_call(stats)
    gc.collect()
    torch.cuda.empty_cache()

    steps = 3
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=steps, warmup_steps=1)
    state = TS.TrainState(params, opt.opt_init(params, tcfg))
    kernels.reset_launch_counts()
    res = TL.run(api, tcfg, steps, BATCH, PROMPT, device, state=state, log_every=1,
                 log=lambda line: None)
    launches = res.launches
    by_body = {k: kernels.launches_by_body()[k] for k in ("flash_attention",
                                                          "flash_attention_bwd")}
    want = {"gemm": 0, "flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps,
            "flash_decode": 0, "flash_decode_partials": 0, "flash_decode_combine": 0,
            "grouped_matmul": 0, "wkv6": 0, "wkv6_bwd": 0}
    # every K2 and K2-bwd call of the steps (bf16, head dim 256) on the TMA bodies
    want_body = {"flash_attention": {"tma": 2 * L * steps, "mma": 0, "f32": 0},
                 "flash_attention_bwd": {"tma": L * steps, "mma": 0, "f32": 0}}
    finite = all(math.isfinite(h[k]) for h in res.history for k in ("loss", "grad_norm"))
    emit({"phase": "gemma_train", "arch": cfg.name, "n_layers": L,
          "full_depth_layers": common.launch_config(GEMMA_ARCH).n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim_, "n_params": api.n_params(),
          "batch": BATCH, "seq": PROMPT, "compute_dtype": cfg.compute_dtype,
          "remat": cfg.remat, "optimizer": tcfg.optimizer,
          "first_step_loss": first["loss"],
          "gradients": rule, "per_call": per_call, "history": res.history,
          "step_ms": [t * 1e3 for t in res.step_s],
          "tok_per_s": [BATCH * PROMPT / t for t in res.step_s],
          "peak_bytes": res.peak_bytes, "launches": launches, "launches_by_body": by_body,
          "per_call_body": per_call_body})
    if launches != want:
        raise AssertionError(f"gemma_train: kernel launches {launches}, expected {want}")
    if by_body != want_body or per_call_body != {"tma": L, "mma": 0, "f32": 0}:
        raise AssertionError(f"gemma_train: K2 / K2-bwd launches by body {by_body} (the "
                             f"checked step's K2-bwd: {per_call_body}), expected all on the "
                             f"TMA bodies")
    if not finite:
        raise AssertionError(f"gemma_train: a loss or gradient norm is not finite: "
                             f"{res.history}")
    if not rule["within"]:
        raise AssertionError(f"gemma_train: the kernel path's gradients are further from "
                             f"float32 than the plain path allows: {rule}")
    if not per_call["within"] or per_call["calls"] != L:
        raise AssertionError(f"gemma_train: a K2-bwd call disagrees with its plain version, "
                             f"or the calls were not counted: {per_call}")
    if not per_call["control_5_bits_rejected"]:
        raise AssertionError("gemma_train: the per-call check did not reject the 5-bit "
                             "control")
    del res, state, params
    return launches


def phase_family_train(device, phase: str, arch: str) -> dict:
    """``arch`` (zamba2-1.2b, internvl2-1b or seamless-m4t-medium) trained
    at full width and depth: float32 master weights from seed 0, bf16
    compute, remat, AdamW with float32 state, ``SyntheticLM`` batches of
    4 x 512 with the stub inputs ``make_source`` gives (internvl2's 256
    patches ahead of the prompt, seamless's 1024 frames); every attention
    through K2 and its gradient through K2-bwd at head dim 64.

    (a) The first step's gradient three ways (:func:`first_gradients`)
    and the float32 rule on gradients at full depth (unlike rwkv6-3b's, these
    gradients are not chaotic there: both bf16 paths lie 0.01-0.12 from
    float32 in the worst leaf on an H100 80GB HBM3 at 700 W, so no
    shallower copy is needed).
    (b) Every K2-bwd call of the full-depth kernel run against its plain
    version on the same inputs (2e-2 and ``ATTN_REL_RMS``), as many checked
    as launched, (c) with a 5-bit control that this check must reject.
    (d) Three AdamW steps through ``launch.train.run`` with exact launch
    counts and finite losses and gradient norms, step ms, tok/s, peak bytes
    and one traced step.

    The counts: a forward pass makes A attention calls
    (``models.attention_calls``: zamba2 19 sites of its 38 Mamba2 layers,
    internvl2 24 layers, seamless 12 encoder layers and 12 decoder layers'
    self and cross passes, 36).  Remat recomputes each layer (each zamba2
    group, site included) in the backward, so K2 runs 2A times a step and
    K2-bwd A times: 114 / 57, 144 / 72 and 216 / 108 over three steps,
    every call bf16 at head dim 64 and so on the ``mma`` bodies; no other
    kernel runs (the projections and the Mamba2 scan are PyTorch)."""
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.launch import common, serve, train as TL
    from repro_torch.models import attention_calls, build_model
    from repro_torch.train import optimizer as opt, train_step as TS
    cfg = common.launch_config(arch)
    A = attention_calls(cfg)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size), cfg)
    batch = TL.to_device(source.batch_at(0, BATCH, PROMPT), device)
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stats = []
    full = first_gradients(cfg, params, batch, FAB, "flash_attention_bwd", stats,
                           plain_cfg=replace(cfg, kernels="plain"))
    per_call = summarize_per_call(stats)
    gc.collect()
    torch.cuda.empty_cache()

    steps = 3
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=steps, warmup_steps=1)
    state = TS.TrainState(params, opt.opt_init(params, tcfg))
    lines = []
    kernels.reset_launch_counts()
    res = TL.run(api, tcfg, steps, BATCH, PROMPT, device, state=state, log_every=1,
                 log=lines.append)
    launches = res.launches
    by_body = {k: kernels.launches_by_body()[k] for k in ("flash_attention",
                                                          "flash_attention_bwd")}
    zero = {name: 0 for name in launches}
    want = dict(zero, flash_attention=2 * A * steps, flash_attention_bwd=A * steps)
    want_body = {"flash_attention": {"tma": 0, "mma": 2 * A * steps, "f32": 0},
                 "flash_attention_bwd": {"tma": 0, "mma": A * steps, "f32": 0}}
    want_grad = dict(zero, flash_attention=2 * A, flash_attention_bwd=A)
    data = TL.to_device(source.batch_at(steps, BATCH, PROMPT), device)
    step_fn = TS.make_train_step(api, tcfg)
    holder = {"state": res.state}

    def one_step():
        holder["state"] = step_fn(holder["state"], data)[0]

    traced = serve._traced(one_step, device, 1)
    finite = all(math.isfinite(h[k]) for h in res.history for k in ("loss", "grad_norm"))
    n_params = api.n_params()
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_encoder_layers": cfg.n_encoder_layers, "attention_calls": A,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "head_dim": cfg.head_dim_, "frontend_len": cfg.frontend_len,
          "n_params": n_params, "batch": BATCH, "seq": PROMPT,
          "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
          "remat": cfg.remat, "optimizer": tcfg.optimizer, "load_s": load_s,
          "gradient_check": "kernel path's gradient distance from float32 (RMS relative to "
                            "each leaf's RMS) at most 1.25 x the plain path's, in the worst "
                            "leaf and over all leaves",
          "first_step": full,
          "per_call_check": f"every K2-bwd call of the step within 2e-2 and {ATTN_REL_RMS} "
                            "relative rms of its plain version on the same inputs (dq, dk, "
                            "dv); control: the outputs with 5 mantissa bits",
          "per_call": per_call, "steps": steps, "step_lines": lines,
          "history": res.history, "step_ms": [t * 1e3 for t in res.step_s],
          "tok_per_s": [BATCH * PROMPT / t for t in res.step_s],
          "peak_bytes": res.peak_bytes, "launches": launches, "launches_by_body": by_body,
          "traced_step": traced})
    if n_params != FAMILY_PARAMS[arch]:
        raise AssertionError(f"{phase}: {n_params:,} parameters, the full model has "
                             f"{FAMILY_PARAMS[arch]:,}")
    if launches != want or full["launches"] != want_grad:
        raise AssertionError(f"{phase}: kernel launches {launches} (first gradient "
                             f"{full['launches']}), expected {want} ({want_grad})")
    if by_body != want_body or full["bwd_body"] != {"tma": 0, "mma": A, "f32": 0}:
        raise AssertionError(f"{phase}: K2 / K2-bwd launches by body {by_body} (the checked "
                             f"step's K2-bwd: {full['bwd_body']}), expected all on the mma "
                             f"bodies")
    if not finite:
        raise AssertionError(f"{phase}: a loss or gradient norm is not finite: {res.history}")
    if not full["gradients"]["within"]:
        raise AssertionError(f"{phase}: the kernel path's gradients are further from float32 "
                             f"than the plain path allows: {full}")
    if not per_call["within"] or per_call["calls"] != A:
        raise AssertionError(f"{phase}: a K2-bwd call disagrees with its plain version, or "
                             f"the calls were not counted: {per_call}")
    if not per_call["control_5_bits_rejected"]:
        raise AssertionError(f"{phase}: the per-call check did not reject the 5-bit control")
    del holder, res, state, params
    return launches


# the three head-dim-64 families trained: (phase, arch)
TRAINED_FAMILIES = (("hybrid_train", HYBRID_ARCH), ("vlm_train", VLM_ARCH),
                    ("encdec_train", ENCDEC_ARCH))


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
# every kernel is on a main path: the reference's two decode functions run
# where a cache is split over ranks (mesh_serve), ``ops.flash_decode``
# computes both in one launch elsewhere
OFF_MAIN_PATH = ()
# the TMA bodies of K2, K2-bwd and K3, compiled at head dim 256 only (their
# mangled names carry no head dim): every aligned bf16 call of gemma-7b
D256_TMA_BODIES = ("flash_fwd_tma_kernel", "flash_bwd_dq_tma_kernel", "flash_bwd_dkv_tma_kernel",
                   "decode_tma_kernel")
# the bodies instantiated at head dim 256 (gemma-7b)
D256_BODIES = ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel", "decode_mma_kernel",
               "decode_f32_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel",
               "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel") + D256_TMA_BODIES
# the bodies redesigned last: their registers and spills go in the build line
REDESIGNED = ("decode_mma_kernel", "decode_f32_kernel", "wkv6_kernel", "flash_bwd_dq_mma_kernel",
              "flash_bwd_dkv_mma_kernel", "wkv6_bwd_kernel", "decode_combine_kernel") \
    + D256_TMA_BODIES
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
    # the head-dim-256 instantiations of K2, K3 (and its partials epilogue)
    # and K2-bwd, and the TMA bodies of K2, K2-bwd and K3: registers and
    # spilled bytes of each
    d256 = {k: v for k, v in ptxas.items()
            if "Li256E" in k or any(b in k for b in D256_TMA_BODIES)}
    occupancy = _build.lib().repro_flash_decode_tma_occupancy()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled_here": bool(info.get("built")), "library": info.get("path"),
          "sources": [p.name for p in _build.sources()], "ptxas": ptxas,
          "redesigned": redesigned, "head_dim_256": d256,
          "decode_tma_blocks_per_sm": occupancy})
    if info.get("built") and not all(any(b in k for k in d256) for b in D256_BODIES):
        raise AssertionError(f"a head-dim-256 body was not compiled: {sorted(d256)}")
    tma_spills = {k: v for k, v in ptxas.items()
                  if any(b in k for b in D256_TMA_BODIES + ("decode_combine_kernel",))
                  and v.get("spill_bytes")}
    if tma_spills:
        raise AssertionError(f"a TMA body of K2, K2-bwd or K3, or K3', spills: {tma_spills}")
    from repro_torch.kernels import flash_decode as FD
    if occupancy != FD.TMA_BLOCKS_PER_SM:
        raise AssertionError(f"K3's TMA body holds {occupancy} blocks an SM, not "
                             f"{FD.TMA_BLOCKS_PER_SM}")
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
    serve_launches, served, chunked_launches = phase_serve(device)
    lap("serve")
    by_path = {"serve": serve_launches, "chunked_prefill": chunked_launches}

    def beside_mesh_serve():
        # the other served models, then two phases whose gloo ranks share the
        # card with mesh_serve's (about 60 GB of it together): mesh_serve's
        # ranks wait on gloo more than on the card; its lap is the wait
        # after these
        lap("mesh_serve_start")
        gc.collect()
        torch.cuda.empty_cache()                # the dense model's weights go first
        by_path["rwkv"] = phase_rwkv(device)
        lap("rwkv")
        # the head-dim-64 families: prompt passes through K2 and decode-step
        # attentions through K3 (zamba2: 19 shared-attention sites; internvl2:
        # 24 layers; seamless: 12 encoder + 12 decoder self + 12 cross passes,
        # 12 self + 12 cross a step)
        for phase, arch, passes, per_step in (("hybrid", HYBRID_ARCH, 19, 19),
                                              ("vlm", VLM_ARCH, 24, 24),
                                              ("encdec", ENCDEC_ARCH, 36, 24)):
            gc.collect()
            torch.cuda.empty_cache()            # the last model's weights go first
            by_path[phase] = phase_attention_family(device, phase, arch, passes, per_step)
            lap(phase)
        gc.collect()
        torch.cuda.empty_cache()
        by_path["gemma"] = phase_gemma(device)
        lap("gemma")
        for name, phase in (("seq_parallel", phase_seq_parallel),
                            ("recurrent_parallel", phase_recurrent_parallel)):
            gc.collect()
            torch.cuda.empty_cache()
            by_path[name] = phase(device)
            lap(name)
        # the head-dim-64 families trained at full width and depth (peaks
        # under 30 GB, below what seq_parallel's ranks took here)
        for phase, arch in TRAINED_FAMILIES:
            gc.collect()
            torch.cuda.empty_cache()
            by_path[phase] = phase_family_train(device, phase, arch)
            lap(phase)
    beside_mesh_serve.phases = ["rwkv", "hybrid", "vlm", "encdec", "gemma", "seq_parallel",
                                "recurrent_parallel"] + [phase for phase, _ in TRAINED_FAMILIES]
    gc.collect()
    torch.cuda.empty_cache()
    by_path["mesh_serve"] = phase_mesh_serve(device, served, beside_mesh_serve)
    lap("mesh_serve")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["serve_obs"] = phase_serve_obs(served)
    lap("serve_obs")
    phase_tenants()
    lap("tenants")
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, moe_by_body, by_path["moe_chunked"] = phase_moe(device)
    by_path["moe"] = moe_launches
    lap("moe")
    # training last: every served model's weights go first
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train"], uninterrupted = phase_train(device)
    lap("train")
    gc.collect()
    torch.cuda.empty_cache()
    # the dry run's smaller cells, each a process of its own, and the
    # examples' processes (small models, and the CPU's warm sweep) while
    # resilient's restores wait on the disk here (its training captures
    # this process's output: their lines are printed after it)
    held = []
    examples = start_examples()
    try:
        by_path["resilient"], by_path["dryrun"] = beside(
            lambda: phase_resilient(device, uninterrupted),
            lambda: phase_dryrun(DRYRUN_BESIDE, beside="resilient", out=held.append))
    except BaseException:
        stop_examples(examples)
        raise
    for line in held:
        emit(line)
    lap("resilient")
    launched = finish_examples(examples)
    by_path["example_serve"], by_path["example_train"] = (launched["serve_decode"],
                                                          launched["train_lm"])
    lap("examples")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["moe_train"], moe_train_loss = phase_moe_train(device)
    lap("moe_train")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["rwkv_train"] = phase_rwkv_train(device)
    lap("rwkv_train")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["gemma_train"] = phase_gemma_train(device)
    lap("gemma_train")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["mesh_train"] = phase_mesh_train(device, uninterrupted["losses"], moe_train_loss,
                                             by_path["moe_train"]["grouped_matmul_bwd"])
    lap("mesh_train")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["family_seq_parallel"] = phase_family_seq_parallel(device)
    lap("family_seq_parallel")
    # the tp2d dry-run cell (50 GB) last, its process beside this one's
    # wait, and meanwhile the chunked prompt's two gloo ranks (about 20 GB)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["mesh_chunked"], rest = phase_mesh_chunked(
        served, lambda: phase_dryrun(tuple(c for c in DRYRUN_CELLS if c not in DRYRUN_BESIDE)))
    by_path["dryrun"] = {k: by_path["dryrun"].get(k, 0) + rest.get(k, 0)
                         for k in set(by_path["dryrun"]) | set(rest)}
    lap("dryrun")
    emit({"phase_seconds": seconds})
    by_path["planner"] = {"gemm_bwd": gemm_bwd_launches}

    launches = dict(serve_launches, gemm=gemm_launches,
                    flash_decode_partials=by_path["mesh_serve"]["flash_decode_partials"],
                    flash_decode_combine=by_path["mesh_serve"]["flash_decode_combine"],
                    grouped_matmul=moe_launches["grouped_matmul"],
                    wkv6=by_path["rwkv"]["wkv6"],
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
                {k: x[k] for k in ("model", "shape", "q_offset", "from_state", "block", "body",
                                   "kernel_ms",
                                   "staged_ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "max_abs_err", "host_us", "staged_host_us",
                                   "mma_host_us")
                 if k in x}
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
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-serve-rank":
        mesh_serve_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-chunk-rank":
        mesh_chunk_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "--seq-parallel-rank":
        seq_parallel_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "--recurrent-parallel-rank":
        recurrent_parallel_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "--family-seq-rank":
        family_seq_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
