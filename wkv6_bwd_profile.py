#!/usr/bin/env python3
"""Where a chunk step of the K5-bwd kernel spends its cycles, on one card.

    python3 wkv6_bwd_profile.py

Copies ``src/repro_torch`` into ``build/wkv6_bwd_profile/src`` and adds to
that copy's ``csrc/wkv6_bwd.cu`` a ``clock64()`` mark after each phase of
the two sweeps: threads 0 and 96 of block 0 add the cycles since their last
mark to a ``__device__`` array, which an extra C function reads back.  Then
it builds the copy in a fresh process, runs the kernel once at rwkv6-3b's
training pass (160 rows, T 512, d 64, chunk 16) in bf16 and in float32, and
prints one JSON line each: the cycles a chunk step of each phase, in the
order they run, for both threads, the kernel's median time over 10 single
launches (the L2 flushed before each; the marks slow it a little) and the
same time for this checkout's kernel without marks; then the card's name,
power limit and clocks.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
COPY = os.path.join(HERE, "build", "wkv6_bwd_profile")

# (text of a line in the kernel, mark in sweep 1, mark in sweep 2, phase
# name); a mark follows its line
ANCHORS = [
    ('asm volatile("cp.async.wait_group 0;', 0, 16, "wait for the chunk's loads"),
    ("const float el = scan(", 1, 17, "sync, decay scan, conversions"),
    ("inter_partial(Xb", 2, 18, "sync, products dO S0^T / v G1^T over J"),
    ("pair_partials(Xb", 3, 19, "pair partials"),
    ("cluster_arrive();", 4, None, "cluster barrier: arrive (release)"),
    ("state_update(st, el, KC, VJ);", 5, None, "state update S"),
    ("cluster_wait();", 6, None, "cluster barrier: wait"),
    ("cluster.sync();", None, 20, "cluster barrier"),
    ("if (n + 1 < NC) fetch", 7, None, "fetch the next chunk"),
    ("if (n > 0) fetch", None, 21, "fetch the next chunk"),
    ("state_update(st, el, A, DOJ);", None, 22, "stage G1, state update G"),
    ("fold_pairs(xb", 8, 23, "fold the pair sums"),
    ("fold_inter(xb, inter);", 9, 24, "fold the owned channels' products"),
    ("const float last = LASTO[ec], mid = 0.5f * last, uu = UO[ec];", 10, 25,
     "sync (sweep 2: and dv)"),
    ("float ia = sa, ib = sb;", None, 26, "epilogue dk, du"),
    ("xb ^= 1;", 11, 27, "epilogue (sweep 1: dr, r dr'; sweep 2: dlog_w)"),
]
BEFORE = ("const float last = LASTO", "float ia = sa", "xb ^= 1;")


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "src", "repro_torch"),
                    os.path.join(COPY, "src", "repro_torch"))
    path = os.path.join(COPY, "src", "repro_torch", "kernels", "csrc", "wkv6_bwd.cu")
    lines = open(path).read().split("\n")
    out, sweep, found = [], 1, set()
    for line in lines:
        if "sweep 2: backward over the chunks" in line:
            sweep = 2
        mark = None
        for text, m1, m2, _ in ANCHORS:
            m = m1 if sweep == 1 else m2
            if text in line and m is not None and "auto " not in line:
                mark = m
                found.add((text, sweep))
        before = mark is not None and any(b in line for b in BEFORE)
        if before:
            out.append(f"    WKVB_MARK({mark});")
        out.append(line)
        if mark is not None and not before:
            out.append(f"    WKVB_MARK({mark});")
        if "const int ch = j0 + ec;" in line:
            out.append("  unsigned long long prev = clock64();")
    want = {(t, 1) for t, m1, _, _ in ANCHORS if m1 is not None} | \
        {(t, 2) for t, _, m2, _ in ANCHORS if m2 is not None}
    if want - found:
        raise SystemExit(f"wkv6_bwd_profile: the kernel no longer has {sorted(want - found)}")
    src = "\n".join(out).replace("namespace cg = cooperative_groups;", """namespace cg = cooperative_groups;
__device__ unsigned long long wkvb_prof[128];
#define WKVB_MARK(i) if (blockIdx.x == 0 && (tid == 0 || tid == 96)) { \\
    unsigned long long now = clock64(); wkvb_prof[(tid ? 64 : 0) + (i)] += now - prev; prev = now; }""", 1)
    src += """
extern "C" int repro_wkvb_prof(void* out, int reset) {
  static unsigned long long zeros[128] = {0};
  if (reset) return (int)cudaMemcpyToSymbol(repro::wkvb_prof, zeros, sizeof(zeros));
  return (int)cudaMemcpyFromSymbol(out, repro::wkvb_prof, sizeof(zeros));
}
"""
    open(path, "w").write(src)


def run(tree: str, marks: bool) -> None:
    import ctypes
    import statistics
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(tree, "build", "kernels")
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from repro_torch.kernels import _build, rwkv6_bwd as KB
    lib = _build.lib()
    if marks:
        lib.repro_wkvb_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    BH, T, d, c = 160, 512, 64, 16
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    names = {1: {}, 2: {}}
    for text, m1, m2, name in ANCHORS:
        for sweep, m in ((1, m1), (2, m2)):
            if m is not None:
                names[sweep][m] = name
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v, do = (torch.randn(BH, T, d, generator=gen, device=dev) for _ in range(4))
        lw = (-torch.exp(torch.randn(BH, T, d, generator=gen, device=dev))).clamp(min=-4.0)
        u = torch.randn(BH, d, generator=gen, device=dev) * 0.5
        args = [x.to(dtype) for x in (r, k, v, lw, u, do)]
        KB.wkv6_bwd(*args, chunk=c)
        times = []
        for _ in range(10):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            KB.wkv6_bwd(*args, chunk=c)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        res = {"marks": marks, "dtype": str(dtype).replace("torch.", ""),
               "shape": [BH, T, d, c], "ms": statistics.median(times)}
        if marks:
            lib.repro_wkvb_prof(None, 1)
            KB.wkv6_bwd(*args, chunk=c)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 128)()
            lib.repro_wkvb_prof(ctypes.addressof(buf), 0)
            chunks = T // c
            for thread, at in (("thread 0", 0), ("thread 96", 64)):
                res[thread] = {f"sweep {sw}": [[m, names[sw][m], round(buf[at + m] / chunks)]
                                               for m in sorted(names[sw])]
                               for sw in (1, 2)}
            res["cycles_a_chunk_thread_0"] = round(sum(buf[:64]) / chunks)
        print(json.dumps(res), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        run(argv[1], argv[2] == "1")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("wkv6_bwd_profile: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    make_copy()
    for tree, marks in ((COPY, "1"), (HERE, "0")):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", tree, marks],
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(done.stdout)
        if done.returncode:
            sys.stderr.write(done.stderr[-4000:])
            return done.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
