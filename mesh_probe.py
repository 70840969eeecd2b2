#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives two ranks sharing one GPU can run.

    python3 mesh_probe.py

Starts two processes on card 0, first with the ``nccl`` backend, then with
``gloo``, each joined through a ``file://`` store under ``build/`` (no port)
and a 60 s process-group timeout, and tries ``all_reduce``, ``all_gather``,
``broadcast``, ``reduce_scatter_tensor`` and ``all_to_all_single`` on CUDA
tensors, each result checked against its value; the ``gloo`` ranks also time
an ``all_gather`` of 64 MiB a rank on the card and on the host (the rates
two ranks on one card get).
Then one process probes torch's no-op ``fake`` backend (what
``repro_torch.launch.dryrun`` runs in): whether it exists, and whether the
five collectives and ``new_group`` complete on CUDA tensors as rank 0 of a
world of 256, with what an ``all_gather``'s output holds afterwards.
Prints one JSON line a backend, ``{collective: "ok" | error text}``, then
the card's name and power limit.  Every process it starts is joined or
killed before it exits.
"""
import datetime
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def child(backend: str, store: str, rank: int) -> None:
    import torch
    import torch.distributed as dist
    out = {}
    try:
        dist.init_process_group(backend, init_method="file://" + store, rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=60))
    except Exception as err:  # noqa: BLE001 - the outcome is what is reported
        print(json.dumps({"init": repr(err)[:300]}), flush=True)
        return
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cases = {
        "all_reduce": lambda: _all_reduce(dist, torch, dev, rank),
        "all_gather": lambda: _all_gather(dist, torch, dev, rank),
        "broadcast": lambda: _broadcast(dist, torch, dev, rank),
        "reduce_scatter_tensor": lambda: _reduce_scatter(dist, torch, dev, rank),
        "all_to_all_single": lambda: _all_to_all(dist, torch, dev, rank),
    }
    for name, fn in cases.items():
        try:
            out[name] = "ok" if fn() else "wrong result"
        except Exception as err:  # noqa: BLE001
            out[name] = repr(err)[:300]
    if backend == "gloo":
        for key, where in (("all_gather_64MiB_GBps", dev),
                           ("all_gather_64MiB_GBps_host_tensors", torch.device("cpu"))):
            try:
                out[key] = _gather_rate(dist, torch, where)
            except Exception as err:  # noqa: BLE001
                out[key] = repr(err)[:300]
    print(json.dumps(out), flush=True)
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


def _all_reduce(dist, torch, dev, rank):
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return bool((x == 3).all())


def _all_gather(dist, torch, dev, rank):
    parts = [torch.empty(2, device=dev) for _ in range(2)]
    dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
    torch.cuda.synchronize()
    return bool((parts[0] == 0).all() and (parts[1] == 1).all())


def _broadcast(dist, torch, dev, rank):
    x = torch.full((3,), 7.0 if rank == 0 else 0.0, device=dev)
    dist.broadcast(x, src=0)
    torch.cuda.synchronize()
    return bool((x == 7).all())


def _reduce_scatter(dist, torch, dev, rank):
    out = torch.empty(2, device=dev)
    dist.reduce_scatter_tensor(out, torch.arange(4.0, device=dev))
    torch.cuda.synchronize()
    return bool((out == 2 * torch.arange(2.0 * rank, 2.0 * rank + 2, device=dev)).all())


def _all_to_all(dist, torch, dev, rank):
    out = torch.empty(2, device=dev)
    dist.all_to_all_single(out, torch.tensor([10.0 * rank, 10.0 * rank + 1], device=dev))
    torch.cuda.synchronize()
    return bool((out == torch.tensor([float(rank), 10.0 + rank], device=dev)).all())


def _gather_rate(dist, torch, dev, mib: int = 64, reps: int = 3):
    """GB/s of gathered output (both ranks' parts) of an all_gather of
    ``mib`` MiB of bf16 a rank on ``dev``, the best of ``reps``."""
    x = torch.ones(mib * 2 ** 19, dtype=torch.bfloat16, device=dev)
    parts = [torch.empty_like(x) for _ in range(2)]
    best = None
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_gather(parts, x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return 2 * x.numel() * x.element_size() / best / 1e9


def fake_child() -> None:
    """Rank 0 of a 256-rank world on the ``fake`` backend, on card 0."""
    import torch
    import torch.distributed as dist
    out = {}
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    except Exception as err:  # noqa: BLE001
        print(json.dumps({"init": repr(err)[:300]}), flush=True)
        return
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    group = dist.new_group(list(range(0, 256, 8)))
    n = dist.get_world_size(group)

    def gather():
        parts = [torch.full((2,), -5.0, device=dev) for _ in range(n)]
        dist.all_gather(parts, torch.full((2,), 3.0, device=dev), group=group)
        torch.cuda.synchronize()
        held = sorted({float(p[0]) for p in parts})
        out["all_gather_outputs_hold"] = held
        return True

    cases = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(4, device=dev), group=group) or True,
        "all_gather": gather,
        "broadcast": lambda: dist.broadcast(torch.ones(4, device=dev), src=0) or True,
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=dev), torch.ones(2 * n, device=dev), group=group) or True,
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(n, device=dev), torch.ones(n, device=dev), group=group) or True,
    }
    out["new_group_size"] = n
    for name, fn in cases.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as err:  # noqa: BLE001
            out[name] = repr(err)[:300]
    out["world"] = dist.get_world_size()
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_probe: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for backend in ("nccl", "gloo"):
        store = os.path.join(ROOT, "build", f"probe-store-{backend}-{os.getpid()}")
        procs = [subprocess.Popen([sys.executable, __file__, "--child", backend, store, str(r)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        t0, outs = time.time(), []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, 150 - (time.time() - t0))))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        results = []
        for p, (so, se) in zip(procs, outs):
            lines = [l for l in so.splitlines() if l.startswith("{")]
            results.append(json.loads(lines[-1]) if lines else
                           {"exit": p.returncode, "stderr": se[-300:]})
        print(json.dumps({"backend": backend, "ranks_on_card_0": 2, "rank_results": results}),
              flush=True)
    p = subprocess.Popen([sys.executable, __file__, "--fake"], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        so, se = p.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        p.kill()
        so, se = p.communicate()
    lines = [l for l in so.splitlines() if l.startswith("{")]
    print(json.dumps({"backend": "fake", "torch": torch.__version__,
                      "result": json.loads(lines[-1]) if lines else
                      {"exit": p.returncode, "stderr": se[-300:]}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    elif len(sys.argv) > 1 and sys.argv[1] == "--fake":
        fake_child()
    else:
        sys.exit(main())
