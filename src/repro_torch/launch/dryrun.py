"""Cluster dry run: one rank's program of a plan-sharded step, run and
measured on one card.

Counterpart of ``repro/launch/dryrun.py``, which compiles each (arch x
shape x mesh) cell for 512 fake TPU devices and reads XLA's memory and cost
analyses.  The port compiles nothing, so its counterpart of the fake
devices is **one rank's local program, run once**, in a process whose
default process group is torch's no-op ``fake`` backend at the cell's world
size (256 ranks for ``32x8``, 512 for ``2x32x8``).  The rank is 0, but
under a plan that splits the sequence of a train or prefill cell
(``train_step.seq_split_axis``), where rank 0 holds the first tokens and
does the least causal attention, it is the last rank along that axis (the
row's ``rank``).  The state, the parameters and the cache are allocated at
that rank's local shapes only (never a global tree: llama3-405b has 405 B
parameters), from the plan's Shardings, and filled from a
``torch.Generator``.

**Collectives move nothing** in such a world: every all-gather,
all-reduce and reduce-scatter completes at once and leaves its output as
the backend leaves it.  Values after one mean nothing, so nothing on this
path branches on a value or checks finiteness, and no shape depends on one
(the MoE's capacity is static).  Times measured here therefore exclude
communication; the collective term comes only from the bytes counted.

For each cell, under ``--plan auto`` the plan the mesh planner ranks first
on ``lower_torch.h100_cluster`` (or a named plan):

* train: ``train_step.jit_train_step``; prefill: ``api.logits_fn`` inside
  the plan's step (parameters gathered a layer at a time, the batch's rows
  this rank's, and its block of the tokens under a sequence split);
  decode: ``serve_step.jit_serve_step`` against a cache
  whose every position but the last is filled (``index`` = seq_len - 1);
* one step under counting (a ``FlopCounterMode`` for the plain PyTorch
  operations' flops, a dispatch mode for their bytes, each kernel launch's
  work from ``kernels.work``, each collective's bytes by kind and mesh axis
  from ``parallel.spmd``), which is also the warm-up; then one step timed
  with CUDA events (``measured_ms``) with the peak memory reset before it;
* the row: the reference's keys (``planner_ranking``, ``tileloom_view``,
  ``roofline`` with, for decode, ``min_stream_bytes`` / ``bw_fraction``
  over the global parameter and cache bytes) plus ``hw`` (the cluster's
  name), ``measured_ms`` and the counts, written under
  ``reports/dryrun_torch/``.

Memory (``memory_analysis``, the reference's keys filled with what is
measured on the card): ``argument_size_in_bytes`` the bytes of the step's
inputs (this rank's state or parameters, batch or tokens, cache);
``output_size_in_bytes`` the bytes of its outputs; ``alias_size_in_bytes``
those outputs that are inputs updated in place (the train state, the
cache); ``temp_size_in_bytes`` the measured peak above the memory held
when the step starts; ``generated_code_size_in_bytes`` None.
``per_device_bytes`` is ``torch.cuda.max_memory_allocated()`` over the
timed step, after a reset; ``fits_hbm`` compares it with the cluster's HBM
(80 GB).  A CUDA out-of-memory is reported: the row records ``fits_hbm``
false with the error and the bytes measured, and the process exits
non-zero.  On the CPU (``--device cpu``, the tests) nothing is measured:
``per_device_bytes``, ``fits_hbm`` and ``measured_ms`` are None.

Run one cell:     python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
                      --shape decode_32k --mesh single
Run all cells:    python -m repro_torch.launch.dryrun --all   (each cell in
                  a fresh process)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
MESHES = {False: ("32x8", ("data", "model"), (32, 8)),
          True: ("2x32x8", ("pod", "data", "model"), (2, 32, 8))}


def _train_cfg(arch: str):
    from repro_torch.configs.base import TrainConfig
    if arch in ("llama3-405b",):
        return TrainConfig(optimizer="adafactor", opt_state_dtype="bfloat16",
                           microbatches=64)
    if arch in ("deepseek-67b",):
        return TrainConfig(opt_state_dtype="bfloat16", microbatches=8)
    return TrainConfig(microbatches=4)


# ------------------------------------------------------------ the fake world
def fake_world(world: int, rank: int = 0) -> None:
    """A default process group of ``world`` ranks on torch's no-op ``fake``
    backend, this process ``rank``: every collective completes without
    moving data."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the dry run makes its "
                           "own no-op world")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def world_mesh(axis_names, sizes, rank: int = 0):
    """``rank``'s Mesh over the default (fake) group, with a process group
    for every set of axes."""
    from repro_torch.launch.mesh import _axis_groups
    from repro_torch.parallel.sharding import Mesh
    mesh = Mesh(tuple(axis_names), tuple(sizes), rank=rank)
    mesh.groups.update(_axis_groups(mesh))
    return mesh


# ------------------------------------------------------------- local state
def _local(shaped: torch.Tensor, sharding, gen: torch.Generator, device, fill: str,
           vocab: int = 0) -> torch.Tensor:
    """A tensor at ``sharding``'s local shape of the global ``shaped``
    (meta), filled from ``gen``: ``normal`` (x 0.02), ``tokens`` (ids below
    ``vocab``) or ``zeros``."""
    shape = sharding.local_shape(tuple(shaped.shape)) if sharding is not None \
        else tuple(shaped.shape)
    if fill == "tokens":
        return torch.randint(0, vocab, shape, generator=gen, device=device,
                             dtype=shaped.dtype)
    out = torch.zeros(shape, dtype=shaped.dtype, device=device)
    if fill == "normal" and out.is_floating_point():
        out.normal_(0.0, 0.02, generator=gen)
    return out


def _local_tree(abstract, shardings, gen, device, fill):
    from repro_torch.parallel.sharding import is_sharding_leaf, tree_map_axes
    return tree_map_axes(lambda sh, x: None if x is None else _local(x, sh, gen, device, fill),
                         shardings, abstract, is_leaf=is_sharding_leaf)


def _nbytes(tree) -> int:
    """Bytes of every tensor in a tree (dicts, dataclasses, NamedTuples)."""
    from repro_torch.ckpt.checkpoint import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------- counting
def _moves_bytes(func) -> bool:
    """Whether an operation reads or writes tensor data: not a view, not an
    allocation, not a collective (those are counted on their own)."""
    name = str(func)
    if name.startswith(("c10d.", "aten.empty", "aten.new_empty")):
        return False
    rets = func._schema.returns
    return not (bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                                   for r in rets))


def _data_bytes(t: torch.Tensor) -> int:
    return 0 if t.device.type == "meta" else t.numel() * t.element_size()


class _ByteCounter:
    """A dispatch mode that adds the bytes of the tensor inputs and outputs
    of every PyTorch operation that moves data (:func:`_moves_bytes`), on a
    device (``meta`` tensors hold none); an embedding lookup reads only the
    rows it returns."""

    def __new__(cls):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.bytes = 0.0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if str(func) == "aten.embedding.default":
                    # reads the rows it returns, not the table
                    self.bytes += 2 * _data_bytes(out) + _data_bytes(args[1])
                elif _moves_bytes(func):
                    from torch.utils._pytree import tree_leaves
                    self.bytes += sum(_data_bytes(t) for t in tree_leaves((args, kwargs, out))
                                      if isinstance(t, torch.Tensor))
                return out

        return Mode()


@contextlib.contextmanager
def counting():
    """Everything one step does: yields a dict filled on the way out with
    ``torch_flops`` / ``torch_bytes`` (plain PyTorch operations),
    ``kernel_flops`` / ``kernel_bytes`` / ``by_kernel`` (hand-written kernel
    launches) and ``collectives`` (spmd's tally)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import work
    from repro_torch.parallel import spmd
    out: Dict[str, Any] = {}
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with work.counting() as kernels, spmd.counting_collectives() as coll, flops, nbytes:
        yield out
    out.update(torch_flops=float(flops.get_total_flops()), torch_bytes=nbytes.bytes,
               kernel_flops=kernels.flops, kernel_bytes=kernels.bytes,
               by_kernel=kernels.by_kernel, collectives=coll)


# -------------------------------------------------------------------- cells
def _choose_plan(ranked, plan_name: str, api, shape):
    from repro_torch.parallel import planner_bridge as PB, sharding as SH
    if plan_name == "auto":
        chosen = ranked[0]
        if not chosen.cost.feasible:
            raise RuntimeError(
                f"no feasible plan for {api.cfg.name}/{shape.name}: "
                + "; ".join(f"{r.plan.name}:{r.notes}" for r in ranked))
        return chosen.plan
    if plan_name in SH.FIXED_PLANS:
        return SH.FIXED_PLANS[plan_name]()
    for p in [r.plan for r in ranked] + PB.candidate_plans(api.cfg, shape):
        if p.name == plan_name:
            return p
    raise ValueError(f"unknown plan {plan_name!r}")


def measured_rank(api, shape, plan, axis_names, sizes) -> int:
    """The rank a cell measures: the last along the sequence axis where the
    plan splits a train or prefill cell's sequence (its queries see the most
    keys), else 0."""
    import numpy as np

    from repro_torch.parallel.sharding import Mesh
    from repro_torch.train.train_step import seq_split_axis
    mesh = Mesh(tuple(axis_names), tuple(sizes))
    ax = seq_split_axis(api, plan, mesh, shape.seq_len) if shape.kind != "decode" else None
    if ax is None:
        return 0
    coords = [mesh.shape[a] - 1 if a == ax else 0 for a in mesh.axis_names]
    return int(np.ravel_multi_index(coords, mesh.sizes))


def _build_step(api, tcfg, shape, plan, mesh, gen, device):
    """The cell's step as a closure over the measured rank's local inputs,
    with the bytes of its arguments, outputs and aliased outputs."""
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import part_axes
    from repro_torch.train import serve_step as SS, train_step as TS
    cfg = api.cfg
    specs = api.input_specs(shape)
    if shape.kind == "train":
        sh = TS.state_shardings(api, tcfg, plan, mesh)
        abstract = TS.abstract_state(api, tcfg)
        state = TS.TrainState(
            _local_tree(abstract.params, sh.params, gen, device, "normal"),
            _local_tree(abstract.opt_state, sh.opt_state, gen, device, "zeros"),
            None if abstract.residual is None else
            _local_tree(abstract.residual, sh.residual, gen, device, "zeros"))
        b_sh = TS.batch_shardings(specs, plan, mesh)
        batch = {k: _local(v, b_sh[k], gen, device,
                           "tokens" if not v.is_floating_point() else "normal", cfg.vocab_size)
                 for k, v in specs.items()}
        rows = batch["tokens"].shape[0]
        if rows % tcfg.microbatches:
            tcfg = dataclasses.replace(tcfg, microbatches=math.gcd(rows, tcfg.microbatches))
        step = TS.jit_train_step(api, tcfg, plan, mesh, specs)
        holder = {"state": state}

        def run():
            holder["state"], metrics = step(holder["state"], batch)
            return metrics
        args = _nbytes(state) + _nbytes(batch)
        return run, args, _nbytes(state), _nbytes(state), tcfg
    p_sh = SS.param_shardings(api, plan, mesh)
    params = _local_tree(api.abstract_params(), p_sh, gen, device, "normal")
    if shape.kind == "prefill":
        b_sh = TS.batch_shardings(specs, plan, mesh)
        batch = {k: _local(v, b_sh[k], gen, device,
                           "tokens" if not v.is_floating_point() else "normal", cfg.vocab_size)
                 for k, v in specs.items()}
        placements = TS.param_placements(api, plan, mesh)
        axes = api.param_axes()
        seq = TS.seq_split_axis(api, plan, mesh, shape.seq_len)
        block = seq if api.block_inputs else None

        def local_step():
            local, batch_part = TS.local_batch(batch, specs, plan, mesh, block)
            return local, spmd.Step(plan, mesh, batch_part, local["tokens"].shape[0],
                                    local=api.local_compute, seq_axis=seq)

        @torch.no_grad()
        def run():
            local, step = local_step()
            with spmd.step_context(step):
                return api.logits_fn(spmd.serving_params(params, axes, placements), local)
        # the rank's rows and the positions of its block that reach the head;
        # a vocabulary-local head leaves each rank its block of the logits
        local, step = local_step()
        B = local["tokens"].shape[0]
        with spmd.step_context(step):
            S = api.head_positions(local["tokens"].shape[1])
        batch_part = step.batch_part
        tp = spmd.local_axis_of(plan, mesh, part_axes(batch_part)) \
            if api.local_compute else None
        head = p_sh["embed"]["table"].spec[:1] if cfg.tie_embeddings \
            else p_sh["lm_head"]["w"].spec[1:2]
        vocab = cfg.padded_vocab // (mesh.shape[tp] if tp and tuple(head) == (tp,) else 1)
        logits = B * S * vocab * torch.empty((), dtype=_cdtype(cfg)).element_size()
        return run, _nbytes(params) + _nbytes(batch), logits, 0, tcfg
    # decode
    c_sh = SS.cache_shardings(api, specs["cache"], plan, mesh)
    cache = {k: (shape.seq_len - 1 if k == "index" else
                 _local(v, c_sh[k], gen, device, "normal"))
             for k, v in specs["cache"].items()}
    tokens_shape = tuple(specs["tokens"].shape)
    t_sh = SS.token_sharding(plan, mesh, tokens_shape)
    tokens = _local(specs["tokens"], t_sh, gen, device, "tokens", cfg.vocab_size)
    step = SS.jit_serve_step(api, plan, mesh, specs["cache"], tokens_shape=tokens_shape)
    start = dict(cache)

    def run():
        # every step decodes the same last position of a full cache
        logits, _ = step(params, tokens, dict(start))
        return logits
    logits = tokens_shape[0] * cfg.padded_vocab * \
        torch.empty((), dtype=_cdtype(cfg)).element_size()
    return run, _nbytes(params) + _nbytes(cache) + _nbytes(tokens), \
        logits + _nbytes(cache), _nbytes(cache), tcfg


def _cdtype(cfg):
    from repro_torch.models.layers import cdtype
    return cdtype(cfg)


def _timed(run, device) -> Optional[float]:
    """Milliseconds of one call on the card (CUDA events), None on the CPU."""
    if device.type != "cuda":
        run()
        return None
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             plan_name: str = "auto", out_dir: Path = REPORT_DIR,
             *, microbatches: int = 0, grad_compression: str = "",
             remat: str = "", tag: str = "", device: str = "cuda") -> dict:
    """Run one cell as rank 0 of its fake world and write its row.  The
    process must not hold a process group already; it holds the fake one
    afterwards."""
    from repro_torch.configs import registry
    from repro_torch.core.lower_torch import h100_cluster
    from repro_torch.models import build_model
    from repro_torch.models.api import require_device
    from repro_torch.models.param import tree_leaves
    from repro_torch.parallel.planner_bridge import plan_mesh, tileloom_view
    from . import roofline as RL

    dev = require_device(device)
    # the kernel path, as launch.common.launch_config gives it
    cfg = dataclasses.replace(registry.get_config(arch), kernels="cuda")
    shape = registry.get_shape(shape_name)
    skip = registry.cell_skip_reason(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "skipped": skip}
    tcfg = _train_cfg(arch)
    if microbatches:
        tcfg = dataclasses.replace(tcfg, microbatches=microbatches)
    if grad_compression:
        tcfg = dataclasses.replace(tcfg, grad_compression=grad_compression)
    if remat:
        cfg = dataclasses.replace(cfg, remat=(remat != "off"))
    api = build_model(cfg)
    mesh_name, axis_names, sizes = MESHES[multi_pod]
    chips = math.prod(sizes)
    hw = h100_cluster(pods=2 if multi_pod else 1)

    t0 = time.perf_counter()
    ranked = plan_mesh(api, shape, tcfg, multi_pod=multi_pod)
    plan = _choose_plan(ranked, plan_name, api, shape)
    rank = measured_rank(api, shape, plan, axis_names, sizes)
    fake_world(chips, rank)
    mesh = world_mesh(axis_names, sizes, rank)
    gen = torch.Generator(device=dev).manual_seed(0)
    row: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "chips": chips, "plan": plan.name, "hw": hw.name,
                           "device": str(dev), "rank": rank, "coords": mesh.coords()}
    row["planner_ranking"] = [
        {"plan": r.plan.name, "total_s": r.cost.total_s, "dominant": r.cost.dominant,
         "feasible": r.cost.feasible, "hbm_gb": round(r.cost.hbm_bytes_per_chip / 1e9, 2),
         "notes": r.notes}
        for r in ranked]
    row["tileloom_view"] = tileloom_view(plan, cfg)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    try:
        run, args_b, out_b, alias_b, tcfg = _build_step(api, tcfg, shape, plan, mesh, gen, dev)
        with counting() as counts:
            run()
        compile_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        measured_ms = _timed(run, dev)
    except torch.cuda.OutOfMemoryError as err:
        peak = torch.cuda.max_memory_allocated(dev)
        row.update(per_device_bytes=peak, fits_hbm=False,
                   error=f"{type(err).__name__}: {str(err).splitlines()[0]}",
                   memory_analysis=None)
        _write(row, out_dir, arch, shape_name, mesh_name, tag)
        print(f"[dryrun] {arch} {shape_name} {mesh_name} plan={plan.name} OUT OF MEMORY at "
              f"{peak / 1e9:.2f} GB measured: {row['error']}")
        raise
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        temp_b = peak - before
        per_device = peak - held
    else:
        temp_b = per_device = None
    mem_row = {"argument_size_in_bytes": args_b, "output_size_in_bytes": out_b,
               "temp_size_in_bytes": temp_b, "generated_code_size_in_bytes": None,
               "alias_size_in_bytes": alias_b}
    coll = counts["collectives"]
    flops = counts["torch_flops"] + counts["kernel_flops"]
    byts = counts["torch_bytes"] + counts["kernel_bytes"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = RL.model_flops_estimate(api.n_active_params(), tokens, shape.kind == "train")
    report = RL.from_counts(arch, shape_name, mesh_name, chips, flops, byts, coll.by_kind(),
                            coll.by_axis(), coll.counts, mf, hw=hw,
                            measured_s=None if measured_ms is None else measured_ms / 1e3)
    row.update({
        "compile_s": round(compile_s, 2), "memory_analysis": mem_row,
        "per_device_bytes": per_device,
        "fits_hbm": None if per_device is None else per_device <= hw.local_mem.size_bytes,
        "roofline": report.row(), "measured_ms": measured_ms,
        "counted": {k: counts[k] for k in ("torch_flops", "torch_bytes", "kernel_flops",
                                           "kernel_bytes", "by_kernel")},
        "collectives": {"bytes": coll.bytes, "counts": coll.counts},
        "microbatches": tcfg.microbatches if shape.kind == "train" else None,
    })
    if shape.kind == "decode":
        is_t = lambda x: isinstance(x, torch.Tensor)
        pbytes = sum(l.numel() * l.element_size()
                     for l in tree_leaves(api.abstract_params(), is_leaf=is_t))
        cbytes = sum(l.numel() * l.element_size()
                     for l in api.input_specs(shape)["cache"].values() if is_t(l))
        row["roofline"]["min_stream_bytes"] = float(pbytes + cbytes)
        row["roofline"]["bw_fraction"] = float((pbytes + cbytes) / max(report.hlo_bytes, 1.0))
    _write(row, out_dir, arch, shape_name, mesh_name, tag)
    gb = "not measured" if per_device is None else f"{per_device / 1e9:.2f}GB"
    ms = "not measured" if measured_ms is None else f"{measured_ms:.2f}ms"
    print(f"[dryrun] {arch} {shape_name} {mesh_name} plan={plan.name} rank={rank} "
          f"setup={compile_s:.1f}s per_device={gb} dominant={report.dominant} "
          f"roofline_frac={report.roofline_fraction:.3f} measured={ms} "
          f"bound={report.bound_s * 1e3:.2f}ms")
    print(f"  terms: compute={report.compute_s:.4e}s memory={report.memory_s:.4e}s "
          f"collective={report.collective_s:.4e}s")
    print(f"  memory_analysis: {mem_row}")
    print(f"  counted: flops={flops:.3e} bytes={byts:.3e} (per device; kernels "
          f"{counts['kernel_flops']:.3e} flops)")
    print(f"  collectives: { {k: f'{v / 1e6:.1f}MB' for k, v in coll.by_kind().items() if v} }")
    return row


def _write(row: dict, out_dir: Path, arch: str, shape_name: str, mesh_name: str,
           tag: str) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    (out_dir / f"{arch}_{shape_name}_{mesh_name}{suffix}.json").write_text(
        json.dumps(row, indent=2, default=str))


def run_all(meshes=("single", "multi"), archs=None, shapes=None,
            timeout: int = 1800, device: str = "cuda") -> int:
    """Every cell, each in a fresh process; returns the number that failed
    (an error or an out-of-memory)."""
    from repro_torch.configs.registry import cells
    failures = []
    todo = []
    for cfg, shape, _ in cells():
        if archs and cfg.name not in archs:
            continue
        if shapes and shape.name not in shapes:
            continue
        for m in meshes:
            todo.append((cfg.name, shape.name, m))
    print(f"[dryrun] {len(todo)} cells to run")
    for arch, shp, m in todo:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shp, "--mesh", m, "--device", device]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
            code, text = r.returncode, r.stdout + r.stderr
        except subprocess.TimeoutExpired as err:
            code, text = -1, f"timed out after {timeout} s: {err}"
        tail = text.strip().splitlines()
        if code != 0:
            failures.append((arch, shp, m, "\n".join(tail[-15:])))
            print(f"FAIL {arch} {shp} {m}")
        else:
            for line in tail:
                if line.startswith("[dryrun]"):
                    print(line)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for arch, shp, m, msg in failures:
            print(f"--- {arch} {shp} {m}\n{msg}\n")
    else:
        print("\nALL CELLS RAN")
    return len(failures)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--plan", default="auto")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--grad-compression", default="")
    ap.add_argument("--remat", default="")
    ap.add_argument("--tag", default="")
    ap.add_argument("--archs", nargs="*")
    ap.add_argument("--shapes", nargs="*")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a card) or cpu")
    args = ap.parse_args()
    if args.all:
        sys.exit(run_all(archs=args.archs, shapes=args.shapes, device=args.device))
    try:
        row = run_cell(args.arch, args.shape, args.mesh == "multi", args.plan,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression,
                       remat=args.remat, tag=args.tag, device=args.device)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    if row.get("skipped"):
        print(f"[dryrun] SKIP {args.arch} {args.shape}: {row['skipped']}")


if __name__ == "__main__":
    main()
