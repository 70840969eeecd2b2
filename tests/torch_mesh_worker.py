"""One rank of a multi-rank CPU run of the port's plan-sharded training
(``tests/test_torch_mesh_train.py`` starts one process per rank):

    python tests/torch_mesh_worker.py JOB.json RANK

It joins a ``gloo`` process group through a ``file://`` store (no network,
no port), builds the job's host mesh on the job's device (the CPU, or with
``"device": "cuda"`` every rank on card 0: ``gloo`` carries CUDA tensors,
NCCL refuses two ranks on one card) and runs the job's cases:

* ``train``: each case's initial state (``state.pt``, whole) through
  ``train_step.jit_train_step`` over the job's batches; writes the losses,
  gradient norms, the MoE's expert-parallel dispatches and this rank's
  shards to ``<out>/<case>.rank<r>.pt``; then checks DTensor's placement
  of a few leaves against the port's slices;
* ``save``: one step of the first case, then ``CheckpointManager.save_sharded``;
* ``restore``: ``restore(shardings=)`` of that checkpoint onto this mesh;
* a case with ``"local_compute": false`` runs the whole-activation path
  (``ModelAPI.local_compute`` and ``ModelAPI.sequence_split`` false while
  it runs); a case's ``"reduced"`` overrides the reduced config's sizes;
  ``"columns": "contiguous"`` makes Mamba2's head-local path read the
  rank's contiguous block of ``in_proj`` (a wrong rule a test must catch);
* ``local``: each case's training steps as ``train`` does, with the
  collectives counted (``spmd.counting_collectives``: bytes by kind and
  mesh axis), then one multi-token prefill pass of the case's prompt (and its
  frontend input) through ``serve_step.jit_serve_step`` into an empty cache
  (the head-, ffn- and vocab-local path, or the sequence-split one under
  a plan that splits the sequence), with K2's query offsets recorded;
  writes the losses, this rank's shards, the counts and the prefill's
  logits, cache slice and offsets;
* ``serve``: each case's decode steps through ``serve_step.jit_serve_step``
  from the job's prefilled cache (whole) and weights (whole), teacher-forced
  on the job's ids; or, where the job's data holds a ``prompt`` (and its
  frontend ``inputs``), from its empty cache after the prompt pass through
  the same step (its logits and this rank's cache slice kept; with
  ``"gather_cross": true`` the encoder-decoder's prompt pass is not handed
  the cross K/V it projected whole and reads the split cache's instead);
  writes each step's logits, this rank's final cache slice and how often
  each decode function ran (``ops.flash_decode``,
  ``ops.flash_decode_partials``, ``flash_decode.combine_partials``) to
  ``<out>/<case>.rank<r>.pt``.

Only ``repro_torch`` is imported: the test holds the results against the
reference and the unsharded step.
"""
import contextlib
import datetime
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.ckpt import checkpoint as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402


JOIN_S = 240


def spawn(job: dict, tmp_path: Path) -> None:
    """Start one process per rank of ``job["mesh"]`` and join them with a
    timeout (a hang fails the caller); raises with a rank's output when one
    fails.  The job's files go to ``tmp_path``."""
    job = dict(job, dir=str(tmp_path), store=str(tmp_path / f"store-{job['mode']}"),
               world=math.prod(job["mesh"]))
    path = tmp_path / f"job-{job['mode']}.json"
    path.write_text(json.dumps(job))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(path), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(job["world"])]
    try:
        outs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def plan_named(name: str) -> SH.ShardingPlan:
    from repro_torch.parallel import planner_bridge as PB
    if name in SH.FIXED_PLANS:
        return SH.FIXED_PLANS[name]()
    derived = {
        "zero3": PB._zero3,
        "zero3_sp": lambda: PB._rename(PB._zero3().with_rule("seq", "model")
                                       .with_rule("kv_seq", "model"), "zero3_sp"),
        "tp2d": PB._tp2d,
        "expert_parallel_zero3": lambda: PB._rename(
            SH.expert_parallel_plan().with_rule("embed", "data"), "expert_parallel_zero3"),
        "kv_sequence_split": lambda: PB._rename(_kv_split(), "kv_sequence_split"),
        "kv_split_zero3": lambda: PB._rename(_kv_split().with_rule("embed", "data"),
                                             "kv_split_zero3"),
    }
    return derived[name]()


def _kv_split() -> SH.ShardingPlan:
    """The decode candidates' sequence-split KV plan (``planner_bridge.
    candidate_plans``): megatron TP, ``kv_seq`` over ``model``, no head
    rules."""
    return SH.megatron_tp_plan().with_rule("kv_seq", "model") \
        .with_rule("kv_heads", None).with_rule("q_heads", None)


def model(arch: str, kernels=None, **reduced):
    """The reduced config (``reduced``: overrides of its sizes) computing in
    float32 (``kernels`` as the job says: ``cuda`` for the card's kernels,
    else the config's own)."""
    from dataclasses import replace
    cfg = replace(get_config(arch).reduced(**reduced), compute_dtype="float32")
    return build_model(replace(cfg, kernels=kernels) if kernels else cfg)


@contextlib.contextmanager
def mamba_columns(case):
    """With ``"columns": "contiguous"`` in the case: Mamba2's head-local
    path reads the rank's contiguous block of ``in_proj``'s columns (and of
    the conv's channels), as many as its heads need, in place of its heads'
    own (a wrong rule that a test must catch)."""
    if case.get("columns") != "contiguous":
        yield
        return
    from repro_torch.models import mamba2
    right = mamba2.mamba2_head_columns

    def contiguous(cfg, h0, hn):
        cols, ch = right(cfg, h0, hn)
        d_inner, H, dh, ds = mamba2.dims(cfg)
        ranks = H // hn
        n, c = 2 * d_inner + 2 * ds + H, d_inner + 2 * ds
        return ((h0 // hn * (n // ranks) + torch.arange(len(cols))) % n,
                (h0 // hn * (c // ranks) + torch.arange(len(ch))) % c)

    mamba2.mamba2_head_columns = contiguous
    try:
        yield
    finally:
        mamba2.mamba2_head_columns = right


@contextlib.contextmanager
def whole_path(case):
    """With ``"local_compute": false`` in the case: the whole-activation
    path while it runs, every head, ffn and vocabulary leaf gathered for use
    and the sequence whole, as in a family without local or sequence-split
    rules."""
    if case.get("local_compute") is not False:
        yield
        return
    from repro_torch.models.api import ModelAPI
    saved = ModelAPI.local_compute, ModelAPI.sequence_split
    ModelAPI.local_compute = ModelAPI.sequence_split = property(lambda self: False)
    try:
        yield
    finally:
        ModelAPI.local_compute, ModelAPI.sequence_split = saved


def run_case(job, case, mesh):
    api = model(case["arch"], job.get("kernels"), **case.get("reduced", {}))
    tcfg = TrainConfig(**dict(job["tcfg"], **case.get("tcfg", {})))
    plan = plan_named(case["plan"])
    device = job.get("device", "cpu")
    state = torch.load(os.path.join(job["dir"], case["state"]), weights_only=False,
                       map_location=device)
    batches = torch.load(os.path.join(job["dir"], case.get("batches", "batches.pt")),
                         map_location=device)
    step = TS.jit_train_step(api, tcfg, plan, mesh, batches[0])
    from repro_torch import kernels
    kernels.reset_launch_counts()
    moe.EP_TRACE = []
    history = []
    for b in batches[:case["steps"]]:
        state, m = step(state, b)
        history.append({k: float(v) for k, v in m.items()})
    trace, moe.EP_TRACE = moe.EP_TRACE, None
    return api, tcfg, plan, state, history, trace


def check_dtensor(mesh, api, tcfg, plan):
    """DTensor's local chunk equals the port's slice wherever placements
    exist (every spec of this plan's state on this mesh)."""
    from torch.distributed.tensor import distribute_tensor
    sh = TS.state_shardings(api, tcfg, plan, mesh)
    shapes = dict(C._flatten_with_paths(TS.abstract_state(api, tcfg)))
    device = mesh.device_mesh.device_type
    n = 0
    for k, s in C._flatten_with_paths(sh, is_leaf=lambda x: isinstance(x, SH.Sharding)):
        placements = s.placements()
        if placements is None:
            continue
        full = torch.arange(shapes[k].numel(), dtype=torch.float32,
                            device=device).view(shapes[k].shape)
        local = distribute_tensor(full, mesh.device_mesh, placements).to_local()
        assert torch.equal(local, s.local(full)), (k, s.spec)
        n += 1
    return n


def run_local_case(job, case, mesh):
    """``case``'s train steps under a collective tally, then one prefill
    pass of the job's prompt (whole) through the plan-sharded serve step."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import spmd
    from repro_torch.train import serve_step as SS
    with spmd.counting_collectives() as tally:
        api, tcfg, plan, state, history, _ = run_case(job, case, mesh)
    device = job.get("device", "cpu")
    inputs = dict(torch.load(os.path.join(job["dir"], case.get("prompt", "prompt.pt")),
                             map_location=device))
    prompt = inputs.pop("tokens")
    params = torch.load(os.path.join(job["dir"], case["state"]), weights_only=False,
                        map_location=device).params
    cache = api.init_cache(api.cfg, prompt.shape[0], api.prefix_len() + prompt.shape[1] + 4,
                           dtype=torch.float32, device=device)
    abstract = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in cache.items() if isinstance(v, torch.Tensor)}
    step = SS.jit_serve_step(api, plan, mesh, abstract, tokens_shape=tuple(prompt.shape))
    offsets, attention = [], ops.attention

    def recorded(*a, **k):
        offsets.append(k.get("q_offset", 0))
        return attention(*a, **k)
    ops.attention = recorded
    try:
        logits, cache = step(params, prompt, cache, **inputs)
    finally:
        ops.attention = attention
    return {"history": history, "state": state, "coords": mesh.coords(),
            "gathered": tally.bytes["all-gather"], "reduced": tally.bytes["all-reduce"],
            "scattered": tally.bytes["reduce-scatter"],
            "prefill_logits": logits, "cache_index": cache["index"], "q_offsets": offsets,
            "cache": {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}}


def run_serve_case(job, case, mesh):
    from repro_torch.kernels import ops
    from repro_torch.train import serve_step as SS
    api = model(case["arch"], job.get("kernels"), **case.get("reduced", {}))
    device = job.get("device", "cpu")
    data = torch.load(os.path.join(job["dir"], case["data"]), weights_only=False,
                      map_location=device)
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models import encdec
    project = encdec._project_cross
    where = {"flash_decode": ops, "flash_decode_partials": ops, "combine_partials": FD}
    calls = {name: 0 for name in where}

    def counted(name):
        fn = getattr(where[name], name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    saved = {name: getattr(where[name], name) for name in calls}
    for name in calls:
        setattr(where[name], name, counted(name))
    sm_count = FD.sm_count
    if "sm_count" in job:
        # split the local keys as a card with this many SMs would
        FD.sm_count = lambda device: job["sm_count"]
    from repro_torch import kernels
    kernels.reset_launch_counts()
    try:
        cache = data["cache"]
        abstract = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in cache.items() if isinstance(v, torch.Tensor)}
        step = SS.jit_serve_step(api, plan_named(case["plan"]), mesh, abstract,
                                 tokens_shape=tuple(data["ids"][0].shape))
        prefill = None
        if case.get("gather_cross"):
            encdec._project_cross = lambda *a, **k: (project(*a, **k)[0], None)
        if "prompt" in data:
            first, cache = step(data["params"], data["prompt"], cache, **data.get("inputs", {}))
            prefill = {"logits": first, "index": cache["index"],
                       "cache": {k: v.clone() for k, v in cache.items()
                                 if isinstance(v, torch.Tensor)}}
        logits = []
        for ids in data["ids"]:
            out, cache = step(data["params"], ids, cache)
            logits.append(out)
    finally:
        for name, fn in saved.items():
            setattr(where[name], name, fn)
        FD.sm_count = sm_count
        encdec._project_cross = project
    return {"logits": logits, "prefill": prefill,
            "cache": {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)},
            "index": cache["index"], "calls": calls,
            "launches": kernels.launch_counts(), "coords": mesh.coords()}


def main():
    job = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=job["world"], timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(*job["mesh"], device_type=job.get("device", "cpu"))
        out = job["dir"]
        if job["mode"] == "train":
            for case in job["cases"]:
                with whole_path(case):
                    api, tcfg, plan, state, history, trace = run_case(job, case, mesh)
                from repro_torch import kernels
                launches = kernels.launch_counts()
                checked = check_dtensor(mesh, api, tcfg, plan)
                torch.save({"history": history, "ep_trace": trace, "state": state,
                            "launches": launches,
                            "coords": mesh.coords(), "dtensor_checked": checked},
                           os.path.join(out, f"{case['name']}.rank{rank}.pt"))
        elif job["mode"] == "local":
            for case in job["cases"]:
                with whole_path(case), mamba_columns(case):
                    res = run_local_case(job, case, mesh)
                torch.save(res, os.path.join(out, f"{case['name']}.rank{rank}.pt"))
        elif job["mode"] == "serve":
            for case in job["cases"]:
                torch.save(run_serve_case(job, case, mesh),
                           os.path.join(out, f"{case['name']}.rank{rank}.pt"))
        elif job["mode"] == "save":
            case = job["cases"][0]
            api, tcfg, plan, state, history, _ = run_case(job, case, mesh)
            mgr = CheckpointManager(job["ckpt"], async_save=False)
            mgr.save_sharded(state, TS.state_shardings(api, tcfg, plan, mesh), step=1)
            torch.save({"state": state, "coords": mesh.coords()},
                       os.path.join(out, f"saved.rank{rank}.pt"))
        elif job["mode"] == "restore":
            case = job["cases"][0]
            api, tcfg = model(case["arch"]), TrainConfig(**job["tcfg"])
            sh = TS.state_shardings(api, tcfg, plan_named(case["plan"]), mesh)
            state, step = CheckpointManager(job["ckpt"]).restore_latest(
                target_tree=TS.abstract_state(api, tcfg), shardings=sh, device="cpu")
            torch.save({"state": state, "step": step, "coords": mesh.coords()},
                       os.path.join(out, f"restored.rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
