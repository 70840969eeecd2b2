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
* ``families``: each case by its ``kind``: ``local`` as the mode above
  (with the first step's gradients), ``moe`` (``moe.moe_mlp`` alone on the
  rank's block of the case's input, :func:`run_moe_case`) or ``forward``
  (the model's logits and loss under the plan's step, :func:`run_forward_case`);
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


def run_case(job, case, mesh, grads=None):
    """The case's train steps; with ``grads`` (a list) the first step's
    gradients (this rank's shards, before the optimizer) appended to it."""
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
    from repro_torch.train import optimizer as opt
    kernels.reset_launch_counts()
    moe.EP_TRACE = []
    history = []
    update = opt.opt_update

    def recorded(g, *a, **k):
        if grads is not None and not grads:
            grads.append({n: t.clone() for n, t in C._flatten_with_paths(g)})
        return update(g, *a, **k)
    opt.opt_update = recorded
    try:
        for b in batches[:case["steps"]]:
            state, m = step(state, b)
            history.append({k: float(v) for k, v in m.items()})
    finally:
        opt.opt_update = update
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
    grads = []
    with spmd.counting_collectives() as tally:
        api, tcfg, plan, state, history, _ = run_case(job, case, mesh, grads)
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
    return {"history": history, "state": state, "coords": mesh.coords(), "grads": grads[0],
            "gathered": tally.bytes["all-gather"], "reduced": tally.bytes["all-reduce"],
            "scattered": tally.bytes["reduce-scatter"],
            "prefill_logits": logits, "cache_index": cache["index"], "q_offsets": offsets,
            "cache": {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}}


def _block_of(mesh, plan, x, seq_len, block_inputs=True):
    """This rank's rows of ``x`` (B, L, ...) under ``plan``'s batch split and,
    where the plan splits a sequence of ``seq_len`` over ``model``, its
    block along dim 1; the Step's batch entry and the sequence axis."""
    from repro_torch.parallel import spmd
    spec = TS.batch_shardings({"t": torch.empty(x.shape[:2], device="meta")}, plan,
                              mesh)["t"].spec
    seq = spmd.seq_axis_of(plan, mesh, seq_len)
    x = SH.Sharding(mesh, SH.P(spec[0], seq if block_inputs else None)).local(x)
    return x, spec[0], seq


def whole_ranks_offsets(expert_idx, rows, cfg):
    """A wrong ``moe._queue_offsets`` (a test must catch it): the global
    queue ordered rank by rank, every pair of an earlier rank (in the mesh's
    rank order) ahead of this rank's, instead of interleaving the ranks'
    blocks inside each batch row."""
    from repro_torch.parallel import spmd
    E, T = cfg.n_experts, expert_idx.shape[0]
    e = expert_idx.long()
    row = (torch.arange(T) // (T // rows))[:, None].expand_as(e)
    flat = (row * E + e).reshape(-1)
    counts = torch.zeros(rows * E, dtype=torch.int32).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32)).view(rows, E)
    every = spmd.gather_counts(counts).long()               # (B_g, R, E)
    R = every.shape[1]
    per_rank = every.view(-1, rows, R, E).sum(dim=1)        # (batch shards, R, E)
    step = spmd.current()
    g = spmd.batch_row0(rows) // rows
    r = spmd.axis_index(step.seq_axis) if step.seq_axis else 0
    ahead = per_rank.reshape(-1, E)[:g * R + r].sum(dim=0)
    return ahead[e.reshape(-1)]


def run_moe_case(job, case, mesh):
    """``moe.moe_mlp`` alone on this rank's block of the case's input under
    the case's plan: its output block, the kept (token, slot) pairs and the
    buffers of every dispatch, the collectives, and the router's gradient
    of the objective ``sum(y * c) + aux`` (each rank back-propagates its
    block's part times the ranks, plus aux, over the ranks, as the step
    does; the gradients summed over the ranks); with ``"pin": "whole_ranks"``
    the queue offsets of :func:`whole_ranks_offsets`."""
    from repro_torch.parallel import spmd
    data = torch.load(os.path.join(job["dir"], case["data"]),
                      map_location=job.get("device", "cpu"))
    cfg = model(case["arch"], job.get("kernels"), **case.get("reduced", {})).cfg
    plan = plan_named(case["plan"])
    S = data["x"].shape[1]
    x, batch_part, seq = _block_of(mesh, plan, data["x"], S)
    c, _, _ = _block_of(mesh, plan, data["c"], S)
    p = {k: v.clone().requires_grad_() for k, v in data["p"].items()}
    step = spmd.Step(plan, mesh, batch_part, x.shape[0], seq_axis=seq)
    right = moe._queue_offsets
    if case.get("pin") == "whole_ranks":
        moe._queue_offsets = whole_ranks_offsets
    moe.DISPATCH_TRACE = []
    try:
        with spmd.counting_collectives() as tally, spmd.step_context(step):
            y, aux = moe.moe_mlp(p, x, cfg)
            share = step.loss_shards * torch.sum(y * c) + aux
            (share / step.loss_shards).backward()
            grad = spmd.reduce_over(p["router"].grad, mesh, step.reduce_axes)
    finally:
        moe._queue_offsets = right
        trace, moe.DISPATCH_TRACE = moe.DISPATCH_TRACE, None
    return {"y": y.detach(), "aux": float(aux), "router_grad": grad, "coords": mesh.coords(),
            "keep": [t["keep"] for t in trace], "buffers": [t["buffer"] for t in trace],
            "gathered": tally.bytes["all-gather"], "reduced": tally.bytes["all-reduce"]}


def run_forward_case(job, case, mesh):
    """The case's model forward (``api.logits_fn``) and loss under a step of
    the case's plan, from whole parameters and a whole batch handed over as
    a train step hands them; with ``"pin": "cross_block"`` the
    encoder-decoder's cross-attention attends over the rank's memory block
    only (a wrong rule a test must catch).  Also the mean over the ranks
    of each rank's own mean loss (where every rank holds labels)."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import spmd
    api = model(case["arch"], job.get("kernels"), **case.get("reduced", {}))
    if case.get("dtype"):
        from dataclasses import replace
        api = build_model(replace(api.cfg, compute_dtype=case["dtype"]))
    data = torch.load(os.path.join(job["dir"], case["data"]),
                      map_location=job.get("device", "cpu"))
    plan = plan_named(case["plan"])
    batch = data["batch"]
    seq = TS.seq_split_axis(api, plan, mesh, batch["tokens"].shape[1])
    local, batch_part = TS.local_batch(batch, None, plan, mesh,
                                       seq if api.block_inputs else None)
    step = spmd.Step(plan, mesh, batch_part, local["tokens"].shape[0], seq_axis=seq)
    attention, gather = L.attention, spmd.gather_seq

    def cross_block(p, x, cfg, **k):
        if k.get("kv_input") is None:
            return attention(p, x, cfg, **k)
        spmd.gather_seq = lambda t, dim, keep=None: t
        try:
            return attention(p, x, cfg, **k)
        finally:
            spmd.gather_seq = gather
    if case.get("pin") == "cross_block":
        L.attention = cross_block
    try:
        with torch.no_grad(), spmd.step_context(step):
            logits = api.logits_fn(data["params"], local)
            loss = step.batch_mean(api.loss_fn(data["params"], local)[0])
            means = None
            if api.cfg.family == "vlm" and seq is not None:
                from repro_torch.models import vlm
                t0, t1 = vlm._text_rows(local["patches"].shape[1], local["labels"].shape[1])
                own = L.softmax_xent(logits, local["labels"][:, t0:t1]) if t1 > t0 \
                    else torch.tensor(float("nan"))
                means = step.batch_mean(own)          # nan where a rank holds no text
    finally:
        L.attention = attention
    return {"logits": logits, "loss": float(loss), "coords": mesh.coords(), "seq": seq,
            "mean_of_means": None if means is None else float(means)}


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
        elif job["mode"] == "families":
            run = {"local": run_local_case, "moe": run_moe_case, "forward": run_forward_case}
            for case in job["cases"]:
                with whole_path(case):
                    res = run[case["kind"]](job, case, mesh)
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
