#!/usr/bin/env python3
"""Per-leaf gradient of one plan-sharded step against the unsharded step, on
two ``gloo`` ranks of one machine.

    python3 grad_probe.py DEVICE ARCH PLAN LAYERS DTYPE KERNELS [SEQ]

DEVICE is ``cuda`` (both ranks on card 0: ``gloo`` carries CUDA tensors) or
``cpu`` (the reduced config); ARCH a config name at full width and LAYERS
layers; PLAN a fixed plan (``megatron_tp``, ``sequence_parallel``, ...) or
``zero3_sp``; DTYPE the compute dtype; KERNELS ``cuda`` or ``plain``; SEQ
the tokens a row (64), 4 rows.  Each rank draws the same seed-0 train state,
computes the unsharded gradient (``train_step.value_and_grad``) and its
part of the plan-sharded one (``train_step.accumulate_grad`` inside the
plan's ``spmd.Step``, heads, ffn columns and vocabulary local where the
plan allows), and rank 0 prints one JSON line: the unsharded gradient's
global norm and, for every leaf, the relative error of its shard
(``|g - w| / |w|``) with the two norms.  It tells a conditioning property
of a model apart from a fault of the sharded step: the error of a fault
does not shrink in float32.
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch  # noqa: E402


def plan_named(name):
    from repro_torch.parallel import planner_bridge as PB, sharding as SH
    if name == "zero3_sp":
        return PB._rename(PB._zero3().with_rule("seq", "model").with_rule("kv_seq", "model"),
                          "zero3_sp")
    return SH.FIXED_PLANS[name]()


def rank_main(store, rank, device, arch, plan_name, layers, dtype, kernels, seq):
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as C
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as SH, spmd
    from repro_torch.train import train_step as TS
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
        mesh = make_host_mesh(1, 2, device_type=device)
        cfg = get_config(arch)
        cfg = cfg.reduced(n_layers=layers) if device == "cpu" else replace(cfg, n_layers=layers)
        api = build_model(replace(cfg, compute_dtype=dtype, kernels=kernels))
        tcfg = TrainConfig()
        state = TS.init_state(api, tcfg, device=dev)
        source = make_source(DataConfig(vocab_size=api.cfg.vocab_size), api.cfg)
        batch = TL.to_device(source.batch_at(0, 4, seq), dev)
        _, _, want = TS.value_and_grad(api, state.params, batch)
        plan = plan_named(plan_name)
        placements = TS.param_placements(api, plan, mesh)
        st_sh = TS.state_shardings(api, tcfg, plan, mesh)
        local_params = TS.place_tree(state.params, st_sh.params,
                                     TS.abstract_state(api, tcfg).params)
        ax = TS.seq_split_axis(api, plan, mesh, seq)
        local, part = TS.local_batch(batch, None, plan, mesh, ax)
        step = spmd.Step(plan, mesh, part, local["tokens"].shape[0], local=True, seq_axis=ax)
        with spmd.step_context(step):
            grads = TS.zero_grads(local_params)
            TS.accumulate_grad(api, local_params, local, grads, placements,
                               1.0 / step.loss_shards)
        sh = dict(C._flatten_with_paths(st_sh.params,
                                        is_leaf=lambda x: isinstance(x, SH.Sharding)))
        got = dict(C._flatten_with_paths(grads))
        leaves, total = {}, 0.0
        for k, w in C._flatten_with_paths(want):
            total += float(w.float().norm()) ** 2
            g, w = got[k].float(), sh[k].local(w).float()
            leaves[k] = [((g - w).norm() / w.norm().clamp(min=1e-30)).item(),
                         g.norm().item(), w.norm().item()]
        if rank == 0:
            print(json.dumps({"device": device, "arch": arch, "plan": plan_name,
                              "layers": layers, "dtype": dtype, "kernels": kernels, "seq": seq,
                              "unsharded_norm": total ** 0.5, "leaves": leaves}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    if argv[0] == "--rank":
        store, rank, device, arch, plan, layers, dtype, kernels, seq = argv[1:10]
        rank_main(store, int(rank), device, arch, plan, int(layers), dtype, kernels, int(seq))
        return 0
    if len(argv) not in (6, 7):
        print(__doc__, file=sys.stderr)
        return 2
    seq = argv[6] if len(argv) == 7 else "64"
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", store,
                               str(r), *argv[:6], seq]) for r in range(2)]
    try:
        return max(p.wait(timeout=600) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
