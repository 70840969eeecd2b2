#!/usr/bin/env python3
"""Where a chunked prompt into a cache split over ``kv_seq`` departs from
the same chunks into a whole cache, and why.

    python3 fold_probe.py          # one H100; prints one JSON line

``qwen2.5-3b`` at full width and depth with seeded weights, as
``chip_smoke.py``'s ``mesh_chunked`` runs it: two ``gloo`` ranks of card 0
under kv_sequence_split, the 512-token prompt in chunks of 256, 128 and 128
into a cache of 640 positions (blocks [0, 320) and [320, 640)).  Each rank
runs the chunks three times through ``serve_step.jit_serve_step``:

* ``k2``: as the port runs them, each block's rows through K2, whose bf16
  output K3' folds over the ranks;
* ``plain_bf16``: every attention through K2's plain version (float32
  inside), the blocks' outputs rounded to bf16 before the fold, as K2's are;
* ``plain_float32``: the same, the blocks' outputs handed to the fold in
  float32, so that the only rounding is the fold's own.

Each rank also runs the chunks into a whole cache on its own, through the
kernels and with every attention through K2's plain version.  The line
gives, for each rank, variant and chunk, the largest difference of the last
token's logits and of the rank's cache block (K and V) and how many of the
block's elements differ: ``k2`` against the kernel run, the two plain
variants against the plain run.  Where the rounding before the fold is what
separates the split pass from the whole one, ``plain_float32`` is
bit-equal where ``plain_bf16`` is not.  Then the card's name and power
limit.  Every process it starts is joined or killed before it exits.
"""
import datetime
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 600
VARIANTS = ("k2", "plain_bf16", "plain_float32")


def _plain(float32: bool):
    """``ops.attention``'s stand-in: K2's plain version; with ``float32``
    a call that returns its log-sum-exp (a block's rows, folded later)
    computes from float32 inputs and returns its output unrounded."""
    from repro_torch.kernels import flash_attention as FA

    def attention(q, k, v, **kw):
        if float32 and kw.get("return_lse"):
            return FA.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        return FA.flash_attention_plain(q, k, v, **kw)
    return attention


def _diff(got: dict, want: dict) -> dict:
    d = [(got[k].float() - want[k].float()).abs() for k in sorted(want)]
    return {"max_abs": max(t.max().item() for t in d),
            "not_bit_equal": int(sum((got[k] != want[k]).sum().item() for k in want))}


def rank_main(job_path: str, rank: int) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    import chip_smoke as CS
    from repro_torch.kernels import ops
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
        cfg = common.launch_config(CS.ARCH)
        api = build_model(cfg)
        plan = PB.candidate_plans(cfg, CS.mesh_serve_shape(CS.MESH_SERVE_BUFFER))[0]
        params = serve.load_params(api, device, seed=0)
        prompts = serve.make_prompts(cfg, CS.BATCH, CS.PROMPT, device)
        p_local = TS.place_tree(params, SS.param_shardings(api, plan, mesh),
                                api.abstract_params())
        full = api.init_cache(cfg, CS.BATCH, CS.MESH_CHUNK_BUFFER, device="meta")
        c_sh = SS.cache_shardings(api, full, plan, mesh)
        none = torch.zeros((CS.BATCH, 0), dtype=torch.long, device=device)
        whole = {"kernels": CS.mesh_chunk_loop(api, params, prompts, none, [c_sh])}
        with CS.patched(ops, "attention", _plain(False)):
            whole["plain"] = CS.mesh_chunk_loop(api, params, prompts, none, [c_sh])
        del params
        torch.cuda.empty_cache()
        step = SS.jit_serve_step(api, plan, mesh, {k: v for k, v in full.items()
                                                   if k != "index"},
                                 tokens_shape=(CS.BATCH, 1))
        for name in VARIANTS:
            ref_logits, ref_blocks = whole["kernels" if name == "k2" else "plain"]
            local = {k: (0 if k == "index" else
                         torch.zeros(c_sh[k].local_shape(v.shape), dtype=v.dtype,
                                     device=device))
                     for k, v in full.items()}
            rows, at = [], 0
            for i, n in enumerate(CS.MESH_CHUNKS):
                t0 = time.perf_counter()
                if name == "k2":
                    logits, local = step(p_local, prompts[:, at:at + n], local)
                else:
                    with CS.patched(ops, "attention", _plain(name == "plain_float32")):
                        logits, local = step(p_local, prompts[:, at:at + n], local)
                torch.cuda.synchronize()
                at += n
                got = logits[:, -1, :cfg.vocab_size].float().cpu()
                rows.append({"index": local["index"], "s": time.perf_counter() - t0,
                             "logits_max_abs": (got - ref_logits[i]).abs().max().item(),
                             "cache_block": _diff({k: local[k].cpu() for k in ("k", "v")},
                                                  ref_blocks[i][0])})
            out[name] = rows
        out.update(ok=True, plan=plan.name, block_elements=sum(
            v.numel() for k, v in local.items() if k in ("k", "v")))
    except Exception:  # noqa: BLE001 - reported to the parent, which fails
        import traceback
        out.update(ok=False, error=traceback.format_exc()[-3000:])
    finally:
        with open(f"{job_path}.rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fold_probe: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    job_path = os.path.join(build, f"fold-probe-{os.getpid()}.json")
    store = os.path.join(build, f"fold-probe-store-{os.getpid()}")
    with open(job_path, "w") as f:
        json.dump({"store": store}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    logs = [open(f"{job_path}.rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", job_path,
                               str(r)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = []
    for r in range(2):
        path = f"{job_path}.rank{r}.json"
        res = json.load(open(path)) if os.path.exists(path) else {"ok": False}
        if not res.get("ok"):
            res["log"] = open(f"{job_path}.rank{r}.log").read()[-2000:]
        ranks.append(res)
    print(json.dumps({"probe": "fold", "chunks": [256, 128, 128], "buffer": 640,
                      "ranks": ranks, "wall_s": time.perf_counter() - t0}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0 if all(r.get("ok") for r in ranks) else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        rank_main(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
