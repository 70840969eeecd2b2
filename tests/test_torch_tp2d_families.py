"""``tp2d`` for the MoE, the VLM and the encoder-decoder, on the CPU over a
2x2 ``gloo`` mesh (``tests/torch_mesh_worker.py``, mode ``families``).

``tp2d`` maps ``seq`` and ``kv_seq`` to ``model`` and the residual's
``embed`` to ``data``: each rank computes its block of the tokens over
the rank's block of the embed channels, every product over ``embed`` summed
over ``data``.  The MoE (``experts`` on ``model`` too) gathers its
sequence, routes on logits summed over ``data``, sums the gate and up
products over ``data`` and reduce-scatters the output; the VLM's connector
and the encoder-decoder's adapter write the rank's embed block; the
cross-attention's K/V projection from the memory's block is summed over
``data`` and gathered over ``model``.

Reduced qwen3-moe-30b-a3b (capacity factor 0.5: pairs drop),
internvl2-1b and seamless-m4t-medium, in float32:

* the forward (``api.logits_fn``, the rank's shards used as a step uses
  them) against the reference's forward on the same weights
  (``models/convert.from_reference``), 1e-5;
* two train steps and a prompt pass through ``serve_step.jit_serve_step``
  against the port's unsharded ones (``test_torch_seq_families._oracle``;
  tp2d splits no batch on this mesh, so the MoE routes the whole batch as
  the unsharded step does): losses within 1e-5 relative, parameter shards,
  first-step gradients within 1e-4 of each leaf's largest entry, logits,
  the rank's cache block;
* the collective tally: no all-gather over ``data``, all-reduces over it,
  and the bytes gathered over ``model`` equal to a count by hand from the
  plan (:func:`_over_model`);
* one decode step after the prompt pass, the cache split over ``kv_seq``:
  K3's partials (plain version) once an attention a rank, logits within
  2e-2 and the rank's cache block within 1e-5 of the unsharded step's;
* a control: the MoE routing on each rank's partial logits (the ``data``
  sum left out) routes differently on at least one rank.
"""
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
from test_torch_local_recurrent import B, S, STEPS, TCFG
from repro_torch.parallel import sharding as SH
from repro_torch.train import serve_step as SS
from test_torch_seq_families import (DROPS, ENCDEC, MOE, VLM, XS, _check_steps,
                                     _forward_data, _setup, _step_cases)
from torch_mesh_worker import plan_named, spawn

MESH = (2, 2)
EXTRA = {MOE: DROPS, VLM: (), ENCDEC: ()}


def _forward_cases(tmp_path, arch):
    tag = f"{arch}-float32-{XS}"
    torch.save(_forward_data(arch, "float32", XS)[0], tmp_path / f"{tag}.pt")
    pins = ("none", "router_partial") if arch == MOE else ("none",)
    return [{"name": f"fwd-{pin}", "kind": "forward", "arch": arch, "dtype": "float32",
             "plan": "tp2d", "data": f"{tag}.pt", "pin": pin, "placed": True}
            for pin in pins]


def _ranks(tmp_path, name):
    return [torch.load(tmp_path / f"{name}.rank{r}.pt", weights_only=False)
            for r in range(math.prod(MESH))]


@pytest.mark.parametrize("arch", [MOE, VLM, ENCDEC])
def test_tp2d_matches_the_reference_and_the_unsharded_steps(arch, tmp_path):
    checked = [(arch, "tp2d", EXTRA[arch])]
    steps = _step_cases(tmp_path, checked)
    steps[0]["decode"] = True
    cases = _forward_cases(tmp_path, arch) + steps
    spawn({"mode": "families", "mesh": list(MESH), "cases": cases, "tcfg": TCFG}, tmp_path)
    # the forward against the reference's
    _, want, _ = _forward_data(arch, "float32", XS)
    blocks = {}
    for got in _ranks(tmp_path, "fwd-none"):
        assert got["seq"] == "model"
        blocks[(got["coords"]["data"], got["coords"]["model"])] = got["logits"].numpy()
    for dp in range(MESH[0]):
        whole = np.concatenate([blocks[(dp, m)] for m in range(MESH[1])], axis=1)
        np.testing.assert_allclose(whole, want, rtol=1e-5, atol=1e-5, err_msg=f"data {dp}")
    if arch == MOE:
        _check_routing(tmp_path)
    # the steps and the prompt pass against the unsharded ones (no
    # all-gather over data: _check_steps)
    _check_steps(tmp_path, MESH, checked)
    api, start, _, prompt, _, _, _, cache, _ = _setup(arch, EXTRA[arch])
    # the decode step after the prompt pass: the cache split over kv_seq, K3
    # partials on each rank's keys (the encoder-decoder's cross K/V too)
    decoded = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
    with torch.no_grad():
        want, decoded = api.decode_step(start.params, prompt["tokens"][:, :1], decoded)
    attention_sites = api.cfg.n_layers * (2 if api.cfg.family == "audio" else 1)
    for rank, got in enumerate(_ranks(tmp_path, f"{arch}-tp2d")):
        what = f"{arch} rank {rank}"
        assert got["gathered"] == {"model": _over_model(api.cfg)}, (what, got["gathered"])
        assert got["decode_partials"] == attention_sites, what
        torch.testing.assert_close(got["decode_logits"], want, rtol=2e-2, atol=2e-2,
                                   msg=lambda m: f"{what} decode logits: {m}")
        mesh = SH.Mesh(("data", "model"), MESH, rank=rank)
        c_sh = SS.cache_shardings(api, decoded, plan_named("tp2d"), mesh)
        for name, w in decoded.items():
            if isinstance(w, torch.Tensor):
                assert c_sh[name].spec[2] == "model", (what, name)
                torch.testing.assert_close(got["decode_cache"][name], c_sh[name].local(w),
                                           rtol=1e-5, atol=1e-5 * max(1.0, float(w.abs().max())),
                                           msg=lambda m: f"{what} decode cache {name}: {m}")


def _check_routing(tmp_path):
    """Every rank's dispatch routes the pairs of its experts as the
    unsharded forward does; routing on partial logits does not."""
    data = _forward_data(MOE, "float32", XS)[0]
    api = build_model(replace(get_config(MOE).reduced(), compute_dtype="float32"))
    moe.DISPATCH_TRACE = []
    try:
        with torch.no_grad():
            api.logits_fn(data["params"], data["batch"])
        want = [t["routed"] for t in moe.DISPATCH_TRACE]
    finally:
        moe.DISPATCH_TRACE = None
    differs = 0
    for pin in ("none", "router_partial"):
        for got in _ranks(tmp_path, f"fwd-{pin}"):
            n = api.cfg.n_experts // MESH[1]
            e0 = got["coords"]["model"] * n
            same = all(torch.equal(g, w[e0:e0 + n]) for g, w in zip(got["routed"], want))
            assert len(got["routed"]) == len(want) == api.cfg.n_layers
            if pin == "none":
                assert same, got["coords"]
            else:
                differs += not same
    assert differs >= 1


def _over_model(cfg, m: int = MESH[1], e: int = MESH[0]) -> float:
    """Bytes the two tp2d STEPS gather over ``model`` (``m`` ranks), counted
    by hand from the plan, every weight's ``embed`` dim split over ``data``
    (``e`` ranks), float32: a layer's weights that the plan splits over
    ``model`` (the query and output projections, the kv projections where
    ``m`` divides the kv heads, the MLP, the MoE's router over its experts;
    not the grouped expert weights, which stay with their experts) in its
    forward and again in its recomputation, the embedding table and an
    untied head once a step; K and V of every position, gathered over the
    sequence in each attention's forward and recomputation (the encoder's
    and the cross-attention's over the frames); the MoE's input sequence
    likewise, and its output's gradient in the backward (the reduce-
    scatter's); and the VLM's inputs, which it takes whole: the step
    slices the batch by the plan and gathers it back (int64 ids, float32
    patches)."""
    d, hd, nkv = cfg.d_model // e, cfg.head_dim_, cfg.n_kv_heads
    attn = 2 * d * cfg.n_heads * hd + (2 * d * nkv * hd if nkv % m == 0 else 0)
    mlp = 3 * d * cfg.d_ff
    kv = lambda n: 2 * B * n * nkv * hd              # noqa: E731 -- K and V of n positions
    L, F = cfg.n_layers, cfg.frontend_len
    head = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    ids = 0
    if cfg.family == "moe":
        floats = 2 * L * (attn + d * cfg.n_experts + kv(S) + B * S * d) + L * B * S * d
    elif cfg.family == "vlm":
        floats = 2 * L * (attn + mlp + kv(F + S)) + B * F * cfg.frontend_dim
        ids = 2 * B * S * 8
    else:
        floats = 2 * ((cfg.n_encoder_layers or L) * (attn + mlp + kv(F))
                      + L * (2 * attn + mlp + kv(S) + kv(F)))
    return float(STEPS * (4 * (floats + head) + ids))
