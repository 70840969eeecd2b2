"""K2-bwd's delta = rowsum(P dP), on the CPU (the kernels' plain versions).

K2-bwd forms dS = P (dP - delta).  delta is rowsum(dO o) for the exact
output o; taken from the bf16 o the forward returns, it is off by
dO . (o - o_exact), and every key of a row takes that shift in dS, so the
rows of dS no longer sum to 0.  Where a pass's keys are nearly alike that
shift outweighs the whole gradient of its query and key projections:
seamless-m4t-medium's cross-attention reads a 12-layer encoder's memory,
whose positions its random init makes nearly equal, and at its first step
the kernel path's ``cross_attn/wq``, ``wk`` and ``cross_norm`` gradients
were 150 x as far from float32 as the plain path's (``chip_smoke.py``'s
``encdec_train``, NVIDIA H100 80GB HBM3, 700 W).  K2-bwd's bf16 bodies
therefore sum delta from the P they recompute (a first pass over the key
tiles), and its plain version does the same.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA, flash_attention_bwd as FAB
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference
from repro_torch.train.train_step import value_and_grad


def test_plain_backward_holds_the_gradient_when_keys_are_nearly_alike():
    """Keys and values nearly alike (the cross pass over a uniform memory):
    against float64 autograd of attention, K2-bwd's plain version (handed
    the bf16 o) puts dK and dV within one bf16 rounding and dQ, which here
    is a small remainder of cancelling terms, at 0.020 relative RMS
    (float32 autograd itself: 0.0056; P recomputed from the float32
    log-sum-exp sums to 1 only to float32); delta taken from the bf16 o
    instead puts dQ off by more than its own size."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 64, 32, generator=g).to(torch.bfloat16)
    k = torch.randn(4, 128, 32, generator=g)
    v = torch.randn(4, 128, 32, generator=g)
    k = (k[:, :1] + 0.01 * k).to(torch.bfloat16)
    v = (v[:, :1] + 0.01 * v).to(torch.bfloat16)
    dout = torch.randn(4, 64, 32, generator=g).to(torch.bfloat16)
    out, lse = FA.flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = FAB.flash_attention_bwd(q, k, v, out, lse, dout)
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    od = torch.softmax(qd @ kd.transpose(1, 2) * 32 ** -0.5, dim=-1) @ vd
    want = torch.autograd.grad(od, (qd, kd, vd), dout.double())
    rel = lambda a, b: float((a.double() - b).norm() / b.norm())
    assert rel(dq, want[0]) < 0.05
    assert rel(dk, want[1]) < 2.0 ** -8 and rel(dv, want[2]) < 2.0 ** -8
    # the same formula with delta = rowsum(dO o) of the bf16 o
    p = torch.exp(q.double() @ k.double().transpose(1, 2) * 32 ** -0.5 - lse[..., None])
    ds = p * (dout.double() @ v.double().transpose(1, 2)
              - (dout.double() * out.double()).sum(-1, keepdim=True))
    assert rel(ds @ k.double() * 32 ** -0.5, want[0]) > 1.0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def test_seamless_at_full_depth_meets_the_float32_rule_on_its_cross_attention():
    """seamless-m4t-medium reduced in width only (d 128, 4 heads of 32) at its
    12 encoder and 12 decoder layers over 1,024 frames, bf16: the first
    gradient through the kernels' path (K2 and K2-bwd, their plain versions
    here) against the reference's float32 ``jax.value_and_grad``, under
    ``chip_smoke.py``'s float32 rule: the worst leaf's relative RMS distance
    at most 1.25 x the plain path's (dense attention under autograd), and
    so is every cross-attention leaf's, which delta from the bf16 o put at
    1.9 (the plain path: 0.03).  The distance of all
    leaves together is left to the smoke's full-size run: here the frontend
    bias's gradient, a sum over 2,048 frames, makes most of it, and two
    correct plain paths (dense and chunked attention) already differ there
    by 12 % (0.0102 and 0.0115; the kernels' path 0.0129)."""
    arch = "seamless-m4t-medium"
    kw = dict(n_layers=12, n_encoder_layers=12, frontend_len=1024)
    ref_cfg = replace(ref_get_config(arch).reduced(), kernels="xla", compute_dtype="float32",
                      **kw)
    ref_api = ref_build_model(ref_cfg)
    weights = jax.tree.map(np.asarray, ref_api.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, ref_cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": (rng.standard_normal((2, 1024, ref_cfg.frontend_dim))
                        * 0.02).astype(np.float32)}
    ref_grads = _flat(jax.tree.map(np.asarray, jax.grad(
        lambda p: ref_api.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(
        jax.tree.map(jnp.asarray, weights))))
    params = from_reference(weights, "cpu")
    tb = {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
          for k, v in batch.items()}
    cfg = replace(get_config(arch).reduced(), compute_dtype="bfloat16", **kw)
    dist = {}
    for path in ("cuda", "plain"):
        grads = _flat(value_and_grad(build_model(replace(cfg, kernels=path)), params, tb)[2])
        dist[path] = {p: float(np.linalg.norm(grads[p].float().numpy() - w)
                               / max(np.linalg.norm(w), 1e-30)) for p, w in ref_grads.items()}
    assert max(dist["cuda"].values()) <= 1.25 * max(dist["plain"].values()), dist
    cross = [p for p in ref_grads if "cross" in p]
    assert len(cross) == 5
    for p in cross:
        assert dist["cuda"][p] <= 1.25 * dist["plain"][p], (p, dist["cuda"][p], dist["plain"][p])
