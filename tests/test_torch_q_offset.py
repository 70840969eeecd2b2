"""K2 and K2-bwd with a query offset (context-parallel attention) against the
reference.

A block of ``Sq`` query rows at positions ``[o, o + Sq)`` of a causal
sequence, against that sequence's first ``Skv`` keys, is rows ``[o, o + Sq)``
of the reference's dense causal ``kernels/ref.py: attention_ref`` over the
whole sequence, and its gradient is ``jax.grad`` of those rows.  The port's
plain versions (what the wrappers run on CPU tensors) take the block and
``q_offset=o``.  Inputs are made with numpy from a seed and handed to both
sides; float32 at 1e-4, bfloat16 at 2e-2 (``tests/test_kernels.py``'s
``_tol``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FAB
from repro_torch.kernels import ops, work

SQ, SKV, BH = 128, 640, 4
OFFSETS = [0, 64, 500, SKV - SQ]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _inputs(o, d, g, dtype):
    """The whole sequence's queries (the block is rows [o, o + SQ)), k/v of
    BH / g heads, and the block's output gradient."""
    rng = np.random.default_rng(o * 1000 + d + g)
    qj, qt = _pair(rng, (BH, SKV, d), dtype)
    kj, kt = _pair(rng, (BH // g, SKV, d), dtype)
    vj, vt = _pair(rng, (BH // g, SKV, d), dtype)
    dj, dt = _pair(rng, (BH, SQ, d), dtype)
    return (qj, kj, vj, dj), (qt[:, o:o + SQ].contiguous(), kt, vt, dt)


def _rows(q, k, v, o, g):
    """Rows [o, o + SQ) of the reference's causal attention over the whole
    sequence, k/v repeated ``g`` times as the reference repeats them."""
    rep = lambda x: jnp.repeat(x, g, axis=0)
    return attention_ref(q, rep(k), rep(v), causal=True)[:, o:o + SQ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("o", OFFSETS)
def test_plain_forward_with_offset_is_the_reference_rows(o, d, g, dtype):
    (qj, kj, vj, _), (qt, kt, vt, _) = _inputs(o, d, g, dtype)
    want = _rows(qj, kj, vj, o, g)
    got = FA.flash_attention(qt, kt, vt, causal=True, q_per_kv=g, q_offset=o)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    through_ops = ops.attention(qt, kt, vt, causal=True, q_per_kv=g, q_offset=o)
    assert torch.equal(through_ops, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("o", OFFSETS)
def test_plain_backward_with_offset_is_jax_grad_of_the_rows(o, d, g, dtype):
    (qj, kj, vj, dj), (qt, kt, vt, dt) = _inputs(o, d, g, dtype)

    def loss(q, k, v):
        return jnp.sum(_rows(q, k, v, o, g).astype(jnp.float32) * dj.astype(jnp.float32))

    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    out, lse = FA.flash_attention(qt, kt, vt, causal=True, q_per_kv=g, q_offset=o,
                                  return_lse=True)
    dq, dk, dv = FAB.flash_attention_bwd(qt, kt, vt, out, lse, dt, causal=True, q_per_kv=g,
                                         q_offset=o)
    np.testing.assert_allclose(_np(dq), _np(gq[:, o:o + SQ]), **_tol(dtype))
    np.testing.assert_allclose(_np(dk), _np(gk), **_tol(dtype))
    np.testing.assert_allclose(_np(dv), _np(gv), **_tol(dtype))


def test_autograd_through_ops_attention_carries_the_offset():
    """``ops.attention``'s autograd Function hands the offset to K2-bwd:
    its gradients are the plain backward's with the offset."""
    (_, _, _, _), (qt, kt, vt, dt) = _inputs(500, 64, 4, "float32")
    q, k, v = (t.clone().requires_grad_() for t in (qt, kt, vt))
    out = ops.attention(q, k, v, causal=True, q_per_kv=4, q_offset=500)
    out.backward(dt)
    o, lse = FA.flash_attention_plain(qt, kt, vt, causal=True, q_per_kv=4, q_offset=500,
                                      return_lse=True)
    want = FAB.flash_attention_bwd_plain(qt, kt, vt, o, lse, dt, causal=True, q_per_kv=4,
                                         q_offset=500)
    for a, b in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(a, b)
    assert not k.grad[:, 500 + SQ:].any()


@pytest.mark.parametrize("o", [0, 1, 63, 500, 4000])
def test_visible_pairs_with_offset_counts_the_mask(o):
    """The dry run's flop count of an offset causal block is the mask's
    count of visible (query, key) pairs."""
    for Sq, Skv in ((128, 640), (512, 4096), (100, 77), (1, 1)):
        qi = torch.arange(Sq)[:, None] + o
        ki = torch.arange(Skv)[None, :]
        assert work.visible_pairs(Sq, Skv, True, o) == int((qi >= ki).sum())
        assert work.attention_flops(2, Sq, Skv, 64, True, o) == \
            4.0 * 2 * int((qi >= ki).sum()) * 64
