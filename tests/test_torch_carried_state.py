"""Recurrent scans carried across a split of the sequence, against the JAX
reference on the CPU.

A rank that holds a block of the tokens scans it from the state the earlier
blocks leave: rwkv6 through K5 with an initial state (``ops.wkv6(...,
state0=)``, on the CPU its plain version ``kernels.rwkv6.wkv6_plain``) and
K5-bwd from the final state's gradient (``kernels.rwkv6_bwd.wkv6_bwd_plain(
..., state0=, dstate=)``), Mamba2 through ``models.mamba2.ssd_chunked(h0=)``
or the block's zero-start scan plus the entering state's read
(``mamba2._carry_ssd``).  Held at wkv6's 2e-3 (of each output's largest
entry, float32) against the reference's whole-sequence scans:
``models/rwkv6.py: wkv6_chunked_jnp``, ``kernels/ref.py: wkv6_ref`` and a
``jax.lax.scan`` token loop that also returns the final state (the
reference's loop returns only o), their ``jax.grad``, and
``models/mamba2.py: ssd_chunked``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro.models import mamba2 as ref_mamba2, rwkv6 as ref_rwkv6
from repro_torch.kernels import ops, rwkv6 as K, rwkv6_bwd as KB
from repro_torch.models import mamba2
from repro_torch.parallel import spmd

TOL = 2e-3


def _inputs(seed, BH, T, d):
    """r, k, v, log_w (the model's floor at -4), u, do; and a state and its
    gradient, float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((BH, T, d)).astype(np.float32) for _ in range(4))
    log_w = np.maximum(-np.exp(rng.standard_normal((BH, T, d)) * 0.5 - 1.0), -4.0)
    u = (rng.standard_normal((BH, d)) * 0.5).astype(np.float32)
    s0, ds = (rng.standard_normal((BH, d, d)).astype(np.float32) for _ in range(2))
    return [r, k, v, log_w.astype(np.float32), u, do, s0, ds]


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max(),
                               err_msg=what)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _loop(r, k, v, log_w, u, s0):
    """The token loop with an initial state, returning (o, final state):
    ``ref.wkv6_ref``'s recurrence, in jnp."""
    w = jnp.exp(log_w)

    def head(rh, kh, vh, wh, uh, sh):
        def step(S, x):
            rt, kt, vt, wt = x
            kv = kt[:, None] * vt[None, :]
            return wt[:, None] * S + kv, rt @ (S + uh[:, None] * kv)
        S, o = jax.lax.scan(step, sh, (rh, kh, vh, wh))
        return o, S
    return jax.vmap(head)(r, k, v, w, u, s0)


@pytest.mark.parametrize("T,cut,chunk,d", [(64, 32, 16, 16), (96, 32, 32, 32),
                                           (128, 48, 16, 64), (40, 20, 4, 16)])
def test_two_block_scan_equals_the_reference_over_the_whole_sequence(T, cut, chunk, d):
    """The second block scanned through ``wkv6_plain`` (and ``ops.wkv6``)
    from the first block's final state: o equals ``wkv6_chunked_jnp`` and
    ``wkv6_ref`` over the whole sequence, and the final state equals the
    reference loop's."""
    r, k, v, lw, u, *_ = _inputs(T + d, 3, T, d)
    first = [x[:, :cut] for x in (r, k, v, lw)]
    second = [x[:, cut:] for x in (r, k, v, lw)]
    o1, s1 = K.wkv6_plain(*map(_t, first), _t(u), chunk=chunk)
    o2, s2 = K.wkv6_plain(*map(_t, second), _t(u), chunk=chunk, state0=s1)
    got = torch.cat([o1, o2], dim=1).numpy()
    c = min(chunk, T)
    _close(got, ref_rwkv6.wkv6_chunked_jnp(r, k, v, lw, u, chunk=c), "wkv6_chunked_jnp")
    _close(got, ref_ref.wkv6_ref(r, k, v, lw, u), "wkv6_ref")
    want_o, want_s = _loop(r, k, v, lw, u, np.zeros((3, d, d), np.float32))
    _close(s2.numpy(), want_s, "final state")
    o2_ops, s2_ops = ops.wkv6(*map(_t, second), _t(u), chunk=chunk, state0=s1)
    assert torch.equal(o2_ops, o2) and torch.equal(s2_ops, s2)


@pytest.mark.parametrize("T,cut,chunk", [(64, 32, 16), (48, 16, 16), (30, 10, 2)])
def test_two_block_gradients_equal_jax_grad_over_the_whole_sequence(T, cut, chunk):
    """Autograd through the two-block scan (``ops.wkv6`` on the CPU: the
    plain forward, and K5-bwd's plain version from the final state's
    gradient, handing the initial state's back to the first block) of
    ``sum(o do) + sum(S_T dS)`` equals ``jax.grad`` of the same loss over the
    whole sequence's token loop."""
    r, k, v, lw, u, do, _, ds = _inputs(T * 7 + cut, 2, T, 32)
    leaves = [_t(x).clone().requires_grad_() for x in (r, k, v, lw, u)]
    o1, s1 = ops.wkv6(*(x[:, :cut] for x in leaves[:4]), leaves[4], chunk=chunk)
    o2, s2 = ops.wkv6(*(x[:, cut:] for x in leaves[:4]), leaves[4], chunk=chunk, state0=s1)
    loss = (torch.cat([o1, o2], 1) * _t(do)).sum() + (s2 * _t(ds)).sum()
    got = torch.autograd.grad(loss, leaves)
    _, vjp = jax.vjp(lambda *a: _loop(*a, jnp.zeros((2, 32, 32), jnp.float32)),
                     r, k, v, lw, u)
    want = vjp((jnp.asarray(do), jnp.asarray(ds)))
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("chunk", [1, 8, 16, 32])
def test_wkv6_bwd_plain_from_a_state_equals_jax_grad(chunk):
    """``wkv6_bwd_plain`` with a nonzero initial state and final-state
    gradient: the five gradients, the log-decay's end-boundary term
    ``sum_j S_T G_T`` included, and the initial state's gradient equal the
    vjp of the reference loop started from that state."""
    r, k, v, lw, u, do, s0, ds = _inputs(chunk, 3, 64, 16)
    got = KB.wkv6_bwd_plain(*map(_t, (r, k, v, lw, u, do)), chunk=chunk, state0=_t(s0),
                            dstate=_t(ds))
    _, vjp = jax.vjp(_loop, r, k, v, lw, u, s0)
    want = vjp((jnp.asarray(do), jnp.asarray(ds)))
    assert len(got) == 6
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du", "dstate0"), got, want):
        _close(g.numpy(), w, name)
    # without the end-boundary term dlog_w misses sum_j S_T G_T
    _, S_T = _loop(r, k, v, lw, u, s0)
    phi = np.sum(np.asarray(S_T) * ds, axis=-1)[:, None, :]
    assert np.abs(phi).max() > 10 * TOL * np.abs(np.asarray(want[3])).max()
    _close(got[3].numpy() - phi, np.asarray(want[3]) - phi, "dlog_w less its boundary term")


def test_folded_block_states_enter_each_block_as_the_whole_scan_does():
    """Four blocks, each scanned from zero, their own final states folded in
    order with the blocks' summed log-decays (``spmd.carry_states``'s fold,
    ``H(r + 1) = exp(L_r) H(r) + S_r``), each rescanned from the state
    entering it: the outputs and the final fold equal the reference over
    the whole sequence."""
    T, n = 128, 4
    r, k, v, lw, u, *_ = _inputs(5, 2, T, 32)
    blocks = [[_t(x[:, i * T // n:(i + 1) * T // n]) for x in (r, k, v, lw)] for i in range(n)]
    own = [K.wkv6_plain(*b, _t(u), chunk=16)[1] for b in blocks]
    h, outs = torch.zeros_like(own[0]), []
    for b, s in zip(blocks, own):
        outs.append(K.wkv6_plain(*b, _t(u), chunk=16, state0=h)[0])
        h = torch.exp(b[3].sum(dim=1))[..., None] * h + s
    _close(torch.cat(outs, 1).numpy(), ref_ref.wkv6_ref(r, k, v, lw, u), "o")
    _close(h.numpy(), _loop(r, k, v, lw, u, np.zeros((2, 32, 32), np.float32))[1], "state")


def _ssd_inputs(seed, B=2, T=64, H=3, dh=8, ds=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, ds)).astype(np.float32) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("T,cut", [(64, 32), (96, 64), (32, 16)])
def test_mamba2_two_block_scan_equals_the_reference_over_the_whole_sequence(T, cut,
                                                                           monkeypatch):
    """The port's ``ssd_chunked`` of the second block from the first block's
    final state, and the second block scanned from zero plus the entering
    state's decayed read (``mamba2._carry_ssd``, the sequence-split path),
    equal the reference's ``ssd_chunked`` over the whole sequence in y and
    the final state."""
    x, dt, A, Bm, Cm = _ssd_inputs(T + cut, T=T)
    want_y, want_h = ref_mamba2.ssd_chunked(x, dt, A, Bm, Cm)
    cut_ = lambda a, s: _t(a[:, s])
    first, second = slice(0, cut), slice(cut, T)
    y1, h1 = mamba2.ssd_chunked(*(cut_(a, first) for a in (x, dt)), _t(A),
                                *(cut_(a, first) for a in (Bm, Cm)))
    y2, h2 = mamba2.ssd_chunked(*(cut_(a, second) for a in (x, dt)), _t(A),
                                *(cut_(a, second) for a in (Bm, Cm)), h0=h1)
    _close(torch.cat([y1, y2], 1).numpy(), want_y, "y")
    _close(h2.numpy(), want_h, "h")
    own, own_h = mamba2.ssd_chunked(*(cut_(a, second) for a in (x, dt)), _t(A),
                                    *(cut_(a, second) for a in (Bm, Cm)))
    da = (cut_(dt, second) * _t(A)).float().sum(1)[..., None, None]
    monkeypatch.setattr(spmd, "carry_states",
                        lambda s, ld: (h1, torch.exp(da) * h1 + s))
    y2c, h2c = mamba2._carry_ssd(own, own_h, cut_(dt, second), _t(A), cut_(Cm, second))
    _close(torch.cat([y1, y2c], 1).numpy(), want_y, "y, carried read")
    _close(h2c.numpy(), want_h, "h, folded")
