"""Training RWKV6 in the port against the reference, on the CPU: the WKV
scan's backward (``kernels.rwkv6_bwd.wkv6_bwd``, which runs its plain
version on a CPU tensor) against ``jax.grad`` of the reference's token-level
oracle ``repro.kernels.ref.wkv6_ref`` and against torch autograd of the
port's own chunked forward, ``ops.wkv6`` as an autograd Function (its final
state never differentiable, nothing recorded under ``no_grad``), the odd
and empty sequences, and remat.  The whole model's losses and gradients are
in ``test_torch_train_models.py``, the train step and the driver in
``test_torch_train.py``.

Inputs are made with numpy from a seed.  Tolerances, each relative to the
output's largest entry: 2e-3 in float32 against the token loop (the
forward's own tolerance: the chunked and the token-level sums differ in
order); 1e-4 against autograd of ``wkv6_plain`` (the same chunked math, both
in float32); bfloat16 against the float32 gradient at 2e-2."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro_torch.configs import get_config
from repro_torch.kernels import ops, rwkv6 as K, rwkv6_bwd as KB
from repro_torch.models import build_model
from repro_torch.train.train_step import value_and_grad

NAMES = ("dr", "dk", "dv", "dlog_w", "du")


def _inputs(rng, BH, T, d, floor=False):
    """r, k, v, log_w, u, do as numpy float32; the forward tests' decays, or
    with ``floor`` every decay in [-4, 0] (the model's floor: at chunk 32 a
    masked product's two factors overflow float32)."""
    r, k, v, do = (rng.standard_normal((BH, T, d)).astype(np.float32) for _ in range(4))
    if floor:
        log_w = (-4.0 * rng.random((BH, T, d))).astype(np.float32)
    else:
        log_w = -np.exp(rng.standard_normal((BH, T, d)) * 0.5 - 1.0).astype(np.float32)
    u = (rng.standard_normal((BH, d)) * 0.5).astype(np.float32)
    return [r, k, v, log_w, u, do]


def _t(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _np(x):
    return x.detach().float().numpy()


def _close(got, want, rel, names=NAMES):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(g) if isinstance(g, torch.Tensor) else g, w,
                                   rtol=rel, atol=rel * scale, err_msg=name)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _jax_grads(xs):
    """``jax.grad`` of the reference's token loop: the vjp of ``wkv6_ref``
    with ``do`` as the cotangent."""
    r, k, v, log_w, u, do = (jnp.asarray(x) for x in xs)
    _, vjp = jax.vjp(ref_ref.wkv6_ref, r, k, v, log_w, u)
    return [np.asarray(g) for g in vjp(do)]


def _autograd(xs, chunk, dtype=torch.float32):
    """Torch autograd of the port's chunked forward ``wkv6_plain``."""
    leaves = [x.clone().requires_grad_() for x in _t(xs[:5], dtype)]
    o, _ = K.wkv6_plain(*leaves, chunk=chunk)
    return torch.autograd.grad(o, leaves, _t(xs[5:], dtype)[0])


# --------------------------------------------------- the plain backward
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("T,chunk", [(64, 32), (128, 32), (96, 16)])
def test_wkv6_bwd_plain_matches_jax_grad_of_the_token_loop(T, chunk, d):
    """The forward sweep's (T, chunk) cases, at every compiled head dim:
    float32 at 2e-3 of each output's largest entry."""
    xs = _inputs(np.random.default_rng(T + chunk + d), 3, T, d)
    before = KB.launches
    got = KB.wkv6_bwd(*_t(xs), chunk=chunk)
    assert KB.launches == before                 # the CPU runs the plain version
    assert [g.dtype for g in got] == [torch.float32] * 5
    assert [tuple(g.shape) for g in got] == [x.shape for x in xs[:5]]
    _close(got, _jax_grads(xs), 2e-3)


@pytest.mark.parametrize("T,chunk,floor", [(64, 32, False), (96, 16, False), (40, 8, False),
                                           (7, 1, False), (64, 32, True)])
def test_wkv6_bwd_plain_matches_autograd_of_the_chunked_forward(T, chunk, floor):
    """The explicit backward against autograd of ``wkv6_plain`` on the same
    float32 inputs, at 1e-4: this pins the chunked math term by term,
    dlog_w's exclusive (r) and inclusive (k) suffix sums included, and at
    the decay floor with chunk 32."""
    xs = _inputs(np.random.default_rng(T), 2, T, 32, floor)
    got = KB.wkv6_bwd_plain(*_t(xs), chunk=chunk)
    assert all(np.isfinite(_np(g)).all() for g in got)
    _close(got, _autograd(xs, chunk), 1e-4)


def test_wkv6_bwd_log_decay_gradient_is_the_split_suffix_sum():
    """dlog_w[s] = sum_{t > s} r_t dr'_t - sum_{t >= s} k_t dk'_t: with the
    bonus terms taken out of dr and dk, the log-decay's gradient follows
    from the other two; moving the split by one step on either side breaks
    it."""
    r, k, v, log_w, u, do = _inputs(np.random.default_rng(9), 2, 48, 16)
    dr, dk, _, dlog_w, _ = (_np(g) for g in KB.wkv6_bwd_plain(*_t([r, k, v, log_w, u, do]),
                                                              chunk=16))
    db = (do * v).sum(-1, keepdims=True)
    a = r * (dr - u[:, None] * k * db)
    b = k * (dk - u[:, None] * r * db)
    suffix = lambda x: np.flip(np.cumsum(np.flip(x, 1), 1), 1)
    want = suffix(a) - a - suffix(b)
    scale = np.abs(want).max()
    np.testing.assert_allclose(dlog_w, want, rtol=1e-4, atol=1e-5 * scale)
    for wrong in (suffix(a) - suffix(b), suffix(a) - a - (suffix(b) - b)):
        assert np.abs(dlog_w - wrong).max() > 1e-2 * scale


def test_wkv6_bwd_odd_length_and_empty_sequence(monkeypatch):
    """An odd T runs at chunk 1 through ``ops.wkv6``; T = 0 and BH = 0 give
    zeros of the operands' shapes."""
    xs = _inputs(np.random.default_rng(11), 2, 7, 16)
    leaves = [x.clone().requires_grad_() for x in _t(xs[:5])]
    seen, real = [], KB.wkv6_bwd

    def spy(*args, chunk):
        seen.append(chunk)
        return real(*args, chunk=chunk)

    monkeypatch.setattr(KB, "wkv6_bwd", spy)
    o, _ = ops.wkv6(*leaves, chunk=16)
    got = torch.autograd.grad(o, leaves, _t(xs)[5])
    assert seen == [1]
    _close(got, _jax_grads(xs), 2e-3)
    for BH, T in ((2, 0), (0, 5)):
        empty = [torch.zeros(BH, T, 16)] * 4 + [torch.zeros(BH, 16)] + [torch.zeros(BH, T, 16)]
        grads = KB.wkv6_bwd(*empty, chunk=16)
        assert [tuple(g.shape) for g in grads] == [tuple(x.shape) for x in empty[:5]]
        assert not any(g.any() for g in grads)


def test_wkv6_bwd_checks_its_operands():
    xs = _t(_inputs(np.random.default_rng(0), 2, 16, 16))
    with pytest.raises(ValueError, match="do must be shaped like r"):
        KB.wkv6_bwd(*xs[:5], xs[5][:, :8])
    with pytest.raises(ValueError, match="BH, T, d"):
        KB.wkv6_bwd(*xs[:4], xs[4][:, :8], xs[5])
    with pytest.raises(ValueError, match="does not divide"):
        KB.wkv6_bwd(*xs, chunk=6)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):      # never a fallback
        KB.wkv6_bwd(*(x.to("meta") for x in xs))


def test_wkv6_bwd_footprint_puts_six_training_blocks_on_an_sm():
    """Four blocks of 128 threads per head at d 64, one cluster, each with
    16 of the state's value columns (mirrored from csrc/wkv6_bwd.cu): at
    the training shape (d 64, chunk 16, bf16) six blocks, each with the
    1 KB the runtime reserves, share an H100 SM's 228 KB, so the 640 blocks
    of 160 rows are resident at once on 132 SMs, with room for the clusters
    that a GPC cannot place (at five an SM the card held 154 of the 160);
    chunk 32 and float32 fit at fewer blocks an SM."""
    train = KB.wkv6_bwd_smem_bytes(64, 16, 2)
    assert train == 37440 and 6 * (train + 1024) <= 228 * 1024
    geo = KB.wkv6_bwd_geometry(160, 64, 16, 2)
    assert geo == {"split": 4, "cluster": 4, "threads": 128, "smem_bytes": train,
                   "blocks_per_sm": 6, "grid": 640, "waves": 1}
    assert geo["grid"] <= 132 * (geo["blocks_per_sm"] - 1) < 132 * geo["blocks_per_sm"]
    assert KB.wkv6_bwd_smem_bytes(64, 16, 4) == 29248             # float32: no raw stage
    assert KB.wkv6_bwd_geometry(160, 64, 16, 4)["blocks_per_sm"] == 6
    for d in K.COMPILED_HEAD_DIMS:
        for elem in (2, 4):
            assert KB.wkv6_bwd_smem_bytes(d, K.MAX_CHUNK, elem) <= 232448
            assert KB.wkv6_bwd_geometry(8, d, K.MAX_CHUNK, elem)["blocks_per_sm"] >= 2


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("chunk", [1, 7, 16, 17, 32])
def test_wkv6_bwd_geometry_splits_each_row_by_value_column(d, chunk):
    """One block per 16 value columns (a cluster of d / 16 per row); every
    chunk up to 16 shares the chunk-16 instantiation's footprint, every
    longer one the chunk-32 one's; the float32 footprint is the bf16 one
    less bf16's raw stage (r, k, log w over d channels, v and dO over 16
    columns, r dr' of 16 channels in float32)."""
    geo = KB.wkv6_bwd_geometry(10, d, chunk, 2)
    assert geo["split"] == geo["cluster"] == d // 16
    assert geo["grid"] == 10 * (d // 16) and geo["threads"] == 128
    cm = 16 if chunk <= 16 else 32
    assert geo["smem_bytes"] == KB.wkv6_bwd_smem_bytes(d, cm, 2)
    assert geo["smem_bytes"] - KB.wkv6_bwd_smem_bytes(d, chunk, 4) == cm * (6 * d + 128)
    assert 1 <= geo["blocks_per_sm"] <= 6
    assert (geo["blocks_per_sm"] + 1) * (geo["smem_bytes"] + 1024) > 233472 \
        or geo["blocks_per_sm"] == 6


# ------------------------------------------------ ops.wkv6 under autograd
def test_ops_wkv6_gradient_in_bfloat16():
    """bf16 operands through the autograd Function: each gradient comes back
    in bf16, equal to ``wkv6_bwd`` on the same bf16 inputs and within 2e-2
    (of each output's largest entry) of the float32 gradient of the same
    bf16-rounded values."""
    xs = _inputs(np.random.default_rng(4), 4, 64, 64)
    leaves = [x.clone().requires_grad_() for x in _t(xs[:5], torch.bfloat16)]
    do = _t(xs[5:], torch.bfloat16)[0]
    o, _ = ops.wkv6(*leaves, chunk=16)
    assert o.dtype == torch.bfloat16 and o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    assert all(g.dtype == torch.bfloat16 for g in got)
    direct = KB.wkv6_bwd(*(x.detach() for x in leaves), do, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))
    rounded = [_np(x) for x in (*leaves, do)]
    _close(got, _autograd(rounded, 16), 2e-2)


def test_ops_wkv6_final_state_does_not_require_a_gradient():
    """A loss that does not read the final state (the reference's) hands
    K5-bwd no final-state gradient: the gradients equal ``wkv6_bwd`` called
    without one, bit for bit.  The final state itself is differentiable (a
    sequence split over ranks carries it into the next block's scan), and
    its gradient reaches the operands."""
    xs = _t(_inputs(np.random.default_rng(1), 2, 32, 16))
    leaves = [x.clone().requires_grad_() for x in xs[:5]]
    with torch.enable_grad():
        o, state = ops.wkv6(*leaves, chunk=16)
    assert o.requires_grad and state.requires_grad and state.grad_fn is o.grad_fn
    assert state.shape == (2, 16, 16) and state.dtype == torch.float32
    got = torch.autograd.grad(o, leaves, xs[5], retain_graph=True)
    want = KB.wkv6_bwd(*(x.detach() for x in leaves), xs[5], chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    via_state = torch.autograd.grad(state.sum(), leaves)
    assert all(torch.isfinite(g).all() for g in via_state) and via_state[3].abs().max() > 0


def test_ops_wkv6_under_no_grad_records_nothing_and_scans_once(monkeypatch):
    """Serving runs under ``no_grad``: the same single call of the scan,
    nothing saved, no backward node."""
    xs = [x.requires_grad_() for x in _t(_inputs(np.random.default_rng(2), 2, 32, 16))[:5]]
    calls, real = [], K.wkv6

    def spy(*args, chunk):
        calls.append(chunk)
        return real(*args, chunk=chunk)

    monkeypatch.setattr(K, "wkv6", spy)
    with torch.no_grad():
        o, state = ops.wkv6(*xs, chunk=16)
    assert calls == [16] and o.grad_fn is None and not o.requires_grad
    want, _ = K.wkv6_plain(*(x.detach() for x in xs), chunk=16)
    assert torch.equal(o, want)


# ----------------------------------------------------------------- remat
def test_rwkv6_remat_runs_the_scan_twice_a_layer_with_the_same_gradient(monkeypatch):
    """With ``cfg.remat`` each block's scan runs twice a step (forward and
    recompute) and its backward once; the gradient equals the one without
    remat."""
    cfg = replace(get_config("rwkv6-3b").reduced(), compute_dtype="float32", kernels="cuda")
    params = build_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls = {"wkv6": 0, "wkv6_bwd": 0}
    scan, bwd = K.wkv6, KB.wkv6_bwd

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(K, "wkv6", counting("wkv6", scan))
    monkeypatch.setattr(KB, "wkv6_bwd", counting("wkv6_bwd", bwd))
    grads = {}
    for remat in (True, False):
        for name in calls:
            calls[name] = 0
        _, _, grads[remat] = value_and_grad(build_model(replace(cfg, remat=remat)), params,
                                            batch)
        L = cfg.n_layers
        assert calls == {"wkv6": (2 if remat else 1) * L, "wkv6_bwd": L}, (remat, calls)
    for path, g in _flat(grads[True]).items():
        torch.testing.assert_close(g, _flat(grads[False])[path], rtol=1e-5, atol=1e-7)
