"""Backward of the chunked RWKV6 WKV scan (K5-bwd): wrapper, launch counter
and plain version.

The reference has no counterpart: ``jax.grad`` cannot go through its Pallas
kernel ``repro/kernels/rwkv6.py``, and it trains on its XLA path
(``wkv6_chunked_jnp``).  The port sends every prompt-length WKV scan through
K5, so training needs K5's gradient.  Per head, with the forward's
recurrence ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` and
``o_t = r_t^T S_{t-1} + (sum_i r_t u k_t) v_t``, the gradient of the state
``G_{t-1} = diag(w_t) G_t + r_t dO_t^T`` runs backward from ``G_T``, the
final state's gradient (``dstate``, zero when not given), to ``G_0``, the
gradient of the initial state (``state0``, zero when not given), and, with
``db_t = dO_t . v_t``:

    dr_t = S_{t-1} dO_t + u k_t db_t        dk_t = G_t v_t + u r_t db_t
    dv_t = G_t^T k_t + (sum_i r_t u k_t) dO_t
    du   = sum_t r_t k_t db_t

With the bonus terms taken out, ``dr' = dr - u k db`` and
``dk' = dk - u r db``, the log-decay's gradient is a plain suffix sum over
the whole sequence, exclusive on r and inclusive on k, plus one term a
channel from the end boundary (``S_T`` the final state):

    dlog_w[s][i] = sum_j S_T[i,j] G_T[i,j] + sum_{t > s} r_t dr'_t
                   - sum_{t >= s} k_t dk'_t.

(``dlog_w[s][i] = sum_j G_s[i,j] w_s[i] S_{s-1}[i,j]`` telescopes from
``s = T``.)

Chunk by chunk, in the forward's notation (``A = r e^{cum_excl}``,
``RS = r e^{cum_excl - c}``, ``KS = k e^{c - cum}``,
``KC = k e^{last - cum}``, ``P = tril(RS KS^T, -1)``) and with
``dP = tril(dO v^T, -1)``, a chunk with start state S0 and end-state
gradient G1 gives

    dr = (dO S0^T) e^{cum_excl} + (dP KS) e^{cum_excl - c} + u k db
    dk = (v G1^T) e^{last - cum} + (dP^T RS) e^{c - cum} + u r db
    dv = KC G1 + P^T dO + (sum_i r u k) dO
    G0 = e^{last} G1 + A^T dO

The midpoint c cancels in every product, as in the forward.  The CUDA
kernel (``csrc/wkv6_bwd.cu``) computes this; a tensor on the CPU goes to
:func:`wkv6_bwd_plain`, a CUDA tensor launches the kernel or raises.

The kernel's design (:func:`wkv6_bwd_geometry` mirrors it).  No row's work
is large: a row walks its chunks twice, and each chunk step is a short chain
of small products and barriers, so one block a row (the first kernel: 160
blocks on 132 SMs) is bound by one block's latency.  The recurrence
separates by value column, so each row's state is split by column over a
thread-block cluster of ``d / 16`` blocks, each holding 16 columns of S and
of G in registers and owning 16 key channels; what sums over columns or
channels (dr', dk', the pair products dP, P and db, the bonus sums) is
folded through distributed shared memory in rank order, one cluster barrier
a chunk, without atomics, so the result repeats bit for bit.  At
rwkv6-3b's training shape (160 rows, d 64, chunk 16, bf16) the 640 blocks
of 128 threads take 37,440 bytes each, six an SM: the whole grid is
resident at once (at five an SM the card held 154 of the 160 clusters, a
cluster's blocks having to share a GPC).  A chunk below 16 runs at 16 with a
ragged last chunk: the same gradient in fewer chunk steps, each of which has
a fixed cost (an odd T, which the forward runs at chunk 1, takes T / 16
steps a sweep instead of T).  The wrapper allocates the float32 ``r dr'`` scratch
(BH, T, d) that the kernel writes in its forward sweep and reads back in
its backward sweep.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build
from . import work as _work
from .gemm import SM_SMEM
from .rwkv6 import DEFAULT_CHUNK, MAX_CHUNK, _check, _check_compiled, _chunk_of, _state_arg

launches = 0                        # kernel launches made by wkv6_bwd()

Grads = Tuple[torch.Tensor, ...]     # dr, dk, dv, dlog_w, du[, dstate0]

THREADS = 128                       # one block of the kernel per (row, 16 value columns)
SLICE = 16                          # value columns a block holds, key channels it owns
MAX_BLOCKS_PER_SM = 6               # the launch bounds ask for at most this many


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _chunk_bound(chunk: int) -> int:
    """The chunk bound of the instantiation a chunk runs on (16 or 32)."""
    return 16 if chunk <= 16 else MAX_CHUNK


def wkv6_bwd_smem_bytes(d: int, chunk: int, elem_size: int = 2) -> int:
    """Dynamic shared memory of one block of the kernel for head dimension
    ``d``, a chunk of ``chunk`` steps and inputs of ``elem_size`` bytes
    (mirrors ``WkvbGeo::BYTES`` in ``csrc/wkv6_bwd.cu``), at the chunk bound
    CM of its instantiation: KC and A for every channel (rows d + 4 floats);
    v and dO of the block's 16 columns, and r, k, the two midpoint-scaled
    copies and the cumulative log-decay of its 16 channels (rows 20); their
    last cumulative log-decay and u; two exchange buffers (the (d x CM)
    products, the pair sums and the bonus sums; the idle one also holds the
    block's (d x 16) slice of G for dv); the folded pair sums; and, for
    bf16 inputs, the raw stage the next chunk is fetched into (r, k, log w,
    the block's v and dO in bf16, r dr' in float32; float32 inputs are read
    from device memory directly)."""
    cm, w = _chunk_bound(chunk), SLICE
    floats = (2 * cm * (d + 4) + 7 * cm * (w + 4) + 2 * w
              + 2 * _round4(d * cm + cm * cm + cm) + _round4(cm * cm + cm))
    stage = 3 * cm * d * elem_size + 2 * cm * w * elem_size + w * cm * 4
    return 4 * floats + (stage if elem_size == 2 else 0)


def wkv6_bwd_geometry(BH: int, d: int, chunk: int, elem_size: int = 2,
                      sms: int = 132) -> Dict[str, int]:
    """The launch of the kernel (mirrors ``csrc/wkv6_bwd.cu``): ``split``
    blocks a row, one cluster; ``threads`` a block; its shared memory;
    ``blocks_per_sm`` that its shared memory and the launch bounds allow
    (the bounds cap the registers so that many fit); the grid; and the waves
    the grid takes on ``sms`` SMs (1: every block resident at once)."""
    split = d // SLICE
    smem = wkv6_bwd_smem_bytes(d, chunk, elem_size)
    per_sm = min(SM_SMEM // (smem + 1024), MAX_BLOCKS_PER_SM)
    grid = BH * split
    return {"split": split, "cluster": split, "threads": THREADS, "smem_bytes": smem,
            "blocks_per_sm": per_sm, "grid": grid,
            "waves": -(-grid // (sms * per_sm)) if grid else 0}


def _zero_grads(r, k, v, log_w, u, state0, dstate) -> Grads:
    """The gradients of an empty sequence: zeros, and the final state's
    gradient passed through to the initial state (the two are one)."""
    zeros = (torch.zeros_like(r), torch.zeros_like(k), torch.zeros_like(v),
             torch.zeros_like(log_w), torch.zeros_like(u))
    if state0 is None:
        return zeros
    return (*zeros, torch.zeros_like(state0, dtype=torch.float32) if dstate is None
            else dstate.float().clone())


def wkv6_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
                   u: torch.Tensor, do: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
                   state0: Optional[torch.Tensor] = None,
                   dstate: Optional[torch.Tensor] = None) -> Grads:
    """The kernel's chunked backward math in plain PyTorch, float32 inside,
    with the chunk and midpoint offsets of ``wkv6_plain`` (not autograd of
    it).  r/k/v/log_w/do: (BH, T, d); u: (BH, d); ``state0``: the forward's
    initial state and ``dstate`` the final state's gradient, (BH, d, d) or
    None (zero) -> (dr, dk, dv, dlog_w, du), each in its operand's dtype,
    and with ``state0`` given also ``dstate0`` (float32), the gradient of
    the initial state.  A masked entry of P or dP is selected away, never
    multiplied by 0."""
    _check(r, k, v, log_w, u, state0, dstate)
    if do.shape != r.shape:
        raise ValueError(f"do must be shaped like r {tuple(r.shape)}, got {tuple(do.shape)}")
    BH, T, d = r.shape
    c = _chunk_of(T, chunk)
    rf, kf, vf, wf, dof = (x.float() for x in (r, k, v, log_w, do))
    uf = u.float()[:, None, :]
    if T == 0:
        return _zero_grads(r, k, v, log_w, u, state0, dstate)
    lower = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device), -1)
    zero = torch.zeros((), device=r.device)
    db = (dof * vf).sum(-1, keepdim=True)               # dO_t . v_t, (BH, T, 1)

    def chunk_terms(t0):
        rr, kk, vv, ww, dd = (x[:, t0:t0 + c] for x in (rf, kf, vf, wf, dof))
        cum = torch.cumsum(ww, dim=1)
        cum_excl = cum - ww
        last = cum[:, -1:]
        mid = 0.5 * last
        dp = torch.where(lower, torch.einsum("btj,bsj->bts", dd, vv), zero)
        return rr, kk, vv, dd, cum, cum_excl, last, mid, dp

    # forward over the chunks: recompute the state entering each, write dr
    dr = torch.empty_like(rf)
    S = torch.zeros((BH, d, d), dtype=torch.float32, device=r.device) if state0 is None \
        else state0.float()
    for t0 in range(0, T, c):
        rr, kk, vv, dd, cum, cum_excl, last, mid, dp = chunk_terms(t0)
        dr[:, t0:t0 + c] = (torch.einsum("btj,bij->bti", dd, S) * torch.exp(cum_excl)
                            + torch.einsum("bts,bsi->bti", dp, kk * torch.exp(mid - cum))
                            * torch.exp(cum_excl - mid))
        S = S * torch.exp(last).transpose(1, 2) \
            + torch.einsum("bsi,bsj->bij", kk * torch.exp(last - cum), vv)
    # backward over the chunks: carry the state's gradient, write dk and dv
    dk, dv = torch.empty_like(rf), torch.empty_like(rf)
    G = torch.zeros((BH, d, d), dtype=torch.float32, device=r.device) if dstate is None \
        else dstate.float()
    # the end boundary's term of dlog_w: sum_j S_T G_T, S being S_T here
    phi = None if dstate is None else (S * G).sum(-1)[:, None, :]
    for t0 in reversed(range(0, T, c)):
        rr, kk, vv, dd, cum, cum_excl, last, mid, dp = chunk_terms(t0)
        rs = rr * torch.exp(cum_excl - mid)
        p = torch.where(lower, torch.einsum("bti,bsi->bts", rs, kk * torch.exp(mid - cum)),
                        zero)
        bonus = (rr * uf * kk).sum(-1, keepdim=True)
        dk[:, t0:t0 + c] = (torch.einsum("bsj,bij->bsi", vv, G) * torch.exp(last - cum)
                            + torch.einsum("bts,bti->bsi", dp, rs) * torch.exp(mid - cum))
        dv[:, t0:t0 + c] = (torch.einsum("bsi,bij->bsj", kk * torch.exp(last - cum), G)
                            + torch.einsum("bts,btj->bsj", p, dd) + bonus * dd)
        G = G * torch.exp(last).transpose(1, 2) \
            + torch.einsum("bti,btj->bij", rr * torch.exp(cum_excl), dd)
    # dr and dk above lack their bonus terms: they are dr' and dk'
    a, b = rf * dr, kf * dk
    suffix = torch.flip(torch.cumsum(torch.flip(a - b, dims=[1]), dim=1), dims=[1])
    dlog_w = suffix - a                                 # exclusive on r, inclusive on k
    if phi is not None:
        dlog_w = dlog_w + phi
    du = (rf * kf * db).sum(1)
    dr = dr + uf * kf * db
    dk = dk + uf * rf * db
    grads = (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlog_w.to(log_w.dtype),
             du.to(u.dtype))
    return grads if state0 is None else (*grads, G)


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
             u: torch.Tensor, do: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
             state0: Optional[torch.Tensor] = None,
             dstate: Optional[torch.Tensor] = None) -> Grads:
    """r/k/v/log_w/do: (BH, T, d); u: (BH, d) -> (dr, dk, dv, dlog_w, du),
    the gradients of ``sum(o * do) + sum(S_T * dstate)`` for ``(o, S_T)`` =
    ``wkv6(r, k, v, log_w, u, chunk=chunk, state0=state0)``, each in its
    operand's dtype (du per row: an expanded u sums it over the batch), and
    with ``state0`` given also ``dstate0`` (float32, (BH, d, d)), the
    gradient of the initial state.  ``state0`` and ``dstate`` are (BH, d, d)
    or None (zero), read in float32.  ``min(chunk, T)`` must divide T.  On a
    CUDA tensor all six operands are float32 or bfloat16 of one type and
    contiguous, with d in ``rwkv6.COMPILED_HEAD_DIMS`` and a chunk of at
    most ``rwkv6.MAX_CHUNK``, as K5 takes them."""
    global launches
    _check(r, k, v, log_w, u, state0, dstate)
    if do.shape != r.shape or do.device != r.device:
        raise ValueError(f"do must be shaped like r {tuple(r.shape)} on {r.device}, got "
                         f"{tuple(do.shape)} on {do.device}")
    if r.device.type == "cpu":
        states = {n: x for n, x in (("state0", state0), ("dstate", dstate)) if x is not None}
        return wkv6_bwd_plain(r, k, v, log_w, u, do, chunk=chunk, **states)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd runs on cpu or cuda tensors, not {r.device}")
    BH, T, d = r.shape
    c = _chunk_of(T, chunk)
    xs = (r, k, v, log_w, u, do)
    _check_compiled("wkv6_bwd", xs, d, T, c)
    if BH == 0 or T == 0:
        return _zero_grads(r, k, v, log_w, u, state0, dstate)
    dr, dk, dv, dlog_w = (torch.empty_like(x) for x in (r, k, v, log_w))
    du = torch.empty_like(u)
    s0, gT = _state_arg(state0), _state_arg(dstate)
    g0 = None if s0 is None else torch.empty_like(s0)
    # r dr', written by the kernel's forward sweep and read back by its backward
    scratch = torch.empty((BH, T, d), dtype=torch.float32, device=r.device)
    states = [s0, gT, g0]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.lib().repro_wkv6_bwd(
            *(x.data_ptr() for x in (*xs, dr, dk, dv, dlog_w, du, scratch)),
            *(None if x is None else x.data_ptr() for x in states),
            BH, T, d, c, int(r.dtype == torch.bfloat16), stream)
    _build.check(code, f"wkv6_bwd BH={BH} T={T} d={d} chunk={c}")
    launches += 1
    _work.add("wkv6_bwd", _work.wkv6_bwd_flops(BH, T, d, c),
              _work.nbytes(*xs, dr, dk, dv, dlog_w, du, *(x for x in states if x is not None)))
    return (dr, dk, dv, dlog_w, du) if g0 is None else (dr, dk, dv, dlog_w, du, g0)

