"""Chunked RWKV6 (Finch) WKV scan: wrapper, launch counter and plain version.

Counterpart of ``repro/kernels/rwkv6.py``.  The data-dependent-decay
recurrence per head (state S in R^{d x d}, key index i, value index j):

    o_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]

runs chunk by chunk: inside a chunk of C steps the pairwise part is a dense
(C x C) product, and the (d, d) float32 state is carried from one chunk to
the next.  The CUDA kernel (``csrc/wkv6.cu``) computes the reference
kernel's chunked math; a tensor on the CPU goes to :func:`wkv6_plain`, a
CUDA tensor launches the kernel or raises.

Against the reference, both also return the **final state** (BH, d, d) in
float32: the reference kernel leaves it in its scratch memory, the port's
prefill hands it to decode.  Both start from a zero state, or from a
float32 initial state ``state0`` (BH, d, d): a sequence split over ranks
scans each rank's block from the state the earlier blocks leave.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from . import work as _work

DEFAULT_CHUNK = 32
COMPILED_HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 32                      # longest chunk the kernel's buffers hold
THREADS = 256                       # one block of the kernel per (batch x head) row

launches = 0                        # kernel launches made by wkv6()


def wkv6_smem_bytes(d: int, chunk: int) -> int:
    """Dynamic shared memory of one block of the kernel (mirrors
    ``wkv6_smem_floats`` in ``csrc/wkv6.cu``), rows padded to d + 4 floats:
    the state in two buffers; r e^{cum_excl} and k e^{last - cum} in three
    chunk slots; the two midpoint-scaled copies, r u k and v in two; two
    slots of scores and bonus sums, three of decays, two of the threads'
    log-decay sums, and u."""
    ld = d + 4
    return 4 * (2 * d * ld + 14 * chunk * ld + 2 * chunk * chunk + 2 * chunk + 3 * d
                + 2 * THREADS + d)


def _chunk_of(T: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, T)``, which must divide T."""
    c = min(int(chunk), T)
    if T and (c < 1 or T % c):
        raise ValueError(f"chunk {chunk} does not divide T={T} (ops.wkv6 fits it)")
    return c


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
               u: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
               state0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunked math in plain PyTorch, float32 inside.

    r/k/v/log_w: (BH, T, d); u: (BH, d); state0: (BH, d, d) or None (zero)
    -> (o (BH, T, d) in r's type, final state (BH, d, d) float32).  A masked
    score is selected away, never multiplied by 0: at chunk 32 its two
    factors may overflow to inf."""
    BH, T, d = r.shape
    c = _chunk_of(T, chunk)
    uf = u.float()
    S = torch.zeros((BH, d, d), dtype=torch.float32, device=r.device) if state0 is None \
        else state0.float()
    if T == 0:
        return torch.empty_like(r), S.clone()
    lower = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device), -1)
    outs = []
    for t0 in range(0, T, c):
        rr, kk, vv, ww = (x[:, t0:t0 + c].float() for x in (r, k, v, log_w))
        cum = torch.cumsum(ww, dim=1)                      # inclusive (BH, c, d)
        cum_excl = cum - ww
        last = cum[:, -1]                                  # (BH, d)
        # inter-chunk: decayed read of the carried state
        o = torch.einsum("btd,bde->bte", rr * torch.exp(cum_excl), S)
        # intra-chunk pairwise scores, both factors offset by the per-channel
        # midpoint decay (exact: the offsets cancel in the product)
        c_off = 0.5 * last[:, None, :]
        r_sc = rr * torch.exp(cum_excl - c_off)
        k_sc = kk * torch.exp(c_off - cum)
        scores = torch.einsum("btd,bsd->bts", r_sc, k_sc)
        scores = torch.where(lower, scores, torch.zeros((), device=r.device))
        diag = torch.sum(rr * uf[:, None, :] * kk, dim=-1)
        o = o + torch.einsum("bts,bse->bte", scores, vv) + diag[..., None] * vv
        outs.append(o)
        # the state after the chunk
        k_carry = kk * torch.exp(last[:, None, :] - cum)
        S = S * torch.exp(last)[:, :, None] + torch.einsum("bsd,bse->bde", k_carry, vv)
    return torch.cat(outs, dim=1).to(r.dtype), S


def _check(r, k, v, log_w, u, *states) -> None:
    """Shapes and devices of the operands, and of the (BH, d, d) states
    given (None: not given)."""
    if r.dim() != 3 or any(x.shape != r.shape for x in (k, v, log_w)) \
            or u.shape != (r.shape[0], r.shape[2]):
        raise ValueError(f"wkv6 wants r/k/v/log_w (BH, T, d) and u (BH, d), got "
                         f"{[tuple(x.shape) for x in (r, k, v, log_w, u)]}")
    given = [x for x in states if x is not None]
    if any(x.shape != (r.shape[0], r.shape[2], r.shape[2]) for x in given):
        raise ValueError(f"wkv6's states are (BH, d, d) = {(r.shape[0], r.shape[2], r.shape[2])}, "
                         f"got {[tuple(x.shape) for x in given]}")
    if any(x.device != r.device for x in (k, v, log_w, u, *given)):
        raise ValueError("wkv6's operands lie on different devices")


def _state_arg(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A state as the kernels read it: float32, contiguous, at a 16-byte
    aligned base (None stays None)."""
    if x is None:
        return None
    x = x.detach().to(torch.float32).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_compiled(name: str, xs, d: int, T: int, c: int) -> None:
    """Raise unless the kernel was compiled for these CUDA operands: d in
    :data:`COMPILED_HEAD_DIMS`, a chunk of 1 to :data:`MAX_CHUNK`, float32
    or bfloat16 of one type, contiguous."""
    if d not in COMPILED_HEAD_DIMS:
        raise ValueError(f"head dimension {d} is not compiled; choose from "
                         f"{COMPILED_HEAD_DIMS}")
    if T and not 1 <= c <= MAX_CHUNK:
        raise ValueError(f"chunk {c} is not compiled; the kernel takes 1 to {MAX_CHUNK}")
    if xs[0].dtype not in (torch.float32, torch.bfloat16) \
            or any(x.dtype != xs[0].dtype for x in xs):
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one type, got "
                        f"{[x.dtype for x in xs]}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name} takes contiguous operands")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
         u: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
         state0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/log_w: (BH, T, d); u: (BH, d); state0: the initial state (BH,
    d, d), None for zero -> (o (BH, T, d) in r's type, final state (BH, d,
    d) float32).

    ``log_w`` is the elementwise log of the decay (<= 0); ``min(chunk, T)``
    must divide T.  On a CUDA tensor all five operands are float32 or
    bfloat16 of one type, contiguous, with d in :data:`COMPILED_HEAD_DIMS`
    and a chunk of at most :data:`MAX_CHUNK`; ``state0`` is read in
    float32."""
    global launches
    _check(r, k, v, log_w, u, state0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, log_w, u, chunk=chunk,
                          **({} if state0 is None else {"state0": state0}))
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cpu or cuda tensors, not {r.device}")
    BH, T, d = r.shape
    c = _chunk_of(T, chunk)
    _check_compiled("wkv6", (r, k, v, log_w, u), d, T, c)
    o = torch.empty_like(r)
    state = torch.empty((BH, d, d), dtype=torch.float32, device=r.device)
    if BH == 0:
        return o, state
    s0 = _state_arg(state0)
    if T == 0:
        return o, state.zero_() if s0 is None else state.copy_(s0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.lib().repro_wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
            o.data_ptr(), None if s0 is None else s0.data_ptr(), state.data_ptr(), BH, T, d, c,
            int(r.dtype == torch.bfloat16), stream)
    _build.check(code, f"wkv6 BH={BH} T={T} d={d} chunk={c}")
    launches += 1
    _work.add("wkv6", _work.wkv6_flops(BH, T, d, c),
              _work.nbytes(r, k, v, log_w, u, o, state, *([] if s0 is None else [s0])))
    return o, state
