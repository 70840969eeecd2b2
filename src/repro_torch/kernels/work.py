"""The work each kernel launch does: operations and bytes.

One formula per kernel, used twice: by the kernel wrappers, which add each
launch's work to the running :class:`Tally` while one is open
(:func:`counting`; ``launch/dryrun.py`` opens one around a step), and by
``chip_smoke.py``, whose roofline bound for a kernel is the same work over
the card's rates.  Bytes are each operand read once and each result written
once; operations are two a multiply-add.  Plain PyTorch versions (the
wrappers on CPU tensors) add nothing here: they are PyTorch operations,
which a ``FlopCounterMode`` counts.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch


def nbytes(*tensors: torch.Tensor) -> int:
    """Bytes of the tensors' elements (a view counts what it shows)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def visible_pairs(Sq: int, Skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs attention computes: all of them, or under the
    causal mask by absolute position (query row r at ``q_offset + r`` sees
    keys ``0 .. min(Skv, q_offset + r + 1)``) the visible part."""
    if not causal:
        return Sq * Skv
    r0 = min(Sq, max(0, Skv - q_offset - 1))     # rows that see fewer than Skv keys
    return r0 * (q_offset + 1) + r0 * (r0 - 1) // 2 + (Sq - r0) * Skv


def gemm_flops(M: int, N: int, K: int, groups: int = 1) -> float:
    """C = A @ B of (M, K) by (K, N), ``groups`` times (K4's experts)."""
    return 2.0 * groups * M * N * K


def attention_flops(BH: int, Sq: int, Skv: int, d: int, causal: bool,
                    q_offset: int = 0) -> float:
    """QK^T and PV over the visible pairs."""
    return 4.0 * BH * visible_pairs(Sq, Skv, causal, q_offset) * d


def attention_bwd_flops(BH: int, Sq: int, Skv: int, d: int, causal: bool,
                        q_offset: int = 0) -> float:
    """S and dP again, dV, dQ, dK over the visible pairs."""
    return 5 * 2.0 * BH * visible_pairs(Sq, Skv, causal, q_offset) * d


def attention_bwd_bytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, body: str) -> int:
    """q, k, v, lse and dO read, dQ, dK and dV (like q, k and v) written;
    o read by the float32 body only, which takes delta = rowsum(dO o): the
    bf16 bodies sum delta = rowsum(P dP) from the P they recompute."""
    return nbytes(q, k, v, lse, dout, *((o,) if body == "f32" else ())) + nbytes(q, k, v)


def decode_flops(BH: int, n_valid: int, d: int) -> float:
    """One query row a head against ``n_valid`` keys: QK^T and PV."""
    return 4.0 * BH * n_valid * d


def decode_kv_bytes(n_groups: int, n_valid: int, d: int, elem_size: int) -> int:
    """The valid keys and values, each read once."""
    return 2 * n_groups * n_valid * d * elem_size


def combine_flops(BH: int, splits: int, d: int) -> float:
    """Rescale and sum ``splits`` partial rows a head, then normalise."""
    return 3.0 * BH * splits * d


def wkv6_flops(BH: int, T: int, d: int, c: int) -> float:
    """The chunked scan's float32 multiply-adds: per chunk the state's read
    and update (4 C d^2) and the strictly lower triangle of the scores and
    their product with v (2 C (C - 1) d)."""
    return 2.0 * BH * (T // c) * (2 * c * d * d + c * (c - 1) * d)


def wkv6_bwd_flops(BH: int, T: int, d: int, c: int) -> float:
    """The chunked backward, per chunk of c steps: five (c x d) by (d x d)
    products (the state recomputed, dO S0^T, v G1^T, KC G1, A^T dO) and five
    over the strictly lower triangle of the pairs (dP, P, dP KS, dP^T RS,
    P^T dO), two operations a multiply-add."""
    return 2.0 * BH * (T // c) * (5 * c * d * d + 5 * (c * (c - 1) // 2) * d)


class Tally:
    """Operations and bytes of the kernel launches made while it is open,
    in all and by kernel."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.by_kernel: Dict[str, Dict[str, float]] = {}

    def add(self, kernel: str, flops: float, byts: float) -> None:
        self.flops += flops
        self.bytes += byts
        k = self.by_kernel.setdefault(kernel, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += byts


_OPEN: Optional[Tally] = None


def add(kernel: str, flops: float, byts: float) -> None:
    """Record one launch of ``kernel`` in the open tally, if any."""
    if _OPEN is not None:
        _OPEN.add(kernel, flops, byts)


@contextlib.contextmanager
def counting() -> Iterator[Tally]:
    """A tally of every kernel launch made inside the block."""
    global _OPEN
    prev, _OPEN = _OPEN, Tally()
    try:
        yield _OPEN
    finally:
        _OPEN = prev
