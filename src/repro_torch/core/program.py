"""Dataflow-agnostic tile-program IR (paper S2.2, Listing 1).

A :class:`TileProgram` is the Python isomorph of the paper's normalized MLIR
input: an ``affine.parallel`` loop over *grid dims* (the logical launch grid),
an ``scf.for`` nest over *sequential dims* inside each block, a set of memory
accesses whose tile-grid addresses are **affine functions of the loop indices**
(the front-end's "affinization" contract), and a ``linalg``-style tile-op body
that dataflow planning never touches.

Programs are built either directly (``matmul_program``,
``flash_attention_program``, ...) or from einsum-like specs by the mesh-level
planner bridge (``parallel/planner_bridge.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from .affine import AffineExpr, AffineMap


@dataclass(frozen=True)
class TensorSpec:
    """A global tensor: logical element shape + dtype width."""
    name: str
    shape: Tuple[int, ...]
    dtype_bytes: int = 2          # bf16/fp16 default

    @property
    def bytes(self) -> int:
        return math.prod(self.shape) * self.dtype_bytes


@dataclass(frozen=True)
class TileAccess:
    """A load or store of one tile of ``tensor`` per innermost iteration.

    ``index`` maps loop dims -> tile-grid coordinates (NOT element offsets);
    ``tile_shape`` is the element shape of one tile.  This mirrors the paper's
    ``memref.reinterpret_cast`` + affine.apply idiom in Listing 1.
    """
    tensor: TensorSpec
    index: AffineMap
    tile_shape: Tuple[int, ...]
    kind: str = "load"            # "load" | "store"
    name: str = ""

    @property
    def tile_bytes(self) -> int:
        return math.prod(self.tile_shape) * self.tensor.dtype_bytes

    def depends_on(self, dim: str) -> bool:
        return self.index.depends_on(dim)

    def label(self) -> str:
        return self.name or f"{self.kind}_{self.tensor.name}"


@dataclass(frozen=True)
class TileOp:
    """One ``linalg`` op of the tile body.  ``unit`` selects the intra-core
    functional unit class (paper S2.5 decomposes ops onto mat/vec/scalar
    intrinsics); ``work`` is intrinsic-independent work: FLOPs for ``mat``,
    element-ops for ``vec``/``scalar``.  Ops sharing a ``segment`` index are
    independent and may run on different unit types concurrently; segments
    execute in sequence (the paper's dependence/segment model)."""
    kind: str                     # "matmul" | "exp" | "add" | "max" | ...
    unit: str                     # "mat" | "vec" | "scalar"
    work: float
    segment: int = 0


@dataclass(frozen=True)
class LoopDim:
    name: str
    extent: int


@dataclass(frozen=True)
class TileProgram:
    """The unit of planning: one kernel's logical grid + per-block program."""
    name: str
    grid_dims: Tuple[LoopDim, ...]       # affine.parallel (logical launch grid)
    seq_dims: Tuple[LoopDim, ...]        # scf.for inside a block (outer->inner)
    loads: Tuple[TileAccess, ...]
    stores: Tuple[TileAccess, ...]
    body: Tuple[TileOp, ...]
    # Accumulators live in local memory for the whole block execution
    # (e.g. the C tile of a GEMM): name -> bytes.
    accumulators: Tuple[Tuple[str, int], ...] = ()

    # -- queries -------------------------------------------------------------
    def dim(self, name: str) -> LoopDim:
        for d in self.grid_dims + self.seq_dims:
            if d.name == name:
                return d
        raise KeyError(name)

    @property
    def extents(self) -> Dict[str, int]:
        return {d.name: d.extent for d in self.grid_dims + self.seq_dims}

    @property
    def n_blocks(self) -> int:
        return math.prod(d.extent for d in self.grid_dims)

    @property
    def inner_iters(self) -> int:
        return math.prod(d.extent for d in self.seq_dims)

    def total_flops(self) -> float:
        per_iter = sum(op.work for op in self.body if op.unit == "mat")
        per_iter += sum(op.work for op in self.body if op.unit != "mat")
        return per_iter * self.inner_iters * self.n_blocks

    def mat_flops(self) -> float:
        return (sum(op.work for op in self.body if op.unit == "mat")
                * self.inner_iters * self.n_blocks)

    def accumulator_bytes(self) -> int:
        return sum(b for _, b in self.accumulators)

    def validate(self) -> None:
        """Front-end contract checks (affinization, bounded dims)."""
        dims = {d.name for d in self.grid_dims} | {d.name for d in self.seq_dims}
        for acc in self.loads + self.stores:
            extra = acc.index.dims - dims
            if extra:
                raise ValueError(
                    f"{self.name}: access {acc.label()} uses undeclared dims {extra}")
        for d in self.grid_dims + self.seq_dims:
            if d.extent <= 0:
                raise ValueError(f"{self.name}: dim {d.name} has extent {d.extent}")


# --------------------------------------------------------------------------
# Program builders (the "front-end" of the reproduction; see DESIGN.md S4:
# Triton/triton-shared is replaced by direct IR construction with the same
# affine-access discipline).
# --------------------------------------------------------------------------
def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def matmul_program(M: int, N: int, K: int, *, bm: int, bn: int, bk: int,
                   dtype_bytes: int = 2, acc_bytes: int = 4,
                   name: str = "matmul",
                   tensor_names: Tuple[str, str, str] = ("A", "B", "C")
                   ) -> TileProgram:
    """``C[M,N] = A[M,K] @ B[K,N]`` — output-stationary tiling, the paper's
    running example (Listing 1).  Grid = (gx over M-tiles, gy over N-tiles);
    sequential k over K-tiles; body = one (bm,bk)x(bk,bn) tile matmul.

    ``tensor_names`` renames (A, B, C) so chained kernels of a pipeline
    graph can share an intermediate tensor by name (e.g. the two GEMMs of an
    MLP both calling their shared activation "Y"); the default leaves every
    historical program — and therefore every cache key and golden — intact.
    """
    an, bn_name, cn = tensor_names
    A = TensorSpec(an, (M, K), dtype_bytes)
    B = TensorSpec(bn_name, (K, N), dtype_bytes)
    C = TensorSpec(cn, (M, N), dtype_bytes)
    gx, gy, k = "gx", "gy", "k"
    loads = (
        TileAccess(A, AffineMap.from_terms({gx: 1}, {k: 1}), (bm, bk), "load"),
        TileAccess(B, AffineMap.from_terms({k: 1}, {gy: 1}), (bk, bn), "load"),
    )
    stores = (
        TileAccess(C, AffineMap.from_terms({gx: 1}, {gy: 1}), (bm, bn), "store"),
    )
    body = (TileOp("matmul", "mat", work=2.0 * bm * bn * bk, segment=0),)
    return TileProgram(
        name=f"{name}_{M}x{N}x{K}_b{bm}x{bn}x{bk}",
        grid_dims=(LoopDim(gx, _ceil(M, bm)), LoopDim(gy, _ceil(N, bn))),
        seq_dims=(LoopDim(k, _ceil(K, bk)),),
        loads=loads, stores=stores, body=body,
        accumulators=(("C_acc", bm * bn * acc_bytes),))


def fused_matmul_program(M: int, N: int, K: int, *, bm: int, bn: int, bk: int,
                         epilogue_ops: Sequence[str] = ("exp", "sqrt"),
                         dtype_bytes: int = 2) -> TileProgram:
    """GEMM with a fused pointwise epilogue (paper Listing 5 shows
    linalg.matmul + linalg.exp + linalg.sqrt in one tile body)."""
    base = matmul_program(M, N, K, bm=bm, bn=bn, bk=bk, dtype_bytes=dtype_bytes,
                          name="fused_matmul")
    body = list(base.body)
    for i, op in enumerate(epilogue_ops):
        body.append(TileOp(op, "vec", work=float(bm * bn), segment=1 + i))
    return replace(base, body=tuple(body))


def flash_attention_program(batch_heads: int, seq_q: int, seq_kv: int,
                            head_dim: int, *, bq: int, bkv: int,
                            dtype_bytes: int = 2, causal: bool = False,
                            name: str = "flash_attention") -> TileProgram:
    """Non-causal FlashAttention forward (the paper's second workload).

    Grid = (h over batch*heads, gq over Q tiles); sequential kv over KV tiles.
    Per inner iteration the block computes S = Q K^T (mat), online-softmax
    statistics (vec), and P V (mat).  K/V tiles do not depend on gq — that is
    exactly the cross-query reuse the paper says TileLoom exploits ("key data
    tiles are reused on-chip across multiple query and value tiles").
    """
    H = batch_heads
    Q = TensorSpec("Q", (H, seq_q, head_dim), dtype_bytes)
    K = TensorSpec("K", (H, seq_kv, head_dim), dtype_bytes)
    V = TensorSpec("V", (H, seq_kv, head_dim), dtype_bytes)
    O = TensorSpec("O", (H, seq_q, head_dim), dtype_bytes)
    h, gq, kv = "h", "gq", "kv"
    loads = (
        TileAccess(Q, AffineMap.from_terms({h: 1}, {gq: 1}), (1, bq, head_dim), "load"),
        TileAccess(K, AffineMap.from_terms({h: 1}, {kv: 1}), (1, bkv, head_dim), "load"),
        TileAccess(V, AffineMap.from_terms({h: 1}, {kv: 1}), (1, bkv, head_dim), "load"),
    )
    stores = (
        TileAccess(O, AffineMap.from_terms({h: 1}, {gq: 1}), (1, bq, head_dim), "store"),
    )
    kv_tiles = _ceil(seq_kv, bkv)
    causal_frac = 0.5 + 0.5 / max(1, kv_tiles) if causal else 1.0
    body = (
        TileOp("qk_matmul", "mat", work=2.0 * bq * bkv * head_dim * causal_frac, segment=0),
        TileOp("softmax_stats", "vec", work=4.0 * bq * bkv * causal_frac, segment=1),
        TileOp("rescale", "vec", work=2.0 * bq * head_dim, segment=1),
        TileOp("pv_matmul", "mat", work=2.0 * bq * bkv * head_dim * causal_frac, segment=2),
    )
    return TileProgram(
        name=f"{name}_h{H}_q{seq_q}_kv{seq_kv}_d{head_dim}_b{bq}x{bkv}",
        grid_dims=(LoopDim(h, H), LoopDim(gq, _ceil(seq_q, bq))),
        seq_dims=(LoopDim(kv, kv_tiles),),
        loads=loads, stores=stores, body=body,
        accumulators=(("O_acc", bq * head_dim * 4), ("m_l", 2 * bq * 4)))


def flash_decode_program(batch_heads: int, seq_kv: int, head_dim: int, *,
                         bkv: int, dtype_bytes: int = 2,
                         name: str = "flash_decode") -> TileProgram:
    """Single-token decode attention: one query row per (batch, head) against
    a long KV cache.

    Grid = (h over batch*heads) only — decode has no query tiling — and the
    whole KV walk is the sequential loop ``s``: a pure online-softmax
    reduction.  That makes the kernel the canonical *reduction-bound* shape
    (StreamTensor's LLM-decode case): with few heads the mesh idles and the
    ``s`` loop serializes on single cores unless the planner binds it to a
    mesh axis (split-KV spatial reduction) and combines the per-split
    (m, l, acc) partials.
    """
    H = batch_heads
    Q = TensorSpec("Q", (H, 1, head_dim), dtype_bytes)
    K = TensorSpec("K", (H, seq_kv, head_dim), dtype_bytes)
    V = TensorSpec("V", (H, seq_kv, head_dim), dtype_bytes)
    O = TensorSpec("O", (H, 1, head_dim), dtype_bytes)
    h, s = "h", "s"
    loads = (
        TileAccess(Q, AffineMap.from_terms({h: 1}, {}), (1, 1, head_dim), "load"),
        TileAccess(K, AffineMap.from_terms({h: 1}, {s: 1}), (1, bkv, head_dim), "load"),
        TileAccess(V, AffineMap.from_terms({h: 1}, {s: 1}), (1, bkv, head_dim), "load"),
    )
    stores = (
        TileAccess(O, AffineMap.from_terms({h: 1}, {}), (1, 1, head_dim), "store"),
    )
    body = (
        TileOp("qk_matvec", "mat", work=2.0 * bkv * head_dim, segment=0),
        TileOp("softmax_stats", "vec", work=4.0 * bkv, segment=1),
        TileOp("rescale", "vec", work=2.0 * head_dim, segment=1),
        TileOp("pv_matvec", "mat", work=2.0 * bkv * head_dim, segment=2),
    )
    return TileProgram(
        name=f"{name}_h{H}_kv{seq_kv}_d{head_dim}_b{bkv}",
        grid_dims=(LoopDim(h, H),),
        seq_dims=(LoopDim(s, _ceil(seq_kv, bkv)),),
        loads=loads, stores=stores, body=body,
        accumulators=(("O_acc", head_dim * 4), ("m_l", 2 * 4)))


def qk_matmul_program(batch_heads: int, seq_q: int, seq_kv: int,
                      head_dim: int, *, bq: int, bkv: int,
                      dtype_bytes: int = 2,
                      name: str = "qk_matmul") -> TileProgram:
    """The *unfused* attention score kernel: ``S[h, q, kv] = Q @ K^T``.

    Where :func:`flash_attention_program` fuses the whole attention forward
    into one tile body, this is the first half of the two-kernel chain the
    pipeline planner co-plans (qk -> softmax+pv): grid = (h, gq, gkv), no
    sequential loop (the contraction over ``head_dim`` fits one tile), and
    the score tile ``S`` is the intermediate tensor the graph edge carries.
    """
    H = batch_heads
    Q = TensorSpec("Q", (H, seq_q, head_dim), dtype_bytes)
    K = TensorSpec("K", (H, seq_kv, head_dim), dtype_bytes)
    S = TensorSpec("S", (H, seq_q, seq_kv), dtype_bytes)
    h, gq, gkv = "h", "gq", "gkv"
    loads = (
        TileAccess(Q, AffineMap.from_terms({h: 1}, {gq: 1}), (1, bq, head_dim),
                   "load"),
        TileAccess(K, AffineMap.from_terms({h: 1}, {gkv: 1}),
                   (1, bkv, head_dim), "load"),
    )
    stores = (
        TileAccess(S, AffineMap.from_terms({h: 1}, {gq: 1}, {gkv: 1}),
                   (1, bq, bkv), "store"),
    )
    body = (TileOp("qk_matmul", "mat", work=2.0 * bq * bkv * head_dim,
                   segment=0),)
    return TileProgram(
        name=f"{name}_h{H}_q{seq_q}_kv{seq_kv}_d{head_dim}_b{bq}x{bkv}",
        grid_dims=(LoopDim(h, H), LoopDim(gq, _ceil(seq_q, bq)),
                   LoopDim(gkv, _ceil(seq_kv, bkv))),
        seq_dims=(),
        loads=loads, stores=stores, body=body,
        accumulators=(("S_acc", bq * bkv * 4),))


def softmax_pv_program(batch_heads: int, seq_q: int, seq_kv: int,
                       head_dim: int, *, bq: int, bkv: int,
                       dtype_bytes: int = 2,
                       name: str = "softmax_pv") -> TileProgram:
    """The second half of the unfused attention chain:
    ``O[h, q, d] = softmax(S) @ V`` with the online-softmax statistics
    computed over the ``kv`` walk.  Loads the score tensor ``S`` produced by
    :func:`qk_matmul_program` — tile shape ``(1, bq, bkv)`` matches the
    producer's store tile exactly, which is the pipeline forwarding
    legality requirement."""
    H = batch_heads
    S = TensorSpec("S", (H, seq_q, seq_kv), dtype_bytes)
    V = TensorSpec("V", (H, seq_kv, head_dim), dtype_bytes)
    O = TensorSpec("O", (H, seq_q, head_dim), dtype_bytes)
    h, gq, kv = "h", "gq", "kv"
    loads = (
        TileAccess(S, AffineMap.from_terms({h: 1}, {gq: 1}, {kv: 1}),
                   (1, bq, bkv), "load"),
        TileAccess(V, AffineMap.from_terms({h: 1}, {kv: 1}),
                   (1, bkv, head_dim), "load"),
    )
    stores = (
        TileAccess(O, AffineMap.from_terms({h: 1}, {gq: 1}),
                   (1, bq, head_dim), "store"),
    )
    body = (
        TileOp("softmax_stats", "vec", work=4.0 * bq * bkv, segment=0),
        TileOp("rescale", "vec", work=2.0 * bq * head_dim, segment=0),
        TileOp("pv_matmul", "mat", work=2.0 * bq * bkv * head_dim, segment=1),
    )
    return TileProgram(
        name=f"{name}_h{H}_q{seq_q}_kv{seq_kv}_d{head_dim}_b{bq}x{bkv}",
        grid_dims=(LoopDim(h, H), LoopDim(gq, _ceil(seq_q, bq))),
        seq_dims=(LoopDim(kv, _ceil(seq_kv, bkv)),),
        loads=loads, stores=stores, body=body,
        accumulators=(("O_acc", bq * head_dim * 4), ("m_l", 2 * bq * 4)))


def moe_gmm_program(n_experts: int, capacity: int, d_in: int, d_out: int, *,
                    bm: int, bn: int, bk: int, dtype_bytes: int = 2,
                    acc_bytes: int = 4, name: str = "moe_gmm",
                    tensor_names: Tuple[str, str, str] = ("X", "W", "O")
                    ) -> TileProgram:
    """Grouped per-expert GEMM (the MoE FFN contraction):
    ``O[e, cap, d_out] = X[e, cap, d_in] @ W[e, d_in, d_out]``.

    Grid = (e over experts, gi over capacity tiles, gj over d_out tiles);
    sequential ``k`` over d_in tiles — the expert-contraction reduction.
    Small per-expert capacities with a deep ``d_in`` leave the parallel grid
    thin, exactly where a split-K bind on ``k`` pays.

    ``tensor_names`` renames (X, W, O) for pipeline graphs chaining two
    expert contractions through a shared hidden tensor; the default keeps
    every historical program identical.
    """
    xn, wn, on = tensor_names
    X = TensorSpec(xn, (n_experts, capacity, d_in), dtype_bytes)
    W = TensorSpec(wn, (n_experts, d_in, d_out), dtype_bytes)
    O = TensorSpec(on, (n_experts, capacity, d_out), dtype_bytes)
    e, gi, gj, k = "e", "gi", "gj", "k"
    loads = (
        TileAccess(X, AffineMap.from_terms({e: 1}, {gi: 1}, {k: 1}),
                   (1, bm, bk), "load"),
        TileAccess(W, AffineMap.from_terms({e: 1}, {k: 1}, {gj: 1}),
                   (1, bk, bn), "load"),
    )
    stores = (
        TileAccess(O, AffineMap.from_terms({e: 1}, {gi: 1}, {gj: 1}),
                   (1, bm, bn), "store"),
    )
    body = (TileOp("matmul", "mat", work=2.0 * bm * bn * bk, segment=0),)
    return TileProgram(
        name=f"{name}_e{n_experts}_c{capacity}_{d_in}x{d_out}_b{bm}x{bn}x{bk}",
        grid_dims=(LoopDim(e, n_experts), LoopDim(gi, _ceil(capacity, bm)),
                   LoopDim(gj, _ceil(d_out, bn))),
        seq_dims=(LoopDim(k, _ceil(d_in, bk)),),
        loads=loads, stores=stores, body=body,
        accumulators=(("O_acc", bm * bn * acc_bytes),))


def block_shape_candidates(M: int, N: int, K: int, *,
                           granule: int = 32,
                           max_block: int = 256) -> Tuple[Tuple[int, int, int], ...]:
    """Front-end block-shape exploration (paper S2.1: "It explores candidate
    block shapes: tile sizes and layouts").  Powers-of-two multiples of the
    hardware granule (Tensix tiles are 32x32; TPU MXU lanes are 128)."""
    opts = []
    size = granule
    while size <= max_block:
        opts.append(size)
        size *= 2
    cands = []
    for bm in opts:
        if bm > max(granule, M):
            continue
        for bn in opts:
            if bn > max(granule, N):
                continue
            for bk in opts:
                if bk > max(granule, K):
                    continue
                cands.append((bm, bn, bk))
    return tuple(cands)
