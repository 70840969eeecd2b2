"""FlashAttention backward (K2-bwd): wrapper, launch counter and plain version.

The reference has no counterpart: ``jax.grad`` through its Pallas kernel
``repro/kernels/flash_attention.py`` fails, and it trains on its XLA path.
The port sends every prompt-length attention through K2, so training needs
K2's gradient.  :func:`flash_attention_bwd` takes q, k, v, the forward's
output ``o``, its float32 log-sum-exp ``lse`` (``flash_attention(...,
return_lse=True)``) and ``dout``, and returns dq, dk, dv with the forward's
semantics: causal masking by absolute position, Sq != Skv, grouped-query
k/v (un-repeated, or the strided (batch, kv_heads, Skv, d) view the layers
hand over), the query offset (``q_offset``: row r masks as position
``q_offset + r``) and zero gradient for a row whose keys are all masked.

The CUDA kernel (``csrc/flash_attention_bwd.cu``) is two launches.  In bf16
both run their products on the tensor cores (``mma.sync``): dQ (which also
writes delta = rowsum(P dP), summed by a first pass over its key tiles from
the P it recomputes: from the bf16 o the rows of dS would not sum to 0, and
where a pass's keys are nearly alike, as in seamless-m4t-medium's cross
attention at its first step, that shift outweighs the query and key
gradients) with one block per (query head, 64-row query tile), then dK and
dV with one block per (query head, 64-key tile), the blocks of one kv
head's group a thread-block cluster that folds their
partial dK/dV through distributed shared memory (:func:`bwd_geometry`
mirrors the grids, the cluster and the shared memory).  At d 256 an aligned
bf16 call takes the Hopper body (``csrc/flash_attention_bwd_tma.cu``: TMA
loads, ``wgmma`` products; a dQ block of 128 query rows, each warpgroup
working its own 64 on its own; a dK/dV block whose two warpgroups share
P^T and dS^T through shared memory, each holding half of the output
columns, with no cluster: it walks its group's query heads in turn).  An
unaligned one keeps the mma.sync body, which at d 256 cuts the output
columns in two over ``gridDim.z`` (:func:`bwd_column_splits`).  float32
keeps the first scalar body, whose dK/dV block loops over its group's
query heads.  Which body a call takes is ``flash_attention.body_of`` its
arguments, decided before the launch; :data:`launches_by_body` counts each.
No float atomics: the result repeats exactly.  :data:`launches` counts calls
of the wrapper that reached the card; one call is those two kernel launches.
A tensor on the CPU goes to :func:`flash_attention_bwd_plain`; a CUDA tensor
launches or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from . import work as _work
from .flash_attention import BODIES, COMPILED_HEAD_DIMS, NEG_INF, TMA_HEAD_DIM, _kv_4d, body_of
from .gemm import SM_SMEM

launches = 0                        # calls of flash_attention_bwd() on the card (2 kernels each)
launches_by_body = {b: 0 for b in BODIES}

BWD_ROWS = 64                       # bf16: query rows of a dQ block, key rows of a dK/dV block
TMA_DQ_ROWS, TMA_DQ_KEYS = 128, 32  # the TMA body's dQ block: query rows, keys a ring tile
MAX_CLUSTER = 8                     # the portable cluster size


def _bf16_body(d: int, body: Optional[str]) -> str:
    """The bf16 body of an aligned call at this head dim, unless named."""
    return body or ("tma" if d == TMA_HEAD_DIM else "mma")


def bwd_smem_bytes(d: int, kernel: str, elem_size: int, body: Optional[str] = None) -> int:
    """Shared memory one block of the ``"dq"`` or ``"dkv"`` launch takes,
    for the body an aligned call runs unless ``body`` names another.
    ``"tma"`` (d 256; mirrors ``repro_flash_bwd_tma_smem_bytes``): 1 KB for
    the swizzle's alignment, unpadded tiles of 256 columns, and five
    mbarriers; the dQ block 128 rows of Q and dO and two ring stages of 32
    rows of K and V, the dK/dV block 64 rows of K and V,
    two ring stages of 64 rows of Q and dO and two 8 KB bf16 tiles each of
    P^T and dS^T.  ``"mma"`` (mirrors
    ``repro_flash_bwd_smem_bytes``): 64-row tiles with rows padded by 16
    bytes, the dQ block's Q and dO and two stages of K and V, the dK/dV
    block's K and V and two stages of Q, dO and their rows' float32 lse and
    delta.  float32 (the scalar body): float32 tiles with rows padded by one
    float, 64-row dQ blocks (32-row at d 256) and 32-row dK/dV blocks."""
    if elem_size == 2 and _bf16_body(d, body) == "tma":
        row = d * 2
        if kernel == "dq":
            tiles = 2 * TMA_DQ_ROWS * row + 2 * 2 * TMA_DQ_KEYS * row
        else:
            tiles = 6 * BWD_ROWS * row + 4 * BWD_ROWS * 128
        return 1024 + tiles + 8 * 5
    if elem_size == 2:
        tile = BWD_ROWS * (d + 8) * 2
        return 6 * tile if kernel == "dq" else 6 * tile + 2 * 2 * BWD_ROWS * 4
    ld = d + 1
    if kernel == "dq":
        bq = 32 if d > 128 else 64
        return (2 * bq * ld + 2 * 64 * ld + bq * 65 + 2 * bq) * 4
    return (2 * 32 * ld + 2 * 64 * ld + 2 * 64 * 33 + 2 * 64) * 4


def bwd_column_splits(d: int, body: Optional[str] = None) -> int:
    """Parts the bf16 launches cut the output columns into over the grid
    (``gridDim.z``).  The mma.sync body: 1 up to d 128; 2 at d 256, where a
    warp's dK and dV rows over the whole d would take 256 float32 registers
    a thread, each part computing S and dP over the whole d again.  The TMA
    body (aligned calls at d 256): 1, its two warpgroups each holding half
    of the columns of one block."""
    if d <= 128 or _bf16_body(d, body) == "tma":
        return 1
    return d // 128


def bwd_cluster(q_per_kv: int) -> int:
    """Blocks of one bf16 dK/dV cluster: the largest divisor of the group
    that is at most :data:`MAX_CLUSTER` (each block then takes
    ``q_per_kv // bwd_cluster(q_per_kv)`` of the group's query heads)."""
    c = min(q_per_kv, MAX_CLUSTER)
    while c > 1 and q_per_kv % c:
        c -= 1
    return max(c, 1)


def bwd_geometry(BH: int, Sq: int, Skv: int, d: int, q_per_kv: int = 1,
                 causal: bool = True, q_offset: int = 0, body: Optional[str] = None) -> dict:
    """The two bf16 launches of one call, on the body an aligned call runs
    unless ``body`` names another: for each, the grid (with a third axis,
    the column parts, on the mma.sync body at d 256), the cluster, the
    shared memory of a block, the blocks one SM holds (by shared memory and
    what ``__launch_bounds__`` asks for: two, or one at d 256) and each
    block's work in (64 x 64)-tile pairs, in the order the blocks launch.
    The TMA body has no cluster (a dK/dV block takes every query head of its
    group) and a dQ block of 128 query rows."""
    n = BWD_ROWS
    nq, nkv = -(-Sq // n), -(-Skv // n)
    tma = d == TMA_HEAD_DIM and _bf16_body(d, body) == "tma"
    cl = 1 if tma else bwd_cluster(q_per_kv)
    heads = q_per_kv // cl
    parts = bwd_column_splits(d, body)
    z = () if parts == 1 else (parts,)

    def per_sm(smem: int) -> int:
        return min(1 if d > 128 else 2, SM_SMEM // (smem + 1024))

    # dQ: query tiles heaviest first (gridDim.y reversed), key tiles a row sees;
    # the TMA body's block takes two 64-row tiles
    rows_q = TMA_DQ_ROWS if tma else n
    nq = -(-Sq // rows_q)
    dq_work = []
    for y in range(nq):
        q0 = (nq - 1 - y) * rows_q
        pairs = 0
        for r in range(q0, min(Sq, q0 + rows_q), n):
            end = min(Skv, q_offset + r + n) if causal else Skv
            pairs += -(-end // n)
        dq_work += [pairs] * BH
    # dK/dV: key tiles in order (the first sees most queries), query tiles
    # from the first row that can see the tile, for each of the block's heads
    dkv_work = []
    for y in range(nkv):
        first = (max(0, y * n - q_offset) // n) * n if causal else 0
        tiles = -(-(Sq - first) // n) if first < Sq else 0
        dkv_work += [heads * tiles] * (BH // q_per_kv * cl)
    dq_work, dkv_work = dq_work * parts, dkv_work * parts
    smem_q, smem_kv = bwd_smem_bytes(d, "dq", 2, body), bwd_smem_bytes(d, "dkv", 2, body)
    return {"dq": {"grid": (BH, nq, *z), "cluster": 1, "smem": smem_q,
                   "blocks_per_sm": per_sm(smem_q), "work": dq_work},
            "dkv": {"grid": (BH // q_per_kv * cl, nkv, *z), "cluster": cl,
                    "heads_per_block": heads, "smem": smem_kv,
                    "blocks_per_sm": per_sm(smem_kv), "work": dkv_work}}


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                              sm_scale: Optional[float] = None, causal: bool = False,
                              q_per_kv: int = 1, q_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, written from the formula in
    float32 (no autograd): P = exp(sm_scale q k^T - lse), 0 where masked
    (by position, row r at ``q_offset + r``, or at or below the -1e30
    sentinel as in the forward);
    dV = P^T dO; dS = P (dP - rowsum(P dP)) with dP = dO v^T (rowsum(dO o)
    for the exact o, as the bf16 kernel sums it); dQ = sm_scale dS k;
    dK = sm_scale dS^T q, the query heads of a group summed.  dk/dv come back
    contiguous in the shape ``k``/``v`` were given in, in their dtype."""
    BH, Sq, d = q.shape
    k4 = _kv_4d(k, BH, q_per_kv, "k")
    v4 = _kv_4d(v, BH, q_per_kv, "v")
    Skv = k4.shape[2]
    kf = k4.reshape(-1, Skv, d).float().repeat_interleave(q_per_kv, dim=0)
    vf = v4.reshape(-1, Skv, d).float().repeat_interleave(q_per_kv, dim=0)
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    qf, dof = q.float(), dout.float()
    s = torch.einsum("hqd,hkd->hqk", qf, kf) * sm_scale
    visible = s > 0.5 * NEG_INF
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Skv, device=q.device)[None, :]
        visible = visible & (qi >= ki)
    p = torch.where(visible, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    dv = torch.einsum("hqk,hqd->hkd", p, dof)
    dp = torch.einsum("hqd,hkd->hqk", dof, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("hqk,hkd->hqd", ds, kf) * sm_scale
    dk = torch.einsum("hqk,hqd->hkd", ds, qf) * sm_scale

    def fold(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        g = g.reshape(-1, q_per_kv, Skv, d).sum(dim=1)
        return g.reshape(like.shape).to(like.dtype)

    return dq.to(q.dtype), fold(dk, k), fold(dv, v)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *,
                        sm_scale: Optional[float] = None, causal: bool = False,
                        q_per_kv: int = 1, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, o, dout: (BH, Sq, d); k/v: (BH / q_per_kv, Skv, d) or a strided
    (batch, kv_heads, Skv, d) view; lse: (BH, Sq) float32 from the forward
    (given the same ``q_offset``) -> (dq like q, dk and dv contiguous in the
    shape of k and v)."""
    global launches
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, Sq, d), got {tuple(q.shape)}")
    BH, Sq, d = q.shape
    if o.shape != q.shape or dout.shape != q.shape or lse.shape != (BH, Sq):
        raise ValueError(f"o {tuple(o.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} must match q {tuple(q.shape)}")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, dout, sm_scale=sm_scale,
                                         causal=causal, q_per_kv=q_per_kv,
                                         q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda tensors, not {q.device}")
    k4 = _kv_4d(k, BH, q_per_kv, "k")
    v4 = _kv_4d(v, BH, q_per_kv, "v")
    if k4.shape != v4.shape or k4.shape[3] != d:
        raise ValueError(f"k {tuple(k4.shape)} and v {tuple(v4.shape)} must agree with "
                         f"each other and with d={d}")
    if not (q.dtype == k4.dtype == v4.dtype == o.dtype == dout.dtype) or \
            q.dtype not in (torch.float32, torch.bfloat16) or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16 q, k, v, o, dout of "
                        f"one type and a float32 lse, got {q.dtype}, {k4.dtype}, {v4.dtype}, "
                        f"{o.dtype}, {dout.dtype}, {lse.dtype}")
    if any(t.device != q.device for t in (k4, v4, o, lse, dout)):
        raise ValueError("all operands must lie on one device")
    if d not in COMPILED_HEAD_DIMS:
        raise ValueError(f"head dimension {d} is not compiled; choose from "
                         f"{COMPILED_HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, o, dout, lse)) or k4.stride(3) != 1 \
            or v4.stride(3) != 1:
        raise ValueError("q, o, dout and lse must be contiguous and k/v contiguous along d")
    Skv = k4.shape[2]
    if Sq < 1 or Skv < 1:
        raise ValueError("empty sequences are not supported")
    sm_scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    dq = torch.empty_like(q)
    dk = torch.empty(k4.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v4.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    strides = [k4.stride(0), k4.stride(1), k4.stride(2),
               v4.stride(0), v4.stride(1), v4.stride(2)]
    heads_per_batch = k4.shape[1] * q_per_kv
    body = body_of(q.dtype, d, strides,
                   [t.data_ptr() for t in (q, k4, v4, o, dout, dq, dk, dv)])
    lib = _build.lib()
    fn = {"tma": lib.repro_flash_attention_bwd_tma, "mma": lib.repro_flash_attention_bwd_bf16,
          "f32": lib.repro_flash_attention_bwd_f32}[body]
    # the TMA body is compiled at d 256 only and takes no head dim
    dims = (BH, Sq, Skv) if body == "tma" else (BH, Sq, Skv, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k4.data_ptr(), v4.data_ptr(), o.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), *dims, heads_per_batch, q_per_kv, *strides,
                  sm_scale, int(causal), q_offset, stream)
    _build.check(code, f"flash_attention_bwd BH={BH} Sq={Sq} Skv={Skv} d={d} body {body}")
    launches += 1
    launches_by_body[body] += 1
    _work.add("flash_attention_bwd", _work.attention_bwd_flops(BH, Sq, Skv, d, causal, q_offset),
              _work.attention_bwd_bytes(q, k4, v4, o, lse, dout, body))
    return dq, dk.reshape(k.shape), dv.reshape(v.shape)
