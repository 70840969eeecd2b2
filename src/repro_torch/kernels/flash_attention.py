"""FlashAttention forward: wrapper, launch counter and plain version.

Counterpart of ``repro/kernels/flash_attention.py``.  The CUDA kernel
(``csrc/flash_attention.cuh``) gives one thread block a (head, query tile)
pair and loops over the KV axis inside it; in bf16 each warp keeps its
scores, probabilities and output in registers (``mma.sync``) while the next
K/V tile arrives by ``cp.async``.  At head dim 256 an aligned bf16 call
takes the Hopper body instead (``csrc/flash_attention_tma.cu``: TMA loads,
``wgmma`` products, one consumer warpgroup per 64 query rows); which body a
call takes is :func:`body_of` its arguments, decided before the launch, and
:data:`launches_by_body` counts each.  It is compiled for head
dimensions :data:`COMPILED_HEAD_DIMS` and the tiles :data:`COMPILED_TILES`;
the planner (``core/lower_torch.py``) chooses among those that fit a block's
shared memory.  A tensor on the CPU goes to :func:`flash_attention_plain`; a
CUDA tensor launches the kernel or raises.

Grouped-query attention: ``k``/``v`` may hold fewer heads than ``q``
(``q_per_kv`` query heads share one kv head, in the reference's
``jnp.repeat`` order) and may come as a strided 4-D view
``(batch, kv_heads, Skv, d)``, so the serving path hands over the projected
keys without a repeated or transposed copy.

With ``return_lse=True`` the kernel also writes each query row's float32
log-sum-exp of the scaled, masked scores, (BH, Sq), which the backward
(:mod:`repro_torch.kernels.flash_attention_bwd`) reads; a row whose keys are
all masked gets :data:`LSE_MASKED`.  Without it (the serving path) no
pointer is passed and the launch is the same as before.

``q_offset`` is the causal position of query row 0: row r masks as position
``q_offset + r`` against key positions from 0.  Context-parallel attention
(``models/layers.py`` under a plan that splits the sequence) hands a rank's
query block with the prefix of keys it may see; ``q_offset=0`` is the
whole-sequence kernel, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from . import work as _work
from .gemm import SM_SMEM

NEG_INF = -1e30
LSE_MASKED = 1e30                   # log-sum-exp of a row with no visible key
COMPILED_HEAD_DIMS = (32, 64, 128, 256)
TILE_Q = (64, 128)
TILE_KV = (32, 64)
COMPILED_TILES = tuple((bq, bkv) for bq in TILE_Q for bkv in TILE_KV)
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_KV = 64
MAX_SMEM = 232448                   # bytes one block may use on sm_90
TMA_HEAD_DIM = 256                  # the head dim the TMA + wgmma body serves
# "tma": TMA + wgmma (bf16, d 256, aligned); "mma": the mma.sync body (every
# other bf16 call); "f32": the float32 body
BODIES = ("tma", "mma", "f32")

launches = 0                        # kernel launches made by flash_attention()
launches_by_body = {b: 0 for b in BODIES}


def body_of(dtype: torch.dtype, d: int, strides, pointers) -> str:
    """The body a CUDA call runs, from its arguments alone: ``"tma"`` for
    bf16 at head dim 256 whose k/v strides (in elements) are multiples of 8
    and whose pointers are 16-byte aligned (TMA's rule for addresses and
    row strides), ``"mma"`` for any other bf16 call, ``"f32"`` for float32."""
    if dtype == torch.float32:
        return "f32"
    aligned = all(s % 8 == 0 for s in strides) and all(p % 16 == 0 for p in pointers)
    return "tma" if d == TMA_HEAD_DIM and aligned else "mma"


def flash_smem_bytes(bq: int, bkv: int, d: int, elem_size: int,
                     body: Optional[str] = None) -> int:
    """Shared memory one block of the kernel takes, for the body an aligned
    call of this head dim and element size runs unless ``body`` names
    another.  ``"tma"`` (mirrors ``FwdCfg`` in ``csrc/flash_attention_tma.cu``):
    1 KB for the 128-byte swizzle's alignment, the Q tile and two stages of
    K and V tiles, unpadded, and seven mbarriers.  ``"mma"`` (``FlashLayout``
    in ``csrc/flash_attention.cuh``): the Q tile and two stages of K and V
    tiles, rows padded by 16 bytes; scores, probabilities and output stay in
    registers.  float32: the Q, K and V tiles, float32 scores and the float32
    output accumulator (at d 256 only the (64, 32) tile fits)."""
    if body is None and elem_size == 2:
        body = "tma" if d == TMA_HEAD_DIM else "mma"
    if body == "tma":
        return 1024 + (bq + 2 * 2 * bkv) * d * 2 + 8 * 7
    if elem_size == 2:
        return (bq + 2 * 2 * bkv) * (d + 8) * 2
    qkv = (bq + 2 * bkv) * (d + 4) * 4
    return qkv + bq * (bkv + 4) * 4 + bq * (d + 4) * 4


def tma_blocks_per_sm(bq: int, bkv: int) -> int:
    """Blocks of the TMA body an SM holds (its ``__launch_bounds__``): two
    where a block of one consumer warpgroup leaves room for a second in
    shared memory ((64, 32): 160 threads, at most 200 registers each), else
    one."""
    fits = 2 * (flash_smem_bytes(bq, bkv, TMA_HEAD_DIM, 2) + 1024) <= SM_SMEM
    return 2 if bq == 64 and fits else 1


def legal_tiles(d: int, elem_size: int) -> Tuple[Tuple[int, int], ...]:
    """The compiled tiles whose shared memory fits one block."""
    return tuple(t for t in COMPILED_TILES
                 if flash_smem_bytes(t[0], t[1], d, elem_size) <= MAX_SMEM)


def _kv_4d(x: torch.Tensor, BH: int, q_per_kv: int, name: str) -> torch.Tensor:
    """``k`` or ``v`` as a (batch, kv_heads, Skv, d) view."""
    if x.dim() == 3:
        x = x.unsqueeze(1)
    if x.dim() != 4:
        raise ValueError(f"{name} must be (heads, Skv, d) or (batch, kv_heads, Skv, d), "
                         f"got {tuple(x.shape)}")
    if x.shape[0] * x.shape[1] * q_per_kv != BH:
        raise ValueError(f"{name} holds {x.shape[0] * x.shape[1]} heads; with q_per_kv="
                         f"{q_per_kv} that does not match the {BH} query heads")
    return x


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          sm_scale: Optional[float] = None, causal: bool = False,
                          block_q: Optional[int] = None,
                          block_kv: Optional[int] = None,
                          q_per_kv: int = 1, return_lse: bool = False,
                          q_offset: int = 0):
    """The kernel's function in plain PyTorch, float32 throughout: the
    -1e30 sentinel, causal masking by absolute position (row r at
    ``q_offset + r``), and 0 for a row whose keys are all masked.
    ``block_q``/``block_kv`` change nothing.
    With ``return_lse`` also each row's float32 log-sum-exp (BH, Sq)."""
    BH, Sq, d = q.shape
    k4 = _kv_4d(k, BH, q_per_kv, "k")
    v4 = _kv_4d(v, BH, q_per_kv, "v")
    Skv = k4.shape[2]
    kf = k4.reshape(-1, Skv, d).float().repeat_interleave(q_per_kv, dim=0)
    vf = v4.reshape(-1, Skv, d).float().repeat_interleave(q_per_kv, dim=0)
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    s = torch.einsum("hqd,hkd->hqk", q.float(), kf) * sm_scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.einsum("hqk,hkd->hqd", p, vf)
           / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, torch.full_like(l, LSE_MASKED), m + torch.log(l))
    return out, lse.squeeze(-1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: Optional[float] = None, causal: bool = False,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_kv: int = DEFAULT_BLOCK_KV,
                    q_per_kv: int = 1, return_lse: bool = False, q_offset: int = 0):
    """q: (BH, Sq, d); k/v: (BH / q_per_kv, Skv, d) or a 4-D strided view
    (batch, kv_heads, Skv, d) -> (BH, Sq, d), and with ``return_lse`` also
    the float32 log-sum-exp (BH, Sq).  ``q_offset`` (>= 0): the causal
    position of query row 0.

    On a CUDA tensor ``(block_q, block_kv)`` must be one of
    :data:`COMPILED_TILES` that fits shared memory for this ``d`` and type;
    sequence lengths that the tile does not divide are masked in the kernel."""
    global launches
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, Sq, d), got {tuple(q.shape)}")
    BH, Sq, d = q.shape
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale=sm_scale, causal=causal,
                                     q_per_kv=q_per_kv, return_lse=return_lse,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")
    k4 = _kv_4d(k, BH, q_per_kv, "k")
    v4 = _kv_4d(v, BH, q_per_kv, "v")
    if k4.shape != v4.shape or k4.shape[3] != d:
        raise ValueError(f"k {tuple(k4.shape)} and v {tuple(v4.shape)} must agree with "
                         f"each other and with d={d}")
    if not (q.dtype == k4.dtype == v4.dtype) or q.dtype not in (torch.float32,
                                                                torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16 tensors of one type, "
                        f"got {q.dtype}, {k4.dtype}, {v4.dtype}")
    if k4.device != q.device or v4.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if d not in COMPILED_HEAD_DIMS:
        raise ValueError(f"head dimension {d} is not compiled; choose from "
                         f"{COMPILED_HEAD_DIMS}")
    if not q.is_contiguous() or k4.stride(3) != 1 or v4.stride(3) != 1:
        raise ValueError("q must be contiguous and k/v contiguous along d")
    Skv = k4.shape[2]
    if Sq < 1 or Skv < 1:
        raise ValueError("empty sequences are not supported")
    es = q.element_size()
    if (block_q, block_kv) not in legal_tiles(d, es):
        raise ValueError(f"tile {(block_q, block_kv)} is not available for d={d}, "
                         f"{q.dtype}; choose from {legal_tiles(d, es)}")
    sm_scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    vec = 16 // es
    strides = [k4.stride(0), k4.stride(1), k4.stride(2),
               v4.stride(0), v4.stride(1), v4.stride(2)]
    vec_ok = int(all(s % vec == 0 for s in strides)
                 and all(t.data_ptr() % 16 == 0 for t in (q, k4, v4)))
    body = body_of(q.dtype, d, strides, [t.data_ptr() for t in (q, k4, v4, out)])
    heads_per_batch = k4.shape[1] * q_per_kv
    lse_ptr = lse.data_ptr() if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body == "tma":
            code = _build.lib().repro_flash_attention_tma(
                q.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(), lse_ptr, BH, Sq,
                Skv, heads_per_batch, q_per_kv, *strides, sm_scale, int(causal), q_offset,
                block_q, block_kv, stream)
        else:
            fn = (_build.lib().repro_flash_attention_bf16 if body == "mma"
                  else _build.lib().repro_flash_attention_f32)
            code = fn(q.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(), lse_ptr, BH,
                      Sq, Skv, d, heads_per_batch, q_per_kv, *strides, sm_scale, int(causal),
                      q_offset, block_q, block_kv, vec_ok, stream)
    _build.check(code, f"flash_attention BH={BH} Sq={Sq} Skv={Skv} d={d} tile "
                       f"{(block_q, block_kv)} body {body}")
    launches += 1
    launches_by_body[body] += 1
    _work.add("flash_attention", _work.attention_flops(BH, Sq, Skv, d, causal, q_offset),
              _work.nbytes(q, k4, v4, out))
    return (out, lse) if return_lse else out
