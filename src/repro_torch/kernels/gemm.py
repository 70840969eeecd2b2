"""Planner-blocked GEMM: wrapper, launch counters and plain version.

Counterpart of ``repro/kernels/gemm.py``.  Two CUDA bodies compute it:

* ``"tma"`` (``csrc/gemm_sm90.cuh``): bf16 only.  A producer warp keeps a
  ring of shared-memory stages filled by TMA and one or two consumer
  warpgroups multiply with ``wgmma``; tiles :data:`TMA_TILES` (BK 64), in
  dynamic shared memory up to :data:`MAX_DYNAMIC_SMEM`.  A product with few
  k-steps takes the short-K ring (one stage a k-step, two blocks an SM;
  :func:`tma_shallow`), any other the deepest ring that fits.
* ``"staged"`` (``csrc/gemm.cuh``): float32 on the CUDA cores, and bf16
  operands that TMA cannot take; tiles :data:`STAGED_TILES`, in static
  shared memory up to :data:`MAX_STATIC_SMEM`.

Either operand may also come as the ``.t()`` of a contiguous tensor, as the
backward hands them over: dA = dC B^T takes ``b.t()`` and dB = A^T dC takes
``a.t()`` (:func:`operand_layouts`).  The TMA body reads such an operand as
it is stored, A as (K, M) or B as (N, K), so the backward makes no
transposing copy; its rows as stored must be whole 16-byte pieces (M a
multiple of 8 for a transposed A), and at most one operand may be
transposed.  The staged body copies a transposed operand to row-major
first.  What bounds the backward is then K1's own rate: its two products
run at the forward's speed, and the copies of A and B (about 106 MB of
device memory traffic at qwen2.5-3b's projection) are gone.

:func:`operand_body` picks the body from the dtype, the shapes, the layouts
and the pointers before the launch; :func:`nearest_tile` moves a requested
tile to that body's closest compiled one.  A tensor on the CPU goes to
:func:`gemm_plain`; a CUDA tensor launches a kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build
from . import work as _work

TILE_M = (64, 128)                  # the staged body's tile sizes
TILE_N = (64, 128)
TILE_K = (16, 32)
STAGED_TILES = tuple((bm, bn, bk) for bm in TILE_M for bn in TILE_N for bk in TILE_K)
TMA_TILE_M = (64, 128)              # the TMA body's: one consumer warpgroup per 64 rows
TMA_TILE_N = (64, 128, 256)
TMA_BK = 64                         # one 128-byte swizzle row of bf16
TMA_TILES = tuple((bm, bn, TMA_BK) for bm in TMA_TILE_M for bn in TMA_TILE_N)
COMPILED_TILES = STAGED_TILES + TMA_TILES
BODIES = ("tma", "staged")
DEFAULT_BLOCK = (128, 128, 32)
MAX_STATIC_SMEM = 48 * 1024         # the staged body's shared memory is static
MAX_DYNAMIC_SMEM = 232448           # what one block may take on sm_90
SM_SMEM = 233472                    # an SM's shared memory, 1 KB of it kept per block
_THREADS = 256                      # the staged body's block
_ALIGN = 1024                       # the TMA body aligns its ring to the swizzle atom

launches = 0                        # kernel launches made by gemm() / gemm_on_body()
launches_by_body = {b: 0 for b in BODIES}


def tile_body(tile: Sequence[int]) -> str:
    """The body a compiled tile belongs to (the two tile sets are disjoint:
    the TMA body's BK is 64)."""
    return "tma" if tuple(tile) in TMA_TILES else "staged"


def body_tiles(body: str) -> Tuple[Tuple[int, int, int], ...]:
    return TMA_TILES if body == "tma" else STAGED_TILES


def smem_limit(tile: Sequence[int]) -> int:
    """Shared memory one block of the tile's body may take."""
    return MAX_DYNAMIC_SMEM if tile_body(tile) == "tma" else MAX_STATIC_SMEM


def tma_stages(bm: int, bn: int, blocks_per_sm: int = 1) -> int:
    """Stages of the TMA body's deepest ring when ``blocks_per_sm`` blocks
    share an SM: as many as fit, each with its A and B tiles and two 8-byte
    mbarriers (``sm90::stages``)."""
    limit = MAX_DYNAMIC_SMEM if blocks_per_sm == 1 else SM_SMEM // blocks_per_sm - 1024
    return (limit - _ALIGN) // ((bm + bn) * TMA_BK * 2 + 16)


def tma_shallow(bm: int, bn: int, K: int) -> bool:
    """Whether a TMA product of depth ``K`` runs the short-K ring
    (``sm90::shallow``): one stage a k-step, two blocks an SM, for every tile
    but (128, 256), when its k-steps fit the two-block ring."""
    return K > 0 and (bm, bn) != (128, 256) and -(-K // TMA_BK) <= tma_stages(bm, bn, 2)


def gemm_smem_bytes(bm: int, bn: int, bk: int, elem_size: int, K: int = 0) -> int:
    """Shared memory one block takes, mirroring ``repro_gemm_smem_bytes``.

    A bf16 tile with BK 64 is the TMA body's: the alignment slack and the
    ring's stages of A and B tiles and their two mbarriers
    (``sm90::smem_bytes`` in ``csrc/gemm_sm90.cuh``), for a product of depth
    ``K``: the short-K ring's one stage a k-step where :func:`tma_shallow`
    says so, else (and for ``K`` <= 0, the most any depth takes)
    :func:`tma_stages` stages.  Any other tile is the staged body's
    (``gemm_smem_bytes`` in ``csrc/gemm.cuh``): the padded A and B tiles,
    two stages of them for bf16, and for bf16 one 16 x 16 float staging
    tile per warp for the epilogue."""
    if elem_size == 2 and bk == TMA_BK:
        n = -(-K // TMA_BK) if tma_shallow(bm, bn, K) else tma_stages(bm, bn)
        return _ALIGN + n * ((bm + bn) * TMA_BK * 2 + 16)
    pad = 16 // elem_size
    ab = (bm * (bk + pad) + bk * (bn + pad)) * elem_size
    if elem_size == 2:
        return 2 * ab + (_THREADS // 32) * 256 * 4
    return ab


def shape_body(dtype: torch.dtype, K: int, N: int) -> str:
    """The body a product of this type and shape takes when its operands are
    16-byte aligned: TMA needs bf16 and rows of whole 16-byte pieces."""
    return "tma" if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 else "staged"


def gemm_body(dtype: torch.dtype, K: int, N: int, *data_ptrs: int, M: int = 0,
              a_t: bool = False, b_t: bool = False) -> str:
    """The body that computes a (M, K) @ (K, N) product of this type from
    operands at these addresses, A stored (K, M) when ``a_t`` and B stored
    (N, K) when ``b_t``: ``"tma"`` when :func:`shape_body` says so, every
    base is 16-byte aligned, at most one operand is transposed and, for a
    transposed A, M is a multiple of 8 (its rows as stored); else
    ``"staged"``."""
    if (shape_body(dtype, K, N) == "tma" and all(p % 16 == 0 for p in data_ptrs)
            and not (a_t and b_t) and not (a_t and M % 8)):
        return "tma"
    return "staged"


def stored_transposed(t: torch.Tensor, op: str) -> bool:
    """Whether an operand is a contiguous tensor with its last two dimensions
    swapped (``.t()``, ``.transpose(1, 2)``) rather than contiguous itself;
    raises for any other layout.  The K1 and K4 wrappers share this rule."""
    if t.is_contiguous():
        return False
    if t.transpose(-2, -1).is_contiguous():
        return True
    raise ValueError(f"{op} takes contiguous operands or transposes of contiguous ones "
                     f"(the last two dimensions swapped)")


def operand_layouts(a: torch.Tensor, b: torch.Tensor) -> Tuple[bool, bool]:
    """(a_t, b_t): whether ``a`` is stored (K, M) and ``b`` (N, K), each the
    ``.t()`` of a contiguous tensor, rather than row-major."""
    return stored_transposed(a, "gemm"), stored_transposed(b, "gemm")


def operand_body(a: torch.Tensor, b: torch.Tensor) -> str:
    """:func:`gemm_body` for these operands as they lie: their dtype,
    shapes, layouts and addresses."""
    a_t, b_t = operand_layouts(a, b)
    return gemm_body(a.dtype, a.shape[1], b.shape[1], a.data_ptr(), b.data_ptr(),
                     M=a.shape[0], a_t=a_t, b_t=b_t)


def snap_tile(b: int, options: Sequence[int]) -> int:
    """The largest compiled size that does not exceed ``b`` (the smallest
    one when ``b`` is below all of them; the kernel masks the edge)."""
    fits = [o for o in options if o <= b]
    return max(fits) if fits else min(options)


def nearest_tile(block: Sequence[int], body: str) -> Tuple[int, int, int]:
    """``block`` moved to the closest compiled tile of ``body``: each side
    snapped to that body's sizes."""
    bm, bn, bk = (int(x) for x in block)
    if body == "tma":
        return (snap_tile(bm, TMA_TILE_M), snap_tile(bn, TMA_TILE_N), TMA_BK)
    return (snap_tile(bm, TILE_M), snap_tile(bn, TILE_N), snap_tile(bk, TILE_K))


def gemm_plain(a: torch.Tensor, b: torch.Tensor, *,
               block: Optional[Tuple[int, int, int]] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` in plain PyTorch with float32 accumulation; ``block`` is
    accepted for the kernel's signature and changes nothing."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm wants (M, K) @ (K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm takes float32 or bfloat16 operands of one type, got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm writes float32 or bfloat16, not {out_dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    operand_layouts(a, b)


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         block: Tuple[int, int, int] = DEFAULT_BLOCK,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` with an explicit tile shape.  a: (M, K), b: (K, N) -> (M, N).

    Either operand may be the ``.t()`` of a contiguous tensor.  ``block``
    must be one of :data:`COMPILED_TILES`; the body comes from
    :func:`operand_body` and runs at the tile :func:`nearest_tile` gives for
    it.  Shapes that the tile does not divide are masked inside the kernel."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.device.type == "cpu":
        return gemm_plain(a, b, block=block, out_dtype=out_dtype)
    return gemm_on_body(a, b, operand_body(a, b), block=block, out_dtype=out_dtype)


def gemm_on_body(a: torch.Tensor, b: torch.Tensor, body: str, *,
                 block: Tuple[int, int, int] = DEFAULT_BLOCK,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`gemm` on the body named, at its tile nearest ``block``: the
    way to time the two bodies on one product.  The TMA body refuses
    operands :func:`operand_body` would not give it; the staged body copies
    a transposed operand to row-major first."""
    global launches
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs its kernels on cuda tensors, not {a.device}")
    if tuple(int(x) for x in block) not in COMPILED_TILES:
        raise ValueError(f"tile {tuple(block)} is not compiled; choose from "
                         f"{COMPILED_TILES}")
    M, K = a.shape
    N = b.shape[1]
    a_t, b_t = operand_layouts(a, b)
    if body == "tma" and operand_body(a, b) != "tma":
        raise ValueError(f"the TMA body takes bf16 with K, N (and M for a transposed a) "
                         f"multiples of 8, at most one transposed operand and 16-byte "
                         f"aligned bases; got {a.dtype} M={M} K={K} N={N} "
                         f"transposed {(a_t, b_t)}")
    bm, bn, bk = nearest_tile(block, body)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    out_bf16 = int(out_dtype == torch.bfloat16)
    lib = _build.lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body == "tma":
            code = lib.repro_gemm_tma_bf16(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
                                           K, out_bf16, bm, bn, int(a_t), int(b_t), stream)
        else:
            a, b = a.contiguous(), b.contiguous()
            vec = 16 // a.element_size()
            vec_ok = int(K % vec == 0 and N % vec == 0 and a.data_ptr() % 16 == 0
                         and b.data_ptr() % 16 == 0)
            fn = lib.repro_gemm_bf16 if a.dtype == torch.bfloat16 else lib.repro_gemm_f32
            code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, out_bf16,
                      bm, bn, bk, vec_ok, stream)
    _build.check(code, f"gemm {M}x{N}x{K} {body} tile {(bm, bn, bk)}")
    launches += 1
    launches_by_body[body] += 1
    _work.add("gemm", _work.gemm_flops(M, N, K), _work.nbytes(a, b, out))
    return out
