"""Flash-decode: wrappers, launch counters and plain versions.

Counterpart of ``repro/kernels/flash_decode.py``: one query token against a
long KV cache, split over the KV sequence into per-split partial
``(m, l, acc)`` statistics that a log-sum-exp combine folds.  The kernels
are in ``csrc/flash_decode.cu``.  :func:`flash_decode` computes both stages
in one launch: the splits of a (batch x kv-head) group run as one thread
block cluster (at most :data:`MAX_CLUSTER_SPLITS`) and fold their partials
through distributed shared memory.  :func:`flash_decode_partials` and
:func:`combine_partials` keep the reference's two functions, one launch
each.  In bf16 the body runs on the tensor cores, in float32 on the CUDA
cores.  Against the reference the kernels gain ``kv_valid_len``: only keys
``[0, kv_valid_len)`` of the buffer take part, the valid range (not the
buffer) is cut into splits, and nothing has to divide anything.  ``None``
means the whole buffer, which reproduces the reference kernel.

As in ``flash_attention``, ``k``/``v`` may hold ``q_per_kv`` times fewer
heads than ``q`` and may be a strided 4-D view ``(batch, kv_heads, Skv, d)``
of the serving cache.  A tensor on the CPU goes to the plain versions; a
CUDA tensor launches the kernels or raises.

At head dim 256 an aligned bf16 call takes the Hopper body
(``csrc/flash_decode_tma.cu``: a TMA ring of 32-key K and V tiles, two
blocks an SM); which body a call takes is :func:`body_of` its arguments,
decided before the launch, and :data:`launches_by_body` counts each launch
of either epilogue.  :func:`choose_splits` cuts the keys by the body: the
TMA body's splits fill one wave of one block an SM.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from . import work as _work
from .flash_attention import BODIES, COMPILED_HEAD_DIMS, NEG_INF, _kv_4d
# body_of(dtype, d, strides, pointers): the body a CUDA call runs, K2's rule
# ("tma" for aligned bf16 at d 256, "mma" for other bf16, "f32" for float32)
from .flash_attention import body_of

MAX_Q_PER_KV = 16                   # query heads one block of the kernel serves
MIN_SPLIT_KEYS = 64                 # the mma.sync and float32 bodies' inner tile
MAX_SPLITS = 64
MAX_CLUSTER_SPLITS = 8              # the portable cluster size: splits of one launch
DECODE_STAGES = 2                   # 16-key chunks each warp of the bf16 body keeps in flight
DECODE_WARPS = 4
F32_TILE = 128                      # keys per inner tile of the float32 body (64 at d 256)
TMA_TILE_KEYS = 32                  # keys a tile of the TMA body
TMA_STAGES = 3                      # tiles of its ring
TMA_BLOCKS_PER_SM = 2               # its blocks an SM can hold (its launch bounds)

launches = 0                        # launches made by flash_decode()
partials_launches = 0               # launches made by flash_decode_partials()
combine_launches = 0                # launches made by combine_partials()
# K3's launches (flash_decode() and flash_decode_partials()) by body
launches_by_body = {b: 0 for b in BODIES}


def body_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_per_kv: int = 1) -> str:
    """:func:`body_of` the tensors of a call, k/v as the wrappers take them."""
    k4 = _kv_4d(k, q.shape[0], q_per_kv, "k")
    v4 = _kv_4d(v, q.shape[0], q_per_kv, "v")
    return body_of(q.dtype, q.shape[-1], [*k4.stride()[:3], *v4.stride()[:3]],
                   [t.data_ptr() for t in (q, k4, v4)])


def choose_splits(kv_valid_len: int, n_groups: int, sm_count: int,
                  max_splits: int = MAX_SPLITS, body: str = "mma") -> int:
    """How many strips to cut the valid keys into, for the body that runs
    them, at most ``max_splits`` (:data:`MAX_CLUSTER_SPLITS` for the
    one-launch decode, whose splits form one cluster).  The mma.sync and
    float32 bodies: enough (batch x kv-head) x split blocks to cover the
    card's ``sm_count`` multiprocessors about twice, no strip shorter than
    their 64-key tile.  The TMA body: as many splits as fit one wave of
    one block an SM (or one split where the groups alone fill it), no strip
    shorter than its 32-key tile.  Its blocks are sized to share an SM two
    at a time, but at gemma-7b's 64 groups 2 splits (128 blocks) ran
    faster than the 4 that fill both slots, at 513, 2,049 and 4,096 keys
    (``PERF.md``); the second slot holds the groups beyond the SM count."""
    if body == "tma":
        want = sm_count // max(1, n_groups)
        by_len = max(1, kv_valid_len) // TMA_TILE_KEYS
    else:
        want = -(-2 * sm_count // max(1, n_groups))
        by_len = -(-max(1, kv_valid_len) // MIN_SPLIT_KEYS)
    return max(1, min(want, by_len, max_splits))


def decode_smem_bytes(d: int, elem_size: int, body: Optional[str] = None) -> int:
    """Dynamic shared memory of one block of the decode body (mirrors
    ``DecodeLayout``, ``decode_f32_smem_bytes`` and ``DecodeTmaLayout`` in
    ``csrc/flash_decode.cuh``), for ``body`` (default: ``"mma"`` in bf16,
    ``"f32"`` in float32).  ``"mma"`` and ``"f32"``: a split's float32
    result (m and l for 16 query rows, acc 16 x d) plus, in bf16, the 16
    query rows and each warp's ring of K and V chunks (16 keys, rows padded
    by 16 bytes), in float32 one K and one V tile of :func:`f32_tile` keys
    (rows padded by 16 bytes).  ``"tma"`` (d 256): 1 KB to align the ring,
    :data:`TMA_STAGES` stages of a K and a V tile of :data:`TMA_TILE_KEYS`
    keys (unpadded, under the swizzle), the 16 query rows (padded by 16
    bytes), two buffers of 16 x 32 float32 scores (rows padded by 32 bytes)
    and two mbarriers a stage; the result reuses the ring."""
    if body is None:
        body = "mma" if elem_size == 2 else "f32"
    if body == "tma":
        ring = TMA_STAGES * 2 * TMA_TILE_KEYS * d * 2
        scores = 2 * MAX_Q_PER_KV * (TMA_TILE_KEYS + 8) * 4
        return 1024 + ring + MAX_Q_PER_KV * (d + 8) * 2 + scores + 8 * 2 * TMA_STAGES
    result = (2 * MAX_Q_PER_KV + MAX_Q_PER_KV * d) * 4
    if body == "mma":
        ld = d + 8
        return MAX_Q_PER_KV * ld * 2 + DECODE_WARPS * DECODE_STAGES * 2 * 16 * ld * 2 + result
    return 2 * f32_tile(d) * (d + 4) * 4 + result


def f32_tile(d: int) -> int:
    """Keys a tile of the float32 body holds: :data:`F32_TILE`, or 64 at d
    256, where two 128-key tiles of K and V would not fit one block."""
    return F32_TILE if d <= 128 else F32_TILE // 2


def sm_count(device: torch.device) -> int:
    """Multiprocessors of the card ``device`` names; 1 for the CPU, whose
    plain version gains nothing from splitting."""
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def _valid_len(kv_valid_len: Optional[int], Skv: int) -> int:
    n = Skv if kv_valid_len is None else int(kv_valid_len)
    if not 0 <= n <= Skv:
        raise ValueError(f"kv_valid_len={n} outside the buffer of {Skv} keys")
    return n


def flash_decode_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                kv_splits: int = 8, sm_scale: Optional[float] = None,
                                kv_valid_len: Optional[int] = None,
                                q_per_kv: int = 1
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The partials kernel's function in plain PyTorch (float32)."""
    BH, one, d = q.shape
    assert one == 1, "decode takes a single query token"
    k4 = _kv_4d(k, BH, q_per_kv, "k")
    v4 = _kv_4d(v, BH, q_per_kv, "v")
    Skv = k4.shape[2]
    n = _valid_len(kv_valid_len, Skv)
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    kf = k4.reshape(-1, Skv, d).float().repeat_interleave(q_per_kv, dim=0)
    vf = v4.reshape(-1, Skv, d).float().repeat_interleave(q_per_kv, dim=0)
    chunk = -(-n // kv_splits) if n else 0
    ms, ls, accs = [], [], []
    for s in range(kv_splits):
        lo, hi = min(n, s * chunk), min(n, (s + 1) * chunk)
        if hi <= lo:
            ms.append(torch.full((BH, 1, 1), NEG_INF, device=q.device))
            ls.append(torch.zeros((BH, 1, 1), device=q.device))
            accs.append(torch.zeros((BH, 1, d), device=q.device))
            continue
        sc = torch.einsum("hqd,hkd->hqk", q.float(), kf[:, lo:hi]) * sm_scale
        m = sc.max(dim=-1, keepdim=True).values
        p = torch.exp(sc - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("hqk,hkd->hqd", p, vf[:, lo:hi]))
    return (torch.stack(ms, dim=1), torch.stack(ls, dim=1), torch.stack(accs, dim=1))


def combine_partials_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Log-sum-exp combine of per-split partials -> (BH, 1, d)."""
    m_g = m.max(dim=1, keepdim=True).values             # (BH, 1, 1, 1)
    scale = torch.exp(m - m_g)                           # (BH, S, 1, 1)
    l_g = (l * scale).sum(dim=1)                         # (BH, 1, 1)
    acc_g = (acc * scale).sum(dim=1)                     # (BH, 1, d)
    l_g = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    return (acc_g / l_g).to(out_dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       sm_scale: Optional[float] = None, kv_splits: int = 1,
                       kv_valid_len: Optional[int] = None,
                       q_per_kv: int = 1) -> torch.Tensor:
    """Both stages in plain PyTorch: the function ``ops.flash_decode``
    computes, in float32, cast to ``q``'s type."""
    m, l, acc = flash_decode_partials_plain(q, k, v, kv_splits=kv_splits,
                                            sm_scale=sm_scale,
                                            kv_valid_len=kv_valid_len,
                                            q_per_kv=q_per_kv)
    return combine_partials_plain(m, l, acc, out_dtype=q.dtype)


def _launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 sm_scale: Optional[float], kv_valid_len: Optional[int], q_per_kv: int,
                 kv_splits: int) -> Tuple[torch.Tensor, torch.Tensor, str, list]:
    """Check what the kernels take; return k and v as 4-D views, the body
    the call runs and its C arguments after the pointers: for ``"tma"``
    n_groups, G, hkv, buffer length, valid length, splits, six strides,
    sm_scale; else n_groups, G, hkv, d, valid length, splits, six strides,
    sm_scale, is_bf16, vec_ok."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda tensors, not {q.device}")
    BH, _, d = q.shape
    k4 = _kv_4d(k, BH, q_per_kv, "k")
    v4 = _kv_4d(v, BH, q_per_kv, "v")
    if k4.shape != v4.shape or k4.shape[3] != d:
        raise ValueError(f"k {tuple(k4.shape)} and v {tuple(v4.shape)} must agree with "
                         f"each other and with d={d}")
    if not (q.dtype == k4.dtype == v4.dtype) or q.dtype not in (torch.float32,
                                                                torch.bfloat16):
        raise TypeError(f"flash_decode takes float32 or bfloat16 tensors of one type, got "
                        f"{q.dtype}, {k4.dtype}, {v4.dtype}")
    if k4.device != q.device or v4.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if d not in COMPILED_HEAD_DIMS:
        raise ValueError(f"head dimension {d} is not compiled; choose from "
                         f"{COMPILED_HEAD_DIMS}")
    if not 1 <= q_per_kv <= MAX_Q_PER_KV:
        raise ValueError(f"q_per_kv={q_per_kv} outside [1, {MAX_Q_PER_KV}]")
    if not q.is_contiguous() or k4.stride(3) != 1 or v4.stride(3) != 1:
        raise ValueError("q must be contiguous and k/v contiguous along d")
    n = _valid_len(kv_valid_len, k4.shape[2])
    sm_scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    vec = 16 // q.element_size()
    strides = [k4.stride(0), k4.stride(1), k4.stride(2),
               v4.stride(0), v4.stride(1), v4.stride(2)]
    vec_ok = int(all(s % vec == 0 for s in strides)
                 and all(t.data_ptr() % 16 == 0 for t in (q, k4, v4)))
    n_groups = k4.shape[0] * k4.shape[1]
    body = body_of(q.dtype, d, strides, [t.data_ptr() for t in (q, k4, v4)])
    if body == "tma":
        return k4, v4, body, [n_groups, q_per_kv, k4.shape[1], k4.shape[2], n, kv_splits,
                              *strides, sm_scale]
    return k4, v4, body, [n_groups, q_per_kv, k4.shape[1], d, n, kv_splits, *strides, sm_scale,
                          int(q.dtype == torch.bfloat16), vec_ok]


def _check_q(q: torch.Tensor, kv_splits: int) -> None:
    if q.dim() != 3 or q.shape[1] != 1:
        raise ValueError(f"q must be (BH, 1, d), got {tuple(q.shape)}")
    if kv_splits < 1:
        raise ValueError(f"kv_splits={kv_splits} must be at least 1")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_splits: int = 1, sm_scale: Optional[float] = None,
                 kv_valid_len: Optional[int] = None, q_per_kv: int = 1) -> torch.Tensor:
    """Both stages in one launch: q (BH, 1, d) against k/v as in
    :func:`flash_decode_partials` -> (BH, 1, d) in q's type.  On a CUDA
    tensor the ``kv_splits`` splits of a group form one cluster, so at most
    :data:`MAX_CLUSTER_SPLITS`."""
    global launches
    _check_q(q, kv_splits)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_splits=kv_splits, sm_scale=sm_scale,
                                  kv_valid_len=kv_valid_len, q_per_kv=q_per_kv)
    if kv_splits > MAX_CLUSTER_SPLITS:
        raise ValueError(f"kv_splits={kv_splits}: the one-launch decode takes at most "
                         f"{MAX_CLUSTER_SPLITS} splits (one cluster)")
    k4, v4, body, args = _launch_args(q, k, v, sm_scale, kv_valid_len, q_per_kv, kv_splits)
    out = torch.empty_like(q)
    d = q.shape[2]
    ptrs = (q.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body == "tma":
            code = _build.lib().repro_flash_decode_tma(*ptrs, None, None, None, *args, stream)
        else:
            code = _build.lib().repro_flash_decode(*ptrs, *args, stream)
    _build.check(code, f"flash_decode BH={q.shape[0]} Skv={k4.shape[2]} valid={args[4]} "
                       f"d={d} splits={kv_splits} body={body}")
    launches += 1
    launches_by_body[body] += 1
    _work.add("flash_decode", _work.decode_flops(q.shape[0], args[4], d),
              _work.decode_kv_bytes(args[0], args[4], d, q.element_size())
              + _work.nbytes(q, out))
    return out


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          kv_splits: int = 8, sm_scale: Optional[float] = None,
                          kv_valid_len: Optional[int] = None, q_per_kv: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: (BH, 1, d); k/v: (BH / q_per_kv, Skv, d) or a 4-D strided view
    (batch, kv_heads, Skv, d) -> float32 per-split partials (m, l, acc) of
    shapes (BH, splits, 1, 1), (BH, splits, 1, 1), (BH, splits, 1, d)."""
    global partials_launches
    _check_q(q, kv_splits)
    if q.device.type == "cpu":
        return flash_decode_partials_plain(q, k, v, kv_splits=kv_splits,
                                           sm_scale=sm_scale,
                                           kv_valid_len=kv_valid_len,
                                           q_per_kv=q_per_kv)
    k4, v4, body, args = _launch_args(q, k, v, sm_scale, kv_valid_len, q_per_kv, kv_splits)
    BH, _, d = q.shape
    m = torch.empty((BH, kv_splits, 1, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((BH, kv_splits, 1, 1), dtype=torch.float32, device=q.device)
    acc = torch.empty((BH, kv_splits, 1, d), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k4.data_ptr(), v4.data_ptr())
    outs = (m.data_ptr(), l.data_ptr(), acc.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body == "tma":
            code = _build.lib().repro_flash_decode_tma(*ptrs, None, *outs, *args, stream)
        else:
            code = _build.lib().repro_flash_decode_partials(*ptrs, *outs, *args, stream)
    _build.check(code, f"flash_decode_partials BH={BH} Skv={k4.shape[2]} valid={args[4]} "
                       f"d={d} splits={kv_splits} body={body}")
    partials_launches += 1
    launches_by_body[body] += 1
    _work.add("flash_decode_partials", _work.decode_flops(BH, args[4], d),
              _work.decode_kv_bytes(args[0], args[4], d, q.element_size())
              + _work.nbytes(q, m, l, acc))
    return m, l, acc


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Log-sum-exp combine of per-split partials -> (BH, 1, d)."""
    global combine_launches
    if acc.dim() != 4 or acc.shape[2] != 1 or m.shape != acc.shape[:2] + (1, 1) \
            or l.shape != m.shape:
        raise ValueError(f"partials must be (BH, S, 1, 1), (BH, S, 1, 1), (BH, S, 1, d); "
                         f"got {tuple(m.shape)}, {tuple(l.shape)}, {tuple(acc.shape)}")
    if acc.device.type == "cpu":
        return combine_partials_plain(m, l, acc, out_dtype=out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"combine_partials runs on cpu or cuda tensors, not {acc.device}")
    if not all(t.dtype == torch.float32 and t.is_contiguous() and t.device == acc.device
               for t in (m, l, acc)):
        raise TypeError("partials must be contiguous float32 tensors on one device")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"combine_partials writes float32 or bfloat16, not {out_dtype}")
    BH, splits, _, d = acc.shape
    out = torch.empty((BH, 1, d), dtype=out_dtype, device=acc.device)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.lib().repro_flash_decode_combine(
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), BH, splits, d,
            int(out_dtype == torch.bfloat16), stream)
    _build.check(code, f"combine_partials BH={BH} splits={splits} d={d}")
    combine_launches += 1
    _work.add("flash_decode_combine", _work.combine_flops(BH, splits, d),
              _work.nbytes(m, l, acc, out))
    return out
