"""Flash-decode: wrappers, launch counters and plain versions.

Counterpart of ``repro/kernels/flash_decode.py``: one query token against a
long KV cache, split over the KV sequence into per-split partial
``(m, l, acc)`` statistics that a log-sum-exp combine folds.  Both stages are
CUDA kernels here (``csrc/flash_decode.cu``).  Against the reference the
partials kernel gains ``kv_valid_len``: only keys ``[0, kv_valid_len)`` of
the buffer take part, the valid range (not the buffer) is cut into splits,
and nothing has to divide anything.  ``None`` means the whole buffer, which
reproduces the reference kernel.

As in ``flash_attention``, ``k``/``v`` may hold ``q_per_kv`` times fewer
heads than ``q`` and may be a strided 4-D view ``(batch, kv_heads, Skv, d)``
of the serving cache.  A tensor on the CPU goes to the plain versions; a
CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention import COMPILED_HEAD_DIMS, NEG_INF, _kv_4d

MAX_Q_PER_KV = 16                   # query heads one block of the kernel serves
MIN_SPLIT_KEYS = 64                 # the kernel's inner tile
MAX_SPLITS = 64

partials_launches = 0               # launches made by flash_decode_partials()
combine_launches = 0                # launches made by combine_partials()


def choose_splits(kv_valid_len: int, n_groups: int, sm_count: int) -> int:
    """How many strips to cut the valid keys into: enough (batch x kv-head)
    x split blocks to cover the card's ``sm_count`` multiprocessors about
    twice, but no strip shorter than the kernel's 64-key tile."""
    want = -(-2 * sm_count // max(1, n_groups))
    by_len = -(-max(1, kv_valid_len) // MIN_SPLIT_KEYS)
    return max(1, min(want, by_len, MAX_SPLITS))


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


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          kv_splits: int = 8, sm_scale: Optional[float] = None,
                          kv_valid_len: Optional[int] = None, q_per_kv: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: (BH, 1, d); k/v: (BH / q_per_kv, Skv, d) or a 4-D strided view
    (batch, kv_heads, Skv, d) -> float32 per-split partials (m, l, acc) of
    shapes (BH, splits, 1, 1), (BH, splits, 1, 1), (BH, splits, 1, d)."""
    global partials_launches
    if q.dim() != 3 or q.shape[1] != 1:
        raise ValueError(f"q must be (BH, 1, d), got {tuple(q.shape)}")
    if kv_splits < 1:
        raise ValueError(f"kv_splits={kv_splits} must be at least 1")
    if q.device.type == "cpu":
        return flash_decode_partials_plain(q, k, v, kv_splits=kv_splits,
                                           sm_scale=sm_scale,
                                           kv_valid_len=kv_valid_len,
                                           q_per_kv=q_per_kv)
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
    m = torch.empty((BH, kv_splits, 1, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((BH, kv_splits, 1, 1), dtype=torch.float32, device=q.device)
    acc = torch.empty((BH, kv_splits, 1, d), dtype=torch.float32, device=q.device)
    n_groups = k4.shape[0] * k4.shape[1]
    vec = 16 // q.element_size()
    strides = [k4.stride(0), k4.stride(1), k4.stride(2),
               v4.stride(0), v4.stride(1), v4.stride(2)]
    vec_ok = int(all(s % vec == 0 for s in strides)
                 and k4.data_ptr() % 16 == 0 and v4.data_ptr() % 16 == 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.lib().repro_flash_decode_partials(
            q.data_ptr(), k4.data_ptr(), v4.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc.data_ptr(), n_groups, q_per_kv, k4.shape[1], d, n, kv_splits,
            *strides, sm_scale, int(q.dtype == torch.bfloat16), vec_ok, stream)
    _build.check(code, f"flash_decode_partials BH={BH} Skv={k4.shape[2]} valid={n} d={d} "
                       f"splits={kv_splits}")
    partials_launches += 1
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
    return out
