"""Build and load the CUDA kernels of ``csrc/`` as one shared library.

The sources have a plain C interface and include none of PyTorch's headers,
so ``nvcc`` compiles each of them in seconds.  At first use every ``*.cu``
file is compiled for ``sm_90a`` by its own ``nvcc`` process, all started
together, the objects are linked into ``libreprokernels-<hash>.so`` and the
library is loaded with :mod:`ctypes`.  The hash covers the sources and the
flags, so an edit rebuilds and an unchanged tree reuses the library.  The
build goes to ``build/kernels`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides the directory).

The TMA tensor maps of the GEMM core (``csrc/gemm_sm90.cuh``) are encoded on
the host by ``cuTensorMapEncodeTiled``, a symbol of libcuda.  The library
reaches it through the runtime (``cudaGetDriverEntryPointByVersion``, or
``cudaGetDriverEntryPoint`` before CUDA 12.5) at its first use, so the link
step needs no ``-lcuda`` and the flags are the same as before.

A build or load failure raises :class:`KernelBuildError` with the compiler's
output; nothing here ever gives way to a plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# -Xptxas -v only prints each kernel's registers, shared memory and spills
# (kept in build_info()["compiler_output"])
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_INFO: Dict[str, object] = {}


class KernelBuildError(RuntimeError):
    """The kernel library could not be compiled, linked or loaded."""


def build_dir() -> Path:
    env = os.environ.get(ENV_BUILD_DIR)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME and in /usr/local/cuda); "
        "the CUDA kernels cannot be built on this machine")


def _run_all(cmds: List[List[str]]) -> str:
    """Start every command at once, wait for all, raise with the output of
    the ones that failed; return what the compilers printed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failures, printed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        printed.append(out)
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return "".join(printed)


def build() -> Path:
    """Compile and link the library if its hash is not built yet; return its
    path."""
    out_dir = build_dir()
    tag = source_hash()
    lib_path = out_dir / f"libreprokernels-{tag}.so"
    if lib_path.exists():
        _INFO.setdefault("built", False)
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [out_dir / f"{p.stem}-{tag}.o" for p in sources()]
    printed = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                         "-o", str(obj)] for src, obj in zip(sources(), objs)])
    tmp = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
    _run_all([[nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs]]])
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink(missing_ok=True)
    _INFO.update(built=True, build_seconds=time.perf_counter() - t0,
                 compiler_output=printed)
    return lib_path


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = [_L] * 6
_SIGNATURES = {
    # a, b, c, M, N, K, out_bf16, bm, bn, bk, vec_ok, stream
    "repro_gemm_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_gemm_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # a, b, c, M, N, K, out_bf16, bm, bn, a_t, b_t, stream (the TMA + wgmma body;
    # a_t: a stored (K, M), b_t: b stored (N, K))
    "repro_gemm_tma_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # bm, bn, bk, in_bf16, K (<= 0: the deepest footprint)
    "repro_gemm_smem_bytes": [_I, _I, _I, _I, _I],
    # x, w, out, E, cap, d_out, d_in, out_bf16, bm, bn, bk, vec_ok, stream
    "repro_grouped_gemm_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_grouped_gemm_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, out, E, cap, d_out, d_in, out_bf16, bm, bn, a_t, b_t, stream (the TMA +
    # wgmma body; a_t: x stored (E, d_in, cap), b_t: w stored (E, d_out, d_in))
    "repro_grouped_gemm_tma_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, lse (NULL: not written), BH, Sq, Skv, d, H, q_per_kv, 6 strides,
    # sm_scale, causal, q_off (position of query row 0), bq, bkv, vec_ok, stream
    "repro_flash_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *_STRIDES,
                                   _F, _I, _I, _I, _I, _I, _P],
    "repro_flash_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *_STRIDES,
                                  _F, _I, _I, _I, _I, _I, _P],
    # the TMA + wgmma body at d 256 (bf16, aligned): q, k, v, o, lse (or NULL), BH,
    # Sq, Skv, H, q_per_kv, 6 strides, sm_scale, causal, q_off, bq, bkv, stream
    "repro_flash_attention_tma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, *_STRIDES,
                                  _F, _I, _I, _I, _I, _P],
    # bq, bkv, minb (1: the blocks an SM its launch bounds ask for, 0: shared memory);
    # bq, bkv: the blocks an SM the runtime finds room for
    "repro_flash_tma_smem_bytes": [_I, _I, _I],
    "repro_flash_tma_occupancy": [_I, _I],
    # q, k, v, o, dout, lse, delta, dq, dk, dv, BH, Sq, Skv, d, H, q_per_kv,
    # 6 strides, sm_scale, causal, q_off, stream (two launches: dQ and delta, then
    # dK/dV; the bf16 dK/dV launch runs each group's query heads as one cluster)
    "repro_flash_attention_bwd_bf16": [_P] * 10 + [_I] * 6 + [*_STRIDES, _F, _I, _I, _P],
    "repro_flash_attention_bwd_f32": [_P] * 10 + [_I] * 6 + [*_STRIDES, _F, _I, _I, _P],
    # the TMA + wgmma body at d 256: the same without d (a dK/dV block walks
    # its group's query heads; no cluster)
    "repro_flash_attention_bwd_tma": [_P] * 10 + [_I] * 5 + [*_STRIDES, _F, _I, _I, _P],
    # d, kernel (0 dQ, 1 dK/dV), is_bf16; q_per_kv; kernel (the TMA body)
    "repro_flash_bwd_smem_bytes": [_I, _I, _I],
    "repro_flash_bwd_cluster": [_I],
    "repro_flash_bwd_tma_smem_bytes": [_I],
    "repro_flash_bwd_tma_occupancy": [_I],
    "repro_flash_smem_bytes_bf16": [_I, _I, _I],
    "repro_flash_smem_bytes_f32": [_I, _I, _I],
    # q, k, v, out, n_groups, G, hkv, d, kv_len, splits, 6 strides, sm_scale,
    # is_bf16, vec_ok, stream (both stages, one launch)
    "repro_flash_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *_STRIDES, _F, _I, _I, _P],
    # q, k, v, m, l, acc, n_groups, G, hkv, d, kv_len, splits, 6 strides,
    # sm_scale, is_bf16, vec_ok, stream
    "repro_flash_decode_partials": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    *_STRIDES, _F, _I, _I, _P],
    # the TMA body at d 256 (bf16, aligned): q, k, v, out (NULL: the partials),
    # m, l, acc (NULL: one launch), n_groups, G, hkv, buffer, kv_len, splits,
    # 6 strides, sm_scale, stream
    "repro_flash_decode_tma": [_P] * 7 + [_I] * 6 + [*_STRIDES, _F, _P],
    "repro_flash_decode_tma_occupancy": [],
    # m, l, acc, out, BH, splits, d, out_bf16, stream
    "repro_flash_decode_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # d, body (0 float32, 1 mma.sync, 2 TMA)
    "repro_flash_decode_smem_bytes": [_I, _I],
    # r, k, v, log_w, u, o, state0 (or null), state, BH, T, d, chunk, is_bf16, stream
    "repro_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_wkv6_smem_bytes": [_I, _I],
    # r, k, v, log_w, u, dout, dr, dk, dv, dlog_w, du, scratch, state0, dstate,
    # dstate0 (each may be null), BH, T, d, chunk, is_bf16, stream
    "repro_wkv6_bwd": [_P] * 15 + [_I] * 5 + [_P],
    # d, chunk, is_bf16: a block's shared memory, the blocks an SM its launch
    # bounds ask for, the most clusters the device holds at once; d: blocks a row
    "repro_wkv6_bwd_smem_bytes": [_I, _I, _I],
    "repro_wkv6_bwd_min_blocks": [_I, _I, _I],
    "repro_wkv6_bwd_max_clusters": [_I, _I, _I],
    "repro_wkv6_bwd_split": [_I],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                loaded = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(loaded, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            except (OSError, AttributeError) as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _INFO["path"] = str(path)
            _LIB = loaded
    return _LIB


def build_info() -> Dict[str, object]:
    """Where the library lives, whether this process compiled it and how
    long that took (for ``chip_smoke.py`` and the serve launcher's report)."""
    return dict(_INFO)


def check(code: int, what: str) -> None:
    """Raise on a non-zero return of one of the library's launch functions:
    a ``cudaError_t``, ``-1`` for a shape that is not compiled, ``-2`` for a
    tile whose shared memory does not fit one block, ``-3`` for a TMA tensor
    map that could not be encoded."""
    if code == 0:
        return
    if code == -1:
        raise ValueError(f"{what}: this shape or tile is not among the compiled kernels")
    if code == -2:
        raise ValueError(f"{what}: the tile's shared memory exceeds what one block may use")
    if code == -3:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused the operands' tensor map "
                           f"(or libcuda does not export it)")
    raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
