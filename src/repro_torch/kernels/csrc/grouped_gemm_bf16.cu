// bf16 grouped (per-expert) GEMM behind a plain C interface: the TMA + wgmma
// core (gemm_sm90.cuh) with the expert as blockIdx.z and the row tile as
// blockIdx.x, and the staged body of grouped_gemm.cuh for operands TMA cannot
// take.  The TMA core reads x and w as they are stored: x (E, cap, d_in) or,
// a_t, (E, d_in, cap); w (E, d_in, d_out) or, b_t, (E, d_out, d_in).  No allocation, no synchronisation; each function launches on the stream it is handed and
// returns cudaGetLastError() (or a negative code, see _build.py).
#include "gemm_sm90.cuh"
#include "grouped_gemm.cuh"

extern "C" int repro_grouped_gemm_bf16(const void* x, const void* w, void* out, int E,
                                       int cap, int d_out, int d_in, int out_bf16, int bm,
                                       int bn, int bk, int vec_ok, void* stream) {
  return repro::launch_grouped_gemm<__nv_bfloat16>(x, w, out, E, cap, d_out, d_in, out_bf16,
                                                   bm, bn, bk, vec_ok, stream);
}

extern "C" int repro_grouped_gemm_tma_bf16(const void* x, const void* w, void* out, int E,
                                           int cap, int d_out, int d_in, int out_bf16, int bm,
                                           int bn, int a_t, int b_t, void* stream) {
  using namespace repro::sm90;
  if (a_t && b_t) return -1;
  if (a_t) return grouped_gemm_tma_a_t(x, w, out, E, cap, d_out, d_in, out_bf16, bm, bn, stream);
  if (b_t) return grouped_gemm_tma_b_t(x, w, out, E, cap, d_out, d_in, out_bf16, bm, bn, stream);
  return launch_gemm_tma<true, false, false>(x, w, out, E, cap, d_out, d_in, out_bf16, bm, bn,
                                             stream);
}
