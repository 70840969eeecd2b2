// bf16 grouped (per-expert) GEMM behind a plain C interface: the TMA + wgmma
// core (gemm_sm90.cuh) with the expert as blockIdx.z and the row tile as
// blockIdx.x, and the staged body of grouped_gemm.cuh for operands TMA cannot
// take.  No allocation, no synchronisation; each function launches on the stream it is handed and
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
                                           int bn, void* stream) {
  return repro::sm90::launch_gemm_tma<true>(x, w, out, E, cap, d_out, d_in, out_bf16, bm, bn,
                                            stream);
}
