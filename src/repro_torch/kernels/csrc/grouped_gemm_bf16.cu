// bf16 instantiations of the grouped (per-expert) GEMM (see grouped_gemm.cuh)
// behind a plain C interface: no allocation, no synchronisation, launches on
// the stream it is handed and returns cudaGetLastError().
#include "grouped_gemm.cuh"

extern "C" int repro_grouped_gemm_bf16(const void* x, const void* w, void* out, int E,
                                       int cap, int d_out, int d_in, int out_bf16, int bm,
                                       int bn, int bk, int vec_ok, void* stream) {
  return repro::launch_grouped_gemm<__nv_bfloat16>(x, w, out, E, cap, d_out, d_in, out_bf16,
                                                   bm, bn, bk, vec_ok, stream);
}
