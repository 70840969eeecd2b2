// bf16 instantiations of the planner-blocked GEMM (see gemm.cuh) behind a
// plain C interface: no allocation, no synchronisation, launches on the
// stream it is handed and returns cudaGetLastError().
#include "gemm.cuh"

extern "C" int repro_gemm_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                               int out_bf16, int bm, int bn, int bk, int vec_ok,
                               void* stream) {
  return repro::launch_gemm<__nv_bfloat16>(a, b, c, M, N, K, out_bf16, bm, bn, bk, vec_ok,
                                           stream);
}

extern "C" int repro_gemm_smem_bytes(int bm, int bn, int bk, int in_bf16) {
  return in_bf16 ? repro::gemm_smem_bytes<__nv_bfloat16>(bm, bn, bk)
                 : repro::gemm_smem_bytes<float>(bm, bn, bk);
}
