// bf16 GEMM behind a plain C interface: the TMA + wgmma core (gemm_sm90.cuh)
// and the staged body of gemm.cuh for operands TMA cannot take.  The TMA core
// reads A (M, K) or, a_t, A stored (K, M), and B (K, N) or, b_t, B stored
// (N, K): the backward's transposed views as they lie, with no copy (the two
// transposed layouts compile in gemm_at_bf16.cu and gemm_bt_bf16.cu).  No
// allocation, no synchronisation; each function launches on the stream it is
// handed and returns cudaGetLastError() (or a negative code, see _build.py).
#include "gemm.cuh"
#include "gemm_sm90.cuh"

extern "C" int repro_gemm_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                               int out_bf16, int bm, int bn, int bk, int vec_ok,
                               void* stream) {
  return repro::launch_gemm<__nv_bfloat16>(a, b, c, M, N, K, out_bf16, bm, bn, bk, vec_ok,
                                           stream);
}

extern "C" int repro_gemm_tma_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                                   int out_bf16, int bm, int bn, int a_t, int b_t,
                                   void* stream) {
  using namespace repro::sm90;
  if (a_t && b_t) return -1;
  if (a_t) return gemm_tma_a_t(a, b, c, M, N, K, out_bf16, bm, bn, stream);
  if (b_t) return gemm_tma_b_t(a, b, c, M, N, K, out_bf16, bm, bn, stream);
  return launch_gemm_tma<false, false, false>(a, b, c, 1, M, N, K, out_bf16, bm, bn, stream);
}

// Shared memory of one block of the body that owns the tile: BK 64 in bf16
// is the TMA core's (dynamic; for a product of depth K, or K <= 0 the deep
// ring, the most any K takes), the rest gemm.cuh's (static).
extern "C" int repro_gemm_smem_bytes(int bm, int bn, int bk, int in_bf16, int K) {
  if (in_bf16 && bk == repro::sm90::BK) return repro::sm90::smem_bytes(bm, bn, K);
  return in_bf16 ? repro::gemm_smem_bytes<__nv_bfloat16>(bm, bn, bk)
                 : repro::gemm_smem_bytes<float>(bm, bn, bk);
}
