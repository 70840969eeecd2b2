// The grouped TMA + wgmma product with A stored transposed, (Z, K, M): the
// backward's dW_e = X_e^T dY_e reads the forward's X (E, cap, d_in) as it is
// stored (`wgmma` with the transpose-A immediate, TMA boxes of 64 cap-rows x
// 64 of d_in).  Its own file, so that nvcc builds it beside the others.
#include "gemm_sm90.cuh"

namespace repro {
namespace sm90 {

int grouped_gemm_tma_a_t(const void* a, const void* b, void* c, int Z, int M, int N, int K,
                         int out_bf16, int bm, int bn, void* stream) {
  return launch_gemm_tma<true, true, false>(a, b, c, Z, M, N, K, out_bf16, bm, bn, stream);
}

}  // namespace sm90
}  // namespace repro
