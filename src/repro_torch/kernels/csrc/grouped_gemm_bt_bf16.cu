// The grouped TMA + wgmma product with B stored transposed, (Z, N, K): the
// backward's dX_e = dY_e W_e^T reads the forward's W (E, d_in, d_out) as it is
// stored (K-major B: `wgmma` without the transpose-B immediate, one TMA box of
// BN d_in-rows x 64 of d_out).  Its own file, so that nvcc builds it beside
// the others.
#include "gemm_sm90.cuh"

namespace repro {
namespace sm90 {

int grouped_gemm_tma_b_t(const void* a, const void* b, void* c, int Z, int M, int N, int K,
                         int out_bf16, int bm, int bn, void* stream) {
  return launch_gemm_tma<true, false, true>(a, b, c, Z, M, N, K, out_bf16, bm, bn, stream);
}

}  // namespace sm90
}  // namespace repro
