// K1's TMA + wgmma product with B stored transposed, (N, K): the backward's
// dA = dC B^T reads the forward's B (K, N) as it is stored (K-major B: `wgmma`
// without the transpose-B immediate, one TMA box of BN rows x 64 of K).  Its
// own file, so that nvcc builds it beside the others.
#include "gemm_sm90.cuh"

namespace repro {
namespace sm90 {

int gemm_tma_b_t(const void* a, const void* b, void* c, int M, int N, int K, int out_bf16,
                 int bm, int bn, void* stream) {
  return launch_gemm_tma<false, false, true>(a, b, c, 1, M, N, K, out_bf16, bm, bn, stream);
}

}  // namespace sm90
}  // namespace repro
