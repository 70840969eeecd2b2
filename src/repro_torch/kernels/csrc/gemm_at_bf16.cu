// K1's TMA + wgmma product with A stored transposed, (K, M): the backward's
// dB = A^T dC reads the forward's A (M, K) as it is stored (`wgmma` with the
// transpose-A immediate, TMA boxes of 64 K-rows x 64 of M).  Its own file, so
// that nvcc builds it beside the others.
#include "gemm_sm90.cuh"

namespace repro {
namespace sm90 {

int gemm_tma_a_t(const void* a, const void* b, void* c, int M, int N, int K, int out_bf16,
                 int bm, int bn, void* stream) {
  return launch_gemm_tma<false, true, false>(a, b, c, 1, M, N, K, out_bf16, bm, bn, stream);
}

}  // namespace sm90
}  // namespace repro
