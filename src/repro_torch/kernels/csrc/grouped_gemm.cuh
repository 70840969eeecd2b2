// Grouped (per-expert) GEMM, staged body (sm_90a):
// out[e] = x[e] @ w[e] for x (E, cap, d_in), w (E, d_in, d_out) -> (E, cap, d_out).
//
// Replaces, with the TMA + wgmma core of gemm_sm90.cuh (GROUPED), the TPU
// kernel `_gmm_kernel` / `grouped_matmul` of src/repro/kernels/moe_gmm.py.
// There the grid is (E, cap/bm, d_out/bn, d_in/bk) with the contraction
// innermost and sequential and a float32 accumulator in VMEM.  Here the
// expert is blockIdx.z, each block owns one (BM, BN) tile of its expert's
// output and runs the d_in loop inside itself with the float32 accumulator
// in registers: it is K1's staged kernel (gemm.cuh) instantiated with
// GROUPED, which moves the block's x, w and out pointers to expert
// blockIdx.z.  It takes what the TMA core cannot: float32 operands and bf16
// operands without 16-byte alignment (and aligned bf16 sent here on purpose
// to compare the two bodies).
//
// What bounds it on an H100: the MoE layer of qwen3-moe-30b-a3b serves
// (E=128, cap, 2048 -> 768) and (128, cap, 768 -> 2048).  Every launch reads
// all 128 experts' weights whatever cap is: at the decode cap of 8 that is
// 8 FLOP a byte, at the prefill cap of 160 124 FLOP a byte, both below the
// card's ~295 in bf16: bytes bound.  In float32 the weights are twice the
// bytes and the CUDA cores' 67 TFLOP/s are the limit at prefill.
#pragma once

#include "gemm.cuh"

namespace repro {

template <typename T, int BM, int BN, int BK>
int launch_grouped_gemm_tile(const void* x, const void* w, void* out, int E, int cap,
                             int d_out, int d_in, int out_bf16, int vec_ok,
                             cudaStream_t stream) {
  dim3 grid((d_out + BN - 1) / BN, (cap + BM - 1) / BM, E);
  gemm_kernel<T, BM, BN, BK, true><<<grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), out, cap, d_out, d_in, out_bf16,
      vec_ok);
  return (int)cudaGetLastError();
}

// Dispatch over K1's compiled tile shapes.  Returns a cudaError_t, or -1 for
// a tile shape that is not compiled.
template <typename T>
int launch_grouped_gemm(const void* x, const void* w, void* out, int E, int cap, int d_out,
                        int d_in, int out_bf16, int bm, int bn, int bk, int vec_ok,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_GROUPED_CASE(BM_, BN_, BK_)                                              \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                             \
    return launch_grouped_gemm_tile<T, BM_, BN_, BK_>(x, w, out, E, cap, d_out, d_in,  \
                                                      out_bf16, vec_ok, s);
  REPRO_GROUPED_CASE(64, 64, 16)
  REPRO_GROUPED_CASE(64, 64, 32)
  REPRO_GROUPED_CASE(64, 128, 16)
  REPRO_GROUPED_CASE(64, 128, 32)
  REPRO_GROUPED_CASE(128, 64, 16)
  REPRO_GROUPED_CASE(128, 64, 32)
  REPRO_GROUPED_CASE(128, 128, 16)
  REPRO_GROUPED_CASE(128, 128, 32)
#undef REPRO_GROUPED_CASE
  return -1;
}

}  // namespace repro
