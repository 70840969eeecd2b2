// Planner-blocked GEMM for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N].
//
// Replaces the TPU kernel `_gemm_kernel` / `gemm` of
// src/repro/kernels/gemm.py.  There the contraction is the innermost,
// sequential axis of the grid and the output block is revisited with a
// float32 accumulator in scratch memory.  A GPU grid has no order, so the K
// axis becomes a loop inside one thread block per (BM, BN) output tile: the
// accumulator stays in registers for the whole loop and the A and B tiles
// are staged through shared memory.  The tile shape (BM, BN, BK) is a
// template parameter; the planner (core/lower_torch.py) chooses among the
// shapes instantiated at the bottom of this file.
//
// What bounds it on an H100: at the serving projection shape
// (2048 x 2048 @ 2048 x 11008, bf16) the product needs 92 GFLOP and moves
// 98 MB, about 940 FLOP per byte, far above the card's ~295 FLOP/byte
// balance point, so the tensor cores are the limit (operations).  The bf16
// path therefore multiplies on the tensor cores (`mma.sync` through
// nvcuda::wmma, 16x16x16 tiles, float32 accumulate) and fills two
// shared-memory stages with `cp.async`, so the next k-step's tiles arrive
// while this one's are multiplied.  It is still a simple kernel: no `wgmma`,
// no TMA, one block-wide barrier pair per k-step; those are the known route
// to the card's full rate.  float32 inputs are multiplied in true
// float32 on the CUDA cores (no TF32), which keeps the 1e-4 tolerance of the
// reference's tests.
//
// Edges that do not divide the tile are masked here: loads beyond the matrix
// read as zero and stores beyond it are dropped.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace repro {

constexpr int GEMM_THREADS = 256;     // 8 warps, laid out 2 (M) x 4 (N)
constexpr int GEMM_WARPS_M = 2;
constexpr int GEMM_WARPS_N = 4;

template <typename T> struct GemmPad { static constexpr int value = 16 / sizeof(T); };
// shared-memory stages of the A and B tiles: two for bf16 (cp.async), one for float32
template <typename T> struct GemmStages { static constexpr int value = is_bf16<T>::value ? 2 : 1; };

// Shared-memory bytes of one block; mirrored by gemm_smem_bytes() in
// kernels/gemm.py, which the planner uses to prune tile shapes.
template <typename T>
__host__ __device__ constexpr int gemm_smem_bytes(int bm, int bn, int bk) {
  const int pad = 16 / (int)sizeof(T);
  const int ab = (bm * (bk + pad) + bk * (bn + pad)) * (int)sizeof(T);
  const int stage = is_bf16<T>::value ? (GEMM_THREADS / 32) * 256 * 4 : 0;
  return GemmStages<T>::value * ab + stage;
}

__device__ __forceinline__ void store_out(void* c, long long idx, float v, int out_bf16) {
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(c)[idx] = __float2bfloat16(v);
  } else {
    reinterpret_cast<float*>(c)[idx] = v;
  }
}

// GROUPED (grouped_gemm.cuh) runs one independent product per blockIdx.z:
// A, B and C are then (Z, M, K), (Z, K, N) and (Z, M, N), and the block moves
// its three pointers to slice blockIdx.z.  Without it the code is K1's alone.
template <typename T, int BM, int BN, int BK, bool GROUPED = false>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, void* __restrict__ C,
            int M, int N, int K, int out_bf16, int vec_ok) {
  if constexpr (GROUPED) {
    const long long z = blockIdx.z;
    A += z * M * K;
    B += z * K * N;
    C = static_cast<char*>(C) + z * M * N * (out_bf16 ? 2 : 4);
  }
  constexpr int PAD = GemmPad<T>::value;
  constexpr int LDA = BK + PAD;
  constexpr int LDB = BN + PAD;
  constexpr int STAGES = GemmStages<T>::value;
  constexpr int A_STAGE = BM * LDA;
  constexpr int B_STAGE = BK * LDB;
  __shared__ __align__(128) T As[STAGES * A_STAGE];
  __shared__ __align__(128) T Bs[STAGES * B_STAGE];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;

  if constexpr (is_bf16<T>::value) {
    using namespace nvcuda;
    constexpr int WM = BM / GEMM_WARPS_M;
    constexpr int WN = BN / GEMM_WARPS_N;
    constexpr int FM = WM / 16;
    constexpr int FN = WN / 16;
    static_assert(FM >= 1 && FN >= 1, "tile too small for the 2 x 4 warp layout");
    __shared__ __align__(128) float stage[GEMM_THREADS / 32][256];

    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wm = (warp / GEMM_WARPS_N) * WM;
    const int wn = (warp % GEMM_WARPS_N) * WN;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    // one k-step's products from the tiles of one shared-memory stage
    auto mma_stage = [&](const T* as, const T* bs) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(fa[i], as + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    };

    if (vec_ok) {
      // two stages: while stage kt % 2 is multiplied, cp.async fills the other
      load_tile_async<T, BM, BK, LDA, GEMM_THREADS>(As, A, m0, 0, M, K, K, tid);
      load_tile_async<T, BK, BN, LDB, GEMM_THREADS>(Bs, B, 0, n0, K, N, N, tid);
      cp_async_commit();
      for (int kt = 0; kt < n_k; ++kt) {
        const int cur = kt % 2;
        if (kt + 1 < n_k) {
          const int k1 = (kt + 1) * BK;
          load_tile_async<T, BM, BK, LDA, GEMM_THREADS>(As + (cur ^ 1) * A_STAGE, A, m0, k1, M,
                                                        K, K, tid);
          load_tile_async<T, BK, BN, LDB, GEMM_THREADS>(Bs + (cur ^ 1) * B_STAGE, B, k1, n0, K,
                                                        N, N, tid);
        }
        cp_async_commit();               // an empty group on the last step keeps the count
        cp_async_wait<1>();              // all but the newest group: stage `cur` has landed
        __syncthreads();
        mma_stage(As + cur * A_STAGE, Bs + cur * B_STAGE);
        __syncthreads();                 // before the stage is filled again
      }
    } else {
      // operands without 16-byte alignment: one stage, element-wise loads
      for (int kt = 0; kt < n_k; ++kt) {
        const int k0 = kt * BK;
        load_tile<T, BM, BK, LDA, GEMM_THREADS>(As, A, m0, k0, M, K, K, false, tid);
        load_tile<T, BK, BN, LDB, GEMM_THREADS>(Bs, B, k0, n0, K, N, N, false, tid);
        __syncthreads();
        mma_stage(As, Bs);
        __syncthreads();
      }
    }

    // Epilogue: a fragment's element-to-thread layout is opaque, so each warp
    // passes it through a 16 x 16 float staging tile of its own and writes the
    // masked, converted values from there.
    float* st = stage[warp];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m0 + wm + i * 16 + e / 16;
          const int c = n0 + wn + j * 16 + e % 16;
          if (r < M && c < N) store_out(C, (long long)r * N + c, st[e], out_bf16);
        }
        __syncwarp();
      }
    }
  } else {
    // float32: 16 x 16 threads, each owning a strided (BM/16) x (BN/16)
    // micro-tile so that shared-memory reads of B are conflict-free.
    constexpr int TM = BM / 16;
    constexpr int TN = BN / 16;
    const int ty = tid / 16;
    const int tx = tid % 16;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int k0 = kt * BK;
      load_tile<T, BM, BK, LDA, GEMM_THREADS>(As, A, m0, k0, M, K, K, vec_ok, tid);
      load_tile<T, BK, BN, LDB, GEMM_THREADS>(Bs, B, k0, n0, K, N, N, vec_ok, tid);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk * LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + tx + 16 * j;
        if (r < M && c < N) store_out(C, (long long)r * N + c, acc[i][j], out_bf16);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch_gemm_tile(const void* a, const void* b, void* c, int M, int N, int K,
                     int out_bf16, int vec_ok, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T, BM, BN, BK><<<grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), c, M, N, K, out_bf16, vec_ok);
  return (int)cudaGetLastError();
}

// Dispatch over the compiled tile shapes: {64,128} x {64,128} x {16,32}.
// Returns a cudaError_t, or -1 for a tile shape that is not compiled.
template <typename T>
int launch_gemm(const void* a, const void* b, void* c, int M, int N, int K,
                int out_bf16, int bm, int bn, int bk, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_GEMM_CASE(BM_, BN_, BK_)                                          \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                      \
    return launch_gemm_tile<T, BM_, BN_, BK_>(a, b, c, M, N, K, out_bf16, vec_ok, s);
  REPRO_GEMM_CASE(64, 64, 16)
  REPRO_GEMM_CASE(64, 64, 32)
  REPRO_GEMM_CASE(64, 128, 16)
  REPRO_GEMM_CASE(64, 128, 32)
  REPRO_GEMM_CASE(128, 64, 16)
  REPRO_GEMM_CASE(128, 64, 32)
  REPRO_GEMM_CASE(128, 128, 16)
  REPRO_GEMM_CASE(128, 128, 32)
#undef REPRO_GEMM_CASE
  return -1;
}

}  // namespace repro
