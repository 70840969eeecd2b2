// Helpers shared by the hand-written Hopper kernels of repro_torch.
//
// Everything here is header-only device code: type conversion between the
// storage type (float or bf16) and float, and a masked, 16-byte-vectorised
// copy of a 2-D tile from device memory into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference's finite mask sentinel

template <typename T> struct is_bf16 { static constexpr bool value = false; };
template <> struct is_bf16<__nv_bfloat16> { static constexpr bool value = true; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy the ROWS x COLS tile whose top-left element is (row0, col0) of a
// row-major matrix with `n_rows` x `n_cols` valid elements and row stride
// `ld_g` into shared memory with row stride LD.  Elements outside the matrix
// are written as zero, so callers never branch on the ragged edge again.
// `vec_ok` says that the base pointer and every row start are 16-byte aligned.
template <typename T, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile(T* __restrict__ s, const T* __restrict__ g,
                                          int row0, int col0, int n_rows, int n_cols,
                                          long long ld_g, bool vec_ok, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(COLS % VEC == 0, "tile width must be a whole number of 16-byte vectors");
  static_assert(LD % VEC == 0, "shared row stride must keep 16-byte alignment");
  constexpr int CV = COLS / VEC;
  for (int i = tid; i < ROWS * CV; i += NT) {
    const int r = i / CV;
    const int c = (i % CV) * VEC;
    const int gr = row0 + r;
    const int gc = col0 + c;
    T* dst = s + r * LD + c;
    if (vec_ok && gr < n_rows && gc + VEC <= n_cols) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + (long long)gr * ld_g + gc);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const bool ok = gr < n_rows && gc + e < n_cols;
        dst[e] = ok ? g[(long long)gr * ld_g + gc + e] : from_float<T>(0.f);
      }
    }
  }
}

// The same copy, asynchronous (`cp.async`, 16 bytes a request): the caller
// commits the group and waits for it before reading the tile.  Needs the
// alignment that `vec_ok` states; a 16-byte piece outside the matrix is
// zero-filled by the hardware (source size 0).
template <typename T, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile_async(T* __restrict__ s, const T* __restrict__ g,
                                                int row0, int col0, int n_rows, int n_cols,
                                                long long ld_g, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(COLS % VEC == 0 && LD % VEC == 0, "tile must be whole 16-byte vectors");
  constexpr int CV = COLS / VEC;
  for (int i = tid; i < ROWS * CV; i += NT) {
    const int r = i / CV;
    const int c = (i % CV) * VEC;
    const int gr = row0 + r;
    const int gc = col0 + c;
    const bool ok = gr < n_rows && gc + VEC <= n_cols;
    const T* src = ok ? g + (long long)gr * ld_g + gc : g;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s + r * LD + c);
    const int src_bytes = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro
