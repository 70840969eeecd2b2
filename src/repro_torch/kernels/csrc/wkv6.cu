// Chunked RWKV6 WKV scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6` of
// src/repro/kernels/rwkv6.py.  Per head (state S in R^{d x d}, key index i,
// value index j) the recurrence is
//
//     o_t[j]   = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//     S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j],
//
// computed chunk by chunk as the TPU kernel does: with cum the inclusive
// cumsum of log w over the chunk and c = cum[C-1] / 2 a per-channel midpoint,
//
//     o   = (r e^{cum_excl}) S + tril((r e^{cum_excl - c}) (k e^{c - cum})^T, -1) v
//           + (sum_i r u k) v
//     S  <- e^{cum[C-1]} S + (k e^{cum[C-1] - cum})^T v.
//
// On the TPU the chunk axis is a sequential grid axis and the state lives in
// VMEM scratch.  Here one block owns one (batch x head) row and a slice of
// WKV_DV value columns, and walks the chunks in a loop with its slice of the
// state in shared memory: value columns are independent (o[:, j] and S[:, j]
// need only v[:, j]), so a (BH, d / WKV_DV) grid spreads 160 heads of the
// served model over 640 blocks.  Each block recomputes the chunk's decays and
// its C x C scores, which costs less than the state products it shares out.
//
// What bounds it on an H100: at the served shape (160 heads, T 512, d 64,
// chunk 16) the function moves 55 MB (0.016 ms at 3.35 TB/s) and does
// 1.68 GFLOP, 0.025 ms at the float32 rate.  All products run in float32 on
// the CUDA cores (FMA), as the reference's tolerance of 2e-3 in float32
// needs; nothing goes through TF32.  The design keeps every operand of the
// chunk in shared memory with padded rows (conflict-free column walks),
// gives each thread a column of outputs so that one loaded state or value
// element feeds several FMAs, and loads the next chunk's inputs into
// registers while the current chunk is computed.
//
// A masked score (s >= t) is never computed: its two factors may reach
// e^{C * 4 / 2} each, whose product overflows float32 at chunk 32.
#include "common.cuh"

namespace repro {

constexpr int WKV_THREADS = 128;
constexpr int WKV_CMAX = 32;     // longest chunk the buffers hold
constexpr int WKV_DV = 16;       // value columns one block owns
constexpr int WKV_ROWS = WKV_THREADS / WKV_DV;   // thread rows of the output tiles

// Dynamic shared memory of one block, in floats, for head dimension d and a
// chunk of c steps: raw r, k, log w and the four scaled copies (A, RS, KS, KC)
// with padded rows, the value slice, the scores, the state slice, the bonus
// sums, u and the chunk's total decay.
__host__ __device__ constexpr int wkv6_smem_floats(int d, int c) {
  return 7 * c * (d + 1) + c * WKV_DV + c * (c + 1) + d * WKV_DV + c + 2 * d;
}

template <typename T, int D>
__global__ void __launch_bounds__(WKV_THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ lw, const T* __restrict__ u, T* __restrict__ o,
            float* __restrict__ state_out, int T_len, int C) {
  static_assert(D % WKV_DV == 0 && D % WKV_ROWS == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1;                                    // padded row
  constexpr int PER = (WKV_CMAX * D + WKV_THREADS - 1) / WKV_THREADS;
  constexpr int PER_V = (WKV_CMAX * WKV_DV + WKV_THREADS - 1) / WKV_THREADS;
  constexpr int QT = (WKV_CMAX + WKV_ROWS - 1) / WKV_ROWS;     // output rows a thread owns
  constexpr int QS = D / WKV_ROWS;                             // state rows a thread owns
  extern __shared__ __align__(16) float wkv_smem[];
  float* R = wkv_smem;
  float* K = R + C * LD;
  float* W = K + C * LD;
  float* A = W + C * LD;           // r e^{cum_excl}
  float* RS = A + C * LD;          // r e^{cum_excl - c}
  float* KS = RS + C * LD;         // k e^{c - cum}
  float* KC = KS + C * LD;         // k e^{cum[C-1] - cum}
  float* V = KC + C * LD;          // C x WKV_DV
  float* SC = V + C * WKV_DV;      // C x (C + 1), strictly lower triangle
  float* S = SC + C * (C + 1);     // D x WKV_DV
  float* diag = S + D * WKV_DV;    // C
  float* U = diag + C;             // D
  float* decay = U + D;            // D

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * WKV_DV;
  const int jj = tid % WKV_DV;
  const int row = tid / WKV_DV;
  const long long base = (long long)bh * T_len * D;

  for (int i = tid; i < D; i += WKV_THREADS) U[i] = to_float(u[(long long)bh * D + i]);
#pragma unroll
  for (int m = 0; m < QS; ++m) S[(row + m * WKV_ROWS) * WKV_DV + jj] = 0.f;

  // the next chunk's inputs, fetched into registers while this one runs
  T pr[PER], pk[PER], pw[PER], pv[PER_V];
  auto fetch = [&](int t0) {
    const long long off = base + (long long)t0 * D;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * WKV_THREADS;
      if (e < C * D) {
        pr[q] = r[off + e];
        pk[q] = k[off + e];
        pw[q] = lw[off + e];
      }
    }
#pragma unroll
    for (int q = 0; q < PER_V; ++q) {
      const int e = tid + q * WKV_THREADS;
      if (e < C * WKV_DV) pv[q] = v[off + (long long)(e / WKV_DV) * D + j0 + e % WKV_DV];
    }
  };
  fetch(0);

  for (int t0 = 0; t0 < T_len; t0 += C) {
    // ---- stage the chunk in shared memory as float32, then fetch the next --------
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * WKV_THREADS;
      if (e < C * D) {
        const int idx = (e / D) * LD + e % D;
        R[idx] = to_float(pr[q]);
        K[idx] = to_float(pk[q]);
        W[idx] = to_float(pw[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < PER_V; ++q) {
      const int e = tid + q * WKV_THREADS;
      if (e < C * WKV_DV) V[e] = to_float(pv[q]);
    }
    if (t0 + C < T_len) fetch(t0 + C);
    __syncthreads();

    // ---- decays: thread i walks channel i through the chunk; the remaining
    // threads take the bonus sums sum_i r u k, one time step each ---------------
    if (tid < D) {
      const int i = tid;
      float last = 0.f;
      for (int t = 0; t < C; ++t) last += W[t * LD + i];
      const float c_off = 0.5f * last;
      float cum = 0.f;
      for (int t = 0; t < C; ++t) {
        const int idx = t * LD + i;
        const float w = W[idx];
        cum += w;                                  // inclusive
        const float cum_excl = cum - w;
        const float rv = R[idx];
        const float kv = K[idx];
        A[idx] = rv * expf(cum_excl);
        RS[idx] = rv * expf(cum_excl - c_off);
        KS[idx] = kv * expf(c_off - cum);
        KC[idx] = kv * expf(last - cum);
      }
      decay[i] = expf(last);
    } else if (tid - D < C) {
      const int t = tid - D;
      float s = 0.f;
#pragma unroll 16
      for (int i = 0; i < D; ++i) s = fmaf(R[t * LD + i] * U[i], K[t * LD + i], s);
      diag[t] = s;
    }
    __syncthreads();

    // ---- intra-chunk scores, strictly below the diagonal only ------------------
    for (int e = tid; e < C * C; e += WKV_THREADS) {
      const int t = e / C;
      const int s = e % C;
      float acc = 0.f;
      if (s < t) {
        const float* a = RS + t * LD;
        const float* b = KS + s * LD;
#pragma unroll 16
        for (int i = 0; i < D; ++i) acc = fmaf(a[i], b[i], acc);
      }
      SC[t * (C + 1) + s] = acc;
    }
    __syncthreads();

    // ---- outputs: a thread owns value column jj of rows row, row + 8, ... ------
    {
      float acc[QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) acc[q] = 0.f;
#pragma unroll 8
      for (int i = 0; i < D; ++i) {
        const float sv = S[i * WKV_DV + jj];
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          const int t = row + q * WKV_ROWS;
          if (t < C) acc[q] = fmaf(A[t * LD + i], sv, acc[q]);
        }
      }
      for (int s = 0; s < C; ++s) {
        const float vv = V[s * WKV_DV + jj];
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          const int t = row + q * WKV_ROWS;
          if (t < C) acc[q] = fmaf(SC[t * (C + 1) + s], vv, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const int t = row + q * WKV_ROWS;
        if (t < C) {
          const float out = fmaf(diag[t], V[t * WKV_DV + jj], acc[q]);
          o[base + (long long)(t0 + t) * D + j0 + jj] = from_float<T>(out);
        }
      }
    }
    __syncthreads();

    // ---- state: S[i, jj] <- e^{cum[C-1, i]} S[i, jj] + sum_s KC[s, i] v[s, jj] --
    {
      float acc[QS];
#pragma unroll
      for (int m = 0; m < QS; ++m) {
        const int i = row + m * WKV_ROWS;
        acc[m] = S[i * WKV_DV + jj] * decay[i];
      }
      for (int s = 0; s < C; ++s) {
        const float vv = V[s * WKV_DV + jj];
#pragma unroll
        for (int m = 0; m < QS; ++m) acc[m] = fmaf(KC[s * LD + row + m * WKV_ROWS], vv, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < QS; ++m) S[(row + m * WKV_ROWS) * WKV_DV + jj] = acc[m];
    }
    __syncthreads();
  }

  // ---- the final state of this block's columns --------------------------------
#pragma unroll
  for (int m = 0; m < QS; ++m) {
    const int i = row + m * WKV_ROWS;
    state_out[((long long)bh * D + i) * D + j0 + jj] = S[i * WKV_DV + jj];
  }
}

template <typename T>
int launch_wkv6(const void* r, const void* k, const void* v, const void* lw, const void* u,
                void* o, float* state, int BH, int T_len, int d, int chunk, cudaStream_t s) {
  if (chunk < 1 || chunk > WKV_CMAX || T_len < 1 || T_len % chunk || BH < 1) return -1;
#define REPRO_WKV_CASE(D_)                                                                  \
  if (d == D_) {                                                                            \
    auto kern = wkv6_kernel<T, D_>;                                                         \
    const int smem = wkv6_smem_floats(D_, chunk) * (int)sizeof(float);                      \
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                           wkv6_smem_floats(D_, WKV_CMAX) * (int)sizeof(float)); \
    if (err != cudaSuccess) return (int)err;                                                \
    kern<<<dim3(BH, D_ / WKV_DV), WKV_THREADS, smem, s>>>(                                  \
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),       \
        static_cast<const T*>(lw), static_cast<const T*>(u), static_cast<T*>(o), state,     \
        T_len, chunk);                                                                      \
    return (int)cudaGetLastError();                                                         \
  }
  REPRO_WKV_CASE(16)
  REPRO_WKV_CASE(32)
  REPRO_WKV_CASE(64)
#undef REPRO_WKV_CASE
  return -1;
}

}  // namespace repro

// Plain C interface: no allocation, no synchronisation; launches on the
// stream it is handed and returns cudaGetLastError(), or -1 for a shape that
// is not compiled (d not in {16, 32, 64}, a chunk outside [1, 32] or one
// that does not divide T).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* lw,
                          const void* u, void* o, void* state, int BH, int T, int d,
                          int chunk, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(state);
  if (is_bf16)
    return repro::launch_wkv6<__nv_bfloat16>(r, k, v, lw, u, o, st, BH, T, d, chunk, s);
  return repro::launch_wkv6<float>(r, k, v, lw, u, o, st, BH, T, d, chunk, s);
}
