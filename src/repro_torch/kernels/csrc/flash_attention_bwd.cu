// FlashAttention backward for Hopper (sm_90a): dQ, dK and dV of
// o = softmax(sm_scale * q k^T, mask) v from q, k, v, o, dO and the float32
// log-sum-exp that the forward kernel (flash_attention.cuh) writes beside o.
//
// The reference has no backward for its TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py): `jax.grad` through the Pallas call
// fails, and the reference trains on its XLA path.  This kernel is the
// gradient of the port's K2, with the forward's semantics: causal masking by
// absolute position (q_pos >= k_pos, Sq != Skv allowed), the finite -1e30
// sentinel, and a row whose keys are all masked (its log-sum-exp is written
// as +1e30) has zero gradient.
//
// With P = exp(sm_scale * q k^T - lse) (masked entries 0), dP = dO v^T,
// delta = rowsum(dO o) and dS = P (dP - delta):
//   dV = P^T dO,  dK = sm_scale dS^T q,  dQ = sm_scale dS k.
// Two launches, no float atomics, so the result repeats bit for bit:
//  * flash_bwd_dq_kernel: one block per (query head, 64-row query tile); it
//    first writes delta for its rows, then walks the key tiles the rows can
//    see and accumulates dQ in registers.
//  * flash_bwd_dkv_kernel: one block per (batch, kv head, 32-key tile); it
//    walks the query tiles of every query head of its group (q_per_kv heads
//    share one kv head), so the grouped-query sum of dK and dV happens in
//    registers inside the block.  It reads the delta the first launch wrote.
// K and V come as strided (batch, kv head, key) views, as in the forward;
// dK and dV are written contiguous as (batch * kv heads, Skv, d).
//
// What bounds it on an H100: at qwen2.5-3b's training shape (64 query heads
// on 8 kv heads, 512 x 512 causal, d 128, bf16) the five S^2 d products
// over the visible half are about 10.7 GFLOP (0.011 ms of tensor-core time)
// and the inputs and outputs about 37 MB (0.011 ms).  This first version is
// simple: every product is a float32 FMA on the CUDA cores over tiles held
// in shared memory as float32 (each thread a 4-column register tile), so it
// is bound by the CUDA cores' float32 rate and shared-memory traffic, far
// above that bound.  Tensor cores (`mma.sync` / `wgmma`), TMA loads and a
// fused dQ are later work.
#include "common.cuh"

namespace repro {
namespace fa_bwd {

constexpr int NT = 256;                    // threads a block
constexpr float LSE_MASKED = 1e30f;        // log-sum-exp of a row with no visible key

// A thread's register tile of an M x N product: 4 columns tx + j * TX and TM
// rows ty + i * TY, so that neighbouring threads read neighbouring columns.
template <int M, int N>
struct Micro {
  static constexpr int TN = 4;
  static constexpr int TX = N / TN;
  static constexpr int TY = NT / TX;
  static constexpr int TM = M / TY;
  static_assert(TX * TY == NT && TM * TY == M && TM >= 1, "micro-tile layout");
};

// acc += A B over K, A(m, k) = A[m * SAM + k * SAK], B(k, n) = B[k * SBK + n * SBN],
// all in shared memory.
template <int M, int N, int K, int SAM, int SAK, int SBK, int SBN>
__device__ __forceinline__ void micro_mma(float (&acc)[Micro<M, N>::TM][4],
                                          const float* __restrict__ A,
                                          const float* __restrict__ B, int tid) {
  using U = Micro<M, N>;
  const int tx = tid % U::TX;
  const int ty = tid / U::TX;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[U::TM], b[4];
#pragma unroll
    for (int i = 0; i < U::TM; ++i) a[i] = A[(ty + i * U::TY) * SAM + k * SAK];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * SBK + (tx + j * U::TX) * SBN];
#pragma unroll
    for (int i = 0; i < U::TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ROWS rows of width D from row `row0` of a row-major matrix with `n_rows`
// rows and row stride `ld` into float shared memory (row stride D + 1);
// rows past the end are zero.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_rows(float* __restrict__ s, const T* __restrict__ g,
                                          int row0, int n_rows, long long ld, int tid) {
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D;
    const int c = i % D;
    const int gr = row0 + r;
    s[r * (D + 1) + c] = gr < n_rows ? to_float(g[(long long)gr * ld + c]) : 0.f;
  }
}

template <int D>
struct DqLayout {
  static constexpr int BQ = 64, BKV = 64, LD = D + 1, LDS = BKV + 1;
  static constexpr int FLOATS = 2 * BQ * LD + 2 * BKV * LD + BQ * LDS + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

template <int D>
struct DkvLayout {
  static constexpr int BQ = 64, BKV = 32, LD = D + 1, LDS = BKV + 1;
  static constexpr int FLOATS = 2 * BKV * LD + 2 * BQ * LD + 2 * BQ * LDS + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Skv, int H, int q_per_kv, long long k_sb,
                    long long k_sh, long long k_st, long long v_sb, long long v_sh,
                    long long v_st, float sm_scale, int causal) {
  using L = DqLayout<D>;
  constexpr int BQ = L::BQ, BKV = L::BKV, LD = L::LD, LDS = L::LDS;
  using US = Micro<BQ, BKV>;
  using UQ = Micro<BQ, D>;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* dSs = Vs + BKV * LD;
  float* Ls = dSs + BQ * LDS;
  float* Dl = Ls + BQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;       // heaviest causal tiles first
  const long long row_off = (long long)bh * Sq * D;
  load_rows<T, BQ, D>(Qs, q + row_off, q0, Sq, D, tid);
  load_rows<T, BQ, D>(dOs, dout + row_off, q0, Sq, D, tid);

  // delta = rowsum(dO o) for this tile's rows, one warp a row
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int r = warp; r < BQ; r += NT / 32) {
    const int gr = q0 + r;
    float s = 0.f;
    if (gr < Sq) {
      const long long base = row_off + (long long)gr * D;
      for (int c = lane; c < D; c += 32) s += to_float(dout[base + c]) * to_float(o[base + c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      Dl[r] = s;
      Ls[r] = gr < Sq ? lse[(long long)bh * Sq + gr] : LSE_MASKED;
      if (gr < Sq) delta[(long long)bh * Sq + gr] = s;
    }
  }

  const long long kv_b = bh / H;
  const long long kv_h = (bh % H) / q_per_kv;
  const T* kb = k + kv_b * k_sb + kv_h * k_sh;
  const T* vb = v + kv_b * v_sb + kv_h * v_sh;
  int kv_end = Skv;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;       // tiles above the diagonal
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  float dqacc[UQ::TM][4];
#pragma unroll
  for (int i = 0; i < UQ::TM; ++i) dqacc[i][0] = dqacc[i][1] = dqacc[i][2] = dqacc[i][3] = 0.f;
  const int stx = tid % US::TX;
  const int sty = tid / US::TX;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();                        // every thread is done with the last K and dS
    load_rows<T, BKV, D>(Ks, kb, kv0, Skv, k_st, tid);
    load_rows<T, BKV, D>(Vs, vb, kv0, Skv, v_st, tid);
    __syncthreads();
    float s[US::TM][4], dp[US::TM][4];
#pragma unroll
    for (int i = 0; i < US::TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    micro_mma<BQ, BKV, D, LD, 1, 1, LD>(s, Qs, Ks, tid);    // S = Q K^T
    micro_mma<BQ, BKV, D, LD, 1, 1, LD>(dp, dOs, Vs, tid);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < US::TM; ++i) {
      const int r = sty + i * US::TY;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = stx + j * US::TX;
        const int kp = kv0 + c;
        const bool ok = qp < Sq && kp < Skv && (!causal || qp >= kp);
        const float p = ok ? expf(s[i][j] * sm_scale - Ls[r]) : 0.f;
        dSs[r * LDS + c] = p * (dp[i][j] - Dl[r]);
      }
    }
    __syncthreads();
    micro_mma<BQ, D, BKV, LDS, 1, LD, 1>(dqacc, dSs, Ks, tid);   // dQ += dS K
  }

  const int tx = tid % UQ::TX;
  const int ty = tid / UQ::TX;
#pragma unroll
  for (int i = 0; i < UQ::TM; ++i) {
    const int gr = q0 + ty + i * UQ::TY;
    if (gr >= Sq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[row_off + (long long)gr * D + tx + j * UQ::TX] = from_float<T>(dqacc[i][j] * sm_scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Sq, int Skv, int H, int q_per_kv, long long k_sb, long long k_sh,
                     long long k_st, long long v_sb, long long v_sh, long long v_st,
                     float sm_scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ, BKV = L::BKV, LD = L::LD, LDS = L::LDS;
  using US = Micro<BQ, BKV>;
  using UA = Micro<BKV, D>;
  extern __shared__ __align__(16) float smem_f[];
  float* Ks = smem_f;
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDS;
  float* Ls = dSs + BQ * LDS;
  float* Dl = Ls + BQ;

  const int tid = threadIdx.x;
  const int Hkv = H / q_per_kv;
  const int kvg = blockIdx.x;               // batch * Hkv + kv head
  const int b = kvg / Hkv;
  const int kvh = kvg % Hkv;
  const int kv0 = blockIdx.y * BKV;         // the first key tiles see most queries: launched first
  const T* kb = k + (long long)b * k_sb + (long long)kvh * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)kvh * v_sh;
  load_rows<T, BKV, D>(Ks, kb, kv0, Skv, k_st, tid);
  load_rows<T, BKV, D>(Vs, vb, kv0, Skv, v_st, tid);

  float dkacc[UA::TM][4], dvacc[UA::TM][4];
#pragma unroll
  for (int i = 0; i < UA::TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dkacc[i][j] = dvacc[i][j] = 0.f;
  const int stx = tid % US::TX;
  const int sty = tid / US::TX;
  const int q_first = causal ? (kv0 / BQ) * BQ : 0;        // earlier rows see none of these keys

  for (int hq = 0; hq < q_per_kv; ++hq) {
    const long long bh = (long long)b * H + (long long)kvh * q_per_kv + hq;
    const long long row_off = bh * Sq * D;
    for (int q0 = q_first; q0 < Sq; q0 += BQ) {
      __syncthreads();                      // every thread is done with the last Q, dO, P, dS
      load_rows<T, BQ, D>(Qs, q + row_off, q0, Sq, D, tid);
      load_rows<T, BQ, D>(dOs, dout + row_off, q0, Sq, D, tid);
      for (int r = tid; r < BQ; r += NT) {
        const int gr = q0 + r;
        Ls[r] = gr < Sq ? lse[bh * Sq + gr] : LSE_MASKED;
        Dl[r] = gr < Sq ? delta[bh * Sq + gr] : 0.f;
      }
      __syncthreads();
      float s[US::TM][4], dp[US::TM][4];
#pragma unroll
      for (int i = 0; i < US::TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      micro_mma<BQ, BKV, D, LD, 1, 1, LD>(s, Qs, Ks, tid);    // S = Q K^T
      micro_mma<BQ, BKV, D, LD, 1, 1, LD>(dp, dOs, Vs, tid);  // dP = dO V^T
#pragma unroll
      for (int i = 0; i < US::TM; ++i) {
        const int r = sty + i * US::TY;
        const int qp = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = stx + j * US::TX;
          const int kp = kv0 + c;
          const bool ok = qp < Sq && kp < Skv && (!causal || qp >= kp);
          const float p = ok ? expf(s[i][j] * sm_scale - Ls[r]) : 0.f;
          Ps[r * LDS + c] = p;
          dSs[r * LDS + c] = p * (dp[i][j] - Dl[r]);
        }
      }
      __syncthreads();
      micro_mma<BKV, D, BQ, 1, LDS, LD, 1>(dvacc, Ps, dOs, tid);   // dV += P^T dO
      micro_mma<BKV, D, BQ, 1, LDS, LD, 1>(dkacc, dSs, Qs, tid);   // dK += dS^T Q
    }
  }

  const long long out_off = (long long)kvg * Skv * D;
  const int tx = tid % UA::TX;
  const int ty = tid / UA::TX;
#pragma unroll
  for (int i = 0; i < UA::TM; ++i) {
    const int gr = kv0 + ty + i * UA::TY;
    if (gr >= Skv) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long at = out_off + (long long)gr * D + tx + j * UA::TX;
      dk[at] = from_float<T>(dkacc[i][j] * sm_scale);
      dv[at] = from_float<T>(dvacc[i][j]);
    }
  }
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int Sq,
               int Skv, int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st,
               long long v_sb, long long v_sh, long long v_st, float sm_scale, int causal,
               cudaStream_t s) {
  using LQ = DqLayout<D>;
  using LKV = DkvLayout<D>;
  const int nq = (Sq + LQ::BQ - 1) / LQ::BQ;
  const int nkv = (Skv + LKV::BKV - 1) / LKV::BKV;
  if (nq > 65535 || nkv > 65535 || H % q_per_kv || BH % H) return -1;
  auto kq = flash_bwd_dq_kernel<T, D>;
  auto kkv = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, LKV::BYTES);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kq<<<dim3(BH, nq), NT, LQ::BYTES, s>>>(qt, kt, vt, static_cast<const T*>(o), dot, lse, delta,
                                          static_cast<T*>(dq), Sq, Skv, H, q_per_kv, k_sb,
                                          k_sh, k_st, v_sb, v_sh, v_st, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(BH / q_per_kv, nkv), NT, LKV::BYTES, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H,
      q_per_kv, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_any(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq, void* dk,
                   void* dv, int BH, int Sq, int Skv, int d, int H, int q_per_kv,
                   long long k_sb, long long k_sh, long long k_st, long long v_sb,
                   long long v_sh, long long v_st, float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_FA_BWD_CASE(D_)                                                               \
  if (d == D_)                                                                              \
    return launch_bwd<T, D_>(q, k, v, o, dout, l, dl, dq, dk, dv, BH, Sq, Skv, H, q_per_kv, \
                             k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale, causal, s);
  REPRO_FA_BWD_CASE(32)
  REPRO_FA_BWD_CASE(64)
  REPRO_FA_BWD_CASE(128)
#undef REPRO_FA_BWD_CASE
  return -1;
}

}  // namespace fa_bwd
}  // namespace repro

// q, k, v, o, dout, lse (BH, Sq) float32, delta (BH, Sq) float32 scratch, dq (as q),
// dk/dv (BH / q_per_kv, Skv, d) contiguous; k/v strided as in the forward.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int Sq, int Skv, int d,
    int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, float sm_scale, int causal, void* stream) {
  return repro::fa_bwd::launch_bwd_any<__nv_bfloat16>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, BH, Sq, Skv, d, H, q_per_kv, k_sb, k_sh, k_st,
      v_sb, v_sh, v_st, sm_scale, causal, stream);
}

extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int Sq, int Skv, int d,
    int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, float sm_scale, int causal, void* stream) {
  return repro::fa_bwd::launch_bwd_any<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH,
                                              Sq, Skv, d, H, q_per_kv, k_sb, k_sh, k_st, v_sb,
                                              v_sh, v_st, sm_scale, causal, stream);
}
