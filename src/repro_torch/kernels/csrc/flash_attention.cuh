// FlashAttention forward for Hopper (sm_90a): online-softmax attention,
// q (BH, Sq, d) against k/v of Skv keys, without materialising the scores.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  There the KV axis is the innermost,
// sequential grid axis and the running max / denominator / output live in
// scratch memory between grid steps.  Here one thread block owns a
// (head, BQ-row query tile) pair for its whole life, the KV axis is the
// block's loop, each warp owns 16 query rows, the running max and
// denominator live in registers and the float32 output accumulator in the
// block's shared memory.  Semantics kept from the reference: the finite
// -1e30 mask sentinel, causal masking by absolute position (q_pos >= k_pos,
// no end alignment), Sq != Skv allowed, and a row whose keys are all masked
// gives 0 (l == 0 -> 1) rather than NaN.
//
// Grouped-query attention without a repeated copy: the reference repeats
// K/V `q_per_kv` times before its kernel; this kernel takes the un-repeated
// K/V with explicit (batch, kv-head, key) strides and maps query head h of a
// batch to kv head h / q_per_kv, so the serving path makes no repeated copy
// and the query heads of one group share their K/V tiles through the L2.
//
// What bounds it on an H100: the serving prefill (64 query heads on 8 kv
// heads, 512 x 512 causal, d = 128, bf16) does 4 * 64 * 512 * 512 * 128 / 2
// = 4.3 GFLOP and has to move 19 MB (q and o once, the un-repeated k and v
// once): about 4 microseconds of tensor-core work and 6 of memory traffic,
// so by the roofline it sits just on the bytes side, and far below either
// bound a block's own shared-memory traffic and softmax arithmetic decide
// its speed.  The bf16 path runs both products on the tensor cores
// (`mma.sync` via nvcuda::wmma) and skips tiles above the causal diagonal.
// It is a first, simple kernel: scores, probabilities and the accumulator
// pass through shared memory because a wmma fragment's layout is opaque; a
// register-resident `wgmma` pipeline with TMA loads is the known faster
// route.  float32 inputs use true float32 FMAs (no TF32).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace repro {

constexpr int FLASH_MAX_SMEM = 232448;   // bytes one block may use on sm_90

// Shared-memory layout of one block; mirrored by flash_smem_bytes() in
// kernels/flash_attention.py, which the planner uses to prune tile shapes.
template <typename T, int D, int BQ, int BKV>
struct FlashLayout {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDQ = D + PAD;       // rows of the Q, K and V tiles
  static constexpr int LDS = BKV + 4;       // float32 scores
  static constexpr int LDP = BKV + PAD;     // bf16 probabilities (bf16 path only)
  static constexpr int LDO = D + 4;         // float32 output accumulator
  static constexpr int Q_BYTES = BQ * LDQ * (int)sizeof(T);
  static constexpr int KV_BYTES = BKV * LDQ * (int)sizeof(T);
  static constexpr int S_BYTES = BQ * LDS * 4;
  static constexpr int P_BYTES = is_bf16<T>::value ? BQ * LDP * (int)sizeof(T) : 0;
  static constexpr int O_BYTES = BQ * LDO * 4;
  static constexpr int TOTAL = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES + O_BYTES;
};

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ * 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Skv, int H, int q_per_kv,
                 long long k_sb, long long k_sh, long long k_st,
                 long long v_sb, long long v_sh, long long v_st,
                 float sm_scale, int causal, int vec_ok) {
  using L = FlashLayout<T, D, BQ, BKV>;
  constexpr int NT = BQ * 2;                // one warp per 16 query rows
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
  constexpr unsigned FULL = 0xffffffffu;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = reinterpret_cast<T*>(smem_raw + L::Q_BYTES);
  T* Vs = reinterpret_cast<T*>(smem_raw + L::Q_BYTES + L::KV_BYTES);
  float* Ss = reinterpret_cast<float*>(smem_raw + L::Q_BYTES + 2 * L::KV_BYTES);
  T* Ps = reinterpret_cast<T*>(smem_raw + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES);
  float* Os = reinterpret_cast<float*>(smem_raw + L::Q_BYTES + 2 * L::KV_BYTES +
                                       L::S_BYTES + L::P_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = lane >> 1;                // query row of this warp's 16
  const int half = lane & 1;                // which interleaved half of a row
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + (long long)bh * Sq * D;
  const long long kv_b = bh / H;
  const long long kv_h = (bh % H) / q_per_kv;
  const T* kb = k + kv_b * k_sb + kv_h * k_sh;
  const T* vb = v + kv_b * v_sb + kv_h * v_sh;

  load_tile<T, BQ, D, LDQ, NT>(Qs, qb, q0, 0, Sq, D, D, vec_ok, tid);
  for (int i = tid; i < BQ * LDO; i += NT) Os[i] = 0.f;
  __syncthreads();

  T* Qw = Qs + warp * 16 * LDQ;
  float* Sw = Ss + warp * 16 * LDS;
  T* Pw = Ps + warp * 16 * LDP;
  float* Ow = Os + warp * 16 * LDO;
  float* srow = Sw + row * LDS;
  float* orow = Ow + row * LDO;

  float m_run = NEG_INF;
  float l_run = 0.f;
  const int q_pos = q0 + warp * 16 + row;
  const int warp_last_q = q0 + warp * 16 + 15;

  int kv_end = Skv;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;   // tiles above the diagonal
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();                        // every warp is done with the last tile
    load_tile<T, BKV, D, LDQ, NT>(Ks, kb, kv0, 0, Skv, D, k_st, vec_ok, tid);
    load_tile<T, BKV, D, LDQ, NT>(Vs, vb, kv0, 0, Skv, D, v_st, vec_ok, tid);
    __syncthreads();
    if (causal && kv0 > warp_last_q) continue;   // nothing visible to this warp

    // ---- S = Q K^T for this warp's 16 rows --------------------------------
    if constexpr (is_bf16<T>::value) {
      using namespace nvcuda;
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
        wmma::fill_fragment(sacc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qw + kk * 16, LDQ);
          wmma::load_matrix_sync(fb, Ks + n * 16 * LDQ + kk * 16, LDQ);
          wmma::mma_sync(sacc, fa, fb, sacc);
        }
        wmma::store_matrix_sync(Sw + n * 16, sacc, LDS, wmma::mem_row_major);
      }
    } else {
      const T* qrow = Qw + row * LDQ;
      for (int j = 0; j < BKV / 2; ++j) {
        const int c = 2 * j + half;
        const T* krow = Ks + c * LDQ;
        float s = 0.f;
#pragma unroll 8
        for (int e = 0; e < D; ++e) s = fmaf(to_float(qrow[e]), to_float(krow[e]), s);
        srow[c] = s;
      }
    }
    __syncwarp();

    // ---- online softmax: two lanes per row, interleaved columns -------------
    float sv[BKV / 2];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const int c = 2 * j + half;
      const int k_pos = kv0 + c;
      const bool ok = k_pos < Skv && (!causal || q_pos >= k_pos);
      const float s = ok ? srow[c] * sm_scale : NEG_INF;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const int c = 2 * j + half;
      const float p = sv[j] > 0.5f * NEG_INF ? expf(sv[j] - m_new) : 0.f;
      sum += p;
      if constexpr (is_bf16<T>::value) {
        Pw[row * LDP + c] = __float2bfloat16(p);
      } else {
        srow[c] = p;
      }
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    for (int dc = half; dc < D; dc += 2) orow[dc] *= alpha;
    __syncwarp();

    // ---- O += P V --------------------------------------------------------------
    if constexpr (is_bf16<T>::value) {
      using namespace nvcuda;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp[BKV / 16];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) wmma::load_matrix_sync(fp[kk], Pw + kk * 16, LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
        wmma::load_matrix_sync(oacc, Ow + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
          wmma::load_matrix_sync(fv, Vs + kk * 16 * LDQ + n * 16, LDQ);
          wmma::mma_sync(oacc, fp[kk], fv, oacc);
        }
        wmma::store_matrix_sync(Ow + n * 16, oacc, LDO, wmma::mem_row_major);
      }
    } else {
      for (int dc = half; dc < D; dc += 2) {
        float acc = orow[dc];
#pragma unroll 8
        for (int c = 0; c < BKV; ++c) acc = fmaf(srow[c], to_float(Vs[c * LDQ + dc]), acc);
        orow[dc] = acc;
      }
    }
    __syncwarp();
  }

  // ---- normalise and write this warp's 16 rows ---------------------------------
  const float inv = 1.f / (l_run == 0.f ? 1.f : l_run);
  for (int dc = half; dc < D; dc += 2) orow[dc] *= inv;
  __syncwarp();
  T* ob = o + (long long)bh * Sq * D;
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D;
    const int c = e % D;
    const int gq = q0 + warp * 16 + r;
    if (gq < Sq) ob[(long long)gq * D + c] = from_float<T>(Ow[r * LDO + c]);
  }
}

template <typename T, int D, int BQ, int BKV>
int launch_flash_tile(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                      int Skv, int H, int q_per_kv, long long k_sb, long long k_sh,
                      long long k_st, long long v_sb, long long v_sh, long long v_st,
                      float sm_scale, int causal, int vec_ok, cudaStream_t stream) {
  using L = FlashLayout<T, D, BQ, BKV>;
  if (L::TOTAL > FLASH_MAX_SMEM) return -2;
  auto kern = flash_fwd_kernel<T, D, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::TOTAL);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, BQ * 2, L::TOTAL, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, q_per_kv, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
      sm_scale, causal, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BQ, int BKV>
constexpr int flash_tile_smem() { return FlashLayout<T, D, BQ, BKV>::TOTAL; }

#define REPRO_FLASH_TILES(X, D_)                                                          \
  X(D_, 64, 32) X(D_, 64, 64) X(D_, 128, 32) X(D_, 128, 64)
#define REPRO_FLASH_ALL(X) REPRO_FLASH_TILES(X, 32) REPRO_FLASH_TILES(X, 64) REPRO_FLASH_TILES(X, 128)

// Dispatch over the compiled shapes: d in {32, 64, 128}, BQ in {64, 128},
// BKV in {32, 64}.  Returns a cudaError_t, -1 for a shape that is not
// compiled, -2 for a tile whose shared memory does not fit one block.
template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
                 int d, int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st,
                 long long v_sb, long long v_sh, long long v_st, float sm_scale, int causal,
                 int bq, int bkv, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(D_, BQ_, BKV_)                                                   \
  if (d == D_ && bq == BQ_ && bkv == BKV_)                                                \
    return launch_flash_tile<T, D_, BQ_, BKV_>(q, k, v, o, BH, Sq, Skv, H, q_per_kv, k_sb, \
                                               k_sh, k_st, v_sb, v_sh, v_st, sm_scale,    \
                                               causal, vec_ok, s);
  REPRO_FLASH_ALL(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
  return -1;
}

template <typename T>
int flash_smem_bytes(int bq, int bkv, int d) {
#define REPRO_FLASH_SMEM_CASE(D_, BQ_, BKV_)                                              \
  if (d == D_ && bq == BQ_ && bkv == BKV_) return flash_tile_smem<T, D_, BQ_, BKV_>();
  REPRO_FLASH_ALL(REPRO_FLASH_SMEM_CASE)
#undef REPRO_FLASH_SMEM_CASE
  return -1;
}

}  // namespace repro
