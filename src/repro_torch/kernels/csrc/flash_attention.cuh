// FlashAttention forward for Hopper (sm_90a): online-softmax attention,
// q (BH, Sq, d) against k/v of Skv keys, without materialising the scores.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  There the KV axis is the innermost,
// sequential grid axis and the running max / denominator / output live in
// scratch memory between grid steps.  Here one thread block owns a
// (head, BQ-row query tile) pair for its whole life, the KV axis is the
// block's loop and each warp owns 16 query rows.  Semantics kept from the
// reference: the finite -1e30 mask sentinel (a masked score never adds
// exp(0)), causal masking by absolute position (q_pos >= k_pos, no end
// alignment), Sq != Skv allowed, and a row whose keys are all masked gives 0
// (l == 0 -> 1) rather than NaN.  `q_off` is the position of query row 0
// (0 for a whole sequence; a rank's first token under context-parallel
// attention, whose queries are a block of the sequence and whose keys are
// the sequence's prefix): row r masks as position q_off + r, so the
// diagonal tile bound, the per-warp skip and the per-element mask all move
// by q_off, and key tiles after a block's last position are never read.  Given a pointer, the kernels also write each
// row's float32 log-sum-exp of the scaled scores, (BH, Sq), for the backward
// (flash_attention_bwd.cu); a fully masked row's is +1e30, so that the
// backward's exp(s - lse) is 0 there.  The serving path passes no pointer.
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
// so by the roofline it sits just on the bytes side.  At that size latency
// and instruction count decide: how many blocks are in flight, whether
// their K/V loads overlap the products, and how many instructions a tile
// costs.
//
// bf16 design (flash_fwd_bf16_kernel):
//  * scores, probabilities and the output accumulator stay in registers.
//    Both products are `mma.sync.m16n8k16` (bf16 in, float32 accumulate)
//    through inline PTX.  Q and K fragments come from shared memory with
//    `ldmatrix`, V fragments with `ldmatrix.trans`.  The float32 score
//    accumulator is scaled, masked, exponentiated (exp2 with
//    sm_scale * log2 e folded in) and summed where it lies; a row's max and
//    sum take two quad shuffles each.  The m16n8k16 accumulator layout of
//    two adjacent n8 tiles is the A layout of one k16 step, so the scores
//    are packed to bf16 pairs and fed to P V without leaving registers.  O is
//    rescaled in registers, normalised once and stored straight to memory.
//  * K/V tiles are copied with `cp.async` into two stages: tile t+1 is in
//    flight while tile t is computed, behind one barrier per tile.  Rows are
//    padded by 16 bytes, so the 8 rows one `ldmatrix` phase reads fall in 8
//    different bank groups.
//  * without S, P and O in shared memory a block takes Q plus two stages of
//    K and V (104,448 bytes at (128, 64), d 128), so two blocks fit an SM,
//    and `__launch_bounds__` caps the registers so that they do (128 a
//    thread for 8 warps; uncapped ptxas takes 198).  Query tiles are
//    launched heaviest first (the causal diagonal's far end), and only the
//    tiles that cross the diagonal or the ragged end of the keys pay for the
//    per-element mask.
//  * `vec_ok == 0` (a misaligned pointer or stride) loads synchronously with
//    scalar loads into the same stages.
//
// float32 inputs (flash_fwd_f32_kernel) keep the first design: true float32
// FMAs (no TF32), with scores and accumulator in shared memory.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace repro {

constexpr int FLASH_MAX_SMEM = 232448;   // bytes one block may use on sm_90
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory layout of one block; mirrored by flash_smem_bytes() in
// kernels/flash_attention.py, which the planner uses to prune tile shapes.
template <typename T, int D, int BQ, int BKV>
struct FlashLayout;

// bf16: the Q tile and two stages of K and V tiles, rows padded by 16 bytes.
template <int D, int BQ, int BKV>
struct FlashLayout<__nv_bfloat16, D, BQ, BKV> {
  static constexpr int LD = D + 8;
  static constexpr int Q_BYTES = BQ * LD * 2;
  static constexpr int KV_BYTES = BKV * LD * 2;   // one K or V tile
  static constexpr int STAGES = 2;
  static constexpr int TOTAL = Q_BYTES + 2 * STAGES * KV_BYTES;
  // blocks an SM should hold: as many as its 228 KB of shared memory take
  // (1 KB of each reserved), at most 2 of 8 warps (128 registers a thread)
  // or 3 of 4 warps (170); one where ptxas spilled under the 128-register
  // cap ((128, 32) at d 128, (128, 64) at d 64).  At d 256 a warp's 16 x 256
  // float32 output accumulator alone is 128 registers a thread, so the cap
  // is the hardware's 255: one block of 8 warps, or two of 4.
  static constexpr bool SPILLS_AT_2 = BQ == 128 && ((D == 128 && BKV == 32) ||
                                                    (D == 64 && BKV == 64));
  static constexpr int BY_SMEM = 233472 / (TOTAL + 1024);
  static constexpr int BY_REGS = D >= 256 ? (BQ == 128 ? 1 : 2)
                                          : BQ == 128 ? (SPILLS_AT_2 ? 1 : 2) : 3;
  static constexpr int MIN_BLOCKS = BY_SMEM < BY_REGS ? BY_SMEM : BY_REGS;
};

// float32: Q, K and V tiles, float32 scores and output accumulator.
template <int D, int BQ, int BKV>
struct FlashLayout<float, D, BQ, BKV> {
  static constexpr int LDQ = D + 4;
  static constexpr int LDS = BKV + 4;
  static constexpr int LDO = D + 4;
  static constexpr int Q_BYTES = BQ * LDQ * 4;
  static constexpr int KV_BYTES = BKV * LDQ * 4;
  static constexpr int S_BYTES = BQ * LDS * 4;
  static constexpr int O_BYTES = BQ * LDO * 4;
  static constexpr int TOTAL = Q_BYTES + 2 * KV_BYTES + S_BYTES + O_BYTES;
};

__device__ __forceinline__ unsigned special_reg_tid_x() {
  unsigned r;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned special_reg_ctaid_x() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned special_reg_ctaid_y() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(r));
  return r;
}

// The register cap of __launch_bounds__ lets FlashLayout::MIN_BLOCKS blocks
// share an SM (at (128, 64), d 128: two blocks, 128 registers a thread).
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ * 2, (FlashLayout<__nv_bfloat16, D, BQ, BKV>::MIN_BLOCKS))
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Skv, int H, int q_per_kv,
                      long long k_sb, long long k_sh,
                      long long k_st, long long v_sb, long long v_sh, long long v_st,
                      float scale_log2, int causal, int q_off, int vec_ok) {
  using L = FlashLayout<__nv_bfloat16, D, BQ, BKV>;
  using bf16 = __nv_bfloat16;
  constexpr int NT = BQ * 2;                // one warp per 16 query rows
  constexpr int LD = L::LD;
  constexpr int NS = BKV / 8;               // n8 tiles of the scores
  constexpr int NO = D / 8;                 // n8 tiles of the output
  constexpr unsigned FULL = 0xffffffffu;
  static_assert(D % 16 == 0 && BKV % 16 == 0 && BQ % 16 == 0, "tiles are whole mma steps");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L::Q_BYTES);              // [stage][BKV][LD]
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L::Q_BYTES + L::STAGES * L::KV_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;                  // accumulator rows g and g + 8
  const int tq = lane & 3;                  // accumulator columns 2 tq, 2 tq + 1
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest causal tiles first

  const bf16* qb = q + (long long)bh * Sq * D;
  const long long kv_b = bh / H;
  const long long kv_h = (bh % H) / q_per_kv;
  const bf16* kb = k + kv_b * k_sb + kv_h * k_sh;
  const bf16* vb = v + kv_b * v_sb + kv_h * v_sh;

  int kv_end = Skv;
  if (causal && q_off + q0 + BQ < kv_end) kv_end = q_off + q0 + BQ;   // tiles above the diagonal
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  flash_copy<BQ, D, LD, NT>(Qs, qb, q0, Sq, D, vec_ok, tid);
  flash_copy<BKV, D, LD, NT>(Ks, kb, 0, Skv, k_st, vec_ok, tid);
  flash_copy<BKV, D, LD, NT>(Vs, vb, 0, Skv, v_st, vec_ok, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                          // Q and the first K/V tile landed

  // positions, not rows: row r of q sits at q_off + r (the rows of the store
  // are read again from the special registers below)
  const int wq0 = q_off + q0 + warp * 16;   // position of this warp's first query row
  const int row_a = wq0 + g;                // the thread's two rows' positions
  const int row_b = row_a + 8;
  const bf16* Qw = Qs + warp * 16 * LD;

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;       // running max (log2 domain)
  float l_a = 0.f, l_b = 0.f;               // this thread's share of the running sums

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      cp_async_wait<0>();
      __syncthreads();                      // tile t landed; every warp is done with t - 1
    }
    if (t + 1 < n_tiles) {                  // into the stage tile t - 1 used
      const int st = (t + 1) & 1;
      flash_copy<BKV, D, LD, NT>(Ks + st * BKV * LD, kb, (t + 1) * BKV, Skv, k_st, vec_ok, tid);
      flash_copy<BKV, D, LD, NT>(Vs + st * BKV * LD, vb, (t + 1) * BKV, Skv, v_st, vec_ok, tid);
    }
    cp_async_commit();
    const int kv0 = t * BKV;
    if (causal && kv0 > wq0 + 15) continue;           // nothing visible to this warp
    const bf16* Kt = Ks + (t & 1) * BKV * LD;
    const bf16* Vt = Vs + (t & 1) * BKV * LD;

    // ---- S = Q K^T: 16 rows x BKV keys per warp, in registers -----------------
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, smem_addr(Qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {    // 16 keys: two n8 tiles
        unsigned b[4];
        ldmatrix_x4(b, smem_addr(Kt + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * j], a, b[0], b[1]);
        mma_bf16(s[2 * j + 1], a, b[2], b[3]);
      }
    }

    // ---- online softmax where the scores lie ------------------------------------
    const bool need_mask = kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > wq0);
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int kp = kv0 + j * 8 + 2 * tq + (e & 1);
          const int qp = e < 2 ? row_a : row_b;
          if (kp >= Skv || (causal && qp < kp)) x = NEG_INF;
        }
        s[j][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a);
    const float alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_a : mn_b;
        s[j][e] = s[j][e] > 0.5f * NEG_INF ? exp2f(s[j][e] - mn) : 0.f;
      }
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= alpha_a;
      oacc[n][1] *= alpha_a;
      oacc[n][2] *= alpha_b;
      oacc[n][3] *= alpha_b;
    }

    // ---- O += P V: P straight from the score registers ----------------------------
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {    // 16 output columns: two n8 tiles
        unsigned b[4];
        ldmatrix_x4_trans(b, smem_addr(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       n * 16 + (lane >> 4) * 8));
        mma_bf16(oacc[2 * n], a, b[0], b[1]);
        mma_bf16(oacc[2 * n + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();                       // no copy outlives the block

  // The thread's row, column and head are read again from the special
  // registers rather than kept live through the loop: under the register cap
  // ptxas would otherwise spill one of them.
  const unsigned tx = special_reg_tid_x();
  const int ra = (int)((gridDim.y - 1 - special_reg_ctaid_y()) * BQ + (tx / 32) * 16 +
                       ((tx % 32) >> 2));
  const int rb = ra + 8;
  const int tc = 2 * (int)(tx & 3);

  // ---- normalise once and store the warp's 16 rows --------------------------------
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  if (lse != nullptr && tc == 0) {          // natural-log LSE for the backward
    float* lb = lse + (long long)special_reg_ctaid_x() * Sq;
    if (ra < Sq) lb[ra] = l_a == 0.f ? -NEG_INF : (m_a + log2f(l_a)) * LN2;
    if (rb < Sq) lb[rb] = l_b == 0.f ? -NEG_INF : (m_b + log2f(l_b)) * LN2;
  }
  bf16* ob = o + (long long)special_reg_ctaid_x() * Sq * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tc;
    if (ra < Sq)
      *reinterpret_cast<unsigned*>(ob + (long long)ra * D + c) =
          pack_bf16(oacc[n][0] * inv_a, oacc[n][1] * inv_a);
    if (rb < Sq)
      *reinterpret_cast<unsigned*>(ob + (long long)rb * D + c) =
          pack_bf16(oacc[n][2] * inv_b, oacc[n][3] * inv_b);
  }
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ * 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int H,
                     int q_per_kv, long long k_sb, long long k_sh, long long k_st,
                     long long v_sb, long long v_sh, long long v_st, float sm_scale,
                     int causal, int q_off, int vec_ok) {
  using L = FlashLayout<float, D, BQ, BKV>;
  constexpr int NT = BQ * 2;                // one warp per 16 query rows
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDO = L::LDO;
  constexpr unsigned FULL = 0xffffffffu;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = reinterpret_cast<float*>(smem_raw + L::Q_BYTES);
  float* Vs = reinterpret_cast<float*>(smem_raw + L::Q_BYTES + L::KV_BYTES);
  float* Ss = reinterpret_cast<float*>(smem_raw + L::Q_BYTES + 2 * L::KV_BYTES);
  float* Os = reinterpret_cast<float*>(smem_raw + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = lane >> 1;                // query row of this warp's 16
  const int half = lane & 1;                // which interleaved half of a row
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  const float* qb = q + (long long)bh * Sq * D;
  const long long kv_b = bh / H;
  const long long kv_h = (bh % H) / q_per_kv;
  const float* kb = k + kv_b * k_sb + kv_h * k_sh;
  const float* vb = v + kv_b * v_sb + kv_h * v_sh;

  load_tile<float, BQ, D, LDQ, NT>(Qs, qb, q0, 0, Sq, D, D, vec_ok, tid);
  for (int i = tid; i < BQ * LDO; i += NT) Os[i] = 0.f;
  __syncthreads();

  float* Sw = Ss + warp * 16 * LDS;
  float* Ow = Os + warp * 16 * LDO;
  float* srow = Sw + row * LDS;
  float* orow = Ow + row * LDO;
  const float* qrow = Qs + (warp * 16 + row) * LDQ;

  float m_run = NEG_INF;
  float l_run = 0.f;
  const int q_abs = q_off + q0 + warp * 16 + row;   // the row's position
  const int warp_last_q = q_off + q0 + warp * 16 + 15;

  int kv_end = Skv;
  if (causal && q_off + q0 + BQ < kv_end) kv_end = q_off + q0 + BQ;   // tiles above the diagonal
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();                        // every warp is done with the last tile
    load_tile<float, BKV, D, LDQ, NT>(Ks, kb, kv0, 0, Skv, D, k_st, vec_ok, tid);
    load_tile<float, BKV, D, LDQ, NT>(Vs, vb, kv0, 0, Skv, D, v_st, vec_ok, tid);
    __syncthreads();
    if (causal && kv0 > warp_last_q) continue;   // nothing visible to this warp

    // ---- S = Q K^T for this warp's 16 rows, two lanes per row -----------------
    for (int j = 0; j < BKV / 2; ++j) {
      const int c = 2 * j + half;
      const float* krow = Ks + c * LDQ;
      float s = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) s = fmaf(qrow[e], krow[e], s);
      srow[c] = s;
    }
    __syncwarp();

    // ---- online softmax: two lanes per row, interleaved columns -------------
    float sv[BKV / 2];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const int c = 2 * j + half;
      const int k_pos = kv0 + c;
      const bool ok = k_pos < Skv && (!causal || q_abs >= k_pos);
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
      srow[c] = p;
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    for (int dc = half; dc < D; dc += 2) orow[dc] *= alpha;
    __syncwarp();

    // ---- O += P V --------------------------------------------------------------
    for (int dc = half; dc < D; dc += 2) {
      float acc = orow[dc];
#pragma unroll 8
      for (int c = 0; c < BKV; ++c) acc = fmaf(srow[c], Vs[c * LDQ + dc], acc);
      orow[dc] = acc;
    }
    __syncwarp();
  }

  // ---- normalise and write this warp's 16 rows ---------------------------------
  const int q_pos = q_abs - q_off;          // the row
  const float inv = 1.f / (l_run == 0.f ? 1.f : l_run);
  if (lse != nullptr && half == 0 && q_pos < Sq)
    lse[(long long)bh * Sq + q_pos] = l_run == 0.f ? -NEG_INF : m_run + logf(l_run);
  for (int dc = half; dc < D; dc += 2) orow[dc] *= inv;
  __syncwarp();
  float* ob = o + (long long)bh * Sq * D;
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D;
    const int c = e % D;
    const int gq = q0 + warp * 16 + r;
    if (gq < Sq) ob[(long long)gq * D + c] = Ow[r * LDO + c];
  }
}

template <int D, int BQ, int BKV>
int launch_flash_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                      int Sq,
                      int Skv, int H, int q_per_kv, long long k_sb, long long k_sh,
                      long long k_st, long long v_sb, long long v_sh, long long v_st,
                      float sm_scale, int causal, int q_off, int vec_ok, cudaStream_t stream) {
  using L = FlashLayout<__nv_bfloat16, D, BQ, BKV>;
  using bf16 = __nv_bfloat16;
  constexpr float LOG2E = 1.4426950408889634f;
  const int nq = (Sq + BQ - 1) / BQ;
  if (nq > 65535) return -1;                // query tiles run along gridDim.y
  auto kern = flash_fwd_bf16_kernel<D, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::TOTAL);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(BH, nq), BQ * 2, L::TOTAL, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Sq, Skv, H, q_per_kv, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
      sm_scale * LOG2E, causal, q_off, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BQ, int BKV>
int launch_flash_tile(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                      int Sq,
                      int Skv, int H, int q_per_kv, long long k_sb, long long k_sh,
                      long long k_st, long long v_sb, long long v_sh, long long v_st,
                      float sm_scale, int causal, int q_off, int vec_ok, cudaStream_t stream) {
  using L = FlashLayout<T, D, BQ, BKV>;
  if constexpr (L::TOTAL > FLASH_MAX_SMEM) {
    return -2;                              // not instantiated: it could never launch
  } else if constexpr (is_bf16<T>::value) {
    return launch_flash_bf16<D, BQ, BKV>(q, k, v, o, lse, BH, Sq, Skv, H, q_per_kv, k_sb, k_sh,
                                         k_st, v_sb, v_sh, v_st, sm_scale, causal, q_off,
                                         vec_ok, stream);
  } else {
    auto kern = flash_fwd_f32_kernel<D, BQ, BKV>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::TOTAL);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + BQ - 1) / BQ, BH);
    kern<<<grid, BQ * 2, L::TOTAL, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, Sq, Skv, H, q_per_kv, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
        sm_scale, causal, q_off, vec_ok);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D, int BQ, int BKV>
constexpr int flash_tile_smem() { return FlashLayout<T, D, BQ, BKV>::TOTAL; }

#define REPRO_FLASH_TILES(X, D_)                                                          \
  X(D_, 64, 32) X(D_, 64, 64) X(D_, 128, 32) X(D_, 128, 64)
#define REPRO_FLASH_ALL(X)                                                                \
  REPRO_FLASH_TILES(X, 32) REPRO_FLASH_TILES(X, 64) REPRO_FLASH_TILES(X, 128)               \
  REPRO_FLASH_TILES(X, 256)

// Dispatch over the compiled shapes: d in {32, 64, 128, 256}, BQ in {64, 128},
// BKV in {32, 64} (at d 256 in float32 only (64, 32) fits a block).  Returns a cudaError_t, -1 for a shape that is not
// compiled, -2 for a tile whose shared memory does not fit one block.
template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq,
                 int Skv, int d, int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st,
                 long long v_sb, long long v_sh, long long v_st, float sm_scale, int causal,
                 int q_off, int bq, int bkv, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(D_, BQ_, BKV_)                                                   \
  if (d == D_ && bq == BQ_ && bkv == BKV_)                                                \
    return launch_flash_tile<T, D_, BQ_, BKV_>(q, k, v, o, static_cast<float*>(lse), BH, Sq, \
                                               Skv, H, q_per_kv, k_sb, k_sh, k_st, v_sb,  \
                                               v_sh, v_st, sm_scale, causal, q_off,       \
                                               vec_ok, s);
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
