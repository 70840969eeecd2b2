// FlashAttention forward (K2) at head dim 256 in bf16 for Hopper: TMA loads,
// `wgmma` products, one or two warpgroups of 64 query rows.
//
// Replaces, for every aligned bf16 call at d 256, the mma.sync body of
// flash_attention.cuh (stretched to d 256 from d 128), and with it the TPU
// kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  Semantics are those of that body:
// the finite -1e30 sentinel, causal masking by absolute position with
// `q_off` the position of query row 0, Sq != Skv, a fully masked row gives
// 0 and a log-sum-exp of +1e30, the optional float32 log-sum-exp (BH, Sq),
// and grouped heads over K/V given as strided (batch, kv head, key, d) views.
//
// What bounds it on an H100: gemma-7b's prefill (64 heads, G 1, 512 x 512
// causal, d 256) does about 9 GFLOP over its visible tile pairs and moves 67
// MB: 0.020 ms of memory traffic against 0.009 of tensor-core work, so on
// paper it is bytes-bound, and at this size what decides is how much of the
// tensor cores' rate the products reach between the softmax steps.  The
// mma.sync body held a 16 x 256 float32 output accumulator a warp (128 registers a
// thread, 248 in all), reread every B fragment from shared memory for each
// 16-row warp with `ldmatrix`, and waited at a block barrier for every key
// tile.  The design here:
//
// * One thread of the last consumer warpgroup (the one that never skips a
//   tile) loads the Q tile once and keeps K and V tiles in flight through a
//   two-stage ring by TMA (`cp.async.bulk.tensor`, the 128-byte swizzle):
//   once a tile's stage is released it loads the tile two ahead into it.
//   No warp is set aside for loads, so every thread may hold 255 registers
//   (with a producer warp, or a producer warpgroup and `setmaxnreg` 40 /
//   232, ptxas capped every thread at 168 and the consumers spilled 64-240
//   bytes).  A 256-wide row arrives as four boxes of 64 columns, so a tile
//   of R rows is four R x 128-byte boxes.  K and V each have a `full`
//   mbarrier per stage, so S can start before V lands; the threads release
//   a stage through one `empty` mbarrier once its tile's O += P V is done.
//   K and V are read through 4-D tensor maps over (batch, kv head, key, d)
//   with the view's own strides, so a grouped or strided view is never
//   copied; TMA zero-fills rows past Sq or Skv.
// * Tried and dropped, on gemma-7b's prefill at (64, 32) on an H100 80GB
//   HBM3 at 700 W: releasing K as soon as its scores were done, through a
//   second `empty` mbarrier (0.0558 ms against 0.049), and issuing S of tile
//   t + 1 before O += P V of tile t with its softmax under that product
//   (0.060 with the early release, 0.065 without: with two stages the next
//   tile's loads had no time to land).
// * One warpgroup per 64 query rows (BQ 64 or 128).  S = Q K^T is
//   `wgmma.m64nBKVk16` with both operands in shared memory (K-major, a k16
//   step 32 bytes along a box's rows, the next box every four steps).  The
//   mask and the online softmax run on the accumulator where it lies (its
//   per-warp layout is mma.sync's m16n8 layout), P is packed to bf16 pairs in
//   registers as the A operand of O += P V (`wgmma.m64n256k16`, A from
//   registers, V read MN-major through the transpose bit: no copy), so S and
//   P never touch shared memory.  O, 64 x 256 float32, is 128 registers a
//   thread.
// * Blocks an SM: at (64, 32) two (99 KB of shared memory and 128 threads
//   each), so one block's softmax overlaps the other's products; the other
//   tiles one.
// * Query tiles launch heaviest first (the causal diagonal's far end); a
//   warpgroup whose rows see none of a key tile skips its products but still
//   waits for the tile and releases it, so the ring's phases stay in step.
// * The epilogue normalises O, writes the warpgroup's rows as bf16 into its
//   own rows of the Q tile (no longer read) under the swizzle, and one thread
//   stores them by TMA, which clips rows past Sq.
//
// Requirements, checked by the wrapper before it chooses this body (else it
// takes flash_attention.cuh's): bf16, d 256, 16-byte-aligned q, k and v and
// k/v strides that are multiples of 8 elements.
#include "mma.cuh"
#include "sm90.cuh"

namespace repro {
namespace fa_tma {

using namespace sm90;

constexpr int D = 256;
constexpr int NBOX = D / 64;                // 64-column TMA boxes a row
constexpr int ALIGN = 1024;                 // the 128-byte swizzle's atom
constexpr int SM_SMEM = 233472;             // shared memory of an SM; 1 KB a block is kept
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Mirrored by flash_attention.flash_smem_bytes() at d 256 in bf16.
template <int BQ, int BKV>
struct FwdCfg {
  static constexpr int CONSUMERS = BQ / 64;
  static constexpr int THREADS = 128 * CONSUMERS;
  static constexpr int LOADER = 128 * (CONSUMERS - 1);   // the thread that issues the loads
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;        // one K or V tile
  static constexpr int BARS = 8 * (1 + 3 * STAGES);   // q_full; k_full, v_full, empty a stage
  static constexpr int SMEM = ALIGN + Q_BYTES + 2 * STAGES * KV_BYTES + BARS;
  // two blocks an SM where their shared memory fits and one warpgroup computes
  static constexpr int MINB = CONSUMERS == 1 && 2 * (SMEM + 1024) <= SM_SMEM ? 2 : 1;
  static_assert(BQ == 64 || BQ == 128, "BQ is 64 or 128");
  static_assert(BKV == 32 || BKV == 64, "BKV is 32 or 64");
};

template <int BQ, int BKV>
__global__ void __launch_bounds__(FwdCfg<BQ, BKV>::THREADS, FwdCfg<BQ, BKV>::MINB)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o, float* __restrict__ lse,
                     int Sq, int Skv, int H, int q_per_kv, float scale_log2, int causal,
                     int q_off) {
  using C = FwdCfg<BQ, BKV>;
  constexpr int NS = BKV / 8;               // n8 tiles of S
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t sq = base;                                 // NBOX boxes of BQ x 64
  const uint32_t sk = sq + C::Q_BYTES;                      // [stage] NBOX boxes of BKV x 64
  const uint32_t sv = sk + C::STAGES * C::KV_BYTES;
  const uint32_t bars = sv + C::STAGES * C::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + C::STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * C::STAGES + s); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest causal tiles first
  int kv_end = Skv;
  if (causal && q_off + q0 + BQ < kv_end) kv_end = q_off + q0 + BQ;   // tiles above the diagonal
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), C::THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads: Q once, K and V tile t into stage t % STAGES
  const bool loader = threadIdx.x == C::LOADER;
  const int kv_b = bh / H;
  const int kv_h = (bh % H) / q_per_kv;
  auto load_kv = [&](int t) {
    const int s = t % C::STAGES;
    mbar_expect_tx(k_full(s), C::KV_BYTES);
#pragma unroll
    for (int j = 0; j < NBOX; ++j)
      tma_load_4d(sk + s * C::KV_BYTES + j * BKV * 128, &map_k, k_full(s), 64 * j, t * BKV,
                  kv_h, kv_b);
    mbar_expect_tx(v_full(s), C::KV_BYTES);
#pragma unroll
    for (int j = 0; j < NBOX; ++j)
      tma_load_4d(sv + s * C::KV_BYTES + j * BKV * 128, &map_v, v_full(s), 64 * j, t * BKV,
                  kv_h, kv_b);
  };
  if (loader) {
    mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int j = 0; j < NBOX; ++j) tma_load_3d(sq + j * BQ * 128, &map_q, q_full, 64 * j, q0, bh);
    for (int t = 0; t < C::STAGES && t < n_tiles; ++t) load_kv(t);
  }

  // ---- warpgroup `wg`: query rows [q0 + 64 wg, q0 + 64 wg + 64) ------------------------
  constexpr unsigned FULL = 0xffffffffu;
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32;
  const int lane = t128 % 32;
  const int g = lane >> 2;                  // accumulator rows g and g + 8 of the warp's 16
  const int tq = lane & 3;                  // accumulator columns 2 tq, 2 tq + 1 of each n8 tile
  const int r0 = q0 + 64 * wg;              // the warpgroup's first row
  const int wq0 = q_off + r0 + warp * 16;   // position of the warp's first row
  const int row_a = wq0 + g;                // the thread's two rows' positions
  const int row_b = row_a + 8;
  const uint32_t qa = sq + wg * 64 * 128;   // the warpgroup's rows in each Q box

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;       // running max (log2 domain)
  float l_a = 0.f, l_b = 0.f;               // this thread's share of the running sums
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::STAGES;
    const int ph = (t / C::STAGES) & 1;
    const int kv0 = t * BKV;
    if (causal && kv0 > q_off + r0 + 63) {  // no row of the warpgroup sees this tile
      mbar_wait(k_full(s), ph);
      mbar_wait(v_full(s), ph);
    } else {
      const uint32_t kt = sk + s * C::KV_BYTES;
      const uint32_t vt = sv + s * C::KV_BYTES;

      // ---- S = Q K^T: 64 rows x BKV keys, both operands K-major in shared memory
      float sc[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
      mbar_wait(k_full(s), ph);
      fence_operands(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = smem_desc(qa + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = smem_desc(kt + (kk / 4) * BKV * 128 + (kk % 4) * 32, 16, 1024);
        Wgmma<BKV, 0, 0>::mma(sc, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);

      // ---- online softmax where the scores lie ---------------------------------
      const bool need_mask = kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > wq0);
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (need_mask) {
            const int kp = kv0 + j * 8 + 2 * tq + (e & 1);
            const int qp = e < 2 ? row_a : row_b;
            if (kp >= Skv || (causal && qp < kp)) x = NEG_INF;
          }
          sc[4 * j + e] = x;
        }
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
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
          sc[4 * j + e] = sc[4 * j + e] > 0.5f * NEG_INF ? exp2f(sc[4 * j + e] - mn) : 0.f;
        }
        sum_a += sc[4 * j] + sc[4 * j + 1];
        sum_b += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }
      // P as the A operand: the accumulator's n8 tiles 2 kk and 2 kk + 1 are the
      // k16 step kk of the m16n8k16 A fragment
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // ---- O += P V: V (keys x d) MN-major, its four boxes LBO apart ------------
      mbar_wait(v_full(s), ph);
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        WgmmaRS<256, 1>::mma(o, pa[kk], smem_desc(vt + kk * 16 * 128, BKV * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
    }
    mbar_arrive(empty(s));
    // the stage is free once every thread released it: the tile two ahead goes in
    if (loader && t + C::STAGES < n_tiles) {
      mbar_wait(empty(s), ph);
      load_kv(t + C::STAGES);
    }
  }

  // ---- normalise; the log-sum-exp; O through the warpgroup's Q rows by TMA ---------
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  const int ra = r0 + warp * 16 + g;        // the thread's rows
  if (lse != nullptr && tq == 0) {          // natural-log LSE for the backward
    float* lb = lse + (long long)bh * Sq;
    if (ra < Sq) lb[ra] = l_a == 0.f ? -NEG_INF : (m_a + log2f(l_a)) * LN2;
    if (ra + 8 < Sq) lb[ra + 8] = l_b == 0.f ? -NEG_INF : (m_b + log2f(l_b)) * LN2;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      const float inv = h ? inv_b : inv_a;
      const uint32_t at = qa + (j / 8) * BQ * 128 + r * 128 + (((j % 8) ^ (r & 7)) << 4) + 4 * tq;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                   "r"(pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv))
                   : "memory");
    }
  }
  fence_async_shared();
  if (wg == 0) named_sync<1, 128>(); else named_sync<2, 128>();
  if (t128 == 0) {
#pragma unroll
    for (int j = 0; j < NBOX; ++j) tma_store_3d(&map_o, qa + j * BQ * 128, 64 * j, r0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");   // before smem goes
  }
}

template <int BQ, int BKV>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int Sq,
               int Skv, int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st,
               long long v_sb, long long v_sh, long long v_st, float sm_scale, int causal,
               int q_off, cudaStream_t stream) {
  using C = FwdCfg<BQ, BKV>;
  const int nq = (Sq + BQ - 1) / BQ;
  if (nq > 65535 || H % q_per_kv || BH % H) return -1;
  auto kern = flash_fwd_tma_kernel<BQ, BKV>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int B = BH / H;
  const int Hkv = H / q_per_kv;
  CUtensorMap mq, mk, mv, mo;
  if (!encode_3d(&mq, q, D, Sq, BH, 64, BQ) ||
      !encode_4d(&mk, k, D, Skv, Hkv, B, k_st, k_sh, k_sb, 64, BKV) ||
      !encode_4d(&mv, v, D, Skv, Hkv, B, v_st, v_sh, v_sb, 64, BKV) ||
      !encode_3d(&mo, o, D, Sq, BH, 64, 64))
    return -3;
  kern<<<dim3(BH, nq), C::THREADS, C::SMEM, stream>>>(mq, mk, mv, mo, lse, Sq, Skv, H, q_per_kv,
                                                      sm_scale * LOG2E, causal, q_off);
  return (int)cudaGetLastError();
}

}  // namespace fa_tma
}  // namespace repro

// q (BH, Sq, 256) contiguous, k/v strided (batch, kv head, key, 256) views, o as q,
// lse (BH, Sq) float32 or null; H query heads a batch, q_per_kv of them a kv head.
// Returns a cudaError_t, -1 for a tile that is not compiled, -3 when a tensor
// map cannot be encoded.
extern "C" int repro_flash_attention_tma(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int BH, int Sq, int Skv, int H,
                                         int q_per_kv, long long k_sb, long long k_sh,
                                         long long k_st, long long v_sb, long long v_sh,
                                         long long v_st, float sm_scale, int causal, int q_off,
                                         int bq, int bkv, void* stream) {
  using namespace repro::fa_tma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_FA_TMA_CASE(BQ_, BKV_)                                                        \
  if (bq == BQ_ && bkv == BKV_)                                                             \
    return launch_fwd<BQ_, BKV_>(q, k, v, o, l, BH, Sq, Skv, H, q_per_kv, k_sb, k_sh, k_st, \
                                 v_sb, v_sh, v_st, sm_scale, causal, q_off, s);
  REPRO_FA_TMA_CASE(64, 32)
  REPRO_FA_TMA_CASE(64, 64)
  REPRO_FA_TMA_CASE(128, 32)
  REPRO_FA_TMA_CASE(128, 64)
#undef REPRO_FA_TMA_CASE
  return -1;
}

// Dynamic shared memory of one block of the tile, -1 for a tile that is not
// compiled; blocks an SM its launch bounds ask for (`minb`).  Mirrored by
// flash_attention.flash_smem_bytes() and tma_blocks_per_sm().
extern "C" int repro_flash_tma_smem_bytes(int bq, int bkv, int minb) {
  using namespace repro::fa_tma;
#define REPRO_FA_TMA_SMEM(BQ_, BKV_) \
  if (bq == BQ_ && bkv == BKV_) return minb ? FwdCfg<BQ_, BKV_>::MINB : FwdCfg<BQ_, BKV_>::SMEM;
  REPRO_FA_TMA_SMEM(64, 32)
  REPRO_FA_TMA_SMEM(64, 64)
  REPRO_FA_TMA_SMEM(128, 32)
  REPRO_FA_TMA_SMEM(128, 64)
#undef REPRO_FA_TMA_SMEM
  return -1;
}

// Blocks of the tile's kernel the device holds an SM at once, as the runtime
// computes it (registers, shared memory, threads), -1 for a tile that is not
// compiled or a runtime error.  Held against tma_blocks_per_sm() on the card.
extern "C" int repro_flash_tma_occupancy(int bq, int bkv) {
  using namespace repro::fa_tma;
#define REPRO_FA_TMA_OCC(BQ_, BKV_)                                               \
  if (bq == BQ_ && bkv == BKV_)                                                   \
    return occupancy(flash_fwd_tma_kernel<BQ_, BKV_>, FwdCfg<BQ_, BKV_>::THREADS, \
                     FwdCfg<BQ_, BKV_>::SMEM);
  REPRO_FA_TMA_OCC(64, 32)
  REPRO_FA_TMA_OCC(64, 64)
  REPRO_FA_TMA_OCC(128, 32)
  REPRO_FA_TMA_OCC(128, 64)
#undef REPRO_FA_TMA_OCC
  return -1;
}
