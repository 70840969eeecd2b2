// FlashAttention backward (K2-bwd) at head dim 256 in bf16 for Hopper: TMA
// loads, `wgmma` products, S and dP computed once per (query tile, key tile)
// pair in each of two launches, no atomics.
//
// Replaces, for every aligned bf16 call at d 256, flash_attention_bwd.cu's
// mma.sync bodies (stretched to d 256 from d 128 by splitting the output
// columns over the grid, so that each half recomputed S and dP: 11 products
// of the five needed, about 200 KB and 245-255 registers a block, 80 bytes
// spilled).  The reference has no backward for its TPU kernel
// `_flash_kernel` (src/repro/kernels/flash_attention.py).  Semantics are
// flash_attention_bwd.cu's: P = exp(sm_scale q k^T - lse) with causal
// masking by absolute position (`q_off` the position of query row 0), the
// -1e30 sentinel, Sq != Skv, zero gradient for a row whose log-sum-exp is
// +1e30, grouped heads over strided (batch, kv head, key, d) K/V views, and
// dK, dV written contiguous as (batch * kv heads, Skv, d); delta =
// rowsum(P dP) (flash_attention_bwd.cu says why not rowsum(dO o)) is written
// by the first launch for the second.  No float
// atomics: a call repeats bit for bit.
//
// What bounds it on an H100: gemma-7b's training pass (64 heads, G 1, 512 x
// 512 causal, d 256) moves about 134 MB (0.040 ms) and its five products
// over the visible half are about 21 GFLOP (0.022 ms at 989 TFLOP/s); two
// launches that share no S and dP do seven.  The design:
//
// * Both launches: 256 threads, two warpgroups, one block an SM.  One
//   thread loads the block's resident tiles once and keeps the other
//   operand's tiles in a two-stage TMA ring, loading the step two ahead into
//   a stage once both warpgroups released it (a 256-wide row arrives as four
//   64-column boxes under the 128-byte swizzle; K/V are read through 4-D maps
//   with the view's strides; rows past Sq or Skv read as zeros).  No warp is
//   set aside for loads, so a thread may hold 255 registers: with a producer
//   warpgroup and `setmaxnreg` 40 / 232 ptxas capped every thread at 168 and
//   the dK/dV body spilled 308 bytes.
// * dQ launch: one block per (query head, 128-row query tile), heaviest
//   causal tiles first; Q and dO resident, K and V in the ring in tiles of 32
//   keys.  Each warpgroup owns 64 query rows and all of their dQ (128
//   registers) and works on its own: S and dP by `wgmma.m64n32k16` (both
//   operands K-major in shared memory), P and dS = P (dP - delta) where they
//   lie, and dQ += dS K with dS as the A operand in registers
//   (`wgmma.m64n256k16`, K read MN-major through the transpose bit).  So S
//   and dP are computed once per pair, the two warpgroups share each K/V tile
//   and never wait for each other, and a warpgroup whose rows see none of a
//   key tile only releases it.  A first pass over the key tiles (S and dP
//   again) sums delta = rowsum(P dP) from the P recomputed here.  (A 64-row
//   block whose warpgroups split the keys of S and dP and the columns of dQ,
//   handing dS over through shared memory behind a named barrier each tile,
//   took 0.096 ms against 0.080 on gemma-7b's training pass, H100 80GB HBM3
//   at 700 W, before that first pass.)
// * dK/dV launch: one block per (kv head, 64-key tile), the first key tiles
//   (which see most queries) first; K and V resident, Q, dO in the ring; the
//   block walks every query tile that can see its keys for each query head of
//   its group in turn, so a group needs no fold across blocks.  dK and dV of
//   64 keys over all 256 columns would take 256 registers a thread, so each
//   warpgroup holds dK and dV[:, 128 w : 128 w + 128] (128 registers): it
//   computes S^T and dP^T for its half of the step's 64 queries
//   (`wgmma.m64n32k16`), masks and exponentiates them where they lie with its
//   columns' lse and delta read from device memory (L2), and writes its half
//   of P^T and dS^T in bf16 into 64 x 64 shared tiles under the swizzle;
//   after a named barrier both warpgroups read the whole tiles as the A
//   operands of their `wgmma.m64n128k16` into their own columns.  The tiles
//   are double-buffered, so one barrier a step suffices.  So the products
//   are the seven a two-launch, atomic-free design needs.  (Splitting the
//   roles instead, warpgroup 0 computing S^T, P^T and all of dV and
//   warpgroup 1 dP^T, dS^T and all of dK with P^T handed over in float32,
//   took this launch from 0.084 to 0.120 ms on the same pass and card.)
// * Epilogues write bf16 through the drained resident tiles under the
//   swizzle, and one thread a warpgroup stores them by TMA, which clips rows
//   past Sq or Skv.
// * P and dS enter their products as one bf16 each (FlashAttention's
//   choice), not as the two bf16 parts of the mma.sync bodies.
//
// Requirements, checked by the wrapper before it chooses this body: bf16,
// d 256, 16-byte-aligned q, k, v, o and dout, and k/v strides that are
// multiples of 8 elements.
#include "mma.cuh"
#include "sm90.cuh"

namespace repro {
namespace fa_bwd_tma {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int D = 256;
constexpr int NBOX = D / 64;                // 64-column TMA boxes a row
constexpr int ROWS = 64;                    // key rows of a dK/dV block, query rows of its steps
constexpr int BOX = ROWS * 128;             // one 64 x 64 bf16 box: 8 KB
constexpr int TILE = NBOX * BOX;            // 64 rows of 256: 32 KB
constexpr int STAGES = 2;
constexpr int THREADS = 256;
constexpr int ALIGN = 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LSE_MASKED = 1e30f;         // log-sum-exp of a row with no visible key

// Shared memory of the two launches, from the 1 KB-aligned base; mirrored by
// flash_attention_bwd.bwd_smem_bytes() at d 256 in bf16.
struct DqLayout {
  static constexpr int BQ = 128, BKV = 32;              // query rows of a block, keys a tile
  static constexpr int QBOX = BQ * 128;                 // 128 rows of one 64-column box: 16 KB
  static constexpr int KBOX = BKV * 128;                // 32 rows of one box: 4 KB
  static constexpr int Q = 0, DO = NBOX * QBOX;         // 64 KB each
  static constexpr int RING = 2 * NBOX * QBOX;          // stage s: K, then V
  static constexpr int STAGE = 2 * NBOX * KBOX;         // 32 KB
  static constexpr int BARS = RING + STAGES * STAGE;    // qd_full, full[2], empty[2]
  static constexpr int SMEM = ALIGN + BARS + 8 * (1 + 2 * STAGES);
};
struct DkvLayout {
  static constexpr int K = 0, V = TILE;
  static constexpr int RING = 2 * TILE;                 // stage s: Q, then dO
  static constexpr int P = RING + STAGES * 2 * TILE;    // two P^T tiles
  static constexpr int DS = P + 2 * BOX;                // two dS^T tiles
  static constexpr int BARS = DS + 2 * BOX;             // kv_full, full[2], empty[2]
  static constexpr int SMEM = ALIGN + BARS + 8 * (1 + 2 * STAGES);
};
static_assert(DkvLayout::SMEM <= 232448, "the dK/dV block must fit");

// The swizzled address of the bf16 pair at (row r, column 8 chunk + 2 tq) of a
// 64-column box whose rows are 128 bytes.
__device__ __forceinline__ uint32_t swz(uint32_t box, int r, int chunk, int tq) {
  return box + r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * tq;
}

__device__ __forceinline__ void st_pair(uint32_t at, float x, float y) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(x, y)) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dq,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, int Sq, int Skv, int H, int q_per_kv,
                        float sm_scale, int causal, int q_off) {
  using L = DqLayout;
  constexpr int BQ = L::BQ, BKV = L::BKV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t qd_full = base + L::BARS;
  auto full = [&](int s) { return base + L::BARS + 8u * (1 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8u * (1 + STAGES + s); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest causal tiles first
  int kv_end = Skv;
  if (causal && q_off + q0 + BQ < kv_end) kv_end = q_off + q0 + BQ;   // above the diagonal
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads: Q and dO once, then the key tiles twice (two passes, see
  // below), step u's tile (u mod n_tiles) into stage u % STAGES, by a thread
  // of warpgroup 1, whose rows see every key tile of the block
  const bool loader = threadIdx.x == 128;
  const int kv_b = bh / H;
  const int kv_h = (bh % H) / q_per_kv;
  auto load_kv = [&](int u) {
    const int s = u % STAGES;
    const int t = u < n_tiles ? u : u - n_tiles;
    const uint32_t kt = base + L::RING + s * L::STAGE;
    mbar_expect_tx(full(s), L::STAGE);
#pragma unroll
    for (int j = 0; j < NBOX; ++j) {
      tma_load_4d(kt + j * L::KBOX, &map_k, full(s), 64 * j, t * BKV, kv_h, kv_b);
      tma_load_4d(kt + NBOX * L::KBOX + j * L::KBOX, &map_v, full(s), 64 * j, t * BKV, kv_h,
                  kv_b);
    }
  };
  if (loader) {
    mbar_expect_tx(qd_full, 2 * NBOX * L::QBOX);
#pragma unroll
    for (int j = 0; j < NBOX; ++j) {
      tma_load_3d(base + L::Q + j * L::QBOX, &map_q, qd_full, 64 * j, q0, bh);
      tma_load_3d(base + L::DO + j * L::QBOX, &map_do, qd_full, 64 * j, q0, bh);
    }
    for (int u = 0; u < STAGES && u < 2 * n_tiles; ++u) load_kv(u);
  }

  {
    // ---- warpgroup `wg`: query rows [q0 + 64 wg, q0 + 64 wg + 64), all 256 of ------
    // dQ's columns
    constexpr unsigned FULL = 0xffffffffu;
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32;
    const int lane = t128 % 32;
    const int g = lane >> 2;
    const int tq = lane & 3;

    const int r0 = q0 + 64 * wg;            // the warpgroup's first row
    const int ra = 64 * wg + warp * 16 + g; // the thread's rows of the block: ra, ra + 8
    float d_a = 0.f, d_b = 0.f;             // their delta, summed by the first pass
    const float l_a = q0 + ra < Sq ? lse[(long long)bh * Sq + q0 + ra] * LOG2E : LSE_MASKED;
    const float l_b = q0 + ra + 8 < Sq ? lse[(long long)bh * Sq + q0 + ra + 8] * LOG2E
                                       : LSE_MASKED;
    const int qp_a = q_off + q0 + ra;       // the rows' positions
    const int qp_b = qp_a + 8;
    const float scale_log2 = sm_scale * LOG2E;
    const uint32_t qa = base + L::Q + wg * 64 * 128;    // the warpgroup's rows of each box
    const uint32_t doa = base + L::DO + wg * 64 * 128;
    // the warpgroup's visible key tiles are a prefix of the block's
    int n_vis = n_tiles;
    if (causal) n_vis = min(n_tiles, (min(Skv, q_off + r0 + 64) + BKV - 1) / BKV);

    float dq[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) dq[i] = 0.f;
    mbar_wait(qd_full, 0);

    // Two passes over the key tiles, step u the tile u mod n_tiles: the first
    // sums delta = rowsum(P dP) from the P recomputed here (flash_attention_bwd.cu
    // says why not rowsum(dO o)), the second forms dS and dQ with it.
    for (int u = 0; u < 2 * n_tiles; ++u) {
      const bool first = u < n_tiles;
      const int t = first ? u : u - n_tiles;
      const int s = u % STAGES;
      const int ph = (u / STAGES) & 1;
      if (u == n_tiles) {                   // the first pass is done: each row's delta
        d_a += __shfl_xor_sync(FULL, d_a, 1);
        d_a += __shfl_xor_sync(FULL, d_a, 2);
        d_b += __shfl_xor_sync(FULL, d_b, 1);
        d_b += __shfl_xor_sync(FULL, d_b, 2);
        if (tq == 0 && q0 + ra < Sq) delta[(long long)bh * Sq + q0 + ra] = d_a;
        if (tq == 0 && q0 + ra + 8 < Sq) delta[(long long)bh * Sq + q0 + ra + 8] = d_b;
      }
      mbar_wait(full(s), ph);
      if (t < n_vis) {
        const int kv0 = t * BKV;
        const uint32_t kt = base + L::RING + s * L::STAGE;
        const uint32_t vt = kt + NBOX * L::KBOX;

        // ---- S = Q K^T and dP = dO V^T: the warpgroup's 64 rows x 32 keys ------------
        float sc[16], dp[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
        fence_operands(sc);
        fence_operands(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<32, 0, 0>::mma(sc, smem_desc(qa + (kk / 4) * L::QBOX + (kk % 4) * 32, 16, 1024),
                               smem_desc(kt + (kk / 4) * L::KBOX + (kk % 4) * 32, 16, 1024));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<32, 0, 0>::mma(dp, smem_desc(doa + (kk / 4) * L::QBOX + (kk % 4) * 32, 16, 1024),
                               smem_desc(vt + (kk / 4) * L::KBOX + (kk % 4) * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(sc);
        fence_operands(dp);

        // ---- P from the log-sum-exp; the first pass sums P dP into delta, the
        // ---- second forms dS = P (dP - delta) in place of S
        const bool need_mask =
            kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > q_off + r0 + warp * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = sc[4 * j + e] * scale_log2;
            bool ok = x > 0.5f * NEG_INF;
            if (need_mask) {
              const int kp = kv0 + 8 * j + 2 * tq + (e & 1);
              const int qp = e < 2 ? qp_a : qp_b;
              ok = ok && kp < Skv && !(causal && qp < kp);
            }
            const float p = ok ? exp2f(x - (e < 2 ? l_a : l_b)) : 0.f;
            if (first)
              (e < 2 ? d_a : d_b) += p * dp[4 * j + e];
            else
              sc[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? d_a : d_b));
          }
        }
        if (!first) {
          // the accumulator's n8 tiles 2 kk and 2 kk + 1 are the k16 step kk of the
          // A fragment
          uint32_t pa[BKV / 16][4];
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk) {
            pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
            pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
            pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
            pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
          }

          // ---- dQ += dS K: dS from registers, K MN-major across its four boxes ----------
          fence_operands(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk)
            WgmmaRS<256, 1>::mma(dq, pa[kk], smem_desc(kt + kk * 16 * 128, L::KBOX, 1024));
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(dq);
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
        }
      }
      mbar_arrive(empty(s));
      if (loader && u + STAGES < 2 * n_tiles) {   // both warpgroups are done with the stage
        mbar_wait(empty(s), ph);
        load_kv(u + STAGES);
      }
    }

    // ---- dQ through the warpgroup's own rows of the Q tile by TMA --------------------
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t bx = qa + (j / 8) * L::QBOX;
      st_pair(swz(bx, warp * 16 + g, j % 8, tq), dq[4 * j] * sm_scale, dq[4 * j + 1] * sm_scale);
      st_pair(swz(bx, warp * 16 + g + 8, j % 8, tq), dq[4 * j + 2] * sm_scale,
              dq[4 * j + 3] * sm_scale);
    }
    fence_async_shared();
    if (wg == 0) named_sync<2, 128>(); else named_sync<3, 128>();
    if (t128 == 0) {
#pragma unroll
      for (int j = 0; j < NBOX; ++j) tma_store_3d(&map_dq, qa + j * L::QBOX, 64 * j, r0, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_dk,
                         const __grid_constant__ CUtensorMap map_dv,
                         const float* __restrict__ lse, const float* __restrict__ delta, int Sq,
                         int Skv, int H, int q_per_kv, float sm_scale, int causal, int q_off) {
  using L = DkvLayout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t kv_full = base + L::BARS;
  auto full = [&](int s) { return base + L::BARS + 8u * (1 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8u * (1 + STAGES + s); };

  const int grp = blockIdx.x;               // batch * kv heads + kv head
  const int Hkv = H / q_per_kv;
  const int b = grp / Hkv;
  const int kvh = grp % Hkv;
  const long long h_first = (long long)b * H + (long long)kvh * q_per_kv;
  const int kv0 = blockIdx.y * ROWS;        // the first key tiles see most queries: launched first
  // earlier rows (positions q_off + row) see none of these keys
  const int q_first = causal && kv0 > q_off ? ((kv0 - q_off) / ROWS) * ROWS : 0;
  const int n_qt = q_first < Sq ? (Sq - q_first + ROWS - 1) / ROWS : 0;
  const int n_steps = q_per_kv * n_qt;      // query tiles of each head of the group in turn
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads (thread 0): K and V once, step i's (Q, dO) into stage i % STAGES
  const bool loader = threadIdx.x == 0;
  auto load_step = [&](int i) {
    const int s = i % STAGES;
    const int bhh = (int)(h_first + i / n_qt);
    const int qs = q_first + (i % n_qt) * ROWS;
    const uint32_t qt = base + L::RING + s * 2 * TILE;
    mbar_expect_tx(full(s), 2 * TILE);
#pragma unroll
    for (int j = 0; j < NBOX; ++j) {
      tma_load_3d(qt + j * BOX, &map_q, full(s), 64 * j, qs, bhh);
      tma_load_3d(qt + TILE + j * BOX, &map_do, full(s), 64 * j, qs, bhh);
    }
  };
  if (loader) {
    mbar_expect_tx(kv_full, 2 * TILE);
#pragma unroll
    for (int j = 0; j < NBOX; ++j) {
      tma_load_4d(base + L::K + j * BOX, &map_k, kv_full, 64 * j, kv0, kvh, b);
      tma_load_4d(base + L::V + j * BOX, &map_v, kv_full, 64 * j, kv0, kvh, b);
    }
    for (int i = 0; i < STAGES && i < n_steps; ++i) load_step(i);
  }

  {
    // ---- warpgroup `wg`: queries [32 wg, 32 wg + 32) of S^T and dP^T, dK's and ----
    // dV's columns [128 wg, 128 wg + 128)
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32;
    const int lane = t128 % 32;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int ra = warp * 16 + g;           // the thread's key rows of the tile: ra, ra + 8
    const int key_a = kv0 + ra;
    const int key_b = key_a + 8;
    const float scale_log2 = sm_scale * LOG2E;
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    // S^T = K Q^T and dP^T = V dO^T of step i over this warpgroup's 32 queries,
    // issued and committed, not waited for; then the log-sum-exp (log2 domain)
    // and delta of the thread's 8 query columns, read while the products run
    float st[16], dpt[16], lq[8], dl[8];
    auto issue_sdp = [&](int i) {
      const uint32_t qt = base + L::RING + (i % STAGES) * 2 * TILE;
#pragma unroll
      for (int e = 0; e < 16; ++e) st[e] = dpt[e] = 0.f;
      mbar_wait(full(i % STAGES), (i / STAGES) & 1);
      fence_operands(st);
      fence_operands(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        Wgmma<32, 0, 0>::mma(st, smem_desc(base + L::K + off, 16, 1024),
                             smem_desc(qt + off + wg * 32 * 128, 16, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        Wgmma<32, 0, 0>::mma(dpt, smem_desc(base + L::V + off, 16, 1024),
                             smem_desc(qt + TILE + off + wg * 32 * 128, 16, 1024));
      }
      wgmma_commit();
      const long long bhh = h_first + i / n_qt;
      const int qc0 = q_first + (i % n_qt) * ROWS + 32 * wg + 2 * tq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qc = qc0 + 8 * j + c;
          const bool in = qc < Sq;
          lq[2 * j + c] = in ? lse[bhh * Sq + qc] * LOG2E : LSE_MASKED;
          dl[2 * j + c] = in ? delta[bhh * Sq + qc] : 0.f;
        }
      }
    };
    // P^T and dS^T = P^T (dP^T - delta) of step i; this warpgroup's half of
    // each into tiles i % 2, then both halves are awaited
    auto write_p_ds = [&](int i) {
      const int qs = q_first + (i % n_qt) * ROWS;
      const int qc0 = qs + 32 * wg + 2 * tq;  // the thread's first query column
      const uint32_t p_t = base + L::P + (i & 1) * BOX;
      const uint32_t ds_t = base + L::DS + (i & 1) * BOX;
      const bool need_mask = qs + ROWS > Sq || kv0 + warp * 16 + 16 > Skv ||
                             (causal && q_off + qs + 32 * wg < kv0 + warp * 16 + 15);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = st[4 * j + e] * scale_log2;
          bool ok = x > 0.5f * NEG_INF;
          if (need_mask) {
            const int qc = qc0 + 8 * j + (e & 1);
            const int key = e < 2 ? key_a : key_b;
            ok = ok && qc < Sq && key < Skv && !(causal && q_off + qc < key);
          }
          p[e] = ok ? exp2f(x - lq[2 * j + (e & 1)]) : 0.f;
          ds[e] = p[e] * (dpt[4 * j + e] - dl[2 * j + (e & 1)]);
        }
        st_pair(swz(p_t, ra, 4 * wg + j, tq), p[0], p[1]);
        st_pair(swz(p_t, ra + 8, 4 * wg + j, tq), p[2], p[3]);
        st_pair(swz(ds_t, ra, 4 * wg + j, tq), ds[0], ds[1]);
        st_pair(swz(ds_t, ra + 8, 4 * wg + j, tq), ds[2], ds[3]);
      }
      fence_async_shared();
      named_sync<1, THREADS>();
    };

    // P^T and dS^T tiles i % 2 were last read by step i - 2's products, which
    // the other warpgroup finished before it wrote its half of step i - 1's.
    // (Issuing S^T and dP^T of the next step ahead of this step's products
    // left each step's loads no time to land with two stages.)
    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % STAGES;
      issue_sdp(i);
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);
      write_p_ds(i);
      // ---- dV += P^T dO and dK += dS^T Q over this warpgroup's 128 columns ----------
      const uint32_t qt = base + L::RING + s * 2 * TILE;
      const uint32_t p_t = base + L::P + (i & 1) * BOX;
      const uint32_t ds_t = base + L::DS + (i & 1) * BOX;
      fence_operands(dv);
      fence_operands(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
        Wgmma<128, 0, 1>::mma(dv, smem_desc(p_t + kk * 32, 16, 1024),
                              smem_desc(qt + TILE + 2 * wg * BOX + kk * 16 * 128, BOX, 1024));
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
        Wgmma<128, 0, 1>::mma(dk, smem_desc(ds_t + kk * 32, 16, 1024),
                              smem_desc(qt + 2 * wg * BOX + kk * 16 * 128, BOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv);
      fence_operands(dk);
      mbar_arrive(empty(s));
      if (loader && i + STAGES < n_steps) {  // both warpgroups are done with the stage
        mbar_wait(empty(s), (i / STAGES) & 1);
        load_step(i + STAGES);
      }
    }

    // ---- dK and dV through the K and V tiles (read by both warpgroups) by TMA -------
    named_sync<1, THREADS>();
    const uint32_t out_k = base + L::K + 2 * wg * BOX;
    const uint32_t out_v = base + L::V + 2 * wg * BOX;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t bk = out_k + (j / 8) * BOX;
      const uint32_t bv = out_v + (j / 8) * BOX;
      st_pair(swz(bk, ra, j % 8, tq), dk[4 * j] * sm_scale, dk[4 * j + 1] * sm_scale);
      st_pair(swz(bk, ra + 8, j % 8, tq), dk[4 * j + 2] * sm_scale, dk[4 * j + 3] * sm_scale);
      st_pair(swz(bv, ra, j % 8, tq), dv[4 * j], dv[4 * j + 1]);
      st_pair(swz(bv, ra + 8, j % 8, tq), dv[4 * j + 2], dv[4 * j + 3]);
    }
    fence_async_shared();
    if (wg == 0) named_sync<2, 128>(); else named_sync<3, 128>();
    if (t128 == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        tma_store_3d(&map_dk, out_k + x * BOX, 128 * wg + 64 * x, kv0, grp);
        tma_store_3d(&map_dv, out_v + x * BOX, 128 * wg + 64 * x, kv0, grp);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int Sq,
               int Skv, int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st,
               long long v_sb, long long v_sh, long long v_st, float sm_scale, int causal,
               int q_off, cudaStream_t s) {
  const int nq = (Sq + DqLayout::BQ - 1) / DqLayout::BQ;
  const int nkv = (Skv + ROWS - 1) / ROWS;
  if (nq > 65535 || nkv > 65535 || H % q_per_kv || BH % H) return -1;
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DqLayout::SMEM);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkv_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DkvLayout::SMEM);
  if (attr_q != cudaSuccess) return (int)attr_q;
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  const int B = BH / H;
  const int Hkv = H / q_per_kv;
  // the dQ launch reads Q and dO in 128-row boxes and K and V in 32-row boxes,
  // the dK/dV launch all four in 64-row boxes
  CUtensorMap mq128, mdo128, mk32, mv32, mq, mk, mv, mdo, mdq, mdk, mdv;
  if (!encode_3d(&mq128, q, D, Sq, BH, 64, DqLayout::BQ) ||
      !encode_3d(&mdo128, dout, D, Sq, BH, 64, DqLayout::BQ) ||
      !encode_4d(&mk32, k, D, Skv, Hkv, B, k_st, k_sh, k_sb, 64, DqLayout::BKV) ||
      !encode_4d(&mv32, v, D, Skv, Hkv, B, v_st, v_sh, v_sb, 64, DqLayout::BKV) ||
      !encode_3d(&mq, q, D, Sq, BH, 64, ROWS) || !encode_3d(&mdo, dout, D, Sq, BH, 64, ROWS) ||
      !encode_4d(&mk, k, D, Skv, Hkv, B, k_st, k_sh, k_sb, 64, ROWS) ||
      !encode_4d(&mv, v, D, Skv, Hkv, B, v_st, v_sh, v_sb, 64, ROWS) ||
      !encode_3d(&mdq, dq, D, Sq, BH, 64, 64) ||
      !encode_3d(&mdk, dk, D, Skv, (long long)B * Hkv, 64, ROWS) ||
      !encode_3d(&mdv, dv, D, Skv, (long long)B * Hkv, 64, ROWS))
    return -3;
  flash_bwd_dq_tma_kernel<<<dim3(BH, nq), THREADS, DqLayout::SMEM, s>>>(
      mq128, mk32, mv32, mdo128, mdq, lse, delta, Sq, Skv, H, q_per_kv, sm_scale, causal, q_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_tma_kernel<<<dim3(B * Hkv, nkv), THREADS, DkvLayout::SMEM, s>>>(
      mq, mk, mv, mdo, mdk, mdv, lse, delta, Sq, Skv, H, q_per_kv, sm_scale, causal, q_off);
  return (int)cudaGetLastError();
}

}  // namespace fa_bwd_tma
}  // namespace repro

// q, o, dout (BH, Sq, 256) contiguous, k/v strided (batch, kv head, key, 256)
// views, lse (BH, Sq) float32, delta (BH, Sq) float32 scratch, dq as q, dk/dv
// (batch * kv heads, Skv, 256) contiguous.  Two launches: dQ (and delta), then
// dK/dV.  Returns a cudaError_t, -1 for a shape the grid cannot hold, -3 when a
// tensor map cannot be encoded.
extern "C" int repro_flash_attention_bwd_tma(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int Sq, int Skv, int H,
    int q_per_kv, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, float sm_scale, int causal, int q_off, void* stream) {
  return repro::fa_bwd_tma::launch_bwd(
      q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
      BH, Sq, Skv, H, q_per_kv, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale, causal, q_off,
      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block: kernel 0 the dQ launch, 1 the dK/dV
// launch.  Mirrored by flash_attention_bwd.bwd_smem_bytes().
extern "C" int repro_flash_bwd_tma_smem_bytes(int kernel) {
  using namespace repro::fa_bwd_tma;
  return kernel == 0 ? DqLayout::SMEM : DkvLayout::SMEM;
}

// Blocks of the dQ (kernel 0) or dK/dV (1) launch the device holds an SM at
// once, as the runtime computes it; -1 on a runtime error.
extern "C" int repro_flash_bwd_tma_occupancy(int kernel) {
  using namespace repro::fa_bwd_tma;
  return kernel == 0 ? occupancy(flash_bwd_dq_tma_kernel, THREADS, DqLayout::SMEM)
                     : occupancy(flash_bwd_dkv_tma_kernel, THREADS, DkvLayout::SMEM);
}
