// The Hopper GEMM core (sm_90a) behind K1 (gemm) and K4 (grouped_matmul) in
// bf16: C = A @ B with A (M, K) and B (K, N) row-major, or either stored
// transposed (A_T, B_T), float32 accumulate, output in float32 or bf16;
// GROUPED runs one such product per expert.
//
// Replaces, with gemm.cuh's body for float32 and unaligned operands, the TPU
// kernels `_gemm_kernel` / `gemm` (src/repro/kernels/gemm.py) and
// `_gmm_kernel` / `grouped_matmul` (src/repro/kernels/moe_gmm.py).  On the
// TPU the contraction is the innermost sequential grid axis with a float32
// accumulator in VMEM; here one thread block owns a (BM, BN) output tile and
// runs the whole K loop, its accumulator in registers.
//
// What bounds it on an H100: K1 at the serving projection (2048 x 2048 @
// 2048 x 11008) does ~940 FLOP a byte, far above the card's ~295, so the
// tensor cores are the limit and only `wgmma` reaches their full rate.  K4
// streams all 128 experts' weights on every launch, 8 FLOP a byte at the
// decode capacity of 8 and 124 at the prefill capacity of 160: bytes bound,
// so the weights must cross HBM once per launch with enough bytes in
// flight on every SM to cover the memory's latency.  The design:
//
// * One producer (on the deep ring a warpgroup, the last, that drops to 40
//   registers with `setmaxnreg` for the two consumer warpgroups of BM 128 to
//   take up; on the short-K ring one warp); one thread of it keeps a ring of
//   shared-memory stages filled by TMA (`cp.async.bulk.tensor`), each stage
//   BM rows of A and BN columns of B over 64 of K, with one `full` and one
//   `empty` mbarrier per stage.  The producer announces the stage's full box
//   bytes (`arrive.expect_tx`); TMA zero-fills whatever a
//   box reaches past the tensor and still counts those bytes, so ragged M,
//   N and K need no code of their own.
// * One consumer warpgroup per 64 output rows (BM 64 or 128) keeps its
//   64 x BN float32 accumulator in registers and issues four
//   `wgmma.m64nBNk16` per stage straight from shared memory; after
//   `wgmma.wait_group 1` it releases the stage before the current one.
// * The ring.  A product with more k-steps than the short-K ring holds runs
//   the deep ring: STAGES is the deepest that fits 227 KB of dynamic shared
//   memory, 4 to 14 stages of 16-48 KB, so every SM keeps 100-200 KB of loads
//   in flight (one block an SM).  A product with few k-steps (the backward's
//   dW_e = X_e^T dY_e has K = cap, 160 at the MoE's prefill: three k-steps)
//   gains nothing from depth and pays, block after block, for its ramp and
//   its epilogue.  It runs the short-K ring instead (MINB 2): one stage per
//   k-step, so the producer starts the loads of the whole K at once, and
//   `__launch_bounds__(THREADS, 2)` with a one-warp producer (no register
//   moves; a cap of 112 registers for 288 threads, 200 for 160, of which
//   ptxas takes 58-154) lets two blocks share an SM, so that one block's epilogue overlaps the other's loads and
//   products.  (128, 256) has no short-K ring: its 128 accumulators a thread
//   do not fit.
// * Layouts.  A is K-major by default: its 128-byte rows (64 bf16 of K) land
//   in the 128-byte swizzle and a k16 step moves the descriptor 32 bytes
//   along the row.  B is row-major (K, N) by default, so N is contiguous:
//   MN-major.  Each B box is 64 K-rows of 128 bytes of N; `wgmma` reads it
//   with the transpose-B immediate set, its leading byte offset the 8 KB
//   from one 64-column box to the next and its stride byte offset the 1 KB
//   from one 8-row group of K to the next; a k16 step moves 16 rows (2 KB).
//   The backward reads the forward's operands as they are stored, with no
//   transposing copy: A_T takes A stored (K, M) (MN-major, the transpose-A
//   immediate, BM / 64 boxes laid out as B's), B_T takes B stored (N, K)
//   (K-major, laid out and described as A, transpose-B 0).  So K4's dW reads
//   X and dY, its dX reads dY and W, each once; K1's backward is the same
//   pair ungrouped (Z = 1): dA = dC B^T on B_T, dB = A^T dC on A_T.  At
//   qwen2.5-3b's projection the transposing copies they replace moved about
//   106 MB (B is 45 MB, A 8 MB, each read and written), more than the two
//   products' own operands; what is left of K1-bwd is K1's own rate.
// * Tensor maps are 3-D, (inner, rows, Z): Z is the expert for K4 and 1 for
//   K1, so an expert's zero-fill stops at its own capacity.  One block per
//   output tile.  K4's grid puts the row tile in blockIdx.x, so the row
//   tiles of one (expert, column slice) run next to each other: the weights
//   cross HBM once and the other row tiles find them in L2.  K1's
//   one-dimensional grid walks M-tiles in groups of GROUP_M so that a B
//   panel is reused while it is in L2.
// * The epilogue reads rows and columns from the documented accumulator
//   layout (per warp, the m16n8 layout of `mma.sync` repeated over N/8).
//   bf16 goes through shared memory: each warpgroup writes its rows into
//   64 x 64 boxes under the 128-byte swizzle at the start of the drained
//   ring and one thread stores them by TMA (`cp.async.bulk.tensor`), which
//   clips ragged M and N.  Direct stores of bf16 pairs (16 bytes of a row
//   per warp instruction) made a large output cost as much as a float32
//   one: dW at the MoE's prefill writes 403 MB.  float32 goes out as pairs,
//   with masks on ragged M and N.
//
// The mbarrier, TMA, descriptor and `wgmma` helpers are sm90.cuh's, shared
// with K2 and K2-bwd at head dim 256.
//
// Requirements, checked by the wrapper before it chooses this body:
// bf16 operands, K % 8 == 0, N % 8 == 0 (and M % 8 == 0 for A_T) and
// 16-byte-aligned bases (TMA's 16-byte rule for addresses and row strides).
#pragma once

#include "mma.cuh"
#include "sm90.cuh"

namespace repro {
namespace sm90 {

constexpr int BK = 64;                 // one 128-byte swizzle row of bf16
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory one block may use
constexpr int ALIGN = 1024;            // the 128-byte swizzle's atom
constexpr int GROUP_M = 8;             // K1's raster: M-tiles walked per B panel

constexpr int SM_SMEM = 233472;        // shared memory of one SM; 1 KB of it is kept per block
constexpr int BOX_BYTES = 64 * BK * 2; // one 64 x 64 bf16 TMA box

__host__ __device__ constexpr int stage_bytes(int bm, int bn) { return (bm + bn) * BK * 2; }
// The short-K ring (MINB 2) for every tile but (128, 256): its 128 accumulators
// a thread do not fit the registers two 288-thread blocks an SM leave.
__host__ __device__ constexpr bool shallow_ok(int bm, int bn) { return !(bm == 128 && bn == 256); }
// the deepest ring that fits when `minb` blocks share an SM: each stage adds
// its tiles and two mbarriers
__host__ __device__ constexpr int stages(int bm, int bn, int minb = 1) {
  return ((minb == 1 ? SMEM_LIMIT : SM_SMEM / minb - 1024) - ALIGN) / (stage_bytes(bm, bn) + 16);
}
__host__ __device__ constexpr int k_steps(int K) { return (K + BK - 1) / BK; }
// Whether a product of depth K runs the short-K ring: as many stages as it
// has k-steps, two blocks an SM.
__host__ __device__ constexpr bool shallow(int bm, int bn, int K) {
  return K > 0 && shallow_ok(bm, bn) && k_steps(K) <= stages(bm, bn, 2);
}
// Dynamic shared memory of one block for a product of depth K (K <= 0: the
// deep ring, the most any K takes); mirrored by gemm_smem_bytes() in
// kernels/gemm.py, which the planner prunes with.
__host__ __device__ constexpr int smem_bytes(int bm, int bn, int K = 0) {
  return ALIGN + (shallow(bm, bn, K) ? k_steps(K) : stages(bm, bn)) * (stage_bytes(bm, bn) + 16);
}

template <int BM, int BN, int MINB>
struct Cfg {
  static constexpr int CONSUMERS = BM / 64;
  // MINB 1, the deep ring: one block an SM (the ring takes its shared
  // memory) and a producer warpgroup.  With 384 threads every thread starts
  // at 168 registers; the producer gives back down to 40 and the two
  // consumer warpgroups take them, 232 each.  With 256 threads every thread
  // may already hold 255, so the one consumer keeps its count.
  // MINB 2, the short-K ring: two blocks an SM, and the producer is one warp,
  // so no registers move: 288 threads may hold up to 112, 160 up to 200.
  static constexpr bool SHALLOW = MINB > 1;
  static constexpr int THREADS = 128 * CONSUMERS + (SHALLOW ? 32 : 128);
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int STAGES = stages(BM, BN, MINB);   // the most stages a launch may use
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = stage_bytes(BM, BN);
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is 64, 128 or 256");
  static_assert(STAGES >= (SHALLOW ? 2 : 3), "the ring is too shallow");
  static_assert(!SHALLOW || shallow_ok(BM, BN), "no short-K ring for this tile");
  // the bf16 epilogue stages the output tile in the drained ring: one stage
  // of the short-K ring (a product has at least one k-step), STAGES of the deep
  static_assert((SHALLOW ? 1 : STAGES) * STAGE_BYTES >= BM * BN * 2,
                "the ring must hold the output tile");
};

// Z products C[z] = A[z] @ B[z] (Z = gridDim.z when GROUPED, else 1), A and B
// read through the 3-D tensor maps, C (Z, M, N) written directly; one block
// per (BM, BN) output tile.  A is stored (Z, M, K) or, A_T, (Z, K, M); B is
// stored (Z, K, N) or, B_T, (Z, N, K).  `ring` is the launch's stage count:
// the deep ring's STAGES, or the short-K ring's k-steps.
template <int BM, int BN, bool GROUPED, bool A_T, bool B_T, int MINB>
__global__ void __launch_bounds__(Cfg<BM, BN, MINB>::THREADS, MINB)
gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, void* __restrict__ C, int M, int N,
                int K, int out_bf16, int ring) {
  using Cf = Cfg<BM, BN, MINB>;
  extern __shared__ unsigned char smem_raw[];
  const int n_st = Cf::SHALLOW ? ring : Cf::STAGES;   // a constant on the deep ring
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t bars = base + n_st * Cf::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (n_st + s); };

  int m_tile, n_tile, z;
  if constexpr (GROUPED) {
    m_tile = blockIdx.x;          // row tiles of one (expert, column slice) run together
    n_tile = blockIdx.y;
    z = blockIdx.z;
  } else {
    const int m_tiles = (M + BM - 1) / BM;
    const int n_tiles = (N + BN - 1) / BN;
    const int per_group = GROUP_M * n_tiles;
    const int first_m = (blockIdx.x / per_group) * GROUP_M;
    const int group_m = min(m_tiles - first_m, GROUP_M);
    const int in_group = blockIdx.x % per_group;
    m_tile = first_m + in_group % group_m;
    n_tile = in_group / group_m;
    z = 0;
  }
  const int n_k = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_st; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * Cf::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == Cf::CONSUMERS) {
    // producer: one thread keeps the ring full
    if constexpr (!Cf::SHALLOW)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cf::PRODUCER_REGS));
    if (threadIdx.x == 128 * Cf::CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % n_st;
        if (kt >= n_st) mbar_wait(empty(s), ((kt / n_st) & 1) ^ 1);
        mbar_expect_tx(full(s), Cf::STAGE_BYTES);
        const uint32_t a = base + s * Cf::STAGE_BYTES;
        const uint32_t b = a + Cf::A_BYTES;
        if constexpr (A_T) {          // BM / 64 boxes of (64 K-rows x 64 of M)
#pragma unroll
          for (int j = 0; j < BM / 64; ++j)
            tma_load_3d(a + j * BOX_BYTES, &map_a, full(s), m_tile * BM + 64 * j, kt * BK, z);
        } else {                      // one box of (BM rows x 64 of K)
          tma_load_3d(a, &map_a, full(s), kt * BK, m_tile * BM, z);
        }
        if constexpr (B_T) {          // one box of (BN rows x 64 of K)
          tma_load_3d(b, &map_b, full(s), kt * BK, n_tile * BN, z);
        } else {                      // BN / 64 boxes of (64 K-rows x 64 of N)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(b + j * BOX_BYTES, &map_b, full(s), n_tile * BN + 64 * j, kt * BK, z);
        }
      }
    }
  } else {
    // consumer warpgroup `wg`: output rows [64 wg, 64 wg + 64) of the tile
    if constexpr (!Cf::SHALLOW && Cf::CONSUMERS > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Cf::CONSUMER_REGS));
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % n_st;
      mbar_wait(full(s), (kt / n_st) & 1);
      // 64 rows of A are 8 KB in either layout: a K-major box slice or one MN-major box
      const uint32_t a = base + s * Cf::STAGE_BYTES + wg * BOX_BYTES;
      const uint32_t b = base + s * Cf::STAGE_BYTES + Cf::A_BYTES;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major: a k16 step moves 32 bytes along the 128-byte rows; MN-major:
        // 16 rows of 128 bytes, and the leading offset is the box to box stride
        const uint64_t da = A_T ? smem_desc(a + kk * 16 * 128, BOX_BYTES, 1024)
                                : smem_desc(a + kk * 32, 16, 1024);
        const uint64_t db = B_T ? smem_desc(b + kk * 32, 16, 1024)
                                : smem_desc(b + kk * 16 * 128, BOX_BYTES, 1024);
        Wgmma<BN, A_T ? 1 : 0, B_T ? 0 : 1>::mma(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();             // the products of stage kt - 1 are done
      fence_operands(acc);
      if (kt > 0) mbar_arrive(empty((kt - 1) % n_st));
    }
    wgmma_wait<0>();
    fence_operands(acc);

    const int t = threadIdx.x % 128;
    const int q = t % 4;
    if (out_bf16) {
      // Through shared memory and TMA: once every consumer is done with the
      // ring, each warpgroup writes its 64 x BN bf16 rows into BN / 64 boxes
      // of 64 x 64 at the start of the ring (128-byte swizzle: the 16-byte
      // chunk index XOR the row, so a warp's pairs fall in 32 banks), and one
      // thread stores the boxes with `cp.async.bulk.tensor`, which clips
      // ragged rows and columns.  The ring's first stage(s) always hold them.
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * Cf::CONSUMERS) : "memory");
      const uint32_t tile = base + wg * (BN / 64) * BOX_BYTES;
      const int r0 = (t / 32) * 16 + (t % 32) / 4;   // the thread's first row of 64
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const uint32_t at = tile + (j / 8) * BOX_BYTES + r * 128 +
                              ((((j % 8) ^ (r & 7))) << 4) + 4 * q;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                       "r"(pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      if (t == 0) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_store_3d(&map_c, tile + b * BOX_BYTES, n_tile * BN + 64 * b,
                       m_tile * BM + wg * 64, z);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");   // before smem goes
      }
    } else {
      const int row = m_tile * BM + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
      const int col = n_tile * BN + 2 * q;
      float* c = static_cast<float*>(C);
      if constexpr (GROUPED) c += static_cast<long long>(z) * M * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cj = col + 8 * j;
        if (cj >= N) continue;       // N % 8 == 0, so cj + 1 < N as well
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r < M)
            *reinterpret_cast<float2*>(c + static_cast<long long>(r) * N + cj) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- host
template <int BM, int BN, bool GROUPED, bool A_T, bool B_T, int MINB>
int launch_tma_ring(const void* a, const void* b, void* c, int Z, int M, int N, int K,
                    int out_bf16, int ring, cudaStream_t stream) {
  using Cf = Cfg<BM, BN, MINB>;
  auto kern = gemm_tma_kernel<BM, BN, GROUPED, A_T, B_T, MINB>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ALIGN + Cf::STAGES * (Cf::STAGE_BYTES + 16));
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map_a, map_b;
  const bool ok_a = A_T ? encode_3d(&map_a, a, M, K, Z, 64, BK)
                        : encode_3d(&map_a, a, K, M, Z, BK, BM);
  const bool ok_b = B_T ? encode_3d(&map_b, b, K, N, Z, BK, BN)
                        : encode_3d(&map_b, b, N, K, Z, 64, BK);
  CUtensorMap map_c = {};         // bf16 output: (Z, M, N) in boxes of 64 x 64
  if (!ok_a || !ok_b || (out_bf16 && !encode_3d(&map_c, c, N, M, Z, 64, 64))) return -3;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const dim3 grid = GROUPED ? dim3(m_tiles, n_tiles, Z) : dim3(m_tiles * n_tiles);
  const int smem = ALIGN + ring * (Cf::STAGE_BYTES + 16);
  kern<<<grid, Cf::THREADS, smem, stream>>>(map_a, map_b, map_c, c, M, N, K, out_bf16, ring);
  return (int)cudaGetLastError();
}

// A product whose k-steps fit the short-K ring takes it (two blocks an SM,
// one stage a k-step); any other the deep ring.
template <int BM, int BN, bool GROUPED, bool A_T, bool B_T>
int launch_tma_tile(const void* a, const void* b, void* c, int Z, int M, int N, int K,
                    int out_bf16, cudaStream_t stream) {
  if constexpr (shallow_ok(BM, BN)) {
    if (shallow(BM, BN, K))
      return launch_tma_ring<BM, BN, GROUPED, A_T, B_T, 2>(a, b, c, Z, M, N, K, out_bf16,
                                                           k_steps(K), stream);
  }
  return launch_tma_ring<BM, BN, GROUPED, A_T, B_T, 1>(a, b, c, Z, M, N, K, out_bf16,
                                                       stages(BM, BN), stream);
}

// Dispatch over the compiled tiles {64, 128} x {64, 128, 256} (BK 64) of one
// operand layout.  Returns a cudaError_t, -1 for a tile that is not
// compiled, -3 when a tensor map cannot be encoded.
template <bool GROUPED, bool A_T, bool B_T>
int launch_gemm_tma(const void* a, const void* b, void* c, int Z, int M, int N, int K,
                    int out_bf16, int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TMA_CASE(BM_, BN_)                                                          \
  if (bm == BM_ && bn == BN_)                                                             \
    return launch_tma_tile<BM_, BN_, GROUPED, A_T, B_T>(a, b, c, Z, M, N, K, out_bf16, s);
  REPRO_TMA_CASE(64, 64)
  REPRO_TMA_CASE(64, 128)
  REPRO_TMA_CASE(64, 256)
  REPRO_TMA_CASE(128, 64)
  REPRO_TMA_CASE(128, 128)
  REPRO_TMA_CASE(128, 256)
#undef REPRO_TMA_CASE
  return -1;
}

// The grouped product with A stored (Z, K, M) (grouped_gemm_at_bf16.cu: dW = X^T dY
// reads X as stored) and with B stored (Z, N, K) (grouped_gemm_bt_bf16.cu: dX = dY W^T
// reads W as stored); each in its own file, so that nvcc builds them in parallel.
int grouped_gemm_tma_a_t(const void* a, const void* b, void* c, int Z, int M, int N, int K,
                         int out_bf16, int bm, int bn, void* stream);
int grouped_gemm_tma_b_t(const void* a, const void* b, void* c, int Z, int M, int N, int K,
                         int out_bf16, int bm, int bn, void* stream);
// K1's product with A stored (K, M) (gemm_at_bf16.cu: dB = A^T dC reads A as
// stored) and with B stored (N, K) (gemm_bt_bf16.cu: dA = dC B^T reads B as stored).
int gemm_tma_a_t(const void* a, const void* b, void* c, int M, int N, int K, int out_bf16,
                 int bm, int bn, void* stream);
int gemm_tma_b_t(const void* a, const void* b, void* c, int M, int N, int K, int out_bf16,
                 int bm, int bn, void* stream);

}  // namespace sm90
}  // namespace repro
