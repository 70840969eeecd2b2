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
// as +1e30) has zero gradient.  `q_off` is the position of query row 0, as
// in the forward (context-parallel attention: a rank's query block against
// the sequence's prefix): it moves the dQ blocks' diagonal tile bound, warp
// skip and mask, and the dK/dV blocks' first query tile (a key tile no
// query of the block can see reads no query tile and writes zeros).
//
// With P = exp(sm_scale * q k^T - lse) (masked entries 0), dP = dO v^T,
// delta = rowsum(P dP) and dS = P (dP - delta):
//   dV = P^T dO,  dK = sm_scale dS^T q,  dQ = sm_scale dS k.
// delta is rowsum(dO o) for the exact o.  The float32 body takes it so from
// its float32 o; the bf16 body sums P dP from the P it recomputes, by a
// first pass over the key tiles.  From the bf16 o it would be off by
// dO . (o - o_exact), o's rounding and that of the forward's bf16 P V
// product, and every key of a row would take that shift in dS: the rows of
// dS would no longer sum to 0.  Where a pass's keys are nearly alike that
// outweighs the whole query and key gradient: seamless-m4t-medium's cross
// attention over its 12-layer encoder's memory, at its first step, put the
// kernel path's cross_attn/wq and wk gradients 150 x as far from float32 as
// the plain path's (H100 80GB HBM3, 700 W).
// Two launches, no float atomics, so the result repeats bit for bit.
// K and V come as strided (batch, kv head, key) views, as in the forward;
// dK and dV are written contiguous as (batch * kv heads, Skv, d).
//
// What bounds it on an H100: at qwen2.5-3b's training shape (64 query heads
// on 8 kv heads, 512 x 512 causal, d 128, bf16) the five S^2 d products
// over the visible half are about 10.7 GFLOP (0.011 ms of tensor-core time)
// and the inputs and outputs about 37 MB (0.011 ms).  Two kernels that do
// not share their S and dP recompute seven products, not five (nine with
// the dQ launch's first pass, which sums delta), and at 4096
// FLOP an `mma.sync` with 16-row warp tiles rereads each B operand from
// shared memory for every warp; at this size the design aims first at
// keeping all 132 SMs busy to the end without atomics.
//
// bf16 design (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel):
//  * every product is `mma.sync.m16n8k16` (bf16 in, float32 accumulate) with
//    K2's fragment helpers (mma.cuh).  Tiles stay bf16 in shared memory, rows
//    padded by 16 bytes for conflict-free `ldmatrix`.  P is recomputed from
//    the float32 log-sum-exp with exp2 and sm_scale * log2 e folded in, as the
//    forward does.  P and dS become the A operand of the next product in
//    registers, without touching shared memory, each as two bf16 parts (the
//    pair and the pair of what it leaves out), one `mma` each: about 16
//    significant bits.  Rounded to one bf16, dS put dQ 3.3e-3 relative RMS
//    from the float32 formula at qwen2.5-3b's first training step, near the
//    2^-8 that the train phase allows; split, P and dS cost 8 % more time.
//  * dQ (also writes delta): one 4-warp block per (query head, 64-row query
//    tile), heaviest causal tiles first; each warp owns 16 query rows, keeps
//    S, dP and its dQ rows in registers and reads K/V tiles that `cp.async`
//    brings in two stages.  It walks its key tiles twice: S and dP once
//    more in a first pass that sums delta = rowsum(P dP) (see above), two
//    more products a tile.
//  * dK/dV: one 4-warp block per (query head, 64-key tile), each warp 16
//    keys.  It computes S^T = K Q^T and dP^T = V dO^T directly, so P^T and
//    dS^T land in the accumulator layout that the A operand of P^T dO and
//    dS^T Q needs (the FlashAttention-2 arrangement); Q, dO and their
//    rows' lse and delta come by `cp.async` in two stages.  The query heads
//    of one kv head's group form a thread-block cluster (at most 8 blocks,
//    the portable size: G 8 at qwen2.5-3b and the MoE, 7 at internvl2, 1 at
//    zamba2; a larger group gives each block G / cluster heads in turn).
//    After its loop each block leaves its float32 dK/dV partial in shared
//    memory, and block r of the cluster folds its share of the key rows
//    through distributed shared memory in rank order, as K3's splits fold
//    (flash_decode.cu).  So the grid is BH x key tiles (512 blocks of 105 KB
//    at the training shape, two an SM), the heaviest key tiles (the first
//    under a causal mask) launch first, and no block sums a whole group.
//  * where a pointer or stride is not 16-byte aligned, the same stages are
//    filled with scalar loads (`vec_ok == 0`), as in the forward.
//
//  * at d 256 a warp cannot hold its output rows: 16 keys x 256 of dK and of
//    dV are 256 float32 registers a thread, 16 query rows of dQ 128 beside
//    S and dP.  So both launches split the output columns over the grid
//    (gridDim.z = 2, BwdCols): a block computes S and dP over the whole d,
//    then accumulates its half of the dQ (or dK/dV) columns.  S and dP are
//    computed once per half, two of the five products twice; the registers
//    a warp holds are those of d 128.  Shared memory (64-row tiles of 256)
//    is about 200 KB a block, so one block an SM.
//
// float32 inputs keep the first design (flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel): true float32 FMAs on the CUDA cores over float32
// tiles in shared memory, one dK/dV block per (batch, kv head, 32-key tile)
// that loops over its group's query heads; at d 256 the dQ block takes 32
// query rows, not 64, so that its tiles fit.  Nothing trained runs it.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace fa_bwd {

namespace cg = cooperative_groups;

// ----------------------------------------------------------------- float32
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
  static constexpr int BQ = D > 128 ? 32 : 64, BKV = 64, LD = D + 1, LDS = BKV + 1;
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
                    long long v_st, float sm_scale, int causal, int q_off) {
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
  if (causal && q_off + q0 + BQ < kv_end) kv_end = q_off + q0 + BQ;   // tiles above the diagonal
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
        const bool ok = qp < Sq && kp < Skv && (!causal || q_off + qp >= kp);
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
                     float sm_scale, int causal, int q_off) {
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
  // earlier rows (positions q_off + row) see none of these keys
  const int q_first = causal && kv0 > q_off ? ((kv0 - q_off) / BQ) * BQ : 0;

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
          const bool ok = qp < Sq && kp < Skv && (!causal || q_off + qp >= kp);
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
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int Sq,
               int Skv, int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st,
               long long v_sb, long long v_sh, long long v_st, float sm_scale, int causal,
               int q_off, cudaStream_t s) {
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
                                          k_sh, k_st, v_sb, v_sh, v_st, sm_scale, causal,
                                          q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(BH / q_per_kv, nkv), NT, LKV::BYTES, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H,
      q_per_kv, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale, causal, q_off);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------------- bf16
constexpr int MMA_WARPS = 4;
constexpr int MMA_NT = 32 * MMA_WARPS;     // threads of a bf16 block
constexpr int MMA_BQ = 64;                 // query rows: a dQ block, a dK/dV stage
constexpr int MMA_BKV = 64;                // key rows: a dK/dV block, a dQ stage
constexpr int MAX_CLUSTER = 8;             // the portable cluster size
constexpr float LOG2E = 1.4426950408889634f;

// Output columns one bf16 block accumulates: all of d up to 128, half of it
// at d 256 (gridDim.z picks the half).
template <int D>
struct BwdCols {
  static constexpr int N = D > 128 ? 128 : D;
  static constexpr int SPLITS = D / N;
};

// The dK/dV cluster: the largest divisor of the group that is at most 8.
__host__ __device__ constexpr int cluster_size(int q_per_kv) {
  int c = q_per_kv < MAX_CLUSTER ? q_per_kv : MAX_CLUSTER;
  while (c > 1 && q_per_kv % c) --c;
  return c < 1 ? 1 : c;
}

// dQ block: the Q and dO tiles and two stages of K and V, bf16 rows padded
// by 16 bytes.  Mirrored by flash_attention_bwd.bwd_smem_bytes().
template <int D>
struct MmaDqLayout {
  static constexpr int LD = D + 8;
  static constexpr int TILE = 64 * LD * 2;           // bytes of one 64-row tile
  static constexpr int BYTES = 2 * TILE + 2 * 2 * TILE;
};

// dK/dV block: the K and V tiles, then two stages of (Q, dO, lse, delta).
// After the loop the stages hold the block's float32 dK and dV partials.
template <int D>
struct MmaDkvLayout {
  static constexpr int LD = D + 8;
  static constexpr int TILE = 64 * LD * 2;
  static constexpr int KV_BYTES = 2 * TILE;
  static constexpr int STAGE_BYTES = 2 * TILE + 2 * MMA_BQ * 4;
  static constexpr int BYTES = KV_BYTES + 2 * STAGE_BYTES;
  static constexpr int LDP = BwdCols<D>::N + 4;      // float row of a partial (its columns)
  static constexpr int FOLD_BYTES = 2 * MMA_BKV * LDP * 4;
  static_assert(FOLD_BYTES <= 2 * STAGE_BYTES, "the partials reuse the stages");
};

static_assert(MMA_NT == 2 * MMA_BQ, "a dK/dV stage's lse and delta: one thread a row");

// 4 bytes by `cp.async` (zero-filled when !ok)
__device__ __forceinline__ void cp_async4(float* s, const float* g, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(s)), "l"(g),
               "r"(ok ? 4 : 0)
               : "memory");
}

// The bf16 pair of (x, y) as an mma A register, and the pair of what it
// leaves out: hi + lo carries x and y to about 16 significant bits.
__device__ __forceinline__ void split_pack(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// The A registers of a k16 step from two n8 accumulator tiles: high parts
// and low parts, each an mma of its own.
__device__ __forceinline__ void a_from_acc(const float (&c0)[4], const float (&c1)[4],
                                           unsigned (&hi)[4], unsigned (&lo)[4]) {
  split_pack(c0[0], c0[1], hi[0], lo[0]);
  split_pack(c0[2], c0[3], hi[1], lo[1]);
  split_pack(c1[0], c1[1], hi[2], lo[2]);
  split_pack(c1[2], c1[3], hi[3], lo[3]);
}

template <int D>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                        int Skv, int H, int q_per_kv, long long k_sb, long long k_sh,
                        long long k_st, long long v_sb, long long v_sh, long long v_st,
                        float sm_scale, int causal, int q_off, int vec_ok) {
  using bf16 = __nv_bfloat16;
  using L = MmaDqLayout<D>;
  constexpr int LD = L::LD, BQ = MMA_BQ, BKV = MMA_BKV;
  constexpr int NS = BKV / 8;               // n8 tiles of S and dP
  constexpr int NO = BwdCols<D>::N / 8;     // n8 tiles of this block's dQ columns
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;                 // [stage][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;                  // accumulator rows g and g + 8
  const int tq = lane & 3;                  // accumulator columns 2 tq, 2 tq + 1
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest causal tiles first
  const int c0 = blockIdx.z * BwdCols<D>::N;          // this block's first dQ column
  const long long row_off = (long long)bh * Sq * D;
  const long long kv_b = bh / H;
  const long long kv_h = (bh % H) / q_per_kv;
  const bf16* kb = k + kv_b * k_sb + kv_h * k_sh;
  const bf16* vb = v + kv_b * v_sb + kv_h * v_sh;
  int kv_end = Skv;
  if (causal && q_off + q0 + BQ < kv_end) kv_end = q_off + q0 + BQ;   // tiles above the diagonal
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  flash_copy<BQ, D, LD, MMA_NT>(Qs, q + row_off, q0, Sq, D, vec_ok, tid);
  flash_copy<BQ, D, LD, MMA_NT>(dOs, dout + row_off, q0, Sq, D, vec_ok, tid);
  flash_copy<BKV, D, LD, MMA_NT>(Ks, kb, 0, Skv, k_st, vec_ok, tid);
  flash_copy<BKV, D, LD, MMA_NT>(Vs, vb, 0, Skv, v_st, vec_ok, tid);
  cp_async_commit();

  // the thread's two rows, their delta (summed by the first pass) and
  // log-sum-exp (log2 domain)
  const int wq0 = q0 + warp * 16;
  const int row_a = wq0 + g;
  const int row_b = row_a + 8;
  float d_a = 0.f, d_b = 0.f;
  const float l_a = row_a < Sq ? lse[(long long)bh * Sq + row_a] * LOG2E : LSE_MASKED;
  const float l_b = row_b < Sq ? lse[(long long)bh * Sq + row_b] * LOG2E : LSE_MASKED;
  const float scale_log2 = sm_scale * LOG2E;

  cp_async_wait<0>();
  __syncthreads();                          // Q, dO and the first K/V tile landed
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* dOw = dOs + warp * 16 * LD;

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  // Two passes over the key tiles, step u the tile u mod n_tiles: the first
  // sums delta = rowsum(P dP), the second forms dS and dQ with it.
  for (int u = 0; u < 2 * n_tiles; ++u) {
    const bool first = u < n_tiles;
    const int t = first ? u : u - n_tiles;
    if (u > 0) {
      cp_async_wait<0>();
      __syncthreads();                      // step u landed; every warp is done with u - 1
    }
    if (u + 1 < 2 * n_tiles) {              // into the stage step u - 1 used
      const int st = (u + 1) & 1;
      const int next = (u + 1 < n_tiles ? u + 1 : u + 1 - n_tiles) * BKV;
      flash_copy<BKV, D, LD, MMA_NT>(Ks + st * BKV * LD, kb, next, Skv, k_st, vec_ok, tid);
      flash_copy<BKV, D, LD, MMA_NT>(Vs + st * BKV * LD, vb, next, Skv, v_st, vec_ok, tid);
    }
    cp_async_commit();
    if (u == n_tiles) {                     // the first pass is done: each row's delta
      d_a += __shfl_xor_sync(FULL, d_a, 1);
      d_a += __shfl_xor_sync(FULL, d_a, 2);
      d_b += __shfl_xor_sync(FULL, d_b, 1);
      d_b += __shfl_xor_sync(FULL, d_b, 2);
      if (tq == 0 && blockIdx.z == 0) {
        if (row_a < Sq) delta[(long long)bh * Sq + row_a] = d_a;
        if (row_b < Sq) delta[(long long)bh * Sq + row_b] = d_b;
      }
    }
    const int kv0 = t * BKV;
    if (causal && kv0 > q_off + wq0 + 15) continue;   // nothing visible to this warp
    const bf16* Kt = Ks + (u & 1) * BKV * LD;
    const bf16* Vt = Vs + (u & 1) * BKV * LD;

    // ---- S = Q K^T and dP = dO V^T: 16 rows x BKV keys per warp ---------------
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4], ao[4];
      const int a_off = (lane & 15) * LD + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(a, smem_addr(Qw + a_off));
      ldmatrix_x4(ao, smem_addr(dOw + a_off));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {    // 16 keys: two n8 tiles
        const int b_off = (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        unsigned b[4];
        ldmatrix_x4(b, smem_addr(Kt + b_off));
        mma_bf16(s[2 * j], a, b[0], b[1]);
        mma_bf16(s[2 * j + 1], a, b[2], b[3]);
        ldmatrix_x4(b, smem_addr(Vt + b_off));
        mma_bf16(dp[2 * j], ao, b[0], b[1]);
        mma_bf16(dp[2 * j + 1], ao, b[2], b[3]);
      }
    }

    // ---- P from the log-sum-exp; the first pass sums P dP into delta, the
    // ---- second forms dS = P (dP - delta) in place of S
    const bool need_mask = kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > q_off + wq0);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e] * scale_log2;
        bool ok = x > 0.5f * NEG_INF;
        if (need_mask) {
          const int kp = kv0 + j * 8 + 2 * tq + (e & 1);
          const int qp = q_off + (e < 2 ? row_a : row_b);
          ok = ok && kp < Skv && !(causal && qp < kp);
        }
        const float p = ok ? exp2f(x - (e < 2 ? l_a : l_b)) : 0.f;
        if (first)
          (e < 2 ? d_a : d_b) += p * dp[j][e];
        else
          s[j][e] = p * (dp[j][e] - (e < 2 ? d_a : d_b));
      }
    }
    if (first) continue;

    // ---- dQ += dS K: dS straight from the registers, high and low parts -----------
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      unsigned a[4], a_lo[4];
      a_from_acc(s[2 * kk], s[2 * kk + 1], a, a_lo);
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {    // 16 columns of d: two n8 tiles
        unsigned b[4];
        ldmatrix_x4_trans(b, smem_addr(Kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       c0 + n * 16 + (lane >> 4) * 8));
        mma_bf16(dqa[2 * n], a, b[0], b[1]);
        mma_bf16(dqa[2 * n + 1], a, b[2], b[3]);
        mma_bf16(dqa[2 * n], a_lo, b[0], b[1]);
        mma_bf16(dqa[2 * n + 1], a_lo, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();                       // no copy outlives the block

  bf16* dqb = dq + row_off;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = c0 + n * 8 + 2 * tq;
    if (row_a < Sq)
      *reinterpret_cast<unsigned*>(dqb + (long long)row_a * D + c) =
          pack_bf16(dqa[n][0] * sm_scale, dqa[n][1] * sm_scale);
    if (row_b < Sq)
      *reinterpret_cast<unsigned*>(dqb + (long long)row_b * D + c) =
          pack_bf16(dqa[n][2] * sm_scale, dqa[n][3] * sm_scale);
  }
}

// One block per (query head, 64-key tile); the blocks of one kv head's
// group and key tile form a cluster along x and fold dK/dV through
// distributed shared memory.  Each block takes `heads` (G / cluster size)
// consecutive query heads of the group in turn.
template <int D>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int q_per_kv,
                         int heads, long long k_sb, long long k_sh, long long k_st,
                         long long v_sb, long long v_sh, long long v_st, float sm_scale,
                         int causal, int q_off, int vec_ok) {
  using bf16 = __nv_bfloat16;
  using L = MmaDkvLayout<D>;
  constexpr int LD = L::LD, BQ = MMA_BQ, BKV = MMA_BKV, LDP = L::LDP;
  constexpr int NS = BQ / 8;                // n8 tiles of S^T and dP^T
  constexpr int NC = BwdCols<D>::N;         // this block's dK and dV columns
  constexpr int NO = NC / 8;                // n8 tiles of them
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * LD;
  auto stage_q = [&](int st) {
    return reinterpret_cast<bf16*>(smem_raw + L::KV_BYTES + st * L::STAGE_BYTES);
  };
  auto stage_f = [&](int st) {              // lse[BQ], then delta[BQ]
    return reinterpret_cast<float*>(smem_raw + L::KV_BYTES + st * L::STAGE_BYTES + 2 * L::TILE);
  };

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int Hkv = H / q_per_kv;
  const int grp = blockIdx.x / n_cl;        // batch * Hkv + kv head
  const int b = grp / Hkv;
  const int kvh = grp % Hkv;
  const long long h_first = (long long)b * H + (long long)kvh * q_per_kv + rank * heads;
  const int kv0 = blockIdx.y * BKV;         // the first key tiles see most queries: launched first
  const int c0 = blockIdx.z * NC;           // this block's first dK/dV column
  const bf16* kb = k + (long long)b * k_sb + (long long)kvh * k_sh;
  const bf16* vb = v + (long long)b * v_sb + (long long)kvh * v_sh;
  // earlier rows (positions q_off + row) see none of these keys; the key
  // tiles still launch in order, each seeing no more queries than the one before
  const int q_first = causal && kv0 > q_off ? ((kv0 - q_off) / BQ) * BQ : 0;
  const int n_qt = q_first < Sq ? (Sq - q_first + BQ - 1) / BQ : 0;
  const int n_steps = heads * n_qt;

  // step i: query tile i % n_qt of head h_first + i / n_qt, into stage i & 1
  auto load_step = [&](int i) {
    const long long bhh = h_first + i / n_qt;
    const int qs = q_first + (i % n_qt) * BQ;
    bf16* Qst = stage_q(i & 1);
    float* Fst = stage_f(i & 1);
    flash_copy<BQ, D, LD, MMA_NT>(Qst, q + bhh * Sq * D, qs, Sq, D, vec_ok, tid);
    flash_copy<BQ, D, LD, MMA_NT>(Qst + BQ * LD, dout + bhh * Sq * D, qs, Sq, D, vec_ok, tid);
    const int r = tid % BQ;
    const bool ok = qs + r < Sq;
    const float* src = (tid < BQ ? lse : delta) + bhh * Sq + (ok ? qs + r : 0);
    cp_async4(Fst + (tid < BQ ? 0 : BQ) + r, src, ok);
  };
  flash_copy<BKV, D, LD, MMA_NT>(Ks, kb, kv0, Skv, k_st, vec_ok, tid);
  flash_copy<BKV, D, LD, MMA_NT>(Vs, vb, kv0, Skv, v_st, vec_ok, tid);
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  const float scale_log2 = sm_scale * LOG2E;
  // the warp's keys as query rows (key position - q_off), so that the loop
  // compares rows with rows and keeps no more registers than without an
  // offset; whether each key exists is decided once
  const int kw0 = kv0 + warp * 16 - q_off;  // first key of this warp, as a row
  const int key_a = kw0 + g;                // the thread's two keys, as rows
  const int key_b = key_a + 8;
  const bool edge = kv0 + warp * 16 + 16 > Skv;
  const bool has_a = key_a + q_off < Skv, has_b = key_b + q_off < Skv;
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();                        // step i landed; every warp is done with i - 1
    if (i + 1 < n_steps) load_step(i + 1);  // into the stage step i - 1 used
    cp_async_commit();
    const int q0 = q_first + (i % n_qt) * BQ;
    if (causal && q0 + BQ - 1 < kw0) continue;        // every query precedes the warp's keys
    const bf16* Qt = stage_q(i & 1);
    const bf16* dOt = Qt + BQ * LD;
    const float* Lt = stage_f(i & 1);
    const float* Dt = Lt + BQ;

    // ---- S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp -----------
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4], av[4];
      const int a_off = (lane & 15) * LD + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(a, smem_addr(Kw + a_off));
      ldmatrix_x4(av, smem_addr(Vw + a_off));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {    // 16 queries: two n8 tiles
        const int b_off = (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        unsigned bq[4];
        ldmatrix_x4(bq, smem_addr(Qt + b_off));
        mma_bf16(s[2 * j], a, bq[0], bq[1]);
        mma_bf16(s[2 * j + 1], a, bq[2], bq[3]);
        ldmatrix_x4(bq, smem_addr(dOt + b_off));
        mma_bf16(dp[2 * j], av, bq[0], bq[1]);
        mma_bf16(dp[2 * j + 1], av, bq[2], bq[3]);
      }
    }

    // ---- P^T in place of S^T, dS^T = P^T (dP^T - delta) in place of dP^T ---------
    const bool need_mask = (causal && q0 < kw0 + 15) || q0 + BQ > Sq || edge;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = j * 8 + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + c);
      const float2 d2 = *reinterpret_cast<const float2*>(Dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e] * scale_log2;
        bool ok = x > 0.5f * NEG_INF;
        if (need_mask) {
          const int qp = q0 + c + (e & 1);
          const int kp = e < 2 ? key_a : key_b;   // as a row
          ok = ok && qp < Sq && (e < 2 ? has_a : has_b) && !(causal && qp < kp);
        }
        const float p = ok ? exp2f(x - ((e & 1) ? l2.y : l2.x) * LOG2E) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // ---- dV += P^T dO, then dK += dS^T Q: the A operands from the registers -------
    // (two passes, so that P^T's registers are free before the second)
    const int b_lane = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      unsigned a[4], a_lo[4];
      a_from_acc(s[2 * kk], s[2 * kk + 1], a, a_lo);
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {    // 16 columns of d: two n8 tiles
        unsigned bt[4];
        ldmatrix_x4_trans(bt, smem_addr(dOt + (kk * 16 + b_lane) * LD + c0 + n * 16 +
                                        (lane >> 4) * 8));
        mma_bf16(dva[2 * n], a, bt[0], bt[1]);
        mma_bf16(dva[2 * n + 1], a, bt[2], bt[3]);
        mma_bf16(dva[2 * n], a_lo, bt[0], bt[1]);
        mma_bf16(dva[2 * n + 1], a_lo, bt[2], bt[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      unsigned a[4], a_lo[4];
      a_from_acc(dp[2 * kk], dp[2 * kk + 1], a, a_lo);
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        unsigned bt[4];
        ldmatrix_x4_trans(bt, smem_addr(Qt + (kk * 16 + b_lane) * LD + c0 + n * 16 +
                                        (lane >> 4) * 8));
        mma_bf16(dka[2 * n], a, bt[0], bt[1]);
        mma_bf16(dka[2 * n + 1], a, bt[2], bt[3]);
        mma_bf16(dka[2 * n], a_lo, bt[0], bt[1]);
        mma_bf16(dka[2 * n + 1], a_lo, bt[2], bt[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // every warp is done with the stages

  // ---- the block's float32 partials into the stages, then the cluster's fold -------
  float* Pk = reinterpret_cast<float*>(smem_raw + L::KV_BYTES);
  float* Pv = Pk + BKV * LDP;
  {
    const int ra = warp * 16 + g;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * tq;
      *reinterpret_cast<float2*>(Pk + ra * LDP + c) = make_float2(dka[n][0], dka[n][1]);
      *reinterpret_cast<float2*>(Pk + (ra + 8) * LDP + c) = make_float2(dka[n][2], dka[n][3]);
      *reinterpret_cast<float2*>(Pv + ra * LDP + c) = make_float2(dva[n][0], dva[n][1]);
      *reinterpret_cast<float2*>(Pv + (ra + 8) * LDP + c) = make_float2(dva[n][2], dva[n][3]);
    }
  }
  cluster.sync();                           // every block's partial is final
  // block `rank` sums rows [r0, r1) of the tile over the cluster in rank order
  const int per = (BKV + n_cl - 1) / n_cl;
  const int r0 = rank * per;
  const int rows = max(0, min(BKV, r0 + per) - r0);
  constexpr int V4 = NC / 4;
  for (int e = tid; e < 2 * rows * V4; e += MMA_NT) {
    const bool is_v = e >= rows * V4;
    const int f = is_v ? e - rows * V4 : e;
    const int r = r0 + f / V4;
    const int c = (f % V4) * 4;
    float* src = (is_v ? Pv : Pk) + r * LDP + c;
    float4 acc = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 0));
    for (int peer = 1; peer < n_cl; ++peer) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, peer));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int key = kv0 + r;
    if (key < Skv) {
      const float sc = is_v ? 1.f : sm_scale;
      uint2 packed;
      packed.x = pack_bf16(acc.x * sc, acc.y * sc);
      packed.y = pack_bf16(acc.z * sc, acc.w * sc);
      *reinterpret_cast<uint2*>((is_v ? dv : dk) + ((long long)grp * Skv + key) * D + c0 + c) =
          packed;
    }
  }
  cluster.sync();                           // no block leaves while a peer reads its partial
}

template <int D>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int BH, int Sq, int Skv, int H, int q_per_kv, long long k_sb,
                   long long k_sh, long long k_st, long long v_sb, long long v_sh,
                   long long v_st, float sm_scale, int causal, int q_off, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using LQ = MmaDqLayout<D>;
  using LKV = MmaDkvLayout<D>;
  const int nq = (Sq + MMA_BQ - 1) / MMA_BQ;
  const int nkv = (Skv + MMA_BKV - 1) / MMA_BKV;
  if (nq > 65535 || nkv > 65535 || H % q_per_kv || BH % H) return -1;
  const int n_cl = cluster_size(q_per_kv);
  const int heads = q_per_kv / n_cl;
  const bool aligned = ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                         reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(dout)) %
                        16) == 0;
  const int vec_ok = aligned && (k_sb | k_sh | k_st | v_sb | v_sh | v_st) % 8 == 0;
  auto kq = flash_bwd_dq_mma_kernel<D>;
  auto kkv = flash_bwd_dkv_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, LKV::BYTES);
  if (err != cudaSuccess) return (int)err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  constexpr int halves = BwdCols<D>::SPLITS;
  kq<<<dim3(BH, nq, halves), MMA_NT, LQ::BYTES, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), Sq, Skv, H, q_per_kv, k_sb, k_sh,
      k_st, v_sb, v_sh, v_st, sm_scale, causal, q_off, vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH / q_per_kv * n_cl, nkv, halves);
  cfg.blockDim = dim3(MMA_NT);
  cfg.dynamicSmemBytes = LKV::BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kkv, qt, kt, vt, dot, static_cast<const float*>(lse),
                           static_cast<const float*>(delta), static_cast<bf16*>(dk),
                           static_cast<bf16*>(dv), Sq, Skv, H, q_per_kv, heads, k_sb, k_sh,
                           k_st, v_sb, v_sh, v_st, sm_scale, causal, q_off, vec_ok);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_any(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq, void* dk,
                   void* dv, int BH, int Sq, int Skv, int d, int H, int q_per_kv,
                   long long k_sb, long long k_sh, long long k_st, long long v_sb,
                   long long v_sh, long long v_st, float sm_scale, int causal, int q_off,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_FA_BWD_CASE(D_)                                                               \
  if (d == D_) {                                                                            \
    if constexpr (is_bf16<T>::value)                                                        \
      return launch_bwd_mma<D_>(q, k, v, o, dout, l, dl, dq, dk, dv, BH, Sq, Skv, H,        \
                                q_per_kv, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale,     \
                                causal, q_off, s);                                          \
    else                                                                                    \
      return launch_bwd_f32<T, D_>(q, k, v, o, dout, l, dl, dq, dk, dv, BH, Sq, Skv, H,     \
                                   q_per_kv, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale,  \
                                   causal, q_off, s);                                       \
  }
  REPRO_FA_BWD_CASE(32)
  REPRO_FA_BWD_CASE(64)
  REPRO_FA_BWD_CASE(128)
  REPRO_FA_BWD_CASE(256)
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
    long long v_sh, long long v_st, float sm_scale, int causal, int q_off, void* stream) {
  return repro::fa_bwd::launch_bwd_any<__nv_bfloat16>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, BH, Sq, Skv, d, H, q_per_kv, k_sb, k_sh, k_st,
      v_sb, v_sh, v_st, sm_scale, causal, q_off, stream);
}

extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int Sq, int Skv, int d,
    int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, float sm_scale, int causal, int q_off, void* stream) {
  return repro::fa_bwd::launch_bwd_any<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH,
                                              Sq, Skv, d, H, q_per_kv, k_sb, k_sh, k_st, v_sb,
                                              v_sh, v_st, sm_scale, causal, q_off, stream);
}

// Shared memory of one block: kernel 0 the dQ launch, 1 the dK/dV launch, of
// the bf16 (tensor-core) or float32 body; -1 for a head dim that is not
// compiled.  Mirrored by flash_attention_bwd.bwd_smem_bytes().
extern "C" int repro_flash_bwd_smem_bytes(int d, int kernel, int is_bf16) {
  using namespace repro::fa_bwd;
#define REPRO_FA_BWD_SMEM(D_)                                                             \
  if (d == D_) {                                                                          \
    if (is_bf16) return kernel == 0 ? MmaDqLayout<D_>::BYTES : MmaDkvLayout<D_>::BYTES;   \
    return kernel == 0 ? DqLayout<D_>::BYTES : DkvLayout<D_>::BYTES;                      \
  }
  REPRO_FA_BWD_SMEM(32)
  REPRO_FA_BWD_SMEM(64)
  REPRO_FA_BWD_SMEM(128)
  REPRO_FA_BWD_SMEM(256)
#undef REPRO_FA_BWD_SMEM
  return -1;
}

// Blocks of one dK/dV cluster for a group of q_per_kv query heads (bf16).
extern "C" int repro_flash_bwd_cluster(int q_per_kv) {
  return repro::fa_bwd::cluster_size(q_per_kv);
}
