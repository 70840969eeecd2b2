// Flash-decode for Hopper (sm_90a): one query token against a long KV cache,
// split over the KV sequence, with the log-sum-exp combine of the splits in
// the same launch.
//
// Replaces the TPU kernel `_decode_kernel` / `flash_decode_partials` of
// src/repro/kernels/flash_decode.py, and `combine_partials` of the same file.
// One body computes a split's (m, l, acc) per query head; two epilogues
// finish it:
//
//   * COMBINE (`ops.flash_decode`, the serving path): the splits of one
//     (batch x kv-head) group run as one thread-block cluster along the
//     split axis (at most 8 blocks, the portable cluster size).  After
//     `cluster.sync()` every block reads its peers' (m, l, acc) through
//     distributed shared memory and writes its share of the normalised
//     output.  No global scratch, no second launch.
//   * PARTIALS (`flash_decode_partials`, the reference's first function):
//     the split's float32 (m, l, acc) go to device memory, for
//     `decode_combine_kernel` (`combine_partials`) to fold.
//
// Against the reference kernel: a valid length (keys [0, kv_len) of a longer
// buffer take part; the valid range is cut into `splits` strips and the
// ragged end is masked, so nothing has to divide anything; a strip wholly
// beyond the valid length gives (m, l, acc) = (-1e30, 0, 0), which the
// combine ignores), and grouped-query attention without a repeated copy: one
// block serves all G = q_per_kv query heads of a kv head, so each K/V byte is
// read from device memory once.  K/V come with explicit (batch, kv-head, key)
// strides, so the serving cache is read in place.
//
// What bounds it on an H100: bytes, and before them latency.  A decode step
// of qwen2.5-3b (4 sequences, 16 query heads on 2 kv heads, 513 valid keys,
// d = 128, bf16) reads 2.1 MB of K/V for 17 MFLOP, 0.6 us at the memory
// rate, so a launch and one round trip to device memory cost more than the
// work.  The bf16 design (decode_mma_kernel) therefore keeps the chain from
// launch to store short:
//   * one launch per call (the COMBINE epilogue);
//   * each of the block's 4 warps owns every 4th 16-key chunk of the strip
//     and issues `cp.async` for up to DEC_STAGES of its chunks before it
//     computes anything, into a ring of its own: at the served shape (65 keys
//     a strip, at most 2 chunks a warp) the whole strip is in flight at once,
//     one round trip sets the pace, and no barrier is needed until the warps
//     merge.  Two stages keep a block at 82 KB (d 128), so two blocks fit
//     an SM and 16 clusters of 8 (the MoE's decode) find room at once; at
//     d 256 a block takes 160 KB, one an SM (an aligned bf16 call at d 256,
//     gemma-7b's, runs the Hopper body of flash_decode_tma.cu instead);
//   * the G query heads of a kv head (padded to 16) are the rows of an
//     `mma.sync.m16n8k16` tile: scores, probabilities and the output
//     accumulator stay in registers, with K2's fragment helpers (mma.cuh);
//   * the warps merge their (m, l, acc) in shared memory, then the splits
//     through the cluster.
// float32 (decode_f32_kernel) keeps the first scalar design, true float32
// FMAs (no TF32: its tolerance is 1e-4), with the same two epilogues.
#include <cstdint>

#include "flash_decode.cuh"
#include "mma.cuh"

namespace repro {

// ---- bf16: tensor-core body -----------------------------------------------------
template <int D, bool COMBINE>
__global__ void __launch_bounds__(DEC_THREADS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, int G, int hkv, int kv_len, int splits,
                  long long k_sb, long long k_sh, long long k_st, long long v_sb,
                  long long v_sh, long long v_st, float sm_scale, int vec_ok) {
  using L = DecodeLayout<D>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD;
  constexpr int KD = D / 16;                // k16 steps of Q K^T
  constexpr int NO = D / 8;                 // n8 tiles of the output
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr unsigned FULL = 0xffffffffu;
  static_assert(D % 16 == 0, "head dimension is whole mma steps");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L::Q_BYTES);
  float* res = reinterpret_cast<float*>(smem_raw + L::Q_BYTES + L::RING_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;                  // accumulator rows g and g + 8
  const int tq = lane & 3;                  // accumulator columns 2 tq, 2 tq + 1
  const int group = blockIdx.x;             // batch * hkv + kv head
  const int split = blockIdx.y;

  const int strip = (kv_len + splits - 1) / splits;
  const int t_begin = min(kv_len, split * strip);
  const int t_end = min(kv_len, t_begin + strip);
  const int n_chunks = (t_end - t_begin + DEC_CHUNK - 1) / DEC_CHUNK;
  const int mine = n_chunks > warp ? (n_chunks - warp + DEC_WARPS - 1) / DEC_WARPS : 0;

  const bf16* kb = k + (long long)(group / hkv) * k_sb + (long long)(group % hkv) * k_sh;
  const bf16* vb = v + (long long)(group / hkv) * v_sb + (long long)(group % hkv) * v_sh;
  bf16* Kw = ring + warp * DEC_STAGES * 2 * L::CHUNK_ELEMS;   // stage st: K, then V

  // every chunk this warp will need, up to DEC_STAGES of them, before any math
  auto issue = [&](int j) {
    const int row0 = t_begin + (warp + DEC_WARPS * j) * DEC_CHUNK;
    bf16* st = Kw + (j % DEC_STAGES) * 2 * L::CHUNK_ELEMS;
    flash_copy<DEC_CHUNK, D, LD, 32>(st, kb, row0, t_end, k_st, vec_ok, lane);
    flash_copy<DEC_CHUNK, D, LD, 32>(st + L::CHUNK_ELEMS, vb, row0, t_end, v_st, vec_ok, lane);
  };
#pragma unroll
  for (int j = 0; j < DEC_STAGES; ++j) {
    if (j < mine) issue(j);
    cp_async_commit();
  }
  // the G query rows; rows G..15 are zeros
  load_tile<bf16, DEC_GMAX, D, LD, DEC_THREADS>(Qs, q + (long long)group * G * D, 0, 0, G, D, D,
                                                vec_ok, tid);
  __syncthreads();
  // Q's A fragments stay in registers up to d 128; at d 256 they would take
  // 64 registers beside the 128 of the accumulator, so they are read from
  // shared memory (untouched until the warps merge) at each step
  constexpr bool Q_IN_REGS = D <= 128;
  constexpr int KQ = Q_IN_REGS ? KD : 1;
  unsigned qa[KQ][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qa[kk], smem_addr(Qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
  }

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;       // running max of rows g, g + 8
  float l_a = 0.f, l_b = 0.f;               // this thread's share of the running sums

  for (int j = 0; j < mine; ++j) {
    cp_async_wait<DEC_STAGES - 1>();
    __syncwarp();                           // chunk j landed for every lane
    const bf16* Kt = Kw + (j % DEC_STAGES) * 2 * L::CHUNK_ELEMS;
    const bf16* Vt = Kt + L::CHUNK_ELEMS;
    const int key0 = t_begin + (warp + DEC_WARPS * j) * DEC_CHUNK;

    // ---- S = Q K^T: 16 rows x 16 keys ----------------------------------------------
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, smem_addr(Kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8));
      if constexpr (!Q_IN_REGS)
        ldmatrix_x4(qa[0], smem_addr(Qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
      const unsigned (&a)[4] = qa[Q_IN_REGS ? kk : 0];
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }

    // ---- online softmax where the scores lie (natural-log domain, as the
    // partials are defined) -------------------------------------------------------------
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + 2 * tq + (e & 1);
        s[n][e] = key < t_end ? s[n][e] * sm_scale : NEG_INF;   // ragged end
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f((m_a - mn_a) * LOG2E);
    const float alpha_b = exp2f((m_b - mn_b) * LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_a : mn_b;
        s[n][e] = s[n][e] > 0.5f * NEG_INF ? exp2f((s[n][e] - mn) * LOG2E) : 0.f;
      }
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
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

    // ---- O += P V: P straight from the score registers -------------------------------
    const unsigned a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < NO / 2; ++n) {      // 16 output columns: two n8 tiles
      unsigned b[4];
      ldmatrix_x4_trans(b, smem_addr(Vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + n * 16 +
                                     (lane >> 4) * 8));
      mma_bf16(oacc[2 * n], a, b[0], b[1]);
      mma_bf16(oacc[2 * n + 1], a, b[2], b[3]);
    }
    __syncwarp();                           // every lane is done with this stage
    if (j + DEC_STAGES < mine) issue(j + DEC_STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);

  // ---- merge the warps: (m, l, acc) of each warp through Q's and the ring's space -
  __syncthreads();                          // every warp is done with Q and its ring
  float* wsc = reinterpret_cast<float*>(smem_raw);
  constexpr int WSZ = 2 * DEC_GMAX + DEC_GMAX * L::WLD;
  float* mine_sc = wsc + warp * WSZ;
  if (tq == 0) {
    mine_sc[g] = m_a;
    mine_sc[g + 8] = m_b;
    mine_sc[DEC_GMAX + g] = l_a;
    mine_sc[DEC_GMAX + g + 8] = l_b;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    float* row_a = mine_sc + 2 * DEC_GMAX + g * L::WLD + n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(row_a) = make_float2(oacc[n][0], oacc[n][1]);
    *reinterpret_cast<float2*>(row_a + 8 * L::WLD) = make_float2(oacc[n][2], oacc[n][3]);
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += DEC_THREADS) {
    const int r = e / D;
    const int c = e % D;
    float mb = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mb = fmaxf(mb, wsc[w * WSZ + r]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float scale = exp2f((wsc[w * WSZ + r] - mb) * LOG2E);
      lb = fmaf(wsc[w * WSZ + DEC_GMAX + r], scale, lb);
      ab = fmaf(wsc[w * WSZ + 2 * DEC_GMAX + r * L::WLD + c], scale, ab);
    }
    res[2 * DEC_GMAX + e] = ab;
    if (c == 0) {
      res[r] = mb;
      res[DEC_GMAX + r] = lb;
    }
  }
  __syncthreads();
  decode_epilogue<D, COMBINE>(res, out, m_out, l_out, acc_out, G, splits);
}

// ---- float32: scalar body ---------------------------------------------------------
// The K and V tiles are staged in shared memory with 16-byte loads that all
// threads start at once; every thread takes the whole q.k dot products of
// one key (at d 256, whose tile holds 64 keys, two neighbouring threads take
// half of one key's each), one warp per query head runs the online softmax,
// and a thread owns an output column in P V (at d 256 two columns).
template <int D, bool COMBINE>
__global__ void __launch_bounds__(DEC_THREADS)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, int G, int hkv, int kv_len, int splits,
                  long long k_sb, long long k_sh, long long k_st, long long v_sb,
                  long long v_sh, long long v_st, float sm_scale, int vec_ok) {
  constexpr int TILE = dec_f32_tile<D>();
  constexpr int KPARTS = DEC_THREADS / TILE;     // threads sharing one key's dot products
  static_assert(KPARTS * TILE == DEC_THREADS && (KPARTS == 1 || KPARTS == 2),
                "the score phase maps one or two threads to a key");
  constexpr int LDK = D + 4;                     // padded row of the staged tiles
  constexpr int PARTS = D < DEC_THREADS ? DEC_THREADS / D : 1;   // threads sharing a column
  constexpr int CPT = D > DEC_THREADS ? D / DEC_THREADS : 1;     // columns a thread owns
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ float qs[DEC_GMAX][D];
  __shared__ float ss[DEC_GMAX][TILE];
  __shared__ float red[DEC_GMAX * DEC_THREADS];
  __shared__ float m_s[DEC_GMAX], l_s[DEC_GMAX], alpha_s[DEC_GMAX];
  extern __shared__ __align__(128) unsigned char dec_smem[];
  float* Ks = reinterpret_cast<float*>(dec_smem);
  float* Vs = Ks + TILE * LDK;
  float* res = Vs + TILE * LDK;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = blockIdx.x;                  // batch * hkv + kv head
  const int split = blockIdx.y;

  const int strip = (kv_len + splits - 1) / splits;
  const int t_begin = split * strip;
  const int t_end = min(kv_len, t_begin + strip);

  const float* kb = k + (long long)(group / hkv) * k_sb + (long long)(group % hkv) * k_sh;
  const float* vb = v + (long long)(group / hkv) * v_sb + (long long)(group % hkv) * v_sh;
  const float* qb = q + (long long)group * G * D;

  for (int i = tid; i < G * D; i += DEC_THREADS) qs[i / D][i % D] = qb[i];
  if (tid < DEC_GMAX) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    alpha_s[tid] = 1.f;
  }
  const int col = tid % (D < DEC_THREADS ? D : DEC_THREADS);
  const int part = D < DEC_THREADS ? tid / D : 0;
  float acc[CPT][DEC_GMAX];
#pragma unroll
  for (int x = 0; x < CPT; ++x)
#pragma unroll
    for (int g = 0; g < DEC_GMAX; ++g) acc[x][g] = 0.f;
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
    const int tile_n = min(TILE, t_end - t0);
    // rows at or beyond t_end are staged as zeros and masked below
    load_tile<float, TILE, D, LDK, DEC_THREADS>(Ks, kb, t0, 0, t_end, D, k_st, vec_ok, tid);
    load_tile<float, TILE, D, LDK, DEC_THREADS>(Vs, vb, t0, 0, t_end, D, v_st, vec_ok, tid);
    __syncthreads();

    // ---- scores: a thread (or two) owns one key and every query head -----------
    {
      const int key = tid / KPARTS;
      const int kpart = tid % KPARTS;
      const float* krow = Ks + key * LDK;
      float s[DEC_GMAX];
#pragma unroll
      for (int g = 0; g < DEC_GMAX; ++g) s[g] = 0.f;
      for (int c = kpart * (D / KPARTS); c < (kpart + 1) * (D / KPARTS); c += 4) {
        const float4 kf = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
        for (int g = 0; g < DEC_GMAX; ++g) {
          if (g < G) {
            s[g] = fmaf(kf.x, qs[g][c], s[g]);
            s[g] = fmaf(kf.y, qs[g][c + 1], s[g]);
            s[g] = fmaf(kf.z, qs[g][c + 2], s[g]);
            s[g] = fmaf(kf.w, qs[g][c + 3], s[g]);
          }
        }
      }
      if constexpr (KPARTS > 1) {
#pragma unroll
        for (int g = 0; g < DEC_GMAX; ++g) s[g] += __shfl_xor_sync(FULL, s[g], 1);
      }
#pragma unroll
      for (int g = 0; g < DEC_GMAX; ++g)
        if (g < G && kpart == 0) ss[g][key] = key < tile_n ? s[g] * sm_scale : NEG_INF;
    }
    __syncthreads();

    // ---- online softmax per query head: one warp per head ---------------------
    constexpr int PER_LANE = TILE / 32;
    for (int g = warp; g < G; g += DEC_WARPS) {
      float sv[PER_LANE];
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        sv[e] = ss[g][lane + 32 * e];
        mx = fmaxf(mx, sv[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const float p = sv[e] > 0.5f * NEG_INF ? expf(sv[e] - m_new) : 0.f;
        ss[g][lane + 32 * e] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- acc += P V: a thread owns output columns, V reads run along d --------
#pragma unroll
    for (int x = 0; x < CPT; ++x)
#pragma unroll
      for (int g = 0; g < DEC_GMAX; ++g)
        if (g < G) acc[x][g] *= alpha_s[g];
    for (int j = part; j < tile_n; j += PARTS) {
#pragma unroll
      for (int x = 0; x < CPT; ++x) {
        const float vv = Vs[j * LDK + col + x * DEC_THREADS];
#pragma unroll
        for (int g = 0; g < DEC_GMAX; ++g)
          if (g < G) acc[x][g] = fmaf(ss[g][j], vv, acc[x][g]);
      }
    }
    __syncthreads();                   // ss, Ks and Vs are rewritten by the next tile
  }

  // ---- fold the threads that share a column into the split's result -----------
  if constexpr (PARTS > 1) {
#pragma unroll
    for (int g = 0; g < DEC_GMAX; ++g)
      if (g < G) red[g * DEC_THREADS + tid] = acc[0][g];
    __syncthreads();
    if (part == 0) {
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int p = 0; p < PARTS; ++p) a += red[g * DEC_THREADS + p * D + col];
        res[2 * DEC_GMAX + g * D + col] = a;
      }
    }
  } else {
#pragma unroll
    for (int x = 0; x < CPT; ++x)
      for (int g = 0; g < G; ++g) res[2 * DEC_GMAX + g * D + col + x * DEC_THREADS] = acc[x][g];
  }
  if (tid < G) {
    res[tid] = m_s[tid];
    res[DEC_GMAX + tid] = l_s[tid];
  }
  __syncthreads();
  decode_epilogue<D, COMBINE>(res, out, m_out, l_out, acc_out, G, splits);
}

// Log-sum-exp combine of the per-split partials (`combine_partials`, K3').
// One warp folds one row's slice of 32 x VEC output columns; COMB_WARPS
// warps a block.  The fold is a handful of FMAs a split, so what bounds it
// is how many round trips to memory it waits for in series: every load of a
// row is issued before the first one is used.  The lanes read m and l of a
// window of COMB_WINDOW splits at once, lane s split s (and s + 32), and each
// lane reads its VEC columns of BATCH splits' acc in 16-byte vectors (VEC
// 4) before the fold starts.  A row of more than 64 splits reads its m's a
// window at a time for the maximum, and its l's and scales a window at a
// time as the fold reaches them.  BATCH (2, 4, 8 or 16) is the least that holds
// the splits, up to 16: the registers a lane keeps for them decide how many
// warps an SM holds, and so how many rows wait on memory at once (the chunk
// rows' 8,192 rows of 2 splits fit the card in one wave).  The fold itself
// is the first design's, operation for operation: the maximum of the m's,
// then in split order
// l_g = fmaf(l_s, e_s, l_g) and a_g = fmaf(acc_s, e_s, a_g) with
// e_s = expf(m_s - m_g) (computed by lane s, handed to the others by a
// shuffle), l_g == 0 -> 1, one division and one rounding; so its outputs are
// bit-equal to the first design's.  An empty split (-1e30, 0, 0) adds 0.
constexpr int COMB_WARPS = 4;
constexpr int COMB_WINDOW = 64;

template <int VEC>
__device__ __forceinline__ void comb_load(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = p[e];
  }
}

template <int VEC, int BATCH>
__global__ void __launch_bounds__(COMB_WARPS * 32)
decode_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ acc, void* __restrict__ out, int rows,
                      int splits, int d, int out_bf16) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int slices = (d + 32 * VEC - 1) / (32 * VEC);
  const long long item = (long long)blockIdx.x * COMB_WARPS + threadIdx.x / 32;
  if (item >= (long long)rows * slices) return;            // the whole warp leaves
  const long long bh = item / slices;
  const int col = (int)(item % slices) * 32 * VEC + lane * VEC;
  const bool active = col < d;                             // VEC divides d
  const float* mb = m + bh * splits;
  const float* lb = l + bh * splits;
  const float* ab = acc + bh * splits * d + col;

  // every load of the row at once: m and l of the first window, acc of the
  // first batch
  float m0 = lane < splits ? mb[lane] : NEG_INF;
  float m1 = lane + 32 < splits ? mb[lane + 32] : NEG_INF;
  float l0 = lane < splits ? lb[lane] : 0.f;
  float l1 = lane + 32 < splits ? lb[lane + 32] : 0.f;
  float v[BATCH][VEC];
#pragma unroll
  for (int i = 0; i < BATCH; ++i)
    if (active && i < splits) comb_load<VEC>(v[i], ab + (long long)i * d);

  float m_g = fmaxf(m0, m1);
  for (int w = COMB_WINDOW; w < splits; w += COMB_WINDOW) {  // the m's of later windows
    const float a = lane + w < splits ? mb[lane + w] : NEG_INF;
    const float b = lane + w + 32 < splits ? mb[lane + w + 32] : NEG_INF;
    m_g = fmaxf(m_g, fmaxf(a, b));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m_g = fmaxf(m_g, __shfl_xor_sync(FULL, m_g, off));
  float e0 = expf(m0 - m_g);                               // this lane's splits' scales
  float e1 = expf(m1 - m_g);
  float l_g = 0.f;
  float a_g[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) a_g[e] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += BATCH) {             // BATCH divides COMB_WINDOW
    if (s0 > 0 && s0 % COMB_WINDOW == 0) {                 // the next window's l's and scales
      m0 = lane + s0 < splits ? mb[lane + s0] : NEG_INF;
      m1 = lane + s0 + 32 < splits ? mb[lane + s0 + 32] : NEG_INF;
      l0 = lane + s0 < splits ? lb[lane + s0] : 0.f;
      l1 = lane + s0 + 32 < splits ? lb[lane + s0 + 32] : 0.f;
      e0 = expf(m0 - m_g);
      e1 = expf(m1 - m_g);
    }
    if (s0 > 0) {
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        if (active && s0 + i < splits) comb_load<VEC>(v[i], ab + (long long)(s0 + i) * d);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int s = s0 + i;
      if (s < splits) {                                    // uniform across the warp
        const bool low = (s % COMB_WINDOW) < 32;
        const float scale = __shfl_sync(FULL, low ? e0 : e1, s & 31);
        const float ls = __shfl_sync(FULL, low ? l0 : l1, s & 31);
        l_g = fmaf(ls, scale, l_g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) a_g[e] = fmaf(v[i][e], scale, a_g[e]);
      }
    }
  }
  if (!active) return;
  if (l_g == 0.f) l_g = 1.f;
  const long long o = bh * d + col;
  if (out_bf16) {
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(out) + o;
    if constexpr (VEC == 4) {          // round to nearest, as __float2bfloat16
      *reinterpret_cast<uint2*>(ob) = make_uint2(pack_bf16(a_g[0] / l_g, a_g[1] / l_g),
                                                 pack_bf16(a_g[2] / l_g, a_g[3] / l_g));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) ob[e] = __float2bfloat16(a_g[e] / l_g);
    }
  } else {
    float r[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = a_g[e] / l_g;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) reinterpret_cast<float*>(out)[o + e] = r[e];
    }
  }
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* m;
  float* l;
  float* acc;
  int n_groups, G, hkv, d, kv_len, splits;
  long long k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  float sm_scale;
  int vec_ok;
};

// One launch of body `kern` with `smem` bytes of dynamic shared memory; the
// COMBINE epilogue runs the splits of a group as one cluster.
template <typename T, typename TO>
int launch_decode_body(void (*kern)(const T*, const T*, const T*, TO*, float*, float*, float*,
                                    int, int, int, int, long long, long long, long long,
                                    long long, long long, long long, float, int),
                       int smem, bool combine, const DecodeArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_groups, a.splits);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = combine ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                           static_cast<const T*>(a.v), static_cast<TO*>(a.out), a.m, a.l, a.acc,
                           a.G, a.hkv, a.kv_len, a.splits, a.k_sb, a.k_sh, a.k_st, a.v_sb,
                           a.v_sh, a.v_st, a.sm_scale, a.vec_ok);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The body follows the type: bf16 runs on the tensor cores, float32 on the
// scalar body.  Both take any alignment (`vec_ok == 0` copies with scalar
// loads), G <= 16 and d in {32, 64, 128, 256}.
template <bool COMBINE>
int launch_decode(const DecodeArgs& a, int is_bf16, cudaStream_t s) {
  if (a.G < 1 || a.G > DEC_GMAX || a.splits < 1) return -1;
  if (COMBINE && a.splits > DEC_MAX_CLUSTER) return -1;
#define REPRO_DEC_CASE(D_)                                                                 \
  if (a.d == D_) {                                                                         \
    if (is_bf16)                                                                           \
      return launch_decode_body(decode_mma_kernel<D_, COMBINE>, DecodeLayout<D_>::TOTAL,   \
                                COMBINE, a, s);                                            \
    return launch_decode_body(decode_f32_kernel<D_, COMBINE>, decode_f32_smem_bytes<D_>(), \
                              COMBINE, a, s);                                              \
  }
  REPRO_DEC_CASE(32)
  REPRO_DEC_CASE(64)
  REPRO_DEC_CASE(128)
  REPRO_DEC_CASE(256)
#undef REPRO_DEC_CASE
  return -1;
}

}  // namespace repro

// Plain C interface: no allocation, no synchronisation; each function
// launches on the stream it is handed and returns cudaGetLastError() (or
// the launch's own error), or -1 for a shape that is not compiled (d not in
// {32, 64, 128, 256}, more than 16 query heads per kv head, more than 8 splits
// for the one-launch decode).
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, void* out,
                                  int n_groups, int G, int hkv, int d, int kv_len, int splits,
                                  long long k_sb, long long k_sh, long long k_st, long long v_sb,
                                  long long v_sh, long long v_st, float sm_scale, int is_bf16,
                                  int vec_ok, void* stream) {
  const repro::DecodeArgs a{q, k, v, out, nullptr, nullptr, nullptr, n_groups, G, hkv, d,
                            kv_len, splits, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale,
                            vec_ok};
  return repro::launch_decode<true>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_decode_partials(
    const void* q, const void* k, const void* v, void* m, void* l, void* acc, int n_groups,
    int G, int hkv, int d, int kv_len, int splits, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, float sm_scale,
    int is_bf16, int vec_ok, void* stream) {
  const repro::DecodeArgs a{q, k, v, nullptr, static_cast<float*>(m), static_cast<float*>(l),
                            static_cast<float*>(acc), n_groups, G, hkv, d, kv_len, splits,
                            k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale, vec_ok};
  return repro::launch_decode<false>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_decode_combine(const void* m, const void* l, const void* acc,
                                          void* out, int BH, int splits, int d, int out_bf16,
                                          void* stream) {
  if (d < 1 || d > 1024 || splits < 1) return -1;
  if (BH < 1) return 0;
  // 16-byte vectors where every row of acc and out starts aligned for them
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (out_bf16 ? 8 : 16) == 0;
  const int per_row = vec4 ? (d + 127) / 128 : (d + 31) / 32;
  const long long items = (long long)BH * per_row;
  const long long blocks = (items + repro::COMB_WARPS - 1) / repro::COMB_WARPS;
  if (blocks > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(repro::COMB_WARPS * 32);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* af = static_cast<const float*>(acc);
  const int batch = splits <= 2 ? 2 : splits <= 4 ? 4 : splits <= 8 ? 8 : 16;
#define REPRO_COMB_CASE(VEC_, BATCH_)                                                       \
  if ((vec4 ? 4 : 1) == VEC_ && batch == BATCH_) {                                           \
    repro::decode_combine_kernel<VEC_, BATCH_><<<grid, block, 0, s>>>(mf, lf, af, out, BH,   \
                                                                       splits, d, out_bf16); \
    return (int)cudaGetLastError();                                                          \
  }
  REPRO_COMB_CASE(4, 2)
  REPRO_COMB_CASE(4, 4)
  REPRO_COMB_CASE(4, 8)
  REPRO_COMB_CASE(4, 16)
  REPRO_COMB_CASE(1, 2)
  REPRO_COMB_CASE(1, 4)
  REPRO_COMB_CASE(1, 8)
  REPRO_COMB_CASE(1, 16)
#undef REPRO_COMB_CASE
  return -1;
}

// Dynamic shared memory of one block of the decode body for `d` and the body
// (0 float32, 1 mma.sync, 2 TMA; mirrored by flash_decode.decode_smem_bytes),
// -1 if not compiled.
extern "C" int repro_flash_decode_smem_bytes(int d, int body) {
  if (body == 2) return d == repro::DecodeTmaLayout::D ? repro::DecodeTmaLayout::TOTAL : -1;
#define REPRO_DEC_SMEM(D_)                                                                  \
  if (d == D_) return body ? repro::DecodeLayout<D_>::TOTAL : repro::decode_f32_smem_bytes<D_>();
  REPRO_DEC_SMEM(32)
  REPRO_DEC_SMEM(64)
  REPRO_DEC_SMEM(128)
  REPRO_DEC_SMEM(256)
#undef REPRO_DEC_SMEM
  return -1;
}
