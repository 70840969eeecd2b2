// Flash-decode for Hopper (sm_90a): one query token against a long KV cache,
// split over the KV sequence, plus the log-sum-exp combine of the splits.
//
// Replaces the TPU kernel `_decode_kernel` / `flash_decode_partials` of
// src/repro/kernels/flash_decode.py, and `combine_partials` of the same file
// (plain array code there, a second small kernel here).  The two stages are
// kept: a partials kernel over the grid (kv-head group, split) that emits
// float32 (m, l, acc) per query head and split, and a combine over the
// splits.  Two things are new against the reference kernel:
//
//   * a valid length: the kernel walks keys [0, kv_len) of a longer cache
//     buffer, cuts that range into `splits` strips itself and masks the
//     ragged end of the last tile, so neither the buffer length nor the valid
//     length has to divide anything; a strip that lies wholly beyond the
//     valid length returns (m, l, acc) = (-1e30, 0, 0), which the combine
//     ignores;
//   * grouped-query attention without a repeated copy: one block serves all
//     `G = q_per_kv` query heads of a kv head, so each K/V byte is read from
//     device memory once, not once per query head.  K/V come with explicit
//     (batch, kv-head, key) strides, so the serving cache is read in place.
//
// What bounds it on an H100: bytes.  A decode step of the serving model
// (4 sequences, 16 query heads on 2 kv heads, 513 valid keys, d = 128, bf16)
// reads 2.1 MB of K/V for 17 MFLOP: 8 operations per byte, far below the
// card's balance point.  The least time is the K/V bytes over the memory
// rate, under a microsecond at this cache length, so a launch costs more
// than the work; the split axis is what spreads the 8 (batch x kv-head)
// groups over the card's 132 SMs.
// The design stages each 64-key K and V tile in shared memory with 16-byte
// loads that all threads start at once, gives every thread whole q.k dot
// products (no shuffle reductions: a warp that folds one key's products with
// dependent shuffles spends its time waiting on them), keeps every read
// coalesced along d, and does the arithmetic in float32 on the CUDA cores;
// nothing here needs the tensor cores.
#include "common.cuh"

namespace repro {

constexpr int DEC_THREADS = 128;
constexpr int DEC_TILE = 64;      // keys per inner tile
constexpr int DEC_GMAX = 16;      // most query heads one kv head may serve

// Dynamic shared memory of one block: the K and V tiles (rows padded by 16
// bytes against bank conflicts).
template <typename T, int D>
constexpr int decode_smem_bytes() {
  return 2 * DEC_TILE * (D + 16 / (int)sizeof(T)) * (int)sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ acc_out, int G, int hkv,
                       int kv_len, int splits, long long k_sb, long long k_sh, long long k_st,
                       long long v_sb, long long v_sh, long long v_st, float sm_scale,
                       int vec_ok) {
  constexpr int VEC = 16 / (int)sizeof(T);       // elements in a 16-byte piece
  static_assert(DEC_THREADS == 2 * DEC_TILE, "the score phase maps two threads to a key");
  constexpr int LDK = D + 16 / (int)sizeof(T);   // padded row of the staged tiles
  constexpr int PARTS = DEC_THREADS / D;         // threads sharing one output column
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ float qs[DEC_GMAX][D];
  __shared__ float ss[DEC_GMAX][DEC_TILE];
  __shared__ float red[DEC_GMAX * DEC_THREADS];
  __shared__ float m_s[DEC_GMAX], l_s[DEC_GMAX], alpha_s[DEC_GMAX];
  extern __shared__ __align__(128) unsigned char dec_smem[];
  T* Ks = reinterpret_cast<T*>(dec_smem);
  T* Vs = Ks + DEC_TILE * LDK;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = blockIdx.x;                  // batch * hkv + kv head
  const int split = blockIdx.y;

  const int chunk = (kv_len + splits - 1) / splits;
  const int t_begin = split * chunk;
  const int t_end = min(kv_len, t_begin + chunk);

  const T* kb = k + (long long)(group / hkv) * k_sb + (long long)(group % hkv) * k_sh;
  const T* vb = v + (long long)(group / hkv) * v_sb + (long long)(group % hkv) * v_sh;
  const T* qb = q + (long long)group * G * D;

  for (int i = tid; i < G * D; i += DEC_THREADS) qs[i / D][i % D] = to_float(qb[i]);
  if (tid < DEC_GMAX) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    alpha_s[tid] = 1.f;
  }
  const int col = tid % D;
  const int part = tid / D;
  float acc[DEC_GMAX];
#pragma unroll
  for (int g = 0; g < DEC_GMAX; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += DEC_TILE) {
    const int tile_n = min(DEC_TILE, t_end - t0);
    // rows at or beyond t_end are staged as zeros and masked below
    load_tile<T, DEC_TILE, D, LDK, DEC_THREADS>(Ks, kb, t0, 0, t_end, D, k_st, vec_ok, tid);
    load_tile<T, DEC_TILE, D, LDK, DEC_THREADS>(Vs, vb, t0, 0, t_end, D, v_st, vec_ok, tid);
    __syncthreads();

    // ---- scores: a thread owns one key and every other query head; it reads
    // the key row from shared memory in 16-byte pieces (the row padding makes
    // that conflict-free) and the query values as broadcasts -------------------
    {
      const int j = tid % DEC_TILE;
      const int g0 = tid / DEC_TILE;             // 0 or 1: even or odd query heads
      const T* krow = Ks + j * LDK;
      float s[DEC_GMAX / 2];
#pragma unroll
      for (int gi = 0; gi < DEC_GMAX / 2; ++gi) s[gi] = 0.f;
      for (int c = 0; c < D; c += VEC) {
        __align__(16) T piece[VEC];
        *reinterpret_cast<uint4*>(piece) = *reinterpret_cast<const uint4*>(krow + c);
        float kf[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = to_float(piece[e]);
#pragma unroll
        for (int gi = 0; gi < DEC_GMAX / 2; ++gi) {
          const int g = g0 + 2 * gi;
          if (g < G) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) s[gi] = fmaf(kf[e], qs[g][c + e], s[gi]);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < DEC_GMAX / 2; ++gi) {
        const int g = g0 + 2 * gi;
        if (g < G) ss[g][j] = j < tile_n ? s[gi] * sm_scale : NEG_INF;   // ragged end
      }
    }
    __syncthreads();

    // ---- online softmax per query head: one warp per head ---------------------
    for (int g = warp; g < G; g += DEC_THREADS / 32) {
      const float s0 = ss[g][lane];
      const float s1 = ss[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = s0 > 0.5f * NEG_INF ? expf(s0 - m_new) : 0.f;
      const float p1 = s1 > 0.5f * NEG_INF ? expf(s1 - m_new) : 0.f;
      ss[g][lane] = p0;
      ss[g][lane + 32] = p1;
      float sum = p0 + p1;
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

    // ---- acc += P V: a thread owns one output column, V reads run along d -----
#pragma unroll
    for (int g = 0; g < DEC_GMAX; ++g)
      if (g < G) acc[g] *= alpha_s[g];
    for (int j = part; j < tile_n; j += PARTS) {
      const float vv = to_float(Vs[j * LDK + col]);
#pragma unroll
      for (int g = 0; g < DEC_GMAX; ++g)
        if (g < G) acc[g] = fmaf(ss[g][j], vv, acc[g]);
    }
    __syncthreads();                   // ss, Ks and Vs are rewritten by the next tile
  }

  // ---- fold the threads that share a column, then write the partials ----------
#pragma unroll
  for (int g = 0; g < DEC_GMAX; ++g)
    if (g < G) red[g * DEC_THREADS + tid] = acc[g];
  __syncthreads();
  if (part == 0) {
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) a += red[g * DEC_THREADS + p * D + col];
      const long long row = (long long)(group * G + g) * splits + split;
      acc_out[row * D + col] = a;
    }
  }
  if (tid < G) {
    const long long row = (long long)(group * G + tid) * splits + split;
    m_out[row] = m_s[tid];
    l_out[row] = l_s[tid];
  }
}

// Log-sum-exp combine of the per-split partials: one block per query head,
// one thread per output column.
__global__ void decode_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                                      const float* __restrict__ acc, void* __restrict__ out,
                                      int splits, int d, int out_bf16) {
  const int bh = blockIdx.x;
  const int col = threadIdx.x;
  if (col >= d) return;
  const float* mb = m + (long long)bh * splits;
  const float* lb = l + (long long)bh * splits;
  const float* ab = acc + (long long)bh * splits * d;
  float m_g = NEG_INF;
  for (int s = 0; s < splits; ++s) m_g = fmaxf(m_g, mb[s]);
  float l_g = 0.f;
  float a_g = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float scale = expf(mb[s] - m_g);
    l_g = fmaf(lb[s], scale, l_g);
    a_g = fmaf(ab[(long long)s * d + col], scale, a_g);
  }
  if (l_g == 0.f) l_g = 1.f;
  const float r = a_g / l_g;
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[(long long)bh * d + col] = __float2bfloat16(r);
  } else {
    reinterpret_cast<float*>(out)[(long long)bh * d + col] = r;
  }
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, float* m, float* l, float* acc,
                  int n_groups, int G, int hkv, int d, int kv_len, int splits, long long k_sb,
                  long long k_sh, long long k_st, long long v_sb, long long v_sh,
                  long long v_st, float sm_scale, int vec_ok, cudaStream_t s) {
  if (G < 1 || G > DEC_GMAX || splits < 1) return -1;
  dim3 grid(n_groups, splits);
#define REPRO_DEC_CASE(D_)                                                                 \
  if (d == D_) {                                                                           \
    auto kern = decode_partials_kernel<T, D_>;                                             \
    constexpr int smem = decode_smem_bytes<T, D_>();                                       \
    cudaError_t err =                                                                      \
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);     \
    if (err != cudaSuccess) return (int)err;                                               \
    kern<<<grid, DEC_THREADS, smem, s>>>(                                                  \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), m, l, \
        acc, G, hkv, kv_len, splits, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale,         \
        vec_ok);                                                                           \
    return (int)cudaGetLastError();                                                        \
  }
  REPRO_DEC_CASE(32)
  REPRO_DEC_CASE(64)
  REPRO_DEC_CASE(128)
#undef REPRO_DEC_CASE
  return -1;
}

}  // namespace repro

// Plain C interface: no allocation, no synchronisation; each function
// launches on the stream it is handed and returns cudaGetLastError(), or -1
// for a shape that is not compiled (d not in {32, 64, 128}, more than 16
// query heads per kv head).
extern "C" int repro_flash_decode_partials(
    const void* q, const void* k, const void* v, void* m, void* l, void* acc, int n_groups,
    int G, int hkv, int d, int kv_len, int splits, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, float sm_scale,
    int is_bf16, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  if (is_bf16)
    return repro::launch_decode<__nv_bfloat16>(q, k, v, mf, lf, af, n_groups, G, hkv, d, kv_len,
                                               splits, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                                               sm_scale, vec_ok, s);
  return repro::launch_decode<float>(q, k, v, mf, lf, af, n_groups, G, hkv, d, kv_len, splits,
                                     k_sb, k_sh, k_st, v_sb, v_sh, v_st, sm_scale, vec_ok, s);
}

extern "C" int repro_flash_decode_combine(const void* m, const void* l, const void* acc,
                                          void* out, int BH, int splits, int d, int out_bf16,
                                          void* stream) {
  if (d < 1 || d > 1024) return -1;
  const int threads = ((d + 31) / 32) * 32;
  repro::decode_combine_kernel<<<BH, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(acc), out, splits, d, out_bf16);
  return (int)cudaGetLastError();
}
