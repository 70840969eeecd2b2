// Flash-decode (K3) at head dim 256 in bf16 for Hopper: a TMA ring of K and
// V tiles, blocks that fit two an SM, splits that fill one wave.
//
// Replaces, for every aligned bf16 call at d 256, the mma.sync body of
// flash_decode.cu stretched to d 256, and with it the TPU kernel
// `_decode_kernel` / `flash_decode_partials` of
// src/repro/kernels/flash_decode.py and its `combine_partials`.  Semantics
// are that body's: keys [0, kv_len) of a longer buffer, cut into `splits`
// strips with the ragged end masked; a strip wholly past kv_len gives
// (-1e30, 0, 0); grouped-query attention (one block serves the G <= 16 query
// heads of a kv head); K/V read in place through the cache's strided
// (batch, kv head, key, d) view; the COMBINE epilogue (`ops.flash_decode`:
// the splits of a group one cluster, folded through distributed shared
// memory, each thread's remote loads issued at once) and the PARTIALS
// epilogue (`flash_decode_partials`: float32 (m, l, acc) to device memory,
// flash_decode.cuh's).
//
// What bounds it on an H100: bytes.  gemma-7b's decode step (4 sequences x
// 16 kv heads, G 1, 513 valid keys of 545) reads 33.6 MB of K/V for 33.6
// MFLOP, 0.0101 ms at 3.35 TB/s.  The mma.sync body took 0.0376: a 160 KB
// block held one an SM, 5 splits made 320 blocks (2.4 waves in clusters of
// 5), each thread issued about 52 16-byte `cp.async` copies before any math,
// and a 16 x 256 float32 accumulator a warp left Q's fragments to be reread
// from shared memory at every k-step.  The design here:
//
// * One thread issues TMA loads (`cp.async.bulk.tensor`, 4-D maps over the
//   view with its own strides, 64-column boxes under the 128-byte swizzle,
//   four to a 256-wide row) of 32-key K and V tiles into a ring of three
//   stages, each tile with its own `full` mbarrier, so S starts before V
//   lands.  TMA zero-fills keys past the buffer; the body masks keys past
//   the strip.  A strip of any length loops the ring.
// * 113 KB a block, so two fit an SM; flash_decode.choose_splits cuts the
//   keys so that the grid fills one wave of one block an SM (gemma: 2
//   splits, 128 blocks, 257 keys a strip), which ran faster than filling
//   both slots (4 splits) on an H100 at 513 to 4,096 keys: what holds the
//   body is the card's read rate, not blocks in flight, and fewer blocks
//   pay fewer prologues and cluster folds.
// * Each of the four warps takes 8 keys of a tile for S = Q K^T
//   (`mma.sync.m16n8k16`, Q's A fragments loaded once into registers: 64 of
//   them) and 64 output columns (one V box) for O += P V, so a thread holds
//   a 16 x 64 accumulator share (32 registers) instead of 16 x 256.  The
//   warps hand their scores over through shared memory, one barrier a tile;
//   every warp then runs the same online softmax on all 32 keys (same values,
//   same operations: m and l agree across warps) and packs P as the A
//   operand of its own columns' product.  That barrier also frees the stage
//   of the tile before, so the loading thread refills it there, with no
//   `empty` mbarrier.
// * At G 1, 15 of the 16 `mma` rows are padding.  The tensor cores' share of
//   the work is then still under 1 us over the card, and one `mma` stands for
//   the 128 FMAs a CUDA-core dot product would issue a thread, so the padded
//   product issues fewer instructions than the unpadded one; one code path
//   serves G 1 to 16.
//
// Requirements, checked by the wrapper before it chooses this body (else it
// takes flash_decode.cu's): bf16, d 256, G <= 16, 16-byte-aligned q, k and v
// and k/v strides that are multiples of 8 elements.
#include <cstdint>

#include "flash_decode.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace repro {
namespace fd_tma {

using namespace sm90;
using L = DecodeTmaLayout;
using bf16 = __nv_bfloat16;

constexpr int D = L::D;
constexpr int BK = L::KEYS;
constexpr int NBOX = D / 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(DEC_THREADS == 128 && BK == 32, "four warps: 8 keys of S and one V box each");

// COMBINE: every block of the cluster writes every `splits`-th slice of the
// group's G x D outputs, folding the splits' results (m, l, acc) in split
// order as decode_epilogue does, with each element's remote loads from all
// the peers issued before the first is used (one round trip through the
// cluster, not three a split).
__device__ __forceinline__ void fold_over_cluster(const float* res, bf16* __restrict__ out,
                                                  int G, int splits) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                                    // every split's result is final
  const float* peer[DEC_MAX_CLUSTER];
#pragma unroll
  for (int s = 0; s < DEC_MAX_CLUSTER; ++s)
    peer[s] = cluster.map_shared_rank(res, s < splits ? s : 0);
  bf16* ob = out + (long long)blockIdx.x * G * D;
  for (int e = (int)cluster.block_rank() * DEC_THREADS + threadIdx.x; e < G * D;
       e += splits * DEC_THREADS) {
    const int r = e / D;
    float pm[DEC_MAX_CLUSTER], pl[DEC_MAX_CLUSTER], pa[DEC_MAX_CLUSTER];
#pragma unroll
    for (int s = 0; s < DEC_MAX_CLUSTER; ++s) {
      if (s < splits) {
        pm[s] = peer[s][r];
        pl[s] = peer[s][DEC_GMAX + r];
        pa[s] = peer[s][2 * DEC_GMAX + e];
      }
    }
    float m_g = NEG_INF;
#pragma unroll
    for (int s = 0; s < DEC_MAX_CLUSTER; ++s)
      if (s < splits) m_g = fmaxf(m_g, pm[s]);
    float l_g = 0.f, a_g = 0.f;
#pragma unroll
    for (int s = 0; s < DEC_MAX_CLUSTER; ++s) {
      if (s < splits) {
        const float scale = expf(pm[s] - m_g);
        l_g = fmaf(pl[s], scale, l_g);
        a_g = fmaf(pa[s], scale, a_g);
      }
    }
    if (l_g == 0.f) l_g = 1.f;
    ob[e] = __float2bfloat16(a_g / l_g);
  }
  cluster.sync();                    // no block leaves while a peer reads its result
}

template <bool COMBINE>
__global__ void __launch_bounds__(DEC_THREADS, L::MIN_BLOCKS)
decode_tma_kernel(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ q,
                  bf16* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, int G, int hkv, int kv_len, int splits,
                  float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + L::ALIGN - 1) & ~static_cast<uint32_t>(L::ALIGN - 1);
  unsigned char* aligned = smem_raw + (ring - raw);
  bf16* Qs = reinterpret_cast<bf16*>(aligned + L::RING_BYTES);
  float* Ss = reinterpret_cast<float*>(aligned + L::RING_BYTES + L::Q_BYTES);
  const uint32_t bars = ring + L::RING_BYTES + L::Q_BYTES + L::S_BYTES;
  auto k_tile = [&](int s) { return ring + s * 2 * L::TILE_BYTES; };
  auto v_tile = [&](int s) { return ring + s * 2 * L::TILE_BYTES + L::TILE_BYTES; };
  auto k_full = [&](int s) { return bars + 8u * s; };
  auto v_full = [&](int s) { return bars + 8u * (L::STAGES + s); };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;                  // accumulator rows g and g + 8
  const int tq = lane & 3;                  // accumulator columns 2 tq, 2 tq + 1
  const int group = blockIdx.x;             // batch * hkv + kv head
  const int split = blockIdx.y;
  // COMBINE's strips start on a tile (its splits are internal: the output
  // does not depend on where they fall), so only the last split reads past
  // its keys; PARTIALS keeps the reference's strips, whose partials are its
  // output
  int strip = (kv_len + splits - 1) / splits;
  if (COMBINE) strip = (strip + BK - 1) / BK * BK;
  const int t_begin = min(kv_len, split * strip);
  const int t_end = min(kv_len, t_begin + strip);
  const int n_tiles = (t_end - t_begin + BK - 1) / BK;

  // tile t of the strip into stage t % STAGES: four boxes of K, four of V
  auto load = [&](int t) {
    const int s = t % L::STAGES;
    const int key0 = t_begin + t * BK;
    mbar_expect_tx(k_full(s), L::TILE_BYTES);
#pragma unroll
    for (int j = 0; j < NBOX; ++j)
      tma_load_4d(k_tile(s) + j * L::BOX_BYTES, &map_k, k_full(s), 64 * j, key0, group % hkv,
                  group / hkv);
    mbar_expect_tx(v_full(s), L::TILE_BYTES);
#pragma unroll
    for (int j = 0; j < NBOX; ++j)
      tma_load_4d(v_tile(s) + j * L::BOX_BYTES, &map_v, v_full(s), 64 * j, key0, group % hkv,
                  group / hkv);
  };
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < L::STAGES && t < n_tiles; ++t) load(t);

  // the G query rows (rows G..15 zeros), then their A fragments into registers
  const bf16* qb = q + (long long)group * G * D;
  for (int i = tid; i < DEC_GMAX * (D / 8); i += DEC_THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < G) x = *reinterpret_cast<const uint4*>(qb + r * D + c);
    *reinterpret_cast<uint4*>(Qs + r * L::QLD + c) = x;
  }
  __syncthreads();
  unsigned qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], smem_addr(Qs + (lane & 15) * L::QLD + kk * 16 + (lane >> 4) * 8));

  float o[8][4];                            // rows g, g + 8 of the warp's 64 columns
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;       // running max of rows g, g + 8 (natural log)
  float l_a = 0.f, l_b = 0.f;               // this thread's share of the running sums

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::STAGES;
    const int ph = (t / L::STAGES) & 1;
    const int key0 = t_begin + t * BK;

    // ---- S = Q K^T for keys 8 warp .. 8 warp + 7 of the tile; two chains ----------
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    mbar_wait(k_full(s), ph);
    {
      const int key = warp * 8 + (lane & 7);
      const uint32_t krow = k_tile(s) + key * 128;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        // matrices: dims kk*16 + {0, 8, 16, 24} .. + 7 of the warp's 8 keys
        const int dim = kk * 16 + (lane >> 3) * 8;
        unsigned b[4];
        ldmatrix_x4(b, krow + (dim / 64) * L::BOX_BYTES + ((((dim % 64) / 8) ^ (key & 7)) << 4));
        mma_bf16(s0, qa[kk], b[0], b[1]);
        mma_bf16(s1, qa[kk + 1], b[2], b[3]);
      }
    }
    float* sb = Ss + (t & 1) * DEC_GMAX * L::SLD;
    {
      float sv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + warp * 8 + 2 * tq + (e & 1);
        sv[e] = key < t_end ? (s0[e] + s1[e]) * sm_scale : NEG_INF;   // ragged end
      }
      const int c = warp * 8 + 2 * tq;
      *reinterpret_cast<float2*>(sb + g * L::SLD + c) = make_float2(sv[0], sv[1]);
      *reinterpret_cast<float2*>(sb + (g + 8) * L::SLD + c) = make_float2(sv[2], sv[3]);
    }
    __syncthreads();                        // the tile's scores are in; tile t - 1 is done
    if (tid == 0 && t >= 1 && t - 1 + L::STAGES < n_tiles) load(t - 1 + L::STAGES);

    // ---- online softmax over the tile's 32 keys, in every warp ------------------------
    float xa[8], xb[8];                     // keys 8 j + 2 tq + {0, 1}, j = 0..3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 ya = *reinterpret_cast<const float2*>(sb + g * L::SLD + 8 * j + 2 * tq);
      const float2 yb = *reinterpret_cast<const float2*>(sb + (g + 8) * L::SLD + 8 * j + 2 * tq);
      xa[2 * j] = ya.x;
      xa[2 * j + 1] = ya.y;
      xb[2 * j] = yb.x;
      xb[2 * j + 1] = yb.y;
    }
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx_a = fmaxf(mx_a, xa[i]);
      mx_b = fmaxf(mx_b, xb[i]);
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
    for (int i = 0; i < 8; ++i) {
      xa[i] = xa[i] > 0.5f * NEG_INF ? exp2f((xa[i] - mn_a) * LOG2E) : 0.f;
      xb[i] = xb[i] > 0.5f * NEG_INF ? exp2f((xb[i] - mn_b) * LOG2E) : 0.f;
      sum_a += xa[i];
      sum_b += xb[i];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }
    // P as the A operand of the two k16 steps: keys 16 kk + 2 tq (+8)
    unsigned pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = pack_bf16(xa[4 * kk], xa[4 * kk + 1]);
      pa[kk][1] = pack_bf16(xb[4 * kk], xb[4 * kk + 1]);
      pa[kk][2] = pack_bf16(xa[4 * kk + 2], xa[4 * kk + 3]);
      pa[kk][3] = pack_bf16(xb[4 * kk + 2], xb[4 * kk + 3]);
    }

    // ---- O += P V over the warp's columns: V box `warp`, read transposed ----------
    mbar_wait(v_full(s), ph);
    const uint32_t vbox = v_tile(s) + warp * L::BOX_BYTES;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < 4; ++np) {      // 16 columns: two n8 tiles
        const int chunk = 2 * np + (lane >> 4);
        unsigned b[4];
        ldmatrix_x4_trans(b, vbox + key * 128 + ((chunk ^ (key & 7)) << 4));
        mma_bf16(o[2 * np], pa[kk], b[0], b[1]);
        mma_bf16(o[2 * np + 1], pa[kk], b[2], b[3]);
      }
    }
  }
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);

  // ---- the split's result over the ring, then the epilogue ---------------------------
  __syncthreads();                          // every warp is done with the ring
  float* res = reinterpret_cast<float*>(aligned);
  if (warp == 0 && tq == 0) {
    res[g] = m_a;
    res[g + 8] = m_b;
    res[DEC_GMAX + g] = l_a;
    res[DEC_GMAX + g + 8] = l_b;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float* row_a = res + 2 * DEC_GMAX + g * D + warp * 64 + n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(row_a) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(row_a + 8 * D) = make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();
  if constexpr (COMBINE)
    fold_over_cluster(res, out, G, splits);
  else
    decode_epilogue<D, false>(res, out, m_out, l_out, acc_out, G, splits);
}

template <bool COMBINE>
int launch(const void* q, const void* k, const void* v, void* out, float* m, float* l,
           float* acc, int n_groups, int G, int hkv, int buffer, int kv_len, int splits,
           long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
           long long v_st, float sm_scale, cudaStream_t stream) {
  if (G < 1 || G > DEC_GMAX || splits < 1 || hkv < 1 || n_groups % hkv) return -1;
  if (COMBINE && splits > DEC_MAX_CLUSTER) return -1;
  auto kern = decode_tma_kernel<COMBINE>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mk, mv;
  const int batch = n_groups / hkv;
  if (!encode_4d(&mk, k, D, buffer, hkv, batch, k_st, k_sh, k_sb, 64, BK) ||
      !encode_4d(&mv, v, D, buffer, hkv, batch, v_st, v_sh, v_sb, 64, BK))
    return -3;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_groups, splits);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = L::TOTAL;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = splits;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = COMBINE ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, mk, mv, static_cast<const bf16*>(q), static_cast<bf16*>(out),
                         m, l, acc, G, hkv, kv_len, splits, sm_scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace fd_tma
}  // namespace repro

// q (n_groups x G, 1, 256) contiguous; k/v strided (batch, kv head, key, 256)
// views of a buffer of `buffer` keys, of which [0, kv_len) take part.  With
// `out` (bf16, q's shape) both stages in one launch (the splits of a group one
// cluster, at most 8); with `out` null the float32 partials m, l (n_groups x
// G, splits) and acc (n_groups x G, splits, 256).  Returns a cudaError_t, -1
// for a shape that is not compiled, -3 when a tensor map cannot be encoded.
extern "C" int repro_flash_decode_tma(const void* q, const void* k, const void* v, void* out,
                                      void* m, void* l, void* acc, int n_groups, int G,
                                      int hkv, int buffer, int kv_len, int splits,
                                      long long k_sb, long long k_sh, long long k_st,
                                      long long v_sb, long long v_sh, long long v_st,
                                      float sm_scale, void* stream) {
  using namespace repro::fd_tma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  if (out != nullptr)
    return launch<true>(q, k, v, out, mf, lf, af, n_groups, G, hkv, buffer, kv_len, splits, k_sb,
                        k_sh, k_st, v_sb, v_sh, v_st, sm_scale, s);
  return launch<false>(q, k, v, out, mf, lf, af, n_groups, G, hkv, buffer, kv_len, splits, k_sb,
                       k_sh, k_st, v_sb, v_sh, v_st, sm_scale, s);
}

// Blocks of the TMA body the device holds an SM at once, as the runtime
// computes it (the smaller of its two epilogues' instantiations), -1 on a
// runtime error.  Held against flash_decode.TMA_BLOCKS_PER_SM on the card.
extern "C" int repro_flash_decode_tma_occupancy() {
  using namespace repro::fd_tma;
  const int a = repro::sm90::occupancy(decode_tma_kernel<true>, repro::DEC_THREADS, L::TOTAL);
  const int b = repro::sm90::occupancy(decode_tma_kernel<false>, repro::DEC_THREADS, L::TOTAL);
  return a < 0 || b < 0 ? -1 : (a < b ? a : b);
}
