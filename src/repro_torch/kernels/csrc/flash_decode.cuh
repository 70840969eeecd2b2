// Flash-decode (K3) pieces shared by its two translation units: the
// mma.sync and float32 bodies (flash_decode.cu) and the Hopper body at head
// dim 256 (flash_decode_tma.cu).  Block shape, the footprints that
// flash_decode.decode_smem_bytes() mirrors, and the two epilogues that turn a
// split's (m, l, acc) in shared memory into the kernel's output.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {

namespace cg = cooperative_groups;

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_GMAX = 16;       // most query heads one kv head may serve (mma rows)
constexpr int DEC_CHUNK = 16;      // keys a warp takes at a time: one k16 step of P V
constexpr int DEC_STAGES = 2;      // chunks each warp keeps in flight
constexpr int DEC_MAX_CLUSTER = 8; // the portable cluster size: most splits COMBINE takes
constexpr int DEC_TILE = 128;      // keys per inner tile of the float32 body: one a thread

// Keys a tile of the float32 body holds: 128, or 64 at d 256, where two
// 128-key tiles of K and V (266 KB) would not fit a block.
template <int D>
__host__ __device__ constexpr int dec_f32_tile() { return D > 128 ? 64 : DEC_TILE; }

// A split's result in shared memory: m and l per query head, then acc (G x D).
template <int D>
constexpr int decode_result_bytes() { return (2 * DEC_GMAX + DEC_GMAX * D) * 4; }

// bf16 body: Q (16 rows), each warp's ring of K and V chunks, the result.
// Rows padded by 16 bytes; mirrored by flash_decode.decode_smem_bytes().
template <int D>
struct DecodeLayout {
  static constexpr int LD = D + 8;
  static constexpr int Q_BYTES = DEC_GMAX * LD * 2;
  static constexpr int CHUNK_ELEMS = DEC_CHUNK * LD;
  static constexpr int RING_BYTES = DEC_WARPS * DEC_STAGES * 2 * CHUNK_ELEMS * 2;
  static constexpr int WLD = D + 8;  // float row of the warps' merge scratch (over Q and ring)
  static constexpr int TOTAL = Q_BYTES + RING_BYTES + decode_result_bytes<D>();
  static_assert(DEC_WARPS * (2 * DEC_GMAX + DEC_GMAX * WLD) * 4 <= Q_BYTES + RING_BYTES,
                "the warps' merge scratch reuses Q and the ring");
};

// float32 body: one K and one V tile of dec_f32_tile<D>() keys, rows padded
// by 16 bytes, then the result.  A tile of 128 keys holds a served strip (65
// keys at 8 splits) whole, so the body makes one pass.
template <int D>
constexpr int decode_f32_smem_bytes() {
  return 2 * dec_f32_tile<D>() * (D + 4) * 4 + decode_result_bytes<D>();
}

// ---- the two epilogues: `res` holds this split's m[16], l[16], acc[16][D] -----
// The group and split are read again from the block index rather than kept
// live through the body.
template <int D, bool COMBINE, typename TO>
__device__ __forceinline__ void decode_epilogue(const float* res, TO* __restrict__ out,
                                                float* __restrict__ m_out,
                                                float* __restrict__ l_out,
                                                float* __restrict__ acc_out, int G, int splits) {
  const int tid = threadIdx.x;
  const int group = blockIdx.x;
  const int split = blockIdx.y;
  if constexpr (!COMBINE) {
    for (int e = tid; e < G * D; e += DEC_THREADS) {
      const long long row = (long long)(group * G + e / D) * splits + split;
      acc_out[row * D + e % D] = res[2 * DEC_GMAX + e];
    }
    if (tid < G) {
      const long long row = (long long)(group * G + tid) * splits + split;
      m_out[row] = res[tid];
      l_out[row] = res[DEC_GMAX + tid];
    }
  } else {
    // every block of the cluster writes every `splits`-th slice of the
    // group's G x D outputs from all the splits' results
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                                    // every split's result is final
    for (int e = (int)cluster.block_rank() * DEC_THREADS + tid; e < G * D;
         e += splits * DEC_THREADS) {
      const int r = e / D;
      float m_g = NEG_INF;
      for (int s = 0; s < splits; ++s) m_g = fmaxf(m_g, cluster.map_shared_rank(res, s)[r]);
      float l_g = 0.f, a_g = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float* peer = cluster.map_shared_rank(res, s);
        const float scale = expf(peer[r] - m_g);
        l_g = fmaf(peer[DEC_GMAX + r], scale, l_g);
        a_g = fmaf(peer[2 * DEC_GMAX + e], scale, a_g);
      }
      if (l_g == 0.f) l_g = 1.f;
      out[(long long)group * G * D + e] = from_float<TO>(a_g / l_g);
    }
    cluster.sync();                    // no block leaves while a peer reads its result
  }
}

// TMA body (bf16, d 256): a ring of STAGES stages, each a K and a V tile of
// KEYS keys in four 64-column boxes under the 128-byte swizzle (16 KB each),
// the 16 query rows (padded by 16 bytes), two buffers of the tile's scores
// (rows padded by 32 bytes), two mbarriers a stage, and 1 KB to align the
// ring for the swizzle.  The split's result reuses the ring.  Two blocks fit
// an SM.
struct DecodeTmaLayout {
  static constexpr int D = 256;
  static constexpr int KEYS = 32;                    // keys a tile
  static constexpr int STAGES = 3;
  static constexpr int MIN_BLOCKS = 2;               // blocks an SM
  static constexpr int ALIGN = 1024;
  static constexpr int BOX_BYTES = KEYS * 128;       // one 64-column box of a tile
  static constexpr int TILE_BYTES = (D / 64) * BOX_BYTES;
  static constexpr int RING_BYTES = STAGES * 2 * TILE_BYTES;
  static constexpr int QLD = D + 8;
  static constexpr int Q_BYTES = DEC_GMAX * QLD * 2;
  static constexpr int SLD = KEYS + 8;
  static constexpr int S_BYTES = 2 * DEC_GMAX * SLD * 4;
  static constexpr int BAR_BYTES = 8 * 2 * STAGES;
  static constexpr int TOTAL = ALIGN + RING_BYTES + Q_BYTES + S_BYTES + BAR_BYTES;
  static_assert(decode_result_bytes<D>() <= RING_BYTES, "the split's result reuses the ring");
  static_assert(MIN_BLOCKS * (TOTAL + 1024) <= 233472, "two blocks share an SM");
};

}  // namespace repro
