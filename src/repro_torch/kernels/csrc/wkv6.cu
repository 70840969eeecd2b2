// Chunked RWKV6 WKV scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6` of
// src/repro/kernels/rwkv6.py.  Per head (state S in R^{d x d}, key index i,
// value index j) the recurrence is
//
//     o_t[j]   = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//     S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j],
//
// computed chunk by chunk as the TPU kernel does: with cum the inclusive
// cumsum of log w over the chunk and c = cum[C-1] / 2 a per-channel midpoint,
//
//     o   = (r e^{cum_excl}) S + tril((r e^{cum_excl - c}) (k e^{c - cum})^T, -1) v
//           + (sum_i r u k) v
//     S  <- e^{cum[C-1]} S + (k e^{cum[C-1] - cum})^T v.
//
// On the TPU the chunk axis is a sequential grid axis and the state lives in
// VMEM scratch.  Here one block of WKV_THREADS threads owns one (batch x
// head) row for its whole life: each head's chunk-local work is done once
// (160 blocks at the served shape, two to an SM), and the chunks run as a
// software pipeline in which only the state-carrying work is serial.  Per
// chunk m the work falls into four stages, each needing only the one before:
//
//   L1a(m)  load r, k, log w into registers; each thread sums log w over its
//           share of the chunk's steps for one channel;
//   L1b(m)  the decay scan: prefix of the shares (shared memory), then the
//           scaled copies A = r e^{cum_excl}, RS, KS, KC, r u k and e^{last};
//   L2(m)   the scores RS KS^T (strictly lower triangle only) and the bonus
//           sums sum_i r u k;
//   ST(m)   o = A S + SC v + diag v from the carried state S, and the state
//           update S <- e^{last} S + KC^T v.
//
// Iteration n runs ST(n), L2(n + 1), L1b(n + 2) and L1a(n + 3), while v of
// chunk n + 1 and r, k, log w of chunk n + 3 arrive in registers, behind one
// barrier: each stage reads only what the previous iteration wrote, in
// ring buffers of shared memory (three slots where a value lives two
// iterations, two where it lives one).  So the serial path from one state to
// the next is ST alone, and a chunk costs one barrier instead of five.
//
// What bounds it on an H100: at the served shape (160 heads, T 512, d 64,
// chunk 16) the function moves 55 MB (0.016 ms at 3.35 TB/s) and does
// 1.68 GFLOP, 0.025 ms at the float32 rate: operations.  All products run in
// float32 on the CUDA cores (FMA), as the reference's tolerance of 2e-3 in
// float32 needs; nothing goes through TF32.  Every product is register
// tiled and reads its operands as float4 from rows padded to d + 4 floats.
// The products read shared memory more than they compute: a 128-bit shared
// load takes four wavefronts, broadcast or not, and at 4 outputs a thread
// one float4 of A and four of S feed 16 FMAs.  So ST splits the block:
// warps 0-3 own the outputs, 4 columns of two rows each (six loads feed 32
// FMAs), and warps 4-7 own the state, a 4 x 8 tile each kept in registers
// from chunk to chunk (three loads feed 32), and then compute L2.  Larger
// output tiles, with the sum over i split across lanes, were slower at the
// 128-register cap that two blocks an SM impose.  The chunk bound CM (16 or
// 32) is a template parameter, so the served chunk of 16 keeps no registers
// for 32 steps.
//
// A masked score (s >= t) is never computed: its two factors may reach
// e^{C * 4 / 2} each, whose product overflows float32 at chunk 32.
//
// The scan starts from zero, or from a float32 initial state (BH, d, d)
// when `state0` is not null: the state buffer of chunk -1 and the state
// warps' registers load it where they would write zeros.  A sequence split
// over ranks scans each rank's block from the state the earlier blocks
// leave (models/rwkv6.py); a null pointer runs the zero start as before.
#include "common.cuh"

namespace repro {

constexpr int WKV_THREADS = 256;
constexpr int WKV_CMAX = 32;     // longest chunk the buffers hold

// Dynamic shared memory of one block, in floats, for head dimension d and a
// chunk of c steps (rows padded to d + 4; mirrored by rwkv6.wkv6_smem_bytes): the state in two buffers; A and
// KC in three slots; RS, KS, r u k and v in two; then the scores, the bonus
// sums, the decays, the partial sums of log w and u.
__host__ __device__ constexpr int wkv6_smem_floats(int d, int c) {
  return 2 * d * (d + 4) + 14 * c * (d + 4) + 2 * c * c + 2 * c + 3 * d + 2 * WKV_THREADS + d;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

// Two blocks an SM at chunk 16 (101 KB of shared memory each at d 64), so
// registers are capped at 128; one at chunk 32 (168 KB), which needs more.
template <typename T, int D, int CM>
__global__ void __launch_bounds__(WKV_THREADS, CM <= 16 ? 2 : 1)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ lw, const T* __restrict__ u, T* __restrict__ o,
            const float* __restrict__ state0, float* __restrict__ state_out, int T_len, int C) {
  constexpr int NT = WKV_THREADS;
  constexpr int HALF = NT / 2;                       // output threads; the rest carry the state
  constexpr int LD = D + 4;                          // padded float row
  constexpr int CG = D / 4;                          // 4-column groups of an output row
  constexpr int RP = HALF / CG;                      // output rows the output threads cover at once
  constexpr int RPT = (CM + RP - 1) / RP;            // output rows a thread owns
  constexpr int SCT = D / 8;                         // 8-column tiles of the state
  constexpr int Q = NT / D;                          // threads that share a channel's scan
  constexpr int TQMAX = (CM + Q - 1) / Q;            // steps one of them takes
  constexpr int PV = (CM * D + NT - 1) / NT;         // v elements a thread loads
  constexpr int NP = (CM * CM + HALF - 1) / HALF;    // score pairs a state thread takes
  static_assert(D % 16 == 0 && (D / 4) * SCT <= HALF && NT % D == 0, "head dim 16, 32 or 64");

  extern __shared__ __align__(16) float wkv_smem[];
  const int CL = C * LD;                             // one chunk-sized array
  float* Sb = wkv_smem;                              // 2 x D x LD: S after chunk m in m & 1
  float* Ab = Sb + 2 * D * LD;                       // 3 slots: r e^{cum_excl}
  float* KCb = Ab + 3 * CL;                          // 3 slots: k e^{last - cum}
  float* RSb = KCb + 3 * CL;                         // 2 slots: r e^{cum_excl - c}
  float* KSb = RSb + 2 * CL;                         // 2 slots: k e^{c - cum}
  float* RKUb = KSb + 2 * CL;                        // 2 slots: r u k
  float* Vb = RKUb + 2 * CL;                         // 2 slots: v
  float* SCb = Vb + 2 * CL;                          // 2 x C x C: scores below the diagonal
  float* diagb = SCb + 2 * C * C;                    // 2 x C: sum_i r u k
  float* decayb = diagb + 2 * C;                     // 3 x D: e^{last}
  float* totb = decayb + 3 * D;                      // 2 x NT: a thread's sum of log w
  float* U = totb + 2 * NT;                          // D

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * T_len * D;
  const int NC = T_len / C;

  for (int i = tid; i < D; i += NT) U[i] = to_float(u[(long long)blockIdx.x * D + i]);
  const float* S0 = state0 ? state0 + (long long)blockIdx.x * D * D : nullptr;
  for (int e = tid; e < D * LD; e += NT)                          // S_{-1}: buffer 1
    Sb[D * LD + e] = S0 && e % LD < D ? S0[(e / LD) * D + e % LD] : 0.f;

  // the decay scan: channel li, steps [lt0, lt0 + TQ) of the chunk
  const int li = tid % D;
  const int lq = tid / D;
  const int TQ = (C + Q - 1) / Q;
  const int lt0 = lq * TQ;
  // warps 0-3 write the outputs: columns oj0 .. oj0 + 3 of rows ort, ort + RP, ...
  const bool out_warp = tid < HALF;
  const int oj0 = 4 * (tid % CG);
  const int ort = tid / CG;
  // warps 4-7 carry the state: rows si0 .. si0 + 3, columns sj0 .. sj0 + 7
  const int sid = tid - HALF;
  const bool s_owner = !out_warp && sid < (D / 4) * SCT;
  const int si0 = 4 * (sid / SCT);
  const int sj0 = 8 * (sid % SCT);
  float Sr[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) Sr[a][b] = 0.f;
  if (S0 && s_owner) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) Sr[a][b] = S0[(si0 + a) * D + sj0 + b];
  }

  T raw_r[TQMAX], raw_k[TQMAX], raw_w[TQMAX];        // chunk n + 3, arriving
  float xr[TQMAX], xk[TQMAX], xcl[TQMAX];            // after L1a: r, k, local cumsum of log w
  T raw_v[PV];                                       // chunk n + 1, arriving
  __syncthreads();

  for (int n = -3; n < NC; ++n) {
    const int mr = n + 3;                            // chunk whose r, k, log w arrive
    const int mv = n + 1;                            // chunk whose v arrives
    if (mr < NC) {
      const long long off = base + (long long)mr * C * D + li;
#pragma unroll
      for (int e = 0; e < TQMAX; ++e) {
        const int t = lt0 + e;
        if (e < TQ && t < C) {
          raw_r[e] = r[off + (long long)t * D];
          raw_k[e] = k[off + (long long)t * D];
          raw_w[e] = lw[off + (long long)t * D];
        }
      }
    }
    if (mv >= 0 && mv < NC) {
      const long long off = base + (long long)mv * C * D;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        const int e = tid + p * NT;
        if (e < C * D) raw_v[p] = v[off + e];
      }
    }

    // ---- ST(n): outputs from the carried state, then the state update ------------
    if (n >= 0) {
      const float* A = Ab + (n % 3) * CL;
      const float* KC = KCb + (n % 3) * CL;
      const float* V = Vb + (n & 1) * CL;
      const float* SC = SCb + (n & 1) * C * C;
      const float* dg = diagb + (n & 1) * C;
      const float* dec = decayb + (n % 3) * D;
      const float* Sp = Sb + ((n - 1) & 1) * D * LD;
      float* Sn = Sb + (n & 1) * D * LD;

      if (out_warp) {
        float acc[RPT][4];
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
#pragma unroll
        for (int i = 0; i < D; i += 4) {
          const float4 s0 = *reinterpret_cast<const float4*>(Sp + (i + 0) * LD + oj0);
          const float4 s1 = *reinterpret_cast<const float4*>(Sp + (i + 1) * LD + oj0);
          const float4 s2 = *reinterpret_cast<const float4*>(Sp + (i + 2) * LD + oj0);
          const float4 s3 = *reinterpret_cast<const float4*>(Sp + (i + 3) * LD + oj0);
#pragma unroll
          for (int q = 0; q < RPT; ++q) {
            const int t = ort + q * RP;
            if (t < C) {
              const float4 a = *reinterpret_cast<const float4*>(A + t * LD + i);
              acc[q][0] = fmaf(a.x, s0.x, fmaf(a.y, s1.x, fmaf(a.z, s2.x, fmaf(a.w, s3.x, acc[q][0]))));
              acc[q][1] = fmaf(a.x, s0.y, fmaf(a.y, s1.y, fmaf(a.z, s2.y, fmaf(a.w, s3.y, acc[q][1]))));
              acc[q][2] = fmaf(a.x, s0.z, fmaf(a.y, s1.z, fmaf(a.z, s2.z, fmaf(a.w, s3.z, acc[q][2]))));
              acc[q][3] = fmaf(a.x, s0.w, fmaf(a.y, s1.w, fmaf(a.z, s2.w, fmaf(a.w, s3.w, acc[q][3]))));
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int t = ort + q * RP;
          if (t < C) {
            for (int s = 0; s < t; ++s) {            // strictly below the diagonal
              const float sc = SC[t * C + s];
              const float4 vv = *reinterpret_cast<const float4*>(V + s * LD + oj0);
              acc[q][0] = fmaf(sc, vv.x, acc[q][0]);
              acc[q][1] = fmaf(sc, vv.y, acc[q][1]);
              acc[q][2] = fmaf(sc, vv.z, acc[q][2]);
              acc[q][3] = fmaf(sc, vv.w, acc[q][3]);
            }
            const float dt = dg[t];
            const float4 vt = *reinterpret_cast<const float4*>(V + t * LD + oj0);
            store4(o + base + (long long)(n * C + t) * D + oj0, fmaf(dt, vt.x, acc[q][0]),
                   fmaf(dt, vt.y, acc[q][1]), fmaf(dt, vt.z, acc[q][2]),
                   fmaf(dt, vt.w, acc[q][3]));
          }
        }
      } else if (s_owner) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float dcy = dec[si0 + a];
#pragma unroll
          for (int b = 0; b < 8; ++b) Sr[a][b] *= dcy;
        }
        for (int s = 0; s < C; ++s) {
          const float4 kc = *reinterpret_cast<const float4*>(KC + s * LD + si0);
          const float4 v0 = *reinterpret_cast<const float4*>(V + s * LD + sj0);
          const float4 v1 = *reinterpret_cast<const float4*>(V + s * LD + sj0 + 4);
          const float ka[4] = {kc.x, kc.y, kc.z, kc.w};
          const float vb[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) Sr[a][b] = fmaf(ka[a], vb[b], Sr[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          store4(Sn + (si0 + a) * LD + sj0, Sr[a][0], Sr[a][1], Sr[a][2], Sr[a][3]);
          store4(Sn + (si0 + a) * LD + sj0 + 4, Sr[a][4], Sr[a][5], Sr[a][6], Sr[a][7]);
        }
      }
    }

    // ---- L2(n + 1), on the state warps: scores strictly below the diagonal,
    // and the bonus sums; four partial sums break the chain of dependent FMAs --
    const int m2 = n + 1;
    if (!out_warp && m2 >= 0 && m2 < NC) {
      const float* RS = RSb + (m2 & 1) * CL;
      const float* KS = KSb + (m2 & 1) * CL;
      const float* RKU = RKUb + (m2 & 1) * CL;
      float* SC = SCb + (m2 & 1) * C * C;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int e = sid + p * HALF;
        const int t = e / C;
        const int s = e % C;
        if (e < C * C && s <= t) {
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          if (s < t) {
#pragma unroll
            for (int i = 0; i < D; i += 4) {
              const float4 a = *reinterpret_cast<const float4*>(RS + t * LD + i);
              const float4 b = *reinterpret_cast<const float4*>(KS + s * LD + i);
              a0 = fmaf(a.x, b.x, a0);
              a1 = fmaf(a.y, b.y, a1);
              a2 = fmaf(a.z, b.z, a2);
              a3 = fmaf(a.w, b.w, a3);
            }
            SC[e] = (a0 + a1) + (a2 + a3);
          } else {
#pragma unroll
            for (int i = 0; i < D; i += 4) {
              const float4 a = *reinterpret_cast<const float4*>(RKU + t * LD + i);
              a0 += a.x;
              a1 += a.y;
              a2 += a.z;
              a3 += a.w;
            }
            diagb[(m2 & 1) * C + t] = (a0 + a1) + (a2 + a3);
          }
        }
      }
    }

    // ---- L1b(n + 2): the decay scan and the scaled copies -------------------------
    const int m1 = n + 2;
    if (m1 >= 0 && m1 < NC) {
      const float* tot = totb + (m1 & 1) * NT;
      float prefix = 0.f, last = 0.f;
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        const float x = tot[qq * D + li];
        if (qq < lq) prefix += x;
        last += x;
      }
      const float c_off = 0.5f * last;
      float* A = Ab + (m1 % 3) * CL;
      float* KC = KCb + (m1 % 3) * CL;
      float* RS = RSb + (m1 & 1) * CL;
      float* KS = KSb + (m1 & 1) * CL;
      float* RKU = RKUb + (m1 & 1) * CL;
      const float uu = U[li];
#pragma unroll
      for (int e = 0; e < TQMAX; ++e) {
        const int t = lt0 + e;
        if (e < TQ && t < C) {
          const float cum = prefix + xcl[e];                       // inclusive
          const float excl = prefix + (e > 0 ? xcl[e - 1] : 0.f);
          const int idx = t * LD + li;
          A[idx] = xr[e] * expf(excl);
          RS[idx] = xr[e] * expf(excl - c_off);
          KS[idx] = xk[e] * expf(c_off - cum);
          KC[idx] = xk[e] * expf(last - cum);
          RKU[idx] = xr[e] * uu * xk[e];
        }
      }
      if (lq == 0) decayb[(m1 % 3) * D + li] = expf(last);
    }

    // ---- L1a(n + 3): this thread's share of the chunk's log-decay sums ------------
    if (mr < NC) {
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < TQMAX; ++e) {
        if (e < TQ && lt0 + e < C) {
          run += to_float(raw_w[e]);
          xcl[e] = run;
          xr[e] = to_float(raw_r[e]);
          xk[e] = to_float(raw_k[e]);
        }
      }
      totb[(mr & 1) * NT + tid] = run;
    }
    if (mv >= 0 && mv < NC) {
      float* V = Vb + (mv & 1) * CL;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        const int e = tid + p * NT;
        if (e < C * D) V[(e / D) * LD + e % D] = to_float(raw_v[p]);
      }
    }
    __syncthreads();
  }

  // ---- the final state, straight from the registers --------------------------------
  if (s_owner) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* row = state_out + ((long long)blockIdx.x * D + si0 + a) * D + sj0;
      store4(row, Sr[a][0], Sr[a][1], Sr[a][2], Sr[a][3]);
      store4(row + 4, Sr[a][4], Sr[a][5], Sr[a][6], Sr[a][7]);
    }
  }
}

template <typename T>
int launch_wkv6(const void* r, const void* k, const void* v, const void* lw, const void* u,
                void* o, const float* state0, float* state, int BH, int T_len, int d, int chunk,
                cudaStream_t s) {
  if (chunk < 1 || chunk > WKV_CMAX || T_len < 1 || T_len % chunk || BH < 1) return -1;
#define REPRO_WKV_CASE(D_)                                                                  \
  if (d == D_) {                                                                            \
    auto kern = chunk <= 16 ? wkv6_kernel<T, D_, 16> : wkv6_kernel<T, D_, WKV_CMAX>;         \
    const int smem = wkv6_smem_floats(D_, chunk) * (int)sizeof(float);                      \
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                           wkv6_smem_floats(D_, WKV_CMAX) * (int)sizeof(float)); \
    if (err != cudaSuccess) return (int)err;                                                \
    kern<<<BH, WKV_THREADS, smem, s>>>(                                                     \
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),       \
        static_cast<const T*>(lw), static_cast<const T*>(u), static_cast<T*>(o), state0,    \
        state, T_len, chunk);                                                                    \
    return (int)cudaGetLastError();                                                         \
  }
  REPRO_WKV_CASE(16)
  REPRO_WKV_CASE(32)
  REPRO_WKV_CASE(64)
#undef REPRO_WKV_CASE
  return -1;
}

}  // namespace repro

// Plain C interface: no allocation, no synchronisation; launches on the
// stream it is handed and returns cudaGetLastError(), or -1 for a shape that
// is not compiled (d not in {16, 32, 64}, a chunk outside [1, 32] or one
// that does not divide T).  `state0` is the float32 initial state
// (BH, d, d), or null for a zero start.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* lw,
                          const void* u, void* o, const void* state0, void* state, int BH,
                          int T, int d, int chunk, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(state0);
  float* st = static_cast<float*>(state);
  if (is_bf16)
    return repro::launch_wkv6<__nv_bfloat16>(r, k, v, lw, u, o, s0, st, BH, T, d, chunk, s);
  return repro::launch_wkv6<float>(r, k, v, lw, u, o, s0, st, BH, T, d, chunk, s);
}

// Dynamic shared memory of one block for head dimension d and a chunk of c
// steps (mirrored by rwkv6.wkv6_smem_bytes).
extern "C" int repro_wkv6_smem_bytes(int d, int chunk) {
  return repro::wkv6_smem_floats(d, chunk) * (int)sizeof(float);
}
