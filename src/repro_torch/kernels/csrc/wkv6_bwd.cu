// Backward of the chunked RWKV6 WKV scan (K5-bwd) for Hopper (sm_90a).
//
// The TPU kernel `_wkv6_kernel` / `wkv6` of src/repro/kernels/rwkv6.py has
// no backward (jax.grad cannot go through its Pallas call; the reference
// trains on its XLA path).  This kernel is the gradient of csrc/wkv6.cu's
// function.  Per head, with S_t = diag(w_t) S_{t-1} + k_t v_t^T and
// o_t = r_t^T S_{t-1} + (sum_i r_t u k_t) v_t, the state's gradient
// G_{t-1} = diag(w_t) G_t + r_t dO_t^T runs backward from G_T = 0.  Chunk by
// chunk, in wkv6.cu's notation (A = r e^{cum_excl}, RS = r e^{cum_excl - c},
// KS = k e^{c - cum}, KC = k e^{last - cum}, P = tril(RS KS^T, -1)), with
// dP = tril(dO v^T, -1) and db_t = dO_t . v_t, a chunk with start state S0
// and end-state gradient G1 gives
//
//     dr = (dO S0^T) e^{cum_excl} + (dP KS) e^{cum_excl - c} + u k db
//     dk = (v G1^T) e^{last - cum} + (dP^T RS) e^{c - cum} + u r db
//     dv = KC G1 + P^T dO + (sum_i r u k) dO
//     G0 = e^{last} G1 + A^T dO,      du = sum_t r k db,
//
// and with dr' = dr - u k db, dk' = dk - u r db the log-decay's gradient is
// a suffix sum over the whole sequence, exclusive on r, inclusive on k:
//
//     dlog_w[s] = sum_{t > s} r_t dr'_t - sum_{t >= s} k_t dk'_t.
//
// One block of WKVB_THREADS threads owns one (batch x head) row, as in the
// forward, and makes two sweeps over its chunks; nothing is stored per
// chunk, so the forward and its serving launch stay as they are.
//
//   sweep 1, forward:  recompute S chunk by chunk (S <- e^{last} S + KC^T v)
//                      and write dr; r dr' goes to a float32 scratch row;
//   sweep 2, backward: carry G from the last chunk to the first, write dk
//                      and dv, and fold dlog_w as a running suffix sum of
//                      r dr' (read back from the scratch) and k dk'; du
//                      stays in registers until the end.
//
// Each chunk is staged in shared memory as float32 (rows padded to d + 4
// floats): the loads and the decay scan (one thread per channel), then the
// pairwise products dO v^T (and RS KS^T in sweep 2), then the (C x d) and
// (d x d) products, each thread four outputs or a 4 x 4 tile read as
// float4, with the state (or its gradient) double-buffered so that the
// update runs beside the products that read it.  Where a thread's four
// outputs each need a whole row of the state, they are rows q, q + d/4,
// q + d/2, q + 3d/4: neighbouring threads then read neighbouring rows,
// which lie in other banks (four consecutive rows 4 apart would share
// two).  No atomics: the result
// repeats bit for bit.  A masked entry of P or dP is never computed or
// read: the loops over pairs run over s < t only, because at chunk 32 a
// masked product's two factors overflow float32.
//
// What bounds it on an H100: at rwkv6-3b's training shape (160 rows, T 512,
// d 64, chunk 16, bf16) the chunked backward needs about 3.75 GFLOP in
// float32 (five (C x d)(d x d) products and five over the chunk's pairs a
// chunk; 0.056 ms at 67 TFLOP/s) and moves 94 MB (0.028 ms at 3.35 TB/s):
// operations.  All products are float32 FMAs on the CUDA cores, as the
// float32 tolerance needs (no TF32).  This first kernel is simple: one
// channel's decay scan is serial over the chunk, every product reads both
// operands from shared memory, and each chunk waits for its own loads; it
// takes about 0.67 ms there (H100 SXM, 700 W), shared-memory bound.
#include "common.cuh"

namespace repro {

constexpr int WKVB_THREADS = 256;
constexpr int WKVB_CMAX = 32;     // longest chunk the buffers hold

// Dynamic shared memory of one block, in floats, for head dimension d and a
// chunk of c steps (mirrored by rwkv6_bwd.wkv6_bwd_smem_bytes): the state
// (or its gradient) in two buffers, fourteen chunk-sized arrays, P and dP,
// db and the bonus sums, e^{last} and u.  Everything read as float4 comes
// first, so it stays 16-byte aligned for any c.
__host__ __device__ constexpr int wkv6_bwd_smem_floats(int d, int c) {
  return 2 * d * (d + 4) + 14 * c * (d + 4) + 2 * c * c + 2 * c + 2 * d;
}

namespace {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ void put4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]), hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

}  // namespace

// Two blocks an SM at chunk 16 (98 KB of shared memory each at d 64), so
// registers are capped at 128.
template <typename T, int D>
__global__ void __launch_bounds__(WKVB_THREADS, 2)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ lw, const T* __restrict__ u, const T* __restrict__ dout,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dlw, T* __restrict__ du, float* __restrict__ rdr,
                int T_len, int C) {
  constexpr int NT = WKVB_THREADS;
  constexpr int LD = D + 4;                          // padded float row
  constexpr int G4 = D / 4;                          // 4-wide column groups of a row
  static_assert(D % 16 == 0 && D < NT, "head dim 16, 32 or 64");

  extern __shared__ __align__(16) float wkvb_smem[];
  const int CL = C * LD;                             // one chunk-sized array
  float* Sb = wkvb_smem;                             // 2 x D x LD: S (sweep 1) or G (sweep 2)
  float* R = Sb + 2 * D * LD;
  float* K = R + CL;
  float* V = K + CL;
  float* DO = V + CL;
  float* E1 = DO + CL;                               // e^{cum_excl}
  float* E2 = E1 + CL;                               // e^{cum_excl - c}
  float* E3 = E2 + CL;                               // e^{c - cum}
  float* E4 = E3 + CL;                               // e^{last - cum}
  float* A = E4 + CL;                                // r e^{cum_excl}
  float* RS = A + CL;                                // r e^{cum_excl - c}
  float* KS = RS + CL;                               // k e^{c - cum}
  float* KC = KS + CL;                               // k e^{last - cum}
  float* AD = KC + CL;                               // r dr' (sweep 2, from the scratch)
  float* BK = AD + CL;                               // k dk' (sweep 2)
  float* P = BK + CL;                                // C x C: RS KS^T, below the diagonal
  float* DP = P + C * C;                             // C x C: dO v^T, below the diagonal
  float* DB = DP + C * C;                            // C: dO_t . v_t
  float* DG = DB + C;                                // C: sum_i r u k
  float* EL = DG + C;                                // D: e^{last}
  float* U = EL + D;                                 // D

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long base = row * T_len * D;
  const int NC = T_len / C;

  for (int i = tid; i < D; i += NT) U[i] = to_float(u[row * D + i]);
  for (int e = tid; e < D * LD; e += NT) Sb[e] = 0.f;       // S before chunk 0, buffer 0

  // Stage the chunk at time offset `off` (every thread): r, k, log w (in
  // E2's slot until the scan), v, dO, and r dr' in sweep 2.
  auto load_chunk = [&](long long off, bool sweep2) {
    for (int e = tid; e < C * D; e += NT) {
      const int x = (e / D) * LD + e % D;
      R[x] = to_float(r[off + e]);
      K[x] = to_float(k[off + e]);
      E2[x] = to_float(lw[off + e]);
      V[x] = to_float(v[off + e]);
      DO[x] = to_float(dout[off + e]);
      if (sweep2) AD[x] = rdr[off + e];
    }
  };

  // The decay scan of channel i (one thread each) and the scaled copies.
  auto scan = [&](int i) {
    float last = 0.f;
    for (int t = 0; t < C; ++t) last += E2[t * LD + i];
    const float c_off = 0.5f * last;
    float excl = 0.f;
    for (int t = 0; t < C; ++t) {
      const int x = t * LD + i;
      const float cum = excl + E2[x];
      const float e1 = expf(excl), e2 = expf(excl - c_off);
      const float e3 = expf(c_off - cum), e4 = expf(last - cum);
      E1[x] = e1;
      E2[x] = e2;
      E3[x] = e3;
      E4[x] = e4;
      A[x] = R[x] * e1;
      RS[x] = R[x] * e2;
      KS[x] = K[x] * e3;
      KC[x] = K[x] * e4;
      excl = cum;
    }
    EL[i] = expf(last);
  };

  // On the threads that do not scan: dO_t . v_s for s < t and db_t, and in
  // sweep 2 the bonus sums.  Four partial sums break the chain of FMAs.
  auto pairs = [&](bool sweep2) {
    for (int e = tid - D; e < C * C; e += NT - D) {
      const int t = e / C, s = e % C;
      if (s > t) continue;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < D; j += 4) {
        const float4 x = ld4(DO + t * LD + j), y = ld4(V + s * LD + j);
        a0 = fmaf(x.x, y.x, a0);
        a1 = fmaf(x.y, y.y, a1);
        a2 = fmaf(x.z, y.z, a2);
        a3 = fmaf(x.w, y.w, a3);
      }
      const float dp = (a0 + a1) + (a2 + a3);
      if (s < t) {
        DP[e] = dp;
      } else {
        DB[t] = dp;
        if (sweep2) {
          float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
          for (int i = 0; i < D; i += 4) {
            const float4 x = ld4(R + t * LD + i), y = ld4(K + t * LD + i), w = ld4(U + i);
            b0 = fmaf(x.x * w.x, y.x, b0);
            b1 = fmaf(x.y * w.y, y.y, b1);
            b2 = fmaf(x.z * w.z, y.z, b2);
            b3 = fmaf(x.w * w.w, y.w, b3);
          }
          DG[t] = (b0 + b1) + (b2 + b3);
        }
      }
    }
  };

  // Sweep 2, after the scan: the scores RS_t . KS_s for s < t.
  auto scores = [&]() {
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e % C;
      if (s >= t) continue;
      float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 x = ld4(RS + t * LD + i), y = ld4(KS + s * LD + i);
        b0 = fmaf(x.x, y.x, b0);
        b1 = fmaf(x.y, y.y, b1);
        b2 = fmaf(x.z, y.z, b2);
        b3 = fmaf(x.w, y.w, b3);
      }
      P[e] = (b0 + b1) + (b2 + b3);
    }
  };

  // ---- sweep 1: forward over the chunks, dr ------------------------------------
  int cur = 0;
  for (int n = 0; n < NC; ++n) {
    const long long off = base + (long long)n * C * D;
    load_chunk(off, false);
    __syncthreads();
    if (tid < D) scan(tid);
    else pairs(false);
    __syncthreads();
    const float* Sc = Sb + cur * D * LD;
    float* Sn = Sb + (cur ^ 1) * D * LD;
    for (int task = tid; task < C * G4; task += NT) {    // dr; rows i = q + a G4
      const int t = task / G4, q = task % G4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, intra[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < D; j += 4) {
        const float4 d4 = ld4(DO + t * LD + j);
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a] = dot4(d4, ld4(Sc + (q + a * G4) * LD + j), acc[a]);
      }
      for (int s = 0; s < t; ++s) {                  // strictly below the diagonal
        const float p = DP[t * C + s];
#pragma unroll
        for (int a = 0; a < 4; ++a) intra[a] = fmaf(p, KS[s * LD + q + a * G4], intra[a]);
      }
      const float db = DB[t];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = q + a * G4, x = t * LD + i;
        const float drp = fmaf(acc[a], E1[x], intra[a] * E2[x]);   // dr'
        dr[off + (long long)t * D + i] = from_float<T>(fmaf(U[i] * K[x], db, drp));
        rdr[off + (long long)t * D + i] = R[x] * drp;
      }
    }
    for (int task = tid; task < G4 * G4; task += NT) {   // S <- e^{last} S + KC^T v
      const int i0 = 4 * (task / G4), j0 = 4 * (task % G4);
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float el = EL[i0 + a];
        const float4 s4 = ld4(Sc + (i0 + a) * LD + j0);
        acc[a][0] = el * s4.x;
        acc[a][1] = el * s4.y;
        acc[a][2] = el * s4.z;
        acc[a][3] = el * s4.w;
      }
      for (int s = 0; s < C; ++s) {
        const float4 kc = ld4(KC + s * LD + i0), vv = ld4(V + s * LD + j0);
        const float ka[4] = {kc.x, kc.y, kc.z, kc.w}, vb[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ka[a], vb[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) put4(Sn + (i0 + a) * LD + j0, acc[a]);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- sweep 2: backward over the chunks, dk, dv, dlog_w, du ---------------------
  for (int e = tid; e < D * LD; e += NT) Sb[e] = 0.f;       // G after the last chunk
  cur = 0;
  float run_a = 0.f, run_b = 0.f, du_acc = 0.f;     // channel tid's sums (tid < D)
  __syncthreads();
  for (int n = NC - 1; n >= 0; --n) {
    const long long off = base + (long long)n * C * D;
    load_chunk(off, true);
    __syncthreads();
    if (tid < D) scan(tid);
    else pairs(true);
    __syncthreads();
    scores();
    __syncthreads();
    const float* Gc = Sb + cur * D * LD;
    float* Gn = Sb + (cur ^ 1) * D * LD;
    for (int task = tid; task < C * G4; task += NT) {    // dk; rows i = q + a G4
      const int s = task / G4, q = task % G4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, intra[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < D; j += 4) {
        const float4 v4 = ld4(V + s * LD + j);
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a] = dot4(v4, ld4(Gc + (q + a * G4) * LD + j), acc[a]);
      }
      for (int t = s + 1; t < C; ++t) {              // strictly below the diagonal
        const float p = DP[t * C + s];
#pragma unroll
        for (int a = 0; a < 4; ++a) intra[a] = fmaf(p, RS[t * LD + q + a * G4], intra[a]);
      }
      const float db = DB[s];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = q + a * G4, x = s * LD + i;
        const float dkp = fmaf(acc[a], E4[x], intra[a] * E3[x]);  // dk'
        dk[off + (long long)s * D + i] = from_float<T>(fmaf(U[i] * R[x], db, dkp));
        BK[x] = K[x] * dkp;
      }
    }
    for (int task = tid; task < C * G4; task += NT) {    // dv
      const int s = task / G4, j0 = 4 * (task % G4);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int i = 0; i < D; i += 4) {
        const float4 kc = ld4(KC + s * LD + i);
        const float ka[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 g = ld4(Gc + (i + q) * LD + j0);
          acc[0] = fmaf(ka[q], g.x, acc[0]);
          acc[1] = fmaf(ka[q], g.y, acc[1]);
          acc[2] = fmaf(ka[q], g.z, acc[2]);
          acc[3] = fmaf(ka[q], g.w, acc[3]);
        }
      }
      for (int t = s + 1; t < C; ++t) {
        const float p = P[t * C + s];
        const float4 d4 = ld4(DO + t * LD + j0);
        acc[0] = fmaf(p, d4.x, acc[0]);
        acc[1] = fmaf(p, d4.y, acc[1]);
        acc[2] = fmaf(p, d4.z, acc[2]);
        acc[3] = fmaf(p, d4.w, acc[3]);
      }
      const float dg = DG[s];
      const float4 d4 = ld4(DO + s * LD + j0);
      acc[0] = fmaf(dg, d4.x, acc[0]);
      acc[1] = fmaf(dg, d4.y, acc[1]);
      acc[2] = fmaf(dg, d4.z, acc[2]);
      acc[3] = fmaf(dg, d4.w, acc[3]);
      put4(dv + off + (long long)s * D + j0, acc);
    }
    for (int task = tid; task < G4 * G4; task += NT) {   // G <- e^{last} G + A^T dO
      const int i0 = 4 * (task / G4), j0 = 4 * (task % G4);
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float el = EL[i0 + a];
        const float4 g4 = ld4(Gc + (i0 + a) * LD + j0);
        acc[a][0] = el * g4.x;
        acc[a][1] = el * g4.y;
        acc[a][2] = el * g4.z;
        acc[a][3] = el * g4.w;
      }
      for (int t = 0; t < C; ++t) {
        const float4 a4 = ld4(A + t * LD + i0), d4 = ld4(DO + t * LD + j0);
        const float aa[4] = {a4.x, a4.y, a4.z, a4.w}, db4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(aa[a], db4[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) put4(Gn + (i0 + a) * LD + j0, acc[a]);
    }
    __syncthreads();
    if (tid < D) {                                   // the suffix sums, last step first
      const int i = tid;
      for (int t = C - 1; t >= 0; --t) {
        const int x = t * LD + i;
        run_b += BK[x];                              // inclusive on k
        dlw[off + (long long)t * D + i] = from_float<T>(run_a - run_b);
        run_a += AD[x];                              // exclusive on r
        du_acc = fmaf(R[x] * K[x], DB[t], du_acc);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  if (tid < D) du[row * D + tid] = from_float<T>(du_acc);
}

template <typename T>
int launch_wkv6_bwd(const void* r, const void* k, const void* v, const void* lw,
                    const void* u, const void* dout, void* dr, void* dk, void* dv, void* dlw,
                    void* du, float* rdr, int BH, int T_len, int d, int chunk, cudaStream_t s) {
  if (chunk < 1 || chunk > WKVB_CMAX || T_len < 1 || T_len % chunk || BH < 1) return -1;
#define REPRO_WKVB_CASE(D_)                                                                 \
  if (d == D_) {                                                                            \
    auto kern = wkv6_bwd_kernel<T, D_>;                                                     \
    const int smem = wkv6_bwd_smem_floats(D_, chunk) * (int)sizeof(float);                  \
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                           wkv6_bwd_smem_floats(D_, WKVB_CMAX) * (int)sizeof(float)); \
    if (err != cudaSuccess) return (int)err;                                                \
    kern<<<BH, WKVB_THREADS, smem, s>>>(                                                    \
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),       \
        static_cast<const T*>(lw), static_cast<const T*>(u), static_cast<const T*>(dout),   \
        static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),                      \
        static_cast<T*>(dlw), static_cast<T*>(du), rdr, T_len, chunk);                      \
    return (int)cudaGetLastError();                                                         \
  }
  REPRO_WKVB_CASE(16)
  REPRO_WKVB_CASE(32)
  REPRO_WKVB_CASE(64)
#undef REPRO_WKVB_CASE
  return -1;
}

}  // namespace repro

// Plain C interface: no allocation, no synchronisation; launches on the
// stream it is handed and returns cudaGetLastError(), or -1 for a shape that
// is not compiled (d not in {16, 32, 64}, a chunk outside [1, 32] or one
// that does not divide T).  `scratch` is a float32 (BH, T, d) buffer the
// kernel writes and reads back (r dr').
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* lw,
                              const void* u, const void* dout, void* dr, void* dk, void* dv,
                              void* dlw, void* du, void* scratch, int BH, int T, int d,
                              int chunk, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rdr = static_cast<float*>(scratch);
  if (is_bf16)
    return repro::launch_wkv6_bwd<__nv_bfloat16>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du, rdr,
                                                 BH, T, d, chunk, s);
  return repro::launch_wkv6_bwd<float>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du, rdr, BH, T, d,
                                       chunk, s);
}

// Dynamic shared memory of one block for head dimension d and a chunk of c
// steps (mirrored by rwkv6_bwd.wkv6_bwd_smem_bytes).
extern "C" int repro_wkv6_bwd_smem_bytes(int d, int chunk) {
  return repro::wkv6_bwd_smem_floats(d, chunk) * (int)sizeof(float);
}
