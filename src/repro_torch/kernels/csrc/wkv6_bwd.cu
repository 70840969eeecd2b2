// Backward of the chunked RWKV6 WKV scan (K5-bwd) for Hopper (sm_90a).
//
// The TPU kernel `_wkv6_kernel` / `wkv6` of src/repro/kernels/rwkv6.py has
// no backward (jax.grad cannot go through its Pallas call; the reference
// trains on its XLA path).  This kernel is the gradient of csrc/wkv6.cu's
// function.  Per head, with S_t = diag(w_t) S_{t-1} + k_t v_t^T and
// o_t = r_t^T S_{t-1} + (sum_i r_t u k_t) v_t, the state's gradient
// G_{t-1} = diag(w_t) G_t + r_t dO_t^T runs backward from G_T, the final
// state's gradient (`dstate`, zero when null), to G_0, the initial state's
// (`dstate0`, written when not null; the forward starts from `state0`, zero
// when null).  Chunk by
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
// a suffix sum over the whole sequence, exclusive on r, inclusive on k,
// plus one term a channel from the end boundary (S_T the final state):
//
//     dlog_w[s][i] = sum_j S_T[i,j] G_T[i,j] + sum_{t > s} r_t dr'_t
//                    - sum_{t >= s} k_t dk'_t,
//
// since dlog_w[s][i] = sum_j G_s[i,j] w_s[i] S_{s-1}[i,j] telescopes from
// s = T.  Sweep 1 ends holding S_T's columns J in registers; with `dstate`
// each block sums S_T G_T over them, and the cluster folds the owned
// channels' sums (rank order, one more cluster barrier) into the suffix
// sum's start.  Null `state0`, `dstate` and `dstate0` run the zero-state
// path with no added work.
//
// What bounds it on an H100: at rwkv6-3b's training shape (160 rows, T 512,
// d 64, chunk 16, bf16) the chunked backward needs about 3.75 GFLOP in
// float32 (0.056 ms at 67 TFLOP/s) and moves 94 MB (0.028 ms at 3.35 TB/s):
// operations.  All products are float32 FMAs on the CUDA cores, as the
// float32 tolerance needs (no TF32).  But no row's work is large: a row
// walks its 32 chunks twice, and each chunk step is a short chain of small
// products, a decay scan and barriers.  The first kernel gave each row one
// 256-thread block, 160 blocks for 132 SMs, and took 0.67 ms, bound by one
// block's latency.  This one splits each row over 4 blocks, all resident,
// and is then bound by the SMs' throughput on that chain: clock64() marks
// of one block (wkv6_bwd_profile.py; H100 SXM, 700 W) give about 13,500
// cycles a chunk step in the forward sweep and 18,000 in the backward one,
// spread over a dozen phases, none above a fifth of it.  Most of it is shared-memory traffic
// of the small products (a thread loads one float of its v or dO row slice
// for every FMA it does, the same row as the 15 other threads of its row
// group), the decay scan that every block of a cluster repeats for all d
// channels, the cluster barrier's release (about 1,400 cycles) and the
// folds; 0.49 ms in all.
// Fewer, larger tiles a thread would read less, but the registers that six
// blocks an SM leave (80 a thread) hold only the 8 state values and a row.
//
// The recurrence separates by value column: column j of S and of G depends
// only on v[:, j] and dO[:, j].  So each row's state is split by value
// column over a thread-block cluster of NS = d / 16 blocks (4 at d 64, 2 at
// d 32, 1 at d 16), and block `rank` of the cluster
//
//  * keeps its 16 columns of S (sweep 1) and of G (sweep 2) in registers,
//    a (d x 16) slice, 8 floats a thread at d 64, and updates them element
//    by element (S[i,j] = e^{last_i} S[i,j] + sum_s KC[s,i] v[s,j]);
//  * loads the chunk's r, k and log w over all d channels (KC and A reach
//    every row of its slice) and only its 16 columns of v and dO, and runs
//    the decay scan of every channel, each of the 128 threads one channel's
//    steps (d 64: two threads a channel);
//  * writes dv[:, J] for its columns J itself: it is local to them;
//  * owns the 16 key channels [16 rank, 16 rank + 16) for everything that
//    sums over j: dr', dk', dlog_w and du, and writes dr, dk, dlog_w, du and
//    the float32 r dr' scratch for them.
//
// What sums over j, or over all key channels, is folded without atomics:
// each block writes its partials (the (d x C) products dO S0^T or v G1^T
// over its columns, dP and db over its columns, P and the bonus sums over
// its channels) into one of two exchange buffers of its shared memory, one
// cluster barrier a chunk, and each block then reads its channels' products
// and the whole of dP, P and the bonus sums from every block through
// distributed shared memory, summed in rank order.  So the result repeats
// bit for bit.  The two buffers alternate, so one barrier a chunk suffices:
// a block writes a buffer again only after every peer has passed the next
// barrier, and so has read it.
//
// The whole grid is resident at once: at d 64 and chunks up to 16 a block
// takes 128 threads, at most 80 registers and 37,440 bytes of shared memory
// in bf16 (`__launch_bounds__(128, 6)`), so 6 blocks share an SM.  Five
// would hold 660 blocks, but a cluster's blocks must share a GPC, and the
// card then holds only 154 of the training shape's 160 clusters of 4 at once
// (cudaOccupancyMaxActiveClusters on an H100 SXM): the last rows would run
// in a second round.  Nothing the scan derives is kept over all channels but
// KC and A: for the owned channels it keeps the midpoint-scaled copies and
// the cumulative log-decays, from which the epilogues compute the other
// decay factors, and sweep 2 stages G[:, J] for dv in the exchange buffer
// that the cluster has finished reading.  The next chunk's r, k, log w,
// v[:, J], dO[:, J] (and, sweep 2, the r dr' scratch) are fetched by
// `cp.async` into a raw stage after the chunk's cluster barrier, so the
// loads run under the folds, dv and the epilogue.  Chunk 32 runs its own
// instantiation, at fewer blocks an SM.
// float32 has no stage and reads the chunk straight from device memory,
// which one thread has asked L2 to prefetch (`cp.async.bulk.prefetch.L2`):
// a stage twice bf16's would leave room for 5 blocks an SM, and the rows
// would run in two rounds.
//
// Every chunk step costs a fixed sequence of phases, barriers and a cluster
// barrier whatever its length, so a chunk below 16 runs at 16 (the whole
// sequence when it is shorter) with a ragged last chunk: the chunked
// formulas above hold for any blocking of the sequence, so this is the same
// gradient, in fewer steps (an odd T, which the forward runs at chunk 1,
// takes T / 16 steps a sweep instead of T).
//
// Sweep 1 runs forward over the chunks and writes dr and r dr'; sweep 2
// runs backward and writes dk, dv, dlog_w (a running suffix sum: the
// chunk's part by a shuffle scan over the 8 lanes of a channel) and du.
// Nothing is stored per chunk, so the forward and its serving launch stay
// as they are.  A masked entry of P or dP is never stored or read (a
// diagonal 2 x 2 tile of pair sums computes its upper entry and drops it),
// because at chunk 32 a masked product's two factors overflow float32.
#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {

namespace cg = cooperative_groups;

constexpr int WKVB_THREADS = 128;
constexpr int WKVB_CMAX = 32;     // longest chunk the kernel takes
constexpr int WKVB_W = 16;        // value columns a block holds, key channels it owns
constexpr int WKVB_LDW = WKVB_W + 4;
constexpr int WKVB_SM_SMEM = 233472;   // shared memory of one SM; 1 KB of it kept per block
constexpr int WKVB_MAX_BLOCKS = 6;

__host__ __device__ constexpr int wkvb_round4(int x) { return (x + 3) / 4 * 4; }
// the chunk bound an instantiation is compiled for: chunks up to 16 take 16
__host__ __device__ constexpr int wkvb_cm(int c) { return c <= 16 ? 16 : WKVB_CMAX; }

// The geometry of one instantiation (mirrored by rwkv6_bwd.wkv6_bwd_geometry).
template <int D, int CM, int ELEM>
struct WkvbGeo {
  static constexpr int NT = WKVB_THREADS, W = WKVB_W, LDW = WKVB_LDW, LDK = D + 4;
  static constexpr int NS = D / W;               // blocks a row: the cluster
  static constexpr int TPR = NT / D;             // threads a state row
  static constexpr int CPT = W / TPR;            // state columns a thread holds
  static constexpr int SPT = CM / TPR;           // scan steps a thread
  static constexpr int TPT = CM / 8;             // steps of an owned channel a thread
  static constexpr int TRI = CM * (CM + 1) / 2;  // pairs s <= t
  // one exchange buffer: the (d x CM) products (channel-major), dP and db
  // (s <= t), P (s < t), the bonus sums
  static constexpr int XF = wkvb_round4(D * CM + CM * CM + CM);
  static constexpr int PFF = wkvb_round4(CM * CM + CM);   // the folded pairs
  // float offsets: KC, A (rows d + 4); v[:, J], dO[:, J], r, k, RS, KS and
  // the exclusive cumulative log-decay of the owned channels (rows 20); their
  // last cumulative log-decay and u; two exchange buffers (in sweep 2 the idle
  // one holds the chunk's G[:, J] for dv); the folded pairs
  static constexpr int O_KC = 0, O_A = O_KC + CM * LDK, O_VJ = O_A + CM * LDK;
  static constexpr int O_DOJ = O_VJ + CM * LDW, O_RO = O_DOJ + CM * LDW;
  static constexpr int O_KO = O_RO + CM * LDW, O_RSO = O_KO + CM * LDW;
  static constexpr int O_KSO = O_RSO + CM * LDW, O_CXO = O_KSO + CM * LDW;
  static constexpr int O_LASTO = O_CXO + CM * LDW, O_UO = O_LASTO + W, O_X = O_UO + W;
  static constexpr int O_PF = O_X + 2 * XF, FLOATS = O_PF + PFF;
  // bf16 only (float32 reads device memory directly): the raw stage after
  // the floats, in bytes: r, k, log w (C x d), v[:, J] and dO[:, J] (C x 16),
  // and the float32 r dr' of the owned channels (16 x C)
  static constexpr bool STAGED = ELEM == 2;
  static constexpr int B_R = FLOATS * 4, B_K = B_R + CM * D * ELEM, B_LW = B_K + CM * D * ELEM;
  static constexpr int B_V = B_LW + CM * D * ELEM, B_DO = B_V + CM * W * ELEM;
  static constexpr int B_AD = B_DO + CM * W * ELEM;
  static constexpr int BYTES = STAGED ? B_AD + W * CM * 4 : FLOATS * 4;
  static constexpr int FIT = WKVB_SM_SMEM / (BYTES + 1024);
  static constexpr int MINB = FIT < WKVB_MAX_BLOCKS ? FIT : WKVB_MAX_BLOCKS;
  static_assert(D % W == 0 && NT % D == 0 && W % TPR == 0 && CM % TPR == 0, "geometry");
  static_assert(MINB >= 1, "a block must fit an SM");
};

// The dynamic shared memory of one block for head dimension d and a chunk
// of c steps, elements of `elem` bytes (mirrored by rwkv6_bwd.wkv6_bwd_smem_bytes).
template <int D, int ELEM>
constexpr int wkvb_bytes(int c) {
  return wkvb_cm(c) == 16 ? WkvbGeo<D, 16, ELEM>::BYTES : WkvbGeo<D, WKVB_CMAX, ELEM>::BYTES;
}

namespace {

__device__ __forceinline__ int tri(int t, int s) { return t * (t + 1) / 2 + s; }    // s <= t
__device__ __forceinline__ int stri(int t, int s) { return t * (t - 1) / 2 + s; }   // s < t

constexpr float LOG2E = 1.4426950408889634f;
// 2^x: one MUFU instruction (the decays are kept in log2 units)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// four consecutive elements as float
__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void load_floats(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + q);
      x[q] = f.x, x[q + 1] = f.y, x[q + 2] = f.z, x[q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + q);
      x[q] = f.x, x[q + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(x[q], x[q + 1], x[q + 2], x[q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 2) *reinterpret_cast<float2*>(p + q) = make_float2(x[q], x[q + 1]);
  }
}

// Bring `bytes` (a multiple of 16, at a 16-byte aligned address) into L2.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// The two halves of a cluster barrier: release this thread's writes, and
// wait until every thread of the cluster has arrived (acquiring theirs).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace

// One block per (row, value slice); the NS slices of a row are one cluster.
template <typename T, int D, int CM>
__global__ void __launch_bounds__(WKVB_THREADS, (WkvbGeo<D, CM, sizeof(T)>::MINB))
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ lw, const T* __restrict__ u, const T* __restrict__ dout,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dlw, T* __restrict__ du, float* __restrict__ rdr,
                const float* __restrict__ state0, const float* __restrict__ dstate,
                float* __restrict__ dstate0, int T_len, int C, int vec) {
  using G = WkvbGeo<D, CM, sizeof(T)>;
  constexpr int NT = G::NT, W = G::W, LDW = G::LDW, LDK = G::LDK;
  constexpr int TPR = G::TPR, CPT = G::CPT, SPT = G::SPT, TPT = G::TPT;
  constexpr unsigned FULL = 0xffffffffu;

  extern __shared__ __align__(16) unsigned char wkvb_raw[];
  float* sm = reinterpret_cast<float*>(wkvb_raw);
  float* KC = sm + G::O_KC;          // k e^{last - cum}, every channel
  float* A = sm + G::O_A;            // r e^{cum_excl}, every channel (sweep 2)
  float* VJ = sm + G::O_VJ;          // v[:, J]
  float* DOJ = sm + G::O_DOJ;        // dO[:, J]
  float* RO = sm + G::O_RO;          // r, k of the owned channels
  float* KO = sm + G::O_KO;
  float* RSO = sm + G::O_RSO;        // r e^{cum_excl - c}, owned (sweep 2)
  float* KSO = sm + G::O_KSO;        // k e^{c - cum}, owned
  float* CXO = sm + G::O_CXO;        // cum_excl, owned
  float* LASTO = sm + G::O_LASTO;    // cum at the chunk's last step, owned
  float* UO = sm + G::O_UO;
  float* X = sm + G::O_X;            // two exchange buffers
  float* PF = sm + G::O_PF;          // dP and db, P, the bonus sums, folded
  T* sR = reinterpret_cast<T*>(wkvb_raw + G::B_R);
  T* sK = reinterpret_cast<T*>(wkvb_raw + G::B_K);
  T* sLW = reinterpret_cast<T*>(wkvb_raw + G::B_LW);
  T* sV = reinterpret_cast<T*>(wkvb_raw + G::B_V);
  T* sDO = reinterpret_cast<T*>(wkvb_raw + G::B_DO);
  float* sAD = reinterpret_cast<float*>(wkvb_raw + G::B_AD);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % G::NS;
  const long long row = blockIdx.x / G::NS;
  const int j0 = rank * W;                       // columns J and owned channels
  const long long base = row * T_len * D;
  // C is the chunk the body runs at (a chunk below 16 runs at 16, see the
  // launch); the last chunk may be shorter: Cn steps
  const int NC = (T_len + C - 1) / C;
  auto steps = [&](int n) { return n == NC - 1 ? T_len - n * C : C; };
  int Cn = C;
  // roles: state row si, part sh (columns sj..sj + CPT of J, scan steps
  // sh SPT..); owned channel ec with steps eg TPT.. (8 lanes a channel)
  const int si = tid / TPR, sh = tid % TPR, sj = sh * CPT;
  const int ec = tid / 8, eg = tid % 8;
  const bool owned_row = si >= j0 && si < j0 + W;

  if (tid < W) UO[tid] = to_float(u[row * D + j0 + tid]);

  // Fetch chunk n into the raw stage (cp.async when every base is 16-byte
  // aligned, else plain loads), and in sweep 2 the owned r dr'.
  auto fetch = [&](int n, bool sweep2) {
    const long long off = base + (long long)n * C * D;
    const int cn = steps(n);
    if constexpr (!G::STAGED) {                  // float32: only warm L2 for the scan's loads
      if (vec && tid == 0) {
        const T* rows[5] = {r, k, lw, v, dout};
#pragma unroll
        for (int a = 0; a < 5; ++a) prefetch_l2(rows[a] + off, cn * D * (int)sizeof(T));
        if (sweep2) prefetch_l2(rdr + off + (long long)j0 * cn, W * cn * 4);
      }
      return;
    }
    constexpr int VE = 16 / sizeof(T);
    if (vec) {
      for (int e = tid; e < cn * D / VE; e += NT) {
        cp16(sR + e * VE, r + off + e * VE);
        cp16(sK + e * VE, k + off + e * VE);
        cp16(sLW + e * VE, lw + off + e * VE);
      }
      constexpr int RV = W / VE;
      for (int e = tid; e < cn * RV; e += NT) {
        const int t = e / RV, p = (e % RV) * VE;
        cp16(sV + t * W + p, v + off + (long long)t * D + j0 + p);
        cp16(sDO + t * W + p, dout + off + (long long)t * D + j0 + p);
      }
    } else {
      for (int e = tid; e < cn * D; e += NT) {
        sR[e] = r[off + e];
        sK[e] = k[off + e];
        sLW[e] = lw[off + e];
      }
      for (int e = tid; e < cn * W; e += NT) {
        const int t = e / W, p = e % W;
        sV[e] = v[off + (long long)t * D + j0 + p];
        sDO[e] = dout[off + (long long)t * D + j0 + p];
      }
    }
    if (sweep2) {                                // scratch rows are [row][chunk][channel][step]
      const float* src = rdr + off + (long long)j0 * cn;
      for (int e = tid; e < W * cn / 4; e += NT) cp16(sAD + 4 * e, src + 4 * e);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // The decay scan of channel si in log2 units: each of the row's TPR
  // threads sums its SPT steps, the row's sums are exchanged in part order,
  // and each thread writes its steps' KC (and A in sweep 2) and, for an
  // owned channel, cum_excl and the midpoint-scaled copies KS (and RS in
  // sweep 2); last for the owned channels.  Then v[:, J], dO[:, J], r and k
  // of the owned channels as float.  Returns e^{last} of channel si.
  auto scan = [&](int n, bool sweep2) {
    // the chunk's inputs: the raw stage (bf16), or device memory (float32)
    const long long off = base + (long long)n * C * D;
    const T* gR = G::STAGED ? sR : r + off;
    const T* gK = G::STAGED ? sK : k + off;
    const T* gLW = G::STAGED ? sLW : lw + off;
    const T* gV = G::STAGED ? sV : v + off + j0;
    const T* gDO = G::STAGED ? sDO : dout + off + j0;
    const int vs = G::STAGED ? W : D;           // row stride of v[:, J] and dO[:, J]
    float w2[SPT], seg = 0.f;
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int t = sh * SPT + q;
      w2[q] = t < Cn ? to_float(gLW[t * D + si]) * LOG2E : 0.f;
      seg += w2[q];
    }
    const int lane0 = (tid & 31) & ~(TPR - 1);
    float pre = 0.f, last = 0.f;
#pragma unroll
    for (int m = 0; m < TPR; ++m) {
      const float x = __shfl_sync(FULL, seg, lane0 + m);
      if (m < sh) pre += x;
      last += x;
    }
    const float mid = 0.5f * last;
    float cx = pre;
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int t = sh * SPT + q;
      if (t < Cn) {
        const float ci = cx + w2[q];
        const float kt = to_float(gK[t * D + si]), rt = to_float(gR[t * D + si]);
        KC[t * LDK + si] = kt * ex2(last - ci);
        if (sweep2) A[t * LDK + si] = rt * ex2(cx);
        if (owned_row) {
          CXO[t * LDW + si - j0] = cx;
          KSO[t * LDW + si - j0] = kt * ex2(mid - ci);
          if (sweep2) RSO[t * LDW + si - j0] = rt * ex2(cx - mid);
        }
        cx = ci;
      }
    }
    if (owned_row && sh == 0) LASTO[si - j0] = last;
    for (int e = tid; e < Cn * W / 4; e += NT) {
      const int t = e / (W / 4), c = 4 * (e % (W / 4));
      const T* src[4] = {gV + t * vs + c, gDO + t * vs + c, gR + t * D + j0 + c,
                         gK + t * D + j0 + c};
      float* dst[4] = {VJ, DOJ, RO, KO};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4 x;
        if (G::STAGED || vec) {
          x = load4f(src[a]);
        } else {                                 // float32 at an unaligned base
          x = make_float4(to_float(src[a][0]), to_float(src[a][1]), to_float(src[a][2]),
                          to_float(src[a][3]));
        }
        *reinterpret_cast<float4*>(dst[a] + t * LDW + c) = x;
      }
    }
    return ex2(last);
  };

  // X[buf][i][t] = sum over J of OP[t][j] st[i][j], the row's parts reduced by
  // a butterfly (every part ends with the same sum) and written by part t / SPT.
  auto inter_partial = [&](float* Xb, const float* OP, const float (&st)[CPT]) {
    float mine[SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) mine[q] = 0.f;
#pragma unroll
    for (int t = 0; t < CM; ++t) {
      if (t < Cn) {
        float o[CPT];
        load_floats(o, OP + t * LDW + sj);
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int jj = 0; jj < CPT; jj += 2) {
          a0 = fmaf(o[jj], st[jj], a0);
          a1 = fmaf(o[jj + 1], st[jj + 1], a1);
        }
        float acc = a0 + a1;
#pragma unroll
        for (int m = 1; m < TPR; m <<= 1) acc += __shfl_xor_sync(FULL, acc, m);
        if (sh == t / SPT) mine[t % SPT] = acc;
      }
    }
    store_floats(Xb + si * CM + sh * SPT, mine);
  };

  // st <- e^{last} st + sum_s F[s][si] OP[s][J part]
  auto state_update = [&](float (&st)[CPT], float el, const float* F, const float* OP) {
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) st[jj] *= el;
#pragma unroll 4
    for (int s = 0; s < Cn; ++s) {
      const float f = F[s * LDK + si];
      float o[CPT];
      load_floats(o, OP + s * LDW + sj);
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) st[jj] = fmaf(f, o[jj], st[jj]);
    }
  };

  // The block's share of the pair sums: dP and db over J; in sweep 2 also P
  // over the owned channels and the bonus sums sum_c r u k.  A thread takes
  // a 2 x 2 tile of pairs (rows t0, t0 + 1 against s0, s0 + 1), so each row
  // it loads feeds two sums; a row past the chunk is loaded but never stored.
  auto pair_partials = [&](float* Xb, bool sweep2) {
    float* xp = Xb + D * CM;
    const int nb = (Cn + 1) / 2;
    for (int e = tid; e < nb * (nb + 1) / 2; e += NT) {
      int tb = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
      tb -= tri(tb, 0) > e;
      tb += tri(tb + 1, 0) <= e;
      const int t0 = 2 * tb, s0 = 2 * (e - tri(tb, 0));
      auto tile = [&](const float* X0, const float* Y0, float (&out)[2][2]) {
        float a[2][2][2] = {};
#pragma unroll
        for (int j = 0; j < W; j += 4) {
          float4 x[2], y[2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            x[p] = *reinterpret_cast<const float4*>(X0 + (t0 + p) * LDW + j);
            y[p] = *reinterpret_cast<const float4*>(Y0 + (s0 + p) * LDW + j);
          }
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              a[p][q][0] = fmaf(x[p].x, y[q].x, fmaf(x[p].z, y[q].z, a[p][q][0]));
              a[p][q][1] = fmaf(x[p].y, y[q].y, fmaf(x[p].w, y[q].w, a[p][q][1]));
            }
        }
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q) out[p][q] = a[p][q][0] + a[p][q][1];
      };
      float dp[2][2];
      tile(DOJ, VJ, dp);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int t = t0 + p, s = s0 + q;
          if (s <= t && t < Cn) xp[tri(t, s)] = dp[p][q];
        }
      if (!sweep2) continue;
      float pp[2][2];
      tile(RSO, KSO, pp);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int t = t0 + p, s = s0 + q;
          if (s < t && t < Cn) xp[G::TRI + stri(t, s)] = pp[p][q];
        }
      if (t0 != s0) continue;
#pragma unroll
      for (int p = 0; p < 2; ++p) {                // the bonus sums of the diagonal tile's rows
        const int t = t0 + p;
        if (t >= Cn) continue;
        float b0 = 0.f, b1 = 0.f;
#pragma unroll
        for (int c = 0; c < W; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(RO + t * LDW + c);
          const float4 y = *reinterpret_cast<const float4*>(KO + t * LDW + c);
          const float4 w = *reinterpret_cast<const float4*>(UO + c);
          b0 = fmaf(x.x * w.x, y.x, fmaf(x.z * w.z, y.z, b0));
          b1 = fmaf(x.y * w.y, y.y, fmaf(x.w * w.w, y.w, b1));
        }
        xp[CM * CM + t] = b0 + b1;
      }
    }
  };

  // After the cluster barrier: the pair sums over the cluster, in rank order
  // (dP and db; in sweep 2 also P and the bonus sums: the whole contiguous
  // pair area, whatever the chunk's length; entries past it are never read).
  auto fold_pairs = [&](int xb, bool sweep2) {
    const int n4 = (sweep2 ? CM * CM + CM : G::TRI + 3) / 4;
    for (int e = tid; e < n4; e += NT) {
      const int at = xb * G::XF + D * CM + 4 * e;
      float4 acc = *reinterpret_cast<const float4*>(cluster.map_shared_rank(X, 0) + at);
#pragma unroll
      for (int q = 1; q < G::NS; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(X, q) + at);
        acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
      }
      *reinterpret_cast<float4*>(PF + 4 * e) = acc;
    }
  };

  // The owned channel's products at its steps, over the cluster in rank order.
  auto fold_inter = [&](int xb, float (&inter)[TPT]) {
    const int at = xb * G::XF + (j0 + ec) * CM + eg * TPT;
    load_floats(inter, cluster.map_shared_rank(X, 0) + at);
#pragma unroll
    for (int q = 1; q < G::NS; ++q) {
      float x[TPT];
      load_floats(x, cluster.map_shared_rank(X, q) + at);
#pragma unroll
      for (int p = 0; p < TPT; ++p) inter[p] += x[p];
    }
  };

  float st[CPT];                                 // S[si][J part] (sweep 1), G (sweep 2)
  // this thread's part of a (d x d) state or gradient: row si, columns j0 + sj ..
  // (recomputed where used: nothing stays live across the sweeps for it)
  auto part = [&](const float* base_) { return base_ + (row * D + si) * D + j0 + sj; };
#pragma unroll
  for (int jj = 0; jj < CPT; ++jj) st[jj] = 0.f;
  if (state0) load_floats(st, part(state0));     // S_0
  int xb = 0;
  const int ch = j0 + ec;                        // the channel this thread folds

  // ---- sweep 1: forward over the chunks, dr and r dr' ---------------------------
  fetch(0, false);
  for (int n = 0; n < NC; ++n) {
    const long long off = base + (long long)n * C * D;
    Cn = steps(n);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const float el = scan(n, false);
    __syncthreads();
    float* Xb = X + xb * G::XF;
    inter_partial(Xb, DOJ, st);                  // dO S0^T over J
    pair_partials(Xb, false);
    cluster_arrive();                            // this block's partials are final
    state_update(st, el, KC, VJ);                // S <- e^{last} S + KC^T v
    cluster_wait();                              // and every peer's
    if (n + 1 < NC) fetch(n + 1, false);         // the raw stage is free since the scan
    fold_pairs(xb, false);
    float inter[TPT];
    fold_inter(xb, inter);
    __syncthreads();
    const float last = LASTO[ec], mid = 0.5f * last, uu = UO[ec];
    float intra_t[TPT];                          // sum_{s < t} dP[t][s] KS[s]
#pragma unroll
    for (int q = 0; q < TPT; ++q) intra_t[q] = 0.f;
#pragma unroll
    for (int s = 0; s < CM - 1; ++s) {
      if (s < eg * TPT + TPT - 1) {
        const float ks = KSO[s * LDW + ec];
#pragma unroll
        for (int q = 0; q < TPT; ++q) {
          const int t = eg * TPT + q;
          if (s < t && t < Cn) intra_t[q] = fmaf(PF[tri(t, 0) + s], ks, intra_t[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      const int t = eg * TPT + q;
      if (t >= Cn) continue;
      const float intra = intra_t[q];
      const float cx = CXO[t * LDW + ec];
      const float drp = fmaf(inter[q], ex2(cx), intra * ex2(cx - mid));   // dr'
      dr[off + (long long)t * D + ch] = from_float<T>(fmaf(uu * KO[t * LDW + ec], PF[tri(t, t)], drp));
      rdr[off + (long long)ch * Cn + t] = RO[t * LDW + ec] * drp;
    }
    xb ^= 1;
  }

  // ---- sweep 2: backward over the chunks, dk, dv, dlog_w, du ---------------------
  float run_a = 0.f, run_b = 0.f, du_acc = 0.f;
  if (dstate) {
    // sum_j S_T G_T over the row's columns J, then over the cluster for the
    // owned channel: the start of its dlog_w suffix sum
    float gt[CPT];
    load_floats(gt, part(dstate));
    float phi = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) phi = fmaf(st[jj], gt[jj], phi);
#pragma unroll
    for (int m = 1; m < TPR; m <<= 1) phi += __shfl_xor_sync(FULL, phi, m);
    __syncthreads();                             // the last chunk's epilogue read PF
    if (sh == 0) PF[si] = phi;
    cluster.sync();
#pragma unroll
    for (int q = 0; q < G::NS; ++q) run_a += cluster.map_shared_rank(PF, q)[ch];
  }
#pragma unroll
  for (int jj = 0; jj < CPT; ++jj) st[jj] = 0.f;  // G after the last chunk
  if (dstate) load_floats(st, part(dstate));
  __threadfence();                               // the scratch rows are written before
  __syncthreads();                               // any thread fetches them back
  fetch(NC - 1, true);
  for (int n = NC - 1; n >= 0; --n) {
    const long long off = base + (long long)n * C * D;
    Cn = steps(n);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const float el = scan(n, true);
    float ad[TPT];                               // r dr' of the owned channel's steps
    const float* gAD = G::STAGED ? sAD : rdr + off + (long long)j0 * Cn;
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      const int t = eg * TPT + q;
      ad[q] = t < Cn ? gAD[ec * Cn + t] : 0.f;
    }
    __syncthreads();
    float* Xb = X + xb * G::XF;
    inter_partial(Xb, VJ, st);                   // v G1^T over J
    pair_partials(Xb, true);
    cluster.sync();
    if (n > 0) fetch(n - 1, true);
    // Every peer has read the other buffer (the last chunk's), and this block
    // writes it again only in the next chunk: it holds G1[:, J] for dv.
    float* GS = X + (xb ^ 1) * G::XF;
    store_floats(GS + si * W + sj, st);
    state_update(st, el, A, DOJ);                // G <- e^{last} G + A^T dO
    fold_pairs(xb, true);
    float inter[TPT];
    fold_inter(xb, inter);
    __syncthreads();
    {                                            // dv[:, J]: KC G1 + P^T dO + (sum r u k) dO
      // Warps 0-1 sum KC G1 over i < d / 2, warps 2-3 over the rest, each
      // thread two rows s0, s0 + 1 and two columns; the halves swap one row's
      // partial through the idle buffer, and half h finishes row s0 + h.
      const int hi = tid / 64, rest = tid % 64, jp = 2 * (rest % 8);
#pragma unroll
      for (int m = 0; m < CM / 16; ++m) {
        const int s0 = 2 * (rest / 8) + 16 * m;
        float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
        if (s0 < Cn) {
#pragma unroll
          for (int i = hi * (D / 2); i < (hi + 1) * (D / 2); i += 4) {
            const float4 k0 = *reinterpret_cast<const float4*>(KC + s0 * LDK + i);
            const float4 k1 = *reinterpret_cast<const float4*>(KC + (s0 + 1) * LDK + i);
            const float q0[4] = {k0.x, k0.y, k0.z, k0.w}, q1[4] = {k1.x, k1.y, k1.z, k1.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 g = *reinterpret_cast<const float2*>(GS + (i + q) * W + jp);
              a00 = fmaf(q0[q], g.x, a00);
              a01 = fmaf(q0[q], g.y, a01);
              a10 = fmaf(q1[q], g.x, a10);
              a11 = fmaf(q1[q], g.y, a11);
            }
          }
        }
        float* xch = GS + D * W + m * 256;       // 2 halves x 64 threads x 2 floats
        *reinterpret_cast<float2*>(xch + (hi * 64 + rest) * 2) =
            hi ? make_float2(a00, a01) : make_float2(a10, a11);
        __syncthreads();
        const float2 o = *reinterpret_cast<const float2*>(xch + ((1 - hi) * 64 + rest) * 2);
        const int s = s0 + hi;
        float v0 = (hi ? a10 : a00) + o.x, v1 = (hi ? a11 : a01) + o.y;
        if (s < Cn) {
#pragma unroll
          for (int t = 1; t < CM; ++t) {
            if (t > s && t < Cn) {
              const float p = PF[G::TRI + stri(t, 0) + s];
              const float2 d2 = *reinterpret_cast<const float2*>(DOJ + t * LDW + jp);
              v0 = fmaf(p, d2.x, v0);
              v1 = fmaf(p, d2.y, v1);
            }
          }
          const float dg = PF[CM * CM + s];
          const float2 d2 = *reinterpret_cast<const float2*>(DOJ + s * LDW + jp);
          store_pair(dv + off + (long long)s * D + j0 + jp, fmaf(dg, d2.x, v0), fmaf(dg, d2.y, v1));
        }
      }
    }
    const float last = LASTO[ec], mid = 0.5f * last, uu = UO[ec];
    float bk[TPT];                               // k dk' of the owned channel's steps
    float intra_s[TPT];                          // sum_{t > s} dP[t][s] RS[t]
#pragma unroll
    for (int q = 0; q < TPT; ++q) intra_s[q] = 0.f;
#pragma unroll
    for (int t = 1; t < CM; ++t) {
      if (t > eg * TPT && t < Cn) {
        const float rs = RSO[t * LDW + ec];
#pragma unroll
        for (int q = 0; q < TPT; ++q) {
          const int s = eg * TPT + q;
          if (t > s) intra_s[q] = fmaf(PF[tri(t, 0) + s], rs, intra_s[q]);
        }
      }
    }
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      const int s = eg * TPT + q;
      bk[q] = 0.f;
      if (s < Cn) {
        const float intra = intra_s[q];
        const float ci = s + 1 < Cn ? CXO[(s + 1) * LDW + ec] : last;
        const float dkp = fmaf(inter[q], ex2(last - ci), intra * ex2(mid - ci));   // dk'
        const float db = PF[tri(s, s)], rr = RO[s * LDW + ec], kk = KO[s * LDW + ec];
        dk[off + (long long)s * D + ch] = from_float<T>(fmaf(uu * rr, db, dkp));
        bk[q] = kk * dkp;
        du_acc = fmaf(rr * kk, db, du_acc);
      }
      sa += ad[q];
      sb += bk[q];
    }
    // the chunk's suffix sums over the channel's 8 lanes, later steps on higher lanes
    float ia = sa, ib = sb;
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
      const float ya = __shfl_down_sync(FULL, ia, m, 8), yb = __shfl_down_sync(FULL, ib, m, 8);
      if (eg + m < 8) ia += ya, ib += yb;
    }
    const float na = __shfl_down_sync(FULL, ia, 1, 8), nb = __shfl_down_sync(FULL, ib, 1, 8);
    float acc_a = run_a + (eg < 7 ? na : 0.f), acc_b = run_b + (eg < 7 ? nb : 0.f);
#pragma unroll
    for (int q = TPT - 1; q >= 0; --q) {
      const int s = eg * TPT + q;
      acc_b += bk[q];                            // inclusive on k
      if (s < Cn) dlw[off + (long long)s * D + ch] = from_float<T>(acc_a - acc_b);
      acc_a += ad[q];                            // exclusive on r
    }
    run_a += __shfl_sync(FULL, ia, 0, 8);
    run_b += __shfl_sync(FULL, ib, 0, 8);
    xb ^= 1;
  }
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1) du_acc += __shfl_xor_sync(FULL, du_acc, m);
  if (eg == 0) du[row * D + ch] = from_float<T>(du_acc);
  if (dstate0) store_floats(const_cast<float*>(part(dstate0)), st);  // G_0: the initial state's gradient
  cluster.sync();                                // no block leaves while a peer reads it
}

template <typename T, int D, int CM>
cudaLaunchConfig_t wkvb_config(int BH, cudaStream_t s, cudaLaunchAttribute* attr) {
  using G = WkvbGeo<D, CM, sizeof(T)>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH * G::NS);
  cfg.blockDim = dim3(G::NT);
  cfg.dynamicSmemBytes = G::BYTES;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int D, int CM>
cudaError_t wkvb_prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, D, CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WkvbGeo<D, CM, sizeof(T)>::BYTES);
  return err;
}

template <typename T, int D, int CM>
int launch_wkv6_bwd_cm(const void* r, const void* k, const void* v, const void* lw,
                       const void* u, const void* dout, void* dr, void* dk, void* dv,
                       void* dlw, void* du, float* rdr, const float* state0,
                       const float* dstate, float* dstate0, int BH, int T_len, int chunk,
                       int vec, cudaStream_t s) {
  cudaError_t err = wkvb_prepare<T, D, CM>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wkvb_config<T, D, CM>(BH, s, attr);
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<T, D, CM>, static_cast<const T*>(r),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<const T*>(lw), static_cast<const T*>(u),
                           static_cast<const T*>(dout), static_cast<T*>(dr),
                           static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dlw),
                           static_cast<T*>(du), rdr, state0, dstate, dstate0, T_len, chunk,
                           vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wkv6_bwd(const void* r, const void* k, const void* v, const void* lw,
                    const void* u, const void* dout, void* dr, void* dk, void* dv, void* dlw,
                    void* du, float* rdr, const float* state0, const float* dstate,
                    float* dstate0, int BH, int T_len, int d, int chunk, cudaStream_t s) {
  if (chunk < 1 || chunk > WKVB_CMAX || T_len < 1 || T_len % chunk || BH < 1) return -1;
  // A chunk below 16 runs at 16 (the whole sequence if shorter), the last
  // chunk ragged: the same gradient, in fewer chunk steps of fixed cost.
  chunk = chunk < 16 ? (T_len < 16 ? T_len : 16) : chunk;
  const int vec = ((reinterpret_cast<size_t>(r) | reinterpret_cast<size_t>(k) |
                    reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(lw) |
                    reinterpret_cast<size_t>(dout)) % 16) == 0;
#define REPRO_WKVB_CASE(D_)                                                                 \
  if (d == D_) {                                                                            \
    if (chunk <= 16)                                                                        \
      return launch_wkv6_bwd_cm<T, D_, 16>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du, rdr,  \
                                           state0, dstate, dstate0, BH, T_len, chunk, vec,  \
                                           s);                                              \
    return launch_wkv6_bwd_cm<T, D_, WKVB_CMAX>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du,  \
                                                rdr, state0, dstate, dstate0, BH, T_len,    \
                                                chunk, vec, s);                             \
  }
  REPRO_WKVB_CASE(16)
  REPRO_WKVB_CASE(32)
  REPRO_WKVB_CASE(64)
#undef REPRO_WKVB_CASE
  return -1;
}

// The most clusters of one instantiation the device holds at once.
template <typename T, int D, int CM>
int wkvb_max_clusters() {
  if (wkvb_prepare<T, D, CM>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wkvb_config<T, D, CM>(1, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, wkv6_bwd_kernel<T, D, CM>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace repro

// Plain C interface: no allocation, no synchronisation; launches on the
// stream it is handed and returns cudaGetLastError(), or -1 for a shape that
// is not compiled (d not in {16, 32, 64}, a chunk outside [1, 32] or one
// that does not divide T).  `scratch` is a float32 buffer of BH * T * d
// floats that the kernel writes in sweep 1 and reads back in sweep 2 (r dr',
// laid out [row][chunk][channel][step]).  `state0` (the forward's initial
// state), `dstate` (the final state's gradient) and `dstate0` (written: the
// initial state's gradient) are float32 (BH, d, d) at 16-byte aligned
// bases, or null: a zero initial state, a zero final-state gradient, none
// wanted.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* lw,
                              const void* u, const void* dout, void* dr, void* dk, void* dv,
                              void* dlw, void* du, void* scratch, const void* state0,
                              const void* dstate, void* dstate0, int BH, int T, int d,
                              int chunk, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rdr = static_cast<float*>(scratch);
  const float* s0 = static_cast<const float*>(state0);
  const float* gT = static_cast<const float*>(dstate);
  float* g0 = static_cast<float*>(dstate0);
  if (is_bf16)
    return repro::launch_wkv6_bwd<__nv_bfloat16>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du, rdr,
                                                 s0, gT, g0, BH, T, d, chunk, s);
  return repro::launch_wkv6_bwd<float>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du, rdr, s0, gT,
                                       g0, BH, T, d, chunk, s);
}

// Dynamic shared memory of one block for head dimension d, a chunk of c
// steps and the input type (mirrored by rwkv6_bwd.wkv6_bwd_smem_bytes).
extern "C" int repro_wkv6_bwd_smem_bytes(int d, int chunk, int is_bf16) {
  using namespace repro;
#define REPRO_WKVB_SMEM(D_)                                                      \
  if (d == D_) return is_bf16 ? wkvb_bytes<D_, 2>(chunk) : wkvb_bytes<D_, 4>(chunk);
  REPRO_WKVB_SMEM(16)
  REPRO_WKVB_SMEM(32)
  REPRO_WKVB_SMEM(64)
#undef REPRO_WKVB_SMEM
  return -1;
}

// Blocks a row (the cluster), and the blocks an SM the launch bounds ask
// for (mirrored by rwkv6_bwd.wkv6_bwd_geometry).
extern "C" int repro_wkv6_bwd_split(int d) { return d / repro::WKVB_W; }

extern "C" int repro_wkv6_bwd_min_blocks(int d, int chunk, int is_bf16) {
  using namespace repro;
#define REPRO_WKVB_MINB(D_, E_)                                                          \
  if (d == D_ && (is_bf16 ? 2 : 4) == E_)                                                \
    return wkvb_cm(chunk) == 16 ? WkvbGeo<D_, 16, E_>::MINB : WkvbGeo<D_, WKVB_CMAX, E_>::MINB;
  REPRO_WKVB_MINB(16, 2) REPRO_WKVB_MINB(32, 2) REPRO_WKVB_MINB(64, 2)
  REPRO_WKVB_MINB(16, 4) REPRO_WKVB_MINB(32, 4) REPRO_WKVB_MINB(64, 4)
#undef REPRO_WKVB_MINB
  return -1;
}

// The most clusters (rows) of the launch for (d, chunk, type) that the
// current device holds at once (cudaOccupancyMaxActiveClusters), or -1.
extern "C" int repro_wkv6_bwd_max_clusters(int d, int chunk, int is_bf16) {
  using namespace repro;
#define REPRO_WKVB_OCC(D_)                                                                 \
  if (d == D_) {                                                                           \
    if (is_bf16)                                                                           \
      return chunk <= 16 ? wkvb_max_clusters<__nv_bfloat16, D_, 16>()                      \
                         : wkvb_max_clusters<__nv_bfloat16, D_, WKVB_CMAX>();              \
    return chunk <= 16 ? wkvb_max_clusters<float, D_, 16>()                                \
                       : wkvb_max_clusters<float, D_, WKVB_CMAX>();                        \
  }
  REPRO_WKVB_OCC(16)
  REPRO_WKVB_OCC(32)
  REPRO_WKVB_OCC(64)
#undef REPRO_WKVB_OCC
  return -1;
}
