// Tensor-core fragment and copy helpers shared by the bf16 bodies of the
// FlashAttention forward (flash_attention.cuh) and flash-decode
// (flash_decode.cu): `ldmatrix` loads of 8x8 bf16 tiles from shared memory,
// the `mma.sync.m16n8k16` bf16 -> float32 product by inline PTX, packing two
// floats into a bf16 pair, and a tile copy that goes through `cp.async` when
// the operands are 16-byte aligned.
#pragma once

#include "common.cuh"

namespace repro {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy a tile into shared memory: asynchronously (the caller commits and
// waits) when pointers and strides are 16-byte aligned, else with scalar loads.
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void flash_copy(__nv_bfloat16* s, const __nv_bfloat16* g, int row0,
                                           int n_rows, long long ld_g, bool vec_ok, int tid) {
  if (vec_ok) {
    load_tile_async<__nv_bfloat16, ROWS, D, LD, NT>(s, g, row0, 0, n_rows, D, ld_g, tid);
  } else {
    load_tile<__nv_bfloat16, ROWS, D, LD, NT>(s, g, row0, 0, n_rows, D, ld_g, false, tid);
  }
}

}  // namespace repro
