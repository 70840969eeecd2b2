// bf16 instantiations of the FlashAttention forward kernel (see
// flash_attention.cuh) behind a plain C interface: no allocation, no
// synchronisation, launches on the stream it is handed and returns
// cudaGetLastError().
#include "flash_attention.cuh"

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq, int Skv, int d,
    int H, int q_per_kv, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, float sm_scale, int causal, int q_off, int bq, int bkv,
    int vec_ok, void* stream) {
  return repro::launch_flash<__nv_bfloat16>(q, k, v, o, lse, BH, Sq, Skv, d, H, q_per_kv, k_sb,
                                            k_sh, k_st, v_sb, v_sh, v_st, sm_scale, causal, q_off,
                                            bq, bkv, vec_ok, stream);
}

extern "C" int repro_flash_smem_bytes_bf16(int bq, int bkv, int d) {
  return repro::flash_smem_bytes<__nv_bfloat16>(bq, bkv, d);
}
