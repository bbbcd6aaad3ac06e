// Ragged chunked-prefill flash attention over the paged K/V pool.
//
// Replaces: src/repro/kernels/prefill_attention.py::prefill_attention_pallas,
// paged layout (_kernel(paged=True) :46-115): grid (sequence, 64-query tile),
// the whole pool in VMEM, a block walk whose trip count comes from the tile's
// largest query position, causal + optional window mask, GQA, int8 dequant.
//
// What bounds it on the H100: at the serve shapes (chunk 256 over contexts
// up to 1.5 K tokens) the operations: ~4 * Sq * ctx * H * Dh FLOP against
// one read of the context per 64-row query tile.
//
// Design (flash_attention.cuh, RING = false): one CTA per (sequence, tile of
// 64 (position, GQA head) rows, kv head).  The pool stays in device memory; a
// CTA reads its sequence's blocks through the block table, 64 keys per tile,
// for keys 0 .. max qpos of its rows only, so it never reads past the blocks
// the sequence occupies and an all-padding tile runs zero iterations.
#include "flash_attention.cuh"

extern "C" int rt_paged_prefill_attention(const void* q, const void* k, const void* v,
                                          const void* k_scale, const void* v_scale,
                                          const void* bt, const void* qpos, void* out, int B,
                                          int Sq, int H, int Hkv, int Dh, int BS, int W,
                                          int window, float sm_scale, int q_dtype, int kv_dtype,
                                          void* stream) {
  flash::Args a{q, k, v, (const float*)k_scale, (const float*)v_scale, (const int*)bt, nullptr,
                (const int*)qpos, out, Sq, H, Hkv, BS, W, 0, window, sm_scale};
  const int GT = flash::group_tile(H, Hkv);
  if (GT < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128) return flash::launch_dh<128, false>(a, B, GT, q_dtype, kv_dtype, st);
  if (Dh == 64) return flash::launch_dh<64, false>(a, B, GT, q_dtype, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}
