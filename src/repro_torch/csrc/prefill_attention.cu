// Ragged chunked-prefill flash attention over the paged K/V pool.
//
// Replaces: src/repro/kernels/prefill_attention.py::prefill_attention_pallas,
// paged layout (_kernel(paged=True) :46-115): grid (sequence, 64-query tile),
// the whole pool in VMEM, a block walk whose trip count comes from the tile's
// largest query position, causal + optional window mask, GQA, int8 dequant.
//
// What bounds it on the H100: at the serve shapes (chunk 256 over contexts
// up to 1.5 K tokens) the operations, ~4 * Sq * ctx * H * Dh FLOP against
// one read of the context per 128-row CTA; in this design the mma.sync rate
// with the online softmax between the two products of each tile.
//
// Design (flash_attention.cuh, tc_kernel with RING = false): one CTA per
// (sequence, tile of 128 (position, GQA head) rows, kv head).  The pool stays
// in device memory; the CTA walks only the key tiles of [max(0, qmin - window
// + 1), qmax] for its rows' positions, so it never reads past the blocks the
// sequence occupies, a window skips the keys behind it, and an all-padding
// CTA walks none.  A producer warp gathers each 64-key tile block by block
// through the block table with cp.async, two or three tiles ahead of the
// consumer warps.  Head dims 64, 112 (kimi-k2-1t-a32b's), 128 and 256.
#include "flash_attention.cuh"

extern "C" int rt_paged_prefill_attention(const void* q, const void* k, const void* v,
                                          const void* k_scale, const void* v_scale,
                                          const void* bt, const void* qpos, void* out, int B,
                                          int Sq, int H, int Hkv, int Dh, int BS, int W,
                                          int window, float sm_scale, int q_dtype, int kv_dtype,
                                          void* stream) {
  flash::Args a{q, k, v, (const float*)k_scale, (const float*)v_scale, (const int*)bt, nullptr,
                (const int*)qpos, out, Sq, H, Hkv, BS, W, 0, window, sm_scale};
  return flash::launch<false>(a, B, Dh, q_dtype, kv_dtype, (cudaStream_t)stream);
}
