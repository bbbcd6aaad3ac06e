// Chunked-prefill and decode flash attention over per-slot K/V rings.
//
// Replaces: src/repro/kernels/prefill_attention.py::prefill_attention_pallas,
// ring layout (_kernel(paged=False) :46-115): grid (sequence, query tile), a
// static trip count over the ring width (kv_tile 128), an explicit kpos
// operand (-1 = empty entry), causal + sliding-window mask, GQA, int8 rings
// with per-(entry, head) scales.  The same kernel serves ring decode (Sq = 1).
//
// What bounds it on the H100: at recurrentgemma-2b's serve shapes (B 8,
// Sq 256, H 10, Hkv 1, Dh 256, WR 2304 = window 2048 + chunk 256) the
// operations at prefill (~4 * Sq * visible keys * H * Dh FLOP against one
// 2.4 MB ring read per sequence and query tile); at decode (Sq = 1) the
// bytes: each sequence's whole ring is read for 10 query rows.
//
// Design (flash_attention.cuh, RING = true): one CTA per (sequence, tile of
// 64 (position, GQA head) rows, kv head).  A ring that has wrapped is not in
// position order, so the CTA walks all WR / 64 tiles, loads each entry's
// position into shared memory with the tile, and masks from those positions
// alone; empty entries (kpos -1) are neither read nor attended.  GQA group 10
// packs 6 positions x 10 heads into the 64 rows; at Sq = 1 only 10 rows of
// the tile are live (recorded in PERF.md).  Head dim 256 needs 104 KB of
// dynamic shared memory on the tensor-core path and reads Q fragments from
// shared memory (see flash_attention.cuh).
#include "flash_attention.cuh"

extern "C" int rt_ring_prefill_attention(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* kpos, const void* qpos, void* out, int B,
                                         int Sq, int H, int Hkv, int Dh, int WR, int window,
                                         float sm_scale, int q_dtype, int kv_dtype,
                                         void* stream) {
  flash::Args a{q, k, v, (const float*)k_scale, (const float*)v_scale, nullptr,
                (const int*)kpos, (const int*)qpos, out, Sq, H, Hkv, 0, 0, WR, window,
                sm_scale};
  const int GT = flash::group_tile(H, Hkv);
  if (GT < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 256) return flash::launch_dh<256, true>(a, B, GT, q_dtype, kv_dtype, st);
  if (Dh == 128) return flash::launch_dh<128, true>(a, B, GT, q_dtype, kv_dtype, st);
  if (Dh == 64) return flash::launch_dh<64, true>(a, B, GT, q_dtype, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}
