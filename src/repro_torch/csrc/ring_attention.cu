// Flash attention over per-slot K/V rings: chunked prefill (Sq > 1) and a
// split-KV decode (Sq = 1).
//
// Replaces: src/repro/kernels/prefill_attention.py::prefill_attention_pallas,
// ring layout (_kernel(paged=False) :46-115): grid (sequence, query tile), a
// static trip count over the ring width (kv_tile 128), an explicit kpos
// operand (-1 = empty entry), causal + sliding-window mask, GQA, int8 rings
// with per-(entry, head) scales.
//
// What bounds it on the H100.  Prefill, at recurrentgemma-2b's serve shapes
// (B 8, Sq 256, H 10, Hkv 1, Dh 256, WR 2304 = window 2048 + chunk 256): the
// operations, ~4 * Sq * visible keys * H * Dh FLOP against one read of the
// walked part of the ring (2.4 MB in bf16 at most) per 120-row CTA; in this
// design the mma.sync rate with the online softmax between the two products
// of each tile.  Decode: the bytes, each sequence's visible ring entries
// read once (2.4 MB in bf16 for 10 query heads, ~10 FLOP a byte), so the
// whole card has to stream them.
//
// Prefill design (flash_attention.cuh, tc_kernel with RING = true): one CTA
// per (sequence, tile of 128 (position, GQA head) rows, kv head): 12
// positions x the 10 heads of recurrentgemma-2b's group, so 22 CTAs read a
// sequence's ring where 43 did with 64 rows.  A ring that has wrapped is not
// in position order, so the CTA first reads its sequence's kpos and keeps
// only the 64-entry tiles holding a key some row can see (by the tile's
// smallest and largest position); at ~1 K of context about half the ring is
// empty or in the future and is neither read nor computed.  Inside a walked
// tile the mask is per element, from positions; empty entries (kpos -1) are
// zero-filled, never read.  A producer warp keeps the next walked tiles in
// flight (cp.async into a 2-stage ring of shared memory at head dim 256,
// 3 stages below); int8 rings arrive as int8 and are dequantized once a tile
// in shared memory.
//
// Decode design (flash_decode.cuh, shared with the paged layout): the ring
// is split across CTAs, on a grid (sequence, kv head x head tile, split); the
// wrapper picks the splits for about three CTAs an SM (36 splits of 64
// entries, 288 CTAs, at recurrentgemma-2b's serve shape), so the whole card
// streams the rings and each K/V row is read once for all the query heads of
// its group.  bf16 queries over bf16 or int8 rings take flash::decode_mma (K
// and V staged 64 entries at a time, mma.sync for the group's heads), f32
// operands flash::decode_simt.  Each CTA writes f32 partials (m, l,
// unnormalized o) per (sequence, head, split); ring_decode_combine, a second
// launch, rescales and sums them.  Masks come from positions only, so a
// wrapped ring needs nothing else; a tile with no visible key is skipped
// without a read; a split with no visible key writes m = -1e30, l = 0, o = 0
// and weighs nothing; a row with no visible key at all, or with qpos -1,
// returns 0.
#include "flash_decode.cuh"

namespace {

constexpr float DNEG = -1e30f;

// One CTA a (sequence, head), a thread an output dim: rescale and sum the
// splits' partials.
template <typename TQ>
__global__ void ring_decode_combine(const float* __restrict__ part,
                                    const int* __restrict__ qpos, TQ* __restrict__ out, int H,
                                    int DH, int S) {
  const int bh = blockIdx.x, b = bh / H, d = threadIdx.x;
  TQ* o = out + (long)bh * DH;
  if (qpos[b] < 0) {
    o[d] = from_f<TQ>(0.f);
    return;
  }
  const float* p = part + (long)bh * S * (DH + 2);
  float mx = DNEG;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, p[s * (DH + 2) + DH]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* ps = p + s * (DH + 2);
    const float w = expf(ps[DH] - mx);
    L = fmaf(w, ps[DH + 1], L);
    O = fmaf(w, ps[d], O);
  }
  o[d] = from_f<TQ>(L > 0.f ? O / fmaxf(L, 1e-30f) : 0.f);
}

}  // namespace

extern "C" int rt_ring_prefill_attention(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* kpos, const void* qpos, void* out, int B,
                                         int Sq, int H, int Hkv, int Dh, int WR, int window,
                                         float sm_scale, int q_dtype, int kv_dtype,
                                         void* stream) {
  flash::Args a{q, k, v, (const float*)k_scale, (const float*)v_scale, nullptr,
                (const int*)kpos, (const int*)qpos, out, Sq, H, Hkv, 0, 0, WR, window,
                sm_scale};
  return flash::launch<true>(a, B, Dh, q_dtype, kv_dtype, (cudaStream_t)stream);
}

// Sq = 1: the split pass over S splits of the ring, then the combine.
// ``part`` holds B * H * S * (Dh + 2) floats.
extern "C" int rt_ring_decode_attention(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* kpos, const void* qpos, void* out,
                                        void* part, int B, int H, int Hkv, int Dh, int WR,
                                        int window, float sm_scale, int q_dtype, int kv_dtype,
                                        int S, void* stream) {
  if (Hkv < 1 || H % Hkv || S < 1) return (int)cudaErrorInvalidValue;
  const bool mma = q_dtype == RT_BF16 && (kv_dtype == RT_BF16 || kv_dtype == RT_I8);
  const int tile = mma ? flash::DKT : flash::DCH;  // entries a split: a multiple of the tile
  flash::DecodeArgs a{q, k, v, (const float*)k_scale, (const float*)v_scale, nullptr,
                      (const int*)kpos, (const int*)qpos, (float*)part, nullptr, out,
                      H, Hkv, WR, 0, 0, window, sm_scale, S,
                      ((WR + S - 1) / S + tile - 1) / tile * tile, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  const int err = flash::launch_decode<false>(a, B, Dh, q_dtype, kv_dtype, st);
  if (err) return err;
  float* pt = (float*)part;
  if (q_dtype == RT_BF16)
    ring_decode_combine<__nv_bfloat16><<<B * H, Dh, 0, st>>>(pt, (const int*)qpos,
                                                             (__nv_bfloat16*)out, H, Dh, S);
  else
    ring_decode_combine<float><<<B * H, Dh, 0, st>>>(pt, (const int*)qpos, (float*)out, H, Dh,
                                                     S);
  return (int)cudaGetLastError();
}
