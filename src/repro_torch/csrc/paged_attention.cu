// Paged decode attention: one query token a sequence, through the block table.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_pallas
// (body _kernel :38-75), one grid step a sequence with the whole K/V pool
// handed to VMEM and an online softmax over ceil((qpos+1)/BS) blocks.
//
// What bounds it on the H100: the bytes.  A query reads its sequence's whole
// context once (2 * ctx * Hkv * Dh K/V elements) for 4 * ctx * H * Dh
// operations: about one FLOP a byte with one query head a kv head (llama2-7b:
// 0.023 ms for 8 sequences of ~830 keys in bf16), G FLOP a byte with a GQA
// group of G (chatglm3-6b, H32/Hkv2: 0.0023 ms).  Either way the work is far
// too small for one CTA a (sequence, kv head): at chatglm3-6b's shape that
// grid is 16 CTAs on 132 SMs, each walking up to 1.6 K keys alone, so the
// kernel is bound by the latency of its longest CTA, not by the bytes.
//
// Design (flash_decode.cuh, the CTA body shared with ring decode): the
// context is split across CTAs on a grid (sequence, kv head x head tile,
// split).  The wrapper picks the splits from the table width W * BS (never
// from qpos, which lives on the card): 256 entries a split, four 64-entry
// tiles, which a device-time sweep put ahead of 64-768 at every serve shape
// (shorter splits add CTAs whose fixed chain and merge cost more than their
// parallelism buys; kernels/paged_attention.py decode_plan).  A CTA
// resolves its tile's pool rows through the block table, issues every K/V
// load of the tile before any is used, scores the tile against up to 16 GQA
// heads with mma.sync and accumulates P V on the tensor cores (int8 K and V
// staged as exact f16 integers, their per-(slot, head) f32 scales applied to
// the scores and to P); a split that lies past its sequence's qpos exits
// before reading.  The merge is in the same launch: each CTA writes f32 partials (m, l,
// unnormalized o), fences and counts itself on its (sequence, head tile)
// counter, and the last to arrive merges the live splits in split order
// (bitwise the same from run to run) and resets the counter to 0.  The
// counters live in a zeroed workspace the wrapper allocates once a device and
// size, so a call is one launch.  f32 operands take the CUDA-core body.
// qpos = -1 reads nothing and writes a zero row; masking follows
// kernels/ref.py, so no row yields NaN.
#include "flash_decode.cuh"

// part: B * H * S * (Dh + 2) floats; count: B * Hkv * head tiles ints, 0 on
// entry and left 0; S splits of kps entries cover the W * BS entries of the
// table, S <= 64.
extern "C" int rt_paged_decode_attention(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* bt, const void* qpos, void* out,
                                         void* part, void* count, int B, int H, int Hkv,
                                         int Dh, int BS, int W, float sm_scale, int q_dtype,
                                         int kv_dtype, int S, int kps, void* stream) {
  if (S < 1 || S > flash::MERGE_SMAX || kps < 1 || (long)S * kps < (long)W * BS ||
      (long)(S - 1) * kps >= (long)W * BS)
    return (int)cudaErrorInvalidValue;
  flash::DecodeArgs a{q, k, v, (const float*)k_scale, (const float*)v_scale, (const int*)bt,
                      nullptr, (const int*)qpos, (float*)part, (int*)count, out,
                      H, Hkv, W * BS, BS, W, 0, sm_scale, S, kps, 0, 0};
  return flash::launch_decode<true>(a, B, Dh, q_dtype, kv_dtype, (cudaStream_t)stream);
}
