// w4a16 matmul: y = act(x @ dequant(qweight)^T * scale + bias) + residual.
//
// Replaces: src/repro/kernels/int4_matmul.py::int4_matmul_pallas (body
// _kernel :24-54), which ships packed nibbles into VMEM, dequantizes the
// whole (block_m, K) weight tile there and runs one f32 matmul with K whole.
//
// What bounds it on the H100: at decode (B = slots <= 8) it reads K*M/2
// bytes of packed weight for 2*B*K*M operations, about 4*B FLOP per byte,
// far below the ~295 the card needs to be compute-bound: the weight bytes
// are the whole cost, so the aim is to read them exactly once, with enough
// loads in flight to run at the memory's rate.  At prefill (B = slots x
// chunk = 2048) it is compute-bound on the tensor cores (2*B*K*M bf16
// operations against 989 TFLOP/s), and only wgmma reaches that rate.
//
// Numbers, both paths: the nibbles become exact small integers in bf16 and
// the tensor cores multiply them by the bf16 activations, so each product is
// exact; the per-group scale is applied once to each group's f32 partial sum
// (acc += partial * scale[n, group]) instead of rounding dequantized weights
// to bf16.  The result differs from the f32 plain version only in summation
// order, and the one rounding is the bf16 store.  The epilogue (scale ->
// bias -> activation -> residual, f32) runs before that store.  Nibble
// order: low nibble = even k, sign-extended (int4_matmul.py:33-37).
//
// Decode (B <= 16): one 16-token row tile.  A CTA owns 32 outputs and its 8
// warps split K by quant groups (warp w takes groups w, w+8, ...); each lane
// reads its weight row's 16-byte chunks straight from device memory into
// mma.sync B fragments, with several chunks in flight, and the activations
// come from L1/L2.  The warps' partial outputs are summed once in shared
// memory.  Every weight byte is read once.
//
// Prefill (B > 16): a warp-specialized wgmma GEMM that computes the
// transposed tile, outputs x tokens (128 x 128), so that the converted
// weights are the register A operand and never pass through shared memory.
// - One producer warp keeps a 4-stage ring in shared memory full: per 128-deep
//   K step two TMA loads of the activation tile (128 tokens x 64 k each, bf16,
//   128-byte swizzle: the wgmma B operand as it lands), one of the packed
//   weight tile (128 rows x 64 bytes), all zero-filled past B, M and K, and
//   4-byte cp.async copies of the step's group scales (a word holding the pair
//   the scale sits in), all completing on the stage's mbarrier.
// - Two consumer warpgroups own 64 weight rows each.  A thread reads its two
//   rows' 64 bytes a step, gathers byte (lane % 4) of every word with prmt
//   (the bytes its mma fragment needs), and turns each nibble into bf16
//   without a float conversion: nibble ^ 8 = q + 8 goes into the mantissa of
//   128.0 (0x4300 | u = 128 + u, exact), and one bf16x2 subtract of 136 leaves
//   q.  The fragments feed eight wgmma m64n128k16 (A from registers, B = the
//   activation tile through its shared-memory descriptor), issued back to
//   back, into a per-group partial sum; the next step starts by waiting for
//   them, folds the partial sum of a group that ended (acc += part * scale)
//   and converts its own fragments while the other warpgroup's products run,
//   so the two warpgroups alternate on the tensor cores.
// - The epilogue goes through shared memory (the ring, once drained): the
//   accumulators, then the tile's scale, bias and residual rows beside them
//   (16-byte loads, all issued before any is used), then 16-byte stores of
//   whole output rows.  Its last pass is a template on the activation: the
//   code runs once a tile and is fetched cold, so a tile fetches one short
//   branch-free copy.
// Each converted weight tile serves all 128 tokens of the tile; each
// activation tile is read from L2 by the M / 128 CTAs of its token tile.
// What development trials showed (scratch builds, PERF.md): a branch between
// the wgmmas of a step made the compiler close and fence each one; consumers
// did not wait for data, but a 64-deep step had a fixed cost that doubling
// the step's products barely raised, so steps are 128 deep; an inlined,
// unrolled epilogue holding every activation was slow, fetched cold.
//
// f32 activations (the MoE router, rt_int4_matmul_f32): computed in f32 as
// the Pallas kernel computes them; see the section at the end.
#include "common.cuh"

#include <cuda.h>  // CUtensorMap (the encoder is fetched through the runtime)

namespace {

constexpr int KS = 64;  // K of one activation sub-tile: 128 bytes of bf16, the swizzle width

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t nib2(uint32_t v) {
  // two sign-extended nibbles (low nibble first) -> packed bf16x2
  int lo = (int)(v & 0xF), hi = (int)((v >> 4) & 0xF);
  lo = lo > 7 ? lo - 16 : lo;
  hi = hi > 7 ? hi - 16 : hi;
  __nv_bfloat162 p = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// ---- nibbles to bf16 without float conversions -----------------------------

// Byte `sel & 7` of w0 and w1 and of w2 and w3 (sel = tig | (tig + 4) << 4),
// packed in word order: byte i of the result comes from word i.
__device__ __forceinline__ uint32_t gather_bytes(uint32_t w0, uint32_t w1, uint32_t w2,
                                                 uint32_t w3, uint32_t sel) {
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// Four packed bytes -> four bf16x2 words, word i = (low, high nibble) of
// byte i as exact integers in [-8, 7]: u = nibble ^ 8 = q + 8 is OR-ed into
// the mantissa of 128.0 (bf16 0x4300 | u = 128 + u) and 136 is subtracted.
__device__ __forceinline__ void nibbles_to_bf16(uint32_t p, uint32_t (&o)[4]) {
  const uint32_t t = p ^ 0x88888888u;
  const uint32_t a = (t & 0x000F000Fu) | 0x43004300u;          // byte 0, 2 low nibbles
  const uint32_t b = ((t >> 4) & 0x000F000Fu) | 0x43004300u;   // byte 0, 2 high
  const uint32_t c = ((t >> 8) & 0x000F000Fu) | 0x43004300u;   // byte 1, 3 low
  const uint32_t d = ((t >> 12) & 0x000F000Fu) | 0x43004300u;  // byte 1, 3 high
  const uint32_t pairs[4] = {__byte_perm(a, b, 0x5410), __byte_perm(c, d, 0x5410),
                             __byte_perm(a, b, 0x7632), __byte_perm(c, d, 0x7632)};
  const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                 __ushort_as_bfloat16(0x4308));  // 136
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&pairs[i]);
    v = __hsub2(v, bias);
    o[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// The mma A-fragment words of one weight row over 64 of K, from its
// 32 packed bytes (word j holds k = 8j .. 8j + 7): f[b][0] holds k = 16b +
// 2 tig and + 1, f[b][1] k = 16b + 8 + 2 tig and + 1 (tig = lane % 4), which is
// byte tig of every word.
__device__ __forceinline__ void row_fragments(const uint8_t* seg, uint32_t sel,
                                              uint32_t (&f)[4][2]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(seg);
  const uint4 hi = *reinterpret_cast<const uint4*>(seg + 16);
  uint32_t c[4];
  nibbles_to_bf16(gather_bytes(lo.x, lo.y, lo.z, lo.w, sel), c);
  f[0][0] = c[0]; f[0][1] = c[1]; f[1][0] = c[2]; f[1][1] = c[3];
  nibbles_to_bf16(gather_bytes(hi.x, hi.y, hi.z, hi.w, sel), c);
  f[2][0] = c[0]; f[2][1] = c[1]; f[3][0] = c[2]; f[3][1] = c[3];
}

// ---- TMA, cp.async, wgmma (barriers: common.cuh) ------------------------------
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// 4 bytes global -> shared; bytes past `src_bytes` (0, 2 or 4) are zero-filled
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulator registers at this point of the program, so that the
// compiler moves no access to them across a wgmma fence or wait.  Used only
// outside the span from a wgmma to its wait: an access inside it makes the
// compiler serialize the wgmmas.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for a step's A fragments: the conversion must be done before the
// wgmma fence, or the compiler moves it between the wgmmas and has to fence
// each one.
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int b = 0; b < N; ++b)
    asm volatile("" : "+r"(a[b][0]), "+r"(a[b][1]), "+r"(a[b][2]), "+r"(a[b][3])::"memory");
}
// shared-memory descriptor of a K-major tile with 128-byte rows in the
// 128-byte swizzle (8-row groups 1024 bytes apart), as TMA lays it out
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// D (64 weight rows x 128 tokens, f32) += A (64 x 16, bf16 registers) * B (16 x 128,
// the activation tile's descriptor); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Decode path: B <= 16 token rows, 32 outputs per CTA, K split over 8 warps
// by quant groups.  mma rows 0..15 are tokens, columns are outputs.
constexpr int GV_WARPS = 8;

__device__ __forceinline__ uint32_t ld_x2(const __nv_bfloat16* x, int row, int B, long K,
                                          int k) {
  // two consecutive bf16 activations of token `row` as one mma register
  return row < B ? *reinterpret_cast<const uint32_t*>(x + row * K + k) : 0u;
}

__global__ void __launch_bounds__(GV_WARPS * 32)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                 const __nv_bfloat16* __restrict__ scales, const float* __restrict__ ep_scale,
                 const float* __restrict__ ep_bias, const __nv_bfloat16* __restrict__ residual,
                 __nv_bfloat16* __restrict__ out, int B, int K, int M, int group, int act) {
  constexpr int NT = 4;  // n8 tiles per CTA (32 outputs)
  __shared__ float red[GV_WARPS][16][NT * 8 + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_cta = blockIdx.x * NT * 8;
  const int n_groups = K / group;
  float acc[NT][4] = {};

  for (int gi = warp; gi < n_groups; gi += GV_WARPS) {
    float part[NT][4] = {};
#pragma unroll 4
    for (int k = gi * group; k < (gi + 1) * group; k += 32) {
      uint4 w[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n_cta + nt * 8 + gid;
        w[nt] = n < M ? *reinterpret_cast<const uint4*>(qw + (long)n * (K / 2) + k / 2)
                      : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int kb = k + 16 * s;
        if (kb >= (gi + 1) * group) break;
        const uint32_t a[4] = {ld_x2(x, gid, B, K, kb + tig * 2),
                               ld_x2(x, gid + 8, B, K, kb + tig * 2),
                               ld_x2(x, gid, B, K, kb + tig * 2 + 8),
                               ld_x2(x, gid + 8, B, K, kb + tig * 2 + 8)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // this lane's bytes of the 16-byte chunk: 8s + tig (k pair 2 tig) and 8s + 4 + tig
          // (k pair 2 tig + 8), i.e. byte tig of words 2s and 2s + 1
          const uint32_t lo = s ? w[nt].z : w[nt].x, hi = s ? w[nt].w : w[nt].y;
          const uint32_t b[2] = {nib2(lo >> (8 * tig)), nib2(hi >> (8 * tig))};
          mma_bf16(part[nt], a, b);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n_cta + nt * 8 + tig * 2;
      const float s0 = n < M ? __bfloat162float(scales[(long)n * n_groups + gi]) : 0.f;
      const float s1 = n + 1 < M ? __bfloat162float(scales[(long)(n + 1) * n_groups + gi]) : 0.f;
      acc[nt][0] = fmaf(part[nt][0], s0, acc[nt][0]);
      acc[nt][1] = fmaf(part[nt][1], s1, acc[nt][1]);
      acc[nt][2] = fmaf(part[nt][2], s0, acc[nt][2]);
      acc[nt][3] = fmaf(part[nt][3], s1, acc[nt][3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[warp][gid + (e >= 2 ? 8 : 0)][nt * 8 + tig * 2 + (e & 1)] = acc[nt][e];
  __syncthreads();
  for (int i = tid; i < 16 * NT * 8; i += GV_WARPS * 32) {
    const int t = i / (NT * 8), c = i % (NT * 8);
    const int n = n_cta + c;
    if (t >= B || n >= M) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < GV_WARPS; ++w) y += red[w][t][c];
    out[(long)t * M + n] = __float2bfloat16(rt_epilogue(y, ep_scale, ep_bias, residual, act, t, n, M));
  }
}


// ---- prefill: the warp-specialized wgmma GEMM -------------------------------

constexpr int MM_BT = 128;                           // tokens a tile (wgmma N)
constexpr int MM_BN = 128;                           // weight rows a tile (2 x 64)
constexpr int MM_KS = 128;                           // K a step
constexpr int MM_SUBS = MM_KS / KS;                  // 64-deep activation sub-tiles a step
constexpr int MM_BLOCKS = MM_KS / 16;                // wgmma k16 blocks a step
constexpr int MM_STAGES = 4;
constexpr int MM_THREADS = 384;                      // 2 consumer warpgroups + 1 producer
constexpr int X_SUB = MM_BT * KS * 2;                // one 64-deep activation sub-tile
constexpr int X_BYTES = MM_SUBS * X_SUB;
constexpr int W_BYTES = MM_BN * MM_KS / 2;           // packed weight tile
constexpr int SC_BYTES = MM_BLOCKS * MM_BN * 4;      // up to a group a block
constexpr int STAGE_BYTES = X_BYTES + W_BYTES + SC_BYTES;
constexpr int YS_LD = MM_BN + 4;                     // epilogue tile row, conflict-free
constexpr int RS_LD = MM_BN + 8;                     // residual tile row (bf16), 16-byte aligned
constexpr int MM_SMEM = 1024 + MM_STAGES * STAGE_BYTES + 2 * MM_STAGES * 8;
static_assert(STAGE_BYTES % 1024 == 0, "swizzled tiles need 1024-byte alignment");
static_assert(MM_BT * YS_LD * 4 + 2 * MM_BN * 4 + MM_BT * RS_LD * 2 <= MM_STAGES * STAGE_BYTES,
              "the epilogue's tiles reuse the ring");

__device__ __forceinline__ float scale_at(uint32_t word, long e) {
  // the bf16 scale with flat index e from the 4-byte word holding pair e & ~1
  const uint32_t bits = (e & 1) ? (word >> 16) : (word & 0xFFFFu);
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ void fold(float (&acc)[64], const float (&part)[64], float s0,
                                     float s1) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j] = fmaf(part[4 * j], s0, acc[4 * j]);
    acc[4 * j + 1] = fmaf(part[4 * j + 1], s0, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(part[4 * j + 2], s1, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(part[4 * j + 3], s1, acc[4 * j + 3]);
  }
}

// One 128-deep K step of a consumer warpgroup.  It starts by waiting for its
// previous step's products: then that step's stage is released, a group that
// ended with it is folded (acc += part * scale: `pending`, with the scales s0
// and s1 of rows rl and rl + 8), and the A registers are free for this step's
// conversion.  While a warpgroup waits, folds and converts, the other one's
// products keep the tensor cores busy, so the two settle into alternating
// batches.  WHOLE: the step is 128 deep and no group ends inside it (group %
// 128 == 0), so its eight wgmmas issue back to back with no branch between
// them (a branch there makes the compiler close and fence each wgmma on its
// own); else the step walks its blocks and folds a group that ends inside it
// on the spot.
template <bool WHOLE>
__device__ __forceinline__ void mm_step(int kt, int K, int group, int G, int n0, int rl,
                                        uint32_t sel, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, float (&acc)[64], float (&part)[64],
                                        uint32_t (&a)[MM_BLOCKS][4], bool& pending, float& ps0,
                                        float& ps1) {
  const int s = kt % MM_STAGES;
  mbar_wait(&full[s], (kt / MM_STAGES) & 1);
  wgmma_wait<0>();
  if (pending) {
    fence_operands(part);
    fold(acc, part, ps0, ps1);
    fence_operands(part);
    pending = false;
  }
  if (kt > 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[(kt - 1) % MM_STAGES]);
  const uint8_t* st = ring + s * STAGE_BYTES;
#pragma unroll
  for (int h = 0; h < MM_SUBS; ++h) {
    uint32_t f0[4][2], f1[4][2];
    row_fragments(st + X_BYTES + rl * (MM_KS / 2) + 32 * h, sel, f0);
    row_fragments(st + X_BYTES + (rl + 8) * (MM_KS / 2) + 32 * h, sel, f1);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      a[4 * h + b][0] = f0[b][0];
      a[4 * h + b][1] = f1[b][0];
      a[4 * h + b][2] = f0[b][1];
      a[4 * h + b][3] = f1[b][1];
    }
  }
  const uint32_t* sc = reinterpret_cast<const uint32_t*>(st + X_BYTES + W_BYTES);
  uint64_t dx[MM_SUBS];  // the sub-tiles' descriptors; + 2 a block: 32 bytes of k
#pragma unroll
  for (int h = 0; h < MM_SUBS; ++h) dx[h] = desc_sw128(smem_u32(st + h * X_SUB));
  const int k0 = kt * MM_KS;
  fence_operands(a);
  wgmma_fence();
  if (WHOLE) {
#pragma unroll
    for (int b = 0; b < MM_BLOCKS; ++b)
      wgmma_rs_m64n128k16(part, a[b], dx[b / 4] + 2 * (b % 4), b > 0 || k0 % group != 0);
    if ((k0 + MM_KS) % group == 0) {  // the group ends with this step
      const int g = k0 / group;
      pending = true;
      ps0 = scale_at(sc[rl], (long)(n0 + rl) * G + g);
      ps1 = scale_at(sc[rl + 8], (long)(n0 + rl + 8) * G + g);
    }
  } else {
    const int nb = min(MM_BLOCKS, (K - k0) / 16);  // K % 32 == 0: nb >= 2
#pragma unroll
    for (int b = 0; b < MM_BLOCKS; ++b) {
      if (b >= nb) break;
      const int kb = k0 + 16 * b;
      wgmma_rs_m64n128k16(part, a[b], dx[b / 4] + 2 * (b % 4), kb % group != 0);
      if ((kb + 16) % group == 0) {  // the group ends: its partial sums take their scales
        const int g = kb / group, slot = g - k0 / group;
        const float s0 = scale_at(sc[slot * MM_BN + rl], (long)(n0 + rl) * G + g);
        const float s1 = scale_at(sc[slot * MM_BN + rl + 8], (long)(n0 + rl + 8) * G + g);
        if (b == nb - 1) {
          pending = true;
          ps0 = s0;
          ps1 = s1;
        } else {
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(part);
          fold(acc, part, s0, s1);
          fence_operands(part);
          wgmma_fence();
        }
      }
    }
  }
  wgmma_commit();
}

// The tile's last pass: each thread takes 8-column chunks of token rows,
// applies the epilogue (scale -> bias -> activation ACT -> residual, f32) from
// the operands staged beside the tile, and stores 16 bytes a chunk.  ACT is a
// template parameter, so the kernel holds one copy of this code for each
// activation and a tile fetches (cold, once) only its own.
template <int ACT>
__device__ __forceinline__ void finish_tile(const float* ys, const float* es,
                                            const __nv_bfloat16* rs, __nv_bfloat16* out, int B,
                                            int M, int t0, int n0, int vec, bool res) {
#pragma unroll 1
  for (int c = threadIdx.x; c < MM_BT * (MM_BN / 8); c += 256) {
    const int tl = c / (MM_BN / 8), nl = (c % (MM_BN / 8)) * 8;
    const int t = t0 + tl, n = n0 + nl;
    if (t >= B || n >= M) continue;
    const float* y = &ys[tl * YS_LD + nl];
    const __nv_bfloat16* r = &rs[tl * RS_LD + nl];
    const long o = (long)t * M + n;
    if (vec) {  // M % 8 == 0 and 16-byte aligned rows: whole 16-byte chunks
      float v[8], sc[8], bi[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float4*>(v + 4 * h) = *reinterpret_cast<const float4*>(y + 4 * h);
        *reinterpret_cast<float4*>(sc + 4 * h) =
            *reinterpret_cast<const float4*>(es + nl + 4 * h);
        *reinterpret_cast<float4*>(bi + 4 * h) =
            *reinterpret_cast<const float4*>(es + MM_BN + nl + 4 * h);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = v[i] * sc[i] + bi[i];
        if (ACT) v[i] = rt_activation(v[i], ACT);
        if (res) v[i] += __bfloat162float(r[i]);
      }
      __nv_bfloat162 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll 1
      for (int i = 0; i < min(8, M - n); ++i) {
        float u = y[i] * es[nl + i] + es[MM_BN + nl + i];
        if (ACT) u = rt_activation(u, ACT);
        if (res) u += __bfloat162float(r[i]);
        out[o + i] = __float2bfloat16(u);
      }
    }
  }
}

__global__ void __launch_bounds__(MM_THREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                  const __nv_bfloat16* __restrict__ scales, const float* __restrict__ ep_scale,
                  const float* __restrict__ ep_bias, const __nv_bfloat16* __restrict__ residual,
                  __nv_bfloat16* __restrict__ out, int B, int K, int M, int group, int act,
                  int vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + MM_STAGES * STAGE_BYTES);
  uint64_t* empty = full + MM_STAGES;
  const int n0 = blockIdx.x * MM_BN, t0 = blockIdx.y * MM_BT;
  const int nk = (K + MM_KS - 1) / MM_KS, G = K / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < MM_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the producer's expect_tx + its 32 lanes' cp.async
      mbar_init(&empty[s], 8);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one warp feeds the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % MM_STAGES, k0 = kt * MM_KS;
        mbar_wait(&empty[s], ((kt / MM_STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * STAGE_BYTES;
        if (lane == 0) {
          const int subs = min(MM_SUBS, (K - k0 + KS - 1) / KS);  // sub-tiles holding some of K
          mbar_expect_tx(&full[s], subs * X_SUB + W_BYTES);
          for (int h = 0; h < subs; ++h)
            tma_load_2d(st + h * X_SUB, &tmx, &full[s], k0 + h * KS, t0);
          tma_load_2d(st + X_BYTES, &tmw, &full[s], k0 / 2, n0);
        }
        uint32_t* sc = reinterpret_cast<uint32_t*>(st + X_BYTES + W_BYTES);
        const int g0 = k0 / group, g1 = (min(k0 + MM_KS, K) - 1) / group;
        for (int i = lane; i < (g1 - g0 + 1) * MM_BN; i += 32) {
          const int r = i % MM_BN, n = n0 + r;
          const long e = (long)n * G + g0 + i / MM_BN;
          const int bytes = n < M ? ((e | 1) < (long)M * G ? 4 : 2) : 0;
          cp_async_4(sc + i, scales + (bytes ? (e & ~1L) : 0), bytes);
        }
        cp_async_arrive(&full[s]);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {  // consumer warpgroups: 64 weight rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
    const int rl = wg * 64 + (warp % 4) * 16 + gid;  // local weight rows rl and rl + 8
    const uint32_t sel = tig | ((tig + 4) << 4);
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    uint32_t a[MM_BLOCKS][4];
    bool pending = false;
    float ps0 = 0.f, ps1 = 0.f;
    const bool whole = group % MM_KS == 0;  // every step but a shorter last one is whole
    for (int kt = 0; kt < nk; ++kt) {
      if (whole && (kt + 1) * MM_KS <= K)
        mm_step<true>(kt, K, group, G, n0, rl, sel, ring, full, empty, acc, part, a, pending,
                      ps0, ps1);
      else
        mm_step<false>(kt, K, group, G, n0, rl, sel, ring, full, empty, acc, part, a, pending,
                       ps0, ps1);
    }
    wgmma_wait<0>();
    fence_operands(part);
    fold(acc, part, ps0, ps1);  // K ends a group, so the last one is always pending

    // epilogue: accumulators (row = weight row, column = token) into a
    // token-major f32 tile over the drained ring, then whole output rows
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* ys = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ys[(8 * j + 2 * tig + (e & 1)) * YS_LD + rl + (e >= 2 ? 8 : 0)] = acc[4 * j + e];
    // The tile's epilogue operands into shared memory beside it, every load
    // issued before any is used: scale and bias of its 128 columns, and its
    // residual rows (16-byte loads).
    float* es = ys + MM_BT * YS_LD;  // scale [MM_BN], bias [MM_BN]
    __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(es + 2 * MM_BN);  // [MM_BT][RS_LD]
    for (int c = threadIdx.x; c < MM_BN; c += 256) {
      const bool in = n0 + c < M;
      es[c] = ep_scale && in ? ep_scale[n0 + c] : 1.0f;
      es[MM_BN + c] = ep_bias && in ? ep_bias[n0 + c] : 0.0f;
    }
    if (residual) {
#pragma unroll 4
      for (int c = threadIdx.x; c < MM_BT * (MM_BN / 8); c += 256) {
        const int tl = c / (MM_BN / 8), nl = (c % (MM_BN / 8)) * 8;
        const int t = t0 + tl, n = n0 + nl;
        if (t >= B || n >= M) continue;
        __nv_bfloat16* d = rs + tl * RS_LD + nl;
        if (vec) {
          *reinterpret_cast<uint4*>(d) =
              __ldg(reinterpret_cast<const uint4*>(residual + (long)t * M + n));
        } else {
          for (int i = 0; i < min(8, M - n); ++i) d[i] = residual[(long)t * M + n + i];
        }
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    switch (act) {  // one instance a tile: only its code is fetched
      case 0: finish_tile<0>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 1: finish_tile<1>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 2: finish_tile<2>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 3: finish_tile<3>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 4: finish_tile<4>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 5: finish_tile<5>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 6: finish_tile<6>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      default: finish_tile<7>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
    }
  }
}

// The conversion alone, for the card test over all 256 byte values: rows of
// 32 packed bytes -> rows of 64 bf16, each lane writing the words its mma
// fragments hold.
__global__ void int4_unpack_kernel(const uint8_t* __restrict__ packed,
                                   __nv_bfloat16* __restrict__ out, int rows) {
  const int lane = threadIdx.x % 32, tig = lane % 4;
  const int row = blockIdx.x * 8 + lane / 4;
  if (row >= rows) return;
  uint32_t f[4][2];
  row_fragments(packed + row * 32, tig | ((tig + 4) << 4), f);
  uint32_t* o = reinterpret_cast<uint32_t*>(out + row * 64);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    o[8 * b + tig] = f[b][0];      // k = 16b + 2 tig
    o[8 * b + 4 + tig] = f[b][1];  // k = 16b + 8 + 2 tig
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A 2-D row-major tensor map: `cols` x `rows` elements of `bytes` each, a
// box of `box_cols` x `box_rows`; reads past the tensor are zero-filled.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base,
                long cols, long rows, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)(cols * bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dim, stride, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- f32 activations (the MoE router) --------------------------------------
// repro's kernel takes f32 x as well and then computes in f32: weights
// dequantized to f32 (nibble x bf16 scale, exact), f32 products and sums, f32
// out, the epilogue in f32.  The router (6144 -> 8, 7168 -> 384) is the one
// caller: at its widths a chunk's f32 activations (B x K x 4 bytes) and, for
// 384 experts, the 2 B K M operations bound it, and a tile of 64 tokens x 64
// outputs covers the output with a handful of CTAs.  So K is split across
// CTAs until the card has ~two CTAs an SM (the wrapper picks the split), each
// CTA a SIMT tile walking its share of K in 32-deep steps through shared
// memory (x rows coalesced, each packed byte dequantized once into two
// weights), its f32 partial sums to a workspace; a second launch sums the
// splits in order (deterministic) and applies the epilogue.
constexpr int FT = 64, FM = 64, FK = 32, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
int4_f32_partial(const float* __restrict__ x, const uint8_t* __restrict__ qw,
                 const __nv_bfloat16* __restrict__ scales, float* __restrict__ part, int B,
                 int K, int M, int group, int steps_per_split) {
  __shared__ float Xs[FK][FT + 4];
  __shared__ float Ws[FK][FM + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = blockIdx.x * FT, m0 = blockIdx.y * FM, split = blockIdx.z;
  const int k_begin = split * steps_per_split * FK;
  const int k_end = min(K, k_begin + steps_per_split * FK);
  const int groups = K / group;
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += FK) {
#pragma unroll
    for (int j = 0; j < FT * FK / F_THREADS; ++j) {  // 32 consecutive k of a token row
      const int idx = tid + j * F_THREADS, r = idx / FK, kk = idx % FK;
      Xs[kk][r] = t0 + r < B ? x[(long)(t0 + r) * K + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < FM * FK / 2 / F_THREADS; ++j) {  // one packed byte: k even, k + 1
      const int idx = tid + j * F_THREADS, r = idx / (FK / 2), c = idx % (FK / 2);
      const int m = m0 + r, k = k0 + 2 * c;
      float lo = 0.f, hi = 0.f;
      if (m < M) {
        const int b = qw[(long)m * (K / 2) + k / 2];
        const float sc = __bfloat162float(scales[(long)m * groups + k / group]);
        lo = (float)(((b & 0xF) ^ 8) - 8) * sc;  // sign-extended nibbles, low = even k
        hi = (float)(((b >> 4) ^ 8) - 8) * sc;
      }
      Ws[2 * c][r] = lo;
      Ws[2 * c + 1][r] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * j;
      if (t < B && m < M) part[((long)split * B + t) * M + m] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
int4_f32_reduce(const float* __restrict__ part, int splits, const float* __restrict__ ep_scale,
                const float* __restrict__ ep_bias, const float* __restrict__ residual,
                float* __restrict__ out, int B, int M, int act) {
  const long i = (long)blockIdx.x * F_THREADS + threadIdx.x, n = (long)B * M;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[s * n + i];  // in split order
  out[i] = rt_epilogue(v, ep_scale, ep_bias, residual, act, i / M, (int)(i % M), M);
}

}  // namespace

// f32 x (B, K) -> f32 out (B, M) through ``splits`` partial tiles of
// ``steps_per_split`` 32-deep K steps each; ``part`` holds splits * B * M f32.
extern "C" int rt_int4_matmul_f32(const void* x, const void* qweight, const void* scales,
                                  const void* ep_scale, const void* ep_bias,
                                  const void* residual, void* part, void* out, int B, int K,
                                  int M, int group, int splits, int steps_per_split, int act,
                                  void* stream) {
  if (B == 0) return 0;
  if (K % FK || group % 16 || K % group || splits < 1 || (long)splits * steps_per_split * FK < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((B + FT - 1) / FT, (M + FM - 1) / FM, splits);
  int4_f32_partial<<<grid, F_THREADS, 0, st>>>((const float*)x, (const uint8_t*)qweight,
                                                (const __nv_bfloat16*)scales, (float*)part, B, K,
                                                M, group, steps_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long n = (long)B * M;
  int4_f32_reduce<<<(unsigned)((n + F_THREADS - 1) / F_THREADS), F_THREADS, 0, st>>>(
      (const float*)part, splits, (const float*)ep_scale, (const float*)ep_bias,
      (const float*)residual, (float*)out, B, M, act);
  return (int)cudaGetLastError();
}

extern "C" int rt_int4_matmul(const void* x, const void* qweight, const void* scales,
                              const void* ep_scale, const void* ep_bias, const void* residual,
                              void* out, int B, int K, int M, int group, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const auto* xp = (const __nv_bfloat16*)x;
  const auto* qp = (const uint8_t*)qweight;
  const auto* sp = (const __nv_bfloat16*)scales;
  const auto* es = (const float*)ep_scale;
  const auto* eb = (const float*)ep_bias;
  const auto* rp = (const __nv_bfloat16*)residual;
  auto* op = (__nv_bfloat16*)out;
  if (B <= 16) {  // decode: K split over warps, weights streamed once
    int4_gemv_kernel<<<(M + 31) / 32, GV_WARPS * 32, 0, st>>>(xp, qp, sp, es, eb, rp, op, B, K,
                                                             M, group, act);
    return (int)cudaGetLastError();
  }
  CUtensorMap tmx, tmw;
  if (!tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, B, KS, MM_BT,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qweight, K / 2, M, MM_KS / 2, MM_BN,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is set once, not per launch
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int4_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int vec = M % 8 == 0 && ((uintptr_t)out & 15) == 0 && ((uintptr_t)residual & 15) == 0;
  dim3 grid((M + MM_BN - 1) / MM_BN, (B + MM_BT - 1) / MM_BT);
  int4_wgmma_kernel<<<grid, MM_THREADS, MM_SMEM, st>>>(tmx, tmw, sp, es, eb, rp, op, B, K, M,
                                                       group, act, vec);
  return (int)cudaGetLastError();
}

// packed (rows, 32) uint8 -> out (rows, 64) bf16 through the prefill kernel's
// nibble conversion
extern "C" int rt_int4_unpack(const void* packed, void* out, int rows, void* stream) {
  if (rows == 0) return 0;
  int4_unpack_kernel<<<(rows + 7) / 8, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (__nv_bfloat16*)out, rows);
  return (int)cudaGetLastError();
}
