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
// operations against 989 TFLOP/s).
//
// Design, both paths: the nibbles become exact small integers in bf16 and
// mma.sync m16n8k16 (bf16 -> f32) multiplies them by the activations, so
// each product is exact; the per-group scale is applied once to each
// group's f32 partial sum (acc += partial * scale[n, group]) instead of
// rounding dequantized weights to bf16.  The result differs from the f32
// plain version only in summation order.  The epilogue (scale -> bias ->
// activation -> residual, f32) runs on the accumulators before the one bf16
// store.  Nibble order: low nibble = even k, sign-extended
// (int4_matmul.py:33-37).
//
// Decode (B <= 16): one 16-token row tile.  A CTA owns 32 outputs and its 8
// warps split K by quant groups (warp w takes groups w, w+8, ...); each lane
// reads its weight row's 16-byte chunks straight from device memory into
// mma B fragments, with several chunks in flight, and the activations come
// from L1/L2.  The warps' partial outputs are summed once in shared memory.
// Every weight byte is read once.
//
// Prefill (B > 16): the card has no room to keep K whole next to a tile (K
// runs to 11008), so a CTA owns a 128 x 64 (tokens x outputs) tile and walks
// K in 64-wide steps, staging activations and unpacked nibbles in shared
// memory for eight warps; each unpacked weight tile serves 128 tokens.
#include "common.cuh"

namespace {

constexpr int KS = 64;   // K step
constexpr int NTH = 256; // threads per CTA (8 warps)
constexpr int PAD = 8;   // bf16 row padding: conflict-free fragment loads

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

template <int BT, int BN, int WM, int WN>
__global__ void __launch_bounds__(NTH)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                const __nv_bfloat16* __restrict__ scales, const float* __restrict__ ep_scale,
                const float* __restrict__ ep_bias, const __nv_bfloat16* __restrict__ residual,
                __nv_bfloat16* __restrict__ out, int B, int K, int M, int group, int act) {
  constexpr int MT = BT / WM / 16;  // m16 tiles per warp (tokens)
  constexpr int NTL = BN / WN / 8;  // n8 tiles per warp (outputs)
  __shared__ __align__(16) __nv_bfloat16 Xs[BT][KS + PAD];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][KS + PAD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n_cta = blockIdx.x * BN, t_cta = blockIdx.y * BT;
  const int n_warp = wn * (BN / WN), t_warp = wm * (BT / WM);
  const int n_groups = K / group;

  float acc[MT][NTL][4] = {};
  float part[MT][NTL][4] = {};

  for (int k0 = 0; k0 < K; k0 += KS) {
    // activations: BT x KS bf16 in 16-byte chunks
    for (int c = tid; c < BT * (KS / 8); c += NTH) {
      const int r = c / (KS / 8), kc = (c % (KS / 8)) * 8;
      const int t = t_cta + r, k = k0 + kc;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t < B && k < K) v = *reinterpret_cast<const uint4*>(x + (long)t * K + k);
      *reinterpret_cast<uint4*>(&Xs[r][kc]) = v;
    }
    // packed weights: BN rows x KS/2 bytes in 16-byte chunks (32 nibbles)
    for (int c = tid; c < BN * (KS / 32); c += NTH) {
      const int r = c / (KS / 32), kc = (c % (KS / 32)) * 32;
      const int n = n_cta + r, k = k0 + kc;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n < M && k < K) v = *reinterpret_cast<const uint4*>(qw + (long)n * (K / 2) + k / 2);
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
      uint32_t* dst = reinterpret_cast<uint32_t*>(&Ws[r][kc]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int s = 0; s < 4; ++s) dst[q * 4 + s] = nib2(w4[q] >> (8 * s));
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < KS / 16; ++s) {
      const int kb = s * 16;
      if (k0 + kb >= K) break;
      uint32_t a[MT][4], b[NTL][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = t_warp + mt * 16 + gid;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&Xs[r][kb + tig * 2]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&Xs[r + 8][kb + tig * 2]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&Xs[r][kb + tig * 2 + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&Xs[r + 8][kb + tig * 2 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int n = n_warp + nt * 8 + gid;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&Ws[n][kb + tig * 2]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&Ws[n][kb + tig * 2 + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) mma_bf16(part[mt][nt], a[mt], b[nt]);
      const int kend = k0 + kb + 16;
      if (kend % group == 0) {  // a group closed: fold its partial sums with their scales
        const int gi = kend / group - 1;
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
          const int n = n_cta + n_warp + nt * 8 + tig * 2;
          const float s0 = n < M ? __bfloat162float(scales[(long)n * n_groups + gi]) : 0.f;
          const float s1 = n + 1 < M ? __bfloat162float(scales[(long)(n + 1) * n_groups + gi]) : 0.f;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][nt][0] = fmaf(part[mt][nt][0], s0, acc[mt][nt][0]);
            acc[mt][nt][1] = fmaf(part[mt][nt][1], s1, acc[mt][nt][1]);
            acc[mt][nt][2] = fmaf(part[mt][nt][2], s0, acc[mt][nt][2]);
            acc[mt][nt][3] = fmaf(part[mt][nt][3], s1, acc[mt][nt][3]);
            part[mt][nt][0] = part[mt][nt][1] = part[mt][nt][2] = part[mt][nt][3] = 0.f;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t_cta + t_warp + mt * 16 + gid + (e >= 2 ? 8 : 0);
        const int n = n_cta + n_warp + nt * 8 + tig * 2 + (e & 1);
        if (t < B && n < M)
          out[(long)t * M + n] = __float2bfloat16(
              rt_epilogue(acc[mt][nt][e], ep_scale, ep_bias, residual, act, t, n, M));
      }
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

}  // namespace

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
  } else {
    dim3 grid((M + 63) / 64, (B + 127) / 128);
    int4_mma_kernel<128, 64, 4, 2><<<grid, NTH, 0, st>>>(xp, qp, sp, es, eb, rp, op, B, K, M,
                                                        group, act);
  }
  return (int)cudaGetLastError();
}
