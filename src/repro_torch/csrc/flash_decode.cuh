// Split-KV decode attention (one query token a sequence) shared by the ring
// layout (ring_attention.cu) and the paged layout (paged_attention.cu).
//
// The grid is (sequence, kv head x head tile, split).  A CTA takes the
// entries [split * kps, (split + 1) * kps) of its sequence and the tile of
// up to GM query heads of one GQA group; a layout only decides how an entry
// index becomes a pool row and a position:
//
// * ring (PAGED = false): entry e is row (b, e) of the (B, WR, Hkv, Dh)
//   ring, its position kpos[b, e] (-1 = empty);
// * paged (PAGED = true): entry e is position e, stored at row
//   bt[b, e / BS] * BS + e % BS of the (NB, BS, Hkv, Dh) pool.  A split that
//   lies past the sequence's qpos reads nothing and writes nothing.
//
// bf16 queries over bf16 or int8 K/V take the tensor cores (decode_mma): the
// CTA's 4 warps share tiles of DKT entries staged in shared memory, the
// entries' pool rows resolved first and then every load of the tile issued
// before any is used; each warp scores 16 entries against the 16 rows of the
// head tile (rows past gt zero) with mma.sync m16n8k16, keeps an online
// softmax per row and accumulates P V on the tensor cores; the warps merge
// in shared memory.  bf16 K and V are staged as they are.  int8 K and V are
// staged once a tile as their exact integers in f16 (a byte permute and a
// half2 subtraction for two values, where int-to-float conversions run at a
// quarter of the ALU rate), Q goes to f16, and the per-(entry, head) f32
// scales go on the scores (K) and on P (V): the product rounds less than
// scaling K and V to bf16 would.  Any f32 operand takes
// decode_simt: the same split on the CUDA cores, a lane per entry.
//
// Each CTA ends with f32 partials (unnormalized o, m, l) per (sequence, head,
// split).  The ring layout combines them in a second launch
// (ring_attention.cu).  The paged layout merges them in the same launch
// (paged_merge): after its partials a CTA fences and counts itself on a
// per-(sequence, head tile) counter; the CTA that arrives last resets the
// counter to 0 and merges every live split in split order, so the result is
// the same bit for bit from run to run.  Masks come from positions only; a
// tile with no visible entry is skipped unread; a row with no visible key, or
// with qpos -1, returns 0, never NaN.
#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "flash_attention.cuh"

namespace flash {

constexpr int DW = 4;          // warps a decode CTA
constexpr int DCH = 32;        // entries a warp chunk of decode_simt, one a lane
constexpr int GM = 16;         // most GQA heads a CTA
constexpr int DKT = 64;        // entries a tile of decode_mma, 16 a warp
constexpr int MERGE_SMAX = 64; // most splits the in-launch merge takes

struct DecodeArgs {
  const void* q;         // (B, H, Dh), f32 or bf16 (q_bf16)
  const void* k;         // ring (B, WR, Hkv, Dh) | paged (NB, BS, Hkv, Dh)
  const void* v;
  const float* k_scale;  // int8: ring (B, WR, Hkv) | paged (NB, BS, Hkv), else null
  const float* v_scale;
  const int* bt;         // paged: (B, W) block table
  const int* kpos;       // ring: (B, WR) entry positions, -1 = empty
  const int* qpos;       // (B,), -1 = inactive row
  float* part;           // [B][H][S][Dh + 2]: the unnormalized o, then (m, l)
  int* count;            // paged: [B][Hkv * head tiles], 0 between launches
  void* out;             // paged: (B, H, Dh) of q's type
  int H, Hkv, NE, BS, W, window;  // NE: entries a sequence (WR | W * BS)
  float sm_scale;
  int S, kps, gt, q_bf16;
};

// Position of entry e of sequence b (-1: empty or past the entries).
template <bool PAGED>
__device__ __forceinline__ int dec_pos(const DecodeArgs& a, int b, int e) {
  if (e >= a.NE) return -1;
  return PAGED ? e : a.kpos[(long)b * a.NE + e];
}

// Pool row of entry e of sequence b, kv head kvh, in the (.., Hkv, Dh) layout.
template <bool PAGED>
__device__ __forceinline__ int dec_row(const DecodeArgs& a, int b, int e, int kvh) {
  if (!PAGED) return (b * a.NE + e) * a.Hkv + kvh;
  const int blk = a.bt[(long)b * a.W + e / a.BS];
  return (blk * a.BS + e % a.BS) * a.Hkv + kvh;
}

__device__ __forceinline__ void dec_store(const DecodeArgs& a, long i, float x) {
  if (a.q_bf16) static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16(x);
  else static_cast<float*>(a.out)[i] = x;
}

struct DecodeCta {
  int b, kvh, h0, split, qp, n_live, e0, e1;
};

// The CTA's coordinates; false when it has nothing to do.  Paged: an
// inactive row's zeros are written by its split 0, and splits past qpos
// (split * kps > qpos) neither read nor write.
template <bool PAGED, int DH>
__device__ __forceinline__ bool decode_begin(const DecodeArgs& a, DecodeCta& c) {
  const int G = a.H / a.Hkv, ngt = G / a.gt;
  c.b = blockIdx.x;
  c.kvh = blockIdx.y / ngt;
  c.h0 = c.kvh * G + (blockIdx.y % ngt) * a.gt;
  c.split = blockIdx.z;
  c.qp = a.qpos[c.b];
  c.e0 = c.split * a.kps;
  c.e1 = min(a.NE, c.e0 + a.kps);
  c.n_live = a.S;
  if (c.qp < 0) {
    if (PAGED && c.split == 0)
      for (int i = threadIdx.x; i < a.gt * DH; i += blockDim.x)
        dec_store(a, ((long)c.b * a.H + c.h0) * DH + i, 0.f);
    return false;
  }
  if (PAGED) {
    c.n_live = min(a.S, c.qp / a.kps + 1);
    if (c.split >= c.n_live) return false;
    c.e1 = min(c.e1, c.qp + 1);  // entries past qpos are never visible
  }
  return true;
}

// Paged, after the CTA's partials are written (by any of its threads): count
// the CTA on its (sequence, head tile) counter; the last of the n_live splits
// to arrive resets the counter and merges the partials in split order into
// the output.  Every load of a step is independent of the others: the (m, l)
// of all splits at once, then the o of each output over the splits, a few
// splits in flight.  ``scratch`` holds MERGE_FLOATS floats.
constexpr int MERGE_FLOATS = GM * (2 * MERGE_SMAX + 1);
template <int DH>
__device__ void paged_merge(const DecodeArgs& a, const DecodeCta& c, float* scratch) {
  constexpr int NTH = DW * 32;
  constexpr int PER = GM * DH / NTH;  // outputs a thread
  __shared__ int last;
  __threadfence();  // this CTA's partials are visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    int* cnt = a.count + (long)c.b * gridDim.y + blockIdx.y;
    last = atomicAdd(cnt, 1) == c.n_live - 1;
    if (last) *cnt = 0;  // every live split has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n = c.n_live, gt = a.gt, tid = threadIdx.x;
  float* wgt = scratch;                     // [gt][MERGE_SMAX]: m, then exp(m - M)
  float* ls = scratch + GM * MERGE_SMAX;    // [gt][MERGE_SMAX]: l
  float* lsum = ls + GM * MERGE_SMAX;       // [gt]
  const float* pb = a.part + ((long)c.b * a.H + c.h0) * a.S * (DH + 2);
  for (int x = tid; x < gt * n; x += NTH) {
    const int g = x / n, sp = x % n;
    const float* p = pb + ((long)g * a.S + sp) * (DH + 2) + DH;
    wgt[g * MERGE_SMAX + sp] = __ldcg(p);
    ls[g * MERGE_SMAX + sp] = __ldcg(p + 1);
  }
  __syncthreads();
  for (int g = tid; g < gt; g += NTH) {
    float M = NEG_INF;
    for (int sp = 0; sp < n; ++sp) M = fmaxf(M, wgt[g * MERGE_SMAX + sp]);
    float L = 0.f;
    for (int sp = 0; sp < n; ++sp) {
      const float w = expf(wgt[g * MERGE_SMAX + sp] - M);
      wgt[g * MERGE_SMAX + sp] = w;
      L = fmaf(w, ls[g * MERGE_SMAX + sp], L);
    }
    lsum[g] = L;
  }
  __syncthreads();
  float O[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) O[m] = 0.f;
#pragma unroll 2
  for (int sp = 0; sp < n; ++sp) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int i = tid + m * NTH, g = i / DH;
      if (g < gt)
        O[m] = fmaf(wgt[g * MERGE_SMAX + sp], __ldcg(pb + ((long)g * a.S + sp) * (DH + 2) + i % DH),
                    O[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = tid + m * NTH, g = i / DH;
    if (g < gt) {
      const float L = lsum[g];
      dec_store(a, ((long)c.b * a.H + c.h0) * DH + i, L > 0.f ? O[m] / fmaxf(L, 1e-30f) : 0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void ld8f(const T* p, float (&o)[8]);
template <>
__device__ __forceinline__ void ld8f<__nv_bfloat16>(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    o[2 * j] = f.x;
    o[2 * j + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void ld8f<float>(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
template <>
__device__ __forceinline__ void ld8f<int8_t>(const int8_t* p, float (&o)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = (float)c[j];
}

// ---- f32 operands: the CUDA cores, a lane per entry, up to GM heads ---------
template <int DH>
constexpr int decode_simt_smem_bytes() {
  return (2 * GM * DH + DW * GM * DCH + 2 * DW * GM) * 4 + DW * DCH * 4;
}

template <int DH, typename TKV, bool PAGED>
__global__ void __launch_bounds__(DW * 32) decode_simt(DecodeArgs a) {
  constexpr int DPL = DH / 32;  // output dims a lane
  static_assert(DW * GM * DCH + 2 * DW * GM >= MERGE_FLOATS, "merge scratch: p_s, m_s, l_s");
  extern __shared__ float smem[];
  float* q_s = smem;                     // [GM][DH], scaled by sm_scale
  float* o_s = q_s + GM * DH;            // [GM][DH]
  float* p_s = o_s + GM * DH;            // [DW][GM][DCH]
  float* m_s = p_s + DW * GM * DCH;      // [DW][GM]
  float* l_s = m_s + DW * GM;            // [DW][GM]
  int* r_s = reinterpret_cast<int*>(l_s + DW * GM);  // [DW][DCH] pool row, -1 = no key

  DecodeCta c;
  if (!decode_begin<PAGED, DH>(a, c)) return;
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  const int gt = a.gt, b = c.b, kvh = c.kvh, qp = c.qp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < gt * DH; i += DW * 32) {
    const long off = ((long)b * a.H + c.h0) * DH + i;
    q_s[i] = (a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off])
                       : static_cast<const float*>(a.q)[off]) * a.sm_scale;
  }
  __syncthreads();

  float m[GM], l[GM], acc[GM][DPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }
  float* my_p = p_s + warp * GM * DCH;
  int* my_r = r_s + warp * DCH;
  for (int c0 = c.e0 + warp * DCH; c0 < c.e1; c0 += DW * DCH) {
    const int e = c0 + lane;
    const int kp = e < c.e1 ? dec_pos<PAGED>(a, b, e) : -1;
    const bool valid = visible(qp, kp, a.window);
    if (!__any_sync(0xffffffffu, valid)) continue;  // nothing visible: read nothing
    const int row = valid ? dec_row<PAGED>(a, b, e, kvh) : -1;
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    if (valid) {
      const TKV* kr = k + (long)row * DH;
#pragma unroll 4
      for (int d0 = 0; d0 < DH; d0 += 8) {
        float kv[8];
        ld8f(kr + d0, kv);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < gt) {
#pragma unroll
            for (int j = 0; j < 8; ++j) s[g] = fmaf(q_s[g * DH + d0 + j], kv[j], s[g]);
          }
        }
      }
      if (a.k_scale) {
        const float ks = a.k_scale[row];
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] *= ks;
      }
    }
    my_r[lane] = row;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= gt) break;
      float mx = valid ? s[g] : NEG_INF;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      const float p = valid ? expf(s[g] - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[g] = l[g] * corr + sum;
      m[g] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= corr;
      my_p[g * DCH + lane] = p;
    }
    __syncwarp();
    for (int i = 0; i < DCH; ++i) {
      const int ri = my_r[i];
      if (ri < 0) continue;  // warp-uniform: not visible, p = 0
      const TKV* vr = v + (long)ri * DH + lane * DPL;
      float vv[DPL];
      if constexpr (DPL == 8) {
        ld8f(vr, vv);
      } else {
#pragma unroll
        for (int j = 0; j < DPL; ++j) vv[j] = to_f(vr[j]);
      }
      if (a.v_scale) {
        const float vs = a.v_scale[ri];
#pragma unroll
        for (int j = 0; j < DPL; ++j) vv[j] *= vs;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= gt) break;
        const float p = my_p[g * DCH + i];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
      }
    }
    __syncwarp();
  }

  // merge the warps: each scales its o by exp(m_w - M) into o_s, one at a time
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m_s[warp * GM + g] = m[g];
      l_s[warp * GM + g] = l[g];
    }
  }
  __syncthreads();
  float f[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DW; ++w) mx = fmaxf(mx, m_s[w * GM + g]);
    f[g] = expf(m[g] - mx);
  }
  for (int w = 0; w < DW; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= gt) break;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          float* o = o_s + g * DH + lane * DPL + j;
          *o = (w ? *o : 0.f) + f[g] * acc[g][j];
        }
      }
    }
    __syncthreads();
  }
  const long base = ((long)b * a.H + c.h0) * a.S + c.split;  // partial (head h0, this split)
  for (int i = tid; i < gt * DH; i += DW * 32) {
    const int g = i / DH, d = i % DH;
    a.part[(base + (long)g * a.S) * (DH + 2) + d] = o_s[i];
  }
  for (int g = tid; g < gt; g += DW * 32) {
    float mx = NEG_INF, L = 0.f;
    for (int w = 0; w < DW; ++w) mx = fmaxf(mx, m_s[w * GM + g]);
    for (int w = 0; w < DW; ++w) L = fmaf(expf(m_s[w * GM + g] - mx), l_s[w * GM + g], L);
    float* ml = a.part + (base + (long)g * a.S) * (DH + 2) + DH;
    ml[0] = mx;
    ml[1] = L;
  }
  if constexpr (PAGED) paged_merge<DH>(a, c, p_s);
}

// 16 int8 values (a 16-byte load) into shared memory as 16 exact f16 values:
// byte b ^ 0x80 under the exponent byte 0x64 is the half 1024 + b + 128, so
// one byte permute and one half2 subtraction convert two values (no
// int-to-float conversion, which runs at a quarter of the ALU rate).
__device__ __forceinline__ void store_i8_as_f16(__nv_bfloat16* dst, const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  const __half2 bias = __half2half2(__ushort_as_half((unsigned short)0x6480));  // 1152
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t x = w[j] ^ 0x80808080u;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t t = __byte_perm(x, 0x64646464u, hf ? 0x4342 : 0x4140);
      __half2 h = __hsub2(*reinterpret_cast<__half2*>(&t), bias);
      o[2 * j + hf] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
}

// d += a b, m16n8k16, f32 accumulate: bf16 operands, or f16 (F16)
template <bool F16>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (F16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    mma_bf16(d, a, b0, b1);
  }
}
template <bool F16>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (F16) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    return pack_bf16(lo, hi);
  }
}

// ---- bf16 queries over bf16 or int8 K/V: the tensor cores -------------------
template <int DH>
constexpr int decode_mma_smem_bytes() {
  return (16 + 2 * DKT) * (DH + 8) * 2 + 4 * DKT * 4 + DW * 16 * 2 * 4;
}

template <int DH, typename TKV, bool PAGED>
__global__ void __launch_bounds__(DW * 32) decode_mma(DecodeArgs a) {
  // int8 K/V are staged as their exact integers in f16, with Q in f16, and
  // the scales go on the scores (K) and on P (V) in f32
  constexpr bool I8 = std::is_same<TKV, int8_t>::value;
  constexpr int RS = DH + 8;  // padded row stride (16-bit values) of Q, K and V
  constexpr int EPL = 16 / (int)sizeof(TKV);         // values a 16-byte load
  constexpr int NLD = DKT * DH / EPL / (DW * 32);     // loads a thread a tile, of K and of V
  constexpr int LB = NLD < 4 ? NLD : 4;               // loads in flight a batch
  static_assert(NLD % LB == 0, "load batches");
  static_assert(DKT * RS >= MERGE_FLOATS, "merge scratch: K and V as floats");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][RS]
  __nv_bfloat16* Ks = Qs + 16 * RS;                                // [DKT][RS]
  __nv_bfloat16* Vs = Ks + DKT * RS;                               // [DKT][RS]
  int* kp_s = reinterpret_cast<int*>(Vs + DKT * RS);               // [DKT], -1: not visible
  int* row_s = kp_s + DKT;                                         // [DKT] pool rows
  float* ksc_s = reinterpret_cast<float*>(row_s + DKT);            // [DKT] int8 scales
  float* vsc_s = ksc_s + DKT;                                      // [DKT]
  float* ml_s = vsc_s + DKT;                                       // [DW][16][2]

  DecodeCta c;
  if (!decode_begin<PAGED, DH>(a, c)) return;
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const int gt = a.gt, b = c.b, kvh = c.kvh, qp = c.qp;
  const float sm_scale = a.sm_scale;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  for (int i = tid; i < 16 * (DH / 8); i += DW * 32) {
    const int r = i / (DH / 8), d = (i % (DH / 8)) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < gt) u = *reinterpret_cast<const uint4*>(q + ((long)b * a.H + c.h0 + r) * DH + d);
    if constexpr (I8) {  // bf16 -> f16
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __half h = __float2half_rn(__bfloat162float(e[j]));
        e[j] = *reinterpret_cast<const __nv_bfloat16*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * RS + d) = u;
  }

  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows gid, gid + 8
  const int kb0 = warp * 16;                              // this warp's entries of a tile
  for (int t0 = c.e0; t0 < c.e1; t0 += DKT) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    bool mine = false;
    if (tid < DKT) {
      const int e = t0 + tid;
      const int kp = e < c.e1 ? dec_pos<PAGED>(a, b, e) : -1;
      mine = visible(qp, kp, a.window);
      kp_s[tid] = mine ? kp : -1;
      const int row = mine ? dec_row<PAGED>(a, b, e, kvh) : 0;
      row_s[tid] = row;
      if (I8) {  // 0 for an entry not visible: its p is 0 and must stay 0
        ksc_s[tid] = mine ? a.k_scale[row] : 0.f;
        vsc_s[tid] = mine ? a.v_scale[row] : 0.f;
      }
    }
    if (!__syncthreads_or(mine)) continue;  // nothing visible in the tile: read nothing
    // K and V, 16 bytes a load (8 bf16 or 16 int8 values), the loads of a
    // batch all issued before their values are stored
#pragma unroll
    for (int i0 = 0; i0 < NLD; i0 += LB) {
      uint4 kr[LB], vr[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int ci = tid + (i0 + j) * DW * 32, sidx = ci / (DH / EPL);
        const int d = (ci % (DH / EPL)) * EPL;
        kr[j] = vr[j] = make_uint4(0, 0, 0, 0);
        if (kp_s[sidx] >= 0) {
          const long row = row_s[sidx];
          kr[j] = *reinterpret_cast<const uint4*>(k + row * DH + d);
          vr[j] = *reinterpret_cast<const uint4*>(v + row * DH + d);
        }
      }
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int ci = tid + (i0 + j) * DW * 32, sidx = ci / (DH / EPL);
        const int d = (ci % (DH / EPL)) * EPL;
        if constexpr (I8) {
          store_i8_as_f16(Ks + sidx * RS + d, kr[j]);
          store_i8_as_f16(Vs + sidx * RS + d, vr[j]);
        } else {
          *reinterpret_cast<uint4*>(Ks + sidx * RS + d) = kr[j];
          *reinterpret_cast<uint4*>(Vs + sidx * RS + d) = vr[j];
        }
      }
    }
    __syncthreads();
    if (!__any_sync(0xffffffffu, kp_s[kb0 + (lane & 15)] >= 0)) continue;
    // S (16 rows x 16 entries) = Q K^T
    float sc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4], bk[4];
      ldsm_x4(qa, Qs + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(bk, Ks + (kb0 + ((lane >> 4) << 3) + (lane & 7)) * RS + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma16<I8>(sc[0], qa, bk[0], bk[1]);
      mma16<I8>(sc[1], qa, bk[2], bk[3]);
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb0 + nt * 8 + tig * 2 + (e & 1);
        const bool ok = kp_s[key] >= 0;
        sc[nt][e] = ok ? sc[nt][e] * (I8 ? sm_scale * ksc_s[key] : sm_scale) : NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, sc[nt][e]);
        else mx1 = fmaxf(mx1, sc[nt][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[nt][e] > 0.5f * NEG_INF ? expf(sc[nt][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        sc[nt][e] = p;
        if (e < 2) sum0 += p;
        else sum1 += p;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
    // O (16 x DH) = O * c + P V, P in bf16 (int8: P times the V scales, in f16)
    if constexpr (I8) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] *= vsc_s[kb0 + nt * 8 + tig * 2 + (e & 1)];
    }
    const uint32_t pa[4] = {pack16<I8>(sc[0][0], sc[0][1]), pack16<I8>(sc[0][2], sc[0][3]),
                            pack16<I8>(sc[1][0], sc[1][1]), pack16<I8>(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dt = 0; dt < DH / 16; ++dt) {
      uint32_t bv[4];
      ldsm_x4_t(bv, Vs + (kb0 + (lane & 15)) * RS + dt * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* oo = o[2 * dt + h];
        oo[0] *= c0;
        oo[1] *= c0;
        oo[2] *= c1;
        oo[3] *= c1;
        mma16<I8>(o[2 * dt + h], pa, bv[2 * h], bv[2 * h + 1]);
      }
    }
  }

  // merge the 4 warps: rescale each to the rows' largest m, sum into warp 0
  __syncthreads();
  if (tig == 0) {
    ml_s[(warp * 16 + gid) * 2] = m0;
    ml_s[(warp * 16 + gid) * 2 + 1] = l0;
    ml_s[(warp * 16 + gid + 8) * 2] = m1;
    ml_s[(warp * 16 + gid + 8) * 2 + 1] = l1;
  }
  __syncthreads();
  float M0 = NEG_INF, M1 = NEG_INF, L0 = 0.f, L1 = 0.f;
#pragma unroll
  for (int w = 0; w < DW; ++w) {
    M0 = fmaxf(M0, ml_s[(w * 16 + gid) * 2]);
    M1 = fmaxf(M1, ml_s[(w * 16 + gid + 8) * 2]);
  }
#pragma unroll
  for (int w = 0; w < DW; ++w) {
    L0 = fmaf(expf(ml_s[(w * 16 + gid) * 2] - M0), ml_s[(w * 16 + gid) * 2 + 1], L0);
    L1 = fmaf(expf(ml_s[(w * 16 + gid + 8) * 2] - M1), ml_s[(w * 16 + gid + 8) * 2 + 1], L1);
  }
  const float f0 = expf(m0 - M0), f1 = expf(m1 - M1);
  float* red = reinterpret_cast<float*>(Ks);  // [DW - 1][DH / 8][4][32], over K and V
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(((warp - 1) * (DH / 8) + i) * 4 + e) * 32 + lane] = o[i][e] * (e < 2 ? f0 : f1);
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float acc = o[i][e] * (e < 2 ? f0 : f1);
#pragma unroll
        for (int w = 1; w < DW; ++w) acc += red[(((w - 1) * (DH / 8) + i) * 4 + e) * 32 + lane];
        o[i][e] = acc;
      }
    const long base = ((long)b * a.H + c.h0) * a.S + c.split;  // partial (head h0, this split)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = gid + hf * 8;
      if (r >= gt) continue;
      float* pr = a.part + (base + (long)r * a.S) * (DH + 2);
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        pr[i * 8 + tig * 2] = o[i][2 * hf];
        pr[i * 8 + tig * 2 + 1] = o[i][2 * hf + 1];
      }
      if (tig == 0) {
        pr[DH] = hf ? M1 : M0;
        pr[DH + 1] = hf ? L1 : L0;
      }
    }
  }
  if constexpr (PAGED) {
    __syncthreads();  // warp 0 has read `red` before the merge reuses K and V
    paged_merge<DH>(a, c, reinterpret_cast<float*>(Ks));
  }
}

// Launch the split pass: decode_mma for bf16 queries over bf16 or int8 K/V,
// decode_simt for any f32 operand.  Grid (B, Hkv * head tiles, S).
template <int DH, typename TKV, bool PAGED>
int launch_decode_typed(const DecodeArgs& a, int B, bool mma, cudaStream_t st) {
  dim3 grid(B, a.Hkv * ((a.H / a.Hkv) / a.gt), a.S);
  if (mma) {
    if constexpr (std::is_same<TKV, float>::value) {
      return (int)cudaErrorInvalidValue;
    } else {
      constexpr int smem = decode_mma_smem_bytes<DH>();
      auto kern = decode_mma<DH, TKV, PAGED>;
      cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e == cudaSuccess)  // all of the SM's shared memory: room for 4-5 CTAs
        e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
      if (e != cudaSuccess) return (int)e;
      kern<<<grid, DW * 32, smem, st>>>(a);
    }
  } else {
    constexpr int smem = decode_simt_smem_bytes<DH>();
    auto kern = decode_simt<DH, TKV, PAGED>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, DW * 32, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The split pass for head dims 64, 128 and 256; gt = the largest head tile
// of at most GM dividing the group.
template <bool PAGED>
int launch_decode(DecodeArgs a, int B, int Dh, int q_dtype, int kv_dtype, cudaStream_t st) {
  if (a.Hkv < 1 || a.H % a.Hkv || a.S < 1 || a.kps < 1) return (int)cudaErrorInvalidValue;
  const int G = a.H / a.Hkv;
  a.gt = G < GM ? G : GM;
  while (G % a.gt) --a.gt;
  a.q_bf16 = q_dtype == RT_BF16;
  const bool mma = a.q_bf16 && (kv_dtype == RT_BF16 || kv_dtype == RT_I8);
#define RT_DEC(D)                                                                           \
  if (Dh == D) {                                                                            \
    if (kv_dtype == RT_BF16) return launch_decode_typed<D, __nv_bfloat16, PAGED>(a, B, mma, st); \
    if (kv_dtype == RT_I8) return launch_decode_typed<D, int8_t, PAGED>(a, B, mma, st);        \
    return launch_decode_typed<D, float, PAGED>(a, B, false, st);                           \
  }
  RT_DEC(256) RT_DEC(128) RT_DEC(64)
#undef RT_DEC
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
