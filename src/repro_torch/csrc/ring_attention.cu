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
// Decode design: the ring is split across CTAs, on a grid (sequence, kv head
// x head tile, split); the wrapper picks the splits for about three CTAs an
// SM (36 splits of 64 entries, 288 CTAs, at recurrentgemma-2b's serve
// shape), so the whole card streams the rings and each K/V row is read once
// for all the query heads of its group.  bf16 queries over bf16 or int8
// rings (ring_decode_mma): a CTA stages its split's entries 64 at a time in
// shared memory (K and V as bf16, int8 dequantized by its per-(entry, head)
// scale, every load of a tile issued before any is used); each of its 4
// warps scores 16 of them against the tile of up to 16 GQA heads (all 10 of
// recurrentgemma-2b's group) with mma.sync, keeps an online softmax per head
// and accumulates P V on the tensor cores; the warps merge in shared memory.
// f32 operands (ring_decode_split) take the same split on the CUDA cores, a
// lane per key.  Each CTA writes f32 partials (m, l, unnormalized o) per
// (sequence, head, split); ring_decode_combine, a second launch, rescales
// and sums them.  Masks come from positions only, so a wrapped ring needs
// nothing else; a tile (or a warp's 16 entries) with no visible key is
// skipped without a read; a split with no visible key writes m = -1e30,
// l = 0, o = 0 and weighs nothing; a row with no visible key at all, or with
// qpos -1, returns 0.
#include "flash_attention.cuh"

namespace {

constexpr int DW = 4;    // warps a decode CTA
constexpr int DCH = 32;  // keys a warp chunk, one a lane
constexpr int GM = 16;   // most GQA heads a CTA
constexpr float DNEG = -1e30f;

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

template <int DH>
constexpr int decode_smem_bytes() {
  return (2 * GM * DH + DW * GM * DCH + 2 * DW * GM) * 4 + DW * DCH * 4;
}

// f32 queries or rings: the CUDA cores, a lane per key, up to GM heads.
// partials: [B][H][S][DH + 2] f32, the unnormalized o then (m, l)
template <int DH, typename TKV>
__global__ void __launch_bounds__(DW * 32)
ring_decode_split(const void* __restrict__ q, int q_bf16, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ kpos,
                  const int* __restrict__ qpos, float* __restrict__ part, int H, int Hkv,
                  int WR, int window, float sm_scale, int S, int kps, int gt) {
  constexpr int DPL = DH / 32;  // output dims a lane
  extern __shared__ float smem[];
  float* q_s = smem;                     // [GM][DH], scaled by sm_scale
  float* o_s = q_s + GM * DH;            // [GM][DH]
  float* p_s = o_s + GM * DH;            // [DW][GM][DCH]
  float* m_s = p_s + DW * GM * DCH;      // [DW][GM]
  float* l_s = m_s + DW * GM;            // [DW][GM]
  int* e_s = reinterpret_cast<int*>(l_s + DW * GM);  // [DW][DCH] entry, -1 = no key

  const int b = blockIdx.x, G = H / Hkv, ngt = G / gt;
  const int kvh = blockIdx.y / ngt, h0 = kvh * G + (blockIdx.y % ngt) * gt;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp = qpos[b];
  if (qp < 0) return;  // the combine writes the zero row
  for (int i = tid; i < gt * DH; i += DW * 32) {
    const long off = ((long)b * H + h0) * DH + i;
    q_s[i] = (q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[off])
                     : static_cast<const float*>(q)[off]) * sm_scale;
  }
  __syncthreads();

  float m[GM], l[GM], acc[GM][DPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = DNEG;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }
  float* my_p = p_s + warp * GM * DCH;
  int* my_e = e_s + warp * DCH;
  const int e0 = split * kps, e1 = min(WR, e0 + kps);
  for (int c0 = e0 + warp * DCH; c0 < e1; c0 += DW * DCH) {
    const int e = c0 + lane;
    const int kp = e < e1 ? kpos[(long)b * WR + e] : -1;
    const bool valid = flash::visible(qp, kp, window);
    if (!__any_sync(0xffffffffu, valid)) continue;  // nothing visible: read nothing
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    if (valid) {
      const long row = ((long)b * WR + e) * Hkv + kvh;
      const TKV* kr = k + row * DH;
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
      if (k_scale) {
        const float ks = k_scale[row];
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] *= ks;
      }
    }
    my_e[lane] = valid ? e : -1;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= gt) break;
      float mx = valid ? s[g] : DNEG;
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
      const int ei = my_e[i];
      if (ei < 0) continue;  // warp-uniform: not visible, p = 0
      const long row = ((long)b * WR + ei) * Hkv + kvh;
      const TKV* vr = v + row * DH + lane * DPL;
      float vv[DPL];
      if constexpr (DPL == 8) {
        ld8f(vr, vv);
      } else {
#pragma unroll
        for (int j = 0; j < DPL; ++j) vv[j] = to_f(vr[j]);
      }
      if (v_scale) {
        const float vs = v_scale[row];
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
    float mx = DNEG;
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
  const long base = ((long)b * H + h0) * S + split;  // partial (head h0, this split)
  for (int i = tid; i < gt * DH; i += DW * 32) {
    const int g = i / DH, d = i % DH;
    part[(base + (long)g * S) * (DH + 2) + d] = o_s[i];
  }
  for (int g = tid; g < gt; g += DW * 32) {
    float mx = DNEG, L = 0.f;
    for (int w = 0; w < DW; ++w) mx = fmaxf(mx, m_s[w * GM + g]);
    for (int w = 0; w < DW; ++w) L = fmaf(expf(m_s[w * GM + g] - mx), l_s[w * GM + g], L);
    float* ml = part + (base + (long)g * S) * (DH + 2) + DH;
    ml[0] = mx;
    ml[1] = L;
  }
}

// bf16 queries over bf16 or int8 rings: the tensor cores.  A CTA's 4 warps
// share tiles of DKT entries, K and V staged in shared memory as bf16 (int8
// dequantized by its per-(entry, head) scale), all loads of a tile issued
// before any is used; each warp scores 16 entries of the tile against the
// CTA's 16 rows (the tile of GQA heads, rows past gt zero): S = Q K^T and
// O += P V as mma.sync m16n8k16, an online softmax per row over its tiles.
constexpr int DKT = 64;  // entries a tile, 16 a warp

template <int DH>
constexpr int decode_mma_smem_bytes() {
  return (16 + 2 * DKT) * (DH + 8) * 2 + DKT * 4 + DW * 16 * 2 * 4;
}

template <int DH, typename TKV>
__global__ void __launch_bounds__(DW * 32)
ring_decode_mma(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k,
                const TKV* __restrict__ v, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const int* __restrict__ kpos,
                const int* __restrict__ qpos, float* __restrict__ part, int H, int Hkv, int WR,
                int window, float sm_scale, int S, int kps, int gt) {
  constexpr int RS = DH + 8;  // padded row stride (bf16) of Q, K and V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][RS]
  __nv_bfloat16* Ks = Qs + 16 * RS;                                // [DKT][RS]
  __nv_bfloat16* Vs = Ks + DKT * RS;                               // [DKT][RS]
  int* kp_s = reinterpret_cast<int*>(Vs + DKT * RS);               // [DKT], -1: not visible
  float* ml_s = reinterpret_cast<float*>(kp_s + DKT);              // [DW][16][2]

  const int b = blockIdx.x, G = H / Hkv, ngt = G / gt;
  const int kvh = blockIdx.y / ngt, h0 = kvh * G + (blockIdx.y % ngt) * gt;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int qp = qpos[b];
  if (qp < 0) return;  // the combine writes the zero row
  for (int c = tid; c < 16 * (DH / 8); c += DW * 32) {
    const int r = c / (DH / 8), d = (c % (DH / 8)) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < gt) u = *reinterpret_cast<const uint4*>(q + ((long)b * H + h0 + r) * DH + d);
    *reinterpret_cast<uint4*>(Qs + r * RS + d) = u;
  }

  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = DNEG, m1 = DNEG, l0 = 0.f, l1 = 0.f;  // rows gid, gid + 8
  const int kb0 = warp * 16;                        // this warp's entries of a tile
  const int e0 = split * kps, e1 = min(WR, e0 + kps);
  for (int t0 = e0; t0 < e1; t0 += DKT) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    bool mine = false;
    if (tid < DKT) {
      const int e = t0 + tid;
      const int kp = e < e1 ? kpos[(long)b * WR + e] : -1;
      mine = flash::visible(qp, kp, window);
      kp_s[tid] = mine ? kp : -1;
    }
    if (!__syncthreads_or(mine)) continue;  // nothing visible in the tile: read nothing
#pragma unroll
    for (int i = 0; i < DKT * DH / 8 / (DW * 32); ++i) {
      const int c = tid + i * DW * 32;
      const int sidx = c / (DH / 8), d = (c % (DH / 8)) * 8;
      __align__(16) __nv_bfloat16 kv[8];
      __align__(16) __nv_bfloat16 vv[8];
      if (kp_s[sidx] >= 0) {
        const long row = ((long)b * WR + t0 + sidx) * Hkv + kvh;
        flash::load8_bf16(k + row * DH + d, k_scale ? k_scale[row] : 1.f, kv);
        flash::load8_bf16(v + row * DH + d, v_scale ? v_scale[row] : 1.f, vv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(Ks + sidx * RS + d) = *reinterpret_cast<uint4*>(kv);
      *reinterpret_cast<uint4*>(Vs + sidx * RS + d) = *reinterpret_cast<uint4*>(vv);
    }
    __syncthreads();
    if (!__any_sync(0xffffffffu, kp_s[kb0 + (lane & 15)] >= 0)) continue;
    // S (16 rows x 16 entries) = Q K^T
    float sc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, Qs + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(bk, Ks + (kb0 + ((lane >> 4) << 3) + (lane & 7)) * RS + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      flash::mma_bf16(sc[0], a, bk[0], bk[1]);
      flash::mma_bf16(sc[1], a, bk[2], bk[3]);
    }
    float mx0 = DNEG, mx1 = DNEG;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kp_s[kb0 + nt * 8 + tig * 2 + (e & 1)] >= 0;
        sc[nt][e] = ok ? sc[nt][e] * sm_scale : DNEG;
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
        const float p = sc[nt][e] > 0.5f * DNEG ? expf(sc[nt][e] - (e < 2 ? mn0 : mn1)) : 0.f;
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
    // O (16 x DH) = O * c + P (bf16) V
    const uint32_t pa[4] = {flash::pack_bf16(sc[0][0], sc[0][1]),
                            flash::pack_bf16(sc[0][2], sc[0][3]),
                            flash::pack_bf16(sc[1][0], sc[1][1]),
                            flash::pack_bf16(sc[1][2], sc[1][3])};
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
        flash::mma_bf16(o[2 * dt + h], pa, bv[2 * h], bv[2 * h + 1]);
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
  float M0 = DNEG, M1 = DNEG, L0 = 0.f, L1 = 0.f;
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
  if (warp > 0) return;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float acc = o[i][e] * (e < 2 ? f0 : f1);
#pragma unroll
      for (int w = 1; w < DW; ++w) acc += red[(((w - 1) * (DH / 8) + i) * 4 + e) * 32 + lane];
      o[i][e] = acc;
    }
  const long base = ((long)b * H + h0) * S + split;  // partial (head h0, this split)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = gid + hf * 8;
    if (r >= gt) continue;
    float* pr = part + (base + (long)r * S) * (DH + 2);
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

template <int DH, typename TKV>
int launch_decode_mma(const flash::Args& a, float* part, int B, int S, int gt, cudaStream_t st) {
  constexpr int smem = decode_mma_smem_bytes<DH>();
  auto kern = ring_decode_mma<DH, TKV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int kps = ((a.WR + S - 1) / S + DKT - 1) / DKT * DKT;  // entries a split
  dim3 grid(B, a.Hkv * ((a.H / a.Hkv) / gt), S);
  kern<<<grid, DW * 32, smem, st>>>((const __nv_bfloat16*)a.q, (const TKV*)a.k, (const TKV*)a.v,
                                    a.k_scale, a.v_scale, a.kpos, a.qpos, part, a.H, a.Hkv, a.WR,
                                    a.window, a.sm_scale, S, kps, gt);
  return (int)cudaGetLastError();
}

template <int DH, typename TKV>
int launch_decode(const flash::Args& a, int q_bf16, float* part, int B, int S, int gt,
                  cudaStream_t st) {
  constexpr int smem = decode_smem_bytes<DH>();
  auto kern = ring_decode_split<DH, TKV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int kps = ((a.WR + S - 1) / S + DCH - 1) / DCH * DCH;  // entries a split
  dim3 grid(B, a.Hkv * ((a.H / a.Hkv) / gt), S);
  kern<<<grid, DW * 32, smem, st>>>(a.q, q_bf16, (const TKV*)a.k, (const TKV*)a.v, a.k_scale,
                                    a.v_scale, a.kpos, a.qpos, part, a.H, a.Hkv, a.WR, a.window,
                                    a.sm_scale, S, kps, gt);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_decode_kv(const flash::Args& a, int q_bf16, int kv_dtype, float* part, int B, int S,
                     int gt, cudaStream_t st) {
  if (kv_dtype == RT_BF16) return launch_decode<DH, __nv_bfloat16>(a, q_bf16, part, B, S, gt, st);
  if (kv_dtype == RT_I8) return launch_decode<DH, int8_t>(a, q_bf16, part, B, S, gt, st);
  return launch_decode<DH, float>(a, q_bf16, part, B, S, gt, st);
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
  flash::Args a{q, k, v, (const float*)k_scale, (const float*)v_scale, nullptr,
                (const int*)kpos, (const int*)qpos, out, 1, H, Hkv, 0, 0, WR, window,
                sm_scale};
  if (Hkv < 1 || H % Hkv || S < 1) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  int gt = G < 16 ? G : 16;  // the largest head tile of at most 16 dividing the group
  while (G % gt) --gt;
  cudaStream_t st = (cudaStream_t)stream;
  float* pt = (float*)part;
  const int qb = q_dtype == RT_BF16;
  int err;
  if (Dh != 256 && Dh != 128 && Dh != 64) return (int)cudaErrorInvalidValue;
  if (qb && (kv_dtype == RT_BF16 || kv_dtype == RT_I8)) {  // the tensor-core path
    const bool i8 = kv_dtype == RT_I8;
    if (Dh == 256)
      err = i8 ? launch_decode_mma<256, int8_t>(a, pt, B, S, gt, st)
               : launch_decode_mma<256, __nv_bfloat16>(a, pt, B, S, gt, st);
    else if (Dh == 128)
      err = i8 ? launch_decode_mma<128, int8_t>(a, pt, B, S, gt, st)
               : launch_decode_mma<128, __nv_bfloat16>(a, pt, B, S, gt, st);
    else
      err = i8 ? launch_decode_mma<64, int8_t>(a, pt, B, S, gt, st)
               : launch_decode_mma<64, __nv_bfloat16>(a, pt, B, S, gt, st);
  } else if (Dh == 256) {
    err = launch_decode_kv<256>(a, qb, kv_dtype, pt, B, S, gt, st);
  } else if (Dh == 128) {
    err = launch_decode_kv<128>(a, qb, kv_dtype, pt, B, S, gt, st);
  } else {
    err = launch_decode_kv<64>(a, qb, kv_dtype, pt, B, S, gt, st);
  }
  if (err) return err;
  if (qb)
    ring_decode_combine<__nv_bfloat16><<<B * H, Dh, 0, st>>>(pt, (const int*)qpos,
                                                             (__nv_bfloat16*)out, H, Dh, S);
  else
    ring_decode_combine<float><<<B * H, Dh, 0, st>>>(pt, (const int*)qpos, (float*)out, H, Dh,
                                                     S);
  return (int)cudaGetLastError();
}
