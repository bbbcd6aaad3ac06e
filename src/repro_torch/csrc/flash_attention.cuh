// Flash-attention CTA bodies shared by the paged and the ring layouts of the
// chunked-prefill kernel (prefill_attention.cu, ring_attention.cu).
//
// One CTA per (sequence, tile of 64 query rows, kv head).  A row is a
// (query position, GQA head) pair of one kv head: 64 positions for G = 1,
// 4 positions x 16 heads for G = 16, 6 positions x 10 heads (60 rows, 4 left
// idle) for G = 10, so every K/V tile read from device memory serves up to
// 64 rows whatever the group size.  K/V stay in device memory and are read
// one 64-key tile at a time:
//
// * paged (RING = false): keys are the sequence's positions 0 .. max qpos of
//   the CTA's rows, read through the block table; entry e holds position e,
//   so an all-padding tile runs zero iterations;
// * ring (RING = true): keys are the WR entries of the sequence's ring, in
//   ring order, which is not position order once the ring has wrapped.  The
//   trip count is static (WR / 64 tiles); each entry's position comes from
//   kpos (-1 = empty: never attended, never read).
//
// Every mask comes from the key's position, never from its index: a key is
// visible to a row iff kpos >= 0, qpos >= 0, kpos <= qpos and (window == 0
// or qpos - kpos < window).  Masking follows kernels/ref.py (-1e30, then x
// valid after the exp), so a fully masked row writes 0, not NaN.
//
// bf16 queries over bf16 or int8 K/V run on the tensor cores: 4 warps own 16
// rows each, S = Q K^T and O += P V are mma.sync m16n8k16 bf16 -> f32 with
// the probabilities reused from the score registers, and the online softmax
// runs on the accumulator fragments.  int8 payloads are dequantized with
// their f32 per-(entry, head) scales into the bf16 tile.  At head_dim 256
// the O accumulator alone takes 128 registers a thread, so the Q fragments
// are read from shared memory per key tile instead of being held in
// registers (head_dim <= 128 keeps them in registers).  Any f32 operand
// takes an f32 CUDA-core path with the same tiling.
#pragma once

#include "common.cuh"

namespace flash {

constexpr int RMAX = 64;  // query rows per CTA
constexpr int KT = 64;    // keys per tile
constexpr int SIMT_NTH = 256;
constexpr int MMA_NTH = 128;  // 4 warps x 16 rows
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;         // (B, Sq, H, Dh)
  const void* k;         // paged (NB, BS, Hkv, Dh) | ring (B, WR, Hkv, Dh)
  const void* v;
  const float* k_scale;  // paged (NB, BS, Hkv) | ring (B, WR, Hkv), or null
  const float* v_scale;
  const int* bt;         // paged: (B, W) block table
  const int* kpos;       // ring: (B, WR) entry positions, -1 = empty
  const int* qpos;       // (B, Sq), -1 = padding row
  void* out;             // (B, Sq, H, Dh)
  int Sq, H, Hkv, BS, W, WR, window;
  float sm_scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  return qp >= 0 && kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
}

// Key tiles a CTA walks: the ring's static count, or the paged keys 0..n_keys-1.
template <bool RING>
__device__ __forceinline__ int n_key_tiles(const Args& a, int n_keys) {
  return RING ? (a.WR + KT - 1) / KT : (n_keys + KT - 1) / KT;
}

// Position of entry e of sequence b (-1: nothing there / beyond the keys).
template <bool RING>
__device__ __forceinline__ int entry_pos(const Args& a, int b, int e, int n_keys) {
  if (RING) return e < a.WR ? a.kpos[(long)b * a.WR + e] : -1;
  return e < n_keys ? e : -1;
}

// Row of entry e of sequence b, kv head kvh, in the (.., Hkv) K/V layout.
template <bool RING>
__device__ __forceinline__ long entry_row(const Args& a, int b, int e, int kvh) {
  if (RING) return ((long)b * a.WR + e) * a.Hkv + kvh;
  const long blk = a.bt[(long)b * a.W + e / a.BS];
  return (blk * a.BS + e % a.BS) * a.Hkv + kvh;
}

// ---- f32 CUDA-core path (any f32 operand) -----------------------------------
// Rows r < QT*GT of this CTA: query q0 + r / GT, head kvh*G + g0 + r % GT.
template <int DH>
constexpr int simt_smem_bytes() {
  return (RMAX * DH + KT * (DH + 1) + KT * DH + RMAX * (KT + 1) + 3 * RMAX) * 4 + RMAX * 4 +
         KT * 4;
}

template <int DH, typename TQ, typename TKV, bool RING>
__global__ void __launch_bounds__(SIMT_NTH) simt_kernel(Args a, int nqt, int QT, int GT) {
  constexpr int RM = RMAX, NTH = SIMT_NTH;
  constexpr int ACC = RM * DH / NTH;
  static_assert(ACC >= 1 && (RM * DH) % NTH == 0, "tile shape");
  extern __shared__ float smem[];
  float* Qs = smem;                // [RM][DH]
  float* Ks = Qs + RM * DH;        // [KT][DH+1]
  float* Vs = Ks + KT * (DH + 1);  // [KT][DH]
  float* Ss = Vs + KT * DH;        // [RM][KT+1]
  float* row_m = Ss + RM * (KT + 1);
  float* row_l = row_m + RM;
  float* row_c = row_l + RM;
  int* row_q = reinterpret_cast<int*>(row_c + RM);
  int* kp_s = row_q + RM;          // [KT] positions of this tile's keys
  __shared__ int n_keys_s;

  const int b = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * QT;
  const int kvh = blockIdx.y, g0 = blockIdx.z * GT;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* kp_ = static_cast<const TKV*>(a.k);
  const TKV* vp_ = static_cast<const TKV*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.Hkv;
  const int rows = QT * GT;

  for (int r = tid; r < RM; r += NTH) {
    int qp = -1;
    if (r < rows) {
      const int sq = q0 + r / GT;
      if (sq < a.Sq) qp = a.qpos[(long)b * a.Sq + sq];
    }
    row_q[r] = qp;
    row_m[r] = NEG_INF;
    row_l[r] = 0.f;
  }
  for (int idx = tid; idx < RM * DH; idx += NTH) {
    const int r = idx / DH, d = idx % DH;
    float val = 0.f;
    if (r < rows) {
      const int sq = q0 + r / GT;
      const int h = kvh * G + g0 + r % GT;
      if (sq < a.Sq) val = to_f(q[(((long)b * a.Sq + sq) * a.H + h) * DH + d]) * a.sm_scale;
    }
    Qs[idx] = val;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = -1;
    for (int r = 0; r < RM; ++r) mx = max(mx, row_q[r]);
    n_keys_s = mx + 1;  // paged: keys 0..max qpos; 0 for an all-idle CTA
  }
  __syncthreads();
  const int n_keys = n_keys_s;

  float acc[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;

  const int n_tiles = n_key_tiles<RING>(a, n_keys);
  for (int j = 0; j < n_tiles; ++j) {
    for (int s = tid; s < KT; s += NTH) kp_s[s] = entry_pos<RING>(a, b, j * KT + s, n_keys);
    __syncthreads();
    for (int idx = tid; idx < KT * DH; idx += NTH) {
      const int s = idx / DH, d = idx % DH;
      float kv = 0.f, vv = 0.f;
      if (kp_s[s] >= 0) {
        const long row = entry_row<RING>(a, b, j * KT + s, kvh);
        kv = to_f(kp_[row * DH + d]);
        vv = to_f(vp_[row * DH + d]);
        if (a.k_scale) {
          kv *= a.k_scale[row];
          vv *= a.v_scale[row];
        }
      }
      Ks[s * (DH + 1) + d] = kv;
      Vs[s * DH + d] = vv;
    }
    __syncthreads();
    for (int idx = tid; idx < RM * KT; idx += NTH) {
      const int r = idx / KT, s = idx % KT;
      if (r >= rows) {
        Ss[r * (KT + 1) + s] = NEG_INF;
        continue;
      }
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(Qs[r * DH + d], Ks[s * (DH + 1) + d], dot);
      Ss[r * (KT + 1) + s] = visible(row_q[r], kp_s[s], a.window) ? dot : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < RM; r += NTH / 32) {
      const int qp = row_q[r];
      float sv[KT / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < KT / 32; ++u) {
        sv[u] = Ss[r * (KT + 1) + lane + 32 * u];
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KT / 32; ++u) {
        const bool ok = r < rows && visible(qp, kp_s[lane + 32 * u], a.window);
        const float p = ok ? expf(sv[u] - m_new) : 0.f;
        Ss[r * (KT + 1) + lane + 32 * u] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int idx = tid + e * NTH;
      const int r = idx / DH, d = idx % DH;
      if (r >= rows) continue;
      float o = acc[e] * row_c[r];
      const float* srow = Ss + r * (KT + 1);
#pragma unroll 8
      for (int s = 0; s < KT; ++s) o = fmaf(srow[s], Vs[s * DH + d], o);
      acc[e] = o;
    }
    __syncthreads();
  }

  TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    const int idx = tid + e * NTH;
    const int r = idx / DH, d = idx % DH;
    if (r >= rows) continue;
    const int sq = q0 + r / GT;
    if (sq >= a.Sq) continue;
    const int h = kvh * G + g0 + r % GT;
    const float l = row_l[r];
    const float o = l > 0.f ? acc[e] / fmaxf(l, 1e-30f) : 0.f;
    out[(((long)b * a.Sq + sq) * a.H + h) * DH + d] = from_f<TQ>(o);
  }
}

// ---- bf16 tensor-core path ------------------------------------------------
template <int DH>
constexpr int mma_smem_bytes() {
  return (RMAX * (DH + 8) + KT * (DH + 8) + DH * (KT + 8)) * 2 + RMAX * 4 + KT * 4;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// 8 consecutive K/V elements as bf16 (int8 payloads times their scale)
template <typename TKV>
__device__ __forceinline__ void load8_bf16(const TKV* p, float scale, __nv_bfloat16 (&o)[8]);
template <>
__device__ __forceinline__ void load8_bf16<__nv_bfloat16>(const __nv_bfloat16* p, float,
                                                          __nv_bfloat16 (&o)[8]) {
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(p);
}
template <>
__device__ __forceinline__ void load8_bf16<int8_t>(const int8_t* p, float scale,
                                                   __nv_bfloat16 (&o)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16((float)c[j] * scale);
}

template <int DH, typename TKV, bool RING>
__global__ void __launch_bounds__(MMA_NTH) mma_kernel(Args a, int nqt, int QT, int GT) {
  constexpr int QS = DH + 8, KS = DH + 8, VS = KT + 8;  // padded smem row strides
  constexpr bool QREG = DH <= 128;  // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [RMAX][QS]
  __nv_bfloat16* Ks = Qs + RMAX * QS;                                // [KT][KS]
  __nv_bfloat16* Vt = Ks + KT * KS;                                  // [DH][VS] (transposed)
  int* row_q = reinterpret_cast<int*>(Vt + DH * VS);                 // [RMAX]
  int* kp_s = row_q + RMAX;                                          // [KT]
  __shared__ int n_keys_s;

  const int b = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * QT;
  const int kvh = blockIdx.y, g0 = blockIdx.z * GT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = a.H / a.Hkv;
  const int rows = QT * GT;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const TKV* kpool = static_cast<const TKV*>(a.k);
  const TKV* vpool = static_cast<const TKV*>(a.v);

  for (int r = tid; r < RMAX; r += MMA_NTH) {
    int qp = -1;
    const int sq = q0 + r / GT;
    if (r < rows && sq < a.Sq) qp = a.qpos[(long)b * a.Sq + sq];
    row_q[r] = qp;
  }
  for (int c = tid; c < RMAX * (DH / 8); c += MMA_NTH) {  // 16-byte chunks of Q rows
    const int r = c / (DH / 8), d = (c % (DH / 8)) * 8;
    const int sq = q0 + r / GT, h = kvh * G + g0 + r % GT;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows && sq < a.Sq)
      v = *reinterpret_cast<const uint4*>(q + (((long)b * a.Sq + sq) * a.H + h) * DH + d);
    *reinterpret_cast<uint4*>(Qs + r * QS + d) = v;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = -1;
    for (int r = 0; r < RMAX; ++r) mx = max(mx, row_q[r]);
    n_keys_s = mx + 1;
  }
  __syncthreads();
  const int n_keys = n_keys_s;

  // this warp's 16 rows
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  const int qp0 = row_q[r0], qp1 = row_q[r1];
  uint32_t qf[QREG ? DH / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * QS + kk * 16 + tig * 2);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(Qs + r1 * QS + kk * 16 + tig * 2);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * QS + kk * 16 + tig * 2 + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(Qs + r1 * QS + kk * 16 + tig * 2 + 8);
    }
  }
  float o[DH / 8][4] = {};
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int n_tiles = n_key_tiles<RING>(a, n_keys);
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the previous tile's K/V and positions are consumed
    for (int s = tid; s < KT; s += MMA_NTH) kp_s[s] = entry_pos<RING>(a, b, j * KT + s, n_keys);
    __syncthreads();
    for (int c = tid; c < KT * (DH / 8); c += MMA_NTH) {
      const int s = c / (DH / 8), d = (c % (DH / 8)) * 8;
      __align__(16) __nv_bfloat16 kv[8];
      __align__(16) __nv_bfloat16 vv[8];
      if (kp_s[s] >= 0) {
        const long row = entry_row<RING>(a, b, j * KT + s, kvh);
        load8_bf16(kpool + row * DH + d, a.k_scale ? a.k_scale[row] : 1.f, kv);
        load8_bf16(vpool + row * DH + d, a.v_scale ? a.v_scale[row] : 1.f, vv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(Ks + s * KS + d) = *reinterpret_cast<uint4*>(kv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(d + e) * VS + s] = vv[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[KT / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        qa[0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * QS + kk * 16 + tig * 2);
        qa[1] = *reinterpret_cast<const uint32_t*>(Qs + r1 * QS + kk * 16 + tig * 2);
        qa[2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * QS + kk * 16 + tig * 2 + 8);
        qa[3] = *reinterpret_cast<const uint32_t*>(Qs + r1 * QS + kk * 16 + tig * 2 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + gid) * KS + kk * 16 + tig * 2;
        mma_bf16(sc[nt], qa, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // mask + online softmax on the fragments (rows r0: e = 0, 1; r1: e = 2, 3)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kp_s[nt * 8 + tig * 2 + (e & 1)];
        const bool ok = visible(e < 2 ? qp0 : qp1, kp, a.window);
        sc[nt][e] = ok ? sc[nt][e] * a.sm_scale : NEG_INF;
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
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        const float p = sc[nt][e] > 0.5f * NEG_INF ? expf(sc[nt][e] - mn) : 0.f;
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
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      o[dt][0] *= c0;
      o[dt][1] *= c0;
      o[dt][2] *= c1;
      o[dt][3] *= c1;
    }
    // O += P V: the score fragments of key tiles 2kk, 2kk+1 are the A operand
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        const __nv_bfloat16* vr = Vt + (dt * 8 + gid) * VS + kk * 16 + tig * 2;
        mma_bf16(o[dt], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    const float l = half ? l1 : l0;
    const int sq = q0 + r / GT;
    if (r >= rows || sq >= a.Sq) continue;
    const int h = kvh * G + g0 + r % GT;
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    __nv_bfloat16* orow = out + (((long)b * a.Sq + sq) * a.H + h) * DH;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      const int d = dt * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(orow + d) =
          __floats2bfloat162_rn(o[dt][half * 2] * inv, o[dt][half * 2 + 1] * inv);
    }
  }
}

// ---- launchers --------------------------------------------------------------
template <int DH, typename TQ, typename TKV, bool RING>
int launch_simt(const Args& a, int B, int GT, cudaStream_t st) {
  constexpr int smem = simt_smem_bytes<DH>();
  auto kern = simt_kernel<DH, TQ, TKV, RING>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int QT = RMAX / GT, nqt = (a.Sq + QT - 1) / QT;
  kern<<<dim3(B * nqt, a.Hkv, (a.H / a.Hkv) / GT), SIMT_NTH, smem, st>>>(a, nqt, QT, GT);
  return (int)cudaGetLastError();
}

template <int DH, typename TKV, bool RING>
int launch_mma(const Args& a, int B, int GT, cudaStream_t st) {
  constexpr int smem = mma_smem_bytes<DH>();
  auto kern = mma_kernel<DH, TKV, RING>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int QT = RMAX / GT, nqt = (a.Sq + QT - 1) / QT;
  kern<<<dim3(B * nqt, a.Hkv, (a.H / a.Hkv) / GT), MMA_NTH, smem, st>>>(a, nqt, QT, GT);
  return (int)cudaGetLastError();
}

template <int DH, bool RING>
int launch_dh(const Args& a, int B, int GT, int q_dtype, int kv_dtype, cudaStream_t st) {
  if (q_dtype == RT_BF16 && kv_dtype == RT_BF16) return launch_mma<DH, __nv_bfloat16, RING>(a, B, GT, st);
  if (q_dtype == RT_BF16 && kv_dtype == RT_I8) return launch_mma<DH, int8_t, RING>(a, B, GT, st);
  if (q_dtype == RT_BF16) return launch_simt<DH, __nv_bfloat16, float, RING>(a, B, GT, st);
  if (kv_dtype == RT_BF16) return launch_simt<DH, float, __nv_bfloat16, RING>(a, B, GT, st);
  if (kv_dtype == RT_I8) return launch_simt<DH, float, int8_t, RING>(a, B, GT, st);
  return launch_simt<DH, float, float, RING>(a, B, GT, st);
}

// Rows per CTA share one kv head: GT heads of a group (all of it when G <= 64)
// times 64 / GT query positions.
inline int group_tile(int H, int Hkv) {
  const int G = H / Hkv;
  const int GT = G < RMAX ? G : RMAX;
  return G % GT ? -1 : GT;
}

}  // namespace flash
