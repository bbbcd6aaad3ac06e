// Flash-attention CTA bodies shared by the paged and the ring layouts of the
// chunked-prefill kernel (prefill_attention.cu, ring_attention.cu).
//
// A row is a (query position, GQA head) pair of one kv head.  Every mask
// comes from the key's position, never from its index: a key is visible to
// a row iff kpos >= 0, qpos >= 0, kpos <= qpos and (window == 0 or qpos -
// kpos < window).  Masking follows kernels/ref.py (-1e30, then x valid after
// the exp), so a fully masked row writes 0, not NaN.  Keys are read one
// 64-entry tile at a time:
//
// * paged (RING = false): entry e holds position e, read through the block
//   table; entries past the rows' largest position or the table are empty;
// * ring (RING = true): the WR entries of the sequence's ring, in ring
//   order, which is not position order once the ring has wrapped; each
//   entry's position comes from kpos (-1 = empty: never attended, never
//   read).
//
// bf16 queries over bf16 or int8 K/V take the tensor-core tile (tc_kernel):
// 128 rows a CTA (GT heads x 128 / GT positions; 12 x 10 = 120 for a group
// of 10), 8 consumer warps of 16 rows and a producer warpgroup, one warp of
// which loads; setmaxnreg hands the consumers 232 registers a thread (the
// 12 warps would otherwise get 168, and head_dim 256 spilled).  CTAs
// interleave the sequences, the last query tile first, so that a wave mixes
// long rings and short ones.
// * Only tiles that hold a key visible to some row are walked.  Paged: the
//   tiles of [max(0, qmin - window + 1), qmax]; ring: the CTA reads its
//   sequence's kpos once and keeps a tile iff its smallest non-empty
//   position is <= qmax and (no window or qmin - its largest < window)
//   (visible_tiles in kernels/prefill_attention.py is the
//   same rule).  A warp also skips a walked tile none of its rows can see,
//   and drops the element mask on a tile every one of its rows sees whole.
// * The producer warp keeps the next tiles in flight in a 2-3 stage ring of
//   shared memory (cp.async, zero-filled for empty entries; a paged tile is
//   gathered block by block through the table), signalled through
//   mbarriers.  int8 tiles arrive as int8 plus their f32 scales, half the
//   bytes; the consumers dequantize a tile once into one shared bf16 tile
//   (value x scale -> bf16, as the plain version rounds), between two
//   named barriers, while the producer's next loads are in flight.
// * S = Q K^T and O += P V are mma.sync m16n8k16 bf16 -> f32; fragments come
//   from ldmatrix (.trans for V, read in its natural row-major layout: no
//   transposed copy), rows padded by 16 bytes so that every ldmatrix phase
//   is conflict-free.  P is reused from the score registers; the online
//   softmax runs on the accumulator fragments in base 2.  Q fragments stay
//   in registers for head_dim <= 128; at 256 the O accumulator alone takes
//   128 registers a thread, so they are re-read from shared memory.
// Any f32 operand takes the f32 CUDA-core path (simt_kernel, 64 rows).
#pragma once

#include <limits.h>

#include "common.cuh"

namespace flash {

constexpr int RMAX = 64;  // query rows per CTA of the f32 path
constexpr int KT = 64;    // keys per tile
constexpr int SIMT_NTH = 256;
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
  static_assert(DH % 16 == 0, "head dim");
  static_assert(ACC >= 1 && (RM * DH) % NTH == 0, "every output of the tile in some acc[e]");
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

// ---- bf16 tensor-core tile --------------------------------------------------
constexpr int TR = 128;                      // rows a CTA
constexpr int TC_WARPS = 8;                  // consumer warps, 16 rows each
constexpr int TC_NTH = (TC_WARPS + 4) * 32;  // + the producer warpgroup (one warp loads)

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

// the consumer warps only
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TC_WARPS * 32) : "memory");
}
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// Whether a key in [kmin, kmax] (kmax < 0: none) can be visible to a row in
// [qmin, qmax] (qmax < 0: none): never false for a visible pair.
__device__ __forceinline__ bool may_see(int qmin, int qmax, int kmin, int kmax, int window) {
  return qmax >= 0 && kmax >= 0 && kmin <= qmax && (window <= 0 || qmin - kmax < window);
}

// Shared-memory layout (byte offsets).  A stage holds one tile as it comes
// from device memory: bf16 K and V rows padded to RS, or int8 K and V rows
// with their scales; int8 tiles are dequantized into one bf16 tile (CONV).
template <int DH, typename TKV>
struct TcLayout {
  static constexpr bool I8 = sizeof(TKV) == 1;
  static constexpr int NS = DH >= 256 ? 2 : 3;  // stages
  static constexpr int RS = DH + 8;             // padded bf16 row stride
  static constexpr int TILE = 2 * KT * RS * 2;  // a bf16 K and V tile
  static constexpr int STAGE = I8 ? 2 * KT * DH + 2 * KT * 4 : TILE;
  static constexpr int STAGES = TR * RS * 2;    // after Q [TR][RS]
  static constexpr int CONV = STAGES + NS * STAGE;
  static constexpr int BARS = CONV + (I8 ? TILE : 0);  // full[NS], empty[NS]
  static constexpr int KPOS = BARS + 2 * NS * 8;        // [NS][KT] key positions
  static constexpr int KRANGE = KPOS + NS * KT * 4;     // [NS] tile's min, max, full
  static constexpr int KROW = KRANGE + NS * 4 * 4;      // [KT] producer: rows of a tile
  static constexpr int ROWQ = KROW + KT * 4;            // [TR] row positions, then n_list
  static constexpr int LIST = ROWQ + TR * 4 + 16;       // [WR / KT] the ring's walked tiles
  // 16-wide k-steps and n-tiles of the head dim, whole 16-byte chunks of a
  // row (bf16 and int8), rows 16-byte aligned at an odd multiple of 16 bytes
  // (every ldmatrix phase conflict-free), stages 16-byte aligned
  static_assert(DH % 16 == 0, "head dim: whole k-steps, n-tiles and 16-byte chunks");
  static_assert(RS * 2 % 32 == 16, "padded rows: 16-byte aligned, an odd number of chunks");
  static_assert(STAGE % 16 == 0 && CONV % 16 == 0 && BARS % 8 == 0, "stage alignment");
  static_assert(LIST <= 232448 - 1024, "shared memory: the layout and a 256-tile ring list");
};

template <int DH, typename TKV, bool RING>
__global__ void __launch_bounds__(TC_NTH, 1) tc_kernel(Args a, int nqt, int QT, int GT) {
  using L = TcLayout<DH, TKV>;
  constexpr int NS = L::NS, RS = L::RS;
  constexpr bool QREG = DH <= 128;  // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* stages = smem_raw + L::STAGES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + L::BARS);
  uint64_t* empty = full + NS;
  int* kp_s = reinterpret_cast<int*>(smem_raw + L::KPOS);
  int* kr_s = reinterpret_cast<int*>(smem_raw + L::KRANGE);
  int* krow = reinterpret_cast<int*>(smem_raw + L::KROW);
  int* row_q = reinterpret_cast<int*>(smem_raw + L::ROWQ);
  int* n_list_s = row_q + TR;
  int* list = reinterpret_cast<int*>(smem_raw + L::LIST);

  // CTAs interleave the sequences, the last (in the paged layout the
  // heaviest) query tile first, so that a wave mixes long and short rows
  const int B = gridDim.x / nqt;
  const int b = blockIdx.x % B, q0 = (nqt - 1 - blockIdx.x / B) * QT;
  const int kvh = blockIdx.y, g0 = blockIdx.z * GT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.Hkv, rows = QT * GT;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 64);  // 32 producer lanes' cp.async + their 32 plain arrivals
      mbar_init(&empty[s], TC_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = tid; r < TR; r += TC_NTH) {
    const int sq = q0 + r / GT;
    row_q[r] = r < rows && sq < a.Sq ? a.qpos[(long)b * a.Sq + sq] : -1;
  }
  for (int c = tid; c < TR * (DH / 8); c += TC_NTH) {  // 16-byte chunks of Q rows
    const int r = c / (DH / 8), d = (c % (DH / 8)) * 8;
    const int sq = q0 + r / GT, h = kvh * G + g0 + r % GT;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows && sq < a.Sq)
      v = *reinterpret_cast<const uint4*>(q + (((long)b * a.Sq + sq) * a.H + h) * DH + d);
    *reinterpret_cast<uint4*>(Qs + r * RS + d) = v;
  }
  __syncthreads();
  // the rows' position range, in every warp
  int qmin = INT_MAX, qmax = -1;
  for (int r = lane; r < TR; r += 32) {
    const int p = row_q[r];
    if (p >= 0) {
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
  qmin = warp_min(qmin);
  qmax = warp_max(qmax);

  // the tiles this CTA walks: tile i is list[i] (ring) or t_lo + i (paged)
  int n_list, t_lo = 0;
  if constexpr (RING) {
    const int nt = (a.WR + KT - 1) / KT;
    for (int t = warp; t < nt; t += TC_NTH / 32) {
      int kmin = INT_MAX, kmax = -1;
      for (int j = lane; j < KT; j += 32) {
        const int e = t * KT + j;
        const int p = e < a.WR ? a.kpos[(long)b * a.WR + e] : -1;
        if (p >= 0) {
          kmin = min(kmin, p);
          kmax = max(kmax, p);
        }
      }
      kmin = warp_min(kmin);
      kmax = warp_max(kmax);
      if (lane == 0) list[t] = may_see(qmin, qmax, kmin, kmax, a.window);
    }
    __syncthreads();
    if (warp == 0) {  // compact the kept tiles' indices in place, in ring order
      int base = 0;
      for (int c = 0; c < nt; c += 32) {
        const int t = c + lane;
        const bool keep = t < nt && list[t];
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        if (keep) list[base + __popc(m & ((1u << lane) - 1))] = t;
        base += __popc(m);
      }
      if (lane == 0) *n_list_s = base;
    }
    __syncthreads();
    n_list = *n_list_s;
  } else {
    t_lo = (a.window > 0 ? max(0, qmin - a.window + 1) : 0) / KT;
    n_list = qmax < 0 ? 0 : qmax / KT - t_lo + 1;
  }

  if (warp >= TC_WARPS) {  // ---- producer warpgroup: one warp loads --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp > TC_WARPS) return;
    const TKV* kpool = static_cast<const TKV*>(a.k);
    const TKV* vpool = static_cast<const TKV*>(a.v);
    for (int i = 0; i < n_list; ++i) {
      const int s = i % NS, e0 = (RING ? list[i] : t_lo + i) * KT;
      mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
      int* kp = kp_s + s * KT;
      int kmin = INT_MAX, kmax = -1, n = 0;
      for (int j = lane; j < KT; j += 32) {
        const int e = e0 + j;
        int p;
        if (RING) p = e < a.WR ? a.kpos[(long)b * a.WR + e] : -1;
        else p = e <= qmax && e / a.BS < a.W ? e : -1;
        kp[j] = p;
        krow[j] = p >= 0 ? (int)entry_row<RING>(a, b, e, kvh) : -1;
        if (p >= 0) {
          kmin = min(kmin, p);
          kmax = max(kmax, p);
          ++n;
        }
      }
      kmin = warp_min(kmin);
      kmax = warp_max(kmax);
      n = __reduce_add_sync(0xffffffffu, n);
      if (lane == 0) {
        kr_s[3 * s] = kmin;
        kr_s[3 * s + 1] = kmax;
        kr_s[3 * s + 2] = n == KT;  // no empty entry
      }
      __syncwarp();
      unsigned char* st = stages + s * L::STAGE;
      if constexpr (!L::I8) {
        __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(st);
        __nv_bfloat16* Vs = Ks + KT * RS;
        for (int c = lane; c < KT * (DH / 8); c += 32) {
          const int j = c / (DH / 8), d = (c % (DH / 8)) * 8;
          const int row = krow[j];
          const long off = (long)max(row, 0) * DH + d;
          cp16(Ks + j * RS + d, kpool + off, row >= 0);
          cp16(Vs + j * RS + d, vpool + off, row >= 0);
        }
      } else {
        int8_t* K8 = reinterpret_cast<int8_t*>(st);
        int8_t* V8 = K8 + KT * DH;
        float* ksc = reinterpret_cast<float*>(V8 + KT * DH);
        for (int c = lane; c < KT * (DH / 16); c += 32) {
          const int j = c / (DH / 16), d = (c % (DH / 16)) * 16;
          const int row = krow[j];
          const long off = (long)max(row, 0) * DH + d;
          cp16(K8 + j * DH + d, kpool + off, row >= 0);
          cp16(V8 + j * DH + d, vpool + off, row >= 0);
        }
        for (int j = lane; j < KT; j += 32) {
          const int row = krow[j];
          ksc[j] = row >= 0 ? a.k_scale[row] : 0.f;
          ksc[KT + j] = row >= 0 ? a.v_scale[row] : 0.f;
        }
      }
      cp_async_arrive(&full[s]);
      mbar_arrive(&full[s]);  // releases this lane's stores of positions and scales
      __syncwarp();           // krow is rewritten for the next tile
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warps: 16 rows each ------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  const int qp0 = row_q[r0], qp1 = row_q[r1];
  int wmin = row_q[warp * 16 + (lane & 15)], wmax = wmin;
  const bool wfull = __all_sync(0xffffffffu, wmin >= 0);  // no padding row
  wmin = warp_min(wmin < 0 ? INT_MAX : wmin);
  wmax = warp_max(wmax);
  const float sl2 = a.sm_scale * 1.4426950408889634f;  // scores in base 2
  const __nv_bfloat16* qrow = Qs + (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
  uint32_t qf[QREG ? DH / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) ldsm_x4(qf[kk], qrow + kk * 16);
  }
  float o[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_list; ++i) {
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    unsigned char* st = stages + s * L::STAGE;
    const __nv_bfloat16* Kt;
    if constexpr (L::I8) {
      __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::CONV);
      consumer_sync();  // the previous tile's dequantized K and V are consumed
      const int8_t* K8 = reinterpret_cast<const int8_t*>(st);
      const float* ksc = reinterpret_cast<const float*>(K8 + 2 * KT * DH);
#pragma unroll 4
      for (int c = tid; c < 2 * KT * (DH / 8); c += TC_WARPS * 32) {  // K rows, then V rows
        const int j = c / (DH / 8), d = (c % (DH / 8)) * 8;
        __align__(16) __nv_bfloat16 v8[8];
        load8_bf16(K8 + j * DH + d, ksc[j], v8);
        *reinterpret_cast<uint4*>(Kb + j * RS + d) = *reinterpret_cast<uint4*>(v8);
      }
      consumer_sync();
      Kt = Kb;
    } else {
      Kt = reinterpret_cast<const __nv_bfloat16*>(st);
    }
    const __nv_bfloat16* Vt = Kt + KT * RS;
    const int* kp = kp_s + s * KT;
    const int kmin = kr_s[3 * s], kmax = kr_s[3 * s + 1];
    if (may_see(wmin, wmax, kmin, kmax, a.window)) {
      // every key of the tile visible to every row of the warp: no element mask
      const bool dense = wfull && kr_s[3 * s + 2] && kmax <= wmin &&
                         (a.window <= 0 || wmax - kmin < a.window);
      // S = Q K^T for this warp's 16 rows x 64 keys
      float sc[KT / 8][4];
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t qa[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          ldsm_x4(qa, qrow + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < KT / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, Kt + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * RS + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * np], qa, bk[0], bk[1]);
          mma_bf16(sc[2 * np + 1], qa, bk[2], bk[3]);
        }
      }
      // mask + online softmax on the fragments (rows r0: e = 0, 1; r1: e = 2, 3)
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok =
              dense || visible(e < 2 ? qp0 : qp1, kp[nt * 8 + tig * 2 + (e & 1)], a.window);
          sc[nt][e] = ok ? sc[nt][e] * sl2 : NEG_INF;
          if (e < 2) mx0 = fmaxf(mx0, sc[nt][e]);
          else mx1 = fmaxf(mx1, sc[nt][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sc[nt][e] > 0.5f * NEG_INF ? exp2f(sc[nt][e] - (e < 2 ? mn0 : mn1))
                                                     : 0.f;
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
      // O += P V: P from the score registers, V fragments by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int dt = 0; dt < DH / 16; ++dt) {
          uint32_t bv[4];
          ldsm_x4_t(bv, Vt + (kk * 16 + (lane & 15)) * RS + dt * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dt], pa, bv[0], bv[1]);
          mma_bf16(o[2 * dt + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
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
// Rows of an f32-path CTA share one kv head: GT heads of a group (all of it
// when G <= 64) times 64 / GT query positions.
inline int group_tile(int H, int Hkv) {
  const int G = H / Hkv;
  const int GT = G < RMAX ? G : RMAX;
  return G % GT ? -1 : GT;
}

template <int DH, typename TQ, typename TKV, bool RING>
int launch_simt(const Args& a, int B, cudaStream_t st) {
  constexpr int smem = simt_smem_bytes<DH>();
  const int GT = group_tile(a.H, a.Hkv);
  if (GT < 0) return (int)cudaErrorInvalidValue;
  auto kern = simt_kernel<DH, TQ, TKV, RING>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int QT = RMAX / GT, nqt = (a.Sq + QT - 1) / QT;
  kern<<<dim3(B * nqt, a.Hkv, (a.H / a.Hkv) / GT), SIMT_NTH, smem, st>>>(a, nqt, QT, GT);
  return (int)cudaGetLastError();
}

// The tensor-core tile's rows: GT heads, the largest divisor of the group
// that is at most 128, times 128 / GT positions (kernels/prefill_attention.py
// row_plan).
inline int tc_group_tile(int G) {
  int gt = G < TR ? G : TR;
  while (G % gt) --gt;
  return gt;
}

template <int DH, typename TKV, bool RING>
int launch_tc(const Args& a, int B, cudaStream_t st) {
  const int list_bytes = RING ? ((a.WR + KT - 1) / KT * 4 + 15) / 16 * 16 : 0;
  const int smem = TcLayout<DH, TKV>::LIST + list_bytes;
  auto kern = tc_kernel<DH, TKV, RING>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int G = a.H / a.Hkv, GT = tc_group_tile(G), QT = TR / GT;
  const int nqt = (a.Sq + QT - 1) / QT;  // blockIdx.x = (nqt - 1 - query tile) * B + sequence
  kern<<<dim3(B * nqt, a.Hkv, G / GT), TC_NTH, smem, st>>>(a, nqt, QT, GT);
  return (int)cudaGetLastError();
}

template <int DH, bool RING>
int launch_dh(const Args& a, int B, int q_dtype, int kv_dtype, cudaStream_t st) {
  if (a.Hkv < 1 || a.H % a.Hkv) return (int)cudaErrorInvalidValue;
  if (q_dtype == RT_BF16 && kv_dtype == RT_BF16) return launch_tc<DH, __nv_bfloat16, RING>(a, B, st);
  if (q_dtype == RT_BF16 && kv_dtype == RT_I8) return launch_tc<DH, int8_t, RING>(a, B, st);
  if (q_dtype == RT_BF16) return launch_simt<DH, __nv_bfloat16, float, RING>(a, B, st);
  if (kv_dtype == RT_BF16) return launch_simt<DH, float, __nv_bfloat16, RING>(a, B, st);
  if (kv_dtype == RT_I8) return launch_simt<DH, float, int8_t, RING>(a, B, st);
  return launch_simt<DH, float, float, RING>(a, B, st);
}

// Sq > 1 of either layout: head_dim 64, 112, 128 or 256.
template <bool RING>
int launch(const Args& a, int B, int Dh, int q_dtype, int kv_dtype, cudaStream_t st) {
  if (Dh == 256) return launch_dh<256, RING>(a, B, q_dtype, kv_dtype, st);
  if (Dh == 128) return launch_dh<128, RING>(a, B, q_dtype, kv_dtype, st);
  if (Dh == 112) return launch_dh<112, RING>(a, B, q_dtype, kv_dtype, st);
  if (Dh == 64) return launch_dh<64, RING>(a, B, q_dtype, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
