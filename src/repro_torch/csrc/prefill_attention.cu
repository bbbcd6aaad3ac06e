// Ragged chunked-prefill flash attention over the paged K/V pool.
//
// Replaces: src/repro/kernels/prefill_attention.py::prefill_attention_pallas,
// paged layout (_kernel(paged=True) :46-115): grid (sequence, 64-query tile),
// the whole pool in VMEM, a block walk whose trip count comes from the tile's
// largest query position, causal + optional window mask, GQA, int8 dequant.
//
// What bounds it on the H100: at the serve shapes (chunk 256 over contexts
// up to 1.5 K tokens) the operations: ~4 * Sq * ctx * H * Dh FLOP against
// one read of the context per 64-row query tile.
//
// Design: one CTA per (sequence, tile of 64 query rows, kv head).  A row is a
// (query position, GQA head) pair of one kv head: 64 positions for llama2
// (G = 1), 4 positions x 16 heads for chatglm3, so every K/V tile read from
// device memory serves 64 rows whatever the group size.  The pool stays in
// device memory; a CTA reads its sequence's blocks through the block table,
// 64 keys per tile, for keys 0 .. max qpos of its rows only, so it never
// reads past the blocks the sequence occupies and an all-padding tile runs
// zero iterations.  Masking follows kernels/ref.py (-1e30, then x valid after
// the exp), so a fully masked row writes 0, not NaN.
//
// bf16 queries over bf16 or int8 pools (the serving path) run on the tensor
// cores, flash-attention style: 4 warps own 16 rows each, S = Q K^T and
// O += P V are mma.sync m16n8k16 bf16 -> f32 with the probabilities reused
// from the score registers, and the online softmax runs on the accumulator
// fragments.  int8 payloads are dequantized with their f32 per-(block-slot,
// head) scales into the bf16 tile.  Any f32 operand takes an f32 CUDA-core
// path with the same tiling.
#include "common.cuh"

namespace {

constexpr int RMAX = 64;   // query rows per CTA
constexpr int KT = 64;     // keys per tile
constexpr int SIMT_NTH = 256;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;        // (B, Sq, H, Dh)
  const void* k;        // (NB, BS, Hkv, Dh)
  const void* v;
  const float* k_scale; // (NB, BS, Hkv) or null
  const float* v_scale;
  const int* bt;        // (B, W)
  const int* qpos;      // (B, Sq)
  void* out;            // (B, Sq, H, Dh)
  int Sq, H, Hkv, BS, W, window;
  float sm_scale;
};

// f32 CUDA-core path (any f32 operand).  Rows r < QT*GT of this CTA: query
// q0 + r / GT, head kvh*G + g0 + r % GT.
template <int RM, int DH, typename TQ, typename TKV>
__device__ void attn_cta_simt(const Args& a, int b, int q0, int QT, int kvh, int g0, int GT) {
  constexpr int NTH = SIMT_NTH;
  constexpr int ACC = RM * DH / NTH;
  static_assert(ACC >= 1 && (RM * DH) % NTH == 0, "tile shape");
  extern __shared__ float smem[];
  float* Qs = smem;                        // [RM][DH]
  float* Ks = Qs + RM * DH;              // [KT][DH+1]
  float* Vs = Ks + KT * (DH + 1);          // [KT][DH]
  float* Ss = Vs + KT * DH;                // [RM][KT+1]
  float* row_m = Ss + RM * (KT + 1);
  float* row_l = row_m + RM;
  float* row_c = row_l + RM;
  int* row_q = reinterpret_cast<int*>(row_c + RM);
  __shared__ int n_keys_s;

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
    n_keys_s = mx + 1;  // keys 0..max qpos; 0 for an all-idle CTA
  }
  __syncthreads();
  const int n_keys = n_keys_s;

  float acc[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;

  const int n_tiles = (n_keys + KT - 1) / KT;
  for (int j = 0; j < n_tiles; ++j) {
    for (int idx = tid; idx < KT * DH; idx += NTH) {
      const int s = idx / DH, d = idx % DH;
      const int kpos = j * KT + s;
      float kv = 0.f, vv = 0.f;
      if (kpos < n_keys) {
        const long blk = a.bt[(long)b * a.W + kpos / a.BS];
        const long slot = (blk * a.BS + kpos % a.BS) * a.Hkv + kvh;
        kv = to_f(kp_[slot * DH + d]);
        vv = to_f(vp_[slot * DH + d]);
        if (a.k_scale) {
          kv *= a.k_scale[slot];
          vv *= a.v_scale[slot];
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
      const int qp = row_q[r], kpos = j * KT + s;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(Qs[r * DH + d], Ks[s * (DH + 1) + d], dot);
      const bool valid = qp >= 0 && kpos <= qp && (a.window <= 0 || qp - kpos < a.window);
      Ss[r * (KT + 1) + s] = valid ? dot : NEG_INF;
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
        const int kpos = j * KT + lane + 32 * u;
        const bool valid = qp >= 0 && kpos <= qp && (a.window <= 0 || qp - kpos < a.window);
        const float p = valid ? expf(sv[u] - m_new) : 0.f;
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
constexpr int MMA_NTH = 128;  // 4 warps x 16 rows

template <int DH>
constexpr int mma_smem_bytes() {
  return (RMAX * (DH + 8) + KT * (DH + 8) + DH * (KT + 8)) * 2 + RMAX * 4;
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

// 8 consecutive pool elements as bf16 (int8 payloads times their scale)
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

template <int DH, typename TKV>
__global__ void __launch_bounds__(MMA_NTH)
prefill_mma_kernel(Args a, int nqt, int QT, int GT) {
  constexpr int QS = DH + 8, KS = DH + 8, VS = KT + 8;  // padded smem row strides
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [RMAX][QS]
  __nv_bfloat16* Ks = Qs + RMAX * QS;                                // [KT][KS]
  __nv_bfloat16* Vt = Ks + KT * KS;                                  // [DH][VS] (transposed)
  int* row_q = reinterpret_cast<int*>(Vt + DH * VS);                 // [RMAX]
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

  // this warp's 16 rows: Q fragments for all of Dh stay in registers
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  const int qp0 = row_q[r0], qp1 = row_q[r1];
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * QS + kk * 16 + tig * 2);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(Qs + r1 * QS + kk * 16 + tig * 2);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * QS + kk * 16 + tig * 2 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(Qs + r1 * QS + kk * 16 + tig * 2 + 8);
  }
  float o[DH / 8][4] = {};
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (n_keys + KT - 1) / KT;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the previous tile's K/V are consumed
    for (int c = tid; c < KT * (DH / 8); c += MMA_NTH) {
      const int s = c / (DH / 8), d = (c % (DH / 8)) * 8;
      const int kpos = j * KT + s;
      __align__(16) __nv_bfloat16 kv[8];
      __align__(16) __nv_bfloat16 vv[8];
      if (kpos < n_keys) {
        const long blk = a.bt[(long)b * a.W + kpos / a.BS];
        const long slot = (blk * a.BS + kpos % a.BS) * a.Hkv + kvh;
        load8_bf16(kpool + slot * DH + d, a.k_scale ? a.k_scale[slot] : 1.f, kv);
        load8_bf16(vpool + slot * DH + d, a.v_scale ? a.v_scale[slot] : 1.f, vv);
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
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + gid) * KS + kk * 16 + tig * 2;
        mma_bf16(sc[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    // mask + online softmax on the fragments (rows r0: e = 0, 1; r1: e = 2, 3)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j * KT + nt * 8 + tig * 2 + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        const bool valid = qp >= 0 && kpos <= qp && (a.window <= 0 || qp - kpos < a.window);
        sc[nt][e] = valid ? sc[nt][e] * a.sm_scale : NEG_INF;
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
template <int DH, typename TQ, typename TKV>
__global__ void __launch_bounds__(SIMT_NTH)
prefill_simt_kernel(Args a, int nqt, int QT, int GT) {
  attn_cta_simt<RMAX, DH, TQ, TKV>(a, blockIdx.x / nqt, (blockIdx.x % nqt) * QT, QT, blockIdx.y,
                                   blockIdx.z * GT, GT);
}

template <int DH, typename TQ, typename TKV>
int launch_simt(const Args& a, int B, int GT, cudaStream_t st) {
  constexpr int smem =
      (RMAX * DH + KT * (DH + 1) + KT * DH + RMAX * (KT + 1) + 3 * RMAX) * 4 + RMAX * 4;
  auto kern = prefill_simt_kernel<DH, TQ, TKV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int QT = RMAX / GT, nqt = (a.Sq + QT - 1) / QT;
  kern<<<dim3(B * nqt, a.Hkv, (a.H / a.Hkv) / GT), SIMT_NTH, smem, st>>>(a, nqt, QT, GT);
  return (int)cudaGetLastError();
}

template <int DH, typename TKV>
int launch_mma(const Args& a, int B, int GT, cudaStream_t st) {
  constexpr int smem = mma_smem_bytes<DH>();
  auto kern = prefill_mma_kernel<DH, TKV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int QT = RMAX / GT, nqt = (a.Sq + QT - 1) / QT;
  kern<<<dim3(B * nqt, a.Hkv, (a.H / a.Hkv) / GT), MMA_NTH, smem, st>>>(a, nqt, QT, GT);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(const Args& a, int B, int GT, int q_dtype, int kv_dtype, cudaStream_t st) {
  if (q_dtype == RT_BF16 && kv_dtype == RT_BF16) return launch_mma<DH, __nv_bfloat16>(a, B, GT, st);
  if (q_dtype == RT_BF16 && kv_dtype == RT_I8) return launch_mma<DH, int8_t>(a, B, GT, st);
  if (q_dtype == RT_BF16) return launch_simt<DH, __nv_bfloat16, float>(a, B, GT, st);
  if (kv_dtype == RT_BF16) return launch_simt<DH, float, __nv_bfloat16>(a, B, GT, st);
  if (kv_dtype == RT_I8) return launch_simt<DH, float, int8_t>(a, B, GT, st);
  return launch_simt<DH, float, float>(a, B, GT, st);
}

}  // namespace

extern "C" int rt_paged_prefill_attention(const void* q, const void* k, const void* v,
                                          const void* k_scale, const void* v_scale,
                                          const void* bt, const void* qpos, void* out, int B,
                                          int Sq, int H, int Hkv, int Dh, int BS, int W,
                                          int window, float sm_scale, int q_dtype, int kv_dtype,
                                          void* stream) {
  Args a{q, k, v, (const float*)k_scale, (const float*)v_scale, (const int*)bt,
         (const int*)qpos, out, Sq, H, Hkv, BS, W, window, sm_scale};
  const int G = H / Hkv;
  const int GT = G < RMAX ? G : RMAX;
  if (G % GT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128) return launch_dh<128>(a, B, GT, q_dtype, kv_dtype, st);
  if (Dh == 64) return launch_dh<64>(a, B, GT, q_dtype, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}
