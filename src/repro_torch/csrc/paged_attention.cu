// Paged decode attention: one query token per sequence, through the block table.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_pallas
// (body _kernel :38-75), one grid step per sequence with the whole K/V pool
// handed to VMEM and an online softmax over ceil((qpos+1)/BS) blocks.
//
// What bounds it on the H100: bytes.  Every query reads its sequence's whole
// K/V context once (2 * ctx * Hkv * Dh elements) for ~4 * ctx * H * Dh
// operations, about one FLOP per byte in bf16.
//
// Design: the pool stays in device memory and a CTA reads only the blocks its
// own sequence occupies, through the block table.  One CTA per (sequence,
// kv head, tile of up to 16 GQA query heads); its 8 warps split the context
// into 32-key chunks (warp w takes chunks w, w+8, ...), so a sequence's
// context streams through 8 independent online softmaxes at once: many
// loads are in flight and no CTA-wide barrier sits inside the key loop.  In a
// chunk each lane owns one key and computes its scores for the tile's query
// heads from the query in shared memory (the K row read with 16-byte loads);
// a warp max/sum updates the running softmax, and the P.V product walks the
// chunk's 32 keys with each lane owning Dh/32 output dims (coalesced V row
// reads).  The warps' (m, l, acc) are merged once at the end.  int8 pools are
// dequantized with their f32 per-(block-slot, head) scales as rows are read.
// qpos = -1 reads nothing and writes a zero row; masking follows
// kernels/ref.py (invalid scores never contribute), so no row yields NaN.
#include "common.cuh"

namespace {

constexpr int NWARP = 8;
constexpr int CH = 32;  // keys per warp chunk
constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&o)[8]);
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float (&o)[8]) {
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
__device__ __forceinline__ void load8<float>(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<int8_t>(const int8_t* p, float (&o)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = (float)c[j];
}

template <int DH, int GT, typename TQ, typename TKV>
__global__ void __launch_bounds__(NWARP * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                    const TKV* __restrict__ vpool, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const int* __restrict__ bt,
                    const int* __restrict__ qpos, TQ* __restrict__ out, int H, int Hkv, int BS,
                    int W, int window, float sm_scale) {
  constexpr int DPL = DH / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* q_s = smem;                       // [GT][DH]
  float* p_s = q_s + GT * DH;              // [NWARP][GT][CH]
  float* m_s = p_s + NWARP * GT * CH;      // [NWARP][GT]
  float* l_s = m_s + NWARP * GT;           // [NWARP][GT]
  float* a_s = l_s + NWARP * GT;           // [NWARP][GT][DH]
  int* row_s = reinterpret_cast<int*>(a_s + NWARP * GT * DH);  // [NWARP][CH]

  const int b = blockIdx.x, kvh = blockIdx.y, g0 = blockIdx.z * GT;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp = qpos[b];
  const long out_base = ((long)b * H + kvh * G + g0) * DH;
  if (qp < 0) {  // inactive row: zeros, nothing read
    for (int i = tid; i < GT * DH; i += NWARP * 32) out[out_base + i] = from_f<TQ>(0.f);
    return;
  }
  for (int i = tid; i < GT * DH; i += NWARP * 32) q_s[i] = to_f(q[out_base + i]) * sm_scale;
  __syncthreads();

  const int n_keys = qp + 1;
  float m[GT], l[GT], acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }
  float* my_p = p_s + warp * GT * CH;
  int* my_row = row_s + warp * CH;

  for (int c0 = warp * CH; c0 < n_keys; c0 += NWARP * CH) {
    const int kpos = c0 + lane;
    const bool valid = kpos < n_keys && (window <= 0 || qp - kpos < window);
    long row = 0;
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
    if (valid) {
      const long blk = bt[(long)b * W + kpos / BS];
      row = (blk * BS + kpos % BS) * Hkv + kvh;
      const TKV* kr = kpool + row * DH;
#pragma unroll 4
      for (int d0 = 0; d0 < DH; d0 += 8) {
        float kv[8];
        load8(kr + d0, kv);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[g] = fmaf(q_s[g * DH + d0 + j], kv[j], s[g]);
      }
      if (kscale) {
        const float ks = kscale[row];
#pragma unroll
        for (int g = 0; g < GT; ++g) s[g] *= ks;
      }
    }
    my_row[lane] = (int)row;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
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
      my_p[g * CH + lane] = p;
    }
    __syncwarp();
    const int nk = min(CH, n_keys - c0);
    for (int i = 0; i < nk; ++i) {
      const long r = my_row[i];  // a masked key has p = 0 (its row is the null block's)
      const TKV* vr = vpool + r * DH + lane * DPL;
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vv[j] = to_f(vr[j]);
      if (vscale) {
        const float vs = vscale[r];
#pragma unroll
        for (int j = 0; j < DPL; ++j) vv[j] *= vs;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = my_p[g * CH + i];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
      }
    }
    __syncwarp();
  }

  // merge the warps' online softmaxes
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      m_s[warp * GT + g] = m[g];
      l_s[warp * GT + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) a_s[(warp * GT + g) * DH + lane * DPL + j] = acc[g][j];
  }
  __syncthreads();
  for (int i = tid; i < GT * DH; i += NWARP * 32) {
    const int g = i / DH, d = i % DH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) mx = fmaxf(mx, m_s[w * GT + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float f = expf(m_s[w * GT + g] - mx);
      L = fmaf(f, l_s[w * GT + g], L);
      O = fmaf(f, a_s[(w * GT + g) * DH + d], O);
    }
    out[out_base + i] = from_f<TQ>(L > 0.f ? O / fmaxf(L, 1e-30f) : 0.f);
  }
}

template <int DH, int GT, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bt, const void* qpos, void* out, int B, int H, int Hkv, int BS, int W,
           int window, float sm_scale, cudaStream_t st) {
  constexpr int smem = (GT * DH + NWARP * GT * 32 + 2 * NWARP * GT + NWARP * GT * DH) * 4 +
                       NWARP * 32 * 4;
  auto kern = paged_decode_kernel<DH, GT, TQ, TKV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, Hkv, (H / Hkv) / GT);
  kern<<<grid, NWARP * 32, smem, st>>>((const TQ*)q, (const TKV*)k, (const TKV*)v,
                                       (const float*)ks, (const float*)vs, (const int*)bt,
                                       (const int*)qpos, (TQ*)out, H, Hkv, BS, W, window,
                                       sm_scale);
  return (int)cudaGetLastError();
}

template <int DH, int GT, typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* bt, const void* qpos, void* out, int B, int H, int Hkv,
              int BS, int W, int window, float sm_scale, cudaStream_t st) {
  if (kv_dtype == RT_BF16)
    return launch<DH, GT, TQ, __nv_bfloat16>(q, k, v, ks, vs, bt, qpos, out, B, H, Hkv, BS, W,
                                             window, sm_scale, st);
  if (kv_dtype == RT_I8)
    return launch<DH, GT, TQ, int8_t>(q, k, v, ks, vs, bt, qpos, out, B, H, Hkv, BS, W, window,
                                      sm_scale, st);
  return launch<DH, GT, TQ, float>(q, k, v, ks, vs, bt, qpos, out, B, H, Hkv, BS, W, window,
                                   sm_scale, st);
}

template <int DH, int GT>
int launch_q(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* bt, const void* qpos, void* out, int B,
             int H, int Hkv, int BS, int W, int window, float sm_scale, cudaStream_t st) {
  if (q_dtype == RT_BF16)
    return launch_kv<DH, GT, __nv_bfloat16>(kv_dtype, q, k, v, ks, vs, bt, qpos, out, B, H, Hkv,
                                            BS, W, window, sm_scale, st);
  return launch_kv<DH, GT, float>(kv_dtype, q, k, v, ks, vs, bt, qpos, out, B, H, Hkv, BS, W,
                                  window, sm_scale, st);
}

template <int DH>
int launch_g(int GT, int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* bt, const void* qpos, void* out, int B,
             int H, int Hkv, int BS, int W, int window, float sm_scale, cudaStream_t st) {
#define RT_G(N)                                                                              \
  if (GT == N)                                                                               \
    return launch_q<DH, N>(q_dtype, kv_dtype, q, k, v, ks, vs, bt, qpos, out, B, H, Hkv, BS, W, \
                           window, sm_scale, st);
  RT_G(16) RT_G(8) RT_G(4) RT_G(2) RT_G(1)
#undef RT_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rt_paged_decode_attention(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* bt, const void* qpos, void* out, int B,
                                         int H, int Hkv, int Dh, int BS, int W, int window,
                                         float sm_scale, int q_dtype, int kv_dtype,
                                         void* stream) {
  const int G = H / Hkv;
  int GT = 16;  // the largest of 16, 8, 4, 2, 1 that divides the group
  while (G % GT) GT /= 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128)
    return launch_g<128>(GT, q_dtype, kv_dtype, q, k, v, k_scale, v_scale, bt, qpos, out, B, H,
                         Hkv, BS, W, window, sm_scale, st);
  if (Dh == 64)
    return launch_g<64>(GT, q_dtype, kv_dtype, q, k, v, k_scale, v_scale, bt, qpos, out, B, H,
                        Hkv, BS, W, window, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
