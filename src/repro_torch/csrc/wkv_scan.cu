// RWKV6 wkv recurrence over a per-(slot, head) matrix state S (hd x hd):
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// Replaces: src/repro/kernels/scan_wkv.py::wkv_scan_pallas (grid (slot, head),
// the state resident on chip; prefill walks 16-step chunks of the
// chunked-parallel form with each step's log-decay clipped at -4.9, decode is
// one exact step).
//
// What bounds it on the H100: the bytes.  At rwkv6-7b's serve shapes (B 8,
// H 64, hd 64) a decode step reads and writes the f32 state (2 x 8.4 MB) for
// ~7 FLOP an element; a 256-token prefill chunk reads r, k, v (bf16) and w
// (f32) and writes y (f32): ~134 MB for ~4.3 GFLOP of f32 recurrence, which
// sits just under the f32 CUDA-core rate's line.
//
// Design: one CTA per (slot, head) and one thread per state column j, which
// keeps S[:, j] (hd f32 values) in registers for the whole call, so the state
// is read once and written once.  Steps are staged 16 at a time in shared
// memory (r, k and the decay, converted to f32; every thread reads the same
// element, a broadcast); each thread loads its own v_t[j] and writes its own
// y_t[j], coalesced across the CTA.  No reduction across threads is needed:
// y_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j]) runs down the thread's
// own column.  Prefill (S > 1) walks the steps serially with the floored decay
// w' = exp(clip(log max(w, 1e-38), -4.9, 0)): the sequential recurrence with
// w' equals the reference's chunked form (up to f32 rounding); decode uses
// the raw w.  A padding step (pos -1) skips the update, so the state passes
// through bitwise.  int8 state: dequantized at entry (q * scale); at exit the
// CTA reduces amax over its hd x hd state, scale = max(amax, 1e-8) / 127 and
// q = rint(s / scale) (round half to even, as jnp.round); a slot with no real
// step this call writes back its stored payload and scale unchanged.
#include "common.cuh"

namespace {

constexpr int TSTEP = 16;                   // steps staged in shared memory at once
constexpr float LOG_DECAY_FLOOR = -4.9f;    // kernels/scan_wkv.py WKV_LOG_DECAY_FLOOR

template <int HD, bool UPDATE>
__device__ __forceinline__ float wkv_step(float (&st)[HD], const float4* r4, const float4* k4,
                                          const float4* w4, const float4* u4, float vj) {
  float acc = 0.0f;
#pragma unroll
  for (int i4 = 0; i4 < HD / 4; ++i4) {
    const float4 r = r4[i4], k = k4[i4], w = w4[i4], u = u4[i4];
    const float rr[4] = {r.x, r.y, r.z, r.w}, kk[4] = {k.x, k.y, k.z, k.w};
    const float ww[4] = {w.x, w.y, w.z, w.w}, uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * i4 + c;
      const float kv = kk[c] * vj;
      acc = fmaf(rr[c], fmaf(uu[c], kv, st[i]), acc);
      if (UPDATE) st[i] = fmaf(ww[c], st[i], kv);
    }
  }
  return acc;
}

// int8 exit: amax over the CTA's hd x hd state, scale = max(amax, 1e-8) / 127,
// q = rint(s / scale); a slot with no real step (`updated` false) keeps its
// stored payload and scale bitwise.
template <int HD>
__device__ __forceinline__ void store_quantized(const float (&st)[HD], const int8_t* s0,
                                                const float* sc0, int8_t* s1, float* sc1,
                                                long sbase, long row, int j, bool updated,
                                                float* red) {
  constexpr int NW = (HD + 31) / 32;
  if (!updated) {
    for (int i = 0; i < HD; ++i) s1[sbase + (long)i * HD + j] = s0[sbase + (long)i * HD + j];
    if (j == 0) sc1[row] = sc0[row];
    return;
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < HD; ++i) amax = fmaxf(amax, fabsf(st[i]));
  constexpr unsigned MASK = HD >= 32 ? 0xffffffffu : ((1u << HD) - 1u);
#pragma unroll
  for (int off = (HD >= 32 ? 16 : HD / 2); off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(MASK, amax, off));
  if ((j & 31) == 0) red[j >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int q = 1; q < NW; ++q) amax = fmaxf(amax, red[q]);
  const float sc = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
  for (int i = 0; i < HD; ++i)
    s1[sbase + (long)i * HD + j] = (int8_t)(int)rintf(st[i] / sc);
  if (j == 0) sc1[row] = sc;
}

template <int HD, typename TI, typename TS>
__global__ void __launch_bounds__(HD)
wkv_kernel(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
           const float* __restrict__ w, const float* __restrict__ u, const int* __restrict__ pos,
           const TS* __restrict__ s0, const float* __restrict__ sc0, float* __restrict__ y,
           TS* __restrict__ s1, float* __restrict__ sc1, int S, int H, int floor_decay) {
  constexpr bool QUANT = sizeof(TS) == 1;
  constexpr int NW = (HD + 31) / 32;
  __shared__ float4 rs[TSTEP][HD / 4], ks[TSTEP][HD / 4], ws[TSTEP][HD / 4], us[HD / 4];
  __shared__ int live[TSTEP];
  __shared__ float red[NW];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long sbase = ((long)b * H + h) * HD * HD;
  const float scale_in = QUANT ? sc0[(long)b * H + h] : 1.0f;
  reinterpret_cast<float*>(us)[j] = u[(long)h * HD + j];
  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    st[i] = to_f(s0[sbase + (long)i * HD + j]);
    if (QUANT) st[i] *= scale_in;
  }
  bool saw_real = false;  // uniform over the CTA: it depends on pos only
  for (int t0 = 0; t0 < S; t0 += TSTEP) {
    const int n = min(TSTEP, S - t0);
    __syncthreads();  // the previous stage is consumed (and us is written)
    for (int tt = 0; tt < n; ++tt) {
      const int t = t0 + tt;
      const bool real = pos == nullptr || pos[(long)b * S + t] >= 0;
      const long g = (((long)b * S + t) * H + h) * HD + j;
      float kk = real ? to_f(k[g]) : 0.0f, ww = real ? w[g] : 1.0f;
      if (floor_decay) ww = expf(fminf(fmaxf(logf(fmaxf(ww, 1e-38f)), LOG_DECAY_FLOOR), 0.0f));
      reinterpret_cast<float*>(rs[tt])[j] = to_f(r[g]);
      reinterpret_cast<float*>(ks[tt])[j] = kk;
      reinterpret_cast<float*>(ws[tt])[j] = ww;
      if (j == 0) live[tt] = real;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const long g = (((long)b * S + t0 + tt) * H + h) * HD + j;
      const float vj = to_f(v[g]);
      float acc;
      if (live[tt]) {
        acc = wkv_step<HD, true>(st, rs[tt], ks[tt], ws[tt], us, vj);
        saw_real = true;
      } else {
        acc = wkv_step<HD, false>(st, rs[tt], ks[tt], ws[tt], us, vj);
      }
      y[g] = acc;
    }
  }
  if constexpr (!QUANT) {
#pragma unroll
    for (int i = 0; i < HD; ++i) s1[sbase + (long)i * HD + j] = st[i];
  } else {
    store_quantized<HD>(st, s0, sc0, s1, sc1, sbase, (long)b * H + h, j,
                        pos == nullptr || saw_real, red);
  }
}

template <typename TI, typename TS>
int launch_typed(const void* r, const void* k, const void* v, const float* w, const float* u,
                 const int* pos, const void* s0, const float* sc0, float* y, void* s1,
                 float* sc1, int B, int S, int H, int HD, int floor_decay, cudaStream_t st) {
  const dim3 grid(H, B);
#define WKV_LAUNCH(D)                                                                      \
  wkv_kernel<D, TI, TS><<<grid, D, 0, st>>>((const TI*)r, (const TI*)k, (const TI*)v, w, u, \
                                            pos, (const TS*)s0, sc0, y, (TS*)s1, sc1, S, H, \
                                            floor_decay)
  if (HD == 16) WKV_LAUNCH(16);
  else if (HD == 32) WKV_LAUNCH(32);
  else if (HD == 64) WKV_LAUNCH(64);
  else return (int)cudaErrorInvalidValue;
#undef WKV_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v (B, S, H, hd) of in_dtype (f32 | bf16); w (B, S, H, hd) f32; u (H, hd)
// f32; pos (B, S) int32 or null (every step real); s0 (B, H, hd, hd) of
// state_dtype (f32 | int8) with sc0 (B, H) f32 for int8 (else null); outputs
// y (B, S, H, hd) f32, s1 like s0, sc1 like sc0.  prefill != 0 floors the
// per-step log-decay at -4.9 (the reference's S > 1 form); hd in {16, 32, 64}.
extern "C" int rt_wkv_scan(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* pos, const void* s0, const void* sc0,
                           void* y, void* s1, void* sc1, int B, int S, int H, int HD,
                           int in_dtype, int state_dtype, int prefill, void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float *wf = (const float*)w, *uf = (const float*)u, *scf = (const float*)sc0;
  const int* p = (const int*)pos;
  float *yf = (float*)y, *sc1f = (float*)sc1;
  const bool bf = in_dtype == RT_BF16, q = state_dtype == RT_I8;
  if ((in_dtype != RT_F32 && !bf) || (state_dtype != RT_F32 && !q) || (q && !sc0))
    return (int)cudaErrorInvalidValue;
  if (bf && q)
    return launch_typed<__nv_bfloat16, int8_t>(r, k, v, wf, uf, p, s0, scf, yf, s1, sc1f, B, S,
                                               H, HD, prefill, st);
  if (bf)
    return launch_typed<__nv_bfloat16, float>(r, k, v, wf, uf, p, s0, scf, yf, s1, sc1f, B, S,
                                              H, HD, prefill, st);
  if (q)
    return launch_typed<float, int8_t>(r, k, v, wf, uf, p, s0, scf, yf, s1, sc1f, B, S, H, HD,
                                       prefill, st);
  return launch_typed<float, float>(r, k, v, wf, uf, p, s0, scf, yf, s1, sc1f, B, S, H, HD,
                                    prefill, st);
}
