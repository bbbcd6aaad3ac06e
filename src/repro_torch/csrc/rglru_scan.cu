// RG-LRU recurrence of griffin / recurrentgemma:
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) gx_t,   a_t = exp(log_a_t)
//
// Replaces: src/repro/kernels/scan_rglru.py::rglru_scan_pallas, both bodies:
// _prefill_kernel (grid (B, W/Wt): token tiles of 16 with a Hillis-Steele scan
// inside each tile and a serial f32 carry between tiles) and _decode_kernel
// (grid (W/Wt,): one masked step for every slot).
//
// What bounds it on the H100: the bytes.  At the serve shapes (B 8, S 256,
// W 2560) a call reads log_a and gx (2 x 21 MB f32) and writes h (10.5 MB
// bf16) for ~15 FLOP per element.
//
// Design: the recurrence is diagonal over W, so one thread owns one (slot,
// channel) and walks S serially with h in an f32 register; neighbouring
// threads take neighbouring channels, so every load and store coalesces over
// W, and the loads of later steps do not depend on h, so the unrolled loop
// keeps several in flight.  No scan across threads is needed.  A padding
// step (pos -1) skips the update, so the state passes through bitwise; a row
// with no real step returns h0 bitwise.  a h + b is rounded after the
// multiply and after the add (no fused multiply-add), as the plain version
// does.  W that is not a multiple of the block is masked.  The decode kernel
// takes one step for every slot in one launch; an inactive row writes h0.
#include "common.cuh"

namespace {

constexpr int NTH = 64;  // channels per block: 320 blocks at B 8, W 2560

__device__ __forceinline__ float rglru_step(float h, float la, float g) {
  const float a = expf(la);
  const float b = __fmul_rn(sqrtf(fmaxf(1.0f - expf(2.0f * la), 1e-12f)), g);
  return __fadd_rn(__fmul_rn(a, h), b);
}

template <typename TO>
__global__ void __launch_bounds__(NTH)
rglru_prefill_kernel(const float* __restrict__ log_a, const float* __restrict__ gx,
                     const float* __restrict__ h0, const int* __restrict__ pos,
                     TO* __restrict__ h, float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * NTH + threadIdx.x, b = blockIdx.y;
  if (w >= W) return;
  float hc = h0[(long)b * W + w];
  const long base = (long)b * S * W + w;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const long i = base + (long)s * W;
    const float la = log_a[i], g = gx[i];
    if (pos == nullptr || pos[(long)b * S + s] >= 0) hc = rglru_step(hc, la, g);
    h[i] = from_f<TO>(hc);
  }
  h_last[(long)b * W + w] = hc;
}

template <typename TO>
__global__ void __launch_bounds__(NTH)
rglru_decode_kernel(const float* __restrict__ log_a, const float* __restrict__ gx,
                    const float* __restrict__ h0, const int* __restrict__ pos,
                    TO* __restrict__ h, float* __restrict__ h_last, int W) {
  const int w = blockIdx.x * NTH + threadIdx.x, b = blockIdx.y;
  if (w >= W) return;
  const long i = (long)b * W + w;
  float hc = h0[i];
  if (pos == nullptr || pos[b] >= 0) hc = rglru_step(hc, log_a[i], gx[i]);
  h[i] = from_f<TO>(hc);
  h_last[i] = hc;
}

template <typename TO>
int launch(const float* log_a, const float* gx, const float* h0, const int* pos, void* h,
           float* h_last, int B, int S, int W, cudaStream_t st) {
  const dim3 grid((W + NTH - 1) / NTH, B);
  if (S == 1)
    rglru_decode_kernel<TO><<<grid, NTH, 0, st>>>(log_a, gx, h0, pos, (TO*)h, h_last, W);
  else
    rglru_prefill_kernel<TO><<<grid, NTH, 0, st>>>(log_a, gx, h0, pos, (TO*)h, h_last, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// log_a, gx (B, S, W) f32; h0 (B, W) f32; pos (B, S) int32 or null (every
// step real); h (B, S, W) of h_dtype (f32 | bf16); h_last (B, W) f32.
extern "C" int rt_rglru_scan(const void* log_a, const void* gx, const void* h0, const void* pos,
                             void* h, void* h_last, int B, int S, int W, int h_dtype,
                             void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float *la = (const float*)log_a, *g = (const float*)gx, *hz = (const float*)h0;
  const int* p = (const int*)pos;
  float* hl = (float*)h_last;
  if (h_dtype == RT_BF16) return launch<__nv_bfloat16>(la, g, hz, p, h, hl, B, S, W, st);
  if (h_dtype == RT_F32) return launch<float>(la, g, hz, p, h, hl, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}
