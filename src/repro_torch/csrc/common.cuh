// Shared helpers for the repro_torch Hopper kernels: element conversion,
// the f32 epilogue (scale -> bias -> activation -> residual, the same order
// as kernels/epilogue.py), the dtype codes the Python wrappers pass, and the
// shared-memory primitives (cp.async, ldmatrix, mbarriers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers
#define RT_F32 0
#define RT_BF16 1
#define RT_I8 2

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// activation codes: kernels/epilogue.py ACT_CODES
__device__ __forceinline__ float rt_activation(float y, int act) {
  switch (act) {
    case 1: return y / (1.0f + expf(-y));                               // silu
    case 2: {                                                             // gelu (tanh)
      const float c = 0.7978845608028654f;                                // sqrt(2/pi)
      return 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    case 3: return 0.5f * y * (1.0f + erff(y * 0.7071067811865476f));   // gelu exact
    case 4: return fmaxf(y, 0.0f);                                        // relu
    case 5: { float r = fmaxf(y, 0.0f); return r * r; }                   // relu2
    case 6: return 1.0f / (1.0f + expf(-y));                              // sigmoid
    case 7: return tanhf(y);                                              // tanh
    default: return y;
  }
}

// y (f32 accumulator of output feature `col` of token `row`) through the
// epilogue; scale/bias are f32 (M,), residual is (rows, M) of type TR.
template <typename TR>
__device__ __forceinline__ float rt_epilogue(float y, const float* scale, const float* bias,
                                             const TR* residual, int act, long row, int col,
                                             int M) {
  if (scale) y *= scale[col];
  if (bias) y += bias[col];
  if (act) y = rt_activation(y, act);
  if (residual) y += to_f(residual[row * (long)M + col]);
  return y;
}

// ---- shared memory: cp.async, ldmatrix, mbarriers ----------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, zero-filled when !valid (src then unread)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Waits for the phase of parity `parity` to complete.  A pipeline fault
// would otherwise spin forever: after ~10 s of SM clocks the kernel traps,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 0) t0 = clock64();
    else if ((spins & 0xFFF) == 0 && clock64() - t0 > 20000000000LL) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
