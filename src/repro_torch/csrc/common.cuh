// Shared helpers for the repro_torch Hopper kernels: element conversion,
// the f32 epilogue (scale -> bias -> activation -> residual, the same order
// as kernels/epilogue.py) and the dtype codes the Python wrappers pass.
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
