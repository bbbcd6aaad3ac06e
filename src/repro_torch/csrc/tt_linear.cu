// TT-linear: the staged contraction of paper Eq. 4, one kernel launch per stage.
//
// Replaces: src/repro/kernels/tt_linear.py::tt_linear_pallas (body
// _stage_contract :50-68), which keeps all d cores and every intermediate in
// VMEM and runs the d stages back to back in one grid step.
//
// What bounds it on the H100: at the llama2-7b shapes a token needs ~9.4
// MFLOP across the four stages against 16 KB of bf16 input/output (~590 FLOP
// per byte), so at prefill widths the operations and the stage-to-stage
// traffic bound it; at decode width (8 tokens) the launches do.
//
// Design: the intermediates do not fit shared memory for every config
// (chatglm3 gate/up needs 2 x 32768 elements per token, tinyllama down
// 2 x 65536), and a stage needs all of the previous stage, so each stage is
// one launch and the intermediates live in a per-call scratch buffer in
// device memory (L2-resident at decode width).  One C call issues all d
// launches.  A stage is a GEMM over all tokens' rows (B*T_k rows x r*n_k
// contraction x m_k*r' columns, the core shared by every token) in 64 x 64
// output tiles.  The inter-stage reorder of the Pallas kernel
// (kernels/tt_linear.py:63-67) is folded into each stage's store index, with
// the rows taken in the order that keeps those stores contiguous, and the
// first stage reads x through the initial (n_1, N/n_1) transpose, so no
// separate transpose pass exists; mode sizes such as 43 and 107 are handled
// by masking every tile edge.  The last stage applies the fused epilogue
// (scale -> bias -> activation -> residual, f32) and writes the output dtype.
//
// bf16 input and cores (the serving path) run on the tensor cores:
// mma.sync m16n8k16 with f32 accumulation, 4 warps per 64 x 64 tile, 32-deep
// k slices staged in shared memory, and bf16 intermediates between stages —
// the rounding repro's ref path and the plain version apply.  Any f32
// operand takes an f32 CUDA-core path (4 x 4 register blocks per thread)
// that keeps f32 intermediates.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64;

struct Stage {
  int first, last, B, T, R, C, n_next, nr, m_prod, m_k, r_next, act;
};

// Row order.  Global row g of a stage is (b, rho) with rho = gq * n_next + i:
// token b's intermediate row t = i * (T / n_next) + gq, where gq = (a, mp)
// indexes (nr, m_prod) and i = i_next.  Taking the next mode's index i as the
// fastest row makes each tile's reordered output land in contiguous runs
// (col' = r * n_next + i), so stores coalesce; the last stage (n_next = 1)
// keeps t = gq.  Each CTA works out, once, every row's input offset and
// output offset and every column's output offset (tile_offsets), so the
// element loops do no index division.  Offsets are 32-bit: the wrapper
// bounds B * max_intermediate below 2^31.
struct Offsets {
  int a_row[BM];    // input offset of the row's element c = 0; -1 past the last row
  int o_row[BM];    // output offset of the row's column 0
  int o_feat[BM];   // last stage: the row's first output feature (t * C)
  int o_col[BN];    // output offset of each column
};

__device__ void tile_offsets(Offsets& o, const Stage& s, int row0, int col0) {
  const int rows = s.B * s.T;
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const int g = row0 + r;
    if (g >= rows) {
      o.a_row[r] = -1;
      continue;
    }
    const int b = g / s.T, rho = g % s.T;
    const int i = rho % s.n_next, gq = rho / s.n_next;
    const int t = i * (s.T / s.n_next) + gq;
    const int per_tok = s.T * s.C;
    o.a_row[r] = s.first ? b * s.R * s.T + t : (b * s.T + t) * s.R;
    o.o_row[r] = s.last ? b * per_tok + t * s.C
                        : b * per_tok + gq * s.m_k * s.r_next * s.n_next + i;
    o.o_feat[r] = t * s.C;
  }
  for (int c = threadIdx.x; c < BN; c += blockDim.x) {
    const int col = col0 + c;
    o.o_col[c] = s.last ? col : (col / s.r_next) * s.r_next * s.n_next + (col % s.r_next) * s.n_next;
  }
}

// One output element: the epilogue on the last stage, a plain store otherwise.
template <typename TOut>
__device__ __forceinline__ void store_out(TOut* out, const Stage& s, const Offsets& o,
                                          const float* scale, const float* bias,
                                          const TOut* residual, int r, int c, int col, float v) {
  const int idx = o.o_row[r] + o.o_col[c];
  if (s.last) {
    const int m = o.o_feat[r] + col;
    if (scale) v *= scale[m];
    if (bias) v += bias[m];
    if (s.act) v = rt_activation(v, s.act);
    if (residual) v += to_f(residual[idx]);
  }
  out[idx] = from_f<TOut>(v);
}

// ---- f32 CUDA-core path ---------------------------------------------------
constexpr int SK = 16, SNT = 256;

template <typename TIn, typename TC, typename TOut>
__global__ void __launch_bounds__(SNT)
tt_stage_simt(const TIn* __restrict__ in, const TC* __restrict__ core, TOut* __restrict__ out,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const TOut* __restrict__ residual, Stage s) {
  __shared__ float As[SK][BM + 4];
  __shared__ float Bs[SK][BN];
  __shared__ Offsets o;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int a_step = s.first ? s.T : 1;  // input stride between consecutive c
  tile_offsets(o, s, row0, col0);
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < s.R; k0 += SK) {
#pragma unroll
    for (int j = 0; j < (BM * SK) / SNT; ++j) {
      const int idx = tid + j * SNT;
      const int r = idx / SK, kk = idx % SK;
      const int c = k0 + kk;
      As[kk][r] = (o.a_row[r] >= 0 && c < s.R) ? to_f(in[o.a_row[r] + c * a_step]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < (SK * BN) / SNT; ++j) {
      const int idx = tid + j * SNT;
      const int kk = idx / BN, cc = idx % BN;
      const int c = k0 + kk, col = col0 + cc;
      Bs[kk][cc] = (c < s.R && col < s.C) ? to_f(core[c * s.C + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (o.a_row[r] < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (col0 + c < s.C) store_out(out, s, o, scale, bias, residual, r, c, col0 + c, acc[i][j]);
    }
  }
}

// ---- bf16 tensor-core path ------------------------------------------------
constexpr int MK = 32, MNT = 128, MPAD = 8;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(MNT)
tt_stage_mma(const __nv_bfloat16* __restrict__ in, const __nv_bfloat16* __restrict__ core,
             __nv_bfloat16* __restrict__ out, const float* __restrict__ scale,
             const float* __restrict__ bias, const __nv_bfloat16* __restrict__ residual,
             Stage s) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][MK + MPAD];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][MK + MPAD];  // [col][k]
  __shared__ Offsets o;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / 2, wn = warp % 2;  // 2 x 2 warps, 32 x 32 each
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int a_step = s.first ? s.T : 1;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  tile_offsets(o, s, row0, col0);
  __syncthreads();
  float acc[2][4][4] = {};

  for (int k0 = 0; k0 < s.R; k0 += MK) {
    for (int idx = tid; idx < BM * MK; idx += MNT) {
      const int r = idx / MK, kk = idx % MK;
      const int c = k0 + kk;
      As[r][kk] = (o.a_row[r] >= 0 && c < s.R) ? in[o.a_row[r] + c * a_step] : zero;
    }
    for (int idx = tid; idx < MK * BN; idx += MNT) {
      const int kk = idx / BN, cc = idx % BN;
      const int c = k0 + kk, col = col0 + cc;
      Bs[cc][kk] = (c < s.R && col < s.C) ? core[c * s.C + col] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < MK; kb += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + gid;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kb + tig * 2]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kb + tig * 2]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kb + tig * 2 + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kb + tig * 2 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + gid;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][kb + tig * 2]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][kb + tig * 2 + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 32 + mt * 16 + gid + (e >= 2 ? 8 : 0);
        const int c = wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (o.a_row[r] >= 0 && col0 + c < s.C)
          store_out(out, s, o, scale, bias, residual, r, c, col0 + c, acc[mt][nt][e]);
      }
}

template <typename TIn, typename TC, typename TOut>
void launch_simt(const void* in, const void* core, void* out, const float* scale,
                 const float* bias, const void* residual, const Stage& s, cudaStream_t st) {
  dim3 grid((unsigned)((s.B * s.T + BM - 1) / BM), (unsigned)((s.C + BN - 1) / BN));
  tt_stage_simt<TIn, TC, TOut><<<grid, SNT, 0, st>>>((const TIn*)in, (const TC*)core, (TOut*)out,
                                                     scale, bias, (const TOut*)residual, s);
}

template <typename TIn, typename TC>
void launch_simt_out(int out_dtype, const void* in, const void* core, void* out,
                     const float* scale, const float* bias, const void* residual,
                     const Stage& s, cudaStream_t st) {
  if (out_dtype == RT_BF16)
    launch_simt<TIn, TC, __nv_bfloat16>(in, core, out, scale, bias, residual, s, st);
  else
    launch_simt<TIn, TC, float>(in, core, out, scale, bias, residual, s, st);
}

}  // namespace

extern "C" int rt_tt_linear(const void* x, int x_dtype, const void* const* cores,
                            const int* core_dtypes, void* scratch0, void* scratch1, void* out,
                            const void* scale, const void* bias, const void* residual, int B,
                            int d, const int* in_modes, const int* out_modes, const int* ranks,
                            int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  bool mma = x_dtype == RT_BF16;
  for (int k = 0; k < d; ++k) mma = mma && core_dtypes[k] == RT_BF16;
  const int mid = mma ? RT_BF16 : RT_F32;  // intermediate dtype
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  const void* src = x;
  int src_dtype = x_dtype, m_prod = 1;
  for (int k = 0; k < d; ++k) {
    const bool last = k == d - 1;
    int t_rows = m_prod;
    for (int j = k + 1; j < d; ++j) t_rows *= in_modes[j];
    int nr = 1;
    for (int j = k + 2; j < d; ++j) nr *= in_modes[j];
    Stage s{k == 0, last, B, t_rows, ranks[k] * in_modes[k], out_modes[k] * ranks[k + 1],
            last ? 1 : in_modes[k + 1], last ? 1 : nr, m_prod, out_modes[k], ranks[k + 1],
            last ? act : 0};
    void* dst = last ? out : (k % 2 ? scratch1 : scratch0);
    const int dst_dtype = last ? x_dtype : mid;
    const float* s_sc = last ? sc : nullptr;
    const float* s_bi = last ? bi : nullptr;
    const void* s_res = last ? residual : nullptr;
    if (mma) {
      dim3 grid((unsigned)((B * t_rows + BM - 1) / BM), (unsigned)((s.C + BN - 1) / BN));
      tt_stage_mma<<<grid, MNT, 0, st>>>((const __nv_bfloat16*)src,
                                         (const __nv_bfloat16*)cores[k], (__nv_bfloat16*)dst,
                                         s_sc, s_bi, (const __nv_bfloat16*)s_res, s);
    } else if (src_dtype == RT_BF16) {
      if (core_dtypes[k] == RT_BF16)
        launch_simt_out<__nv_bfloat16, __nv_bfloat16>(dst_dtype, src, cores[k], dst, s_sc, s_bi,
                                                      s_res, s, st);
      else
        launch_simt_out<__nv_bfloat16, float>(dst_dtype, src, cores[k], dst, s_sc, s_bi, s_res,
                                              s, st);
    } else {
      if (core_dtypes[k] == RT_BF16)
        launch_simt_out<float, __nv_bfloat16>(dst_dtype, src, cores[k], dst, s_sc, s_bi, s_res,
                                              s, st);
      else
        launch_simt_out<float, float>(dst_dtype, src, cores[k], dst, s_sc, s_bi, s_res, s, st);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
    src_dtype = dst_dtype;
    m_prod *= out_modes[k];
  }
  return 0;
}
