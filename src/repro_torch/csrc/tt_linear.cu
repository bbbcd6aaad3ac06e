// TT-linear (paper Eq. 4) with the fused epilogue: one fused two-half
// contraction on the bf16 path, the staged contraction on the f32 path.
//
// Replaces: src/repro/kernels/tt_linear.py::tt_linear_pallas (body
// _stage_contract :50-68), which keeps all d cores and every intermediate in
// VMEM and runs the d stages back to back in one grid step.
//
// What bounds it on the H100.  The TT splits at a mode h into a left half
// (modes 1..h: NL inputs, ML outputs) and a right half (NR, MR) joined by the
// rank r = r_h, so y = sum_rho A_rho X B_rho with X the token's (NL x NR)
// view of x, A_rho (ML x NL) the left cores contracted, B_rho (NR x MR) the
// right ones.  Left first (A_rho X, then . B_rho) costs 2 r ML NR (NL + MR)
// operations a token, right first 2 r NL MR (NR + ML); the plan takes the
// cheaper split (kernels/tt_linear.py contraction_plan): 8-38 MFLOP a token
// at the serve specs against 5-36 KB of bf16 in and out, so at prefill widths
// the operations bound it, and in this design the mma.sync rate with each
// CTA's prologue and epilogue and a barrier a rank step around it; at decode
// width (8 tokens) the latency of the rank loop and of the launch pair.  The staged order (one GEMM a core, the intermediates through
// device memory) costs up to 3.3x those operations at auto-factorized modes
// and moved 41-229 K elements a token through HBM between stages.
//
// Design of the bf16 path: two launches a call, nothing staged in HBM.
// 1. tt_operators contracts each half's cores (bf16, or f32 rounded to bf16
//    as they load) into its operator, in f32, rounded once to bf16, into
//    buffers the wrapper allocates per call
//    (nothing derived outlives the call): OPL [r][ML][NL16] and
//    OPR [r][MR][NR16], rows zero-padded to a multiple of 16.
// 2. tt_fused: the half the plan contracts first is P, the other Q; right
//    first is the transpose of left first (Y^T = sum B^T X^T A^T), so one
//    kernel serves both, reading X or X^T and storing Y or Y^T.  A warp owns
//    16 rows (one token, 16 rows of P); for each 64-wide chunk of X's second
//    axis and each rho it computes Z = P_rho[rows] X_tok (mma.sync m16n8k16,
//    f32), rounds Z to bf16 in registers and feeds it straight back as the A
//    operand of Y += Z Q_rho, the way flash attention reuses its
//    probabilities: Z never leaves the warp.  The token's X chunk stays in
//    shared memory for the whole rank loop; P_rho and Q_rho tiles come
//    through a 3-stage cp.async pipeline (16-byte copies, zero-filled past
//    every ragged edge: modes 5, 43, 107, NR 40), and CTAs start the rank
//    loop at different ranks so that they do not all read one L2 line at
//    once.  Fragments come from ldmatrix (.trans for X in the left-first
//    layout).  The CTA shape is chosen per call from the token count: at
//    prefill width 8-warp CTAs of TB tokens x 16 WPT rows that share each
//    P and Q tile; at decode width the most CTAs, their warps splitting the
//    rank loop (KS groups, summed in shared memory).  The epilogue (scale ->
//    bias -> activation -> residual, f32) goes through a shared-memory tile
//    to 16-byte stores in the output's memory order.
//
// The grouped entry (the MoE experts: rows sorted by expert, cores stacked
// on an E axis) keeps the two launches.  Where each half has one or two
// cores (every served expert spec), the operator pass is tt_ops_mma: one
// GEMM of depth r a half on mma.sync, over grid slots that find the experts
// with rows on the device; tt_operators (one thread an operator element, on
// the CUDA cores) serves the ungrouped entry and halves of three or more
// cores.  The contraction takes tt_fused's decode tiles (the
// GROUPED instances) below 4 rows an expert, and from there tt_wgmma:
// operator tiles by TMA into an mbarrier ring, the first product batched
// over a CTA's rows on wgmma, Z fed from registers to the second.  The
// wrapper's grouped_plan picks the route and tt_wgmma's shape.
//
// The staged path (f32 x, cores of mixed dtypes, or a bf16 spec past the
// fused limits): one launch per stage, a GEMM over all tokens' rows
// (B*T_k rows x r*n_k contraction x m_k*r' columns, the core shared by every
// token) in 64 x 64 tiles on the CUDA cores, f32 intermediates in a per-call
// scratch buffer.  The inter-stage reorder of the Pallas kernel
// (kernels/tt_linear.py:63-67) is folded into each stage's store index and
// the first stage reads x through the initial (n_1, N/n_1) transpose.  No
// shipped serving config takes it but the tied TT unembed.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

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

// ---- fused bf16 path ------------------------------------------------------
constexpr int MAXD = 8;      // cores a spec may have
constexpr int SKC = 64;      // width of one chunk of X's second axis
constexpr int FNT = 256;     // threads of a full tt_fused CTA (8 warps)
constexpr int SMEM_MAX = 227 * 1024;

struct OpArgs {
  const void* core[MAXD];  // bf16 or f32 elements (the kernel's TC)
  int n[MAXD], m[MAXD], r[MAXD + 1];
  bool vec[MAXD];  // core k's rows allow 16-byte loads
  int d, h, NL, NR, ML, MR, NL16, NR16;
  __nv_bfloat16* opl;  // [r_h][ML][NL16]
  __nv_bfloat16* opr;  // [r_h][MR][NR16]
  // grouped (offsets != nullptr): blockIdx.y is the expert, whose cores sit
  // estride[k] elements past the previous expert's and whose operators
  // op_stride elements past its; row y = E computes the tile schedule
  const int* offsets;  // (E + 1) row offsets of the experts in the sorted rows
  long estride[MAXD], op_stride;
  int E, R, TB, n_tiles;
  int4* tiles;  // [n_tiles] (expert, first row, end row, 0); expert -1 past the count
};

// Core elements as the operator pass reads them: bf16 as stored, f32 rounded
// to bf16 (round to nearest even) as it loads, so an f32 core gives the
// operators a bf16 copy of it would give (the plain version rounds each core
// to the bf16 of x).  Vec<TC, N> holds N consecutive elements from one
// 2N- or 4N-byte load (N = 4: 8 or 16 bytes; N = 8: 16 or 32 bytes).
__device__ __forceinline__ float core_val(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float core_val(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename TC, int N> struct Vec;
template <int N> struct Vec<__nv_bfloat16, N> {
  using Raw = typename std::conditional<N == 8, uint4, uint2>::type;
  Raw u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ float get(int e) const {
    const __nv_bfloat162 h2 = reinterpret_cast<const __nv_bfloat162*>(&u)[e / 2];
    return e % 2 ? __high2float(h2) : __low2float(h2);
  }
};
template <int N> struct Vec<float, N> {
  float4 u[N / 4];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) u[c] = reinterpret_cast<const float4*>(p)[c];
  }
  __device__ __forceinline__ float get(int e) const {
    const float4 q = u[e / 4];
    return core_val(e % 4 == 0 ? q.x : e % 4 == 1 ? q.y : e % 4 == 2 ? q.z : q.w);
  }
};

template <typename TC>
__device__ __forceinline__ const TC* core_ptr(const OpArgs& o, int k) {
  return static_cast<const TC*>(o.core[k]) + blockIdx.y * o.estride[k];  // 0 ungrouped
}

// The grouped contraction's row-tile schedule (kernels/tt_linear.py
// grouped_tiles is its plain version): expert e's rows [offsets[e],
// offsets[e + 1]) cut into tiles of TB rows, the experts in order, so that no
// tile crosses an expert; n_tiles = ceil(R / TB) + E slots bound the count,
// and the slots past it get expert -1 (their CTAs exit).  One block, a
// block-wide scan of the experts' tile counts, 256 experts at a time.
__device__ __forceinline__ void grouped_schedule(const int* offsets, int E, int R, int TB,
                                                 int n_tiles, int4* tiles) {
  __shared__ int scan[256];
  __shared__ int carry;  // tiles of the experts before this chunk
  const int tid = threadIdx.x;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int e0 = 0; e0 < E; e0 += 256) {
    const int e = e0 + tid;
    const int lo = e < E ? min(max(offsets[e], 0), R) : 0;
    const int hi = e < E ? min(max(offsets[e + 1], lo), R) : 0;
    const int n = (hi - lo + TB - 1) / TB;
    scan[tid] = n;
    __syncthreads();
    for (int s = 1; s < 256; s *= 2) {  // inclusive scan
      const int v = tid >= s ? scan[tid - s] : 0;
      __syncthreads();
      scan[tid] += v;
      __syncthreads();
    }
    const int first = carry + scan[tid] - n;
    for (int i = 0; i < n && first + i < n_tiles; ++i)
      tiles[first + i] = make_int4(e, lo + i * TB, min(lo + (i + 1) * TB, hi), 0);
    __syncthreads();  // every thread has read carry
    if (tid == 255) carry += scan[255];
    __syncthreads();
  }
  for (int t = carry + tid; t < n_tiles; t += 256) tiles[t] = make_int4(-1, 0, 0, 0);
}

// Rows G_k[a, i, j, 0 .. r_{k+1}) for a = a0 .. a0 + 3 of core k (stored as the
// (r_k n_k, m_k r_{k+1}) matrix) as f32, zeros past r_{k+1} and past r_k: all
// loads issued before any is used (16-byte loads where ``vec``).
template <int RC, typename TC>
__device__ __forceinline__ void core_rows4(const OpArgs& o, int k, int a0, int i, int j, bool vec,
                                           float (&row)[4][RC]) {
  const int rk = o.r[k], rn = o.r[k + 1];
  const TC* base = core_ptr<TC>(o, k) + (long)i * (o.m[k] * rn) + (long)j * rn;
  const long astep = (long)o.n[k] * o.m[k] * rn;  // from row a to row a + 1
  if (vec) {
    Vec<TC, 8> u[4][RC / 8];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int b0 = 0; b0 < RC; b0 += 8) {
        const int a = min(a0 + t, rk - 1), bb = min(b0, rn - 8);  // in range; zeroed below
        u[t][b0 / 8].load(base + a * astep + bb);
      }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int b0 = 0; b0 < RC; b0 += 8) {
        const bool ok = a0 + t < rk && b0 < rn;
#pragma unroll
        for (int e = 0; e < 8; ++e) row[t][b0 + e] = ok ? u[t][b0 / 8].get(e) : 0.f;
      }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int b = 0; b < RC; ++b) {
        const int a = min(a0 + t, rk - 1), bb = min(b, rn - 1);
        const float val = core_val(base[a * astep + bb]);
        row[t][b] = (a0 + t < rk && b < rn) ? val : 0.f;
      }
  }
}

// v <- v G_k (LEFT: v'[b] = sum_a v[a] G_k[a, i, j, b]) or v <- G_k v
// (v'[a] = sum_b G_k[a, i, j, b] v[b]) over all RC >= r_k, r_{k+1} values.
template <int RC, bool LEFT, typename TC>
__device__ __forceinline__ void chain_step(const OpArgs& o, int k, int i, int j, float (&v)[RC]) {
  float w[RC], row[4][RC];
#pragma unroll
  for (int b = 0; b < RC; ++b) w[b] = 0.f;
#pragma unroll
  for (int a0 = 0; a0 < RC; a0 += 4) {
    core_rows4<RC, TC>(o, k, a0, i, j, o.vec[k], row);  // zeros past r_k
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (LEFT) {
#pragma unroll
        for (int b = 0; b < RC; ++b) w[b] = fmaf(v[a0 + t], row[t][b], w[b]);
      } else {
#pragma unroll
        for (int b = 0; b < RC; ++b) w[a0 + t] = fmaf(row[t][b], v[b], w[a0 + t]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < RC; ++b) v[b] = w[b];
}

// One thread per (out index, in index) of a half, digits most significant
// first: the chain of the half's cores in f32.  A half of one or two cores
// gives each thread 4 values of rho: the chain's last core contributes only
// those, so its loads are independent of the rest of the chain and the
// thread takes one round trip to memory.  A longer half gives each thread
// every rho (a thread per quad would redo the middle cores 4 times).
template <int RC, typename TC>
__global__ void __launch_bounds__(256) tt_operators(OpArgs o) {
  if (o.offsets) {  // grouped: an expert with no rows needs no operators
    if (blockIdx.y == o.E) {
      if (blockIdx.x == 0) grouped_schedule(o.offsets, o.E, o.R, o.TB, o.n_tiles, o.tiles);
      return;
    }
    if (o.offsets[blockIdx.y + 1] == o.offsets[blockIdx.y]) return;
  }
  const int rho = o.r[o.h];
  const int nql = o.h <= 2 ? (rho + 3) / 4 : 1, nqr = o.d - o.h <= 2 ? (rho + 3) / 4 : 1;
  const long nl = (long)o.ML * o.NL16, nr = (long)o.MR * o.NR16;
  long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nl * nql + nr * nqr) return;
  const bool left = idx < nl * nql;
  if (!left) idx -= nl * nql;
  const long n_half = left ? nl : nr;
  const bool quad = (left ? o.h : o.d - o.h) <= 2;
  const int q4 = (int)(idx / n_half) * 4;  // this thread's first rho (quad mode)
  idx %= n_half;
  const int width = left ? o.NL16 : o.NR16, n_in = left ? o.NL : o.NR;
  int jj = (int)(idx / width), ii = (int)(idx % width);
  const int k0 = left ? 0 : o.h, k1 = left ? o.h : o.d;  // the half's cores [k0, k1)
  __nv_bfloat16* dst = (left ? o.opl : o.opr) + blockIdx.y * o.op_stride + (long)jj * width + ii;
  const long rstride = (long)(left ? o.ML : o.MR) * width;
  float v[RC];
#pragma unroll
  for (int a = 0; a < RC; ++a) v[a] = 0.f;
  float out[4] = {0.f, 0.f, 0.f, 0.f};
  if (ii < n_in) {  // else the zero padding of the contraction axis
    int di[MAXD], dj[MAXD];
    for (int k = k1 - 1; k >= k0; --k) {
      di[k] = ii % o.n[k];
      ii /= o.n[k];
      dj[k] = jj % o.m[k];
      jj /= o.m[k];
    }
    float row[4][RC];
    if (left) {  // G_0[0, i_0, j_0, :] G_1 ... G_{h-1}[:, ., ., rho]
      const int kf = k1 - 1;
      if (!quad) {
        core_rows4<RC, TC>(o, 0, 0, di[0], dj[0], o.vec[0], row);
#pragma unroll
        for (int b = 0; b < RC; ++b) v[b] = row[0][b];
        for (int k = 1; k <= kf; ++k) chain_step<RC, true, TC>(o, k, di[k], dj[k], v);
      } else {
        const int rk = o.r[kf], rn = o.r[kf + 1];
        const TC* cf =
            core_ptr<TC>(o, kf) + (long)di[kf] * (o.m[kf] * rn) + (long)dj[kf] * rn;
        const long astep = (long)o.n[kf] * o.m[kf] * rn;
        float g[RC][4];  // the last core's rows, this thread's 4 columns
        if (o.vec[kf]) {   // 8- or 16-byte loads: r_{k+1} is a multiple of 8
#pragma unroll
          for (int a = 0; a < RC; ++a) {
            Vec<TC, 4> u;
            u.load(cf + min(a, rk - 1) * astep + q4);
#pragma unroll
            for (int t = 0; t < 4; ++t) g[a][t] = a < rk ? u.get(t) : 0.f;
          }
        } else {
#pragma unroll
          for (int a = 0; a < RC; ++a)
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float val = core_val(cf[min(a, rk - 1) * astep + min(q4 + t, rn - 1)]);
              g[a][t] = (a < rk && q4 + t < rn) ? val : 0.f;
            }
        }
        if (kf == 0) {
#pragma unroll
          for (int t = 0; t < 4; ++t) out[t] = g[0][t];
        } else {
          core_rows4<RC, TC>(o, 0, 0, di[0], dj[0], o.vec[0], row);
#pragma unroll
          for (int b = 0; b < RC; ++b) v[b] = row[0][b];
          for (int k = 1; k < kf; ++k) chain_step<RC, true, TC>(o, k, di[k], dj[k], v);
#pragma unroll
          for (int a = 0; a < RC; ++a)
#pragma unroll
            for (int t = 0; t < 4; ++t) out[t] = fmaf(v[a], g[a][t], out[t]);
        }
      }
    } else if (k0 == o.d) {  // an empty right half (d = 1) is the identity
      out[0] = v[0] = 1.f;
    } else {  // G_h[rho, ., ., :] G_{h+1} ... G_{d-1}[:, ., ., 0]
      const int kl = o.d - 1, rl = o.r[kl];
      if (quad) core_rows4<RC, TC>(o, k0, q4, di[k0], dj[k0], o.vec[k0], row);  // 4 rows of G_h
      if (quad && k0 == kl) {
#pragma unroll
        for (int t = 0; t < 4; ++t) out[t] = row[t][0];
      } else {
#pragma unroll
        for (int a = 0; a < RC; ++a) {
          const float val = core_val(
              core_ptr<TC>(o, kl)[((long)min(a, rl - 1) * o.n[kl] + di[kl]) * o.m[kl] + dj[kl]]);
          v[a] = a < rl ? val : 0.f;
        }
        for (int k = kl - 1; k > k0; --k) chain_step<RC, false, TC>(o, k, di[k], dj[k], v);
        if (quad) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int b = 0; b < RC; ++b) out[t] = fmaf(row[t][b], v[b], out[t]);
        } else if (kl > k0) {
          chain_step<RC, false, TC>(o, k0, di[k0], dj[k0], v);
        }
      }
    }
  }
  if (quad) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (q4 + t < rho) dst[(q4 + t) * rstride] = __float2bfloat16(out[t]);
  } else {
#pragma unroll
    for (int p = 0; p < RC; ++p)
      if (p < rho) dst[p * rstride] = __float2bfloat16(v[p]);
  }
}

struct Fused {
  int B, N, M;         // tokens, n_in, n_out
  int Mf, Nf, Ns, Ms;  // Z = P_rho (Mf x Nf) . X (Nf x Ns); Y += Z . Q_rho (Ns x Ms)
  int Nf16, Ns16;      // padded row lengths of P and Q
  int r, left, act;    // rank; 1: X is the token's row-major (Nf x Ns) view, Y row-major
  int TB, WPT, KS;     // tokens a CTA, warps a token's rows, warps splitting the ranks
  int xvec;            // x rows allow 16-byte loads
  int rvec;            // the residual allows 16-byte loads
  int tb_max;          // the most tokens a CTA may take
  // grouped (tiles != nullptr): CTA x takes tile x of the schedule, rows of
  // one expert, whose operators sit op_stride elements past the previous
  // expert's; B is then the row count R
  const int4* tiles;
  long op_stride;
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_1() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Shared-memory geometry of a tt_fused CTA (bf16 elements; row strides are
// padded by 8 so that ldmatrix's eight 16-byte rows hit distinct banks).
// Each of the NST stages holds KS tiles of P and of Q; after the loop the
// same memory takes the KS - 1 partial Y fragments of the rank split, then
// the CTA's f32 output tile.
constexpr int NST = 3;  // P/Q pipeline stages: tiles arrive two rank steps ahead
struct FusedSmem {
  int sk16, x_rows, x_stride, p_stride, q_stride, tmf, bnt;
  __host__ __device__ FusedSmem(const Fused& f, int bnt_) {
    sk16 = f.Ns16 < SKC ? f.Ns16 : SKC;
    x_rows = f.left ? f.Nf16 : sk16;
    x_stride = (f.left ? sk16 : f.Nf16) + 8;
    p_stride = f.Nf16 + 8;
    q_stride = sk16 + 8;
    tmf = 16 * f.WPT;
    bnt = bnt_;
  }
  __host__ __device__ int x_elems(const Fused& f) const { return f.TB * x_rows * x_stride; }
  __host__ __device__ int p_elems() const { return tmf * p_stride; }
  __host__ __device__ int q_elems() const { return bnt * q_stride; }
  __host__ __device__ int bytes(const Fused& f) const {
    const int loop = 2 * (x_elems(f) + NST * f.KS * (p_elems() + q_elems()));
    const int red = 4 * (f.KS - 1) * f.TB * f.WPT * 16 * bnt;
    const int out = 4 * f.TB * f.WPT * 16 * (bnt + 4);  // the epilogue's f32 tile
    const int most = loop > red ? loop : red;
    return most > out ? most : out;
  }
};

// BNT output columns a CTA, LEFT: X is the token's row-major (Nf x Ns) view,
// NP: 16-wide column pairs of an X chunk (Ns16 / 16, at most 4), GROUPED:
// CTAs take the grouped schedule's tiles (a kernel of its own name, so that
// a profile tells the grouped decode tiles from the ungrouped contraction).
template <int BNT, bool LEFT, int NP, bool GROUPED>
__global__ void __launch_bounds__(FNT, 2)
tt_fused(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ P,
         const __nv_bfloat16* __restrict__ Q, __nv_bfloat16* __restrict__ y,
         const float* __restrict__ scale, const float* __restrict__ bias,
         const __nv_bfloat16* __restrict__ residual, Fused f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FusedSmem g(f, BNT);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TB][x_rows][x_stride]
  __nv_bfloat16* Ps = Xs + g.x_elems(f);                            // [NST][KS][tmf][p_stride]
  __nv_bfloat16* Qs = Ps + NST * f.KS * g.p_elems();                // [NST][KS][BNT][q_stride]

  int tok0 = blockIdx.x * f.TB, tok_end = f.B;  // tokens [tok0, min(tok0 + TB, tok_end))
  if (GROUPED) {
    const int4 t = f.tiles[blockIdx.x];
    if (t.x < 0) return;  // a slot past the schedule's count (CTA-uniform)
    tok0 = t.y;
    tok_end = t.z;
    P += t.x * f.op_stride;
    Q += t.x * f.op_stride;
  }
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mf0 = blockIdx.y * g.tmf, ms0 = blockIdx.z * BNT;
  const int n_rb = f.TB * f.WPT;                 // row blocks of 16 (token, P rows) a CTA
  const int rb = warp % n_rb, kg = warp / n_rb;  // this warp's row block, rank group
  const int wt = rb / f.WPT, wm = (rb % f.WPT) * 16;
  const int tok = tok0 + wt;
  const bool live = tok < tok_end && mf0 + wm < f.Mf;  // warp-uniform
  const int n_chunks = (f.Ns16 + SKC - 1) / SKC;
  const int rho_steps = (f.r + f.KS - 1) / f.KS;  // rank steps a chunk (KS ranks a step)
  const int total = n_chunks * rho_steps;
  // CTAs start the rank loop at different ranks, so that they do not all
  // read the same operator tile from L2 at once (the sum's order differs)
  const int rot = (blockIdx.x + blockIdx.y) % rho_steps;
  auto rank_of = [&](int it, int j) { return ((it % rho_steps + rot) % rho_steps) * f.KS + j; };

  auto load_x = [&](int c) {  // X chunk c of every token of the CTA
    const int s0 = c * SKC;
    for (int t = 0; t < f.TB; ++t) {
      const int tk = tok0 + t;
      const __nv_bfloat16* xt = x + (long)min(tk, tok_end - 1) * f.N;
      __nv_bfloat16* xs = Xs + t * g.x_rows * g.x_stride;
      // LEFT: rows f (Nf16) of columns s (sk16); else rows s (sk16) of columns f (Nf16)
      const int rows = LEFT ? f.Nf16 : g.sk16, cols = LEFT ? g.sk16 : f.Nf16;
      if (f.xvec) {
        const int per_row = cols / 8;
        for (int e = tid; e < rows * per_row; e += nth) {
          const int rr = e / per_row, cc = (e % per_row) * 8;
          const int fi = LEFT ? rr : cc, si = s0 + (LEFT ? cc : rr);
          const bool ok = tk < tok_end && fi < f.Nf && si < f.Ns;
          const long off = LEFT ? (long)fi * f.Ns + si : (long)si * f.Nf + fi;
          cp16(xs + rr * g.x_stride + cc, ok ? xt + off : x, ok);
        }
      } else {
        for (int e = tid; e < rows * cols; e += nth) {
          const int rr = e / cols, cc = e % cols;
          const int fi = LEFT ? rr : cc, si = s0 + (LEFT ? cc : rr);
          const bool ok = tk < tok_end && fi < f.Nf && si < f.Ns;
          const long off = LEFT ? (long)fi * f.Ns + si : (long)si * f.Nf + fi;
          xs[rr * g.x_stride + cc] = ok ? xt[off] : __float2bfloat16(0.f);
        }
      }
    }
  };
  // each thread's walk over the 16-byte chunks of a P and of a Q tile, fixed
  // for the kernel: a start and a step, no division in the loop
  const int pc = f.Nf16 / 8, qc = g.sk16 / 8;
  const int p_r0 = tid / pc, p_c0 = tid % pc, p_dr = nth / pc, p_dc = nth % pc;
  const int q_r0 = tid / qc, q_c0 = tid % qc, q_dr = nth / qc, q_dc = nth % qc;
  auto load_pq = [&](int it, int buf) {  // the KS tiles of P_rho and of Q_rho's chunk
    const int s0 = (it / rho_steps) * SKC;
    for (int j = 0; j < f.KS; ++j) {
      const int p = rank_of(it, j);
      if (p >= f.r) break;
      __nv_bfloat16* ps = Ps + (buf * f.KS + j) * g.p_elems();
      const __nv_bfloat16* pg = P + ((long)p * f.Mf + mf0) * f.Nf16;
      for (int rr = p_r0, cc = p_c0; rr < g.tmf;) {
        const bool ok = mf0 + rr < f.Mf;
        cp16(ps + rr * g.p_stride + cc * 8, ok ? pg + (long)rr * f.Nf16 + cc * 8 : P, ok);
        rr += p_dr;
        cc += p_dc;
        if (cc >= pc) {
          cc -= pc;
          ++rr;
        }
      }
      __nv_bfloat16* qs = Qs + (buf * f.KS + j) * g.q_elems();
      const __nv_bfloat16* qg = Q + ((long)p * f.Ms + ms0) * f.Ns16 + s0;
      for (int rr = q_r0, cc = q_c0; rr < BNT;) {
        const bool ok = ms0 + rr < f.Ms && s0 + cc * 8 < f.Ns16;
        cp16(qs + rr * g.q_stride + cc * 8, ok ? qg + (long)rr * f.Ns16 + cc * 8 : Q, ok);
        rr += q_dr;
        cc += q_dc;
        if (cc >= qc) {
          cc -= qc;
          ++rr;
        }
      }
    }
  };

  float yacc[BNT / 8][4];
#pragma unroll
  for (int i = 0; i < BNT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[i][e] = 0.f;

  // groups in flight at the top of iteration it: its own P/Q, then it + 1's
  load_x(0);
  load_pq(0, 0);
  cp_commit();
  if (total > 1) load_pq(1, 1);
  cp_commit();
  const __nv_bfloat16* xw = Xs + wt * g.x_rows * g.x_stride;
  for (int it = 0; it < total; ++it) {
    const int buf = it % NST;
    const int rho = rank_of(it, kg);
    if (it % rho_steps == 0)
      cp_wait_all();  // a chunk's first step: its X as well
    else
      cp_wait_1();
    __syncthreads();
    if (it + 2 < total) load_pq(it + 2, (it + 2) % NST);
    cp_commit();
    if (live && rho < f.r) {
      const __nv_bfloat16* ps = Ps + (buf * f.KS + kg) * g.p_elems() + wm * g.p_stride;
      const __nv_bfloat16* qs = Qs + (buf * f.KS + kg) * g.q_elems();
      float z[2 * NP][4];
#pragma unroll
      for (int i = 0; i < 2 * NP; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[i][e] = 0.f;
      // Z (16 x 16 NP) = P_rho[16 rows] (16 x Nf16) . X_chunk (Nf16 x 16 NP)
#pragma unroll 2
      for (int kb = 0; kb < f.Nf16; kb += 16) {
        uint32_t a[4], b[NP][4];
        ldsm_x4(a, ps + (lane & 15) * g.p_stride + kb + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          if (LEFT)  // X stored [f][s]: k-major, transposed on load
            ldsm_x4_t(b[np], xw + (kb + (lane & 15)) * g.x_stride + np * 16 + (lane >> 4) * 8);
          else       // X stored [s][f]: n-major
            ldsm_x4(b[np], xw + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * g.x_stride + kb +
                               ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          mma16816(z[2 * np], a, b[np][0], b[np][1]);
          mma16816(z[2 * np + 1], a, b[np][2], b[np][3]);
        }
      }
      // Y (16 x BNT) += Z (bf16, 16 x 16 NP) . Q_rho chunk (16 NP x BNT)
#pragma unroll
      for (int ks = 0; ks < NP; ++ks) {
        const uint32_t za[4] = {pack2(z[2 * ks][0], z[2 * ks][1]),
                                pack2(z[2 * ks][2], z[2 * ks][3]),
                                pack2(z[2 * ks + 1][0], z[2 * ks + 1][1]),
                                pack2(z[2 * ks + 1][2], z[2 * ks + 1][3])};
        uint32_t b[BNT / 16][4];
#pragma unroll
        for (int np = 0; np < BNT / 16; ++np)
          ldsm_x4(b[np], qs + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * g.q_stride +
                             ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < BNT / 16; ++np) {
          mma16816(yacc[2 * np], za, b[np][0], b[np][1]);
          mma16816(yacc[2 * np + 1], za, b[np][2], b[np][3]);
        }
      }
    }
    if (it + 1 < total && (it + 1) % rho_steps == 0) {  // next chunk: its X
      __syncthreads();
      load_x((it + 1) / rho_steps);
      cp_commit();
    }
  }

  if (f.KS > 1) {  // sum the rank groups' partial Y into group 0, fragment by fragment
    float* red = reinterpret_cast<float*>(smem_raw);  // [KS - 1][n_rb][BNT / 8][4][32]
    __syncthreads();
    if (kg > 0 && live) {
      float* r = red + ((kg - 1) * n_rb + rb) * (BNT / 8) * 4 * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < BNT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) r[(nt * 4 + e) * 32] = yacc[nt][e];
    }
    __syncthreads();
    if (kg == 0 && live) {
      for (int k2 = 1; k2 < f.KS; ++k2) {
        const float* r = red + ((k2 - 1) * n_rb + rb) * (BNT / 8) * 4 * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < BNT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[nt][e] += r[(nt * 4 + e) * 32];
      }
    }
  }
  // Epilogue through shared memory: the fragments land in a (rows, BNT) f32
  // tile, then each thread takes groups of 8 outputs consecutive in memory,
  // issues the residual loads of all its groups first (16 bytes each where
  // aligned), and forms and stores them in a rolled loop.  The epilogue is
  // scale -> bias -> activation -> residual in f32; the activation runs in a
  // rolled loop, because eight inlined copies of its code per group cost more
  // than the whole store phase (measured).
  float* ot = reinterpret_cast<float*>(smem_raw);  // [n_rb * 16][BNT + 4]
  constexpr int OS = BNT + 4;
  __syncthreads();
  if (live && kg == 0) {
#pragma unroll
    for (int nt = 0; nt < BNT / 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(ot + (rb * 16 + gid + hf * 8) * OS + nt * 8 + tig * 2) =
            make_float2(yacc[nt][2 * hf], yacc[nt][2 * hf + 1]);
  }
  __syncthreads();
  // groups of 8 outputs consecutive in memory: columns (LEFT) or P rows
  constexpr int GPT = BNT / 16;  // groups a thread, at most (n_rb * 16 * BNT / 8) / (32 * n_rb)
  const int groups = n_rb * 2 * BNT;
  int gm[GPT], gtk[GPT], gr[GPT], gc[GPT], gn[GPT];  // first m, token, tile row, column, valid
  float res[GPT][8];  // all residual loads are issued before any output is formed
#pragma unroll
  for (int u = 0; u < GPT; ++u) {
    const int gi = tid + u * nth;
    int t = 0, mfl = 0, c = 0, n = 0;
    gm[u] = gtk[u] = 0;
    if (gi < groups) {
      if (LEFT) {
        c = (gi % (BNT / 8)) * 8;
        mfl = (gi / (BNT / 8)) % g.tmf;
        t = gi / ((BNT / 8) * g.tmf);
      } else {
        mfl = (gi % (g.tmf / 8)) * 8;
        c = (gi / (g.tmf / 8)) % BNT;
        t = gi / ((g.tmf / 8) * BNT);
      }
      const int tk = tok0 + t, mf = mf0 + mfl, ms = ms0 + c;
      if (tk < tok_end && mf < f.Mf && ms < f.Ms)
        n = LEFT ? min(8, f.Ms - ms) : min(8, f.Mf - mf);
      gm[u] = LEFT ? mf * f.Ms + ms : ms * f.Mf + mf;
      gtk[u] = tk;
    }
    gr[u] = t * g.tmf + mfl;
    gc[u] = c;
    gn[u] = n;
    const long off = (long)gtk[u] * f.M + gm[u];
    const bool vec = n == 8 && (off & 7) == 0 && f.rvec;
#pragma unroll
    for (int e = 0; e < 8; ++e) res[u][e] = 0.f;
    if (residual && vec) {
      const uint4 q = *reinterpret_cast<const uint4*>(residual + off);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = __bfloat1622float2(h2[e]);
        res[u][2 * e] = f2.x;
        res[u][2 * e + 1] = f2.y;
      }
    } else if (residual) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n) res[u][e] = __bfloat162float(residual[off + e]);
    }
  }
#pragma unroll 1  // one copy of the activation code, not GPT of them
  for (int u = 0; u < GPT; ++u) {
    const int n = gn[u];
    if (n == 0) continue;
    const long off = (long)gtk[u] * f.M + gm[u];
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = LEFT ? ot[gr[u] * OS + gc[u] + e] : ot[(gr[u] + e) * OS + gc[u]];
      const int m = gm[u] + (e < n ? e : 0);
      if (scale) v[e] *= scale[m];
      if (bias) v[e] += bias[m];
    }
    if (f.act) {  // rolled: the activation's code once, not once per element
#pragma unroll 1
      for (int e = 0; e < 8; ++e) v[e] = rt_activation(v[e], f.act);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += res[u][e];
    if (n == 8 && (off & 7) == 0) {
      uint4 q;
      uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = pack2(v[2 * e], v[2 * e + 1]);
      *reinterpret_cast<uint4*>(y + off) = q;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n) y[off + e] = __float2bfloat16(v[e]);
    }
  }
}

// The CTA shape for B tokens, over every (TB, WPT, KS) with TB * WPT * KS <=
// 8 warps whose shared memory fits.  With tokens enough for two CTAs an SM
// (prefill): KS = 1, then the most warps, the most CTAs an SM holds, the most
// tokens a CTA (each P_rho tile serves TB tokens, each Q_rho tile every
// row).  Otherwise (decode width): the most CTAs, then the most warps, which
// split the rank loop (KS) so that each walks r / KS of it.
template <int BNT>
int pick_shape(Fused& f) {
  long best_key = -1;
  int best[3] = {0, 0, 0};
  const int wpt_max = (f.Mf + 15) / 16;
  for (int tb = 8; tb >= 1; tb /= 2) {
    if (tb > f.tb_max) continue;
    for (int wpt = 1; tb * wpt <= 8; wpt *= 2) {
      if (wpt > 1 && wpt / 2 >= wpt_max) break;  // no warp without P rows
      for (int ks = 1; tb * wpt * ks <= 8; ks *= 2) {
        if (ks > 1 && ks / 2 >= f.r) break;  // no warp without a rank
        Fused c = f;
        c.TB = tb;
        c.WPT = wpt;
        c.KS = ks;
        const int bytes = FusedSmem(c, BNT).bytes(c);
        if (bytes > SMEM_MAX) continue;
        const long ctas = (long)((f.B + tb - 1) / tb) * ((f.Mf + 16 * wpt - 1) / (16 * wpt)) *
                          ((f.Ms + BNT - 1) / BNT);
        const int warps = tb * wpt * ks;
        long key;
        if (ctas >= 264) {
          if (ks > 1) continue;
          const int fit = 233472 / (bytes + 1024);  // CTAs an SM's shared memory holds
          const int per_sm = fit < 2 ? fit : 2;       // 2: the registers' limit
          key = (1L << 40) + ((long)warps << 20) + ((long)per_sm << 8) + tb;
        } else {
          key = (ctas << 8) + warps;
        }
        if (key > best_key) {
          best_key = key;
          best[0] = tb;
          best[1] = wpt;
          best[2] = ks;
        }
      }
    }
  }
  if (best_key < 0) return -1;
  f.TB = best[0];
  f.WPT = best[1];
  f.KS = best[2];
  return FusedSmem(f, BNT).bytes(f);
}

// Raises a kernel's dynamic shared-memory limit to `limit` once a device.
template <typename Kernel>
cudaError_t raise_smem(Kernel kern, int limit, unsigned long long& raised) {
  int dev = 0;  // devices whose limit is raised, a bit each
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (!(raised & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (e != cudaSuccess) return e;
    raised |= bit;
  }
  return cudaSuccess;
}

template <int BNT, bool LEFT, int NP, bool GROUPED>
int launch_fused(const void* x, const __nv_bfloat16* P, const __nv_bfloat16* Q, void* y,
                 const float* scale, const float* bias, const void* residual, const Fused& f,
                 int n_tiles, int smem, cudaStream_t st) {
  auto kern = tt_fused<BNT, LEFT, NP, GROUPED>;
  static unsigned long long raised = 0;
  const cudaError_t e = raise_smem(kern, SMEM_MAX, raised);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)n_tiles, (unsigned)((f.Mf + 16 * f.WPT - 1) / (16 * f.WPT)),
            (unsigned)((f.Ms + BNT - 1) / BNT));
  kern<<<grid, 32 * f.TB * f.WPT * f.KS, smem, st>>>(
      (const __nv_bfloat16*)x, P, Q, (__nv_bfloat16*)y, scale, bias,
      (const __nv_bfloat16*)residual, f);
  return (int)cudaGetLastError();
}

template <int BNT, bool LEFT, bool GROUPED>
int launch_fused_np(const void* x, const __nv_bfloat16* P, const __nv_bfloat16* Q, void* y,
                    const float* scale, const float* bias, const void* residual, const Fused& f,
                    int n_tiles, int smem, cudaStream_t st) {
  const int np = (f.Ns16 < SKC ? f.Ns16 : SKC) / 16;
  if (np == 1)
    return launch_fused<BNT, LEFT, 1, GROUPED>(x, P, Q, y, scale, bias, residual, f, n_tiles,
                                               smem, st);
  if (np == 2)
    return launch_fused<BNT, LEFT, 2, GROUPED>(x, P, Q, y, scale, bias, residual, f, n_tiles,
                                               smem, st);
  if (np == 3)
    return launch_fused<BNT, LEFT, 3, GROUPED>(x, P, Q, y, scale, bias, residual, f, n_tiles,
                                               smem, st);
  return launch_fused<BNT, LEFT, 4, GROUPED>(x, P, Q, y, scale, bias, residual, f, n_tiles,
                                             smem, st);
}


// ---- grouped: the operator pass on the tensor cores --------------------------
//
// Each half of one or two cores is one GEMM of depth K = r (one or two mma
// k-steps).  Left half (cores 1, 2; r_0 = 1): A = G_1 as the (n1 m1, r1)
// matrix, B = G_2 as (r1, n2 m2 r2), C[(i1, j1), (i2, j2, rho)] =
// OPL[rho][j1 m2 + j2][i1 n2 + i2].  Right half (cores d-1, d; r_d = 1): A =
// G_{d-1} as (r n m, r'), B = G_d as (r', n m), C[(rho, i, j), (i', j')] =
// OPR[rho][j m' + j'][i n' + i'].  A half of one core takes the identity as
// its other core (B = I for the left, A = I for the right).  A CTA takes one
// group of an expert's C: the left half's rows of a chunk of j1 (every i1)
// and columns of a chunk of j2 (every i2, every rho), the right half's rows
// of a chunk of ranks.  It stages its A rows and B columns in shared memory
// (16-byte copies, cp.async for bf16; f32 cores rounded to bf16 in registers
// as they load), with C's columns ordered so that the input index i2 (i')
// runs fastest, runs mma.sync m16n8k16 (f32 accumulate), rounds each element
// once to bf16 and stores it straight from the fragment into the operators'
// layout (a lane's two neighbouring columns are one 4-byte store, a quad's
// one 16-byte run), then writes the zeros of its rows'
// padding past N.  The CTAs of an expert with no rows are never launched:
// grid.y counts min(E, R) slots, and slot y finds the y-th expert with rows
// from the offsets (a ballot scan, no host read); the last row of grid.y
// writes the contraction's tile schedule.  kernels/tt_linear.py op_groups
// and operators_by_groups are the plain version of this plan.
constexpr int OPS_NT = 256;

struct OpHalf {
  const void* A;  // core matrices (TC elements); nullptr: the identity
  const void* B;
  long a_estride, b_estride;      // elements from one expert's core to the next's
  int K, K16;                     // depth r and its multiple of 16
  int a_ld, b_ld;                 // row lengths of A (rows x K) and B (K x cols)
  int rows, cols, rows16, cols16; // a group's A rows and B columns
  int nA, mA, nB, mB, rr;         // modes of the half's two cores, r_h
  int mac, mc, rc;                // a group's chunks: of mA and of mB (left), of the ranks (right)
  int N, N16, Mt;                 // the half's inputs (padded) and outputs
  int groups, left, avec, bvec;   // groups an expert; 16-byte loads of A rows, B runs
  long op_off;                    // the half's operators within an expert's
};

struct OpsArgs {
  OpHalf half[2];
  const int* offsets;
  int E, R, TB, n_tiles, slots;  // slots: grid.y - 1 (its last row writes the schedule)
  int4* tiles;
  __nv_bfloat16* ops;
  long op_stride;
};

// The y-th expert with rows (rows clamped to [0, R) as grouped_schedule
// reads them), or -1: a block-wide scan of the experts, 512 a pass (two a
// thread, their three offsets loaded at once).  256 threads.
__device__ int nth_active(const int* offsets, int E, int R, int slot) {
  __shared__ int wsum[8];
  __shared__ int found;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) found = -1;
  int base = 0;  // experts with rows before this pass
  for (int e0 = 0; e0 < E; e0 += 512) {
    const int ea = e0 + 2 * tid;
    const int o0 = ea < E ? offsets[ea] : 0, o1 = ea < E ? offsets[ea + 1] : 0;
    const int o2 = ea + 1 < E ? offsets[ea + 2] : 0;
    const int lo0 = min(max(o0, 0), R), lo1 = min(max(o1, 0), R);
    const int a0 = ea < E && min(max(o1, lo0), R) > lo0;
    const int a1 = ea + 1 < E && min(max(o2, lo1), R) > lo1;
    int incl = a0 + a1;  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int first = base + incl - a0 - a1, total = 0;
    for (int w = 0; w < 8; ++w) {
      first += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    if (a0 && first == slot) found = ea;
    if (a1 && first + a0 == slot) found = ea + 1;
    base += total;
    __syncthreads();
    if (found >= 0 || base > slot) break;
  }
  return found;
}

// 8 consecutive elements of a core as bf16 (f32 rounded to nearest even)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  uint4 u;
  u.x = pack2(a.x, a.y);
  u.y = pack2(a.z, a.w);
  u.z = pack2(b.x, b.y);
  u.w = pack2(b.z, b.w);
  return u;
}
__device__ __forceinline__ __nv_bfloat16 load1(const __nv_bfloat16* p) { return *p; }
// 8 bf16 core elements straight to shared memory by cp.async (true), or
// false for f32 cores, which are rounded in registers (load8)
__device__ __forceinline__ bool stage8(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  cp16(dst, src, true);
  return true;
}
__device__ __forceinline__ bool stage8(__nv_bfloat16*, const float*) { return false; }
__device__ __forceinline__ __nv_bfloat16 load1(const float* p) { return __float2bfloat16(*p); }

template <typename TC>
__global__ void __launch_bounds__(OPS_NT) tt_ops_mma(const __grid_constant__ OpsArgs o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.y == o.slots) {
    if (blockIdx.x == 0) grouped_schedule(o.offsets, o.E, o.R, o.TB, o.n_tiles, o.tiles);
    return;
  }
  const int ex = nth_active(o.offsets, o.E, o.R, blockIdx.y);
  if (ex < 0) return;
  const bool left = blockIdx.x < o.half[0].groups;
  const OpHalf& p = o.half[left ? 0 : 1];
  const int g = left ? blockIdx.x : blockIdx.x - o.half[0].groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int as = p.K16 + 8, bs = p.cols16 + 8;  // row strides: conflict-free ldmatrix
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rows16][as]
  __nv_bfloat16* Bs = As + p.rows16 * as;                           // [K16][bs]
  int* row_at = reinterpret_cast<int*>(Bs + p.K16 * bs);  // a C row's element 0 in the operators
  int* col_at = row_at + p.rows16;                         // and a C column's offset from it
  // The group: left (chunk of mac j1, chunk of mc j2), right (chunk of rc
  // ranks).  C's columns run with i2 (left) or i' (right) fastest, so that
  // a pair of neighbouring columns is a pair of neighbouring operator
  // elements.  Left: a = (i1, j1 of the chunk), c = (j2 of the chunk, rho,
  // i2); right: a = (rho of the chunk, i, j), c = (j', i').
  const int chunks = p.mB / p.mc;
  const int ja0 = (g / chunks) * p.mac, jb0 = (g % chunks) * p.mc;
  auto a_row = [&](int a) {  // the core row (of A) of C's row a
    return left ? (a / p.mac) * p.mA + ja0 + a % p.mac : g * p.rows + a;
  };
  auto b_col = [&](int c) {  // the core column (of B) of C's column c
    const int ib = c % p.nB;
    if (!left) return ib * p.mB + c / p.nB;
    return (ib * p.mB + jb0 + c / (p.nB * p.rr)) * p.rr + (c / p.nB) % p.rr;
  };
  const TC* A = p.A ? static_cast<const TC*>(p.A) + ex * p.a_estride : nullptr;
  const TC* B = p.B ? static_cast<const TC*>(p.B) + ex * p.b_estride : nullptr;
  const __nv_bfloat16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
  for (int i = tid; i < p.rows16 * (p.K16 / 8); i += OPS_NT) {  // A rows, zero-padded
    const int a = i / (p.K16 / 8), k0 = (i % (p.K16 / 8)) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (a < p.rows) {
      const int ga = a_row(a);
      if (A && p.avec && k0 + 8 <= p.K) {
        if (stage8(As + a * as + k0, A + (long)ga * p.a_ld + k0)) continue;
        u = load8(A + (long)ga * p.a_ld + k0);
      } else {
        __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
        for (int j = 0; j < 8; ++j)
          if (k0 + j < p.K) h[j] = A ? load1(A + (long)ga * p.a_ld + k0 + j) : (k0 + j == ga ? one : zero);
      }
    }
    *reinterpret_cast<uint4*>(As + a * as + k0) = u;
  }
  if (p.bvec) {
    // 16-byte loads of 8 consecutive core columns (8 ranks on the left, 8 j'
    // on the right), each element to its C column (nB apart); zeros first
    for (int i = tid; i < p.K16 * p.cols16; i += OPS_NT) {
      const int k = i / p.cols16, c = i % p.cols16;
      if (k >= p.K || c >= p.cols) Bs[k * bs + c] = zero;
    }
    const int runs = p.cols / 8;  // C columns c with (c / nB) % 8 == 0 start a run
    for (int i = tid; i < p.K * runs; i += OPS_NT) {
      const int k = i / runs, r = i % runs;
      const int c0 = (r / p.nB) * 8 * p.nB + r % p.nB;
      const uint4 u = load8(B + (long)k * p.b_ld + b_col(c0));
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[k * bs + c0 + j * p.nB] = h[j];
    }
  } else {
    for (int i = tid; i < p.K16 * p.cols16; i += OPS_NT) {
      const int k = i / p.cols16, c = i % p.cols16;
      __nv_bfloat16 v = zero;
      if (k < p.K && c < p.cols) {
        const int gc = b_col(c);
        v = B ? load1(B + (long)k * p.b_ld + gc) : (k == gc ? one : zero);
      }
      Bs[k * bs + c] = v;
    }
  }
  for (int a = tid; a < p.rows; a += OPS_NT) {
    const int q = a % (p.nA * p.mA);  // right: rank a / (nA mA) of the chunk
    row_at[a] = left ? (ja0 + a % p.mac) * p.mB * p.N16 + (a / p.mac) * p.nB
                     : ((g * p.rc + a / (p.nA * p.mA)) * p.Mt + (q % p.mA) * p.mB) * p.N16 +
                           (q / p.mA) * p.nB;
  }
  for (int c = tid; c < p.cols; c += OPS_NT) {
    const int ib = c % p.nB;
    col_at[c] = left ? ((c / p.nB) % p.rr) * p.Mt * p.N16 + (jb0 + c / (p.nB * p.rr)) * p.N16 + ib
                     : (c / p.nB) * p.N16 + ib;
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();
  // C tiles by mma.sync, each element rounded once to bf16 and stored where
  // it belongs: a lane's two neighbouring columns are one 4-byte store (nB
  // even), a quad's eight one 16-byte run
  __nv_bfloat16* dst = o.ops + ex * o.op_stride + p.op_off;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_pairs = p.cols16 / 16;
  for (int item = warp; item < (p.rows16 / 16) * n_pairs; item += OPS_NT / 32) {
    const int mt = item / n_pairs, np = item % n_pairs;
    float acc[2][4] = {};
    for (int ks = 0; ks < p.K16 / 16; ++ks) {
      uint32_t a[4], b[4];
      ldsm_x4(a, As + (mt * 16 + (lane & 15)) * as + ks * 16 + (lane >> 4) * 8);
      ldsm_x4_t(b, Bs + (ks * 16 + (lane & 15)) * bs + np * 16 + (lane >> 4) * 8);
      mma16816(acc[0], a, b[0], b[1]);
      mma16816(acc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = mt * 16 + gid + 8 * hf, col = np * 16 + t * 8 + 2 * tig;
        if (row >= p.rows || col >= p.cols) continue;
        __nv_bfloat16* d = dst + row_at[row] + col_at[col];
        if (p.nB % 2 == 0) {
          *reinterpret_cast<uint32_t*>(d) = pack2(acc[t][2 * hf], acc[t][2 * hf + 1]);
        } else {
          d[0] = __float2bfloat16(acc[t][2 * hf]);
          if (col + 1 < p.cols) dst[row_at[row] + col_at[col + 1]] = __float2bfloat16(acc[t][2 * hf + 1]);
        }
      }
  }
  if (p.N < p.N16) {  // the zero padding of the contraction axis, the group's rows
    const int rows = (left ? p.rr * p.mac * p.mc : p.rc * p.Mt), pad = p.N16 - p.N;
    for (int i = tid; i < rows * pad; i += OPS_NT) {
      const int q = i / pad;  // left: (rho, j1 of the chunk, j2 of the chunk); right: (rho, jj)
      const long row = left ? (long)(q / (p.mac * p.mc)) * p.Mt +
                                  (ja0 + (q / p.mc) % p.mac) * p.mB + jb0 + q % p.mc
                            : (long)g * p.rc * p.Mt + q;
      dst[row * p.N16 + p.N + i % pad] = zero;
    }
  }
}

// ---- grouped: the contraction at prefill width on wgmma -----------------------
//
// Left half first (Y = sum_rho A_rho X B_rho, Y row-major), one CTA per (tile
// of 2 IW rows of one expert, 64 rows of ML, BMS columns of MR).  A producer
// warp streams each rank's operator tiles by TMA into a ring of `stages`
// shared-memory stages (mbarriers: full a stage when its bytes land, empty
// when the 8 consumer warps are done with it): 64 rows of A_rho = OPL[rho]
// (K = NL in 64-wide, 128-byte-swizzled sub-tiles) and BMS rows of B_rho^T =
// OPR[rho] (K = NR), zero-filled past ML, MR, NL16 and NR16.  Two consumer
// warpgroups own IW rows each; before the rank loop each stages its rows' X
// (the row's (NL, NR) view, transposed to K-major, swizzled as TMA would) in
// shared memory for the whole loop.  A rank step, for each pair of its rows,
// is Z = A_rho [X_i X_i+1] (wgmma m64 n2NS k16, both operands in shared
// memory: A_rho is one operand for every row of the CTA), then each row's
// half of Z, rounded to bf16 in registers, is the A operand of Y += Z B_rho
// (wgmma m64 nBMS k16, B_rho^T from shared memory): Z never leaves the
// registers, and each B_rho tile serves 2 IW x 64 rows of Z.  The two warpgroups' wgmmas interleave on the
// tensor cores.  The epilogue goes through shared memory to 16-byte stores
// with the activation.  Rows past the tile's end compute zeros and are not
// stored (no branch between wgmmas).
// D (64 x N, f32) (+)= A (64 x 16) * B (16 x N), both K-major in shared memory
// (descriptors da, db); scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// D (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, K-major, descriptor db).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int WG_THREADS = 384;  // 2 consumer warpgroups + 1 producer warpgroup

struct WgArgs {
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  const int4* tiles;
  int N, M, ML, NL, NR, MR, r, act;
  int kp;           // 64-wide K sub-tiles of A_rho and of a row's X (ceil(NL16 / 64))
  int kf;           // k16 steps of the first product (NL16 / 16)
  int xpad;         // X's tile has padding (NR < NS or NL < NL16)
  int stages;
  int x_bytes;      // one row's staged X
  int p_bytes;      // a stage's A_rho tile
  int stage_bytes;  // a stage
  int ring_off, epi_off, epi_stride, bar_off;
};

// PT rows a first product: 2 (one m64 n2NS operand for a pair of rows) where
// the accumulators leave room for the pair's Z, else 1 (a pair spilled at
// NS 64, BMS 64, IW 4 and ran slower there: PERF.md).
template <int NS, int BMS, int IW>
__host__ __device__ constexpr int pair_rows() { return IW * BMS / 2 + NS > 160 ? 1 : 2; }

template <int NS, int BMS, int IW>
__global__ void __launch_bounds__(WG_THREADS, 1)
tt_wgmma(const __grid_constant__ CUtensorMap tmp, const __grid_constant__ CUtensorMap tmq,
         const __grid_constant__ WgArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int4 t = a.tiles[blockIdx.x];
  if (t.x < 0) return;  // a slot past the schedule's count (CTA-uniform)
  const int ex = t.x, tok0 = t.y, tok_end = t.z;
  const int mb = blockIdx.y, cb = blockIdx.z;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + a.bar_off);
  uint64_t* empty = full + a.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane feeds the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      // CTAs start the rank loop at different ranks, so that they do not all
      // read one operator tile from L2 at once (the sum's order differs)
      const int rot = (blockIdx.x + blockIdx.y + blockIdx.z) % a.r;
      for (int it = 0; it < a.r; ++it) {
        const int s = it % a.stages, rho = (it + rot) % a.r;
        mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
        uint8_t* st = sm + a.ring_off + s * a.stage_bytes;
        mbar_expect_tx(&full[s], a.stage_bytes);
        for (int kk = 0; kk < a.kp; ++kk)
          tma_load_4d(st + kk * 8192, &tmp, &full[s], 64 * kk, 64 * mb, rho, ex);
        for (int kq = 0; kq < (NS + 63) / 64; ++kq)
          tma_load_4d(st + a.p_bytes + kq * BMS * 128, &tmq, &full[s], 64 * kq, BMS * cb, rho,
                      ex);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, wl = threadIdx.x % 128;
  uint8_t* xs = sm + wg * IW * a.x_bytes;  // this warpgroup's rows' X
  const int xsub = IW * NS * 128;           // a 64-wide K sub-tile of its IW rows
  // X of row i: element (f, s) = x[tok][f NR + s] at row i NS + s of sub-tile
  // f / 64 (column f % 64) of a K-major tile (128-byte swizzle), so that
  // consecutive rows are one PT NS-row operand; zeros past NR, NL and the
  // tile's end
  auto x_at = [&](int i, int f, int sc) {
    return xs + (f / 64) * xsub + (i * NS + sc) * 128 + ((((f % 64) / 8) ^ (sc % 8)) * 16) +
           (f % 8) * 2;
  };
  // a row's X is N contiguous elements: 16-byte loads, neighbouring lanes on
  // neighbouring chunks, four a thread in flight; each chunk is 8
  // consecutive s of one f (NR % 8 == 0, x 16-byte aligned: the wrapper's
  // plan), stored as 8 elements of one column
  if (a.xpad)
    for (int c = wl; c < IW * a.x_bytes / 16; c += 128)
      reinterpret_cast<uint4*>(xs)[c] = make_uint4(0, 0, 0, 0);
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const int cpr = a.NR / 8, per_row = a.NL * cpr, total = IW * per_row;
  for (int c0 = wl; c0 < total; c0 += 4 * 128) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 128, i = c / per_row;
      const int tok = tok0 + wg * IW + i;
      v[u] = c < total && tok < tok_end
                 ? __ldg(reinterpret_cast<const uint4*>(a.x + (long)tok * a.N) + c % per_row)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 128;
      if (c >= total) break;
      const int i = c / per_row, r = c % per_row, f = r / cpr, s0 = (r % cpr) * 8;
      const uint16_t* h = reinterpret_cast<const uint16_t*>(&v[u]);
#pragma unroll
      for (int j = 0; j < 8; ++j) *reinterpret_cast<uint16_t*>(x_at(i, f, s0 + j)) = h[j];
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  float y[IW][BMS / 2];
#pragma unroll
  for (int i = 0; i < IW; ++i)
#pragma unroll
    for (int j = 0; j < BMS / 2; ++j) y[i][j] = 0.f;
  const uint32_t xa = smem_u32(xs);
  constexpr int PT = pair_rows<NS, BMS, IW>();
  float z[PT * NS / 2];
  uint32_t za[2][PT][NS / 16][4];  // two sets: one feeds a second product while the next fills
  // Z (64 x PT NS) = A_rho (64 x NL16) . [X_i .. X_i+PT-1] (NL16 x PT NS), one commit group
  auto first_product = [&](uint32_t st, int i) {
    for (int kb = 0; kb < a.kf; ++kb) {
      const uint32_t koff = (kb >> 2) * 8192 + (kb & 3) * 32;
      const uint32_t xoff = (kb >> 2) * xsub + i * NS * 128 + (kb & 3) * 32;
      wgmma_ss<PT * NS>(z, desc_sw128(st + koff), desc_sw128(xa + xoff), kb > 0);
    }
    wgmma_commit();
  };
  auto to_bf16 = [&](uint32_t (&d)[PT][NS / 16][4]) {  // Z's row j columns as A fragments
#pragma unroll
    for (int j = 0; j < PT; ++j)
#pragma unroll
      for (int ks = 0; ks < NS / 16; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          d[j][ks][q] = pack2(z[NS / 2 * j + 8 * ks + 2 * q], z[NS / 2 * j + 8 * ks + 2 * q + 1]);
  };
  for (int it = 0; it < a.r; ++it) {
    const int s = it % a.stages;
    mbar_wait(&full[s], (it / a.stages) & 1);
    const uint32_t st = smem_u32(sm + a.ring_off + s * a.stage_bytes);
    wgmma_fence();
    first_product(st, 0);
    wgmma_wait<0>();  // also the previous step's last second product
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % a.stages]);
    to_bf16(za[0]);
    // Rows i: the next rows' first product is issued ahead of rows i's second
    // product (Y_i+j (64 x BMS) += Z's columns of row i + j . B_rho (NS x
    // BMS)), and converted while that one runs
#pragma unroll
    for (int i = 0; i < IW; i += PT) {
      const int cur = (i / PT) % 2;
      wgmma_fence();
      if (i + PT < IW) first_product(st, i + PT);
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int ks = 0; ks < NS / 16; ++ks)
          wgmma_rs<BMS>(y[i + j], za[cur][j][ks],
                        desc_sw128(st + a.p_bytes + (ks >> 2) * (BMS * 128) + (ks & 3) * 32));
      wgmma_commit();
      if (i + PT < IW) {
        wgmma_wait<1>();  // the next rows' first product; this second product may run on
        to_bf16(za[cur ^ 1]);
      }
    }
  }
  wgmma_wait<0>();

  // epilogue, a row at a time: the accumulators into a (64, BMS) f32 tile,
  // then 8 consecutive outputs a thread: activation (a rolled loop), 16-byte
  // stores
  float* ep = reinterpret_cast<float*>(sm + a.epi_off + wg * a.epi_stride);
  constexpr int ES = BMS + 4;
  const int gid = lane >> 2, tig = lane & 3, wr = (warp % 4) * 16;
#pragma unroll
  for (int i = 0; i < IW; ++i) {
    const int tok = tok0 + wg * IW + i;
    if (tok >= tok_end) break;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the tile is free
#pragma unroll
    for (int j = 0; j < BMS / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(ep + (wr + gid + 8 * hf) * ES + 8 * j + 2 * tig) =
            make_float2(y[i][4 * j + 2 * hf], y[i][4 * j + 2 * hf + 1]);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll 1
    for (int c = wl; c < 64 * (BMS / 8); c += 128) {
      const int row = c / (BMS / 8), c8 = (c % (BMS / 8)) * 8;
      const int ml = mb * 64 + row, mr = cb * BMS + c8;
      if (ml >= a.ML || mr >= a.MR) continue;
      const int n = min(8, a.MR - mr);
      const long off = (long)tok * a.M + (long)ml * a.MR + mr;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = ep[row * ES + c8 + e];
      if (a.act) {
#pragma unroll 1
        for (int e = 0; e < 8; ++e) v[e] = rt_activation(v[e], a.act);
      }
      if (n == 8 && (off & 7) == 0) {
        *reinterpret_cast<uint4*>(a.y + off) =
            make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
      } else {
        for (int e = 0; e < n; ++e) a.y[off + e] = __float2bfloat16(v[e]);
      }
    }
  }
}


// ---- grouped: host-side plans ------------------------------------------------
constexpr int OPS_S_TARGET = 16384;  // a group's operator elements aimed at (32 KB)
constexpr int OPS_S_MAX = 16384, OPS_ROWS_MAX = 256, OPS_COLS_MAX = 1024;
constexpr int OPS_SMEM_MAX = SMEM_MAX - 2048;  // tt_ops_mma's static shared memory (scans) aside

// The half of the cores left (cores [0, h)) or right ([h, d)) as the K = r
// GEMM of tt_ops_mma; false when it has more than two cores or passes the
// limits (tt_operators takes such specs).
// kernels/tt_linear.py op_groups is its plain version.
static bool plan_half(OpHalf& p, bool left, const void* const* cores, const int* n,
                      const int* m, const int* r, int d, int h, int elt, long op_off) {
  const int nc = left ? h : d - h;
  if (nc < 1 || nc > 2) return false;
  const int ka = left ? 0 : (nc == 2 ? d - 2 : -1);  // core of A, -1: the identity
  const int kb = left ? (nc == 2 ? 1 : -1) : d - 1;   // core of B
  p = OpHalf{};
  p.left = left;
  p.rr = r[h];
  p.nA = ka >= 0 ? n[ka] : 1;
  p.mA = ka >= 0 ? m[ka] : 1;
  p.nB = kb >= 0 ? n[kb] : 1;
  p.mB = kb >= 0 ? m[kb] : 1;
  p.K = left ? r[1] : (nc == 2 ? r[d - 1] : r[h]);
  p.K16 = p.K <= 16 ? 16 : 32;
  p.a_ld = p.K;
  p.b_ld = p.nB * p.mB * (left ? p.rr : 1);
  p.N = p.nA * p.nB;
  p.N16 = (p.N + 15) / 16 * 16;
  p.Mt = p.mA * p.mB;
  long s;
  if (left) {  // the most j1 a group (each reads B once), then the most j2
    p.mac = p.mc = 0;
    for (int mac = p.mA; mac >= 1 && !p.mac; --mac)
      if (p.mA % mac == 0 && p.nA * mac <= OPS_ROWS_MAX &&
          (long)p.rr * mac * p.N16 <= OPS_S_TARGET)
        p.mac = mac;
    if (!p.mac) p.mac = 1;
    for (int mc = p.mB; mc >= 1 && !p.mc; --mc)
      if (p.mB % mc == 0 && (long)p.rr * p.mac * mc * p.N16 <= OPS_S_TARGET &&
          p.nB * mc * p.rr <= OPS_COLS_MAX)
        p.mc = mc;
    if (!p.mc) p.mc = 1;
    p.rows = p.nA * p.mac;
    p.cols = p.nB * p.mc * p.rr;
    p.groups = (p.mA / p.mac) * (p.mB / p.mc);
    s = (long)p.rr * p.mac * p.mc * p.N16;
    p.rc = 1;
  } else {
    p.mac = p.mA;
    p.mc = p.mB;
    p.rc = 0;
    for (int rc = p.rr; rc >= 1 && !p.rc; --rc)
      if (p.rr % rc == 0 && rc * p.nA * p.mA <= OPS_ROWS_MAX &&
          (long)rc * p.Mt * p.N16 <= OPS_S_TARGET)
        p.rc = rc;
    if (!p.rc) p.rc = 1;
    p.rows = p.rc * p.nA * p.mA;
    p.cols = p.nB * p.mB;
    p.groups = p.rr / p.rc;
    s = (long)p.rc * p.Mt * p.N16;
  }
  if (p.rows > OPS_ROWS_MAX || p.cols > OPS_COLS_MAX || s > OPS_S_MAX) return false;
  p.rows16 = (p.rows + 15) / 16 * 16;
  p.cols16 = (p.cols + 15) / 16 * 16;
  p.A = ka >= 0 ? cores[ka] : nullptr;
  p.B = kb >= 0 ? cores[kb] : nullptr;
  p.a_estride = ka >= 0 ? (long)r[ka] * n[ka] * m[ka] * r[ka + 1] : 0;
  p.b_estride = kb >= 0 ? (long)r[kb] * n[kb] * m[kb] * r[kb + 1] : 0;
  p.avec = p.A && p.K % 8 == 0 && (uintptr_t)p.A % 16 == 0 && (p.a_estride * elt) % 16 == 0;
  p.bvec = p.B && p.b_ld % 8 == 0 && (left ? p.rr : p.mB) % 8 == 0 &&
           (uintptr_t)p.B % 16 == 0 && (p.b_estride * elt) % 16 == 0;
  p.op_off = op_off;
  return true;
}

static int ops_smem(const OpHalf& p) {
  return (int)(2 * ((long)p.rows16 * (p.K16 + 8) + (long)p.K16 * (p.cols16 + 8)) +
               4 * (p.rows16 + p.cols16));
}

template <typename TC>
static int launch_ops_mma(const OpsArgs& oa, int smem, cudaStream_t st) {
  static unsigned long long raised = 0;
  const cudaError_t e = raise_smem(tt_ops_mma<TC>, OPS_SMEM_MAX, raised);
  if (e != cudaSuccess) return (int)e;
  tt_ops_mma<TC><<<dim3((unsigned)(oa.half[0].groups + oa.half[1].groups),
                        (unsigned)(oa.slots + 1)), OPS_NT, smem, st>>>(oa);
  return (int)cudaGetLastError();
}

// The wgmma contraction's shared-memory layout (kernels/tt_linear.py
// grouped_plan mirrors it): the two warpgroups' rows' X, the ring, the
// epilogue tiles (over each warpgroup's own X when they fit there), barriers.
static int wgmma_layout(WgArgs& a, int ns, int bms, int iw) {
  a.x_bytes = a.kp * ns * 128;
  a.p_bytes = a.kp * 8192;
  a.stage_bytes = a.p_bytes + ((ns + 63) / 64) * bms * 128;
  a.ring_off = 2 * iw * a.x_bytes;
  const int epi = 64 * (bms + 4) * 4;
  int end = a.ring_off + a.stages * a.stage_bytes;
  if (iw * a.x_bytes >= epi) {
    a.epi_off = 0;
    a.epi_stride = iw * a.x_bytes;
  } else {
    a.epi_off = end;
    a.epi_stride = epi;
    end += 2 * epi;
  }
  a.bar_off = end;
  return 1024 + end + 2 * a.stages * 8;
}

template <int NS, int BMS, int IW>
static int launch_wgmma(const CUtensorMap& tmp, const CUtensorMap& tmq, const WgArgs& a,
                        dim3 grid, int smem, cudaStream_t st) {
  static unsigned long long raised = 0;
  const cudaError_t e = raise_smem(tt_wgmma<NS, BMS, IW>, SMEM_MAX, raised);
  if (e != cudaSuccess) return (int)e;
  tt_wgmma<NS, BMS, IW><<<grid, WG_THREADS, smem, st>>>(tmp, tmq, a);
  return (int)cudaGetLastError();
}

template <int NS, int BMS>
static int launch_wgmma_iw(int iw, const CUtensorMap& tmp, const CUtensorMap& tmq,
                           const WgArgs& a, dim3 grid, int smem, cudaStream_t st) {
  return iw == 4 ? launch_wgmma<NS, BMS, 4>(tmp, tmq, a, grid, smem, st)
                 : launch_wgmma<NS, BMS, 2>(tmp, tmq, a, grid, smem, st);
}

}  // namespace

// The staged path: d launches, f32 intermediates in
// scratch0/scratch1 (each B * max_intermediate elements).
extern "C" int rt_tt_linear(const void* x, int x_dtype, const void* const* cores,
                            const int* core_dtypes, void* scratch0, void* scratch1, void* out,
                            const void* scale, const void* bias, const void* residual, int B,
                            int d, const int* in_modes, const int* out_modes, const int* ranks,
                            int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
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
    const int dst_dtype = last ? x_dtype : RT_F32;
    const float* s_sc = last ? sc : nullptr;
    const float* s_bi = last ? bi : nullptr;
    const void* s_res = last ? residual : nullptr;
    if (src_dtype == RT_BF16) {
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

// The fused bf16 path: the operator pass, then the two-half contraction,
// for one TT linear (offsets == nullptr) or for E experts' stacked cores over
// rows sorted by expert (grouped).  ``h`` splits the cores (1 <= h <= d),
// ``left_first`` picks the half that meets x first (kernels/tt_linear.py
// contraction_plan); ``ops`` holds r_h * (ML * NL16 + MR * NR16) bf16
// elements an expert.  ``cores_f32``: the cores are f32 (what compression
// writes), each element rounded to bf16 as it loads.
// The decode-width contraction (tt_fused, mma.sync), either half first.
static int launch_contraction(bool wide, int left_first, const void* x, const OpArgs& o,
                              void* out, const void* scale, const void* bias,
                              const void* residual, const Fused& f, int n_tiles, int smem,
                              cudaStream_t st) {
  const __nv_bfloat16* P = left_first ? o.opl : o.opr;
  const __nv_bfloat16* Q = left_first ? o.opr : o.opl;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  auto go = [&](auto grouped) {
    constexpr bool G = decltype(grouped)::value;
    if (wide)
      return left_first ? launch_fused_np<128, true, G>(x, P, Q, out, sc, bi, residual, f,
                                                        n_tiles, smem, st)
                        : launch_fused_np<128, false, G>(x, P, Q, out, sc, bi, residual, f,
                                                         n_tiles, smem, st);
    return left_first
               ? launch_fused_np<64, true, G>(x, P, Q, out, sc, bi, residual, f, n_tiles, smem, st)
               : launch_fused_np<64, false, G>(x, P, Q, out, sc, bi, residual, f, n_tiles, smem,
                                               st);
  };
  return f.tiles ? go(std::true_type{}) : go(std::false_type{});
}

// The prefill-width contraction (tt_wgmma) over the schedule's tiles of
// 2 iw rows, left half first whatever the plan's order.
static int grouped_wgmma(const OpArgs& o, const Fused& f, const void* x, void* out, int act,
                         int E, int n_tiles, int iw, int bms, int stages, cudaStream_t st) {
  const int ns = o.NR16;
  if ((ns != 32 && ns != 64) || o.NR % 8 != 0 || (bms != 32 && bms != 64) ||
      (iw != 2 && iw != 4) || stages < 2 || (uintptr_t)x % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  WgArgs a{};
  a.x = (const __nv_bfloat16*)x;
  a.y = (__nv_bfloat16*)out;
  a.tiles = f.tiles;
  a.ML = o.ML;
  a.NL = o.NL;
  a.NR = o.NR;
  a.MR = o.MR;
  a.N = o.NL * o.NR;
  a.M = o.ML * o.MR;
  a.r = o.r[o.h];
  a.act = act;
  a.kp = (o.NL16 + 63) / 64;
  a.kf = o.NL16 / 16;
  a.xpad = o.NR < ns || o.NL < o.NL16;
  a.stages = stages;
  const int smem = wgmma_layout(a, ns, bms, iw);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap tmp, tmq;  // OPL [E][r][ML][NL16] and OPR [E][r][MR][NR16], op_stride apart
  const cuuint64_t dp[4] = {(cuuint64_t)o.NL16, (cuuint64_t)o.ML, (cuuint64_t)a.r, (cuuint64_t)E};
  const cuuint64_t sp[3] = {(cuuint64_t)o.NL16 * 2, (cuuint64_t)o.ML * o.NL16 * 2,
                            (cuuint64_t)o.op_stride * 2};
  const cuuint64_t dq[4] = {(cuuint64_t)o.NR16, (cuuint64_t)o.MR, (cuuint64_t)a.r, (cuuint64_t)E};
  const cuuint64_t sq[3] = {(cuuint64_t)o.NR16 * 2, (cuuint64_t)o.MR * o.NR16 * 2,
                            (cuuint64_t)o.op_stride * 2};
  if (!tensor_map_nd(&tmp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, o.opl, dp, sp, 64, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_nd(&tmq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, o.opr, dq, sq, 64, bms,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tiles, (unsigned)((o.ML + 63) / 64), (unsigned)((o.MR + bms - 1) / bms));
  if (ns == 32)
    return bms == 32 ? launch_wgmma_iw<32, 32>(iw, tmp, tmq, a, grid, smem, st)
                     : launch_wgmma_iw<32, 64>(iw, tmp, tmq, a, grid, smem, st);
  return bms == 32 ? launch_wgmma_iw<64, 32>(iw, tmp, tmq, a, grid, smem, st)
                   : launch_wgmma_iw<64, 64>(iw, tmp, tmq, a, grid, smem, st);
}

static int tt_fused_call(const void* x, const void* const* cores, const int* offsets, int E,
                         void* tiles, void* ops, void* out, const void* scale, const void* bias,
                         const void* residual, int B, int d, const int* in_modes,
                         const int* out_modes, const int* ranks, int h, int left_first, int act,
                         int cores_f32, int wg_iw, int wg_bms, int wg_stages,
                         cudaStream_t st) {
  if (d < 1 || d > MAXD || h < 1 || h > d) return (int)cudaErrorInvalidValue;
  OpArgs o{};
  const int elt = cores_f32 ? 4 : 2;
  int rmax = 1;
  for (int k = 0; k < d; ++k) {
    o.core[k] = cores[k];
    o.n[k] = in_modes[k];
    o.m[k] = out_modes[k];
    o.estride[k] = offsets ? (long)ranks[k] * in_modes[k] * out_modes[k] * ranks[k + 1] : 0;
    o.vec[k] = ranks[k + 1] % 8 == 0 && (uintptr_t)cores[k] % 16 == 0 &&
               (o.estride[k] * elt) % 16 == 0;
  }
  for (int k = 0; k <= d; ++k) {
    o.r[k] = ranks[k];
    rmax = ranks[k] > rmax ? ranks[k] : rmax;
  }
  if (rmax > 32) return (int)cudaErrorInvalidValue;
  o.d = d;
  o.h = h;
  o.NL = o.NR = o.ML = o.MR = 1;
  for (int k = 0; k < d; ++k) {
    (k < h ? o.NL : o.NR) *= in_modes[k];
    (k < h ? o.ML : o.MR) *= out_modes[k];
  }
  o.NL16 = (o.NL + 15) / 16 * 16;
  o.NR16 = (o.NR + 15) / 16 * 16;
  const int rho = ranks[h];
  o.opl = (__nv_bfloat16*)ops;
  o.opr = o.opl + (long)rho * o.ML * o.NL16;
  o.op_stride = offsets ? (long)rho * (o.ML * o.NL16 + o.MR * o.NR16) : 0;

  Fused f{};
  f.B = B;
  f.N = o.NL * o.NR;
  f.M = o.ML * o.MR;
  f.r = rho;
  f.left = left_first ? 1 : 0;
  f.act = act;
  f.Mf = left_first ? o.ML : o.MR;
  f.Nf = left_first ? o.NL : o.NR;
  f.Ns = left_first ? o.NR : o.NL;
  f.Ms = left_first ? o.MR : o.ML;
  f.Nf16 = left_first ? o.NL16 : o.NR16;
  f.Ns16 = left_first ? o.NR16 : o.NL16;
  f.xvec = ((uintptr_t)x % 16 == 0) && (left_first ? f.Ns : f.Nf) % 8 == 0;
  f.rvec = (uintptr_t)residual % 16 == 0;
  f.tb_max = 8;
  if (offsets) {  // grouped: at most the mean rows an expert (a power of 2), so
    f.tb_max = 1;  // that sparse routings do not leave most of a CTA idle
    while (f.tb_max < 8 && 2 * f.tb_max * E <= B) f.tb_max *= 2;
    f.tiles = (const int4*)tiles;
    f.op_stride = o.op_stride;
  }
  const bool wgmma = offsets && wg_iw > 0;  // grouped, prefill width: the wgmma contraction
  const bool wide = f.Ms > 64 && B >= 128;  // 128 output columns a CTA at prefill widths
  int smem = 0;
  if (wgmma) {
    f.TB = 2 * wg_iw;
  } else {
    smem = wide ? pick_shape<128>(f) : pick_shape<64>(f);
    if (smem < 0) return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (B + f.TB - 1) / f.TB + (offsets ? E : 0);  // token tiles or schedule slots

  // grouped, every half of one or two cores: the operator pass on the tensor
  // cores over the experts with rows (tt_ops_mma)
  OpsArgs oa{};
  if (offsets && plan_half(oa.half[0], true, cores, in_modes, out_modes, ranks, d, h, elt, 0) &&
      plan_half(oa.half[1], false, cores, in_modes, out_modes, ranks, d, h, elt,
                (long)rho * o.ML * o.NL16)) {
    oa.offsets = offsets;
    oa.E = E;
    oa.R = B;
    oa.TB = f.TB;
    oa.n_tiles = n_tiles;
    oa.slots = E < B ? E : B;
    oa.tiles = (int4*)tiles;
    oa.ops = o.opl;
    oa.op_stride = o.op_stride;
    const int s0 = ops_smem(oa.half[0]), s1 = ops_smem(oa.half[1]);
    const int osm = s0 > s1 ? s0 : s1;
    if (osm > OPS_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const int e = cores_f32 ? launch_ops_mma<float>(oa, osm, st)
                            : launch_ops_mma<__nv_bfloat16>(oa, osm, st);
    if (e != 0) return e;
    return wgmma ? grouped_wgmma(o, f, x, out, act, E, n_tiles, wg_iw, wg_bms, wg_stages, st)
                 : launch_contraction(wide, left_first, x, o, out, scale, bias, residual, f,
                                      n_tiles, smem, st);
  }
  if (wgmma) return (int)cudaErrorInvalidValue;  // the wgmma route takes tt_ops_mma's specs

  const long nq = (ranks[h] + 3) / 4;  // threads a (out, in) pair: a quad of rho each
  const long work = (long)o.ML * o.NL16 * (h <= 2 ? nq : 1) +
                    (long)o.MR * o.NR16 * (d - h <= 2 ? nq : 1);
  dim3 op_grid((unsigned)((work + 255) / 256), offsets ? (unsigned)(E + 1) : 1u);
  if (offsets) {
    o.offsets = offsets;
    o.E = E;
    o.R = B;
    o.TB = f.TB;
    o.n_tiles = n_tiles;
    o.tiles = (int4*)tiles;
  }
  if (cores_f32) {
    if (rmax <= 16)
      tt_operators<16, float><<<op_grid, 256, 0, st>>>(o);
    else
      tt_operators<32, float><<<op_grid, 256, 0, st>>>(o);
  } else if (rmax <= 16) {
    tt_operators<16, __nv_bfloat16><<<op_grid, 256, 0, st>>>(o);
  } else {
    tt_operators<32, __nv_bfloat16><<<op_grid, 256, 0, st>>>(o);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  return launch_contraction(wide, left_first, x, o, out, scale, bias, residual, f, n_tiles, smem,
                            st);
}

extern "C" int rt_tt_linear_fused(const void* x, const void* const* cores, void* ops, void* out,
                                  const void* scale, const void* bias, const void* residual,
                                  int B, int d, const int* in_modes, const int* out_modes,
                                  const int* ranks, int h, int left_first, int act,
                                  int cores_f32, void* stream) {
  return tt_fused_call(x, cores, nullptr, 0, nullptr, ops, out, scale, bias, residual, B, d,
                       in_modes, out_modes, ranks, h, left_first, act, cores_f32, 0, 0, 0,
                       (cudaStream_t)stream);
}

// The grouped entry (replaces tt_linear_pallas batched by jax.vmap over the
// experts, src/repro/models/moe.py:91): x holds R rows sorted by expert,
// expert e's rows [offsets[e], offsets[e + 1]) (offsets on the device, never
// read by the host); cores[k] holds the E experts' core k stacked; ``ops``
// E experts' operators, ``tiles`` R + E int4 slots for the schedule.  Two
// launches: the operator pass over every expert with rows (plus one block
// that writes the schedule), then one contraction over the schedule's tiles.
extern "C" int rt_tt_linear_fused_grouped(const void* x, const void* const* cores,
                                          const void* offsets, int E, void* tiles, void* ops,
                                          void* out, int R, int d, const int* in_modes,
                                          const int* out_modes, const int* ranks, int h,
                                          int left_first, int act, int cores_f32,
                                          int wg_iw, int wg_bms, int wg_stages, void* stream) {
  if (E < 1 || !offsets) return (int)cudaErrorInvalidValue;
  return tt_fused_call(x, cores, (const int*)offsets, E, tiles, ops, out, nullptr, nullptr,
                       nullptr, R, d, in_modes, out_modes, ranks, h, left_first, act, cores_f32,
                       wg_iw, wg_bms, wg_stages, (cudaStream_t)stream);
}
