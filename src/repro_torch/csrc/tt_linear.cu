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
// The staged path (f32 x, cores of mixed dtypes, or a bf16 spec past the
// fused limits): one launch per stage, a GEMM over all tokens' rows
// (B*T_k rows x r*n_k contraction x m_k*r' columns, the core shared by every
// token) in 64 x 64 tiles on the CUDA cores, f32 intermediates in a per-call
// scratch buffer.  The inter-stage reorder of the Pallas kernel
// (kernels/tt_linear.py:63-67) is folded into each stage's store index and
// the first stage reads x through the initial (n_1, N/n_1) transpose.  No
// shipped serving config takes it but the tied TT unembed.
#include "common.cuh"

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
  return static_cast<const TC*>(o.core[k]);
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
  __nv_bfloat16* dst = (left ? o.opl : o.opr) + (long)jj * width + ii;
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
// NP: 16-wide column pairs of an X chunk (Ns16 / 16, at most 4).
template <int BNT, bool LEFT, int NP>
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

  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tok0 = blockIdx.x * f.TB, mf0 = blockIdx.y * g.tmf, ms0 = blockIdx.z * BNT;
  const int n_rb = f.TB * f.WPT;                 // row blocks of 16 (token, P rows) a CTA
  const int rb = warp % n_rb, kg = warp / n_rb;  // this warp's row block, rank group
  const int wt = rb / f.WPT, wm = (rb % f.WPT) * 16;
  const int tok = tok0 + wt;
  const bool live = tok < f.B && mf0 + wm < f.Mf;  // warp-uniform
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
      const __nv_bfloat16* xt = x + (long)min(tk, f.B - 1) * f.N;
      __nv_bfloat16* xs = Xs + t * g.x_rows * g.x_stride;
      // LEFT: rows f (Nf16) of columns s (sk16); else rows s (sk16) of columns f (Nf16)
      const int rows = LEFT ? f.Nf16 : g.sk16, cols = LEFT ? g.sk16 : f.Nf16;
      if (f.xvec) {
        const int per_row = cols / 8;
        for (int e = tid; e < rows * per_row; e += nth) {
          const int rr = e / per_row, cc = (e % per_row) * 8;
          const int fi = LEFT ? rr : cc, si = s0 + (LEFT ? cc : rr);
          const bool ok = tk < f.B && fi < f.Nf && si < f.Ns;
          const long off = LEFT ? (long)fi * f.Ns + si : (long)si * f.Nf + fi;
          cp16(xs + rr * g.x_stride + cc, ok ? xt + off : x, ok);
        }
      } else {
        for (int e = tid; e < rows * cols; e += nth) {
          const int rr = e / cols, cc = e % cols;
          const int fi = LEFT ? rr : cc, si = s0 + (LEFT ? cc : rr);
          const bool ok = tk < f.B && fi < f.Nf && si < f.Ns;
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
      if (tk < f.B && mf < f.Mf && ms < f.Ms)
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

template <int BNT, bool LEFT, int NP>
int launch_fused(const void* x, const __nv_bfloat16* P, const __nv_bfloat16* Q, void* y,
                 const float* scale, const float* bias, const void* residual, Fused f,
                 cudaStream_t st) {
  const int smem = pick_shape<BNT>(f);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  auto kern = tt_fused<BNT, LEFT, NP>;
  static unsigned long long raised = 0;  // devices whose limit is raised, a bit each
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (!(raised & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    raised |= bit;
  }
  dim3 grid((unsigned)((f.B + f.TB - 1) / f.TB), (unsigned)((f.Mf + 16 * f.WPT - 1) / (16 * f.WPT)),
            (unsigned)((f.Ms + BNT - 1) / BNT));
  kern<<<grid, 32 * f.TB * f.WPT * f.KS, smem, st>>>(
      (const __nv_bfloat16*)x, P, Q, (__nv_bfloat16*)y, scale, bias,
      (const __nv_bfloat16*)residual, f);
  return (int)cudaGetLastError();
}

template <int BNT, bool LEFT>
int launch_fused_np(const void* x, const __nv_bfloat16* P, const __nv_bfloat16* Q, void* y,
                    const float* scale, const float* bias, const void* residual, const Fused& f,
                    cudaStream_t st) {
  const int np = (f.Ns16 < SKC ? f.Ns16 : SKC) / 16;
  if (np == 1) return launch_fused<BNT, LEFT, 1>(x, P, Q, y, scale, bias, residual, f, st);
  if (np == 2) return launch_fused<BNT, LEFT, 2>(x, P, Q, y, scale, bias, residual, f, st);
  if (np == 3) return launch_fused<BNT, LEFT, 3>(x, P, Q, y, scale, bias, residual, f, st);
  return launch_fused<BNT, LEFT, 4>(x, P, Q, y, scale, bias, residual, f, st);
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

// The fused bf16 path: the operator pass, then the two-half contraction.
// ``h`` splits the cores (1 <= h <= d), ``left_first`` picks the half that
// meets x first (kernels/tt_linear.py contraction_plan); ``ops`` holds
// r_h * (ML * NL16 + MR * NR16) bf16 elements.  ``cores_f32``: the cores are
// f32 (what compression writes), each element rounded to bf16 as it loads.
extern "C" int rt_tt_linear_fused(const void* x, const void* const* cores, void* ops, void* out,
                                  const void* scale, const void* bias, const void* residual,
                                  int B, int d, const int* in_modes, const int* out_modes,
                                  const int* ranks, int h, int left_first, int act,
                                  int cores_f32, void* stream) {
  if (d < 1 || d > MAXD || h < 1 || h > d) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  OpArgs o{};
  int rmax = 1;
  for (int k = 0; k < d; ++k) {
    o.core[k] = cores[k];
    o.n[k] = in_modes[k];
    o.m[k] = out_modes[k];
    o.vec[k] = ranks[k + 1] % 8 == 0 && (uintptr_t)cores[k] % 16 == 0;
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
  const long nq = (ranks[h] + 3) / 4;  // threads a (out, in) pair: a quad of rho each
  const long work = (long)o.ML * o.NL16 * (h <= 2 ? nq : 1) +
                    (long)o.MR * o.NR16 * (d - h <= 2 ? nq : 1);
  const unsigned blocks = (unsigned)((work + 255) / 256);
  if (cores_f32) {
    if (rmax <= 16)
      tt_operators<16, float><<<blocks, 256, 0, st>>>(o);
    else
      tt_operators<32, float><<<blocks, 256, 0, st>>>(o);
  } else if (rmax <= 16) {
    tt_operators<16, __nv_bfloat16><<<blocks, 256, 0, st>>>(o);
  } else {
    tt_operators<32, __nv_bfloat16><<<blocks, 256, 0, st>>>(o);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

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
  const __nv_bfloat16* P = left_first ? o.opl : o.opr;
  const __nv_bfloat16* Q = left_first ? o.opr : o.opl;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  if (f.Ms > 64 && B >= 128)  // 128 output columns a CTA at prefill widths
    return left_first ? launch_fused_np<128, true>(x, P, Q, out, sc, bi, residual, f, st)
                      : launch_fused_np<128, false>(x, P, Q, out, sc, bi, residual, f, st);
  return left_first ? launch_fused_np<64, true>(x, P, Q, out, sc, bi, residual, f, st)
                    : launch_fused_np<64, false>(x, P, Q, out, sc, bi, residual, f, st);
}
