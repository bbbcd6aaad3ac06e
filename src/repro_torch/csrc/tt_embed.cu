// Rows of a vocab-axis TT embedding table (TensorGPT layout): the (V, D)
// table is the TT's (M, N) weight with M = V.  Id t -> big-endian digits
// (i_1..i_d) over out_modes; digit i_k selects the (r_{k-1}, n_k, r_k) block
// of core matrix C_k (rows (r, n) r-major, columns (m, r) m-major, so the
// block is strided: r_k contiguous values every m_k * r_k).  A negative id
// wraps once, then ids clamp into [0, V).
//
// Replaces: src/repro/kernels/tt_embed.py::tt_embed_pallas (a 1-D grid over
// token tiles that gathers each digit's block for the whole tile with a
// one-hot matmul on the MXU, then chains with batched dot_generals).
//
// What bounds it on the H100: the bytes of the f32 rows it writes (D * 4 per
// token: 33.5 MB at llama2-7b's 2048-token prefill chunk, 10.0 us at 3.35
// TB/s); the cores (114 KB in bf16 at llama2's spec) stay in L2.
//
// Design: a row is a product of two halves split at a rank, row = L . R,
// flattened row-major (n_1 slowest): L (P x r) chains the selected blocks of
// cores 1..rho (P = n_1 .. n_rho, r = r_rho) and depends only on the id's
// prefix digits, R (r x Q) chains cores rho+1..d (Q = n_{rho+1} .. n_d) and
// depends only on its suffix digits.  The wrapper picks rho by operations
// (kernels/tt_embed.py embed_plan): at llama2's spec rho = 2, L 64 x 16 and R
// 16 x 64, 0.20 MFLOP a token against 0.43 for the left-to-right chain.
// One launch, a CTA per token (or, with few tokens, per slab of a token's L
// rows, so that 8 tokens still spread over the card), nothing staged in
// device memory:
// 1. the token's d selected blocks into shared memory as f32, 16-byte loads
//    of their contiguous r_k runs;
// 2. both halves' chains, stage by stage side by side: a stage is a small
//    GEMM in shared memory;
// 3. the product of the token's (slab of) L and R.
// Each GEMM gives a thread 4 rows x 4 consecutive columns, so a k step of 4
// is 8 16-byte shared loads for 64 FMAs, and the product's rows are stored
// 16 bytes at a time in memory order.
// Many CTAs an SM (26 KB of shared memory each at llama2's spec) overlap one
// token's block loads and chains with another's stores.  A CTA builds its
// token's halves even when another token shares them (320 distinct L and 100
// distinct R at llama2's spec): that costs 64 K FMAs a token, less than the
// row's own product, and saves a launch, a scratch buffer and a round trip
// through device memory.  Everything is f32, each output one ordered f32 sum.
#include "common.cuh"

namespace {

constexpr int MAXD = 8;
constexpr int NTH = 128;

struct EmbedArgs {
  const void* cores[MAXD];
  const void* ids;
  long long stride[MAXD];  // id / stride[k] % out_modes[k] is digit k
  int in_modes[MAXD], out_modes[MAXD], ranks[MAXD + 1];
  int sel_off[MAXD];       // shared-memory float offsets: each selected block,
  int buf_off[2][2];       // each half's ping-pong buffers,
  int one_off;             // the 1 x 1 identity of d = 1's empty right half
  int d, rho, P, Q, r, vocab, ids64, slab_rows;
};

__device__ __forceinline__ long long token_id(const void* ids, int ids64, int t, int vocab) {
  long long id = ids64 ? static_cast<const long long*>(ids)[t] : static_cast<const int*>(ids)[t];
  if (id < 0) id += vocab;
  return id < 0 ? 0 : (id >= vocab ? vocab - 1 : id);
}

// sel[(u, j), s] = C[(u, j), (digit, s)]: `rows` = r_{k-1} n_k rows of r1
// contiguous values, m * r1 apart; 16-byte loads where the runs allow
template <typename TC>
__device__ __forceinline__ void load_block(float* dst, const TC* C, int rows, int m, int r1,
                                           int digit) {
  constexpr int VW = 16 / sizeof(TC);
  const TC* src = C + digit * r1;
  if (r1 % VW == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0) {
    const int cpr = r1 / VW;
#pragma unroll 4
    for (int c = threadIdx.x; c < rows * cpr; c += NTH) {
      const int row = c / cpr, s0 = (c - row * cpr) * VW;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + (long)row * m * r1 + s0));
      const TC* e = reinterpret_cast<const TC*>(&v);
#pragma unroll
      for (int i = 0; i < VW; ++i) dst[row * r1 + s0 + i] = to_f(e[i]);
    }
  } else {
    for (int e = threadIdx.x; e < rows * r1; e += NTH) {
      const int row = e / r1, s = e - row * r1;
      dst[e] = to_f(src[(long)row * m * r1 + s]);
    }
  }
}

// C (M x N) = A (M x K) . B (K x N), row-major, one ordered f32 sum over k
// an element.  With vec (K % 4 == 0, N % 4 == 0, 16-byte aligned rows) an
// item is 4 rows x 4 consecutive columns: a k step of 4 is 8 16-byte loads
// for 64 FMAs, and its rows are stored 16 bytes at a time; else an item is
// one element.
struct Gemm {
  const float* A;
  const float* B;
  float* C;
  int M, K, N, vec;
  __device__ int items() const { return vec ? (M + 3) / 4 * (N / 4) : M * N; }
  __device__ void item(int i) const {
    if (vec) {
      const int c = i % (N / 4), row0 = i / (N / 4) * 4;
      float acc[4][4] = {};
      for (int k = 0; k < K; k += 4) {
        float4 bv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          bv[kk] = *reinterpret_cast<const float4*>(&B[(k + kk) * N + 4 * c]);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          if (row0 + ii >= M) break;
          const float4 av = *reinterpret_cast<const float4*>(&A[(row0 + ii) * K + k]);
          const float l[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[ii][0] = fmaf(l[kk], bv[kk].x, acc[ii][0]);
            acc[ii][1] = fmaf(l[kk], bv[kk].y, acc[ii][1]);
            acc[ii][2] = fmaf(l[kk], bv[kk].z, acc[ii][2]);
            acc[ii][3] = fmaf(l[kk], bv[kk].w, acc[ii][3]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        if (row0 + ii < M)
          *reinterpret_cast<float4*>(&C[(row0 + ii) * N + 4 * c]) =
              make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
    } else {
      const int row = i / N, col = i - row * N;
      float acc = 0.0f;
      for (int k = 0; k < K; ++k) acc = fmaf(A[row * K + k], B[k * N + col], acc);
      C[i] = acc;
    }
  }
};

__device__ __forceinline__ Gemm gemm(const float* A, const float* B, float* C, int M, int K,
                                     int N) {
  return Gemm{A, B, C, M, K, N, K % 4 == 0 && N % 4 == 0};
}

template <typename TC>
__global__ void __launch_bounds__(NTH) tt_embed_kernel(float* __restrict__ out, EmbedArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const int a0 = blockIdx.y * a.slab_rows, rows = min(a0 + a.slab_rows, a.P) - a0;
  if (rows <= 0) return;
  const long long id = token_id(a.ids, a.ids64, t, a.vocab);
  for (int k = 0; k < a.d; ++k)
    load_block(smem + a.sel_off[k], static_cast<const TC*>(a.cores[k]),
               a.ranks[k] * a.in_modes[k], a.out_modes[k], a.ranks[k + 1],
               (int)(id / a.stride[k] % a.out_modes[k]));
  if (a.rho == a.d && threadIdx.x == 0) smem[a.one_off] = 1.0f;
  __syncthreads();

  // the halves, stage by stage side by side: a stage of a chain is the GEMM
  // p_k (X, r_k) . sel_k (r_k, n_k r_{k+1}) -> (X n_k, r_{k+1}); L starts as
  // core 0's block (n_1, r_1), R as core rho's (r_rho n_{rho+1}, r_{rho+1})
  const float* L = smem + a.sel_off[0];
  const float* R = a.rho < a.d ? smem + a.sel_off[a.rho] : smem + a.one_off;
  int xl = a.in_modes[0], xr = a.rho < a.d ? a.ranks[a.rho] * a.in_modes[a.rho] : 1;
  for (int i = 1; i < max(a.rho, a.d - a.rho); ++i) {
    const int kl = i, kr = a.rho + i;
    Gemm gl{}, gr{};
    if (kl < a.rho)
      gl = gemm(L, smem + a.sel_off[kl], smem + a.buf_off[0][i & 1], xl, a.ranks[kl],
                a.in_modes[kl] * a.ranks[kl + 1]);
    if (kr < a.d)
      gr = gemm(R, smem + a.sel_off[kr], smem + a.buf_off[1][i & 1], xr, a.ranks[kr],
                a.in_modes[kr] * a.ranks[kr + 1]);
    const int nl = kl < a.rho ? gl.items() : 0, nr = kr < a.d ? gr.items() : 0;
    for (int it = threadIdx.x; it < nl + nr; it += NTH) {
      if (it < nl) gl.item(it);
      else gr.item(it - nl);
    }
    __syncthreads();
    if (kl < a.rho) {
      L = gl.C;
      xl *= a.in_modes[kl];
    }
    if (kr < a.d) {
      R = gr.C;
      xr *= a.in_modes[kr];
    }
  }

  // rows [a0, a0 + rows) of L . R, written to out[t, a * Q + b]
  const Gemm gp = gemm(L + a0 * a.r, R, out + ((long)t * a.P + a0) * a.Q, rows, a.r, a.Q);
  for (int it = threadIdx.x; it < gp.items(); it += NTH) gp.item(it);
}

template <typename TC>
cudaError_t launch(dim3 grid, size_t smem, float* out, const EmbedArgs& a, cudaStream_t st) {
  static int set_bytes = -1;  // the attributes are set once, and again for a larger size
  if ((int)smem > set_bytes) {
    // all of the SM's unified memory as shared memory: as many CTAs an SM as fit
    cudaError_t e = cudaFuncSetAttribute(tt_embed_kernel<TC>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(tt_embed_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return e;
    set_bytes = (int)smem;
  }
  tt_embed_kernel<TC><<<grid, NTH, smem, st>>>(out, a);
  return cudaGetLastError();
}

}  // namespace

// ids (T,) int32 or int64 (ids64); cores: d device pointers to C_k
// (r_{k-1} n_k, m_k r_k) of core_dtype (f32 | bf16); out (T, prod(in_modes))
// f32.  layout: rho, then the shared-memory float offsets (sel_off[d],
// buf_off[2][2], one_off) and the total; slabs: CTAs a token's rows are
// split over.
extern "C" int rt_tt_embed(const void* ids, int ids64, const void* const* cores, int core_dtype,
                           void* out, int T, int d, const int* in_modes, const int* out_modes,
                           const int* ranks, const int* layout, int slabs, void* stream) {
  if (T == 0) return 0;
  const int rho = layout[0];
  if (d < 1 || d > MAXD || ranks[0] != 1 || ranks[d] != 1 || rho < 1 || rho > d || slabs < 1)
    return (int)cudaErrorInvalidValue;
  EmbedArgs a;
  a.d = d;
  a.rho = rho;
  a.P = a.Q = a.vocab = 1;
  for (int k = d - 1; k >= 0; --k) {
    a.cores[k] = cores[k];
    a.in_modes[k] = in_modes[k];
    a.out_modes[k] = out_modes[k];
    a.sel_off[k] = layout[1 + k];
    a.stride[k] = a.vocab;
    a.vocab *= out_modes[k];
    (k < rho ? a.P : a.Q) *= in_modes[k];
  }
  for (int k = 0; k <= d; ++k) a.ranks[k] = ranks[k];
  for (int i = 0; i < 4; ++i) a.buf_off[i / 2][i % 2] = layout[1 + d + i];
  a.one_off = layout[5 + d];
  const size_t smem = sizeof(float) * (size_t)layout[6 + d];
  a.r = ranks[rho];
  a.ids = ids;
  a.ids64 = ids64;
  a.slab_rows = (a.P + slabs - 1) / slabs;
  a.slab_rows = (a.slab_rows + 3) / 4 * 4;  // whole 4-row items
  const dim3 grid(T, (a.P + a.slab_rows - 1) / a.slab_rows);
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  cudaError_t e;
  if (core_dtype == RT_BF16)
    e = launch<__nv_bfloat16>(grid, smem, o, a, st);
  else if (core_dtype == RT_F32)
    e = launch<float>(grid, smem, o, a, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}
