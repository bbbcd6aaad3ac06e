// Rows of a vocab-axis TT embedding table (TensorGPT layout): the (V, D)
// table is the TT's (M, N) weight with M = V.  Id t -> big-endian digits
// (i_1..i_d) over out_modes; digit i_k selects the (r_{k-1}, n_k, r_k) block
// of core matrix C_k (rows (r, n) r-major, columns (m, r) m-major, so the
// block is strided: r_k contiguous values every m_k * r_k); the blocks are
// chained left to right,
//   p_1 = sel_1 (n_1, r_1),  p_k[(x, j), s] = sum_r p_{k-1}[x, r] sel_k[r, j, s],
// and p_d (D, 1) is the row, n_1 the slowest index.  A negative id wraps once,
// then ids clamp into [0, V).
//
// Replaces: src/repro/kernels/tt_embed.py::tt_embed_pallas (a 1-D grid over
// token tiles that gathers each digit's block for the whole tile with a
// one-hot matmul on the MXU, then chains with batched dot_generals).
//
// What bounds it on the H100: the bytes of the f32 rows it writes (D * 4 per
// token: 33.5 MB at llama2-7b's 2048-token prefill chunk) against ~0.43 MFLOP
// a token in f32; the cores (114 KB in bf16 at llama2's spec) stay in L2.
//
// Design: a direct indexed load replaces the one-hot matmul.  One CTA per
// token decodes its id, loads only the selected block of each core into
// shared memory (converted to f32), and runs the chain in shared memory with
// ping-pong buffers sized for the even and odd stages (llama2: 512 x 16 and
// 64 x 16 f32); the last stage writes the row straight to device memory, its
// consecutive threads on consecutive columns.  Each output element of a stage
// is one f32 dot product over r_{k-1}, summed in order.
#include "common.cuh"

namespace {

constexpr int MAXD = 8;
constexpr int NTH = 256;

struct EmbedArgs {
  const void* cores[MAXD];
  int in_modes[MAXD], out_modes[MAXD], ranks[MAXD + 1];
  int d, n_in, vocab, sel, buf0, buf1;
};

template <typename TC>
__global__ void __launch_bounds__(NTH)
tt_embed_kernel(const int* __restrict__ ids, float* __restrict__ out, EmbedArgs a) {
  extern __shared__ float smem[];
  float* sel = smem;
  float* buf0 = smem + a.sel;
  float* buf1 = buf0 + a.buf0;
  const long t = blockIdx.x;
  int id = ids[t];
  if (id < 0) id += a.vocab;
  id = min(max(id, 0), a.vocab - 1);
  int digit[MAXD];
  for (int k = a.d - 1; k >= 0; --k) {  // little end first: digit k = (id / stride_k) % m_k
    digit[k] = id % a.out_modes[k];
    id /= a.out_modes[k];
  }
  const float* p = nullptr;  // previous stage, (X, r0) row-major
  int X = 1;
  for (int k = 0; k < a.d; ++k) {
    const int r0 = a.ranks[k], n = a.in_modes[k], m = a.out_modes[k], r1 = a.ranks[k + 1];
    const TC* C = static_cast<const TC*>(a.cores[k]);
    const int nsel = r0 * n * r1;
    for (int e = threadIdx.x; e < nsel; e += NTH) {  // sel[(r, j), s] = C[(r, j), (digit, s)]
      const int row = e / r1, s = e - row * r1;
      sel[e] = to_f(C[(long)row * m * r1 + digit[k] * r1 + s]);
    }
    __syncthreads();
    const bool last = k == a.d - 1;
    float* q = (k & 1) ? buf1 : buf0;
    const int nout = X * n * r1;
    for (int e = threadIdx.x; e < nout; e += NTH) {
      float acc;
      if (k == 0) {
        acc = sel[e];  // r0 == 1 on the first core
      } else {
        const int s = e % r1, xj = e / r1, j = xj % n, x = xj / n;
        const float* pr = p + x * r0;
        const float* sr = sel + j * r1 + s;
        acc = 0.0f;
        for (int r = 0; r < r0; ++r) acc = fmaf(pr[r], sr[r * n * r1], acc);
      }
      if (last) out[t * a.n_in + e] = acc;
      else q[e] = acc;
    }
    __syncthreads();
    p = q;
    X *= n;
  }
}

}  // namespace

// ids (T,) int32; cores: d device pointers to C_k (r_{k-1} n_k, m_k r_k) of
// core_dtype (f32 | bf16); out (T, prod(in_modes)) f32.  sel/buf0/buf1: floats
// of shared memory for the largest selected block and the even/odd stages.
extern "C" int rt_tt_embed(const void* ids, const void* const* cores, int core_dtype, void* out,
                           int T, int d, const int* in_modes, const int* out_modes,
                           const int* ranks, int sel, int buf0, int buf1, void* stream) {
  if (T == 0) return 0;
  if (d < 1 || d > MAXD || ranks[0] != 1) return (int)cudaErrorInvalidValue;
  EmbedArgs a;
  a.d = d;
  a.n_in = 1;
  a.vocab = 1;
  for (int k = 0; k < d; ++k) {
    a.cores[k] = cores[k];
    a.in_modes[k] = in_modes[k];
    a.out_modes[k] = out_modes[k];
    a.n_in *= in_modes[k];
    a.vocab *= out_modes[k];
  }
  for (int k = 0; k <= d; ++k) a.ranks[k] = ranks[k];
  a.sel = sel;
  a.buf0 = buf0;
  a.buf1 = buf1;
  const size_t smem = sizeof(float) * (size_t)(sel + buf0 + buf1);
  cudaStream_t st = (cudaStream_t)stream;
  const int* id = (const int*)ids;
  float* o = (float*)out;
  if (core_dtype == RT_BF16) {
    auto kern = tt_embed_kernel<__nv_bfloat16>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<T, NTH, smem, st>>>(id, o, a);
  } else if (core_dtype == RT_F32) {
    auto kern = tt_embed_kernel<float>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<T, NTH, smem, st>>>(id, o, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
