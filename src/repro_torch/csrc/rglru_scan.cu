// RG-LRU recurrence of griffin / recurrentgemma, two entries on one kernel body:
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) gx_t,   a_t = exp(log_a_t)
//
// Replaces: src/repro/kernels/scan_rglru.py::rglru_scan_pallas, both bodies (:53-84):
// _prefill_kernel (grid (B, W/Wt): token tiles of 16 with a Hillis-Steele scan inside each
// tile and a serial f32 carry between tiles) and _decode_kernel (grid (W/Wt,): one masked
// step for every slot).
//
// Entries (the template is on how an element is loaded and stored):
// * rt_rglru_scan, the TPU kernel's contract (ScanIO): log_a, gx (B, S, W) f32 in; h (B, S, W)
//   f32 or bf16 out; h_last (B, W) f32.
// * rt_rglru_gated, griffin's recurrent block around the scan (GatedIO): from the gate
//   linears' outputs ga, gxp, the conv output u and the in_g linear's output g, all of one
//   dtype T, it forms r = sigmoid(ga), i = sigmoid(gxp), log_a = -8 softplus(lambda) r and
//   gx = i u in registers, scans, and writes y = T(T(h) T(gelu_tanh(g))) (B, S, W) and h_last
//   (B, W) f32, which may be h0's own storage: every CTA reads its h0 before it raises its
//   flag (below), and the CTA of the last panel writes h_last after it has seen every flag.
//
// What bounds it on the H100: the bytes.  At griffin's prefill chunk (B 8, S 256, W 2560) the
// contract entry reads 8 B an element (log_a, gx f32) and writes 2 (h bf16); the gated entry
// reads 8 (ga, gxp, u, g bf16) and writes 2 (y bf16), against 30-100 operations an element.
//
// Design, S > 1: a chunked scan over S, one CTA a (slot, tile of CW = 32 channels, panel of
// 64 steps).  A lane takes a channel, so every row of a tile is one coalesced segment; the 4
// warps take the panel's 4 sub-chunks of 16 steps.  The panel's operands and positions are
// staged into shared memory by cp.async, so nothing waits on a load inside the step chain.
// Each thread forms its sub-chunk's prefix pairs h_t = A_t h_in + B_t in registers, (a, b) o
// (A, B) = (a A, a B + b), and writes the end pair to shared memory, and for every panel but
// the last to a workspace (`Carry`).  After a barrier every thread walks, from h0, the end
// pairs of the earlier panels' sub-chunks (once their flags are up) and then those of its own
// panel before its sub-chunk, to get h_in; then it writes h_t = A_t h_in + B_t.  The walk and
// the fix-up advance the state by the same expression, rounded after the multiply and after
// the add (no fused multiply-add), in the same order in every CTA, so a padding step (pos -1),
// the identity pair (1, 0), repeats the last real h bitwise, an idle row returns h0 bitwise,
// h_last is the value written as the last h, and no result depends on how CTAs were scheduled.
// Real steps differ from the plain version's serial order by that reassociation only.  S that
// is not a multiple of 16 or 64 is masked (the steps past S are identity pairs and are not
// stored); W that is not a multiple of the tile is masked.  Rows that are not 16-byte aligned
// (W not a multiple of 16 bytes of elements) are staged element by element instead.
// Why a CTA a panel: griffin's chunk is 2560 such CTAs of 128 threads and ~17 KB of shared
// memory, so as CTAs finish others start, and one CTA's copies overlap another's arithmetic.
// One CTA a (slot, tile) walking its four panels with the next one's copies in flight (640
// CTAs) was no faster: the CTAs of an SM computed their first and last panels in step, with
// the memory idle.  tools/port_probe.py rglru-variants times other CTA shapes.
// S == 1 (decode): one launch for all slots, a CTA a tile of 32 channels and every slot of
// it; a thread loads its operands straight from memory and takes one step.  An inactive row
// (pos -1) keeps h0 bitwise.
#include "common.cuh"

namespace {

constexpr int CW = 32;             // channels a CTA, one a thread of each sub-chunk
constexpr int SUB = 16;            // steps a thread: one sub-chunk
constexpr int NSUB = 4;            // sub-chunks a panel
constexpr int PANEL = SUB * NSUB;  // steps a CTA
constexpr int NT = CW * NSUB;      // threads a CTA
constexpr int STEP_CW = 32, STEP_NT = 256;  // decode: channels and threads a CTA

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A h + B, rounded after the multiply and after the add: the one expression that advances
// the state everywhere (prefix pairs, the walk, the fix-up, the decode step)
__device__ __forceinline__ float advance(float A, float h, float B) {
  return __fadd_rn(__fmul_rn(A, h), B);
}

// (a_t, b_t) of a real step from log_a and gx, as the plain version forms them
__device__ __forceinline__ void rglru_pair(float la, float gx, float& a, float& b) {
  a = expf(la);
  b = __fmul_rn(sqrtf(fmaxf(1.0f - expf(2.0f * la), 1e-12f)), gx);
}

// sigmoid, and gelu_tanh(x) = 0.5 x (1 + tanh(z)) = x sigmoid(2 z), z = sqrt(2/pi) (x + 0.044715
// x^3), each with one ex2 and one reciprocal of the SFU (a few f32 ulps): the special-function
// unit runs at a quarter of the FMA rate, and the gated entry's ~9 SFU operations an element
// would otherwise rival its bytes
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float gelu_tanh(float x) {
  const float z = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return __fdividef(x, 1.0f + __expf(-2.0f * z));
}
// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// The TPU contract: log_a, gx f32 in; h of TO out.
template <typename TO>
struct ScanIO {
  using TI = float;
  static constexpr int NOPS = 2, NPAIR = 2;  // staged operands; those the pair reads
  const float* in[NOPS];                     // log_a, gx
  TO* h;
  __device__ __forceinline__ float coef(int) const { return 0.0f; }
  __device__ __forceinline__ void pair(const float* v, float, float& a, float& b) const {
    rglru_pair(v[0], v[1], a, b);
  }
  __device__ __forceinline__ void store(long i, float hv, const float*) const {
    h[i] = from_f<TO>(hv);
  }
};

// griffin's block around the scan: ga, gxp, u, g of T in; y of T out.
template <typename T>
struct GatedIO {
  using TI = T;
  static constexpr int NOPS = 4, NPAIR = 3;
  const T* in[NOPS];  // ga, gxp, u, g
  const void* lam;    // lambda (W,), bf16 when lam_bf16, else f32
  int lam_bf16;
  T* y;
  // -8 softplus(lambda_c), with torch's threshold of 20
  __device__ __forceinline__ float coef(int c) const {
    const float l = lam_bf16 ? to_f(static_cast<const __nv_bfloat16*>(lam)[c])
                             : static_cast<const float*>(lam)[c];
    return __fmul_rn(-8.0f, l > 20.0f ? l : log1pf(expf(l)));
  }
  __device__ __forceinline__ void pair(const float* v, float coef, float& a, float& b) const {
    rglru_pair(__fmul_rn(coef, sigmoid(v[0])), __fmul_rn(sigmoid(v[1]), v[2]), a, b);
  }
  // y = T(T(h) T(gelu_tanh(g))): for bf16 T the f32 product is exact, one rounding in all
  __device__ __forceinline__ void store(long i, float hv, const float* ve) const {
    y[i] = from_f<T>(round_to<T>(hv) * round_to<T>(gelu_tanh(ve[0])));
  }
};

template <class IO>
struct Smem {
  typename IO::TI v[IO::NOPS][PANEL][CW];  // the panel's operands
  int pos[PANEL];
  float pa[NSUB][CW], pb[NSUB][CW];        // the sub-chunks' end pairs
};

// The carry between the CTAs of one (slot, tile) when S > PANEL: every panel but the last
// writes its sub-chunks' end pairs and then, after a barrier, its flag (a release store, as
// CUTLASS's semaphores publish a CTA's writes); a CTA walks the end pairs of the panels before
// its own from h0.  The grid is panel-major: CTAs start in the order of their index, so every
// CTA a CTA waits on has started before it (the wait traps after ~10 s rather than hang if
// that ever failed).  A flag holds the launch's epoch (never 0), so flags need no reset.
struct Carry {
  unsigned* flags;   // [panel < np - 1][unit]
  float *pa, *pb;    // [panel * NSUB + sub-chunk][slot][channel]
  unsigned epoch;
};

// Bytes of the workspace ``Carry`` lives in: 0 when one panel covers S.
long workspace_bytes(int B, int S, int W) {
  const long np = (S + PANEL - 1) / PANEL, units = (long)B * ((W + CW - 1) / CW);
  return np == 1 ? 0 : 4 * units * (np - 1) + 2 * 4 * (np - 1) * NSUB * B * (long)W;
}

Carry carry_in(void* ws, int B, int S, int W, unsigned epoch) {
  const long np = (S + PANEL - 1) / PANEL, units = (long)B * ((W + CW - 1) / CW);
  unsigned* flags = static_cast<unsigned*>(ws);
  float* pa = reinterpret_cast<float*>(flags + units * (np - 1));
  return {flags, pa, pa + (np - 1) * NSUB * B * (long)W, epoch};
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Issues the copies of the panel at step s0 of slot b, channels c0.., into shared memory:
// 16-byte cp.async when the tile's rows are 16-byte aligned (VEC), else element by element
// through registers.  Rows past S are not copied; channels past W are zero-filled.
template <class IO, bool VEC>
__device__ __forceinline__ void stage(const IO& io, Smem<IO>& sm, int s0, int b, int c0,
                                      const int* pos, int S, int W) {
  using TI = typename IO::TI;
  const int tid = threadIdx.x, rows = min(PANEL, S - s0);
  const long row0 = (long)b * S + s0;
  if (pos != nullptr && tid < rows) cp4(&sm.pos[tid], pos + row0 + tid);
  if constexpr (VEC) {
    constexpr int CH = 16 / sizeof(TI), NCH = CW / CH;  // channels a chunk, chunks a row
    static_assert(IO::NOPS * PANEL * NCH % NT == 0, "whole chunks a thread");
#pragma unroll
    for (int i = 0; i < IO::NOPS * PANEL * NCH / NT; ++i) {
      const int k = tid + i * NT, op = k / (PANEL * NCH), row = k / NCH % PANEL, q = k % NCH;
      if (row >= rows) continue;
      const int c = c0 + q * CH;
      const bool live = c < W;
      cp16(&sm.v[op][row][q * CH], io.in[op] + (row0 + row) * W + (live ? c : 0), live);
    }
  } else {
    for (int k = tid; k < IO::NOPS * PANEL * CW; k += NT) {
      const int op = k / (PANEL * CW), row = k / CW % PANEL, q = k % CW;
      if (row >= rows) continue;
      const int c = c0 + q;
      sm.v[op][row][q] = c < W ? io.in[op][(row0 + row) * W + c] : from_f<TI>(0.0f);
    }
  }
}

// One CTA a (slot, tile, panel); `cr` is read only when S > PANEL.
template <class IO, bool VEC>
__global__ void __launch_bounds__(NT, 640 / NT)
rglru_chunk_kernel(const IO io, const float* h0, const int* __restrict__ pos, float* h_last,
                   int B, int S, int W, Carry cr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<IO>& sm = *reinterpret_cast<Smem<IO>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % CW, j = tid / CW;
  const int np = (S + PANEL - 1) / PANEL, tiles = (W + CW - 1) / CW, units = B * tiles;
  const int p = blockIdx.x / units, unit = blockIdx.x % units;
  const int b = unit / tiles, c0 = unit % tiles * CW, c = c0 + lane, s0 = p * PANEL;
  stage<IO, VEC>(io, sm, s0, b, c0, pos, S, W);
  commit_copies();
  const bool live = c < W;
  const float coef = live ? io.coef(c) : 0.0f;
  // h0 is read before this CTA's flag is set, and the last panel writes h_last (which may be
  // h0's storage) only after it has seen every other panel's flag
  float carry = live ? h0[(long)b * W + c] : 0.0f;
  wait_copies();
  __syncthreads();
  // (1) the sub-chunk's prefix pairs; a padding step and a step past S are (1, 0)
  float A[SUB], Bp[SUB], ra = 1.0f, rb = 0.0f;
#pragma unroll
  for (int t = 0; t < SUB; ++t) {
    const int row = j * SUB + t;
    float a = 1.0f, bb = 0.0f;
    if (s0 + row < S && (pos == nullptr || sm.pos[row] >= 0)) {
      float v[IO::NPAIR];
#pragma unroll
      for (int op = 0; op < IO::NPAIR; ++op) v[op] = to_f(sm.v[op][row][lane]);
      io.pair(v, coef, a, bb);
    }
    ra = __fmul_rn(a, ra);
    rb = advance(a, rb, bb);
    A[t] = ra;
    Bp[t] = rb;
  }
  sm.pa[j][lane] = ra;
  sm.pb[j][lane] = rb;
  if (p < np - 1 && live) {  // publish the end pairs for the later panels
    const long q = ((long)(p * NSUB + j) * B + b) * W + c;
    cr.pa[q] = ra;
    cr.pb[q] = rb;
  }
  __syncthreads();
  if (p < np - 1 && tid == 0) st_release(&cr.flags[(long)p * units + unit], cr.epoch);
  if (p > 0) {  // the state entering the panel: the earlier panels' sub-chunks from h0
    for (int q = tid; q < p; q += NT) {
      const unsigned* f = &cr.flags[(long)q * units + unit];
      const long long t0 = clock64();
      while (ld_acquire(f) != cr.epoch) {  // a fault traps after ~10 s instead of hanging
        if (clock64() - t0 > 20000000000LL) __trap();
        __nanosleep(100);
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int q = 0; q < p * NSUB; ++q) {
        const long i = ((long)q * B + b) * W + c;
        carry = advance(__ldcg(&cr.pa[i]), carry, __ldcg(&cr.pb[i]));
      }
    }
  }
  // (2) the state entering this sub-chunk
  float hin = carry;
#pragma unroll
  for (int k = 0; k < NSUB; ++k) {
    if (k == j) hin = carry;
    carry = advance(sm.pa[k][lane], carry, sm.pb[k][lane]);
  }
  // (3) the sub-chunk's states; the one at step S - 1 is also h_last
  if (live) {
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const int row = j * SUB + t, s = s0 + row;
      if (s >= S) break;
      const float h = advance(A[t], hin, Bp[t]);
      float ve[IO::NOPS - IO::NPAIR + 1];
#pragma unroll
      for (int op = IO::NPAIR; op < IO::NOPS; ++op)
        ve[op - IO::NPAIR] = to_f(sm.v[op][row][lane]);
      io.store(((long)b * S + s) * W + c, h, ve);
      if (s == S - 1) h_last[(long)b * W + c] = h;
    }
  }
}

template <class IO>
__global__ void __launch_bounds__(STEP_NT)
rglru_step_kernel(const IO io, const float* h0, const int* __restrict__ pos, float* h_last,
                  int B, int W) {
  const int c = blockIdx.x * STEP_CW + threadIdx.x % STEP_CW;
  if (c >= W) return;
  const float coef = io.coef(c);
  for (int b = threadIdx.x / STEP_CW; b < B; b += STEP_NT / STEP_CW) {
    const long i = (long)b * W + c;
    float v[IO::NOPS];
#pragma unroll
    for (int op = 0; op < IO::NOPS; ++op) v[op] = to_f(io.in[op][i]);
    float h = h0[i];  // read before this thread writes h_last[i], which may be h0[i]
    if (pos == nullptr || pos[b] >= 0) {
      float a, bb;
      io.pair(v, coef, a, bb);
      h = advance(a, h, bb);
    }
    io.store(i, h, v + IO::NPAIR);
    h_last[i] = h;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <class IO>
int launch(const IO& io, const float* h0, const int* pos, float* h_last, int B, int S, int W,
           void* ws, long ws_bytes, unsigned epoch, cudaStream_t st) {
  if (S == 1) {
    rglru_step_kernel<IO><<<(W + STEP_CW - 1) / STEP_CW, STEP_NT, 0, st>>>(io, h0, pos, h_last,
                                                                          B, W);
    return (int)cudaGetLastError();
  }
  const int units = B * ((W + CW - 1) / CW), np = (S + PANEL - 1) / PANEL;
  if (ws_bytes < workspace_bytes(B, S, W) || (np > 1 && epoch == 0))
    return (int)cudaErrorInvalidValue;
  bool vec = W % (16 / (int)sizeof(typename IO::TI)) == 0;
  for (const auto* p : io.in) vec = vec && aligned16(p);
  auto kern = vec ? rglru_chunk_kernel<IO, true> : rglru_chunk_kernel<IO, false>;
  const Carry cr = np > 1 ? carry_in(ws, B, S, W, epoch) : Carry{};
  kern<<<units * np, NT, sizeof(Smem<IO>), st>>>(io, h0, pos, h_last, B, S, W, cr);
  return (int)cudaGetLastError();
}

}  // namespace

// log_a, gx (B, S, W) f32; h0 (B, W) f32; pos (B, S) int32 or null (every step real); h
// (B, S, W) of h_dtype (f32 | bf16); h_last (B, W) f32; ws a workspace of ws_bytes (at least
// rt_rglru_workspace_bytes, zero-filled when first used) and epoch a number no earlier launch
// on it used (never 0), both read only when S > PANEL.
extern "C" int rt_rglru_scan(const void* log_a, const void* gx, const void* h0, const void* pos,
                             void* h, void* h_last, void* ws, long ws_bytes, int epoch, int B,
                             int S, int W, int h_dtype, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float *la = (const float*)log_a, *g = (const float*)gx, *hz = (const float*)h0;
  const int* p = (const int*)pos;
  float* hl = (float*)h_last;
  const unsigned ep = (unsigned)epoch;
  if (h_dtype == RT_BF16)
    return launch(ScanIO<__nv_bfloat16>{{la, g}, (__nv_bfloat16*)h}, hz, p, hl, B, S, W, ws,
                  ws_bytes, ep, st);
  if (h_dtype == RT_F32)
    return launch(ScanIO<float>{{la, g}, (float*)h}, hz, p, hl, B, S, W, ws, ws_bytes, ep, st);
  return (int)cudaErrorInvalidValue;
}

// ga, gxp, u, g (B, S, W) and y (B, S, W) of dtype (f32 | bf16); lam (W,) of lam_dtype (f32 |
// bf16); h0 (B, W) f32; pos (B, S) int32 or null; h_last (B, W) f32, which may be h0; ws,
// ws_bytes and epoch as for rt_rglru_scan.
extern "C" int rt_rglru_gated(const void* ga, const void* gxp, const void* u, const void* g,
                              const void* lam, const void* h0, const void* pos, void* y,
                              void* h_last, void* ws, long ws_bytes, int epoch, int B, int S,
                              int W, int dtype, int lam_dtype, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  if (lam_dtype != RT_BF16 && lam_dtype != RT_F32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* hz = (const float*)h0;
  const int* p = (const int*)pos;
  float* hl = (float*)h_last;
  const int lb = lam_dtype == RT_BF16;
  const unsigned ep = (unsigned)epoch;
  if (dtype == RT_BF16) {
    using T = __nv_bfloat16;
    GatedIO<T> io{{(const T*)ga, (const T*)gxp, (const T*)u, (const T*)g}, lam, lb, (T*)y};
    return launch(io, hz, p, hl, B, S, W, ws, ws_bytes, ep, st);
  }
  if (dtype == RT_F32) {
    using T = float;
    GatedIO<T> io{{(const T*)ga, (const T*)gxp, (const T*)u, (const T*)g}, lam, lb, (T*)y};
    return launch(io, hz, p, hl, B, S, W, ws, ws_bytes, ep, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The workspace rt_rglru_scan and rt_rglru_gated need at (B, S, W), in bytes.
extern "C" long rt_rglru_workspace_bytes(int B, int S, int W) { return workspace_bytes(B, S, W); }
