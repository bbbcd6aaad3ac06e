// w4a16 matmul: y = act(x @ dequant(qweight)^T * scale + bias) + residual.
//
// Replaces: src/repro/kernels/int4_matmul.py::int4_matmul_pallas (body
// _kernel :24-54), which ships packed nibbles into VMEM, dequantizes the
// whole (block_m, K) weight tile there and runs one f32 matmul with K whole.
//
// What bounds it on the H100: at decode (B = slots <= 8) it reads K*M/2
// bytes of packed weight for 2*B*K*M operations, about 4*B FLOP per byte,
// far below the ~295 the card needs to be compute-bound: the weight bytes
// are the whole cost, so the aim is to read them exactly once, with enough
// loads in flight to run at the memory's rate.  At prefill (B = slots x
// chunk = 2048) it is compute-bound on the tensor cores (2*B*K*M bf16
// operations against 989 TFLOP/s), and only wgmma reaches that rate.
//
// Numbers, both paths: the nibbles become exact small integers in bf16 and
// the tensor cores multiply them by the bf16 activations, so each product is
// exact; the per-group scale is applied once to each group's f32 partial sum
// (acc += partial * scale[n, group]) instead of rounding dequantized weights
// to bf16.  The result differs from the f32 plain version only in summation
// order, and the one rounding is the bf16 store.  The epilogue (scale ->
// bias -> activation -> residual, f32) runs before that store.  Nibble
// order: low nibble = even k, sign-extended (int4_matmul.py:33-37).
//
// Decode (B <= the wrapper's GEMV_MAX_B): a split-K GEMV with the weights as
// the mma A operand and the tokens as N (one n8 tile per 8 tokens).  K is
// cut into group-aligned slices until the (row tile, slice) CTAs fill a wave
// of the SMs (the wrapper's plan); each warp streams its 16 weight rows from
// device memory straight into registers (every byte fetched once, 16-byte
// loads, two 128-k blocks in flight), the CTA's slice of x and its scales
// are staged once in shared memory, and the slices of a row tile, one thread
// block cluster, are summed in order through distributed shared memory and
// run through the epilogue in the same launch.  See the section below.
//
// Prefill (B above it): a warp-specialized wgmma GEMM that computes the
// transposed tile, outputs x tokens (128 x 128), so that the converted
// weights are the register A operand and never pass through shared memory.
// - One producer warp keeps a 4-stage ring in shared memory full: per 128-deep
//   K step two TMA loads of the activation tile (128 tokens x 64 k each, bf16,
//   128-byte swizzle: the wgmma B operand as it lands), one of the packed
//   weight tile (128 rows x 64 bytes), all zero-filled past B, M and K, and
//   4-byte cp.async copies of the step's group scales (a word holding the pair
//   the scale sits in), all completing on the stage's mbarrier.
// - Two consumer warpgroups own 64 weight rows each.  A thread reads its two
//   rows' 64 bytes a step, gathers byte (lane % 4) of every word with prmt
//   (the bytes its mma fragment needs), and turns each nibble into bf16
//   without a float conversion: nibble ^ 8 = q + 8 goes into the mantissa of
//   128.0 (0x4300 | u = 128 + u, exact), and one bf16x2 subtract of 136 leaves
//   q.  The fragments feed eight wgmma m64n128k16 (A from registers, B = the
//   activation tile through its shared-memory descriptor), issued back to
//   back, into a per-group partial sum; the next step starts by waiting for
//   them, folds the partial sum of a group that ended (acc += part * scale)
//   and converts its own fragments while the other warpgroup's products run,
//   so the two warpgroups alternate on the tensor cores.
// - The epilogue goes through shared memory (the ring, once drained): the
//   accumulators, then the tile's scale, bias and residual rows beside them
//   (16-byte loads, all issued before any is used), then 16-byte stores of
//   whole output rows.  Its last pass is a template on the activation: the
//   code runs once a tile and is fetched cold, so a tile fetches one short
//   branch-free copy.
// Each converted weight tile serves all 128 tokens of the tile; each
// activation tile is read from L2 by the M / 128 CTAs of its token tile.
// What development trials showed (scratch builds, PERF.md): a branch between
// the wgmmas of a step made the compiler close and fence each one; consumers
// did not wait for data, but a 64-deep step had a fixed cost that doubling
// the step's products barely raised, so steps are 128 deep; an inlined,
// unrolled epilogue holding every activation was slow, fetched cold.
//
// f32 activations (the MoE router, rt_int4_matmul_f32): f32-accurate
// products from two TF32 tensor-core passes (x split into tf32 hi and lo),
// split-K reduced in the same launch; see the section at the end.
#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int KS = 64;  // K of one activation sub-tile: 128 bytes of bf16, the swizzle width

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- nibbles to bf16 without float conversions -----------------------------

// Byte `sel & 7` of w0 and w1 and of w2 and w3 (sel = tig | (tig + 4) << 4),
// packed in word order: byte i of the result comes from word i.
__device__ __forceinline__ uint32_t gather_bytes(uint32_t w0, uint32_t w1, uint32_t w2,
                                                 uint32_t w3, uint32_t sel) {
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// Four packed bytes -> four bf16x2 words, word i = (low, high nibble) of
// byte i as exact integers in [-8, 7]: u = nibble ^ 8 = q + 8 is OR-ed into
// the mantissa of 128.0 (bf16 0x4300 | u = 128 + u) and 136 is subtracted.
__device__ __forceinline__ void nibbles_to_bf16(uint32_t p, uint32_t (&o)[4]) {
  const uint32_t t = p ^ 0x88888888u;
  const uint32_t a = (t & 0x000F000Fu) | 0x43004300u;          // byte 0, 2 low nibbles
  const uint32_t b = ((t >> 4) & 0x000F000Fu) | 0x43004300u;   // byte 0, 2 high
  const uint32_t c = ((t >> 8) & 0x000F000Fu) | 0x43004300u;   // byte 1, 3 low
  const uint32_t d = ((t >> 12) & 0x000F000Fu) | 0x43004300u;  // byte 1, 3 high
  const uint32_t pairs[4] = {__byte_perm(a, b, 0x5410), __byte_perm(c, d, 0x5410),
                             __byte_perm(a, b, 0x7632), __byte_perm(c, d, 0x7632)};
  const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                 __ushort_as_bfloat16(0x4308));  // 136
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&pairs[i]);
    v = __hsub2(v, bias);
    o[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// The mma A-fragment words of one weight row over 64 of K, from its
// 32 packed bytes (word j holds k = 8j .. 8j + 7): f[b][0] holds k = 16b +
// 2 tig and + 1, f[b][1] k = 16b + 8 + 2 tig and + 1 (tig = lane % 4), which is
// byte tig of every word.
__device__ __forceinline__ void row_fragments(const uint8_t* seg, uint32_t sel,
                                              uint32_t (&f)[4][2]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(seg);
  const uint4 hi = *reinterpret_cast<const uint4*>(seg + 16);
  uint32_t c[4];
  nibbles_to_bf16(gather_bytes(lo.x, lo.y, lo.z, lo.w, sel), c);
  f[0][0] = c[0]; f[0][1] = c[1]; f[1][0] = c[2]; f[1][1] = c[3];
  nibbles_to_bf16(gather_bytes(hi.x, hi.y, hi.z, hi.w, sel), c);
  f[2][0] = c[0]; f[2][1] = c[1]; f[3][0] = c[2]; f[3][1] = c[3];
}

// ---- cp.async, wgmma operand fences (TMA, wgmma, barriers: hopper.cuh, common.cuh) ----
// 4 bytes global -> shared; bytes past `src_bytes` (0, 2 or 4) are zero-filled
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// Pins the accumulator registers at this point of the program, so that the
// compiler moves no access to them across a wgmma fence or wait.  Used only
// outside the span from a wgmma to its wait: an access inside it makes the
// compiler serialize the wgmmas.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for a step's A fragments: the conversion must be done before the
// wgmma fence, or the compiler moves it between the wgmmas and has to fence
// each one.
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int b = 0; b < N; ++b)
    asm volatile("" : "+r"(a[b][0]), "+r"(a[b][1]), "+r"(a[b][2]), "+r"(a[b][3])::"memory");
}
// D (64 weight rows x 128 tokens, f32) += A (64 x 16, bf16 registers) * B (16 x 128,
// the activation tile's descriptor); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// ---- decode: the split-K GEMV (bf16 activations, B <= 8 * GV_MAX_NT) --------
//
// Weights are the mma A operand (16 output rows x 16 k), tokens the N side
// (one n8 tile per 8 tokens).  A CTA holds `warps` warps of 16 weight rows
// each and one K-slice of the split plan (kernels/int4_matmul.py gemv_plan:
// slices on group boundaries, the grid balanced over the 132 SMs).  The
// CTA's slice of x is staged once in shared memory (16-byte cp.async, then
// each 8-k run put in the order (0, 4, 1, 5, 2, 6, 3, 7)), the slice's scales
// beside it.  The packed weights go straight from device memory to
// registers, every byte fetched once by one lane: in a 128-k block a quad of
// lanes reads its two rows' 64 bytes, lane tig the 16 bytes of words 4 tig ..
// 4 tig + 3, as two 16-byte loads, GV_DEPTH blocks in flight a warp
// (development trials, tools/port_probe.py int4-variants and PERF.md: a
// TMA-fed shared-memory ring a warp was no faster, and more bytes in flight
// a warp were slower).  Word 4 tig + w gives the mma steps 2w (bytes 0 and 2)
// and 2w + 1 (bytes 1 and 3): one AND/XOR puts a byte pair's low nibbles
// into the two halves of a bf16x2 (magic 128.0, minus 136), their high
// nibbles likewise, with no byte gather, and the permuted x makes the same k
// pairs one 16-byte load of both steps' B fragments.  An mma step then spans
// 128 k, so this takes group % 128 == 0 (WHOLE, every served config); other
// groups take k16 steps whose 16 k are contiguous (a lane pair shares a
// 4-byte word load).  A group's f32 partial sums fold as acc += part *
// scale.  The slices of a row tile are one thread block cluster, reduced
// through distributed shared memory in slice order in the same launch
// (SliceReduce below): one launch, deterministic, no workspace.  Trials
// showed the alternative, partials through L2 and the last CTA of a tile
// to count itself in on an atomic summing them, spending 6-11 us a call on
// that tail.  Where a call's time goes, measured: PERF.md §6.
constexpr int GV_MAX_NT = 6;  // n8 token tiles: B <= 48
constexpr int GV_DEPTH = 2;   // 128-k blocks in flight a warp (1 KB each)
constexpr int GV_XPAD = 8;    // bf16 padding of a staged x row: 16 bytes, conflict-free loads
constexpr int MAX_SPLITS = 16;  // K slices: the CTAs of one cluster

struct GemvArgs {
  const __nv_bfloat16* x;
  const uint8_t* qw;
  const __nv_bfloat16* scales;
  const float* ep_scale;
  const float* ep_bias;
  const __nv_bfloat16* residual;
  __nv_bfloat16* out;
  int B, K, M, group, act, splits, per_k, ngs;
};

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 streamed bytes: not kept in L1, the L2 fetching 256-byte runs
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Bits 0-3 and 16-19 of t (of a packed word shifted by 0, 4, 8 or 12: the
// low nibbles of bytes 0 and 2, their high nibbles, those of bytes 1 and 3)
// as a bf16x2 of the sign-extended values, exact: nibble ^ 8 = q + 8 into the
// mantissa of 128.0 (one AND/XOR: (t & 0x000F000F) ^ 0x43084308 = ((t ^ 8) &
// 15) | 0x4300 in each half), minus 136.
__device__ __forceinline__ uint32_t halves_to_bf16(uint32_t t) {
  const uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              __halves2bfloat162(__ushort_as_bfloat16(0x4308), __ushort_as_bfloat16(0x4308)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The slices' reduce, shared by both routes.  The CTAs of a cluster (cluster
// rank = K-slice) hold partial sums of one output tile of n = toks x rows
// outputs (o = t * rows + r); CTA q owns outputs [q share, (q + 1) share).
// Each CTA pushes every partial into its owner's receive buffer (slot = its
// own rank) by remote shared-memory stores; one cluster barrier later each
// owner sums its outputs' slots in slice order and runs the epilogue, whose
// operands it loaded when the kernel began (EP_PRE outputs a thread ahead).
// One slice: the CTA alone, a block barrier.
constexpr int EP_PRE = 4;
template <typename T>
struct SliceReduce {
  int splits, rank, toks, rows, share, count, t0, m0, M, act;
  float* recv;  // [splits][share] of this CTA's shared memory
  const float* ep_scale;
  const float* ep_bias;
  const T* residual;
  T* out;
  float pre[EP_PRE][3];  // scale, bias, residual of this thread's first outputs

  __device__ __forceinline__ void operands(int i, float (&v)[3]) const {
    const int o = rank * share + i, t = o / rows, r = o % rows;
    v[0] = ep_scale ? ep_scale[m0 + r] : 1.f;
    v[1] = ep_bias ? ep_bias[m0 + r] : 0.f;
    v[2] = residual ? to_f(residual[(long)(t0 + t) * M + m0 + r]) : 0.f;
  }
  __device__ __forceinline__ SliceReduce(int splits_, int toks_, int rows_, int t0_, int m0_,
                                         int M_, int act_, float* recv_, const float* ep_scale_,
                                         const float* ep_bias_, const T* residual_, T* out_)
      : splits(splits_), toks(toks_), rows(rows_), t0(t0_), m0(m0_), M(M_), act(act_),
        recv(recv_), ep_scale(ep_scale_), ep_bias(ep_bias_), residual(residual_), out(out_) {
    rank = splits > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
    share = (toks * rows + splits - 1) / splits;
    count = max(0, min(share, toks * rows - rank * share));
#pragma unroll
    for (int q = 0; q < EP_PRE; ++q)
      if (threadIdx.x + q * blockDim.x < count) operands(threadIdx.x + q * blockDim.x, pre[q]);
  }
  // partial v of the tile's token t, row r (tile-local) to its owner
  __device__ __forceinline__ void push(float v, int t, int r) const {
    if (t >= toks || r >= rows) return;
    const int o = t * rows + r, owner = o / share;
    float* dst = recv + rank * share + (o - owner * share);
    if (splits > 1) dst = cooperative_groups::this_cluster().map_shared_rank(dst, owner);
    *dst = v;
  }
  __device__ __forceinline__ void emit(int i, const float (&v)[3]) const {
    float y = 0.f;
    for (int s = 0; s < splits; ++s) y += recv[s * share + i];  // in slice order
    if (ep_scale) y *= v[0];
    if (ep_bias) y += v[1];
    if (act) y = rt_activation(y, act);
    if (residual) y += v[2];
    const int o = rank * share + i;
    out[(long)(t0 + o / rows) * M + m0 + o % rows] = from_f<T>(y);
  }
  __device__ __forceinline__ void finish() const {
    if (splits > 1)
      cooperative_groups::this_cluster().sync();
    else
      __syncthreads();
#pragma unroll
    for (int q = 0; q < EP_PRE; ++q)
      if (threadIdx.x + q * blockDim.x < count) emit(threadIdx.x + q * blockDim.x, pre[q]);
    for (int i = threadIdx.x + EP_PRE * blockDim.x; i < count; i += blockDim.x) {
      float v[3];
      operands(i, v);
      emit(i, v);
    }
  }
};

template <int NT, bool WHOLE>
__global__ void __launch_bounds__(256) int4_gemv_kernel(const GemvArgs a) {
  extern __shared__ __align__(16) uint8_t gv_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.x * warps * 16, split = blockIdx.y;
  const int k0 = split * a.per_k, k1 = min(a.K, k0 + a.per_k);
  const int XS = a.per_k + GV_XPAD;  // a staged x row, bf16
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(gv_smem);
  __nv_bfloat16* sc = xs + 8 * NT * XS;  // [warps * 16][ngs]
  float* recv = reinterpret_cast<float*>(  // the slices' receive buffer, 16-byte aligned
      (reinterpret_cast<uintptr_t>(sc + warps * 16 * a.ngs) + 15) & ~static_cast<uintptr_t>(15));
  const SliceReduce<__nv_bfloat16> red(a.splits, a.B, min(warps * 16, a.M - m0), 0, m0, a.M,
                                       a.act, recv, a.ep_scale, a.ep_bias, a.residual, a.out);
  const int rb = m0 + warp * 16;  // the warp's first weight row
  const long KH = a.K / 2;
  const int nblk = a.M > rb ? (k1 - k0 + 127) / 128 : 0;
  // the lane's rows gid and gid + 8 (a row past M reads row M - 1; it is never stored)
  const uint8_t* w0 = a.qw + (long)min(rb + gid, a.M - 1) * KH + k0 / 2;
  const uint8_t* w1 = a.qw + (long)min(rb + gid + 8, a.M - 1) * KH + k0 / 2;
  // the cluster's CTAs must all be running before one stores into another's
  // shared memory: arrive now, wait before the partials go out
  if (a.splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // The slice's x (8 * NT token rows, zero past B) in 16-byte cp.async
  // copies; each thread then puts the 8-k runs it copied in the order (0, 4,
  // 1, 5, 2, 6, 3, 7).
  const int runs = (k1 - k0) / 8;
  for (int c = threadIdx.x; c < 8 * NT * runs; c += blockDim.x) {
    const int t = c / runs, j = c % runs;
    cp16(xs + t * XS + 8 * j, a.x + (t < a.B ? (long)t * a.K + k0 + 8 * j : 0), t < a.B);
  }
  cp_commit();
  // the slice's scales (rows past M read as 0), 8 loads a thread a batch,
  // each batch's loads all issued before its stores
  const int G = a.K / a.group, g0 = k0 / a.group, ng = (k1 - 1) / a.group - g0 + 1;
  auto scale_batch = [&](int i0, __nv_bfloat16 (&v)[8]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x, row = m0 + i / ng;
      v[u] = i < warps * 16 * ng && row < a.M ? a.scales[(long)row * G + g0 + i % ng]
                                               : __float2bfloat16(0.f);
    }
  };
  auto store_batch = [&](int i0, const __nv_bfloat16 (&v)[8]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < warps * 16 * ng) sc[(i / ng) * a.ngs + i % ng] = v[u];
    }
  };
  __nv_bfloat16 v0[8];
  scale_batch(threadIdx.x, v0);
  // WHOLE: the first blocks' weights go out after x and the first scales
  // (whatever is queued behind them waits: every warp needs x for its
  // first products)
  uint4 buf[GV_DEPTH][2];
  if (WHOLE) {
#pragma unroll
    for (int d = 0; d < GV_DEPTH; ++d)
      if (d < nblk) {
        buf[d][0] = ld_stream(w0 + 64 * d + 16 * tig);
        buf[d][1] = ld_stream(w1 + 64 * d + 16 * tig);
      }
  }
  store_batch(threadIdx.x, v0);
  for (int i0 = threadIdx.x + 8 * blockDim.x; i0 < warps * 16 * ng; i0 += 8 * blockDim.x) {
    __nv_bfloat16 v[8];
    scale_batch(i0, v);
    store_batch(i0, v);
  }
  cp_wait<0>();  // this thread's x copies have landed
  for (int c = threadIdx.x; c < 8 * NT * runs; c += blockDim.x) {
    uint4* q = reinterpret_cast<uint4*>(xs + (c / runs) * XS + 8 * (c % runs));
    const uint4 v = *q;
    uint4 p;
    p.x = __byte_perm(v.x, v.z, 0x5410);  // (x0, x4)
    p.y = __byte_perm(v.x, v.z, 0x7632);  // (x1, x5)
    p.z = __byte_perm(v.y, v.w, 0x5410);  // (x2, x6)
    p.w = __byte_perm(v.y, v.w, 0x7632);  // (x3, x7)
    *q = p;
  }
  __syncthreads();

  // two partial sums, even and odd mma steps, so that consecutive mmas do not
  // wait on each other; a group's fold takes both
  float acc[NT][4], part[2][NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = part[0][n][e] = part[1][n][e] = 0.f;
  const __nv_bfloat16* sc0 = sc + (warp * 16 + gid) * a.ngs;  // rows gid and gid + 8
  const uint8_t* xrow = reinterpret_cast<const uint8_t*>(xs + gid * XS);
  int gend = min(k1, (g0 + 1) * a.group), g = 0;  // where the current group ends, its slot
  auto fold = [&]() {
    const float s0 = __bfloat162float(sc0[g]), s1 = __bfloat162float(sc0[8 * a.ngs + g]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = fmaf(part[0][n][e] + part[1][n][e], e < 2 ? s0 : s1, acc[n][e]);
        part[0][n][e] = part[1][n][e] = 0.f;
      }
    ++g;
    gend = min(k1, gend + a.group);
  };
  // the mma steps of words u0 (row gid) and u1 (row gid + 8), bytes (0, 2)
  // then (1, 3), against the 16 bytes of permuted x at xp (+ one n8 tile a row block)
  auto word_steps = [&](uint32_t u0, uint32_t u1, const uint8_t* xp) {
    const uint32_t ae[4] = {halves_to_bf16(u0), halves_to_bf16(u1), halves_to_bf16(u0 >> 4),
                            halves_to_bf16(u1 >> 4)};
    const uint32_t ao[4] = {halves_to_bf16(u0 >> 8), halves_to_bf16(u1 >> 8),
                            halves_to_bf16(u0 >> 12), halves_to_bf16(u1 >> 12)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint4 bv = *reinterpret_cast<const uint4*>(xp + n * 8 * XS * 2);
      const uint32_t be[2] = {bv.x, bv.y}, bo[2] = {bv.z, bv.w};
      mma_bf16(part[0][n], ae, be);
      mma_bf16(part[1][n], ao, bo);
    }
  };
  if (WHOLE) {
    // block b: lane tig's words 4 tig + w (w = 0..3) are k 32 tig + 8w .. + 7
    const uint8_t* xl = xrow + 64 * tig;
    for (int b0 = 0; b0 < nblk; b0 += GV_DEPTH) {
#pragma unroll
      for (int d = 0; d < GV_DEPTH; ++d) {
        const int b = b0 + d;
        if (b >= nblk) break;
        const uint4 r0 = buf[d][0], r1 = buf[d][1];
        if (b + GV_DEPTH < nblk) {  // refill: the block GV_DEPTH ahead
          buf[d][0] = ld_stream(w0 + 64 * (b + GV_DEPTH) + 16 * tig);
          buf[d][1] = ld_stream(w1 + 64 * (b + GV_DEPTH) + 16 * tig);
        }
        const uint8_t* xp = xl + 256 * b;
        word_steps(r0.x, r1.x, xp);
        word_steps(r0.y, r1.y, xp + 16);
        word_steps(r0.z, r1.z, xp + 32);
        word_steps(r0.w, r1.w, xp + 48);
        if (k0 + 128 * b + 128 == gend) fold();
      }
    }
  } else {
    // k16 step j of a block: lane tig's word 2j + tig / 2, bytes (p, p + 2), p = tig % 2
    const int pp = tig & 1;
    const uint8_t* xl = xrow + 8 * tig;
    for (int b = 0; b < nblk; ++b) {
      const int kb = k0 + 128 * b, nst = min(8, (k1 - kb) / 16);
      uint32_t u[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < nst) {
          const int off = 64 * b + 8 * j + 4 * (tig >> 1);
          u[j][0] = __ldg(reinterpret_cast<const uint32_t*>(w0 + off));
          u[j][1] = __ldg(reinterpret_cast<const uint32_t*>(w1 + off));
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nst) break;
        const uint32_t af[4] = {halves_to_bf16(u[j][0] >> (8 * pp)),
                                halves_to_bf16(u[j][1] >> (8 * pp)),
                                halves_to_bf16(u[j][0] >> (8 * pp + 4)),
                                halves_to_bf16(u[j][1] >> (8 * pp + 4))};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 bv = *reinterpret_cast<const uint2*>(xl + (kb - k0 + 16 * j) * 2 +
                                                           n * 8 * XS * 2);
          const uint32_t bf[2] = {bv.x, bv.y};
          mma_bf16(part[j & 1][n], af, bf);
        }
        if (kb + 16 * j + 16 == gend) fold();  // a group (or the slice) ends
      }
    }
  }

  // partials (row gid / gid + 8, tokens 8n + 2 tig, + 1) to their owners
  if (a.splits > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red.push(acc[n][e], 8 * n + 2 * tig + (e & 1), warp * 16 + gid + (e >= 2 ? 8 : 0));
  red.finish();
}

// ---- prefill: the warp-specialized wgmma GEMM -------------------------------

constexpr int MM_BT = 128;                           // tokens a tile (wgmma N)
constexpr int MM_BN = 128;                           // weight rows a tile (2 x 64)
constexpr int MM_KS = 128;                           // K a step
constexpr int MM_SUBS = MM_KS / KS;                  // 64-deep activation sub-tiles a step
constexpr int MM_BLOCKS = MM_KS / 16;                // wgmma k16 blocks a step
constexpr int MM_STAGES = 4;
constexpr int MM_THREADS = 384;                      // 2 consumer warpgroups + 1 producer
constexpr int X_SUB = MM_BT * KS * 2;                // one 64-deep activation sub-tile
constexpr int X_BYTES = MM_SUBS * X_SUB;
constexpr int W_BYTES = MM_BN * MM_KS / 2;           // packed weight tile
constexpr int SC_BYTES = MM_BLOCKS * MM_BN * 4;      // up to a group a block
constexpr int STAGE_BYTES = X_BYTES + W_BYTES + SC_BYTES;
constexpr int YS_LD = MM_BN + 4;                     // epilogue tile row, conflict-free
constexpr int RS_LD = MM_BN + 8;                     // residual tile row (bf16), 16-byte aligned
constexpr int MM_SMEM = 1024 + MM_STAGES * STAGE_BYTES + 2 * MM_STAGES * 8;
static_assert(STAGE_BYTES % 1024 == 0, "swizzled tiles need 1024-byte alignment");
static_assert(MM_BT * YS_LD * 4 + 2 * MM_BN * 4 + MM_BT * RS_LD * 2 <= MM_STAGES * STAGE_BYTES,
              "the epilogue's tiles reuse the ring");

__device__ __forceinline__ float scale_at(uint32_t word, long e) {
  // the bf16 scale with flat index e from the 4-byte word holding pair e & ~1
  const uint32_t bits = (e & 1) ? (word >> 16) : (word & 0xFFFFu);
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ void fold(float (&acc)[64], const float (&part)[64], float s0,
                                     float s1) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j] = fmaf(part[4 * j], s0, acc[4 * j]);
    acc[4 * j + 1] = fmaf(part[4 * j + 1], s0, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(part[4 * j + 2], s1, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(part[4 * j + 3], s1, acc[4 * j + 3]);
  }
}

// One 128-deep K step of a consumer warpgroup.  It starts by waiting for its
// previous step's products: then that step's stage is released, a group that
// ended with it is folded (acc += part * scale: `pending`, with the scales s0
// and s1 of rows rl and rl + 8), and the A registers are free for this step's
// conversion.  While a warpgroup waits, folds and converts, the other one's
// products keep the tensor cores busy, so the two settle into alternating
// batches.  WHOLE: the step is 128 deep and no group ends inside it (group %
// 128 == 0), so its eight wgmmas issue back to back with no branch between
// them (a branch there makes the compiler close and fence each wgmma on its
// own); else the step walks its blocks and folds a group that ends inside it
// on the spot.
template <bool WHOLE>
__device__ __forceinline__ void mm_step(int kt, int K, int group, int G, int n0, int rl,
                                        uint32_t sel, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, float (&acc)[64], float (&part)[64],
                                        uint32_t (&a)[MM_BLOCKS][4], bool& pending, float& ps0,
                                        float& ps1) {
  const int s = kt % MM_STAGES;
  mbar_wait(&full[s], (kt / MM_STAGES) & 1);
  wgmma_wait<0>();
  if (pending) {
    fence_operands(part);
    fold(acc, part, ps0, ps1);
    fence_operands(part);
    pending = false;
  }
  if (kt > 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[(kt - 1) % MM_STAGES]);
  const uint8_t* st = ring + s * STAGE_BYTES;
#pragma unroll
  for (int h = 0; h < MM_SUBS; ++h) {
    uint32_t f0[4][2], f1[4][2];
    row_fragments(st + X_BYTES + rl * (MM_KS / 2) + 32 * h, sel, f0);
    row_fragments(st + X_BYTES + (rl + 8) * (MM_KS / 2) + 32 * h, sel, f1);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      a[4 * h + b][0] = f0[b][0];
      a[4 * h + b][1] = f1[b][0];
      a[4 * h + b][2] = f0[b][1];
      a[4 * h + b][3] = f1[b][1];
    }
  }
  const uint32_t* sc = reinterpret_cast<const uint32_t*>(st + X_BYTES + W_BYTES);
  uint64_t dx[MM_SUBS];  // the sub-tiles' descriptors; + 2 a block: 32 bytes of k
#pragma unroll
  for (int h = 0; h < MM_SUBS; ++h) dx[h] = desc_sw128(smem_u32(st + h * X_SUB));
  const int k0 = kt * MM_KS;
  fence_operands(a);
  wgmma_fence();
  if (WHOLE) {
#pragma unroll
    for (int b = 0; b < MM_BLOCKS; ++b)
      wgmma_rs_m64n128k16(part, a[b], dx[b / 4] + 2 * (b % 4), b > 0 || k0 % group != 0);
    if ((k0 + MM_KS) % group == 0) {  // the group ends with this step
      const int g = k0 / group;
      pending = true;
      ps0 = scale_at(sc[rl], (long)(n0 + rl) * G + g);
      ps1 = scale_at(sc[rl + 8], (long)(n0 + rl + 8) * G + g);
    }
  } else {
    const int nb = min(MM_BLOCKS, (K - k0) / 16);  // K % 32 == 0: nb >= 2
#pragma unroll
    for (int b = 0; b < MM_BLOCKS; ++b) {
      if (b >= nb) break;
      const int kb = k0 + 16 * b;
      wgmma_rs_m64n128k16(part, a[b], dx[b / 4] + 2 * (b % 4), kb % group != 0);
      if ((kb + 16) % group == 0) {  // the group ends: its partial sums take their scales
        const int g = kb / group, slot = g - k0 / group;
        const float s0 = scale_at(sc[slot * MM_BN + rl], (long)(n0 + rl) * G + g);
        const float s1 = scale_at(sc[slot * MM_BN + rl + 8], (long)(n0 + rl + 8) * G + g);
        if (b == nb - 1) {
          pending = true;
          ps0 = s0;
          ps1 = s1;
        } else {
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(part);
          fold(acc, part, s0, s1);
          fence_operands(part);
          wgmma_fence();
        }
      }
    }
  }
  wgmma_commit();
}

// The tile's last pass: each thread takes 8-column chunks of token rows,
// applies the epilogue (scale -> bias -> activation ACT -> residual, f32) from
// the operands staged beside the tile, and stores 16 bytes a chunk.  ACT is a
// template parameter, so the kernel holds one copy of this code for each
// activation and a tile fetches (cold, once) only its own.
template <int ACT>
__device__ __forceinline__ void finish_tile(const float* ys, const float* es,
                                            const __nv_bfloat16* rs, __nv_bfloat16* out, int B,
                                            int M, int t0, int n0, int vec, bool res) {
#pragma unroll 1
  for (int c = threadIdx.x; c < MM_BT * (MM_BN / 8); c += 256) {
    const int tl = c / (MM_BN / 8), nl = (c % (MM_BN / 8)) * 8;
    const int t = t0 + tl, n = n0 + nl;
    if (t >= B || n >= M) continue;
    const float* y = &ys[tl * YS_LD + nl];
    const __nv_bfloat16* r = &rs[tl * RS_LD + nl];
    const long o = (long)t * M + n;
    if (vec) {  // M % 8 == 0 and 16-byte aligned rows: whole 16-byte chunks
      float v[8], sc[8], bi[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float4*>(v + 4 * h) = *reinterpret_cast<const float4*>(y + 4 * h);
        *reinterpret_cast<float4*>(sc + 4 * h) =
            *reinterpret_cast<const float4*>(es + nl + 4 * h);
        *reinterpret_cast<float4*>(bi + 4 * h) =
            *reinterpret_cast<const float4*>(es + MM_BN + nl + 4 * h);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = v[i] * sc[i] + bi[i];
        if (ACT) v[i] = rt_activation(v[i], ACT);
        if (res) v[i] += __bfloat162float(r[i]);
      }
      __nv_bfloat162 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll 1
      for (int i = 0; i < min(8, M - n); ++i) {
        float u = y[i] * es[nl + i] + es[MM_BN + nl + i];
        if (ACT) u = rt_activation(u, ACT);
        if (res) u += __bfloat162float(r[i]);
        out[o + i] = __float2bfloat16(u);
      }
    }
  }
}

__global__ void __launch_bounds__(MM_THREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                  const __nv_bfloat16* __restrict__ scales, const float* __restrict__ ep_scale,
                  const float* __restrict__ ep_bias, const __nv_bfloat16* __restrict__ residual,
                  __nv_bfloat16* __restrict__ out, int B, int K, int M, int group, int act,
                  int vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + MM_STAGES * STAGE_BYTES);
  uint64_t* empty = full + MM_STAGES;
  const int n0 = blockIdx.x * MM_BN, t0 = blockIdx.y * MM_BT;
  const int nk = (K + MM_KS - 1) / MM_KS, G = K / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < MM_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the producer's expect_tx + its 32 lanes' cp.async
      mbar_init(&empty[s], 8);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one warp feeds the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % MM_STAGES, k0 = kt * MM_KS;
        mbar_wait(&empty[s], ((kt / MM_STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * STAGE_BYTES;
        if (lane == 0) {
          const int subs = min(MM_SUBS, (K - k0 + KS - 1) / KS);  // sub-tiles holding some of K
          mbar_expect_tx(&full[s], subs * X_SUB + W_BYTES);
          for (int h = 0; h < subs; ++h)
            tma_load_2d(st + h * X_SUB, &tmx, &full[s], k0 + h * KS, t0);
          tma_load_2d(st + X_BYTES, &tmw, &full[s], k0 / 2, n0);
        }
        uint32_t* sc = reinterpret_cast<uint32_t*>(st + X_BYTES + W_BYTES);
        const int g0 = k0 / group, g1 = (min(k0 + MM_KS, K) - 1) / group;
        for (int i = lane; i < (g1 - g0 + 1) * MM_BN; i += 32) {
          const int r = i % MM_BN, n = n0 + r;
          const long e = (long)n * G + g0 + i / MM_BN;
          const int bytes = n < M ? ((e | 1) < (long)M * G ? 4 : 2) : 0;
          cp_async_4(sc + i, scales + (bytes ? (e & ~1L) : 0), bytes);
        }
        cp_async_arrive(&full[s]);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {  // consumer warpgroups: 64 weight rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
    const int rl = wg * 64 + (warp % 4) * 16 + gid;  // local weight rows rl and rl + 8
    const uint32_t sel = tig | ((tig + 4) << 4);
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    uint32_t a[MM_BLOCKS][4];
    bool pending = false;
    float ps0 = 0.f, ps1 = 0.f;
    const bool whole = group % MM_KS == 0;  // every step but a shorter last one is whole
    for (int kt = 0; kt < nk; ++kt) {
      if (whole && (kt + 1) * MM_KS <= K)
        mm_step<true>(kt, K, group, G, n0, rl, sel, ring, full, empty, acc, part, a, pending,
                      ps0, ps1);
      else
        mm_step<false>(kt, K, group, G, n0, rl, sel, ring, full, empty, acc, part, a, pending,
                       ps0, ps1);
    }
    wgmma_wait<0>();
    fence_operands(part);
    fold(acc, part, ps0, ps1);  // K ends a group, so the last one is always pending

    // epilogue: accumulators (row = weight row, column = token) into a
    // token-major f32 tile over the drained ring, then whole output rows
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* ys = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ys[(8 * j + 2 * tig + (e & 1)) * YS_LD + rl + (e >= 2 ? 8 : 0)] = acc[4 * j + e];
    // The tile's epilogue operands into shared memory beside it, every load
    // issued before any is used: scale and bias of its 128 columns, and its
    // residual rows (16-byte loads).
    float* es = ys + MM_BT * YS_LD;  // scale [MM_BN], bias [MM_BN]
    __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(es + 2 * MM_BN);  // [MM_BT][RS_LD]
    for (int c = threadIdx.x; c < MM_BN; c += 256) {
      const bool in = n0 + c < M;
      es[c] = ep_scale && in ? ep_scale[n0 + c] : 1.0f;
      es[MM_BN + c] = ep_bias && in ? ep_bias[n0 + c] : 0.0f;
    }
    if (residual) {
#pragma unroll 4
      for (int c = threadIdx.x; c < MM_BT * (MM_BN / 8); c += 256) {
        const int tl = c / (MM_BN / 8), nl = (c % (MM_BN / 8)) * 8;
        const int t = t0 + tl, n = n0 + nl;
        if (t >= B || n >= M) continue;
        __nv_bfloat16* d = rs + tl * RS_LD + nl;
        if (vec) {
          *reinterpret_cast<uint4*>(d) =
              __ldg(reinterpret_cast<const uint4*>(residual + (long)t * M + n));
        } else {
          for (int i = 0; i < min(8, M - n); ++i) d[i] = residual[(long)t * M + n + i];
        }
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    switch (act) {  // one instance a tile: only its code is fetched
      case 0: finish_tile<0>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 1: finish_tile<1>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 2: finish_tile<2>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 3: finish_tile<3>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 4: finish_tile<4>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 5: finish_tile<5>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      case 6: finish_tile<6>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
      default: finish_tile<7>(ys, es, rs, out, B, M, t0, n0, vec, residual != nullptr); break;
    }
  }
}

// The conversion alone, for the card test over all 256 byte values: rows of
// 32 packed bytes -> rows of 64 bf16, each lane writing the words its mma
// fragments hold.
__global__ void int4_unpack_kernel(const uint8_t* __restrict__ packed,
                                   __nv_bfloat16* __restrict__ out, int rows) {
  const int lane = threadIdx.x % 32, tig = lane % 4;
  const int row = blockIdx.x * 8 + lane / 4;
  if (row >= rows) return;
  uint32_t f[4][2];
  row_fragments(packed + row * 32, tig | ((tig + 4) << 4), f);
  uint32_t* o = reinterpret_cast<uint32_t*>(out + row * 64);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    o[8 * b + tig] = f[b][0];      // k = 16b + 2 tig
    o[8 * b + 4 + tig] = f[b][1];  // k = 16b + 8 + 2 tig
  }
}

// ---- f32 activations (the MoE router) --------------------------------------
// repro's kernel takes f32 x as well and then computes in f32: weights
// dequantized to f32 (nibble x bf16 scale, exact), f32 products and sums, f32
// out, the epilogue in f32.  The router (6144 -> 8, 7168 -> 384) is the one
// caller.  Here the tensor cores compute f32-accurate products: a weight q *
// scale has at most 11 significant bits (3 of |q| <= 8, 8 of the bf16
// scale), so it is exact in TF32 and goes into the A operand whole; x is
// split, x_hi = tf32(x), x_lo = tf32(x - x_hi), and two mma.sync m16n8k8
// TF32 passes (w x_lo, then w x_hi) accumulate in f32.  Each product is
// within ~2^-22 of the f32 product w x, and the sums are the plain
// version's own w x in another order, with no per-group rounding.  Weights
// are the A operand (16 rows), tokens the N side.  A CTA of 8 warps (wm x 8 /
// wm) owns a tile of 16 FM wm weight rows x 8 FN (8 / wm) tokens and one
// K-slice of the plan (kernels/int4_matmul.py f32_plan: slices on group
// boundaries until the tiles fill a wave; the slices of a tile are one
// cluster, reduced as in the GEMV).  A cp.async ring brings KT k of
// x (f32) and of the packed weights a stage (KT 32 at prefill; 256 at
// decode, where a stage's loads, not its products, set the pace); each stage's x is
// split into (hi, lo) pairs once for the CTA, a stage ahead of its products,
// laid out so that a lane's B fragments of both passes are one 16-byte load.
// A lane converts byte tig of its rows' packed word (k 2 tig and 2 tig + 1
// of the word's 8) as mma k labels tig and tig + 4 (nibble ^ 8 into the
// mantissa of 2^23, minus 2^23 + 8, times the row's scale), which matches
// the pair layout.  Bound at prefill by the tensor cores' mma.sync rate (two
// TF32 passes; an f32 FMA tile was bound by shared memory), at decode by
// latency.
// a stage's ring depth and row strides (padded for conflict-free loads): raw
// x (f32), the split x ((hi, hi, lo, lo) quads), packed weights (bytes)
template <int KT> struct FLd {
  static constexpr int STAGES = KT > 32 ? 3 : 4;
  static constexpr int X = KT + 4, C = 2 * KT + 4, W = KT / 2 + (KT > 32 ? 16 : 0);
};

struct F32Args {
  const float* x;
  const uint8_t* qw;
  const __nv_bfloat16* scales;
  const float* ep_scale;
  const float* ep_bias;
  const float* residual;
  float* out;
  int B, K, M, group, act, splits, per_k, ngs, wm;
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t t;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(t) : "f"(x));
  return t;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the low nibble of v (already XOR-ed with 8) as the integer q, times s: exact in TF32
__device__ __forceinline__ uint32_t weight_tf32(uint32_t v, float s) {
  return __float_as_uint((__uint_as_float((v & 0xFu) | 0x4B000000u) - 8388616.0f) * s);
}

template <int FM, int FN, int KT>
__global__ void __launch_bounds__(256, 1) int4_f32_kernel(const F32Args a) {
  constexpr int F_STAGES = FLd<KT>::STAGES, F_XLD = FLd<KT>::X, F_CLD = FLd<KT>::C,
                F_WLD = FLd<KT>::W;
  extern __shared__ __align__(16) uint8_t f_smem[];
  const int wm = a.wm, wn = 8 / wm;
  const int TMr = 16 * FM * wm, TN = 8 * FN * wn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int wr = warp % wm, wc = warp / wm;
  const int m0 = blockIdx.x * TMr, t0 = blockIdx.y * TN, split = blockIdx.z;
  const int k0 = split * a.per_k, k1 = min(a.K, k0 + a.per_k), nst = (k1 - k0 + KT - 1) / KT;
  float* xs = reinterpret_cast<float*>(f_smem);                  // raw [stage][TN][F_XLD]
  float* xc = xs + F_STAGES * TN * F_XLD;                        // split [2][TN][F_CLD]
  uint8_t* ws = reinterpret_cast<uint8_t*>(xc + 2 * TN * F_CLD);  // [stage][TMr][F_WLD]
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(ws + F_STAGES * TMr * F_WLD);
  const long KH = a.K / 2;
  const SliceReduce<float> red(a.splits, min(TN, a.B - t0), min(TMr, a.M - m0), t0, m0, a.M,
                               a.act, reinterpret_cast<float*>(f_smem), a.ep_scale, a.ep_bias,
                               a.residual, a.out);

  // a stage: KT k, or less at the slice's end (whole 32-k runs; the rest zero-filled)
  auto load_stage = [&](int st) {
    if (st < nst) {
      const int kb = k0 + st * KT, s = st % F_STAGES;
      float* xd = xs + s * TN * F_XLD;
      for (int i = threadIdx.x; i < TN * KT / 4; i += 256) {
        const int t = i / (KT / 4), c = i % (KT / 4), tok = t0 + t;
        const bool ok = tok < a.B && kb + 4 * c < k1;
        cp16(xd + t * F_XLD + 4 * c, a.x + (ok ? (long)tok * a.K + kb + 4 * c : 0), ok);
      }
      uint8_t* wd = ws + s * TMr * F_WLD;
      for (int i = threadIdx.x; i < TMr * KT / 32; i += 256) {
        const int r = i / (KT / 32), c = i % (KT / 32), row = m0 + r;
        const bool ok = row < a.M && kb + 32 * c < k1;
        cp16(wd + r * F_WLD + 16 * c, a.qw + (ok ? (long)row * KH + kb / 2 + 16 * c : 0), ok);
      }
    }
    cp_commit();
  };
  // stage st's x as (hi, hi, lo, lo) of each k pair (2p, 2p + 1), pair p at quad p
  auto split_stage = [&](int st) {
    const float* src = xs + (st % F_STAGES) * TN * F_XLD;
    float* dst = xc + (st & 1) * TN * F_CLD;
    for (int i = threadIdx.x; i < TN * KT / 4; i += 256) {
      const int t = i / (KT / 4), q = i % (KT / 4);
      const float4 v = *reinterpret_cast<const float4*>(src + t * F_XLD + 4 * q);
      const uint32_t h0 = tf32(v.x), h1 = tf32(v.y), h2 = tf32(v.z), h3 = tf32(v.w);
      *reinterpret_cast<uint4*>(dst + t * F_CLD + 8 * q) = make_uint4(
          h0, h1, tf32(v.x - __uint_as_float(h0)), tf32(v.y - __uint_as_float(h1)));
      *reinterpret_cast<uint4*>(dst + t * F_CLD + 8 * q + 4) = make_uint4(
          h2, h3, tf32(v.z - __uint_as_float(h2)), tf32(v.w - __uint_as_float(h3)));
    }
  };
#pragma unroll
  for (int st = 0; st < F_STAGES - 1; ++st) load_stage(st);
  const int G = a.K / a.group, g0 = k0 / a.group, ng = (k1 - 1) / a.group - g0 + 1;
  for (int i = threadIdx.x; i < TMr * ng; i += 256) {
    const int r = i / ng, g = i % ng, row = m0 + r;
    sc[r * a.ngs + g] = row < a.M ? a.scales[(long)row * G + g0 + g] : __float2bfloat16(0.f);
  }
  cp_wait<F_STAGES - 2>();
  __syncthreads();
  split_stage(0);

  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int c = 0; c < FN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  const int rl = wr * FM * 16 + gid;  // local rows rl + 16 i and + 8
  const int tl = wc * FN * 8 + gid;   // local tokens tl + 8 c
  float s[FM][2];                     // the rows' scales in the current group
  int gnext = (g0 + 1) * a.group, gl = 0;
  auto load_scales = [&]() {
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      s[i][0] = __bfloat162float(sc[(rl + 16 * i) * a.ngs + gl]);
      s[i][1] = __bfloat162float(sc[(rl + 16 * i + 8) * a.ngs + gl]);
    }
  };
  load_scales();
  for (int st = 0; st < nst; ++st) {
    cp_wait<F_STAGES - 3>();  // stage st + 1 is in
    __syncthreads();          // ... for every thread; stage st's split is done
    load_stage(st + F_STAGES - 1);
    if (st + 1 < nst) split_stage(st + 1);
    const float* xcb = xc + (st & 1) * TN * F_CLD;
    const uint8_t* wsb = ws + (st % F_STAGES) * TMr * F_WLD;
    const int kb = k0 + st * KT;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      if (kb + 8 * j >= k1) break;  // a short last stage
      if (kb + 8 * j == gnext) {  // a new group: its scales
        ++gl;
        gnext += a.group;
        load_scales();
      }
      uint32_t af[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const uint32_t w0 =
            *reinterpret_cast<const uint32_t*>(wsb + (rl + 16 * i) * F_WLD + 4 * j) ^ 0x88888888u;
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(wsb + (rl + 16 * i + 8) * F_WLD + 4 * j) ^
            0x88888888u;
        af[i][0] = weight_tf32(w0 >> (8 * tig), s[i][0]);      // (row, k 8j + 2 tig): label tig
        af[i][1] = weight_tf32(w1 >> (8 * tig), s[i][1]);      // (row + 8, the same k)
        af[i][2] = weight_tf32(w0 >> (8 * tig + 4), s[i][0]);  // (row, k + 1): label tig + 4
        af[i][3] = weight_tf32(w1 >> (8 * tig + 4), s[i][1]);
      }
#pragma unroll
      for (int c = 0; c < FN; ++c) {
        const uint4 b = *reinterpret_cast<const uint4*>(xcb + (tl + 8 * c) * F_CLD +
                                                        4 * (4 * j + tig));
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          mma_tf32(acc[i][c], af[i], b.z, b.w);  // w x_lo
          mma_tf32(acc[i][c], af[i], b.x, b.y);  // w x_hi
        }
      }
    }
  }
  cp_wait<0>();
  // the receive buffer reuses the ring: every CTA of the cluster is done with its own first
  if (a.splits > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int c = 0; c < FN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red.push(acc[i][c][e], tl - gid + 8 * c + 2 * tig + (e & 1), rl + 16 * i + (e >= 2 ? 8 : 0));
  red.finish();
}

// Raises a kernel's dynamic shared-memory limit to `bytes` the first time a
// launch needs more than it was set to (the attribute is kept between calls),
// and lets it run in clusters of up to 16 CTAs (8 is the portable limit).
template <typename Kernel>
cudaError_t kernel_limits(Kernel* kernel, int bytes, int& set) {
  if (set == 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    set = 48 * 1024;
  }
  if (bytes <= set) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) set = bytes;
  return e;
}

// a K-slice plan (splits slices of per_k, the last possibly shorter, at most
// one cluster of them) that covers K exactly once, in whole 32-k runs, with
// ngs scale slots enough for the groups any slice touches
bool plan_ok(int K, int group, int splits, int per_k, int ngs) {
  return splits >= 1 && splits <= MAX_SPLITS && per_k > 0 && per_k % 32 == 0 &&
         (long)(splits - 1) * per_k < K && (long)splits * per_k >= K &&
         ngs >= (per_k + group - 1) / group + (per_k % group != 0);
}

// `kernel` on `grid`, the CTAs of a cluster along the grid's K-slice axis
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel* kernel, dim3 grid, dim3 cluster, int threads, int smem,
                             cudaStream_t st, const Args&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster.x;
  attr.val.clusterDim.y = cluster.y;
  attr.val.clusterDim.z = cluster.z;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int NT, bool WHOLE>
cudaError_t launch_gemv(const GemvArgs& a, int warps, cudaStream_t st) {
  static int set = 0;
  const int smem = 8 * NT * (a.per_k + GV_XPAD) * 2 + warps * 16 * a.ngs * 2 + 16 +
                   8 * NT * warps * 16 * 4 + 4 * MAX_SPLITS;  // x, scales, receive buffer
  const cudaError_t e = kernel_limits(int4_gemv_kernel<NT, WHOLE>, smem, set);
  if (e != cudaSuccess) return e;
  return launch_clustered(int4_gemv_kernel<NT, WHOLE>,
                          dim3((a.M + warps * 16 - 1) / (warps * 16), a.splits),
                          dim3(1, a.splits, 1), warps * 32, smem, st, a);
}

template <int NT>
cudaError_t launch_gemv(const GemvArgs& a, int warps, cudaStream_t st) {
  return a.group % 128 == 0 && a.per_k % a.group == 0 ? launch_gemv<NT, true>(a, warps, st)
                                                      : launch_gemv<NT, false>(a, warps, st);
}

template <int FM, int FN, int KT>
cudaError_t launch_f32(const F32Args& a, cudaStream_t st) {
  static int set = 0;
  const int tm = 16 * FM * a.wm, tn = 8 * FN * (8 / a.wm);
  const int smem = max(FLd<KT>::STAGES * (tn * FLd<KT>::X * 4 + tm * FLd<KT>::W) +
                           2 * tn * FLd<KT>::C * 4 + tm * a.ngs * 2,
                       tm * tn * 4 + 4 * MAX_SPLITS);  // the receive buffer reuses it
  const cudaError_t e = kernel_limits(int4_f32_kernel<FM, FN, KT>, smem, set);
  if (e != cudaSuccess) return e;
  return launch_clustered(int4_f32_kernel<FM, FN, KT>,
                          dim3((a.M + tm - 1) / tm, (a.B + tn - 1) / tn, a.splits),
                          dim3(1, 1, a.splits), 256, smem, st, a);
}

}  // namespace

// f32 x (B, K) -> f32 out (B, M) in one launch: tiles of 16 fm wm rows x 8 fn
// (8 / wm) tokens over `splits` K-slices of `per_k` (one cluster a tile)
extern "C" int rt_int4_matmul_f32(const void* x, const void* qweight, const void* scales,
                                  const void* ep_scale, const void* ep_bias,
                                  const void* residual, void* out, int B, int K, int M,
                                  int group, int act, int fm, int fn, int wm, int splits,
                                  int per_k, int ngs, void* stream) {
  if (B == 0) return 0;
  if (K % 32 || group % 16 || K % group || !plan_ok(K, group, splits, per_k, ngs) ||
      (wm != 1 && wm != 2 && wm != 4 && wm != 8))
    return (int)cudaErrorInvalidValue;
  const F32Args a{(const float*)x, (const uint8_t*)qweight, (const __nv_bfloat16*)scales,
                  (const float*)ep_scale, (const float*)ep_bias, (const float*)residual,
                  (float*)out, B, K, M, group, act, splits, per_k, ngs, wm};
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 16) {  // decode: deep stages
    if (fm == 1 && fn == 1) return (int)launch_f32<1, 1, 256>(a, st);
    if (fm == 1 && fn == 2) return (int)launch_f32<1, 2, 256>(a, st);
  } else {
    if (fm == 1 && fn == 2) return (int)launch_f32<1, 2, 32>(a, st);
    if (fm == 2 && fn == 8) return (int)launch_f32<2, 8, 32>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 x (B, K) -> bf16 out (B, M).  gv_splits > 0: the split-K GEMV (B <=
// 48) with gv_warps warps a CTA over gv_splits K-slices of gv_per_k (one
// cluster a row tile); gv_splits == 0: the wgmma GEMM.
extern "C" int rt_int4_matmul(const void* x, const void* qweight, const void* scales,
                              const void* ep_scale, const void* ep_bias, const void* residual,
                              void* out, int B, int K, int M, int group, int act, int gv_warps,
                              int gv_splits, int gv_per_k, int gv_ngs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const auto* xp = (const __nv_bfloat16*)x;
  const auto* qp = (const uint8_t*)qweight;
  const auto* sp = (const __nv_bfloat16*)scales;
  const auto* es = (const float*)ep_scale;
  const auto* eb = (const float*)ep_bias;
  const auto* rp = (const __nv_bfloat16*)residual;
  auto* op = (__nv_bfloat16*)out;
  if (B == 0) return 0;
  if (gv_splits > 0) {  // decode: the split-K GEMV
    if (B > 8 * GV_MAX_NT || K % 32 || group % 16 || K % group ||
        !plan_ok(K, group, gv_splits, gv_per_k, gv_ngs) ||
        (gv_warps != 1 && gv_warps != 2 && gv_warps != 4 && gv_warps != 8))
      return (int)cudaErrorInvalidValue;
    const GemvArgs a{xp, qp, sp, es, eb, rp, op, B, K, M, group, act, gv_splits, gv_per_k,
                     gv_ngs};
    switch ((B + 7) / 8) {
      case 1: return (int)launch_gemv<1>(a, gv_warps, st);
      case 2: return (int)launch_gemv<2>(a, gv_warps, st);
      case 3: return (int)launch_gemv<3>(a, gv_warps, st);
      case 4: return (int)launch_gemv<4>(a, gv_warps, st);
      case 5: return (int)launch_gemv<5>(a, gv_warps, st);
      default: return (int)launch_gemv<6>(a, gv_warps, st);
    }
  }
  CUtensorMap tmx, tmw;
  if (!tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, B, KS, MM_BT,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qweight, K / 2, M, MM_KS / 2, MM_BN,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is set once, not per launch
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int4_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int vec = M % 8 == 0 && ((uintptr_t)out & 15) == 0 && ((uintptr_t)residual & 15) == 0;
  dim3 grid((M + MM_BN - 1) / MM_BN, (B + MM_BT - 1) / MM_BT);
  int4_wgmma_kernel<<<grid, MM_THREADS, MM_SMEM, st>>>(tmx, tmw, sp, es, eb, rp, op, B, K, M,
                                                       group, act, vec);
  return (int)cudaGetLastError();
}


// packed (rows, 32) uint8 -> out (rows, 64) bf16 through the prefill kernel's
// nibble conversion
extern "C" int rt_int4_unpack(const void* packed, void* out, int rows, void* stream) {
  if (rows == 0) return 0;
  int4_unpack_kernel<<<(rows + 7) / 8, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (__nv_bfloat16*)out, rows);
  return (int)cudaGetLastError();
}
