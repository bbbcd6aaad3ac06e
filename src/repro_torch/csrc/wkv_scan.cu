// RWKV6 wkv recurrence over a per-(slot, head) matrix state S (hd x hd):
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// Replaces: src/repro/kernels/scan_wkv.py::wkv_scan_pallas (grid (slot, head),
// the state resident on chip; prefill walks 16-step chunks of the
// chunked-parallel form with each step's log-decay clipped at -4.9, _kernel
// :62-97; decode is one exact step).
//
// What bounds it on the H100: the bytes.  At rwkv6-7b's serve shapes (B 8,
// H 64, hd 64) a 256-token prefill chunk reads r, k, v (bf16) and w (f32) and
// writes y (f32): ~134 MB, 0.040 ms at 3.35 TB/s; a decode step reads and
// writes the f32 state (2 x 8.4 MB) for ~7 FLOP an element.  Walking the 256
// steps one after another cannot reach that: each step is a dependent update
// of the whole state, so a serial walk is bound by its chain of steps.
//
// Prefill design (wkv_chunked, S > 1): the reference's chunked form, 16 steps
// a chunk, exactly as repro.kernels.ref.wkv_chunked: with
// la = clip(log max(w, 1e-38), -4.9, 0) and its inclusive / exclusive sums
// la_inc / la_exc in the chunk (la_end the last),
//   r~ = r e^{la_exc}, k~ = k e^{-la_inc}, k_end = k e^{la_end - la_inc},
//   y  = tril_{-1}(r~ k~^T) v + (sum r u k) v + r~ S,
//   S <- diag(e^{la_end}) S + k_end^T v,
// so a chunk is four small matrix products and the chain from chunk to chunk
// is one state update.  One CTA per (slot, head), 4 warps.  S^T lives in registers for the whole call as mma accumulators,
// warp w owning state columns [16w, 16w + 16): the update k_end^T v
// accumulates into it and it is read back as the A operand of r~ S (the
// accumulator layout holds i = 2 tig, 2 tig + 1 of each 8-wide block, so that
// product permutes its inner index the same way in both operands).  The
// chunk's inputs arrive by cp.async into a double-buffered stage, the next
// chunk loading while this one computes, so no global load sits on the
// chain.  The products run mma.sync m16n8k8 in TF32 with the 3xTF32 split
// (a_hi b_hi + a_hi b_lo + a_lo b_hi, hi = cvt.rna.tf32(x), lo = the rest):
// f32 accuracy (y within 1e-4 of max|y|, which one TF32 pass misses); bf16 v
// is exact in TF32, so its products take two passes.  Ragged tails and
// padding steps (pos -1) are identity steps (k = 0, w = 1) inside the chunk,
// and a chunk with no real step leaves S untouched, so an idle f32 slot keeps
// its state bitwise.
//
// Decode design (wkv_step, S = 1): one CTA per (slot, head), one thread per
// state column j holding S[:, j] in registers; y_j = sum_i r_i (S_ij + u_i k_i
// v_j) down the thread's own column, then the exact update with the raw w.  A
// padding step skips the update, so the state passes through bitwise.
//
// int8 state (both): dequantized at entry (q * scale); at exit the CTA
// reduces amax over the hd x hd state, scale = max(amax, 1e-8) / 127 and
// q = rint(s / scale) (round half to even, as jnp.round); a slot with no
// real step this call writes back its stored payload and scale unchanged.
#include "common.cuh"

namespace {

// kernels/scan_wkv.py WKV_LOG_DECAY_FLOOR (-4.9) in base 2: -4.9 * log2(e)
constexpr float LOG2_DECAY_FLOOR = -4.9f * 1.4426950408889634f;

// ---- decode: one exact step ---------------------------------------------------
template <int HD>
__device__ __forceinline__ float wkv_step_col(float (&st)[HD], const float* r, const float* k,
                                              const float* w, const float* u, float vj,
                                              bool update) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    const float kv = k[i] * vj;
    acc = fmaf(r[i], fmaf(u[i], kv, st[i]), acc);
    if (update) st[i] = fmaf(w[i], st[i], kv);
  }
  return acc;
}

// int8 exit of the step kernel: amax over the CTA's hd x hd state, scale =
// max(amax, 1e-8) / 127, q = rint(s / scale); a slot with no real step
// (`updated` false) keeps its stored payload and scale bitwise.
template <int HD>
__device__ __forceinline__ void store_quantized(const float (&st)[HD], const int8_t* s0,
                                                const float* sc0, int8_t* s1, float* sc1,
                                                long sbase, long row, int j, bool updated,
                                                float* red) {
  constexpr int NW = (HD + 31) / 32;
  if (!updated) {
    for (int i = 0; i < HD; ++i) s1[sbase + (long)i * HD + j] = s0[sbase + (long)i * HD + j];
    if (j == 0) sc1[row] = sc0[row];
    return;
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < HD; ++i) amax = fmaxf(amax, fabsf(st[i]));
  constexpr unsigned MASK = HD >= 32 ? 0xffffffffu : ((1u << HD) - 1u);
#pragma unroll
  for (int off = (HD >= 32 ? 16 : HD / 2); off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(MASK, amax, off));
  if ((j & 31) == 0) red[j >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int q = 1; q < NW; ++q) amax = fmaxf(amax, red[q]);
  const float sc = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
  for (int i = 0; i < HD; ++i)
    s1[sbase + (long)i * HD + j] = (int8_t)(int)rintf(st[i] / sc);
  if (j == 0) sc1[row] = sc;
}

template <int HD, typename TI, typename TS>
__global__ void __launch_bounds__(HD)
wkv_step(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
         const float* __restrict__ w, const float* __restrict__ u, const int* __restrict__ pos,
         const TS* __restrict__ s0, const float* __restrict__ sc0, float* __restrict__ y,
         TS* __restrict__ s1, float* __restrict__ sc1, int H) {
  constexpr bool QUANT = sizeof(TS) == 1;
  constexpr int NW = (HD + 31) / 32;
  __shared__ float rs[HD], ks[HD], ws[HD], us[HD];
  __shared__ float red[NW];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long sbase = ((long)b * H + h) * HD * HD;
  const bool real = pos == nullptr || pos[b] >= 0;
  const long g = ((long)b * H + h) * HD + j;
  rs[j] = to_f(r[g]);
  ks[j] = real ? to_f(k[g]) : 0.0f;
  ws[j] = real ? w[g] : 1.0f;
  us[j] = u[(long)h * HD + j];
  const float scale_in = QUANT ? sc0[(long)b * H + h] : 1.0f;
  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    st[i] = to_f(s0[sbase + (long)i * HD + j]);
    if (QUANT) st[i] *= scale_in;
  }
  __syncthreads();
  y[g] = wkv_step_col<HD>(st, rs, ks, ws, us, to_f(v[g]), real);
  if constexpr (!QUANT) {
#pragma unroll
    for (int i = 0; i < HD; ++i) s1[sbase + (long)i * HD + j] = st[i];
  } else {
    store_quantized<HD>(st, s0, sc0, s1, sc1, sbase, (long)b * H + h, j, real, red);
  }
}

// ---- prefill: the chunked form on the tensor cores ----------------------------
constexpr int WC = 16;  // steps a chunk (kernels/scan_wkv.py WKV_CHUNK)
constexpr int CW = 4;   // warps a chunked CTA

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t t;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(t) : "f"(x));
  return t;
}
// x = hi + lo with hi and lo in TF32: the 3xTF32 split
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in 3xTF32, the small terms first; ``a_exact``: a is TF32 (lo = 0)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2], bool a_exact) {
  if (!a_exact) mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

template <int HD, typename TI>
struct ChunkSmem {
  static constexpr int RS = HD + 8;  // padded row of the prepared operands (32-bit words)
  static constexpr int AS = WC + 4;  // padded row of A
  TI r[2][WC][HD], k[2][WC][HD], v[2][WC][HD];  // the double-buffered stage
  float w[2][WC][HD];
  int pos[2][WC];
  float lai[WC][HD];                // la_inc, in base 2
  uint32_t rh[WC][RS], rl[WC][RS];  // r~ split (hi, lo): read by every warp, split once
  uint32_t eh[WC][RS], el[WC][RS];  // k_end split
  float kt[WC][RS];                 // k~
  uint32_t ah[WC][AS], al[WC][AS];  // tril_{-1}(r~ k~^T) split
  float lend[HD];                   // e^{la_end}
  float u[HD];
  float dg[WC];                     // sum_i r u k
  int any_real;
  float red[CW];
};

// r/k/v/w (B, S, H, HD); y (B, S, H, HD) f32; state (B, H, HD, HD); grid (H, B).
template <int HD, typename TI, typename TS>
__global__ void __launch_bounds__(CW * 32)
wkv_chunked(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const int* __restrict__ pos, const TS* __restrict__ s0,
            const float* __restrict__ sc0, float* __restrict__ y, TS* __restrict__ s1,
            float* __restrict__ sc1, int S, int H) {
  constexpr bool QUANT = sizeof(TS) == 1;
  constexpr bool V_EXACT = sizeof(TI) == 2;  // bf16 is exact in TF32
  constexpr int NSLAB = HD / 16;             // 16-column slabs of the state
  static_assert(CW == 4, "warps 0-1 compute A, 2-3 the bonus sums");
  constexpr int EPT = WC * HD / (CW * 32);   // steps a thread in the prep
  constexpr int NT = HD / 8;                 // 8-wide blocks of i
  constexpr int RCH = HD * (int)sizeof(TI) / 16;  // 16-byte pieces a r/k/v row
  constexpr int WCH = HD * 4 / 16;                // ... a w row
  using Sm = ChunkSmem<HD, TI>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool owner = warp < NSLAB;
  const int j0 = warp * 16;  // this warp's 16 state columns
  const long bh = (long)b * H + h;
  const long sbase = bh * HD * HD;
  const int nchunk = (S + WC - 1) / WC;

  auto issue = [&](int c) {  // chunk c's inputs into stage c % 2
    const int st = c & 1, t0 = c * WC;
    for (int i = tid; i < WC * RCH; i += CW * 32) {
      const int t = i / RCH, p = (i % RCH) * (16 / (int)sizeof(TI));
      const bool ok = t0 + t < S;
      const long g = ((long)b * S + (ok ? t0 + t : 0)) * H * HD + (long)h * HD + p;
      cp16(&sm.r[st][t][p], r + g, ok);
      cp16(&sm.k[st][t][p], k + g, ok);
      cp16(&sm.v[st][t][p], v + g, ok);
    }
    for (int i = tid; i < WC * WCH; i += CW * 32) {
      const int t = i / WCH, p = (i % WCH) * 4;
      const bool ok = t0 + t < S;
      cp16(&sm.w[st][t][p], w + ((long)b * S + (ok ? t0 + t : 0)) * H * HD + (long)h * HD + p,
           ok);
    }
    if (tid < WC) {
      const bool ok = t0 + tid < S;
      if (pos) cp4(&sm.pos[st][tid], pos + (long)b * S + (ok ? t0 + tid : 0), ok);
      else sm.pos[st][tid] = 0;
    }
    cp_commit();
  };

  // S^T as accumulators: sa[n][e] holds S[i][j], i = 8n + 2 tig + (e & 1),
  // j = j0 + gid + 8 (e >> 1)
  float sa[NT][4];
  const float scale_in = QUANT ? sc0[bh] : 1.0f;
  if (owner) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + 2 * tig + (e & 1), j = j0 + gid + 8 * (e >> 1);
        sa[n][e] = to_f(s0[sbase + (long)i * HD + j]) * scale_in;
      }
  }
  for (int i = tid; i < HD; i += CW * 32) sm.u[i] = u[(long)h * HD + i];
  issue(0);
  bool saw_real = false;

  for (int c = 0; c < nchunk; ++c) {
    const int st = c & 1, t0 = c * WC;
    cp_wait_all();
    __syncthreads();  // chunk c has landed; chunk c - 1 is consumed
    if (c + 1 < nchunk) issue(c + 1);
    // (a) the clipped log decays and their inclusive sums, a thread a channel,
    //     in base 2 (lg2 / ex2: an absolute error of ~2^-22 in the exponent)
    if (tid < HD) {
      float la = 0.f;
#pragma unroll
      for (int t = 0; t < WC; ++t) {
        const bool real = t0 + t < S && sm.pos[st][t] >= 0;
        const float lw =
            real ? fminf(fmaxf(__log2f(fmaxf(sm.w[st][t][tid], 1e-38f)), LOG2_DECAY_FLOOR), 0.f)
                 : 0.f;
        la += lw;
        sm.lai[t][tid] = la;
      }
      sm.lend[tid] = exp2f(la);
    } else if (tid == HD) {
      int any = 0;
#pragma unroll
      for (int t = 0; t < WC; ++t) any |= t0 + t < S && sm.pos[st][t] >= 0;
      sm.any_real = any;
    }
    __syncthreads();
    // (b) r~ and k_end split into TF32 pairs, k~; a thread a channel and
    //     EPT steps, neighbouring lanes on neighbouring channels (no bank
    //     conflicts)
    {
      const int i = tid % HD, tb = (tid / HD) * EPT;
      const float le = sm.lai[WC - 1][i];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int t = tb + e;
        const bool real = t0 + t < S && sm.pos[st][t] >= 0;
        const float li = sm.lai[t][i], lx = t ? sm.lai[t - 1][i] : 0.f;
        const float kv = real ? to_f(sm.k[st][t][i]) : 0.f;
        split_tf32(to_f(sm.r[st][t][i]) * exp2f(lx), sm.rh[t][i], sm.rl[t][i]);
        split_tf32(kv * exp2f(le - li), sm.eh[t][i], sm.el[t][i]);
        sm.kt[t][i] = kv * exp2f(-li);
      }
    }
    __syncthreads();
    // (c) warps 0 and 1: A = r~ k~^T (16 x 16), warp w its columns [8w, 8w + 8),
    //     the inner index permuted (k slot tig <-> i = 2 tig, tig + 4 <-> 2 tig + 1),
    //     then masked to t > s and split; warps 2 and 3: the bonus sums
    if (warp < 2) {
      float acc[2][4] = {};
      const int s = warp * 8 + gid;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const int ib = kk * 8 + 2 * tig;
        const uint32_t ah[4] = {sm.rh[gid][ib], sm.rh[gid + 8][ib], sm.rh[gid][ib + 1],
                                sm.rh[gid + 8][ib + 1]};
        const uint32_t al[4] = {sm.rl[gid][ib], sm.rl[gid + 8][ib], sm.rl[gid][ib + 1],
                                sm.rl[gid + 8][ib + 1]};
        uint32_t bh2[2], bl2[2];
        split_tf32(sm.kt[s][ib], bh2[0], bl2[0]);
        split_tf32(sm.kt[s][ib + 1], bh2[1], bl2[1]);
        mma3(acc[kk & 1], ah, al, bh2, bl2, false);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = gid + 8 * (e >> 1), sc = warp * 8 + 2 * tig + (e & 1);
        split_tf32(t > sc ? acc[0][e] + acc[1][e] : 0.f, sm.ah[t][sc], sm.al[t][sc]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < WC / 2; ++q) {
        const int t = (warp - 2) * (WC / 2) + q;
        const bool real = t0 + t < S && sm.pos[st][t] >= 0;
        float d = 0.f;
        for (int i = lane; i < HD; i += 32)
          d = fmaf(to_f(sm.r[st][t][i]) * sm.u[i], real ? to_f(sm.k[st][t][i]) : 0.f, d);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (lane == 0) sm.dg[t] = d;
      }
    }
    __syncthreads();
    // (d) the owners of state columns: y, then the state update
    if (owner) {
      saw_real |= sm.any_real != 0;
      // v^T as the A operand (rows j, inner index the step s), both k steps
      uint32_t vh[2][4], vl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = kk * 8 + tig + 4 * (e >> 1), j = j0 + gid + 8 * (e & 1);
          const float x = to_f(sm.v[st][s][j]);
          if (V_EXACT) {
            vh[kk][e] = __float_as_uint(x);
            vl[kk][e] = 0u;
          } else {
            split_tf32(x, vh[kk][e], vl[kk][e]);
          }
        }
      // y^T (16 columns x 16 steps) = v^T tril(A)^T + diag v + S^T r~^T
      float ya[2][4] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t bh2[2], bl2[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int s = kk * 8 + tig + 4 * q, t = nt * 8 + gid;
            bh2[q] = sm.ah[t][s];
            bl2[q] = sm.al[t][s];
          }
          mma3(ya[nt], vh[kk], vl[kk], bh2, bl2, V_EXACT);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = nt * 8 + 2 * tig + (e & 1), j = j0 + gid + 8 * (e >> 1);
          ya[nt][e] = fmaf(sm.dg[t], to_f(sm.v[st][t][j]), ya[nt][e]);
        }
      }
      float yb[2][2][4] = {};  // S^T r~^T, two chains by the parity of n
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t ah[4], al[4];
        split_tf32(sa[n][0], ah[0], al[0]);  // (j = gid, i = 8n + 2 tig)
        split_tf32(sa[n][2], ah[1], al[1]);  // (j = gid + 8, i = 8n + 2 tig)
        split_tf32(sa[n][1], ah[2], al[2]);  // (j = gid, i = 8n + 2 tig + 1)
        split_tf32(sa[n][3], ah[3], al[3]);  // (j = gid + 8, i = 8n + 2 tig + 1)
        const int ib = n * 8 + 2 * tig;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int t = nt * 8 + gid;
          const uint32_t bh2[2] = {sm.rh[t][ib], sm.rh[t][ib + 1]};
          const uint32_t bl2[2] = {sm.rl[t][ib], sm.rl[t][ib + 1]};
          mma3(yb[n & 1][nt], ah, al, bh2, bl2, false);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = nt * 8 + 2 * tig + (e & 1), j = j0 + gid + 8 * (e >> 1);
          if (t0 + t < S)
            y[((long)b * S + t0 + t) * H * HD + (long)h * HD + j] =
                ya[nt][e] + (yb[0][nt][e] + yb[1][nt][e]);
        }
      // S <- diag(e^{la_end}) S + k_end^T v, skipped for a chunk of padding only
      if (sm.any_real) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float e0 = sm.lend[8 * n + 2 * tig], e1 = sm.lend[8 * n + 2 * tig + 1];
          sa[n][0] *= e0;
          sa[n][1] *= e1;
          sa[n][2] *= e0;
          sa[n][3] *= e1;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int i = n * 8 + gid, s = kk * 8 + tig;
            const uint32_t bh2[2] = {sm.eh[s][i], sm.eh[s + 4][i]};
            const uint32_t bl2[2] = {sm.el[s][i], sm.el[s + 4][i]};
            mma3(sa[n], vh[kk], vl[kk], bh2, bl2, V_EXACT);
          }
        }
      }
    }
  }

  if constexpr (!QUANT) {
    if (owner) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * n + 2 * tig + (e & 1), j = j0 + gid + 8 * (e >> 1);
          s1[sbase + (long)i * HD + j] = sa[n][e];
        }
    }
  } else {
    const bool updated = __syncthreads_or(saw_real);
    if (!updated) {
      for (int i = tid; i < HD * HD; i += CW * 32) s1[sbase + i] = s0[sbase + i];
      if (tid == 0) sc1[bh] = sc0[bh];
      return;
    }
    float amax = 0.f;
    if (owner) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(sa[n][e]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) sm.red[warp] = amax;
    __syncthreads();
#pragma unroll
    for (int x = 0; x < CW; ++x) amax = fmaxf(amax, sm.red[x]);
    const float sc = fmaxf(amax, 1e-8f) / 127.0f;
    if (owner) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * n + 2 * tig + (e & 1), j = j0 + gid + 8 * (e >> 1);
          s1[sbase + (long)i * HD + j] = (int8_t)(int)rintf(sa[n][e] / sc);
        }
    }
    if (tid == 0) sc1[bh] = sc;
  }
}

template <int HD, typename TI, typename TS>
int launch_hd(const void* r, const void* k, const void* v, const float* w, const float* u,
              const int* pos, const void* s0, const float* sc0, float* y, void* s1, float* sc1,
              int B, int S, int H, cudaStream_t st) {
  if (S == 1) {
    wkv_step<HD, TI, TS><<<dim3(H, B), HD, 0, st>>>((const TI*)r, (const TI*)k, (const TI*)v, w,
                                                    u, pos, (const TS*)s0, sc0, y, (TS*)s1,
                                                    sc1, H);
    return (int)cudaGetLastError();
  }
  constexpr int smem = (int)sizeof(ChunkSmem<HD, TI>);
  auto kern = wkv_chunked<HD, TI, TS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)  // all of the SM's shared memory: room for 4 CTAs
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(H, B), CW * 32, smem, st>>>((const TI*)r, (const TI*)k, (const TI*)v, w, u, pos,
                                          (const TS*)s0, sc0, y, (TS*)s1, sc1, S, H);
  return (int)cudaGetLastError();
}

template <typename TI, typename TS>
int launch_typed(const void* r, const void* k, const void* v, const float* w, const float* u,
                 const int* pos, const void* s0, const float* sc0, float* y, void* s1,
                 float* sc1, int B, int S, int H, int HD, cudaStream_t st) {
  if (HD == 16)
    return launch_hd<16, TI, TS>(r, k, v, w, u, pos, s0, sc0, y, s1, sc1, B, S, H, st);
  if (HD == 32)
    return launch_hd<32, TI, TS>(r, k, v, w, u, pos, s0, sc0, y, s1, sc1, B, S, H, st);
  if (HD == 64)
    return launch_hd<64, TI, TS>(r, k, v, w, u, pos, s0, sc0, y, s1, sc1, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r, k, v (B, S, H, hd) of in_dtype (f32 | bf16), 16-byte aligned; w (B, S, H,
// hd) f32; u (H, hd) f32; pos (B, S) int32 or null (every step real); s0
// (B, H, hd, hd) of state_dtype (f32 | int8) with sc0 (B, H) f32 for int8
// (else null); outputs y (B, S, H, hd) f32, s1 like s0, sc1 like sc0.  S == 1
// takes the exact step with the raw w, S > 1 the chunked form with the
// floored decay.  hd in {16, 32, 64}.
extern "C" int rt_wkv_scan(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* pos, const void* s0, const void* sc0,
                           void* y, void* s1, void* sc1, int B, int S, int H, int HD,
                           int in_dtype, int state_dtype, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float *wf = (const float*)w, *uf = (const float*)u, *scf = (const float*)sc0;
  const int* p = (const int*)pos;
  float *yf = (float*)y, *sc1f = (float*)sc1;
  const bool bf = in_dtype == RT_BF16, q = state_dtype == RT_I8;
  if ((in_dtype != RT_F32 && !bf) || (state_dtype != RT_F32 && !q) || (q && !sc0))
    return (int)cudaErrorInvalidValue;
  if (bf && q)
    return launch_typed<__nv_bfloat16, int8_t>(r, k, v, wf, uf, p, s0, scf, yf, s1, sc1f, B, S,
                                               H, HD, st);
  if (bf)
    return launch_typed<__nv_bfloat16, float>(r, k, v, wf, uf, p, s0, scf, yf, s1, sc1f, B, S,
                                              H, HD, st);
  if (q)
    return launch_typed<float, int8_t>(r, k, v, wf, uf, p, s0, scf, yf, s1, sc1f, B, S, H, HD,
                                       st);
  return launch_typed<float, float>(r, k, v, wf, uf, p, s0, scf, yf, s1, sc1f, B, S, H, HD,
                                    st);
}
