"""w4a16 matmul with the fused epilogue.

``int4_matmul`` runs the CUDA kernels (``csrc/int4_matmul.cu``) on a CUDA
tensor and the plain version (dequantize to f32, f32 matmul) on a CPU
tensor.  Replaces ``repro/kernels/int4_matmul.py::int4_matmul_pallas``,
which takes either.  One launch a call, by route:

- bf16 activations, B <= ``GEMV_MAX_B`` tokens: a split-K GEMV (weights the
  mma A operand, tokens the N side) over the K-slices ``gemv_plan`` picks,
  the slices of a row tile one thread block cluster that sums them in
  slice order through distributed shared memory;
- bf16, larger B: a warp-specialized TMA + wgmma GEMM;
- f32 activations (the MoE router): tiles on the tensor cores, the
  dequantized weights (exact in TF32) times x split into tf32 hi and lo in
  two TF32 passes (``f32_route_emulated`` writes the arithmetic in torch),
  over the K-slices ``f32_plan`` picks, reduced the same way.

``unpack_magic`` is the kernels' nibble conversion written in torch (no
float conversion: the nibble goes into a bf16 mantissa), which the CPU
tests hold against ``core.quant.unpack_int4``; ``unpack_on_card`` runs the
prefill kernel's own conversion on a CUDA tensor.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..core.quant import dequantize_int4
from . import _build
from .epilogue import ACT_CODES, apply_epilogue
from .scan_wkv import tf32_round

launches = 0          # kernel launches (one a call, either route)
f32_launches = 0      # the f32-activation route's share of ``launches``
plain_cuda_calls = 0

_MAGIC = 0x4300  # bf16 128.0: 0x4300 | u is 128 + u for u in [0, 16)
_MAGIC_BIAS = 136.0  # 128 + 8: u = nibble ^ 8 = q + 8


def unpack_magic(packed: torch.Tensor) -> torch.Tensor:
    """(…, K/2) uint8 -> (…, K) bf16, as the prefill kernel converts: each
    nibble XOR 8 into the mantissa of bf16 128.0, minus 136 in bf16 (exact:
    every value is an integer in [-8, 7]).  Low nibble = even k."""
    p = packed.to(torch.int32) ^ 0x88
    u = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(*p.shape[:-1], -1)
    bits = (u | _MAGIC).to(torch.int16)
    return bits.view(torch.bfloat16) - torch.tensor(_MAGIC_BIAS, dtype=torch.bfloat16)


def int4_matmul_ref(x, qweight, scales, group: int = 128, *, scale=None,
                    bias=None, residual=None, activation=None) -> torch.Tensor:
    """y = act(x @ dequant(qweight)ᵀ·scale + bias) + residual, in x.dtype."""
    global plain_cuda_calls
    plain_cuda_calls += x.is_cuda
    w = dequantize_int4({"qweight": qweight, "scales": scales}, dtype=torch.float32)
    y = torch.matmul(x.to(torch.float32), w.T)
    y = apply_epilogue(y, scale=scale, bias=bias, residual=residual,
                       activation=activation)
    return y.to(x.dtype)


WAVE = 132             # SMs of an H100
GEMV_MAX_B = 24        # B at or below it takes the GEMV, above it the GEMM (PERF.md §6)
GEMV_MAX_NT = 6        # csrc/int4_matmul.cu GV_MAX_NT: the GEMV takes B <= 48
GEMV_X_BYTES = 32768   # the staged x slice's shared memory, at most
MAX_SPLITS = 16        # csrc/int4_matmul.cu MAX_SPLITS: a tile's slices are one cluster
F32_SC_BYTES = 32768   # the f32 tile's staged scales, at most
F32_TURN_K = 1024      # a CTA's fixed cost in f32_plan, as K (development trials, PERF.md)


class SplitPlan(NamedTuple):
    """K cut into ``splits`` slices of ``per_k`` (the last may be shorter),
    each on a group boundary where the group fits the slice's cap, and
    ``ngs`` scale slots a row (the most groups a slice touches)."""
    splits: int
    per_k: int
    ngs: int

    def slices(self, k: int) -> list[tuple[int, int]]:
        return [(s * self.per_k, min(k, (s + 1) * self.per_k)) for s in range(self.splits)]


def _unit(group: int, cap_k: int) -> int:
    """The slices' step: whole groups (group 16 in pairs: whole 32-k runs),
    or 32 k when one group is deeper than a slice may be."""
    unit = group if group % 32 == 0 else 2 * group
    return unit if unit <= cap_k else 32


def _split(k: int, group: int, unit: int, per: int) -> SplitPlan:
    per_k = per * unit
    ngs = -(-per_k // group) + (per_k % group != 0)
    return SplitPlan(-(-k // per_k), per_k, ngs)


class GemvPlan(NamedTuple):
    warps: int      # warps a CTA, 16 weight rows each
    row_tiles: int  # CTAs along M (one cluster of slices each)
    split: SplitPlan

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.split.splits


@functools.lru_cache(maxsize=None)
def gemv_plan(b: int, k: int, m: int, group: int) -> GemvPlan:
    """The GEMV's grid: K slices of whole units (``_unit``, under the
    staged-x cap, at most MAX_SPLITS) and warps a CTA.  In order of
    preference: a wave of CTAs; CTAs of more than one warp; a power-of-two
    cluster of slices; four or eight warps a CTA; the fewest slices; the most
    warps.  (The development trials in PERF.md: more slices, one-warp CTAs,
    clusters of 3 or 6 and two-warp CTAs each cost time; fewer, deeper
    slices did not.)"""
    if not 0 < b <= 8 * GEMV_MAX_NT:
        raise ValueError(f"the GEMV takes 1 to {8 * GEMV_MAX_NT} tokens, got {b}")
    rb = -(-m // 16)
    cap_k = GEMV_X_BYTES // (2 * 8 * -(-b // 8))
    unit = _unit(group, cap_k)
    units = k // unit
    best = None
    for per in range(max(1, -(-units // MAX_SPLITS)), max(1, min(units, cap_k // unit)) + 1):
        splits = -(-units // per)
        for warps in (8, 4, 2, 1):
            ctas = -(-rb // warps) * splits
            key = (ctas < WAVE, warps == 1, splits & (splits - 1) != 0, warps < 4, splits,
                   -warps)
            if best is None or key < best[0]:
                best = (key, warps, per)
    _, warps, per = best
    return GemvPlan(warps, -(-rb // warps), _split(k, group, unit, per))


class F32Plan(NamedTuple):
    fm: int         # m16 tiles a warp
    fn: int         # n8 tiles a warp
    wm: int         # warps along M (8 / wm along the tokens)
    row_tiles: int
    token_tiles: int
    split: SplitPlan

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.token_tiles * self.split.splits


@functools.lru_cache(maxsize=None)
def f32_plan(b: int, k: int, m: int, group: int) -> F32Plan:
    """The f32 route's tiles: at B <= 16 a CTA of 128 weight rows x one or
    two n8 tiles (the kernel's deep 256-k stages); above, 128 rows x 128
    tokens (warp tiles 32 x 64), or for M <= 64 32 rows x 64 tokens; K
    slices (at most MAX_SPLITS) by the cost in the comment below."""
    if b <= 16:
        fm, fn, wm = 1, -(-b // 8), 8
    elif m > 64:
        fm, fn, wm = 2, 8, 4
    else:
        fm, fn, wm = 1, 2, 2
    rt, tt = -(-m // (16 * fm * wm)), -(-b // (8 * fn * (8 // wm)))
    cap_k = group * (F32_SC_BYTES // (32 * fm * wm))
    unit = _unit(group, cap_k)
    units = k // unit
    # the least K on the busiest SM (CTAs dealt out in turns, each turn also
    # paying a CTA's fixed cost), then the fewest slices
    per = min(range(max(1, -(-units // MAX_SPLITS)), max(1, min(units, cap_k // unit)) + 1),
              key=lambda p: (-(-rt * tt * -(-units // p) // WAVE) * (p * unit + F32_TURN_K),
                             -(-units // p)))
    sp = _split(k, group, unit, per)
    return F32Plan(fm, fn, wm, rt, tt, sp)


def f32_route_emulated(x, qweight, scales, group: int = 128) -> torch.Tensor:
    """The f32 route's arithmetic in torch: the weights w = q * scale (exact
    in TF32: at most 11 significant bits) times x_lo = tf32(x - x_hi), plus w
    times x_hi = tf32(x), the products summed in f32.  (B, K) f32 -> (B, M)
    f32, no epilogue."""
    w = dequantize_int4({"qweight": qweight, "scales": scales}, dtype=torch.float32)
    x = x.to(torch.float32)
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    return lo @ w.T + hi @ w.T


def _int4_matmul_cuda(x, qweight, scales, group, scale, bias, residual, activation):
    _build.refuse_grad("int4_matmul", x, scales, scale, bias, residual)
    global launches, f32_launches
    m, kh = qweight.shape
    k = kh * 2
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4_matmul kernel takes bf16 or f32 activations, got {x.dtype}")
    if x.shape[-1] != k or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (…, {k}); got {tuple(x.shape)}")
    if qweight.dtype != torch.uint8 or not qweight.is_cuda or not qweight.is_contiguous():
        raise ValueError("qweight must be a contiguous CUDA uint8 (M, K/2) tensor")
    if group % 16 or k % group or k % 32:
        raise ValueError(f"kernel needs group % 16 == 0 and K % 32 == 0 (K={k}, group={group})")
    if scales.shape != (m, k // group) or scales.dtype != torch.bfloat16 \
            or not scales.is_contiguous() or not scales.is_cuda:
        raise ValueError(f"scales must be contiguous CUDA bf16 {(m, k // group)}")
    if x.data_ptr() % 16 or qweight.data_ptr() % 16 or scales.data_ptr() % 4:
        raise ValueError("x and qweight must start 16-byte aligned, scales 4-byte")
    lead = x.shape[:-1]
    b = math.prod(lead)
    out = torch.empty(*lead, m, dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    if residual is not None:
        if residual.shape != out.shape or residual.dtype != x.dtype \
                or not residual.is_contiguous():
            raise ValueError("residual must be contiguous, shaped and typed like the output")
    scale = _build.epilogue_vector(scale, m, "scale")
    bias = _build.epilogue_vector(bias, m, "bias")
    ptrs = (x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _build.ptr(scale),
            _build.ptr(bias), _build.ptr(residual), out.data_ptr())
    if x.dtype == torch.float32:
        plan = f32_plan(b, k, m, group)
        sp = plan.split
        err = _build.lib().rt_int4_matmul_f32(
            *ptrs, b, k, m, group, ACT_CODES[activation], plan.fm, plan.fn, plan.wm, sp.splits,
            sp.per_k, sp.ngs, _build.stream(x))
        _build.check(err, "int4_matmul (f32)")
        launches += 1
        f32_launches += 1
        return out
    if b <= GEMV_MAX_B:
        plan = gemv_plan(b, k, m, group)
        gemv = (plan.warps, plan.split.splits, plan.split.per_k, plan.split.ngs)
    else:
        gemv = (0, 0, 0, 0)
    err = _build.lib().rt_int4_matmul(*ptrs, b, k, m, group, ACT_CODES[activation], *gemv,
                                      _build.stream(x))
    _build.check(err, "int4_matmul")
    launches += 1
    return out


def unpack_on_card(packed: torch.Tensor) -> torch.Tensor:
    """(rows, 32) uint8 on the card -> (rows, 64) bf16 through the prefill
    kernel's own nibble conversion (for its card test)."""
    if packed.dtype != torch.uint8 or packed.dim() != 2 or packed.shape[1] != 32 \
            or not packed.is_cuda or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous CUDA (rows, 32) uint8 tensor")
    out = torch.empty(packed.shape[0], 64, dtype=torch.bfloat16, device=packed.device)
    _build.check(_build.lib().rt_int4_unpack(packed.data_ptr(), out.data_ptr(),
                                             packed.shape[0], _build.stream(packed)),
                 "int4_unpack")
    return out


def int4_matmul(x, qweight, scales, group: int = 128, *, scale=None, bias=None,
                residual=None, activation=None) -> torch.Tensor:
    """(…, K) -> (…, M): the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if not x.is_cuda:
        return int4_matmul_ref(x, qweight, scales, group, scale=scale, bias=bias,
                               residual=residual, activation=activation)
    return _int4_matmul_cuda(x, qweight, scales, group, scale, bias, residual,
                             activation)
