"""w4a16 matmul with the fused epilogue.

``int4_matmul`` runs the CUDA kernels (``csrc/int4_matmul.cu``: for bf16
activations a GEMV for B <= 16 tokens, a warp-specialized TMA + wgmma GEMM
above; for f32 activations, which the MoE router applies, a split-K SIMT
kernel computing in f32 and its reduce) on a CUDA tensor and the plain
version (dequantize to f32, f32 matmul) on a CPU tensor.  Replaces
``repro/kernels/int4_matmul.py::int4_matmul_pallas``, which takes either.

``unpack_magic`` is the prefill kernel's nibble conversion written in torch
(no float conversion: the nibble goes into a bf16 mantissa), which the CPU
tests hold against ``core.quant.unpack_int4``; ``unpack_on_card`` runs the
kernel's own conversion on a CUDA tensor.
"""
from __future__ import annotations

import math

import torch

from ..core.quant import dequantize_int4
from . import _build
from .epilogue import ACT_CODES, apply_epilogue

launches = 0          # kernel launches (1 a bf16 call, 2 an f32 call)
f32_launches = 0      # the f32-activation path's share of ``launches``
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


F32_TILE, F32_STEP = 64, 32  # csrc/int4_matmul.cu FT = FM, FK


def f32_splits(b: int, k: int, m: int) -> tuple[int, int]:
    """(splits, K steps a split) of the f32 path: K cut until the tiles make
    ~two CTAs an SM (264), at most one 32-deep step a split."""
    tiles = -(-b // F32_TILE) * -(-m // F32_TILE)
    steps = k // F32_STEP
    per = -(-steps // min(steps, max(1, -(-264 // tiles))))
    return -(-steps // per), per


def _int4_matmul_cuda(x, qweight, scales, group, scale, bias, residual, activation):
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
        raise ValueError("x and qweight must start 16-byte aligned (TMA), scales 4-byte")
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
    if x.dtype == torch.float32:
        splits, per = f32_splits(b, k, m)
        part = torch.empty(splits * b * m, dtype=torch.float32, device=x.device)
        err = _build.lib().rt_int4_matmul_f32(
            x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _build.ptr(scale),
            _build.ptr(bias), _build.ptr(residual), part.data_ptr(), out.data_ptr(), b, k, m,
            group, splits, per, ACT_CODES[activation], _build.stream(x))
        _build.check(err, "int4_matmul (f32)")
        launches += 2  # the partial tiles and their reduce
        f32_launches += 2
        return out
    err = _build.lib().rt_int4_matmul(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _build.ptr(scale),
        _build.ptr(bias), _build.ptr(residual), out.data_ptr(), b, k, m, group,
        ACT_CODES[activation], _build.stream(x))
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
