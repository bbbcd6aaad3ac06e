"""w4a16 matmul with the fused epilogue.

``int4_matmul`` runs the CUDA kernel (``csrc/int4_matmul.cu``) on a CUDA
tensor and the plain version (dequantize to f32, f32 matmul) on a CPU
tensor.  Replaces ``repro/kernels/int4_matmul.py::int4_matmul_pallas``.
"""
from __future__ import annotations

import math

import torch

from ..core.quant import dequantize_int4
from . import _build
from .epilogue import ACT_CODES, apply_epilogue

launches = 0
plain_cuda_calls = 0


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


def _int4_matmul_cuda(x, qweight, scales, group, scale, bias, residual, activation):
    global launches
    m, kh = qweight.shape
    k = kh * 2
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int4_matmul kernel takes bf16 activations, got {x.dtype}")
    if x.shape[-1] != k or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (…, {k}); got {tuple(x.shape)}")
    if qweight.dtype != torch.uint8 or not qweight.is_cuda or not qweight.is_contiguous():
        raise ValueError("qweight must be a contiguous CUDA uint8 (M, K/2) tensor")
    if group % 16 or k % group or k % 32:
        raise ValueError(f"kernel needs group % 16 == 0 and K % 32 == 0 (K={k}, group={group})")
    if scales.shape != (m, k // group) or scales.dtype != torch.bfloat16 \
            or not scales.is_contiguous() or not scales.is_cuda:
        raise ValueError(f"scales must be contiguous CUDA bf16 {(m, k // group)}")
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
    err = _build.lib().rt_int4_matmul(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _build.ptr(scale),
        _build.ptr(bias), _build.ptr(residual), out.data_ptr(), b, k, m, group,
        ACT_CODES[activation], _build.stream(x))
    _build.check(err, "int4_matmul")
    launches += 1
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
