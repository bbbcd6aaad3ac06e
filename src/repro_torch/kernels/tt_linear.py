"""TT-linear: the staged Eq.-4 contraction with the fused epilogue.

``tt_linear`` runs the CUDA kernel (``csrc/tt_linear.cu``, one launch per
stage, all issued by one C call) on a CUDA tensor and the plain version on a
CPU tensor.  Replaces ``repro/kernels/tt_linear.py::tt_linear_pallas``.  The
plain version mirrors ``repro``'s ``ref`` path: each stage is stored in the
input dtype and multiplied in f32.  The kernel does the same for bf16
(tensor cores, bf16 intermediates) and keeps f32 intermediates otherwise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.tt_linear import tt_linear_apply
from ..core.ttd import TTSpec
from . import _build
from .epilogue import ACT_CODES, apply_epilogue

launches = 0          # kernel launches (one per stage)
plain_cuda_calls = 0  # plain-version calls that were handed CUDA tensors


def tt_linear_ref(x, cores, spec: TTSpec, scale=None, bias=None, residual=None,
                  activation=None) -> torch.Tensor:
    """y = act(TT(x)·scale + bias) + residual, (…, N) -> (…, M), in x.dtype."""
    global plain_cuda_calls
    plain_cuda_calls += x.is_cuda
    y = tt_linear_apply({"cores": cores}, x, spec)
    y = apply_epilogue(y, scale=scale, bias=bias, residual=residual,
                       activation=activation)
    return y.to(x.dtype)


def _int_array(vals):
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def _spec_info(spec: TTSpec):
    """ctypes mode/rank arrays, core shapes and the largest per-token intermediate."""
    return (_int_array(spec.in_modes), _int_array(spec.out_modes), _int_array(spec.ranks),
            spec.core_matrix_shapes(), spec.max_intermediate())


def _tt_linear_cuda(x, cores, spec: TTSpec, scale, bias, residual, activation):
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tt_linear kernel takes f32/bf16 input, got {x.dtype}")
    if x.shape[-1] != spec.n_in or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (…, {spec.n_in}); got {tuple(x.shape)}")
    in_m, out_m, ranks, shapes, max_inter = _spec_info(spec)
    if len(cores) != spec.d:
        raise ValueError(f"expected {spec.d} cores, got {len(cores)}")
    for c, shp in zip(cores, shapes):
        if tuple(c.shape) != shp or not c.is_cuda or not c.is_contiguous() \
                or c.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"core must be a contiguous CUDA f32/bf16 {shp}; "
                             f"got {tuple(c.shape)} {c.dtype}")
    lead = x.shape[:-1]
    b = math.prod(lead)
    if b * max(max_inter, spec.n_out) >= 2 ** 31:
        raise ValueError(f"{b} tokens overflow the kernel's 32-bit offsets")
    out = torch.empty(*lead, spec.n_out, dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    if residual is not None:
        if residual.shape != out.shape or residual.dtype != x.dtype \
                or not residual.is_contiguous():
            raise ValueError("residual must be contiguous, shaped and typed like the output")
    scale = _build.epilogue_vector(scale, spec.n_out, "scale")
    bias = _build.epilogue_vector(bias, spec.n_out, "bias")
    # bf16 x and cores run the tensor-core path with bf16 intermediates
    mma = x.dtype == torch.bfloat16 and all(c.dtype == torch.bfloat16 for c in cores)
    scratch = torch.empty(2, b * max_inter if spec.d > 1 else 0,
                          dtype=torch.bfloat16 if mma else torch.float32, device=x.device)
    err = _build.lib().rt_tt_linear(
        x.data_ptr(), _build.dtype_code(x),
        (ctypes.c_void_p * spec.d)(*[c.data_ptr() for c in cores]),
        _int_array([_build.dtype_code(c) for c in cores]),
        scratch[0].data_ptr(), scratch[1].data_ptr(), out.data_ptr(),
        _build.ptr(scale), _build.ptr(bias), _build.ptr(residual), b, spec.d,
        in_m, out_m, ranks, ACT_CODES[activation], _build.stream(x))
    _build.check(err, "tt_linear")
    launches += spec.d  # one kernel launch per stage
    return out


def tt_linear(x, cores, spec: TTSpec, *, scale=None, bias=None, residual=None,
              activation=None) -> torch.Tensor:
    """(…, N) -> (…, M): the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if not x.is_cuda:
        return tt_linear_ref(x, cores, spec, scale, bias, residual, activation)
    return _tt_linear_cuda(x, cores, spec, scale, bias, residual, activation)
