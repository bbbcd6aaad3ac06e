"""TT-linear: the Eq.-4 contraction with the fused epilogue.

``tt_linear`` runs the CUDA kernels (``csrc/tt_linear.cu``) on a CUDA tensor
and the plain version on a CPU tensor.  Replaces
``repro/kernels/tt_linear.py::tt_linear_pallas``.  The plain version mirrors
``repro``'s ``ref`` path: each stage is stored in the input dtype and
multiplied in f32.  bf16 input and cores with d <= 8 and ranks <= 32 take
the fused route: the cores split at the mode ``contraction_plan`` picks
into two halves, each half contracted into one operator (a first launch),
then one kernel contracts x with both halves on the tensor cores, rounding
its one intermediate to bf16 on chip (a second launch).  Any f32 operand,
and a bf16 spec past those limits, takes the staged route: one launch per
core, f32 intermediates in a per-call scratch buffer (``fused_route``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ..core.tt_linear import tt_linear_apply
from ..core.ttd import TTSpec
from . import _build
from .epilogue import ACT_CODES, apply_epilogue

launches = 0          # kernel launches (2 a fused call, one per core a staged call)
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


@dataclass(frozen=True)
class Plan:
    """A split of the cores at ``h``: the left half (modes 1..h) has ``nl``
    inputs and ``ml`` outputs, the right half ``nr`` and ``mr``, joined by
    the rank ``rank`` = r_h; ``left_first`` says which half meets x first."""

    h: int
    left_first: bool
    nl: int
    nr: int
    ml: int
    mr: int
    rank: int

    @property
    def flops(self) -> int:
        """Operations a token: with X the token's (nl, nr) view of x,
        sum_rho A_rho X B_rho with A_rho (ml, nl) and B_rho (nr, mr)."""
        if self.left_first:
            return 2 * self.rank * self.ml * self.nr * (self.nl + self.mr)
        return 2 * self.rank * self.nl * self.mr * (self.nr + self.ml)


def _split(spec: TTSpec, h: int, left_first: bool) -> Plan:
    n, m = spec.in_modes, spec.out_modes
    return Plan(h, left_first, math.prod(n[:h]), math.prod(n[h:]), math.prod(m[:h]),
                math.prod(m[h:]), spec.ranks[h])


def _splits(spec: TTSpec) -> list[Plan]:
    """Every split with either half first; d = 1 has the one split h = 1
    (an empty right half)."""
    hs = range(1, spec.d) if spec.d > 1 else (1,)
    return [_split(spec, h, left) for h in hs for left in (True, False)]


@functools.lru_cache(maxsize=None)
def contraction_plan(spec: TTSpec) -> Plan:
    """The split the fused kernel contracts by: the fewest operations (the
    first such split, left first, on a tie)."""
    return min(_splits(spec), key=lambda p: p.flops)


def tt_order_flops(spec: TTSpec) -> dict[str, int]:
    """Operations a token of each contraction order: the staged order left
    to right (``TTSpec.flops_per_token``) and right to left, and every split
    ``h`` with either half first."""
    rev = TTSpec(spec.in_modes[::-1], spec.out_modes[::-1], spec.ranks[::-1])
    out = {"staged left to right": spec.flops_per_token(),
           "staged right to left": rev.flops_per_token()}
    for p in _splits(spec):
        out[f"h={p.h} {'left' if p.left_first else 'right'} first"] = p.flops
    return out


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=None)
def _spec_info(spec: TTSpec):
    """ctypes mode/rank arrays, core shapes, the largest per-token
    intermediate (staged route), the plan and its operators' element count."""
    plan = contraction_plan(spec)
    op_elems = plan.rank * (plan.ml * _pad16(plan.nl) + plan.mr * _pad16(plan.nr))
    return (_build.int_array(spec.in_modes), _build.int_array(spec.out_modes), _build.int_array(spec.ranks),
            spec.core_matrix_shapes(), spec.max_intermediate(), plan, op_elems)


FUSED_MAX_D, FUSED_MAX_RANK = 8, 32  # csrc/tt_linear.cu MAXD and the rank limit


def fused_route(spec: TTSpec, x_dtype, core_dtypes) -> bool:
    """Which hand kernel a CUDA call takes, by dtype and shape: bf16 x and
    cores with d <= 8 and every rank <= 32 take the fused two-half
    contraction; any f32 operand, or a bf16 spec past those limits, takes
    the staged kernel (one GEMM launch a core, f32 intermediates, any d and
    rank).  Both are hand kernels, chosen the way int4_matmul picks its GEMV
    or its GEMM; neither is the plain version."""
    return (x_dtype == torch.bfloat16 and all(d == torch.bfloat16 for d in core_dtypes)
            and spec.d <= FUSED_MAX_D and max(spec.ranks) <= FUSED_MAX_RANK)


def _tt_linear_cuda(x, cores, spec: TTSpec, scale, bias, residual, activation):
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tt_linear kernel takes f32/bf16 input, got {x.dtype}")
    if x.shape[-1] != spec.n_in or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (…, {spec.n_in}); got {tuple(x.shape)}")
    in_m, out_m, ranks, shapes, max_inter, plan, op_elems = _spec_info(spec)
    if len(cores) != spec.d:
        raise ValueError(f"expected {spec.d} cores, got {len(cores)}")
    for c, shp in zip(cores, shapes):
        if tuple(c.shape) != shp or not c.is_cuda or not c.is_contiguous() \
                or c.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"core must be a contiguous CUDA f32/bf16 {shp}; "
                             f"got {tuple(c.shape)} {c.dtype}")
    lead = x.shape[:-1]
    b = math.prod(lead)
    fused = fused_route(spec, x.dtype, [c.dtype for c in cores])
    if b * max(spec.n_in, spec.n_out, 0 if fused else max_inter) >= 2 ** 31:
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
    core_ptrs = (ctypes.c_void_p * spec.d)(*[c.data_ptr() for c in cores])
    if fused:
        ops = torch.empty(op_elems, dtype=torch.bfloat16, device=x.device)
        err = _build.lib().rt_tt_linear_fused(
            x.data_ptr(), core_ptrs, ops.data_ptr(), out.data_ptr(), _build.ptr(scale),
            _build.ptr(bias), _build.ptr(residual), b, spec.d, in_m, out_m, ranks, plan.h,
            int(plan.left_first), ACT_CODES[activation], _build.stream(x))
        _build.check(err, "tt_linear")
        launches += 2  # the operator pass and the fused contraction
        return out
    scratch = torch.empty(2, b * max_inter if spec.d > 1 else 0, dtype=torch.float32,
                          device=x.device)
    err = _build.lib().rt_tt_linear(
        x.data_ptr(), _build.dtype_code(x), core_ptrs,
        _build.int_array([_build.dtype_code(c) for c in cores]),
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
