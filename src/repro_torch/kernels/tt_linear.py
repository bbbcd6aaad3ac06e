"""TT-linear: the Eq.-4 contraction with the fused epilogue.

``tt_linear`` runs the CUDA kernels (``csrc/tt_linear.cu``) on a CUDA tensor
and the plain version on a CPU tensor.  Replaces
``repro/kernels/tt_linear.py::tt_linear_pallas``.  The plain version mirrors
``repro``'s ``ref`` path: each stage is stored in the input dtype and
multiplied in f32.  bf16 input and cores with d <= 8 and ranks <= 32 take
the fused route: the cores split at the mode ``contraction_plan`` picks
into two halves, each half contracted into one operator (a first launch),
then one kernel contracts x with both halves on the tensor cores, rounding
its one intermediate to bf16 on chip (a second launch).  f32 cores with bf16
input (what ``core.compress`` writes) take the same route: the operator pass
rounds each core element to bf16 as it loads it, as the plain version rounds
each core to the dtype of x.  f32 input, cores of mixed dtypes and a bf16
spec past those limits take the staged route: one launch per core, f32
intermediates in a per-call scratch buffer (``fused_route``).

``tt_linear_grouped`` is the MoE experts' entry: rows sorted by expert, the
experts' cores stacked on a leading E axis, one operator launch over every
expert with rows and one contraction over a row-tile schedule built on the
device (``grouped_tiles`` is its plain version), no host read.  It replaces
``tt_linear_pallas`` batched by ``jax.vmap`` over the experts
(``repro/models/moe.py::_expert_ffn``).  It takes the fused route's specs
only; there is no grouped staged kernel.
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

launches = 0          # kernel launches (2 a fused or grouped call, one per core a staged call)
staged_launches = 0   # the staged route's share of ``launches``
grouped_launches = 0  # the grouped entry's share of ``launches``
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
    """Which hand kernel a CUDA call takes, by dtype and shape: bf16 x with
    cores all bf16 or all f32, d <= 8 and every rank <= 32 takes the fused
    two-half contraction; f32 x, cores of mixed dtypes, or a spec past those
    limits takes the staged kernel (one GEMM launch a core, f32
    intermediates, any d and rank).  Both are hand kernels, chosen the way
    int4_matmul picks its GEMV or its GEMM; neither is the plain version."""
    return (x_dtype == torch.bfloat16 and len(set(core_dtypes)) == 1
            and core_dtypes[0] in (torch.bfloat16, torch.float32)
            and spec.d <= FUSED_MAX_D and max(spec.ranks) <= FUSED_MAX_RANK)


def _tt_linear_cuda(x, cores, spec: TTSpec, scale, bias, residual, activation):
    global launches, staged_launches
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
            int(plan.left_first), ACT_CODES[activation], int(cores[0].dtype == torch.float32),
            _build.stream(x))
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
    staged_launches += spec.d
    return out


def tt_linear(x, cores, spec: TTSpec, *, scale=None, bias=None, residual=None,
              activation=None) -> torch.Tensor:
    """(…, N) -> (…, M): the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if not x.is_cuda:
        return tt_linear_ref(x, cores, spec, scale, bias, residual, activation)
    return _tt_linear_cuda(x, cores, spec, scale, bias, residual, activation)


# ---------------------------------------------------------------------------
# Grouped entry: E experts' TT linears over rows sorted by expert
# ---------------------------------------------------------------------------
def tt_linear_grouped_ref(x, offsets, cores, spec: TTSpec, *, activation=None) -> torch.Tensor:
    """x (R, N) rows sorted by expert, expert e's rows ``offsets[e] :
    offsets[e + 1]``; ``cores`` the experts' stacked cores, each (E, r n, m
    r) -> (R, M) in x.dtype: ``tt_linear_ref`` on each expert's rows.  Reads
    the offsets on the host (the plain version only)."""
    global plain_cuda_calls
    plain_cuda_calls += x.is_cuda
    off = offsets.tolist()
    out = x.new_empty(x.shape[0], spec.n_out)
    for e in range(len(off) - 1):
        if off[e + 1] > off[e]:
            out[off[e]:off[e + 1]] = tt_linear_ref(x[off[e]:off[e + 1]], [c[e] for c in cores],
                                                   spec, activation=activation)
    return out


def grouped_tiles(offsets, tb: int):
    """The grouped kernel's row-tile schedule, as its operator launch writes
    it on the device (``csrc/tt_linear.cu`` ``grouped_schedule``): expert
    e's rows cut into tiles of ``tb``, the experts in order.  Returns the
    (expert, first row, end row) tiles and the launch's slot count
    ceil(R / tb) + E, which bounds their number."""
    off = [int(v) for v in offsets]
    tiles = [(e, r, min(r + tb, off[e + 1]))
             for e in range(len(off) - 1) for r in range(off[e], off[e + 1], tb)]
    return tiles, -(-off[-1] // tb) + len(off) - 1


def _tt_linear_grouped_cuda(x, offsets, cores, spec: TTSpec, activation):
    global launches, grouped_launches
    e = offsets.shape[0] - 1
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != spec.n_in \
            or not x.is_contiguous():
        raise ValueError(f"grouped tt_linear takes contiguous bf16 (R, {spec.n_in}) rows; "
                         f"got {tuple(x.shape)} {x.dtype}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or e < 1 or not offsets.is_cuda \
            or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous CUDA int32 (E + 1,) vector")
    if len(cores) != spec.d or not fused_route(spec, x.dtype, [c.dtype for c in cores]):
        raise ValueError(f"grouped tt_linear takes d <= {FUSED_MAX_D}, ranks <= "
                         f"{FUSED_MAX_RANK} and cores all bf16 or all f32 (no grouped staged "
                         f"kernel); got d {spec.d}, ranks {spec.ranks}")
    in_m, out_m, ranks, shapes, _, plan, op_elems = _spec_info(spec)
    for c, shp in zip(cores, shapes):
        if tuple(c.shape) != (e, *shp) or not c.is_cuda or not c.is_contiguous():
            raise ValueError(f"stacked core must be a contiguous CUDA {(e, *shp)}; "
                             f"got {tuple(c.shape)}")
    r = x.shape[0]
    if (r + e) * max(spec.n_in, spec.n_out) >= 2 ** 31:
        raise ValueError(f"{r} rows overflow the kernel's 32-bit offsets")
    out = torch.empty(r, spec.n_out, dtype=x.dtype, device=x.device)
    if r == 0:
        return out
    ops = torch.empty(e * op_elems, dtype=torch.bfloat16, device=x.device)
    tiles = torch.empty(r + e, 4, dtype=torch.int32, device=x.device)
    core_ptrs = (ctypes.c_void_p * spec.d)(*[c.data_ptr() for c in cores])
    err = _build.lib().rt_tt_linear_fused_grouped(
        x.data_ptr(), core_ptrs, offsets.data_ptr(), e, tiles.data_ptr(), ops.data_ptr(),
        out.data_ptr(), r, spec.d, in_m, out_m, ranks, plan.h, int(plan.left_first),
        ACT_CODES[activation], int(cores[0].dtype == torch.float32), _build.stream(x))
    _build.check(err, "tt_linear_grouped")
    launches += 2  # the operator pass (with the schedule) and the contraction
    grouped_launches += 2
    return out


def tt_linear_grouped(x, offsets, cores, spec: TTSpec, *, activation=None) -> torch.Tensor:
    """(R, N) rows sorted by expert -> (R, M): the grouped kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return tt_linear_grouped_ref(x, offsets, cores, spec, activation=activation)
    return _tt_linear_grouped_cuda(x, offsets, cores, spec, activation)
