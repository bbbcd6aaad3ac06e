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
experts' cores stacked on a leading E axis, one operator launch over the
experts with rows and one contraction over a row-tile schedule built on the
device (``grouped_tiles`` is its plain version), no host read.  It replaces
``tt_linear_pallas`` batched by ``jax.vmap`` over the experts
(``repro/models/moe.py::_expert_ffn``).  It takes the fused route's specs
only; there is no grouped staged kernel.  Where each half has one or two
cores, the operator pass is a GEMM of depth r on the tensor cores, group by
group (``op_groups`` and ``operators_by_groups`` are its plain version), over
a grid of min(E, R) expert slots, each finding its expert with rows on the
device (``active_experts``).  The contraction takes the decode tiles
(mma.sync, a few rows a CTA) or, from ``GROUPED_WGMMA_MIN_ROWS`` rows an
expert on, the wgmma contraction over tiles of 8 or 4 rows with TMA-fed
operator tiles (``grouped_plan`` says which, and its shape).

Training: on a CUDA tensor under grad mode ``tt_linear`` goes through the
custom op ``repro_torch::tt_linear``, whose forward is the same kernel call
(bitwise the inference output) and whose backward (``tt_linear_backward``)
gives x, every core and each epilogue operand their gradients.  ``repro``
has no backward kernel (its gradients are XLA's autodiff of the ``ref``
contraction), so the backward is held to autograd of the plain version:
dx = dz·Wᵀ runs the same hand kernel on the transposed train
(``transpose_train``: each core's n and m swapped), the cores' gradients
are GEMMs over the stage intermediates (``core_grads``), and where the
activation or the scale needs u = TT(x) it is recomputed by one kernel
call without the epilogue (no activation-sized tensor is saved).  Being an
op, it is visible to selective checkpointing (``models.modules``' "dots"
policy saves its output).  The grouped entry has no backward: it refuses a
tensor that requires grad.
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
from .epilogue import ACT_CODES, ACTIVATIONS, apply_epilogue

launches = 0          # kernel launches (2 a fused or grouped call, one per core a staged call)
staged_launches = 0   # the staged route's share of ``launches``
grouped_launches = 0  # the grouped entry's share of ``launches``
plain_cuda_calls = 0  # plain-version calls that were handed CUDA tensors
bwd_launches = 0        # ``launches``' share of backward dx calls (the transposed train)
recompute_launches = 0  # ``launches``' share of backward recomputes of u = TT(x)


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


def _count(n: int, role: str | None, staged: bool = False):
    """Add a call's ``n`` kernel launches to the counters, at the launch:
    ``role`` "dx" (a backward dx call) or "recompute" (a backward recompute
    of u) also counts them in that share."""
    global launches, staged_launches, bwd_launches, recompute_launches
    launches += n
    staged_launches += n if staged else 0
    bwd_launches += n if role == "dx" else 0
    recompute_launches += n if role == "recompute" else 0


def _tt_linear_cuda(x, cores, spec: TTSpec, scale, bias, residual, activation, role=None):
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
        _count(2, role)  # the operator pass and the fused contraction
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
    _count(spec.d, role, staged=True)  # one kernel launch per stage
    return out


def tt_linear(x, cores, spec: TTSpec, *, scale=None, bias=None, residual=None,
              activation=None) -> torch.Tensor:
    """(…, N) -> (…, M): the kernel on a CUDA tensor (through the custom op,
    which has a backward, when grad mode is on and an input requires grad),
    the plain version on a CPU tensor."""
    if not x.is_cuda:
        return tt_linear_ref(x, cores, spec, scale, bias, residual, activation)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias, residual, *cores)):
        return torch.ops.repro_torch.tt_linear(
            x, list(cores), list(spec.in_modes), list(spec.out_modes), list(spec.ranks),
            scale, bias, residual, activation or "")
    return _tt_linear_cuda(x, cores, spec, scale, bias, residual, activation)


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------
def transpose_train(cores, spec: TTSpec):
    """Wᵀ as a tensor train: core k (r_{k-1}·n_k, m_k·r_k) becomes
    (r_{k-1}·m_k, n_k·r_k) with its n and m axes swapped, and the in and
    out modes trade places.  Returns (cores, spec), contiguous, in the
    cores' dtype."""
    r, n, m = spec.ranks, spec.in_modes, spec.out_modes
    cores_t = [c.reshape(r[k], n[k], m[k], r[k + 1]).transpose(1, 2)
               .reshape(r[k] * m[k], n[k] * r[k + 1]).contiguous() for k, c in enumerate(cores)]
    return cores_t, TTSpec(spec.out_modes, spec.in_modes, spec.ranks)


def _mm(a, b, out_dtype):
    """a @ b (2-D) accumulated in f32, stored in ``out_dtype``: cuBLAS on the
    card (bf16 operands straight in); the CPU upcasts."""
    if a.dtype == torch.float32:
        return torch.mm(a, b).to(out_dtype)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=out_dtype)
    return torch.mm(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


GRAD_CHUNK_ELEMS = 1 << 27  # elements of the largest stage intermediate a row chunk holds


def core_grads(x, du, cores, spec: TTSpec) -> list[torch.Tensor]:
    """The cores' gradients of y = TT(x) given du = dL/dy, x (B, N) and du
    (B, M) of one dtype.  Core k's is L_kᵀ R_k, one GEMM over the rows
    (b, j_<k, i_>k) of x's left partial L_k (x contracted with the cores
    before k; columns (r_k, i_k)) and du's right partial R_k (du contracted
    with the cores after k; columns (j_k, r_{k+1})).  Each partial comes
    from its neighbour by one GEMM with a core and one permute that moves
    the next mode into the columns.  The partials are stored in x's dtype
    (f32 accumulation) and the cores rounded to it, as the plain version's
    stages; rows go in chunks of at most ``GRAD_CHUNK_ELEMS`` partial
    elements.  Returns f32 (r_k n_k, m_k r_{k+1}) matrices."""
    n, m, r, d = spec.in_modes, spec.out_modes, spec.ranks, spec.d
    dt = x.dtype
    cs = [c.to(dt) for c in cores]
    per_row = max(math.prod(m[:k + e]) * r[k + e] * math.prod(n[k + e:])
                  for k in range(d) for e in (0, 1))
    rows = max(1, GRAD_CHUNK_ELEMS // per_row)
    out = [torch.zeros(c.shape, dtype=torch.float32, device=x.device) for c in cores]
    for r0 in range(0, x.shape[0], rows):
        xb, gb = x[r0:r0 + rows], du[r0:r0 + rows]
        b = xb.shape[0]
        right = [None] * d
        right[d - 1] = gb.reshape(-1, m[d - 1])
        for k in range(d - 1, 0, -1):
            # [b, j<k-1, j_{k-1}, i>k | r_k, i_k] -> [b, j<k-1, i_k, i>k | j_{k-1}, r_k]
            t = _mm(right[k], cs[k].T, dt).reshape(
                b * math.prod(m[:k - 1]), m[k - 1], math.prod(n[k + 1:]), r[k], n[k])
            right[k - 1] = t.permute(0, 4, 2, 1, 3).reshape(-1, m[k - 1] * r[k])
        # [b, i_0, i>0] -> [b, i>0 | i_0]
        left = xb.reshape(b, n[0], -1).transpose(1, 2).reshape(-1, n[0])
        for k in range(d):
            out[k] += _mm(left.T, right[k], torch.float32)
            if k < d - 1:
                # [b, j<k, i_{k+1}, i>k+1 | j_k, r_{k+1}] -> [b, j<k, j_k, i>k+1 | r_{k+1}, i_{k+1}]
                t = _mm(left, cs[k], dt).reshape(
                    b * math.prod(m[:k]), n[k + 1], math.prod(n[k + 2:]), m[k], r[k + 1])
                left = t.permute(0, 3, 2, 4, 1).reshape(-1, r[k + 1] * n[k + 1])
    return out


def tt_linear_backward(dy, x, cores, spec: TTSpec, contract, *, scale=None, bias=None,
                       residual: bool = False, activation=None):
    """Gradients of y = act(TT(x)·scale + bias) + residual given dy:
    (dx, [d core], d scale, d bias, d residual), None for an absent operand.
    ``contract(x, cores, spec, what)`` is TT(x) in x's dtype with no
    epilogue ("recompute": u for the activation or the scale; "dx": du on
    the transposed train): the kernel on the card, the plain contraction in
    the tests.  dz = dy·act'(z) (z = u·scale + bias), d scale = sum dz·u,
    d bias = sum dz, d residual = dy, du = dz·scale rounded to x's dtype, as
    autograd of the plain version gives them."""
    x2 = x.reshape(-1, spec.n_in)
    g = dy.reshape(-1, spec.n_out).to(torch.float32)
    u = None
    if activation is not None or scale is not None:
        u = contract(x2, cores, spec, "recompute").to(torch.float32)
    if activation is not None:
        z = u if scale is None else u * scale.to(torch.float32)
        z = z if bias is None else z + bias.to(torch.float32)
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(ACTIVATIONS[activation](zz), zz, g)
    d_bias = None if bias is None else g.sum(0).to(bias.dtype)
    d_scale = None
    if scale is not None:
        d_scale = (g * u).sum(0).to(scale.dtype)
        g = g * scale.to(torch.float32)
    du = g.to(x.dtype).contiguous()
    cores_t, spec_t = transpose_train(cores, spec)
    dx = contract(du, cores_t, spec_t, "dx").reshape(x.shape)
    d_cores = [dc.to(x.dtype).to(c.dtype) for dc, c in zip(core_grads(x2, du, cores, spec), cores)]
    return dx, d_cores, d_scale, d_bias, (dy if residual else None)


def _contract_on_card(x, cores, spec: TTSpec, what: str):
    return _tt_linear_cuda(x.contiguous(), [c.contiguous() for c in cores], spec,
                           None, None, None, None, role=what)


@torch.library.custom_op(
    "repro_torch::tt_linear", mutates_args=(),
    schema="(Tensor x, Tensor[] cores, int[] in_modes, int[] out_modes, int[] ranks, "
           "Tensor? scale, Tensor? bias, Tensor? residual, str activation) -> Tensor")
def _tt_linear_op(x, cores, in_modes, out_modes, ranks, scale, bias, residual, activation):
    spec = TTSpec(tuple(in_modes), tuple(out_modes), tuple(ranks))
    return _tt_linear_cuda(x, cores, spec, scale, bias, residual, activation or None)


@_tt_linear_op.register_fake
def _(x, cores, in_modes, out_modes, ranks, scale, bias, residual, activation):
    return x.new_empty(*x.shape[:-1], math.prod(out_modes))


def _tt_op_setup(ctx, inputs, output):
    x, cores, in_modes, out_modes, ranks, scale, bias, residual, activation = inputs
    ctx.save_for_backward(x, scale, bias, *cores)
    ctx.spec = TTSpec(tuple(in_modes), tuple(out_modes), tuple(ranks))
    ctx.activation = activation or None
    ctx.residual = residual is not None


def _tt_op_backward(ctx, dy):
    x, scale, bias, *cores = ctx.saved_tensors
    dx, d_cores, d_scale, d_bias, d_res = tt_linear_backward(
        dy.contiguous(), x, cores, ctx.spec, _contract_on_card, scale=scale, bias=bias,
        residual=ctx.residual, activation=ctx.activation)
    return dx, d_cores, None, None, None, d_scale, d_bias, d_res, None


_tt_linear_op.register_autograd(_tt_op_backward, setup_context=_tt_op_setup)


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


# The grouped operator pass on the tensor cores (csrc/tt_linear.cu plan_half):
# a group's operator elements aimed at, and the limits past which a
# spec takes tt_operators (CUDA cores).
OPS_S_TARGET, OPS_S_MAX, OPS_ROWS_MAX, OPS_COLS_MAX = 16384, 16384, 256, 1024


@dataclass(frozen=True)
class OpHalf:
    """One half of the cores as the operator pass's GEMM of depth ``k``: A
    (core ``a``: rows (i, j) of modes nA x mA, or rank-major rows on the
    right) times B (core ``b``: columns (i', j') of nB x mB, times the rank
    rr on the left); core -1 is the identity.  A CTA takes one of ``groups``
    groups: ``rows`` A rows by ``cols`` B columns (the left half's chunks of
    ``mac`` of m_a and ``mc`` of m_b, the right half's of ``rc`` ranks)."""

    left: bool
    a: int
    b: int
    n_a: int
    m_a: int
    n_b: int
    m_b: int
    k: int
    rr: int
    mac: int     # the left half's chunk of m_a a group
    mc: int      # the left half's chunk of m_b a group
    rc: int      # the right half's chunk of ranks a group
    rows: int
    cols: int
    groups: int

    @property
    def n(self) -> int:
        return self.n_a * self.n_b

    @property
    def s_elems(self) -> int:
        """A group's operator elements (what its plan sizes it by)."""
        return (self.rr * self.mac * self.mc if self.left else self.rc * self.m_a * self.m_b) \
            * _pad16(self.n)


def _op_half(spec: TTSpec, h: int, left: bool) -> OpHalf | None:
    n, m, r, d = spec.in_modes, spec.out_modes, spec.ranks, spec.d
    nc = h if left else d - h
    if not 1 <= nc <= 2:
        return None
    ka = 0 if left else (d - 2 if nc == 2 else -1)
    kb = (1 if nc == 2 else -1) if left else d - 1
    n_a, m_a = (n[ka], m[ka]) if ka >= 0 else (1, 1)
    n_b, m_b = (n[kb], m[kb]) if kb >= 0 else (1, 1)
    k = r[1] if left else (r[d - 1] if nc == 2 else r[h])
    rr, n16 = r[h], _pad16(n_a * n_b)
    if left:  # the most j1 a group (each reads B once), then the most j2
        mac = next((c for c in range(m_a, 0, -1) if m_a % c == 0 and n_a * c <= OPS_ROWS_MAX
                    and rr * c * n16 <= OPS_S_TARGET), 1)
        mc = next((c for c in range(m_b, 0, -1) if m_b % c == 0
                   and rr * mac * c * n16 <= OPS_S_TARGET and n_b * c * rr <= OPS_COLS_MAX), 1)
        half = OpHalf(True, ka, kb, n_a, m_a, n_b, m_b, k, rr, mac, mc, 1, n_a * mac,
                      n_b * mc * rr, (m_a // mac) * (m_b // mc))
    else:
        rc = next((c for c in range(rr, 0, -1) if rr % c == 0 and c * n_a * m_a <= OPS_ROWS_MAX
                   and c * m_a * m_b * n16 <= OPS_S_TARGET), 1)
        half = OpHalf(False, ka, kb, n_a, m_a, n_b, m_b, k, rr, m_a, m_b, rc, rc * n_a * m_a,
                      n_b * m_b, rr // rc)
    if half.rows > OPS_ROWS_MAX or half.cols > OPS_COLS_MAX or half.s_elems > OPS_S_MAX:
        return None
    return half


@functools.lru_cache(maxsize=None)
def op_groups(spec: TTSpec, h: int) -> tuple[OpHalf, OpHalf] | None:
    """The tensor-core operator pass's plan of split ``h``, or None where a
    half has more than two cores (or none) or passes the limits."""
    halves = (_op_half(spec, h, True), _op_half(spec, h, False))
    return None if None in halves else halves


def operators_by_groups(cores, spec: TTSpec, h: int):
    """The operator pass as ``tt_ops_mma`` computes it, group by group: each
    group's GEMM of depth r in f32 from the cores (C's columns with the
    input index i' fastest), each element put where the kernel stores it in
    OPL (r_h, ML, NL16) and OPR (r_h, MR, NR16), zeros past NL and NR (the
    kernel then rounds to bf16)."""
    halves = op_groups(spec, h)
    if halves is None:
        raise ValueError(f"spec {spec.in_modes}->{spec.out_modes} split {h}: no GEMM plan")
    out = []
    for p in halves:
        eye = torch.eye(p.rr, dtype=torch.float32)
        a_mat = cores[p.a].float().reshape(-1, p.k) if p.a >= 0 else eye
        b_mat = cores[p.b].float().reshape(p.k, -1) if p.b >= 0 else eye
        n16, mt = _pad16(p.n), p.m_a * p.m_b
        op = torch.zeros(p.rr * mt * n16)
        rows, cols = torch.arange(p.rows), torch.arange(p.cols)
        ib = cols % p.n_b
        for g in range(p.groups):
            if p.left:  # a = (i1, j1 of the chunk), c = (j2 of the chunk, rho, i2)
                ja0, jb0 = divmod(g, p.m_b // p.mc)
                ja0, jb0 = ja0 * p.mac, jb0 * p.mc
                jl, rho = cols // (p.n_b * p.rr), (cols // p.n_b) % p.rr
                a_rows = (rows // p.mac) * p.m_a + ja0 + rows % p.mac
                b_cols = (ib * p.m_b + jb0 + jl) * p.rr + rho
                row_at = (ja0 + rows % p.mac) * p.m_b * n16 + (rows // p.mac) * p.n_b
                col_at = rho * mt * n16 + (jb0 + jl) * n16 + ib
            else:  # a = (rho of the chunk, i, j), c = (j', i')
                q = rows % (p.n_a * p.m_a)
                a_rows, b_cols = g * p.rows + rows, ib * p.m_b + cols // p.n_b
                row_at = ((g * p.rc + rows // (p.n_a * p.m_a)) * mt + (q % p.m_a) * p.m_b) * n16 \
                    + (q // p.m_a) * p.n_b
                col_at = (cols // p.n_b) * n16 + ib
            c = a_mat[a_rows] @ b_mat[:, b_cols]
            op[(row_at[:, None] + col_at[None, :]).reshape(-1)] = c.reshape(-1)
        out.append(op.reshape(p.rr, mt, n16))
    return tuple(out)


def active_experts(offsets, rows: int) -> list[int]:
    """The experts the operator pass's min(E, rows) slots find, in slot
    order, as each CTA finds its own (``csrc/tt_linear.cu`` nth_active): 512
    experts a pass, two a thread, an inclusive scan of the threads' counts
    within each warp of 32 plus the warps' sums before it gives each expert
    with rows its slot; offsets clamped to [0, rows]."""
    off = [int(v) for v in offsets]
    n_exp, slots, base = len(off) - 1, min(len(off) - 1, rows), 0
    found = {}

    def has_rows(e):
        if e >= n_exp:
            return 0
        lo = min(max(off[e], 0), rows)
        return int(min(max(off[e + 1], lo), rows) > lo)

    for e0 in range(0, n_exp, 512):
        act = [(has_rows(e0 + 2 * t), has_rows(e0 + 2 * t + 1)) for t in range(256)]
        incl = []  # inclusive scans within each warp
        for t in range(256):
            incl.append(sum(act[t]) + (incl[-1] if t % 32 else 0))
        wsum = [incl[32 * w + 31] for w in range(8)]
        for t in range(256):
            first = base + incl[t] - sum(act[t]) + sum(wsum[:t // 32])
            for j in range(2):
                if act[t][j]:
                    found[first + (act[t][0] if j else 0)] = e0 + 2 * t + j
        base += sum(wsum)
        if base >= slots:
            break
    return [found[y] for y in range(slots) if y in found]


# The grouped contraction takes the wgmma route from this many rows an
# expert (the mean over the call's experts) on; below it the decode tiles.
GROUPED_WGMMA_MIN_ROWS = 4
SMEM_MAX = 227 * 1024  # csrc/tt_linear.cu SMEM_MAX


@dataclass(frozen=True)
class GroupedPlan:
    """The grouped call's launches: whether the operator pass runs on the
    tensor cores (``ops_mma``), the contraction's route ("decode tiles" or
    "wgmma"), its rows a CTA tile (decode tiles: at most) and schedule slots;
    for wgmma, rows a warpgroup (``iw``), MR columns a CTA (``bms``), ring
    stages, shared memory and grid."""

    ops_mma: bool
    route: str
    tb: int
    slots: int
    iw: int = 0
    bms: int = 0
    stages: int = 0
    smem: int = 0
    grid: tuple = ()


@functools.lru_cache(maxsize=None)
def _wgmma_shape(spec: TTSpec):
    """(iw, bms, stages, smem) of the wgmma contraction (left half first at
    the plan's split; ``csrc/tt_linear.cu`` wgmma_layout), or None."""
    p = _split(spec, contraction_plan(spec).h, True)
    ns, kp = _pad16(p.nr), -(-_pad16(p.nl) // 64)
    if ns not in (32, 64) or p.nr % 8:  # a row's X loads 8 of NR at a time
        return None
    bms = 32 if p.mr <= 32 else 64
    for iw in (4, 2):
        x_bytes = kp * ns * 128
        epi = 64 * (bms + 4) * 4
        for stages in (4, 3, 2):
            end = 2 * iw * x_bytes + stages * (kp * 8192 + -(-ns // 64) * bms * 128)
            if iw * x_bytes < epi:
                end += 2 * epi
            smem = 1024 + end + 2 * stages * 8
            if smem <= SMEM_MAX:
                return iw, bms, stages, smem
    return None


def grouped_plan(spec: TTSpec, rows: int, experts: int, x_aligned: bool = True) -> GroupedPlan:
    """The grouped call's plan for ``rows`` rows over ``experts`` experts
    (the wgmma route loads x 16 bytes at a time: ``x_aligned``)."""
    return _grouped_plan(spec, rows, experts, x_aligned, GROUPED_WGMMA_MIN_ROWS)


@functools.lru_cache(maxsize=1024)  # a decode tick asks the same few plans ~180 times
def _grouped_plan(spec: TTSpec, rows: int, experts: int, x_aligned: bool,
                  min_rows: int) -> GroupedPlan:
    plan = contraction_plan(spec)
    ops = op_groups(spec, plan.h) is not None
    shape = _wgmma_shape(spec) if ops else None
    if shape is not None and x_aligned and rows >= min_rows * experts:
        iw, bms, stages, smem = shape
        tb = 2 * iw
        slots = -(-rows // tb) + experts
        lf = _split(spec, plan.h, True)
        return GroupedPlan(True, "wgmma", tb, slots, iw, bms, stages, smem,
                           (slots, -(-lf.ml // 64), -(-lf.mr // bms)))
    tb = 1
    while tb < 8 and 2 * tb * experts <= rows:
        tb *= 2
    return GroupedPlan(ops, "decode tiles", tb, -(-rows // tb) + experts)


def _tt_linear_grouped_cuda(x, offsets, cores, spec: TTSpec, activation):
    _build.refuse_grad("tt_linear_grouped (MoE experts)", x, *cores)
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
    gp = grouped_plan(spec, r, e, x.data_ptr() % 16 == 0)
    err = _build.lib().rt_tt_linear_fused_grouped(
        x.data_ptr(), core_ptrs, offsets.data_ptr(), e, tiles.data_ptr(), ops.data_ptr(),
        out.data_ptr(), r, spec.d, in_m, out_m, ranks, plan.h, int(plan.left_first),
        ACT_CODES[activation], int(cores[0].dtype == torch.float32), gp.iw, gp.bms, gp.stages,
        _build.stream(x))
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
