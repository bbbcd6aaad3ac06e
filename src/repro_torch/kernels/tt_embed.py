"""Rows of a vocab-axis TT embedding table (TensorGPT layout).

The (V, D) table is the TT's (M, N) weight with M = V, so a lookup never
builds the table: each id splits into its big-endian ``out_modes`` digits,
digit k selects the (r_{k-1}, n_k, r_k) block of core matrix C_k (rows
(r, n), columns (m, r) m-major), and the blocks are chained left to right.
Ids resolve like the dense gather: a negative id wraps once (-1 is row
V - 1), then every id clamps into [0, V).

``tt_embed`` runs the CUDA kernel (``csrc/tt_embed.cu``) on a CUDA tensor
and the plain PyTorch version on a CPU tensor.  Replaces
``repro/kernels/tt_embed.py::tt_embed_pallas``.  Both return f32 rows.  The
kernel computes a row as the product of two halves split at the rank
``embed_plan`` picks: L (P, r) from the cores left of the split, selected by
the id's prefix digits, times R (r, Q) from the cores right of it, selected
by its suffix digits.  ``tt_embed_two_half`` is that order in plain
PyTorch, for the CPU tests.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..core.ttd import TTSpec
from . import _build

launches = 0
plain_cuda_calls = 0


def resolve_ids(ids, vocab: int):
    """Negative ids wrap once, then every id clamps into [0, vocab)."""
    ids = ids.to(torch.int64)
    return torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)


def tt_embed_plain(ids, cores, spec: TTSpec):
    """ids: int of any shape -> (..., D) f32 rows of the (V, D) table the
    cores describe (``spec``: M = V, N = D); the digit-indexed chain of
    ``repro.kernels.ref.tt_embedding``, in f32."""
    lead = ids.shape
    flat = resolve_ids(ids.reshape(-1), spec.n_out)
    t = flat.shape[0]
    m = spec.out_modes
    p = None
    for k in range(spec.d):
        digit = (flat // math.prod(m[k + 1:])) % m[k]
        r0, r1, n_k = spec.ranks[k], spec.ranks[k + 1], spec.in_modes[k]
        c = cores[k].to(torch.float32).reshape(r0, n_k, m[k], r1)
        sel = c[:, :, digit].permute(2, 0, 1, 3)  # (T, r0, n_k, r1)
        if p is None:
            p = sel.reshape(t, n_k, r1)  # r0 == 1 on the first core
        else:
            p = torch.einsum("txr,trjs->txjs", p, sel).reshape(t, -1, r1)
    return p.reshape(*lead, spec.n_in)


def tt_embed_ref(ids, cores, spec: TTSpec):
    """The plain version; it counts the calls handed CUDA tensors."""
    global plain_cuda_calls
    plain_cuda_calls += ids.is_cuda
    return tt_embed_plain(ids, cores, spec)


@dataclass(frozen=True)
class EmbedPlan:
    """A split of the cores at ``rho``: a row is L (p, rank) · R (rank, q)
    flattened row-major, L chained from cores 1..rho and selected by the
    id's first rho digits (``n_left`` distinct prefixes), R from cores
    rho+1..d and selected by the rest (``n_right`` suffixes)."""

    rho: int
    p: int
    q: int
    rank: int
    n_left: int
    n_right: int
    flops: int  # a token: both halves' chains and the product


def _chain_flops(spec: TTSpec, k0: int, k1: int) -> int:
    """Operations of one half's chain over cores k0..k1-1 (its first block
    is taken as it is)."""
    if k0 >= k1:
        return 0
    rows, f = spec.ranks[k0] * spec.in_modes[k0], 0
    for k in range(k0 + 1, k1):
        f += 2 * rows * spec.ranks[k] * spec.in_modes[k] * spec.ranks[k + 1]
        rows *= spec.in_modes[k]
    return f


def embed_split(spec: TTSpec, rho: int) -> EmbedPlan:
    n, m = spec.in_modes, spec.out_modes
    p, q, r = math.prod(n[:rho]), math.prod(n[rho:]), spec.ranks[rho]
    flops = _chain_flops(spec, 0, rho) + _chain_flops(spec, rho, spec.d) + 2 * p * q * r
    return EmbedPlan(rho, p, q, r, math.prod(m[:rho]), math.prod(m[rho:]), flops)


@functools.lru_cache(maxsize=None)
def embed_plan(spec: TTSpec) -> EmbedPlan:
    """The split the kernels use: the fewest operations a token (the first
    such split on a tie); d = 1 has the one split rho = 1, an empty right
    half."""
    rhos = range(1, spec.d) if spec.d > 1 else (1,)
    return min((embed_split(spec, rho) for rho in rhos), key=lambda p: p.flops)


def embed_halves(cores, spec: TTSpec, rho: int):
    """Every left half (n_left, P, r) and right half (n_right, r, Q) in f32,
    prefixes and suffixes big-endian, rows and columns n-digit big-endian
    (an empty right half is the 1 x 1 identity)."""
    n, m, r = spec.in_modes, spec.out_modes, spec.ranks
    g = [c.to(torch.float32).reshape(r[k], n[k], m[k], r[k + 1]) for k, c in enumerate(cores)]
    left = g[0][0].permute(1, 0, 2)  # (m_1, n_1, r_1)
    for k in range(1, rho):
        left = torch.einsum("IJu,ujis->IiJjs", left, g[k]).reshape(
            left.shape[0] * m[k], left.shape[1] * n[k], r[k + 1])
    right = torch.ones(1, 1, 1, 1)  # (I, r_rho, J, s)
    if rho < spec.d:
        right = g[rho].permute(2, 0, 1, 3)  # (m, r_rho, n, r)
        for k in range(rho + 1, spec.d):
            right = torch.einsum("IrJu,ujis->IirJjs", right, g[k]).reshape(
                right.shape[0] * m[k], r[rho], right.shape[2] * n[k], r[k + 1])
    return left, right[..., 0]


def tt_embed_two_half(ids, cores, spec: TTSpec, rho: int | None = None):
    """The kernels' order in plain PyTorch: row = L[prefix] · R[suffix]."""
    plan = embed_plan(spec) if rho is None else embed_split(spec, rho)
    lead = ids.shape
    flat = resolve_ids(ids.reshape(-1), spec.n_out)
    left, right = embed_halves(cores, spec, plan.rho)
    rows = torch.bmm(left[flat // plan.n_right], right[flat % plan.n_right])
    return rows.reshape(*lead, spec.n_in)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=None)
def _spec_info(spec: TTSpec):
    """What every call of one spec passes the C side, built once: the plan,
    the ctypes mode/rank arrays, the core shapes, and the kernel's shared
    memory layout (floats, 16-byte aligned regions): rho, each core's
    selected block, each half's two ping-pong buffers for the chain stages
    after its first block, the 1 x 1 identity of d = 1's empty right half,
    and the total."""
    plan = embed_plan(spec)
    n, r, d = spec.in_modes, spec.ranks, spec.d
    offs, total = [], 0
    for k in range(d):
        offs.append(total)
        total += _pad4(r[k] * n[k] * r[k + 1])
    bufs = [[0, 0], [0, 0]]
    for half, (k0, k1) in enumerate(((0, plan.rho), (plan.rho, d))):
        if k0 < k1:
            rows = r[k0] * n[k0]
            for i, k in enumerate(range(k0 + 1, k1), start=1):
                rows *= n[k]
                bufs[half][i % 2] = max(bufs[half][i % 2], rows * r[k + 1])
    buf_off = []
    for size in (bufs[0][0], bufs[0][1], bufs[1][0], bufs[1][1]):
        buf_off.append(total)
        total += _pad4(size)
    layout = [plan.rho, *offs, *buf_off, total, total + 4]
    arrays = tuple(_build.int_array(v) for v in (spec.in_modes, spec.out_modes, spec.ranks))
    return plan, arrays, spec.core_matrix_shapes(), _build.int_array(layout)


def _slabs(t: int, p: int) -> int:
    """CTAs a token's rows are split over: enough for ~2 CTAs an SM of the
    card's 132 when there are few tokens, at least 4 rows each."""
    return max(1, min(-(-p // 4), -(-264 // t)))


def _tt_embed_cuda(ids, cores, spec: TTSpec):
    _build.refuse_grad("tt_embed", *cores)
    global launches
    if ids.dtype not in (torch.int32, torch.int64) or not ids.is_cuda:
        raise ValueError(f"ids must be a CUDA int32/int64 tensor; got {ids.dtype}")
    if len(cores) != spec.d or spec.d > 8:
        raise ValueError(f"expected {spec.d} cores (at most 8); got {len(cores)}")
    dtype = cores[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tt_embed kernel takes f32/bf16 cores, got {dtype}")
    plan, (in_m, out_m, ranks), shapes, layout = _spec_info(spec)
    for c, shp in zip(cores, shapes):
        if c.shape != shp or c.dtype != dtype or not c.is_cuda or not c.is_contiguous():
            raise ValueError(f"core must be a contiguous CUDA {dtype} {shp}; "
                             f"got {tuple(c.shape)} {c.dtype}")
    lead = ids.shape
    flat = ids.reshape(-1)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    t = flat.shape[0]
    out = torch.empty(*lead, spec.n_in, dtype=torch.float32, device=ids.device)
    if t == 0:
        return out
    err = _build.lib().rt_tt_embed(
        flat.data_ptr(), flat.dtype == torch.int64,
        (_build.P * spec.d)(*[c.data_ptr() for c in cores]), int(dtype == torch.bfloat16),
        out.data_ptr(), t, spec.d, in_m, out_m, ranks, layout, _slabs(t, plan.p),
        _build.stream(ids))
    _build.check(err, "tt_embed")
    launches += 1
    return out


def tt_embed(ids, cores, spec: TTSpec):
    """(..., D) f32 rows: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if not ids.is_cuda:
        return tt_embed_ref(ids, cores, spec)
    return _tt_embed_cuda(ids, cores, spec)
