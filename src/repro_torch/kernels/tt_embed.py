"""Rows of a vocab-axis TT embedding table (TensorGPT layout).

The (V, D) table is the TT's (M, N) weight with M = V, so a lookup never
builds the table: each id splits into its big-endian ``out_modes`` digits,
digit k selects the (r_{k-1}, n_k, r_k) block of core matrix C_k (rows
(r, n), columns (m, r) m-major), and the blocks are chained left to right.
Ids resolve like the dense gather: a negative id wraps once (-1 is row
V - 1), then every id clamps into [0, V).

``tt_embed`` runs the CUDA kernel (``csrc/tt_embed.cu``: one CTA per token,
a direct indexed load of each selected block, the chain in shared memory in
f32) on a CUDA tensor and the plain PyTorch version on a CPU tensor.
Replaces ``repro/kernels/tt_embed.py::tt_embed_pallas``.  Both return f32
rows.
"""
from __future__ import annotations

import math

import torch

from ..core.ttd import TTSpec
from . import _build
from .tt_linear import _int_array

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


def _buffers(spec: TTSpec) -> tuple[int, int, int]:
    """Floats of shared memory the kernel needs: the largest selected block,
    and the two ping-pong buffers for the chain's even and odd stages (the
    last stage writes the output row directly)."""
    sel = max(spec.ranks[k] * spec.in_modes[k] * spec.ranks[k + 1] for k in range(spec.d))
    bufs = [0, 0]
    for k in range(spec.d - 1):
        width = math.prod(spec.in_modes[:k + 1]) * spec.ranks[k + 1]
        bufs[k % 2] = max(bufs[k % 2], width)
    return sel, bufs[0], bufs[1]


def _tt_embed_cuda(ids, cores, spec: TTSpec):
    global launches
    if ids.dtype not in (torch.int32, torch.int64) or not ids.is_cuda:
        raise ValueError(f"ids must be a CUDA int32/int64 tensor; got {ids.dtype}")
    if len(cores) != spec.d or spec.d > 8:
        raise ValueError(f"expected {spec.d} cores (at most 8); got {len(cores)}")
    dtype = cores[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tt_embed kernel takes f32/bf16 cores, got {dtype}")
    for c, shp in zip(cores, spec.core_matrix_shapes()):
        if tuple(c.shape) != shp or c.dtype != dtype or not c.is_cuda \
                or not c.is_contiguous():
            raise ValueError(f"core must be a contiguous CUDA {dtype} {shp}; "
                             f"got {tuple(c.shape)} {c.dtype}")
    lead = ids.shape
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    t = flat.shape[0]
    out = torch.empty(*lead, spec.n_in, dtype=torch.float32, device=ids.device)
    if t == 0:
        return out
    sel, buf0, buf1 = _buffers(spec)
    err = _build.lib().rt_tt_embed(
        flat.data_ptr(), (_build.P * spec.d)(*[c.data_ptr() for c in cores]),
        _build.dtype_code(cores[0]), out.data_ptr(), t, spec.d,
        _int_array(spec.in_modes), _int_array(spec.out_modes), _int_array(spec.ranks),
        sel, buf0, buf1, _build.stream(ids))
    _build.check(err, "tt_embed")
    launches += 1
    return out


def tt_embed(ids, cores, spec: TTSpec):
    """(..., D) f32 rows: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if not ids.is_cuda:
        return tt_embed_ref(ids, cores, spec)
    return _tt_embed_cuda(ids, cores, spec)
