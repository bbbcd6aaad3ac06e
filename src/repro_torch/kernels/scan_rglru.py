"""RG-LRU recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t²) gx_t`` (griffin).

``rglru_scan`` runs the CUDA kernel (``csrc/rglru_scan.cu``: a serial walk
over S for prefill, one fused step for every slot at decode) on a CUDA
tensor and the plain PyTorch version on a CPU tensor.  Replaces both bodies
of ``repro/kernels/scan_rglru.py::rglru_scan_pallas``.

Both carry the state in f32, write ``h`` in ``scan_dtype`` and return the
f32 final state, as the Pallas kernel does.  A padding step (``pos`` -1)
leaves the state untouched bitwise, so a row with no real step returns
``h0`` bitwise; its ``h`` rows are the carried state in ``scan_dtype``.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0
plain_cuda_calls = 0


def _check_shapes(log_a, gx, h0, pos):
    if log_a.ndim != 3 or log_a.shape != gx.shape:
        raise ValueError(f"log_a/gx must both be (B, S, W); got {tuple(log_a.shape)} vs "
                         f"{tuple(gx.shape)}")
    b, s, w = log_a.shape
    if tuple(h0.shape) != (b, w):
        raise ValueError(f"h0 must be (B, W) = {(b, w)}; got {tuple(h0.shape)}")
    if pos is not None and tuple(pos.shape) != (b, s):
        raise ValueError(f"pos must be (B, S) = {(b, s)}; got {tuple(pos.shape)}")


def rglru_scan_plain(log_a, gx, h0, pos=None, *, scan_dtype=None):
    """The recurrence step by step in f32: log_a, gx (B, S, W), h0 (B, W),
    pos (B, S) int (``-1`` = padding step) or None (every step real).
    Returns (h (B, S, W) in ``scan_dtype`` (default f32), h_last (B, W) f32)."""
    _check_shapes(log_a, gx, h0, pos)
    f32 = torch.float32
    log_a, gx = log_a.to(f32), gx.to(f32)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gx
    real = None if pos is None else (pos >= 0)[:, :, None]
    h = h0.to(f32)
    hs = []
    for t in range(log_a.shape[1]):
        step = a[:, t] * h + b[:, t]
        h = step if real is None else torch.where(real[:, t], step, h)
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else log_a.new_empty(log_a.shape)
    return out.to(scan_dtype or f32), h


def rglru_scan_ref(log_a, gx, h0, pos=None, *, scan_dtype=None):
    """The plain version; it counts the calls handed CUDA tensors."""
    global plain_cuda_calls
    plain_cuda_calls += log_a.is_cuda
    return rglru_scan_plain(log_a, gx, h0, pos, scan_dtype=scan_dtype)


def _rglru_scan_cuda(log_a, gx, h0, pos, scan_dtype):
    global launches
    _check_shapes(log_a, gx, h0, pos)
    for nm, t in (("log_a", log_a), ("gx", gx), ("h0", h0)):
        if t.dtype != torch.float32 or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"{nm} must be a contiguous CUDA f32 tensor")
    if pos is not None and (pos.dtype != torch.int32 or not pos.is_contiguous()
                            or not pos.is_cuda):
        raise ValueError("pos must be a contiguous CUDA int32 tensor")
    out_dtype = scan_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scan_dtype must be f32 or bf16, got {out_dtype}")
    b, s, w = log_a.shape
    h = torch.empty((b, s, w), dtype=out_dtype, device=log_a.device)
    h_last = torch.empty((b, w), dtype=torch.float32, device=log_a.device)
    if s == 0:
        return h, h_last.copy_(h0)
    err = _build.lib().rt_rglru_scan(
        log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(), _build.ptr(pos), h.data_ptr(),
        h_last.data_ptr(), b, s, w, _build.dtype_code(h), _build.stream(log_a))
    _build.check(err, "rglru_scan")
    launches += 1
    return h, h_last


def rglru_scan(log_a, gx, h0, pos=None, *, scan_dtype=None):
    """(h (B, S, W) scan_dtype, h_last (B, W) f32): the kernel on a CUDA
    tensor (S == 1 takes the decode kernel), the plain version on a CPU
    tensor."""
    if not log_a.is_cuda:
        return rglru_scan_ref(log_a, gx, h0, pos, scan_dtype=scan_dtype)
    return _rglru_scan_cuda(log_a, gx, h0, pos, scan_dtype)
