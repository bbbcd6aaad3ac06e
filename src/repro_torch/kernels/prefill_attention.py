"""Ragged chunked-prefill attention over the paged pool.

``prefill_attention`` runs the CUDA kernel (``csrc/prefill_attention.cu``)
on a CUDA tensor and the plain gather + masked-softmax version on a CPU
tensor.  Replaces the paged layout of
``repro/kernels/prefill_attention.py::prefill_attention_pallas``; the ring
layout belongs to a later slice.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .paged_attention import check_paged_args, paged_attention_plain

launches = 0
plain_cuda_calls = 0


def prefill_attention_ref(q, qpos, *, cache, block_tables, window: int = 0,
                          sm_scale=None) -> torch.Tensor:
    """The plain version; it counts the calls handed CUDA tensors."""
    global plain_cuda_calls
    plain_cuda_calls += q.is_cuda
    return paged_attention_plain(q, cache, block_tables, qpos, sm_scale=sm_scale,
                                 window=window)


def _prefill_attention_cuda(q, qpos, cache, block_tables, window, sm_scale):
    global launches
    if q.ndim != 4 or qpos.shape != q.shape[:2]:
        raise ValueError(f"q must be (B, Sq, H, Dh) and qpos (B, Sq); got "
                         f"{tuple(q.shape)} / {tuple(qpos.shape)}")
    b, sq, h, dh = q.shape
    quantized = check_paged_args(q, cache, block_tables, qpos, sq)
    nb, bs, hkv, _ = cache["k"].shape
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    err = _build.lib().rt_paged_prefill_attention(
        q.data_ptr(), cache["k"].data_ptr(), cache["v"].data_ptr(),
        _build.ptr(cache["k_scale"]) if quantized else None,
        _build.ptr(cache["v_scale"]) if quantized else None,
        block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(),
        b, sq, h, hkv, dh, bs, block_tables.shape[1], int(window),
        float(sm_scale or (1.0 / math.sqrt(dh))), _build.dtype_code(q),
        _build.dtype_code(cache["k"]), _build.stream(q))
    _build.check(err, "prefill_attention")
    launches += 1
    return out


def prefill_attention(q, qpos, *, cache: dict, block_tables, window: int = 0,
                      sm_scale=None) -> torch.Tensor:
    """q (B, Sq, H, Dh), qpos (B, Sq) (``-1`` = padding row -> zeros): the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not q.is_cuda:
        return prefill_attention_ref(q, qpos, cache=cache, block_tables=block_tables,
                                     window=window, sm_scale=sm_scale)
    return _prefill_attention_cuda(q, qpos, cache, block_tables, window, sm_scale)
