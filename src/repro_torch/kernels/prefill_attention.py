"""Ragged chunked-prefill attention over the paged pool or per-slot rings.

``prefill_attention`` (paged pool, ``csrc/prefill_attention.cu``) and
``ring_attention`` (per-slot rings with explicit key positions,
``csrc/ring_attention.cu``: a flash kernel for Sq > 1, a split-KV pass and
a combine pass for ring decode, Sq = 1) run their
CUDA kernel on a CUDA tensor and the plain masked-softmax version on a CPU
tensor.  Together they replace both layouts of
``repro/kernels/prefill_attention.py::prefill_attention_pallas``.  Each
layout has its own launch counter.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .paged_attention import check_paged_args, paged_attention_plain, ring_attention_plain

launches = 0
plain_cuda_calls = 0
ring_launches = 0  # 1 a prefill call, 2 a decode call (split pass and combine)
ring_plain_cuda_calls = 0


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


# ---------------------------------------------------------------------------
# Ring layout
# ---------------------------------------------------------------------------
def ring_attention_ref(q, qpos, *, k, v, kpos, window: int = 0, sm_scale=None,
                       k_scale=None, v_scale=None) -> torch.Tensor:
    """The plain ring version; it counts the calls handed CUDA tensors."""
    global ring_plain_cuda_calls
    ring_plain_cuda_calls += q.is_cuda
    return ring_attention_plain(q, k, v, qpos, kpos, window=window, sm_scale=sm_scale,
                                k_scale=k_scale, v_scale=v_scale)


def check_ring_args(q, k, v, qpos, kpos, k_scale, v_scale) -> bool:
    """Device/dtype/shape/contiguity checks of the ring kernel; True for
    int8 rings."""
    if q.ndim != 4 or q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError(f"q must be contiguous f32/bf16 (B, Sq, H, Dh); got "
                         f"{q.dtype} {tuple(q.shape)}")
    b, sq, h, dh = q.shape
    if dh not in (64, 128, 256):
        raise ValueError(f"the ring attention kernel takes head_dim 64, 128 or 256, got {dh}")
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[-1] != dh \
            or k.dtype != v.dtype:
        raise ValueError(f"k/v rings must both be ({b}, WR, Hkv, {dh}) of one dtype; got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if k.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"ring dtype {k.dtype} not supported")
    if not (k.is_cuda and v.is_cuda and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k/v rings must be contiguous CUDA tensors")
    wr, hkv = k.shape[1], k.shape[2]
    g = h // hkv if hkv else 0
    if hkv == 0 or h % hkv or (g > 64 and g % 64):
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv} with a GQA group of at "
                         "most 64 or a multiple of 64")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None):
        raise ValueError("int8 rings need k_scale/v_scale; float rings take none")
    if quantized:
        for nm, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc is None or sc.shape != k.shape[:3] or sc.dtype != torch.float32 \
                    or not sc.is_contiguous() or not sc.is_cuda:
                raise ValueError(f"{nm} must be contiguous CUDA f32 {tuple(k.shape[:3])}")
    for nm, p, shape in (("qpos", qpos, (b, sq)), ("kpos", kpos, (b, wr))):
        if p.dtype != torch.int32 or tuple(p.shape) != shape or not p.is_contiguous() \
                or not p.is_cuda:
            raise ValueError(f"{nm} must be contiguous CUDA int32 {shape}")
    return quantized


def decode_splits(b: int, wr: int, hkv: int) -> int:
    """Splits of the ring for decode: enough CTAs (B x Hkv x splits) for
    three an SM of the H100's 132, at least 64 entries (one tile) a split."""
    return max(1, min(-(-wr // 64), -(-3 * 132 // (b * hkv))))


def _ring_attention_cuda(q, qpos, k, v, kpos, window, sm_scale, k_scale, v_scale):
    global ring_launches
    quantized = check_ring_args(q, k, v, qpos, kpos, k_scale, v_scale)
    b, sq, h, dh = q.shape
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    wr, hkv = k.shape[1], k.shape[2]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _build.ptr(k_scale) if quantized else None,
            _build.ptr(v_scale) if quantized else None,
            kpos.data_ptr(), qpos.data_ptr(), out.data_ptr())
    scale = float(sm_scale or (1.0 / math.sqrt(dh)))
    codes = (_build.dtype_code(q), _build.dtype_code(k))
    if sq == 1:  # decode: the split-KV pass, then the combine
        splits = decode_splits(b, wr, hkv)
        part = torch.empty(b * h * splits * (dh + 2), dtype=torch.float32, device=q.device)
        err = _build.lib().rt_ring_decode_attention(
            *args, part.data_ptr(), b, h, hkv, dh, wr, int(window), scale, *codes, splits,
            _build.stream(q))
        n = 2
    else:
        err = _build.lib().rt_ring_prefill_attention(
            *args, b, sq, h, hkv, dh, wr, int(window), scale, *codes, _build.stream(q))
        n = 1
    _build.check(err, "ring_attention")
    ring_launches += n
    return out


def ring_attention(q, qpos, *, k, v, kpos, window: int = 0, sm_scale=None,
                   k_scale=None, v_scale=None) -> torch.Tensor:
    """q (B, Sq, H, Dh) at qpos (B, Sq) against rings k/v (B, WR, Hkv, Dh) at
    kpos (B, WR): the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    kw = dict(k=k, v=v, kpos=kpos, window=window, sm_scale=sm_scale,
              k_scale=k_scale, v_scale=v_scale)
    if not q.is_cuda:
        return ring_attention_ref(q, qpos, **kw)
    return _ring_attention_cuda(q, qpos, k, v, kpos, window, sm_scale, k_scale, v_scale)
