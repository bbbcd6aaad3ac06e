"""Paged decode attention (one query token per sequence).

``paged_attention`` runs the CUDA kernel (``csrc/paged_attention.cu``) on a
CUDA tensor and the plain gather + masked-softmax version on a CPU tensor.
Replaces ``repro/kernels/paged_attention.py::paged_attention_pallas``.  The
masked softmax over explicit key positions (``ring_attention_plain``) is the
plain version of every attention kernel: ``paged_attention_plain`` (any Sq,
optional window) runs it over the gathered pool.
"""
from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30

launches = 0
plain_cuda_calls = 0


def gather_paged_kv(cache: dict, block_tables: torch.Tensor):
    """(B, W*BS, Hkv, Dh) f32 K and V views of the pool; gathered index i
    holds the sequence's absolute position i (int8 pools dequantized)."""
    bt = block_tables.long()
    k = cache["k"][bt].to(torch.float32)  # (B, W, BS, Hkv, Dh)
    v = cache["v"][bt].to(torch.float32)
    if "k_scale" in cache:
        k = k * cache["k_scale"][bt][..., None]
        v = v * cache["v_scale"][bt][..., None]
    b, w, bs, hkv, dh = k.shape
    return k.reshape(b, w * bs, hkv, dh), v.reshape(b, w * bs, hkv, dh)


def ring_attention_plain(q, k, v, qpos, kpos, *, window: int = 0, sm_scale=None,
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention of (B, Sq, H, Dh) queries
    at qpos (B, Sq) against keys k, v (B, K, Hkv, Dh) at positions kpos
    (B, K) in any order; ``-1`` marks a padding query (zero output) or an
    empty key (never attended).  int8 keys carry (B, K, Hkv) f32
    ``k_scale``/``v_scale``.  Mirrors ``repro.kernels.ref.ring_attention``;
    the plain version of the ring layout and, over the gathered pool, of the
    paged kernels."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    sm_scale = sm_scale or (1.0 / math.sqrt(dh))
    k, v = k.to(torch.float32), v.to(torch.float32)
    if k_scale is not None:
        k = k * k_scale[..., None]
        v = v * v_scale[..., None]
    qh = q.reshape(b, sq, hkv, g, dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k) * sm_scale
    qpos, kpos = qpos.to(torch.int32), kpos.to(torch.int32)
    mask = (kpos[:, None, :] >= 0) & (qpos[:, :, None] >= 0) \
        & (kpos[:, None, :] <= qpos[:, :, None])
    if window > 0:
        mask &= qpos[:, :, None] - kpos[:, None, :] < window
    maskb = mask[:, None, None]
    s = torch.where(maskb, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * maskb
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v)
    o = torch.where(l > 0, o / torch.clamp(l, min=1e-30), torch.zeros_like(o))
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def paged_attention_plain(q, cache: dict, block_tables, qpos, *, sm_scale=None,
                          window: int = 0) -> torch.Tensor:
    """Causal attention of (B, Sq, H, Dh) queries at positions qpos (B, Sq)
    (``-1`` = padding, zero output) against the paged pool; mirrors
    ``repro.kernels.ref.paged_attention``: the gathered index i holds the
    sequence's position i."""
    k, v = gather_paged_kv(cache, block_tables)
    kpos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    return ring_attention_plain(q, k, v, qpos, kpos.expand(k.shape[0], -1),
                                window=window, sm_scale=sm_scale)


HEAD_DIMS = (64, 128)  # what the decode kernel takes


def check_paged_args(q, cache, block_tables, qpos, sq: int, head_dims=HEAD_DIMS):
    """Device/dtype/shape/contiguity checks shared by both paged kernels;
    ``head_dims``: the calling kernel's."""
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError(f"q must be contiguous f32/bf16; got {q.dtype}")
    if dh not in head_dims:
        raise ValueError(f"this paged attention kernel takes head_dim {head_dims}, got {dh}")
    k, v = cache["k"], cache["v"]
    if k.ndim != 4 or k.shape != v.shape or k.shape[-1] != dh or k.dtype != v.dtype:
        raise ValueError("k/v pools must both be (NB, BS, Hkv, Dh) of one dtype")
    if k.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"pool dtype {k.dtype} not supported")
    if not (k.is_cuda and v.is_cuda and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k/v pools must be contiguous CUDA tensors")
    hkv = k.shape[2]
    g = h // hkv if hkv else 0
    if hkv == 0 or h % hkv or g % min(g, 16):
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv} with a GQA group "
                         "of at most 16 or a multiple of 16")
    quantized = k.dtype == torch.int8
    if quantized != ("k_scale" in cache):
        raise ValueError("int8 pools need k_scale/v_scale; float pools take none")
    if quantized:
        for nm in ("k_scale", "v_scale"):
            sc = cache[nm]
            if sc.shape != k.shape[:3] or sc.dtype != torch.float32 \
                    or not sc.is_contiguous() or not sc.is_cuda:
                raise ValueError(f"{nm} must be contiguous CUDA f32 {tuple(k.shape[:3])}")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 \
            or block_tables.shape[0] != b or not block_tables.is_contiguous():
        raise ValueError("block_tables must be contiguous int32 (B, W)")
    if qpos.dtype != torch.int32 or qpos.numel() != b * sq or not qpos.is_contiguous():
        raise ValueError(f"qpos must be contiguous int32 with {b * sq} entries")
    return quantized


def _paged_attention_cuda(q, cache, block_tables, qpos, sm_scale):
    global launches
    if q.ndim != 3:
        raise ValueError(f"decode q must be (B, H, Dh); got {tuple(q.shape)}")
    quantized = check_paged_args(q, cache, block_tables, qpos, 1)
    b, h, dh = q.shape
    nb, bs, hkv, _ = cache["k"].shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = _build.lib().rt_paged_decode_attention(
        q.data_ptr(), cache["k"].data_ptr(), cache["v"].data_ptr(),
        _build.ptr(cache["k_scale"]) if quantized else None,
        _build.ptr(cache["v_scale"]) if quantized else None,
        block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(),
        b, h, hkv, dh, bs, block_tables.shape[1], 0,
        float(sm_scale or (1.0 / math.sqrt(dh))), _build.dtype_code(q),
        _build.dtype_code(cache["k"]), _build.stream(q))
    _build.check(err, "paged_attention")
    launches += 1
    return out


def paged_attention(q, cache: dict, block_tables, qpos, *, sm_scale=None) -> torch.Tensor:
    """Decode attention, q (B, H, Dh), qpos (B,) -> (B, H, Dh): the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if not q.is_cuda:
        return paged_attention_ref(q, cache, block_tables, qpos, sm_scale=sm_scale)
    return _paged_attention_cuda(q, cache, block_tables, qpos, sm_scale)


def paged_attention_ref(q, cache: dict, block_tables, qpos, *, sm_scale=None):
    """The plain decode version; it counts the calls handed CUDA tensors."""
    global plain_cuda_calls
    plain_cuda_calls += q.is_cuda
    return paged_attention_plain(q[:, None], cache, block_tables, qpos[:, None],
                                 sm_scale=sm_scale)[:, 0]
