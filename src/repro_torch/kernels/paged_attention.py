"""Paged decode attention (one query token per sequence).

``paged_attention`` runs the CUDA kernel (``csrc/paged_attention.cu``, its
CTA body in ``csrc/flash_decode.cuh``) on a CUDA tensor and the plain gather
+ masked-softmax version on a CPU tensor.  Replaces
``repro/kernels/paged_attention.py::paged_attention_pallas``.  The masked
softmax over explicit key positions (``ring_attention_plain``) is the plain
version of every attention kernel: ``paged_attention_plain`` (any Sq,
optional window) runs it over the gathered pool.

The kernel splits each sequence's table across CTAs and merges the splits
in the same launch.  Its plan is written out here as plain functions, for
the CPU tests and for ``chip_smoke.py``: ``decode_plan`` (the splits, from
the shapes alone) and ``split_paged_decode`` (the splits' partial softmaxes
and the last arriver's merge in split order, emulated in float32).
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


HEAD_DIMS = (64, 112, 128, 256)  # what the decode kernel takes
KEY_TILE = 64      # entries a tile of the kernel's tensor-core body
MAX_SPLIT = 256    # entries a split, while 64 splits cover the table
MAX_SPLITS = 64    # most splits the in-launch merge takes
HEAD_TILE = 16     # most GQA heads a CTA


def check_paged_args(q, cache, block_tables, qpos, sq: int, head_dims=HEAD_DIMS):
    """Device/dtype/shape/contiguity checks shared by both paged kernels;
    ``head_dims``: the calling kernel's (the decode kernel's ``HEAD_DIMS``
    by default, the prefill kernel's ``prefill_attention.HEAD_DIMS``); a
    head dim past them is refused by name, never truncated."""
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


def head_tile(g: int) -> int:
    """The GQA heads a CTA scores: the largest divisor of the group ``g``
    that is at most 16 (10 for recurrentgemma-2b's group of 10)."""
    gt = min(g, HEAD_TILE)
    while g % gt:
        gt -= 1
    return gt


def decode_plan(entries: int) -> tuple[int, int]:
    """(splits, entries a split) for tables of ``entries`` = W * BS
    positions: splits of 256 entries (four 64-entry tiles), longer only
    where 64 splits (the merge's limit) would not cover the table.  Chosen
    from the table width alone (reading qpos on the host would stall the
    decode tick).  A device-time sweep at the serve shapes (B 8, 64-1600
    keys; PERF.md §6, PR 17) found 256 the best or within noise of the best
    of 64-768 entries a split at every shape: shorter splits add CTAs whose
    fixed chain (block table, K/V, partials, fence, count) and a longer
    merge cost more than the parallelism buys."""
    kps = max(MAX_SPLIT, -(-entries // MAX_SPLITS // KEY_TILE) * KEY_TILE)
    return -(-entries // kps), kps


_workspace: dict = {}


def _decode_workspace(device, n_part: int, n_count: int):
    """The f32 partials and the int32 split counters of one device and size,
    made once and reused: the counters start at 0 and every launch leaves
    them at 0, so a call needs no zero-filling launch."""
    key = (device.index, n_part, n_count)
    if key not in _workspace:
        _workspace[key] = (torch.empty(n_part, dtype=torch.float32, device=device),
                           torch.zeros(n_count, dtype=torch.int32, device=device))
    return _workspace[key]


def _paged_attention_cuda(q, cache, block_tables, qpos, sm_scale):
    _build.refuse_grad("paged_attention", q, *cache.values())
    global launches
    if q.ndim != 3:
        raise ValueError(f"decode q must be (B, H, Dh); got {tuple(q.shape)}")
    quantized = check_paged_args(q, cache, block_tables, qpos, 1)
    b, h, dh = q.shape
    nb, bs, hkv, _ = cache["k"].shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    w = block_tables.shape[1]
    g = h // hkv
    splits, kps = decode_plan(w * bs)
    part, count = _decode_workspace(q.device, b * h * splits * (dh + 2),
                                    b * hkv * (g // head_tile(g)))
    err = _build.lib().rt_paged_decode_attention(
        q.data_ptr(), cache["k"].data_ptr(), cache["v"].data_ptr(),
        _build.ptr(cache["k_scale"]) if quantized else None,
        _build.ptr(cache["v_scale"]) if quantized else None,
        block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(), part.data_ptr(),
        count.data_ptr(), b, h, hkv, dh, bs, w,
        float(sm_scale or (1.0 / math.sqrt(dh))), _build.dtype_code(q),
        _build.dtype_code(cache["k"]), splits, kps, _build.stream(q))
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


def split_paged_decode(q, cache: dict, block_tables, qpos, splits: int, kps: int,
                       tile: int = KEY_TILE, *, sm_scale=None) -> torch.Tensor:
    """The kernel's plan emulated in float32: q (B, H, Dh) at qpos (B,) over
    the paged pool, each sequence's W * BS table entries cut into ``splits``
    ranges of ``kps``; a split past qpos is not live and adds nothing; a live
    split walks its entries ``tile`` at a time with an online softmax, and
    its partial (m, l, unnormalized o) joins the merge, which runs over the
    live splits in split order as the last CTA to arrive does.  qpos -1
    gives zeros.  Returns (B, H, Dh) in ``q.dtype``."""
    k, v = gather_paged_kv(cache, block_tables)  # (B, W*BS, Hkv, Dh) by position
    b, h, dh = q.shape
    hkv, entries = k.shape[2], k.shape[1]
    g = h // hkv
    if splits * kps < entries or (splits - 1) * kps >= entries:
        raise ValueError(f"{splits} splits of {kps} entries do not cover {entries}")
    scale = sm_scale or (1.0 / math.sqrt(dh))
    out = torch.zeros(b, h, dh)
    for i in range(b):
        qp = int(qpos[i])
        if qp < 0:
            continue
        live = min(splits, qp // kps + 1)
        qh = q[i].reshape(hkv, g, dh).to(torch.float32)
        parts = []
        for sp in range(live):
            m = torch.full((hkv, g), NEG_INF)
            l = torch.zeros(hkv, g)
            o = torch.zeros(hkv, g, dh)
            for t0 in range(sp * kps, min((sp + 1) * kps, entries, qp + 1), tile):
                e = torch.arange(t0, min(t0 + tile, (sp + 1) * kps, entries))
                ok = e <= qp
                s = torch.einsum("hgd,khd->hgk", qh, k[i, e]) * scale
                s = torch.where(ok, s, torch.full((), NEG_INF))
                mn = torch.maximum(m, s.amax(-1))
                p = torch.where(ok, torch.exp(s - mn[..., None]), torch.zeros(()))
                c = torch.exp(m - mn)
                l = l * c + p.sum(-1)
                o = o * c[..., None] + torch.einsum("hgk,khd->hgd", p, v[i, e])
                m = mn
            parts.append((m, l, o))
        big_m = torch.stack([m for m, _, _ in parts]).amax(0)
        big_l = torch.zeros(hkv, g)
        big_o = torch.zeros(hkv, g, dh)
        for m, l, o in parts:  # split order
            wgt = torch.exp(m - big_m)
            big_l = big_l + wgt * l
            big_o = big_o + wgt[..., None] * o
        res = torch.where(big_l[..., None] > 0, big_o / big_l.clamp(min=1e-30)[..., None],
                          torch.zeros(()))
        out[i] = res.reshape(h, dh)
    return out.to(q.dtype)
