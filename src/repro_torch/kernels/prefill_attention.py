"""Ragged chunked-prefill attention over the paged pool or per-slot rings.

``prefill_attention`` (paged pool, ``csrc/prefill_attention.cu``) and
``ring_attention`` (per-slot rings with explicit key positions,
``csrc/ring_attention.cu``: a flash kernel for Sq > 1, a split-KV pass and
a combine pass for ring decode, Sq = 1) run their
CUDA kernel on a CUDA tensor and the plain masked-softmax version on a CPU
tensor.  Together they replace both layouts of
``repro/kernels/prefill_attention.py::prefill_attention_pallas``.  Each
layout has its own launch counter.

The plan of the bf16 flash tile both layouts run for Sq > 1
(``csrc/flash_attention.cuh`` tc_kernel) is written out here as plain
functions, for the CPU tests and for ``chip_smoke.py``'s tile counts:
``row_plan``/``row_map`` (which (query, head) pairs a CTA's 128 rows hold),
``visible_tiles``/``tiles_walked`` (which 64-entry key tiles a CTA walks)
and ``tile_walk_attention`` (the loop itself, emulated in float32).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .paged_attention import (NEG_INF, check_paged_args, paged_attention_plain,
                              ring_attention_plain)

HEAD_DIMS = (64, 112, 128, 256)  # what both layouts' kernels take (ring: Sq = 1 too)
ROW_TILE = 128  # (position, GQA head) rows a CTA of the bf16 tile
KEY_TILE = 64   # entries a key tile

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
    _build.refuse_grad("prefill_attention", q, *cache.values())
    global launches
    if q.ndim != 4 or qpos.shape != q.shape[:2]:
        raise ValueError(f"q must be (B, Sq, H, Dh) and qpos (B, Sq); got "
                         f"{tuple(q.shape)} / {tuple(qpos.shape)}")
    b, sq, h, dh = q.shape
    quantized = check_paged_args(q, cache, block_tables, qpos, sq, HEAD_DIMS)
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
    if dh not in HEAD_DIMS:
        raise ValueError(f"the ring attention kernel takes head_dim {HEAD_DIMS}, got {dh}")
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
    _build.refuse_grad("ring_attention", q, k, v, k_scale, v_scale)
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


# ---------------------------------------------------------------------------
# The bf16 flash tile's plan, as plain functions (csrc/flash_attention.cuh)
# ---------------------------------------------------------------------------
def row_plan(g: int) -> tuple[int, int]:
    """(GT, QT) for a GQA group of ``g`` heads: a CTA's rows are GT heads of
    the group (the largest divisor of ``g`` that is at most 128) times QT =
    128 // GT query positions; 12 x 10 = 120 rows for a group of 10."""
    gt = min(g, ROW_TILE)
    while g % gt:
        gt -= 1
    return gt, ROW_TILE // gt


def row_map(sq: int, h: int, hkv: int) -> torch.Tensor:
    """(CTAs, 128, 2) int64: the (query index, head) pair of every row of
    every CTA of one sequence, CTAs in grid order (query tile, kv head,
    head tile); -1 marks an idle row."""
    g = h // hkv
    gt, qt = row_plan(g)
    nqt = -(-sq // qt)
    r = torch.arange(qt * gt)
    out = torch.full((nqt, hkv, g // gt, ROW_TILE, 2), -1, dtype=torch.int64)
    for t in range(nqt):
        s = t * qt + r // gt
        live = s < sq
        for kvh in range(hkv):
            for z in range(g // gt):
                head = kvh * g + z * gt + r % gt
                out[t, kvh, z, :qt * gt][live] = torch.stack([s, head], -1)[live]
    return out.reshape(-1, ROW_TILE, 2)


def _may_see(qmin: int, qmax: int, kmin: int, kmax: int, window: int) -> bool:
    """Whether a key in [kmin, kmax] can be visible to a row in [qmin, qmax]."""
    return kmin <= qmax and (window <= 0 or qmin - kmax < window)


def visible_tiles(row_qpos, kpos=None, *, window: int = 0) -> list[int]:
    """The 64-entry key tiles one CTA walks, in order, for its rows'
    positions ``row_qpos`` (-1 = padding).  Ring layout (``kpos``: the
    sequence's (WR,) entry positions, -1 = empty): a tile is kept iff its
    smallest non-empty position is <= the rows' largest and, with a window,
    the rows' smallest minus its largest is < window, so no tile holding a
    key visible to some row is dropped.  Paged layout (``kpos`` None, entry e
    holds position e): the tiles of [max(0, qmin - window + 1), qmax]."""
    row_qpos = torch.as_tensor(row_qpos)
    live = row_qpos[row_qpos >= 0]
    if live.numel() == 0:
        return []
    qmin, qmax = int(live.min()), int(live.max())
    if kpos is None:
        lo = max(0, qmin - window + 1) if window > 0 else 0
        return list(range(lo // KEY_TILE, qmax // KEY_TILE + 1))
    kpos = torch.as_tensor(kpos)
    tiles = []
    for t in range(-(-kpos.shape[0] // KEY_TILE)):
        p = kpos[t * KEY_TILE:(t + 1) * KEY_TILE]
        p = p[p >= 0]
        if p.numel() and _may_see(qmin, qmax, int(p.min()), int(p.max()), window):
            tiles.append(t)
    return tiles


def tiles_walked(qpos, h: int, hkv: int, kpos=None, *, window: int = 0) -> tuple[int, int]:
    """(tiles walked, tiles without the rule) summed over a call's CTAs:
    without it a ring CTA walks all WR / 64 tiles and a paged one the
    tiles of keys 0 .. its rows' largest position."""
    qpos = torch.as_tensor(qpos).cpu()
    b, sq = qpos.shape
    gt, qt = row_plan(h // hkv)
    heads = hkv * (h // hkv // gt)  # CTAs a query tile
    walked = total = 0
    for i in range(b):
        kp = None if kpos is None else torch.as_tensor(kpos)[i].cpu()
        for q0 in range(0, sq, qt):
            rows = qpos[i, q0:q0 + qt]
            walked += heads * len(visible_tiles(rows, kp, window=window))
            if kp is not None:
                total += heads * -(-kp.shape[0] // KEY_TILE)
            elif rows.max() >= 0:
                total += heads * (int(rows.max()) // KEY_TILE + 1)
    return walked, total


def tile_walk_attention(q, k, v, qpos, kpos=None, *, window: int = 0, sm_scale=None,
                        k_scale=None, v_scale=None) -> torch.Tensor:
    """The bf16 tile's loop emulated in float32, in its row packing and tile
    order: each CTA visits its ``visible_tiles`` in order and runs an online
    softmax per row, scores masked per element to -1e30, a row that sees no
    key returning 0.  ``k``/``v`` (B, K, Hkv, Dh) are rings at ``kpos``, or,
    with ``kpos`` None, the paged context gathered by position (entry e =
    position e; entries past a CTA's largest row position are empty, as the
    kernel treats them).  Returns (B, Sq, H, Dh) in ``q.dtype``."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    gt, qt = row_plan(g)
    scale = sm_scale or (1.0 / math.sqrt(dh))
    k, v = k.to(torch.float32), v.to(torch.float32)
    if k_scale is not None:
        k, v = k * k_scale[..., None], v * v_scale[..., None]
    n_ent = k.shape[1]
    out = torch.zeros(b, sq, h, dh)
    for i in range(b):
        for q0 in range(0, sq, qt):
            pos = qpos[i, q0:q0 + qt].to(torch.int64)
            rp = pos.repeat_interleave(gt)  # row r: position q0 + r // GT
            if kpos is None:
                ent = torch.arange(n_ent)
                kp_all = torch.where(ent <= int(pos.max()), ent, -1)
            else:
                kp_all = kpos[i].to(torch.int64)
            for kvh in range(hkv):
                for z in range(g // gt):
                    heads = kvh * g + z * gt + torch.arange(gt)
                    qr = q[i, q0:q0 + qt][:, heads].reshape(-1, dh).to(torch.float32)
                    m = torch.full((qr.shape[0],), NEG_INF)
                    l = torch.zeros(qr.shape[0])
                    acc = torch.zeros(qr.shape[0], dh)
                    for t in visible_tiles(pos, None if kpos is None else kp_all,
                                           window=window):
                        e = torch.arange(t * KEY_TILE, (t + 1) * KEY_TILE)
                        e = e[e < n_ent]
                        kp = kp_all[e]
                        kt, vt = k[i, e, kvh], v[i, e, kvh]
                        ok = (kp[None] >= 0) & (rp[:, None] >= 0) & (kp[None] <= rp[:, None])
                        if window > 0:
                            ok &= rp[:, None] - kp[None] < window
                        s = torch.where(ok, qr @ kt.T * scale, torch.full((), NEG_INF))
                        mn = torch.maximum(m, s.amax(-1))
                        c = torch.exp(m - mn)
                        p = torch.where(ok, torch.exp(s - mn[:, None]), torch.zeros(()))
                        l = l * c + p.sum(-1)
                        acc = acc * c[:, None] + p @ vt
                        m = mn
                    o = torch.where(l[:, None] > 0, acc / l.clamp(min=1e-30)[:, None],
                                    torch.zeros(()))
                    out[i, q0:q0 + qt][:, heads] = o.reshape(-1, gt, dh)
    return out.to(q.dtype)
