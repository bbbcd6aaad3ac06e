"""Shared model building blocks (PyTorch counterpart of ``repro.models.modules``).

Params are plain dicts of tensors; ``init_*`` build them on an explicit device
from an explicit ``torch.Generator``, and the ``apply``-style functions
consume them.  Every linear role resolves from ``ModelConfig.ttd``/``.quant``
to dense | tt (Tensor-Train cores, paper §II) | int4 (w4a16, paper §IV) and
runs through ``kernels.dispatch``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..config import ModelConfig
from ..core.quant import quantize_int4
from ..core.tt_linear import init_tt_linear
from ..core.ttd import TTSpec
from ..kernels import dispatch
from ..kernels.tt_embed import resolve_ids

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Linear: dense | tt | int4
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LinearSpec:
    kind: str  # dense | tt | int4
    n_in: int
    n_out: int
    bias: bool = False
    tt: TTSpec | None = None
    quant_group: int = 128


def linear_spec(cfg: ModelConfig, role: str, n_in: int, n_out: int, bias: bool = False,
                *, ttd_block: bool = True) -> LinearSpec:
    """TT if the role is compressed in this block and its dims factorize,
    else int4 if ``n_in`` divides into quant groups, else dense."""
    ttd = cfg.ttd
    if ttd.enabled and ttd_block and role in ttd.roles:
        ov = ttd.override_for(role)
        try:
            tt = TTSpec.make(n_in, n_out, ov.rank if ov else ttd.rank, d=ttd.d,
                             in_modes=ov.in_modes if ov else None,
                             out_modes=ov.out_modes if ov else None)
            return LinearSpec("tt", n_in, n_out, bias=bias, tt=tt)
        except ValueError:
            pass  # un-factorizable dim: fall through to int4/dense
    if cfg.quant.enabled and n_in % cfg.quant.group_size == 0:
        return LinearSpec("int4", n_in, n_out, bias=bias, quant_group=cfg.quant.group_size)
    return LinearSpec("dense", n_in, n_out, bias=bias)


def init_linear(spec: LinearSpec, param_dtype, *, generator: torch.Generator,
                device) -> dict[str, Any]:
    out: dict[str, Any] = {}
    std = 1.0 / math.sqrt(spec.n_in)
    if spec.kind == "dense":
        w = torch.randn(spec.n_in, spec.n_out, generator=generator, device=device)
        out["w"] = (w * std).to(param_dtype)
    elif spec.kind == "tt":
        out.update(init_tt_linear(spec.tt, generator=generator, device=device,
                                  dtype=param_dtype))
    elif spec.kind == "int4":
        w = torch.randn(spec.n_out, spec.n_in, generator=generator, device=device)
        out.update(quantize_int4(w * std, spec.quant_group))
    else:
        raise ValueError(spec.kind)
    if spec.bias:
        out["b"] = torch.zeros(spec.n_out, dtype=param_dtype, device=device)
    return out


def apply_linear(params, x, spec: LinearSpec, compute_dtype=torch.bfloat16, *,
                 scale=None, residual=None, activation: str | None = None) -> torch.Tensor:
    """y = act(x W [* scale] + b) [+ residual]; x: (..., n_in) -> (..., n_out)."""
    x = x.to(compute_dtype)
    bias = params["b"] if spec.bias else None
    if spec.kind == "dense":
        return dispatch.dense_linear(x, params["w"].to(compute_dtype), scale=scale,
                                     bias=bias, residual=residual, activation=activation)
    if spec.kind == "tt":
        return dispatch.tt_linear(x, params["cores"], spec.tt, scale=scale, bias=bias,
                                  residual=residual, activation=activation)
    if spec.kind == "int4":
        return dispatch.int4_matmul(x, params["qweight"], params["scales"],
                                    group=spec.quant_group, scale=scale, bias=bias,
                                    residual=residual, activation=activation)
    raise ValueError(spec.kind)


def linear_param_count(spec: LinearSpec) -> int:
    n = spec.n_out if spec.bias else 0
    if spec.kind == "tt":
        return n + spec.tt.n_params()
    return n + spec.n_in * spec.n_out


def linear_param_bits(spec: LinearSpec, param_bits: int = 16) -> int:
    """Storage bits (int4 weights count 4 bits + 16-bit group scales)."""
    n = spec.n_out * param_bits if spec.bias else 0
    if spec.kind == "tt":
        return n + spec.tt.n_params() * param_bits
    if spec.kind == "int4":
        groups = spec.n_in // spec.quant_group
        return n + spec.n_in * spec.n_out * 4 + spec.n_out * groups * 16
    return n + spec.n_in * spec.n_out * param_bits


# ---------------------------------------------------------------------------
# Norms and rotary positions
# ---------------------------------------------------------------------------
def init_norm(dim: int, param_dtype, *, device, norm_type: str = "rmsnorm") -> dict[str, Any]:
    """Norm gains (ones), plus a bias (zeros) for ``norm_type="layernorm"``."""
    p = {"scale": torch.ones(dim, dtype=param_dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros(dim, dtype=param_dtype, device=device)
    return p


def apply_norm(params, x, eps: float = 1e-5):
    """RMSNorm, or LayerNorm when the params carry a bias (``init_norm``'s
    ``norm_type="layernorm"``): mean and variance in f32, cast back to the
    input dtype."""
    xf = x.to(torch.float32)
    scale = params["scale"].to(torch.float32)
    if "bias" in params:
        y = F.layer_norm(xf, (x.shape[-1],), scale, params["bias"].to(torch.float32), eps)
    else:
        y = F.rms_norm(xf, (x.shape[-1],), scale, eps)
    return y.to(x.dtype)


def rope_angles(positions, head_dim: int, theta: float, partial: float = 1.0,
                mrope_sections=None):
    """cos/sin tables for int positions (..., S), each (..., S, 1, head_dim):
    the rotated half-pairs repeat the angle twice, and the un-rotated tail of a
    partial rotary has cos 1 and sin 0, so ``apply_rope`` is two multiplies.

    M-RoPE (Qwen2-VL): positions (3, ..., S) hold the (t, h, w) position
    planes and ``mrope_sections`` splits the rotary half-dim between them,
    rotary frequency j reading the plane of its section; the tables are
    (..., S, 1, head_dim) as above."""
    half = int(head_dim * partial) // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device) / half))
    if mrope_sections is not None:
        if sum(mrope_sections) != half:
            raise ValueError(f"mrope_sections {tuple(mrope_sections)} must sum to the "
                             f"rotary half-dim {half}")
        pos = positions.to(torch.float32)
        starts = [sum(mrope_sections[:i]) for i in range(len(mrope_sections))]
        angle = torch.cat([pos[i][..., None] * inv_freq[a:a + n]
                           for i, (a, n) in enumerate(zip(starts, mrope_sections))], dim=-1)
    else:
        angle = positions.to(torch.float32)[..., None] * inv_freq
    tail = head_dim - 2 * half
    ones = angle.new_ones(*angle.shape[:-1], tail)
    cos = torch.cat([torch.cos(angle), torch.cos(angle), ones], dim=-1)
    sin = torch.cat([torch.sin(angle), torch.sin(angle), ones * 0], dim=-1)
    return cos[..., None, :], sin[..., None, :]


def apply_rope(x, cos, sin, partial: float = 1.0):
    """x: (B, S, H, Dh) with tables from ``rope_angles``: the first half of
    the rotated dims becomes x1·c − x2·s, the second x2·c + x1·s, the tail
    passes through; computed in f32, cast back to x.dtype."""
    half = int(x.shape[-1] * partial) // 2
    rotated = torch.cat([-x[..., half:2 * half], x[..., :half], x[..., 2 * half:]], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Paged KV-cache write (serve path; see serve/kv_cache.py for the layout)
# ---------------------------------------------------------------------------
def paged_write_index(block_tables, positions, block_size: int):
    """Flat (block, slot) pool coordinates of each (B, S) position; ``-1``
    (padding) maps to the reserved null block 0.  Computed once per step and
    shared by every layer's ``paged_kv_update``."""
    positions = positions.to(torch.int64)
    bt = block_tables.to(torch.int64)
    valid = positions >= 0
    safe = positions.clamp(min=0)
    idx = (safe // block_size).clamp(0, bt.shape[1] - 1)
    rows = torch.where(valid, torch.gather(bt, 1, idx), 0).reshape(-1)
    slots = torch.where(valid, safe % block_size, 0).reshape(-1)
    return rows, slots


def paged_kv_update(cache: dict, k_new, v_new, index) -> dict:
    """Scatter one chunk of K/V (B, S, Hkv, Dh) into the paged pools at
    ``index`` (from :func:`paged_write_index`), **in place**.

    cache: ``{"k","v": (NB, BS, Hkv, Dh)}`` plus ``k_scale``/``v_scale``
    ``(NB, BS, Hkv)`` f32 for int8 pools (each written token gets a
    per-(block-slot, head) amax/127 scale).  Returns ``cache``.
    """
    hkv, dh = k_new.shape[-2:]
    rows, slots = index
    for nm, x in (("k", k_new), ("v", v_new)):
        buf = cache[nm]
        if nm + "_scale" in cache:
            x32 = x.to(torch.float32)
            sc = x32.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
            q = torch.round(x32 / sc[..., None]).to(torch.int8)
            buf[rows, slots] = q.reshape(-1, hkv, dh)
            cache[nm + "_scale"][rows, slots] = sc.reshape(-1, hkv)
        else:
            buf[rows, slots] = x.to(buf.dtype).reshape(-1, hkv, dh)
    return cache


# ---------------------------------------------------------------------------
# Per-slot ring write (ring and griffin serving; layout in transformer.py)
# ---------------------------------------------------------------------------
def ring_write_index(positions, wr: int):
    """Where one call's (B, S) positions land in (B, WR) rings: entry
    ``pos % WR`` for a real position.  A padding position (-1) must drop its
    write; it is sent instead to a spare entry of its row that no real write
    of this call touches, and rewrites that entry's current contents there, so
    the update needs no host sync and no data-dependent shapes.  Computed once
    per step and shared by every layer's :func:`ring_kv_update`.  Returns
    (rows (B, S), entries (B, S), real (B, S) bool, spare (B,))."""
    b, s = positions.shape
    if s > wr:
        raise ValueError(f"a call writes {s} positions into rings of {wr} entries")
    positions = positions.to(torch.int64)
    real = positions >= 0
    entry = torch.remainder(positions.clamp(min=0), wr)
    taken = torch.zeros((b, wr + 1), dtype=torch.uint8, device=positions.device)
    taken.scatter_(1, torch.where(real, entry, wr), 1)
    spare = taken[:, :wr].argmin(dim=1)  # first entry this call leaves alone
    rows = torch.arange(b, device=positions.device)[:, None].expand(b, s)
    return rows, torch.where(real, entry, spare[:, None]), real, spare


def ring_kv_update(cache: dict, k_new, v_new, positions, index=None) -> dict:
    """Write one call's K/V (B, S, Hkv, Dh) into per-slot rings at
    ``pos % WR``, **in place**; a write at position -1 is dropped.

    cache: ``{"k","v": (B, WR, Hkv, Dh), "pos": (B, WR) int32}`` (-1 = empty
    entry), plus ``k_scale``/``v_scale`` (B, WR, Hkv) f32 for int8 rings: each
    written entry gets a per-(entry, head) amax/127 scale, as
    ``repro.models.modules.ring_kv_update``.  ``index`` is
    :func:`ring_write_index`'s result for ``positions`` when the caller
    shares it across layers.  Returns ``cache``.
    """
    if index is None:
        index = ring_write_index(positions, cache["k"].shape[1])
    rows, entries, real, spare = index
    b = rows.shape[0]

    def put(buf, x):
        keep = buf[torch.arange(b, device=buf.device), spare][:, None]  # (B, 1, ...)
        m = real.reshape(real.shape + (1,) * (x.ndim - 2))
        buf[rows, entries] = torch.where(m, x.to(buf.dtype), keep)

    put(cache["pos"], positions.to(torch.int32))
    for nm, x in (("k", k_new), ("v", v_new)):
        if nm + "_scale" in cache:
            x32 = x.to(torch.float32)
            sc = x32.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
            put(cache[nm], torch.round(x32 / sc[..., None]).to(torch.int8))
            put(cache[nm + "_scale"], sc)
        else:
            put(cache[nm], x)
    return cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig, ttd_block: bool, d_in: int | None = None,
              d_ff: int | None = None, prefix: str = "mlp") -> dict[str, LinearSpec]:
    """Gated MLP (swiglu | geglu), or for ``act="gelu_mlp"`` the plain
    up -> GELU -> down MLP, biased under layernorm (whisper); an MoE
    expert's is the same with ``prefix="expert"`` and ``d_ff_expert``."""
    d, f = d_in or cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "gelu_mlp":
        bias = cfg.norm_type == "layernorm"
        return {
            "up": linear_spec(cfg, f"{prefix}_up", d, f, bias=bias, ttd_block=ttd_block),
            "down": linear_spec(cfg, f"{prefix}_down", f, d, bias=bias, ttd_block=ttd_block),
        }
    return {
        "gate": linear_spec(cfg, f"{prefix}_gate", d, f, ttd_block=ttd_block),
        "up": linear_spec(cfg, f"{prefix}_up", d, f, ttd_block=ttd_block),
        "down": linear_spec(cfg, f"{prefix}_down", f, d, ttd_block=ttd_block),
    }


def init_mlp(specs: dict[str, LinearSpec], param_dtype, *, generator, device):
    return {nm: init_linear(sp, param_dtype, generator=generator, device=device)
            for nm, sp in specs.items()}


def apply_mlp(params, x, specs: dict[str, LinearSpec], cfg: ModelConfig, compute_dtype,
              residual=None):
    """The gate (or, ungated, the up) activation fuses into that
    projection's epilogue and the block's skip connection into the down
    projection's (TTDLinear-Res)."""
    if "gate" in specs:
        act = "silu" if cfg.act == "swiglu" else "gelu"
        g = apply_linear(params["gate"], x, specs["gate"], compute_dtype, activation=act)
        h = g * apply_linear(params["up"], x, specs["up"], compute_dtype)
    else:
        h = apply_linear(params["up"], x, specs["up"], compute_dtype, activation="gelu")
    return apply_linear(params["down"], h, specs["down"], compute_dtype, residual=residual)


# ---------------------------------------------------------------------------
# Dense and blocked attention (the single-sequence path's self-attention, the
# encoder's and the cross-attention): plain PyTorch ops, as the JAX package
# leaves them to XLA with no Pallas kernel behind them.  Scores and softmax
# in f32, the probabilities rounded to v's dtype for the product with v.
# ---------------------------------------------------------------------------
NEG_INF = -1e30


def _block_mask(qpos, kpos, kmask, causal: bool, window: int):
    """(..., Sq, Skv) validity mask from absolute positions qpos (..., Sq),
    kpos (Skv,) and an optional key mask (Skv,)."""
    m = torch.ones(*qpos.shape, kpos.shape[0], dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos <= qpos[..., None]
    if window > 0:
        m &= qpos[..., None] - kpos < window
    if kmask is not None:
        m &= kmask
    return m


def attention_dense(q, k, v, *, qpos=None, kpos=None, kmask=None, causal: bool = False,
                    window: int = 0, scale=None):
    """Unblocked attention: q (B, Sq, H, Dh), k/v (B, Skv, Hkv, Dh) -> (B, Sq,
    H, Dh) in v's dtype, as ``repro.models.modules.attention_dense``.
    ``qpos``/``kpos`` are the absolute positions (default 0..S-1 on each
    side), ``kmask`` (B, Skv) or (Skv,) drops keys, ``causal`` masks key
    positions past the query's and ``window`` > 0 those ``window`` or more
    behind it.  With no mask at all no score is masked."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale or 1.0 / math.sqrt(dh)
    qh = q.reshape(b, sq, hkv, h // hkv, dh).permute(0, 2, 3, 1, 4).to(torch.float32)
    kh = k.permute(0, 2, 1, 3).to(torch.float32)[:, :, None]       # (B, Hkv, 1, Skv, Dh)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale           # (B, Hkv, G, Sq, Skv)
    if causal or window > 0 or kmask is not None:
        if qpos is None:
            qpos = torch.arange(sq, device=q.device)
        if kpos is None:
            kpos = torch.arange(skv, device=q.device)
        mask = _block_mask(qpos, kpos, None, causal, window)[None, None, None]
        if kmask is not None:
            km = kmask if kmask.ndim == 2 else kmask[None]
            mask = mask & km[:, None, None, None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p, v.permute(0, 2, 1, 3)[:, :, None])       # (B, Hkv, G, Sq, Dh)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def flash_attention(q, k, v, *, qpos, kpos, kmask=None, causal: bool = True, window: int = 0,
                    q_block: int = 1024, kv_block: int = 1024, scale=None):
    """Blocked online-softmax attention, as ``repro.models.modules.
    flash_attention``: one query block at a time, its key blocks in turn,
    so B·H·q_block·kv_block f32 scores (and their exp and mask) live at a
    time.  Shapes as in :func:`attention_dense` (``kmask`` (Skv,)); the
    dense form when ``Sq * Skv <= max(q_block * kv_block, 2**21)``.  Padded
    query rows take position -1, padded keys position 2**30 and are masked."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    if sq * skv <= max(q_block * kv_block, 1 << 21):
        return attention_dense(q, k, v, qpos=qpos, kpos=kpos, kmask=kmask, causal=causal,
                               window=window, scale=scale)
    hkv = k.shape[2]
    g = h // hkv
    scale = scale or 1.0 / math.sqrt(dh)
    qb, kb = min(q_block, sq), min(kv_block, skv)
    pad_q, pad_k = (-sq) % qb, (-skv) % kb
    if kmask is None:
        kmask = torch.ones(skv, dtype=torch.bool, device=k.device)
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        qpos = F.pad(qpos, (0, pad_q), value=-1)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        kpos = F.pad(kpos, (0, pad_k), value=2 ** 30)
        kmask = F.pad(kmask, (0, pad_k), value=False)
    nq, nk = q.shape[1] // qb, k.shape[1] // kb
    qh = q.reshape(b, nq, qb, hkv, g, dh).permute(1, 0, 3, 4, 2, 5)   # (nq, B, Hkv, G, qb, Dh)
    kh = k.reshape(b, nk, kb, hkv, dh).permute(1, 0, 3, 2, 4)[:, :, :, None]
    vh = v.reshape(b, nk, kb, hkv, dh).permute(1, 0, 3, 2, 4)[:, :, :, None]
    qp, kp, km = qpos.reshape(nq, qb), kpos.reshape(nk, kb), kmask.reshape(nk, kb)
    out = []
    for i in range(nq):
        qi = qh[i].to(torch.float32)
        m = torch.full(qi.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
        el = torch.zeros_like(m)                                  # (B, Hkv, G, qb)
        acc = torch.zeros(qi.shape, dtype=torch.float32, device=q.device)
        for j in range(nk):
            s = torch.matmul(qi, kh[j].to(torch.float32).transpose(-1, -2)) * scale
            s = torch.where(_block_mask(qp[i], kp[j], km[j], causal, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            el = el * corr + p.sum(-1)
            pv = torch.matmul(p.to(vh.dtype), vh[j])
            acc = acc * corr[..., None] + pv.to(torch.float32)
            m = m_new
        out.append(torch.where(el[..., None] > 0, acc / el.clamp(min=1e-30)[..., None], 0.0)
                   .to(q.dtype))
    o = torch.stack(out).permute(1, 0, 4, 2, 3, 5).reshape(b, nq * qb, h, dh)
    return o[:, :sq] if pad_q else o


# ---------------------------------------------------------------------------
# Embedding / unembedding: a dense table, or a vocab-axis TT (TensorGPT)
# ---------------------------------------------------------------------------
def embed_spec(cfg: ModelConfig) -> LinearSpec | None:
    """TT spec of the embedding table, or ``None`` for the dense gather.

    The (V, D) table is the TT's (M, N) weight directly (M = V, N = D), so
    ``out_modes`` factor the vocab and ``in_modes`` the model width, and a
    row lookup is the digit-indexed core chain of ``dispatch.tt_embed``."""
    ttd = cfg.ttd
    if not (ttd.enabled and ttd.embed):
        return None
    try:
        tt = TTSpec.make(cfg.d_model, cfg.vocab_size, ttd.embed_rank or ttd.rank,
                         d=ttd.embed_d or ttd.d)
    except ValueError:
        return None  # un-factorizable vocab or width: the table stays dense
    return LinearSpec("tt", cfg.d_model, cfg.vocab_size, tt=tt)


def init_embed(cfg: ModelConfig, param_dtype, *, generator, device):
    sp = embed_spec(cfg)
    if sp is not None:
        return init_tt_linear(sp.tt, generator=generator, device=device, dtype=param_dtype)
    std = 1.0 / math.sqrt(cfg.d_model)
    t = torch.randn(cfg.vocab_size, cfg.d_model, generator=generator, device=device)
    return {"table": (t * std).to(param_dtype)}


def embed_lookup(params, ids, compute_dtype, cfg: ModelConfig | None = None):
    """Rows of the table for int ``ids``: a dense gather, or the TT kernel
    when the params carry cores (which needs the ``cfg`` they were built
    for).  A negative id wraps once, then ids clamp into range."""
    if "cores" in params:
        sp = embed_spec(cfg) if cfg is not None else None
        if sp is None:
            raise ValueError(
                "params carry a TT-compressed embedding but the config does "
                "not declare one (cfg.ttd.embed) — pass the cfg the tree was "
                "compressed for")
        return dispatch.tt_embed(ids, params["cores"], sp.tt).to(compute_dtype)
    table = params["table"]
    return table[resolve_ids(ids, table.shape[0])].to(compute_dtype)


def unembed(x, table, compute_dtype):
    """x: (..., D), table (V, D) -> logits (..., V) f32: the operands rounded to
    the compute dtype, multiplied with f32 accumulation (XLA's f32-accumulating
    dot in the JAX package).  On the card that is one ``torch.mm`` with an f32
    output (``aten::mm.dtype``), so no f32 copy of the table is made (the
    serving path's head is bf16: 1.3 GB for recurrentgemma's tied 256000 x
    2560 table, whose f32 copy would be 2.6 GB per call).  The CPU has no such
    overload and upcasts both operands."""
    xs = x.to(compute_dtype)
    t = table.to(compute_dtype)
    if xs.is_cuda and compute_dtype != torch.float32:
        y = torch.mm(xs.reshape(-1, xs.shape[-1]), t.T, out_dtype=torch.float32)
        return y.reshape(*xs.shape[:-1], t.shape[0])
    return torch.matmul(xs.to(torch.float32), t.to(torch.float32).T)


# ---------------------------------------------------------------------------
# Rematerialization of a block in the backward (``repro``'s ``remat_wrap``)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _dot_ops():
    """The ops whose outputs the "dots" policy saves: the aten matrix
    products (what ``checkpoint_dots`` saves of the reference: every
    ``dot_general``) and the tt_linear op (``kernels.tt_linear``'s custom op,
    which the card's training path calls)."""
    aten = torch.ops.aten
    return {aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default,
            aten.matmul.default, aten.dot.default, aten.mv.default,
            torch.ops.repro_torch.tt_linear.default}


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _dot_ops() else CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, policy: str):
    """``"none"``: ``fn`` itself; ``"full"``: only its inputs are saved and
    its forward runs again in the backward (non-reentrant
    ``torch.utils.checkpoint``); ``"dots"``: selective checkpointing that
    saves the matrix products' outputs and recomputes the rest.  The
    recompute runs under the forward's ``dispatch.force_plain()`` state:
    the backward may run on autograd's device thread, which does not see
    the forward's context variables."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"remat policy {policy!r}: none | full | dots")
    kw = {} if policy == "full" else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts, _save_dots)}

    def run(*args):
        plain = dispatch.plain_forced()

        def body(*a):
            if not plain:
                return fn(*a)
            with dispatch.force_plain():
                return fn(*a)

        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run
