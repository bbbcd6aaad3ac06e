"""Shared model building blocks (PyTorch counterpart of ``repro.models.modules``).

Params are plain dicts of tensors; ``init_*`` build them on an explicit device
from an explicit ``torch.Generator``, and the ``apply``-style functions
consume them.  Every linear role resolves from ``ModelConfig.ttd``/``.quant``
to dense | tt (Tensor-Train cores, paper §II) | int4 (w4a16, paper §IV) and
runs through ``kernels.dispatch``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

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
def init_norm(dim: int, param_dtype, *, device) -> dict[str, Any]:
    return {"scale": torch.ones(dim, dtype=param_dtype, device=device)}


def apply_norm(params, x, eps: float = 1e-5):
    """RMSNorm in f32, cast back to the input dtype (the ported configs'
    ``norm_type``; layernorm arrives with whisper)."""
    y = F.rms_norm(x.to(torch.float32), (x.shape[-1],), params["scale"].to(torch.float32), eps)
    return y.to(x.dtype)


def rope_angles(positions, head_dim: int, theta: float, partial: float = 1.0):
    """cos/sin tables for int positions (..., S), each (..., S, 1, head_dim):
    the rotated half-pairs repeat the angle twice, and the un-rotated tail of a
    partial rotary has cos 1 and sin 0, so ``apply_rope`` is two multiplies."""
    half = int(head_dim * partial) // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device) / half))
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
    """Gated MLP (swiglu | geglu), the ported configs' ``act``; an MoE
    expert's is the same with ``prefix="expert"`` and ``d_ff_expert``."""
    d, f = d_in or cfg.d_model, d_ff or cfg.d_ff
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
    """The gate activation fuses into the gate projection's epilogue and the
    block's skip connection into the down projection's (TTDLinear-Res)."""
    act = "silu" if cfg.act == "swiglu" else "gelu"
    g = apply_linear(params["gate"], x, specs["gate"], compute_dtype, activation=act)
    u = apply_linear(params["up"], x, specs["up"], compute_dtype)
    return apply_linear(params["down"], g * u, specs["down"], compute_dtype,
                        residual=residual)


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
