"""Decoder-only transformer, the single-sequence path and the paged and ring
serving paths (counterpart of the dense, MoE and M-RoPE families in
``repro.models.transformer``).

Layers are a per-layer list (no scan).  ``params["segments"]`` mirrors the
JAX tree's segments — blocks ``[0, first_tt_block)`` quant-only, the rest
TT-compressed (paper: 19 of 32 llama2 blocks) — each a list of layer dicts.
The paged K/V pools, the per-slot rings and the single-sequence path's
ring caches are updated in place.  An MoE
block (``models/moe.py``) takes ``"moe"`` in place of ``"mlp"``: its gated
combine cannot ride one linear's epilogue, so the skip connection is added
after it, in x's dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..config import ModelConfig
from ..kernels import dispatch
from .moe import apply_moe, init_moe, moe_specs
from .modules import (
    LinearSpec,
    apply_linear,
    apply_mlp,
    apply_norm,
    apply_rope,
    attention_dense,
    dt,
    embed_lookup,
    embed_spec,
    flash_attention,
    init_embed,
    init_linear,
    init_mlp,
    init_norm,
    linear_spec,
    mlp_specs,
    paged_kv_update,
    paged_write_index,
    remat_wrap,
    ring_kv_update,
    ring_write_index,
    rope_angles,
    unembed,
)


@dataclass(frozen=True)
class BlockSpecs:
    attn: tuple[tuple[str, LinearSpec], ...]
    mlp: tuple[tuple[str, LinearSpec], ...] | None
    moe: dict[str, Any] | None = None  # moe_specs' dict (MoE blocks, which have no mlp)

    def attn_d(self):
        return dict(self.attn)

    def mlp_d(self):
        return dict(self.mlp) if self.mlp is not None else None


def make_block_specs(cfg: ModelConfig, ttd_block: bool) -> BlockSpecs:
    if cfg.family not in ("dense", "griffin", "moe") or cfg.norm_type != "rmsnorm" \
            or cfg.act not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / norm {cfg.norm_type!r} / act {cfg.act!r} "
            "is not ported yet (dense, MoE and griffin's attention blocks, rmsnorm, "
            "swiglu|geglu are)")
    return block_linear_specs(cfg, ttd_block)


def block_linear_specs(cfg: ModelConfig, ttd_block: bool) -> BlockSpecs:
    """An attention block's linears with its gated MLP, or for an MoE config
    its router and experts, for any config: what
    ``core.compress.compression_report`` accounts."""
    attn = (
        ("wq", linear_spec(cfg, "attn_q", cfg.d_model, cfg.q_dim, bias=cfg.qkv_bias, ttd_block=ttd_block)),
        ("wk", linear_spec(cfg, "attn_k", cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, ttd_block=ttd_block)),
        ("wv", linear_spec(cfg, "attn_v", cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, ttd_block=ttd_block)),
        ("wo", linear_spec(cfg, "attn_o", cfg.q_dim, cfg.d_model, ttd_block=ttd_block)),
    )
    if cfg.family == "moe":
        return BlockSpecs(attn, None, moe_specs(cfg, ttd_block))
    return BlockSpecs(attn, tuple(mlp_specs(cfg, ttd_block).items()))


def segment_plan(cfg: ModelConfig) -> list[tuple[int, bool]]:
    """[(n_layers, ttd_enabled_for_these_blocks), ...]"""
    ft = cfg.ttd.first_tt_block if cfg.ttd.enabled else cfg.n_layers
    ft = max(0, min(ft, cfg.n_layers))
    segs = []
    if ft > 0:
        segs.append((ft, False))
    if cfg.n_layers - ft > 0:
        segs.append((cfg.n_layers - ft, True))
    return segs


def init_block(cfg: ModelConfig, specs: BlockSpecs, param_dtype, *, generator, device):
    kw = dict(generator=generator, device=device)
    p = {
        "ln1": init_norm(cfg.d_model, param_dtype, device=device),
        "ln2": init_norm(cfg.d_model, param_dtype, device=device),
        "attn": {nm: init_linear(sp, param_dtype, **kw) for nm, sp in specs.attn},
    }
    if specs.moe is not None:
        p["moe"] = init_moe(cfg, specs.moe, param_dtype, **kw)
    else:
        p["mlp"] = init_mlp(specs.mlp_d(), param_dtype, **kw)
    return p


def init_lm(cfg: ModelConfig, *, seed: int = 0, generator: torch.Generator | None = None,
            device=None) -> dict[str, Any]:
    """Random params from a seeded ``torch.Generator`` on ``device`` (the
    card unless ``device="cpu"``)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    param_dtype = dt(cfg.param_dtype)
    kw = dict(generator=generator, device=device)
    params: dict[str, Any] = {"embed": init_embed(cfg, param_dtype, **kw)}
    params["segments"] = [
        [init_block(cfg, make_block_specs(cfg, ttd_on), param_dtype, **kw) for _ in range(n)]
        for n, ttd_on in segment_plan(cfg)]
    params["final_norm"] = init_norm(cfg.d_model, param_dtype, device=device)
    if not cfg.tie_embeddings:
        std = 1.0 / math.sqrt(cfg.d_model)
        w = torch.randn(cfg.d_model, cfg.vocab_size, **kw)
        params["head"] = {"w": (w * std).to(param_dtype)}
    return params


def specs_tree(cfg: ModelConfig):
    """The params' structure with each linear's ``LinearSpec`` at its place
    and ``None`` for every other leaf (used by ``core.compress``): a segment
    is a list of its layers, as in ``init_lm``."""
    segs = []
    for n, ttd_on in segment_plan(cfg):
        sp = make_block_specs(cfg, ttd_on)
        ffn = {"moe": {"router": sp.moe["router"], "experts": dict(sp.moe["expert"])}} \
            if sp.moe is not None else {"mlp": sp.mlp_d()}
        segs.append([{"ln1": None, "ln2": None, "attn": sp.attn_d(), **ffn}
                     for _ in range(n)])
    tree = {"embed": embed_spec(cfg), "segments": segs, "final_norm": None}
    if not cfg.tie_embeddings:
        tree["head"] = None
    return tree


# ---------------------------------------------------------------------------
# Attention against the paged cache
# ---------------------------------------------------------------------------
def _qkv(params, specs: BlockSpecs, cfg: ModelConfig, x, rope_cs, compute_dtype):
    a = specs.attn_d()
    b, s, _ = x.shape
    q = apply_linear(params["attn"]["wq"], x, a["wq"], compute_dtype).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = apply_linear(params["attn"]["wk"], x, a["wk"], compute_dtype).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = apply_linear(params["attn"]["wv"], x, a["wv"], compute_dtype).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin, cfg.partial_rotary)
        k = apply_rope(k, cos, sin, cfg.partial_rotary)
    return q, k, v


def attn_paged(params, specs, cfg: ModelConfig, x, rope_cs, cache, block_tables,
               positions, kv_index, compute_dtype, residual=None):
    """S == 1 runs the decode kernel, S > 1 the chunked-prefill kernel; the
    block's skip connection fuses into the output projection's epilogue."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, specs, cfg, x, rope_cs, compute_dtype)
    cache = paged_kv_update(cache, k, v, kv_index)
    if s == 1:
        o = dispatch.paged_attention(q[:, 0].contiguous(), cache, block_tables,
                                     positions[:, 0].contiguous())[:, None]
    else:
        o = dispatch.prefill_attention(q.contiguous(), positions, cache=cache,
                                       block_tables=block_tables)
    o = o.to(compute_dtype).reshape(b, s, cfg.q_dim)
    o = apply_linear(params["attn"]["wo"], o, specs.attn_d()["wo"], compute_dtype,
                     residual=residual)
    return o, cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     cache_dtype=torch.bfloat16, *, device=None):
    """Per-layer paged K/V pools (block 0 = reserved null block); int8 pools
    carry per-(block-slot, head) f32 scale tables."""
    device = resolve_device(device)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)

    def one():
        c = {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
             "v": torch.zeros(shape, dtype=cache_dtype, device=device)}
        if cache_dtype == torch.int8:
            c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        return c

    return [[one() for _ in range(n)] for n, _ in segment_plan(cfg)]


def _paged_rope(cfg: ModelConfig, positions):
    """Per-sequence rope tables; padding positions (-1) clamp to 0."""
    if cfg.pos_type == "none":
        return None
    if cfg.pos_type != "rope":
        raise NotImplementedError(
            f"paged serving supports pos_type rope|none, not {cfg.pos_type!r}")
    return rope_angles(positions.clamp(min=0), cfg.head_dim, cfg.rope_theta,
                       cfg.partial_rotary)


def ffn_block(params, specs, cfg, x, compute_dtype):
    """The block's second half on x (after attention): the gated MLP with the
    skip connection in its down projection's epilogue, or the MoE layer with
    the skip added after the combine, in x's dtype."""
    h = apply_norm(params["ln2"], x)
    if specs.moe is not None:
        m, _ = apply_moe(params["moe"], h, specs.moe, cfg, compute_dtype)
        return x + m.to(x.dtype)
    return apply_mlp(params["mlp"], h, specs.mlp_d(), cfg, compute_dtype,
                     residual=x).to(x.dtype)


def _paged_body(params, specs, cfg, x, rope_cs, cache, block_tables, positions,
                kv_index, compute_dtype):
    h = apply_norm(params["ln1"], x)
    a, cache = attn_paged(params, specs, cfg, h, rope_cs, cache, block_tables,
                          positions, kv_index, compute_dtype, residual=x)
    return ffn_block(params, specs, cfg, a.to(x.dtype), compute_dtype), cache


def _paged_stack(params, cfg: ModelConfig, caches, x, rope_cs, block_tables,
                 positions, compute_dtype):
    kv_index = paged_write_index(block_tables, positions, caches[0][0]["k"].shape[1])
    for seg_params, seg_cache, (_, ttd_on) in zip(params["segments"], caches,
                                                  segment_plan(cfg)):
        specs = make_block_specs(cfg, ttd_on)
        for layer_params, layer_cache in zip(seg_params, seg_cache):
            x, _ = _paged_body(layer_params, specs, cfg, x, rope_cs, layer_cache,
                               block_tables, positions, kv_index, compute_dtype)
    return apply_norm(params["final_norm"], x), caches


def logits_from_hidden(params, cfg: ModelConfig, x, compute_dtype=None):
    """(…, D) -> (…, V) f32 logits.  A tied TT embedding unembeds through
    its cores: their (M, N) = (V, D) weight maps (…, D) to (…, V) directly,
    one ``tt_linear`` on f32 ``x``."""
    compute_dtype = compute_dtype or dt(cfg.compute_dtype)
    if cfg.tie_embeddings and "cores" in params["embed"]:
        sp = embed_spec(cfg)
        if sp is None:
            raise ValueError("embed params carry TT cores but cfg.ttd.embed is off")
        return dispatch.tt_linear(x.to(torch.float32).contiguous(), params["embed"]["cores"],
                                  sp.tt)
    table = params["embed"]["table"] if cfg.tie_embeddings else params["head"]["w"].T
    return unembed(x, table, compute_dtype)


def head_weight(params, cfg: ModelConfig):
    """(D, V) unembedding weight (tied or separate)."""
    if cfg.tie_embeddings:
        if "cores" in params["embed"]:
            raise ValueError(
                "tied TT-compressed embedding has no dense head weight — "
                "logits go through logits_from_hidden's TT unembed path")
        return params["embed"]["table"].T
    return params["head"]["w"]


def decode_step_paged(params, cfg: ModelConfig, caches, tokens, block_tables, positions):
    """One decode tick: tokens (B, 1), positions (B,) (``-1`` = inactive
    row).  Returns logits (B, V) f32; the pools are updated in place."""
    compute_dtype = dt(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, compute_dtype, cfg)
    pos2 = positions[:, None].to(torch.int32)
    rope_cs = _paged_rope(cfg, pos2)
    x, caches = _paged_stack(params, cfg, caches, x, rope_cs, block_tables, pos2,
                             compute_dtype)
    return logits_from_hidden(params, cfg, x)[:, 0], caches


def prefill_paged_chunk(params, cfg: ModelConfig, caches, tokens, block_tables, positions,
                        logit_cols=None):
    """One chunk of batched prefill: tokens (B, C), positions (B, C)
    (``-1`` = padding).  Returns logits (B, C, V) f32 for every position, or
    (B, V) for column ``logit_cols[b]`` of each row when those (B,) indices
    are given (the serving path needs only each prompt's last position);
    the pools are updated in place."""
    compute_dtype = dt(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, compute_dtype, cfg)
    positions = positions.to(torch.int32).contiguous()
    rope_cs = _paged_rope(cfg, positions)
    x, caches = _paged_stack(params, cfg, caches, x, rope_cs, block_tables, positions,
                             compute_dtype)
    if logit_cols is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logit_cols]
    return logits_from_hidden(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Ring-cache serving path: per-slot K/V rings of ``window + chunk`` entries
# (the whole ``max_len`` for full attention) with per-entry positions, the
# constant-footprint backend for sliding-window attention.  Same position
# conventions as the paged path.
# ---------------------------------------------------------------------------
def ring_width(cfg: ModelConfig, max_len: int, chunk: int) -> int:
    """Per-slot ring entries: the visible window plus the widest same-call
    write (so a chunk write never evicts a key still visible to its own
    earliest query); full attention keeps the whole ``max_len``."""
    if cfg.window:
        return min(cfg.window, max_len) + chunk
    return max_len


def new_ring(cfg: ModelConfig, batch: int, wr: int, cache_dtype, device) -> dict:
    """One layer's empty rings: k/v (B, WR, Hkv, Dh), pos (B, WR) = -1, and
    for int8 rings per-(entry, head) f32 scale tables."""
    shape = (batch, wr, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
         "v": torch.zeros(shape, dtype=cache_dtype, device=device),
         "pos": torch.full((batch, wr), -1, dtype=torch.int32, device=device)}
    if cache_dtype == torch.int8:
        c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return c


def init_ring_cache(cfg: ModelConfig, batch: int, max_len: int, chunk: int,
                    cache_dtype=torch.bfloat16, *, device=None):
    """Per-segment lists of per-layer rings (see :func:`new_ring`)."""
    device = resolve_device(device)
    wr = ring_width(cfg, max_len, chunk)
    return [[new_ring(cfg, batch, wr, cache_dtype, device) for _ in range(n)]
            for n, _ in segment_plan(cfg)]


def attn_ring(params, specs, cfg: ModelConfig, x, rope_cs, cache, positions,
              compute_dtype, residual=None, index=None):
    """Write-then-attend against one layer's rings: prefill (S > 1) and
    ragged decode (S == 1) both run the ring attention kernel, with the
    ring's ``pos`` as its ``kpos``; the skip connection fuses into the output
    projection's epilogue.  ``index`` is the step's ``ring_write_index``."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, specs, cfg, x, rope_cs, compute_dtype)
    cache = ring_kv_update(cache, k, v, positions, index)
    o = dispatch.prefill_attention(q.contiguous(), positions, k=cache["k"], v=cache["v"],
                                   kpos=cache["pos"], window=cfg.window,
                                   k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    o = apply_linear(params["attn"]["wo"], o.to(compute_dtype).reshape(b, s, cfg.q_dim),
                     specs.attn_d()["wo"], compute_dtype, residual=residual)
    return o, cache


def ring_layer(params, specs, cfg: ModelConfig, x, rope_cs, cache, positions, compute_dtype,
               index):
    """One block against its rings (updated in place): attention, then the
    MLP or MoE half."""
    h = apply_norm(params["ln1"], x)
    a, _ = attn_ring(params, specs, cfg, h, rope_cs, cache, positions, compute_dtype,
                     residual=x, index=index)
    return ffn_block(params, specs, cfg, a.to(x.dtype), compute_dtype)


def _ring_stack(params, cfg: ModelConfig, caches, x, rope_cs, positions, compute_dtype):
    index = ring_write_index(positions, caches[0][0]["k"].shape[1])
    for seg_params, seg_cache, (_, ttd_on) in zip(params["segments"], caches,
                                                  segment_plan(cfg)):
        specs = make_block_specs(cfg, ttd_on)
        for layer_params, layer_cache in zip(seg_params, seg_cache):
            x = ring_layer(layer_params, specs, cfg, x, rope_cs, layer_cache, positions,
                           compute_dtype, index)
    return apply_norm(params["final_norm"], x), caches


def prefill_ring_chunk(params, cfg: ModelConfig, caches, tokens, positions,
                       logit_cols=None):
    """One chunk of batched prefill into per-slot rings: tokens (B, C),
    positions (B, C) (``-1`` = padding).  Returns logits (B, C, V) f32, or
    (B, V) at column ``logit_cols[b]`` of each row when given; the rings are
    updated in place."""
    compute_dtype = dt(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, compute_dtype, cfg)
    positions = positions.to(torch.int32).contiguous()
    rope_cs = _paged_rope(cfg, positions)
    x, caches = _ring_stack(params, cfg, caches, x, rope_cs, positions, compute_dtype)
    if logit_cols is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logit_cols]
    return logits_from_hidden(params, cfg, x), caches


def decode_step_ring(params, cfg: ModelConfig, caches, tokens, positions):
    """One ragged decode tick against the rings: tokens (B, 1), positions (B,)
    (``-1`` = inactive row).  Returns logits (B, V) f32."""
    compute_dtype = dt(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, compute_dtype, cfg)
    pos2 = positions[:, None].to(torch.int32).contiguous()
    rope_cs = _paged_rope(cfg, pos2)
    x, caches = _ring_stack(params, cfg, caches, x, rope_cs, pos2, compute_dtype)
    return logits_from_hidden(params, cfg, x)[:, 0], caches



# ---------------------------------------------------------------------------
# The single-sequence path (``models.api.Model``): ``forward`` over whole
# sequences, ``prefill`` into per-layer ring caches and ``decode_step`` one
# token at a shared position.  Its attention is plain ops
# (``modules.flash_attention`` / ``attention_dense``), as the JAX package's.
# ---------------------------------------------------------------------------
def _rope_tables(cfg: ModelConfig, positions, b: int, s: int, device):
    """rope: positions (S,) or (B, S), default 0..S-1; mrope: (3, B, S),
    default 0..S-1 on every plane; none: no tables."""
    if cfg.pos_type == "rope":
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=device)
        return rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.partial_rotary)
    if cfg.pos_type == "mrope":
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=device).expand(3, b, s)
        return rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.partial_rotary,
                           mrope_sections=cfg.mrope_sections)
    return None


def attn_full(params, specs, cfg: ModelConfig, x, rope_cs, compute_dtype, *,
              return_kv=False, residual=None):
    """Causal self-attention over the whole sequence (positions 0..S-1,
    ``cfg.window``); the skip connection fuses into the output projection's
    epilogue.  Returns (y, (k, v) or None)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, specs, cfg, x, rope_cs, compute_dtype)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    o = flash_attention(q, k, v, qpos=pos, kpos=pos, causal=True, window=cfg.window,
                        q_block=cfg.q_block, kv_block=cfg.kv_block)
    o = apply_linear(params["attn"]["wo"], o.reshape(b, s, cfg.q_dim), specs.attn_d()["wo"],
                     compute_dtype, residual=residual)
    return o, ((k, v) if return_kv else None)


def _pos_index(pos, device):
    """The decode position as a (1,) int64 tensor on ``device``: a Python
    int or a device tensor, read on the device only."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(1)
    return torch.full((1,), int(pos), dtype=torch.int64, device=device)


def ring_attend(q, k, v, cache, pos, *, causal: bool, window: int = 0):
    """Write one token's k/v (B, 1, Hkv, Dh) into a ring cache ``{"k", "v":
    (B, W, Hkv, Dh), "pos": (W,) int32}`` (-1 = empty entry; one position
    row shared by the batch) at entry ``pos % W`` **in place**, then attend
    q over the cache (``attention_dense``).  ``pos`` is :func:`_pos_index`'s
    (1,) tensor."""
    slot = torch.remainder(pos, cache["k"].shape[1])
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(0, slot, pos.to(torch.int32))
    return attention_dense(q, cache["k"], cache["v"], qpos=pos, kpos=cache["pos"],
                           kmask=cache["pos"] >= 0, causal=causal, window=window)


def attn_decode(params, specs, cfg: ModelConfig, x, rope_cs, cache, pos, compute_dtype,
                residual=None):
    """One token against its ring cache (:func:`ring_attend`, in place).
    Returns (y, cache)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, specs, cfg, x, rope_cs, compute_dtype)
    o = ring_attend(q, k, v, cache, pos, causal=True, window=cfg.window)
    o = apply_linear(params["attn"]["wo"], o.reshape(b, s, cfg.q_dim), specs.attn_d()["wo"],
                     compute_dtype, residual=residual)
    return o, cache


def _ffn_aux(params, specs, cfg, x, compute_dtype):
    """``ffn_block`` returning the MoE aux loss too (0 for an MLP block)."""
    h = apply_norm(params["ln2"], x)
    if specs.moe is not None:
        m, aux = apply_moe(params["moe"], h, specs.moe, cfg, compute_dtype)
        return x + m.to(x.dtype), aux
    y = apply_mlp(params["mlp"], h, specs.mlp_d(), cfg, compute_dtype, residual=x).to(x.dtype)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_block(params, specs: BlockSpecs, cfg: ModelConfig, x, rope_cs, compute_dtype,
                cache=None, pos=None, return_kv=False):
    """One block: full attention (``cache`` None) or one decode token against
    its ring cache.  Returns (x, cache, aux); with ``return_kv`` (full
    attention) (x, the layer's (k, v), aux)."""
    h = apply_norm(params["ln1"], x)
    if cache is None:
        a, cache = attn_full(params, specs, cfg, h, rope_cs, compute_dtype,
                             return_kv=return_kv, residual=x)
    else:
        a, cache = attn_decode(params, specs, cfg, h, rope_cs, cache, pos, compute_dtype,
                               residual=x)
    x, aux = _ffn_aux(params, specs, cfg, a.to(x.dtype), compute_dtype)
    return x, cache, aux


def forward(params, cfg: ModelConfig, tokens, positions=None, *, remat="none",
            inputs_embeds=None):
    """tokens (B, S) -> (hidden (B, S, D) after the final norm, aux: the sum
    of the MoE layers' aux losses, f32).  Each block runs under
    ``remat_wrap(remat)``, as the reference's scan body."""
    compute_dtype = dt(cfg.compute_dtype)
    b, s = tokens.shape[:2]
    x = inputs_embeds if inputs_embeds is not None else \
        embed_lookup(params["embed"], tokens, compute_dtype, cfg)
    rope_cs = _rope_tables(cfg, positions, b, s, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, (_, ttd_on) in zip(params["segments"], segment_plan(cfg)):
        specs = make_block_specs(cfg, ttd_on)

        def body(carry, layer_params, specs=specs):
            y, _, aux = apply_block(layer_params, specs, cfg, carry, rope_cs, compute_dtype)
            return y, aux

        f = remat_wrap(body, remat)
        for layer_params in seg_params:
            x, aux = f(x, layer_params)
            aux_total = aux_total + aux
    return apply_norm(params["final_norm"], x), aux_total


def init_cache(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=torch.bfloat16, *,
               device=None):
    """Per-segment lists of per-layer ring caches of ``window`` entries (the
    whole ``max_len`` without a window): k/v (B, W, Hkv, Dh), pos (W,) = -1."""
    device = resolve_device(device)
    w = min(cfg.window, max_len) if cfg.window else max_len
    return [[solo_ring(cfg, batch, w, cache_dtype, device) for _ in range(n)]
            for n, _ in segment_plan(cfg)]


def solo_ring(cfg: ModelConfig, batch: int, w: int, cache_dtype, device):
    """One layer's empty ring cache: k/v (B, w, Hkv, Dh) zeros, pos (w,) = -1."""
    kv = (batch, w, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=cache_dtype, device=device),
            "v": torch.zeros(kv, dtype=cache_dtype, device=device),
            "pos": torch.full((w,), -1, dtype=torch.int32, device=device)}


def _ring_from_prefill(k, v, s: int, w: int, cache_dtype):
    """Pack the last ``w`` prefilled K/V (B, S, Hkv, Dh) into ring layout
    (position p at entry p % w).  Returns (k, v, pos (w,))."""
    b, _, hkv, dh = k.shape
    dev = k.device
    if s <= w:
        pad = (0, 0, 0, 0, 0, w - s)
        pos = torch.cat([torch.arange(s, dtype=torch.int32, device=dev),
                         torch.full((w - s,), -1, dtype=torch.int32, device=dev)])
        return (F.pad(k, pad).to(cache_dtype), F.pad(v, pad).to(cache_dtype), pos)
    tail_pos = torch.arange(s - w, s, dtype=torch.int32, device=dev)
    slots = (tail_pos % w).to(torch.int64)
    k_c = torch.zeros(b, w, hkv, dh, dtype=cache_dtype, device=dev)
    v_c = torch.zeros_like(k_c)
    k_c[:, slots] = k[:, -w:].to(cache_dtype)
    v_c[:, slots] = v[:, -w:].to(cache_dtype)
    pos = torch.zeros(w, dtype=torch.int32, device=dev)
    pos[slots] = tail_pos
    return k_c, v_c, pos


def prefill(params, cfg: ModelConfig, tokens, positions=None, cache_dtype=torch.bfloat16,
            max_len: int | None = None):
    """Whole-prompt prefill: tokens (B, S) -> (the last position's logits
    (B, V) f32, ring caches filled to S, as :func:`init_cache` lays them
    out).  The MoE aux loss is dropped."""
    compute_dtype = dt(cfg.compute_dtype)
    b, s = tokens.shape
    max_len = max_len or s
    w = min(cfg.window, max_len) if cfg.window else max_len
    x = embed_lookup(params["embed"], tokens, compute_dtype, cfg)
    rope_cs = _rope_tables(cfg, positions, b, s, x.device)
    caches = []
    for seg_params, (_, ttd_on) in zip(params["segments"], segment_plan(cfg)):
        specs = make_block_specs(cfg, ttd_on)
        seg = []
        for lp in seg_params:
            x, (k, v), _ = apply_block(lp, specs, cfg, x, rope_cs, compute_dtype,
                                       return_kv=True)
            k_c, v_c, pos_c = _ring_from_prefill(k, v, s, w, cache_dtype)
            seg.append({"k": k_c, "v": v_c, "pos": pos_c})
        caches.append(seg)
    x = apply_norm(params["final_norm"], x[:, -1:])
    return logits_from_hidden(params, cfg, x)[:, 0], caches


def decode_step(params, cfg: ModelConfig, caches, tokens, pos, positions=None):
    """tokens (B, 1) at absolute position ``pos`` (a Python int or a device
    tensor; the batch shares it); ``positions``: rope (B, 1), M-RoPE (3, B,
    1).  Returns logits (B, V) f32 and the caches, updated in place.  Under
    M-RoPE without ``positions`` the rotary table is position 0's, as the
    JAX package's."""
    compute_dtype = dt(cfg.compute_dtype)
    b = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens, compute_dtype, cfg)
    p = _pos_index(pos, x.device)
    rope_pos = p if positions is None and cfg.pos_type != "mrope" else positions
    rope_cs = _rope_tables(cfg, rope_pos, b, 1, x.device)
    for seg_params, seg_cache, (_, ttd_on) in zip(params["segments"], caches,
                                                  segment_plan(cfg)):
        specs = make_block_specs(cfg, ttd_on)
        for lp, lc in zip(seg_params, seg_cache):
            x, _, _ = apply_block(lp, specs, cfg, x, rope_cs, compute_dtype, cache=lc, pos=p)
    x = apply_norm(params["final_norm"], x)
    return logits_from_hidden(params, cfg, x)[:, 0], caches
