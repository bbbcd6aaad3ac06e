"""Whisper-style encoder-decoder, served through paged decoder
self-attention and a per-slot encoder context (counterpart of
``repro.models.whisper``'s session path).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T_enc, D).  LayerNorm, biased linears and
the plain GELU MLP; TT on attn-O and the MLP linears of both stacks.
``enc_blocks`` and ``dec_blocks`` are per-layer lists.  The encoder's
self-attention and the cross-attention are plain PyTorch ops in f32
(``modules.attention_dense``; the reference leaves them to XLA, with no
Pallas kernel behind them); the serving decoder's self-attention runs the
paged decode and chunked-prefill kernels.  The paged pools and the encoder
context are updated in place.  The single-sequence path (``forward``,
``prefill``, ``decode_step``, for ``models.api.Model``) runs the decoder's
self-attention on plain ops too, over a ring cache a layer, with each
layer's cross K/V computed once at its prefill.
"""
from __future__ import annotations

from typing import Any

import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..kernels import dispatch
from .modules import (
    apply_linear,
    apply_mlp,
    apply_norm,
    attention_dense,
    dt,
    embed_lookup,
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
    unembed,
)
from .transformer import _pos_index, _ring_from_prefill, ring_attend, solo_ring


# ---------------------------------------------------------------------------
# Specs / init
# ---------------------------------------------------------------------------
def attn_specs(cfg: ModelConfig, ttd_block: bool = True):
    d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": linear_spec(cfg, "attn_q", d, qd, bias=True, ttd_block=ttd_block),
        "wk": linear_spec(cfg, "attn_k", d, kd, bias=False, ttd_block=ttd_block),
        "wv": linear_spec(cfg, "attn_v", d, kd, bias=True, ttd_block=ttd_block),
        "wo": linear_spec(cfg, "attn_o", qd, d, bias=True, ttd_block=ttd_block),
    }


def _init_block(cfg: ModelConfig, param_dtype, cross: bool, **kw):
    """One encoder block, or with ``cross`` one decoder block (its
    cross-attention ``xattn`` and that sublayer's norm ``ln_x``)."""
    aspecs, mspecs = attn_specs(cfg), mlp_specs(cfg, True)
    norm = dict(device=kw["device"], norm_type=cfg.norm_type)
    p = {"ln1": init_norm(cfg.d_model, param_dtype, **norm),
         "attn": {nm: init_linear(sp, param_dtype, **kw) for nm, sp in aspecs.items()}}
    if cross:
        p["ln_x"] = init_norm(cfg.d_model, param_dtype, **norm)
        p["xattn"] = {nm: init_linear(sp, param_dtype, **kw) for nm, sp in aspecs.items()}
    p["ln2"] = init_norm(cfg.d_model, param_dtype, **norm)
    p["mlp"] = init_mlp(mspecs, param_dtype, **kw)
    return p


def init_lm(cfg: ModelConfig, *, seed: int = 0, generator: torch.Generator | None = None,
            device=None) -> dict[str, Any]:
    """Random params from a seeded ``torch.Generator`` on ``device`` (the
    card unless ``device="cpu"``); the output head is tied to the
    embedding, as whisper's."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    param_dtype = dt(cfg.param_dtype)
    kw = dict(generator=generator, device=device)

    def positions(n):
        return (torch.randn(n, cfg.d_model, **kw) * 0.02).to(param_dtype)

    return {
        "embed": init_embed(cfg, param_dtype, **kw),
        "dec_pos": positions(cfg.max_seq_len),
        "enc_pos": positions(cfg.enc_len),
        "enc_blocks": [_init_block(cfg, param_dtype, False, **kw)
                       for _ in range(cfg.n_enc_layers)],
        "dec_blocks": [_init_block(cfg, param_dtype, True, **kw) for _ in range(cfg.n_layers)],
        "enc_norm": init_norm(cfg.d_model, param_dtype, device=device,
                              norm_type=cfg.norm_type),
        "final_norm": init_norm(cfg.d_model, param_dtype, device=device,
                                norm_type=cfg.norm_type),
    }


def specs_tree(cfg: ModelConfig):
    """The params' structure with each linear's ``LinearSpec`` at its place
    and ``None`` for every other leaf; the block lists as in ``init_lm``."""
    asp, msp = attn_specs(cfg), mlp_specs(cfg, True)
    enc = {"ln1": None, "ln2": None, "attn": dict(asp), "mlp": dict(msp)}
    dec = {"ln1": None, "ln2": None, "ln_x": None, "attn": dict(asp), "xattn": dict(asp),
           "mlp": dict(msp)}
    return {"embed": None, "dec_pos": None, "enc_pos": None,
            "enc_blocks": [dict(enc) for _ in range(cfg.n_enc_layers)],
            "dec_blocks": [dict(dec) for _ in range(cfg.n_layers)],
            "enc_norm": None, "final_norm": None}


def _heads(cfg: ModelConfig, t):
    b, s, _ = t.shape
    return t.reshape(b, s, cfg.n_heads, cfg.head_dim)


# ---------------------------------------------------------------------------
# Encoder and the per-slot encoder context
# ---------------------------------------------------------------------------
def encode(params, cfg: ModelConfig, enc_frames, compute_dtype, remat="none"):
    """enc_frames (B, T_enc, D) (the stub frontend's output) -> the encoder's
    output (B, T_enc, D) in ``compute_dtype``.  The skip connections fuse
    into the output and down projections' epilogues; each block runs under
    ``remat_wrap(remat)``."""
    aspecs, mspecs = attn_specs(cfg), mlp_specs(cfg, True)
    t = enc_frames.shape[1]
    x = enc_frames.to(compute_dtype) + params["enc_pos"][:t].to(compute_dtype)

    def body(x, p):
        h = apply_norm(p["ln1"], x)
        q, k, v = (_heads(cfg, apply_linear(p["attn"][nm], h, aspecs[nm], compute_dtype))
                   for nm in ("wq", "wk", "wv"))
        o = attention_dense(q, k, v).reshape(x.shape[0], t, cfg.q_dim)
        y = apply_linear(p["attn"]["wo"], o, aspecs["wo"], compute_dtype,
                         residual=x).to(x.dtype)
        return apply_mlp(p["mlp"], apply_norm(p["ln2"], y), mspecs, cfg, compute_dtype,
                         residual=y).to(y.dtype)

    f = remat_wrap(body, remat)
    for p in params["enc_blocks"]:
        x = f(x, p)
    return apply_norm(params["enc_norm"], x)


def encode_ctx(params, cfg: ModelConfig, enc_frames):
    """Run the encoder and project each decoder layer's cross K/V:
    enc_frames (B, T_enc, D) -> {"k", "v"}: (n_layers, B, T_enc, H, Dh) f32.
    Computed once an admission (a preempted request reruns it)."""
    compute_dtype = dt(cfg.compute_dtype)
    enc_out = encode(params, cfg, enc_frames, compute_dtype)
    aspecs = attn_specs(cfg)
    return {nm: torch.stack([
        _heads(cfg, apply_linear(p["xattn"][w], enc_out, aspecs[w], compute_dtype))
        .to(torch.float32) for p in params["dec_blocks"]])
        for nm, w in (("k", "wk"), ("v", "wv"))}


def init_session_state(cfg: ModelConfig, batch: int, num_blocks: int, block_size: int,
                       cache_dtype=torch.float32, *, device=None):
    """{"self": a paged K/V pool a decoder layer (block 0 the reserved null
    block; int8 pools carry per-(block-slot, head) f32 scale tables),
    "cross": the per-slot encoder context {"k", "v"}: (n_layers, batch,
    T_enc, H, Dh) f32}."""
    device = resolve_device(device)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)

    def pool():
        c = {nm: torch.zeros(shape, dtype=cache_dtype, device=device) for nm in ("k", "v")}
        if cache_dtype == torch.int8:
            for nm in ("k_scale", "v_scale"):
                c[nm] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        return c

    ctx = (cfg.n_layers, batch, cfg.enc_len, cfg.n_heads, cfg.head_dim)
    return {"self": [pool() for _ in range(cfg.n_layers)],
            "cross": {nm: torch.zeros(ctx, dtype=torch.float32, device=device)
                      for nm in ("k", "v")}}


# ---------------------------------------------------------------------------
# Decoder against the paged pools and the encoder context
# ---------------------------------------------------------------------------
def _self_attn_paged(p, aspecs, cfg: ModelConfig, x, cache, block_tables, positions,
                     kv_index, compute_dtype, residual=None):
    """Decoder self-attention against one layer's paged pool: S == 1 runs
    the decode kernel, S > 1 the chunked-prefill kernel."""
    b, s, _ = x.shape
    q, k, v = (_heads(cfg, apply_linear(p[nm], x, aspecs[nm], compute_dtype))
               for nm in ("wq", "wk", "wv"))
    paged_kv_update(cache, k, v, kv_index)
    if s == 1:
        o = dispatch.paged_attention(q[:, 0].contiguous(), cache, block_tables,
                                     positions[:, 0].contiguous())[:, None]
    else:
        o = dispatch.prefill_attention(q.contiguous(), positions, cache=cache,
                                       block_tables=block_tables)
    o = o.to(compute_dtype).reshape(b, s, cfg.q_dim)
    return apply_linear(p["wo"], o, aspecs["wo"], compute_dtype, residual=residual)


def _cross_attn_ctx(p, aspecs, cfg: ModelConfig, x, ck, cv, compute_dtype, residual=None):
    """Cross-attention against the slots' encoder context ck/cv (B, T_enc, H,
    Dh) f32, every key visible."""
    b, s, _ = x.shape
    q = _heads(cfg, apply_linear(p["wq"], x, aspecs["wq"], compute_dtype))
    o = attention_dense(q, ck, cv).reshape(b, s, cfg.q_dim)
    return apply_linear(p["wo"], o, aspecs["wo"], compute_dtype, residual=residual)


def _session_stack(params, cfg: ModelConfig, state, x, block_tables, positions,
                   compute_dtype):
    aspecs, mspecs = attn_specs(cfg), mlp_specs(cfg, True)
    kv_index = paged_write_index(block_tables, positions, state["self"][0]["k"].shape[1])
    for li, (p, cache) in enumerate(zip(params["dec_blocks"], state["self"])):
        a = _self_attn_paged(p["attn"], aspecs, cfg, apply_norm(p["ln1"], x), cache,
                             block_tables, positions, kv_index, compute_dtype, residual=x)
        y = a.to(x.dtype)
        a = _cross_attn_ctx(p["xattn"], aspecs, cfg, apply_norm(p["ln_x"], y),
                            state["cross"]["k"][li], state["cross"]["v"][li], compute_dtype,
                            residual=y)
        y = a.to(y.dtype)
        x = apply_mlp(p["mlp"], apply_norm(p["ln2"], y), mspecs, cfg, compute_dtype,
                      residual=y).to(y.dtype)
    return apply_norm(params["final_norm"], x)


def _embed_positions(params, cfg: ModelConfig, tokens, positions, compute_dtype):
    """Token rows plus the learned decoder positions; padding (-1) gathers
    row 0."""
    x = embed_lookup(params["embed"], tokens, compute_dtype, cfg)
    return x + params["dec_pos"][positions.clamp(min=0)].to(compute_dtype)


def prefill_session_chunk(params, cfg: ModelConfig, state, tokens, block_tables, positions,
                          logit_cols=None):
    """One chunk of batched prefill: tokens (B, C), positions (B, C) (``-1`` =
    padding).  Returns logits (B, C, V) f32, or (B, V) at column
    ``logit_cols[b]`` of each row when given, and the state (its pools
    updated in place)."""
    compute_dtype = dt(cfg.compute_dtype)
    positions = positions.to(torch.int32).contiguous()
    x = _embed_positions(params, cfg, tokens, positions, compute_dtype)
    x = _session_stack(params, cfg, state, x, block_tables, positions, compute_dtype)
    if logit_cols is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logit_cols]
    return unembed(x, params["embed"]["table"], compute_dtype), state


def decode_session_step(params, cfg: ModelConfig, state, tokens, block_tables, positions):
    """One ragged decode tick: tokens (B, 1), positions (B,) (``-1`` =
    inactive row).  Returns logits (B, V) f32 and the state."""
    compute_dtype = dt(cfg.compute_dtype)
    pos2 = positions[:, None].to(torch.int32).contiguous()
    x = _embed_positions(params, cfg, tokens, pos2, compute_dtype)
    x = _session_stack(params, cfg, state, x, block_tables, pos2, compute_dtype)
    return unembed(x, params["embed"]["table"], compute_dtype)[:, 0], state



# ---------------------------------------------------------------------------
# The single-sequence path
# ---------------------------------------------------------------------------
def _mha(params, specs, cfg: ModelConfig, xq, xkv, *, causal, compute_dtype, cache=None,
         pos=None, q_block=1024, kv_block=1024, residual=None):
    """Multi-head attention, self (``xkv`` is ``xq``) or cross, as
    ``repro.models.whisper._mha``: with a ``cache`` and no ``xkv``, one
    query against the fixed cross K/V the cache holds; with a ``cache`` and
    ``xkv``, one decode token through the self-attention ring cache
    (``transformer.ring_attend``, in place; ``pos``: ``_pos_index``'s (1,)
    tensor); with neither, whole sequences through ``flash_attention``,
    returning their (k, v).  The skip connection fuses into the output
    projection's epilogue.  Returns (y, cache or (k, v))."""
    q = _heads(cfg, apply_linear(params["wq"], xq, specs["wq"], compute_dtype))
    if cache is not None and xkv is None:
        kpos = cache["pos"]
        qpos = pos if pos is not None else torch.arange(q.shape[1], device=q.device)
        o = attention_dense(q, cache["k"], cache["v"], qpos=qpos, kpos=kpos, kmask=kpos >= 0,
                            causal=False)
        new_cache = cache
    else:
        k = _heads(cfg, apply_linear(params["wk"], xkv, specs["wk"], compute_dtype))
        v = _heads(cfg, apply_linear(params["wv"], xkv, specs["wv"], compute_dtype))
        if cache is not None:
            o = ring_attend(q, k, v, cache, pos, causal=causal)
            new_cache = cache
        else:
            qpos = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
            kpos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
            o = flash_attention(q, k, v, qpos=qpos, kpos=kpos, causal=causal,
                                q_block=q_block, kv_block=kv_block)
            new_cache = (k, v)
    b, s = o.shape[:2]
    y = apply_linear(params["wo"], o.reshape(b, s, cfg.q_dim), specs["wo"], compute_dtype,
                     residual=residual)
    return y, new_cache


def decode_stack(params, cfg: ModelConfig, tokens, enc_out, compute_dtype, remat="none",
                 return_kv=False):
    """The decoder over whole sequences against ``enc_out`` (B, T_enc, D):
    causal self-attention, cross-attention, MLP; the final norm.  With
    ``return_kv`` also each layer's ((self k, v), (cross k, v)); without it
    each block runs under ``remat_wrap(remat)``."""
    aspecs, mspecs = attn_specs(cfg), mlp_specs(cfg, True)
    x = embed_lookup(params["embed"], tokens, compute_dtype)
    x = x + params["dec_pos"][:tokens.shape[1]].to(compute_dtype)

    def body(x, p, enc_out):
        h = apply_norm(p["ln1"], x)
        a, kv = _mha(p["attn"], aspecs, cfg, h, h, causal=True, compute_dtype=compute_dtype,
                     q_block=cfg.q_block, kv_block=cfg.kv_block, residual=x)
        y = a.to(x.dtype)
        a, xkv = _mha(p["xattn"], aspecs, cfg, apply_norm(p["ln_x"], y), enc_out, causal=False,
                      compute_dtype=compute_dtype, residual=y)
        y = a.to(y.dtype)
        x = apply_mlp(p["mlp"], apply_norm(p["ln2"], y), mspecs, cfg, compute_dtype,
                      residual=y).to(y.dtype)
        return x, (kv, xkv)

    kvs = []
    f = remat_wrap(lambda x, p, e: body(x, p, e)[0], remat)
    for p in params["dec_blocks"]:
        if return_kv:
            x, kv = body(x, p, enc_out)
            kvs.append(kv)
        else:
            x = f(x, p, enc_out)
    x = apply_norm(params["final_norm"], x)
    return (x, kvs) if return_kv else x


def _encoded(params, cfg: ModelConfig, b: int, enc_frames, compute_dtype, device,
             remat="none"):
    """The encoder's output on the given frames, or on zeros (B, T_enc, D)
    for an LM-style call."""
    if enc_frames is None:
        enc_frames = torch.zeros(b, cfg.enc_len, cfg.d_model, dtype=compute_dtype,
                                 device=device)
    return encode(params, cfg, enc_frames, compute_dtype, remat)


def forward(params, cfg: ModelConfig, tokens, positions=None, *, remat="none",
            enc_frames=None):
    """tokens (B, S) and frames (B, T_enc, D) (zeros when None) -> (the
    decoder's hidden (B, S, D), aux 0)."""
    compute_dtype = dt(cfg.compute_dtype)
    enc_out = _encoded(params, cfg, tokens.shape[0], enc_frames, compute_dtype, tokens.device,
                       remat)
    x = decode_stack(params, cfg, tokens, enc_out, compute_dtype, remat)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def head_weight(params, cfg: ModelConfig):
    """(D, V): the head is tied to the embedding."""
    return params["embed"]["table"].T


def init_cache(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=torch.bfloat16, *,
               device=None):
    """A decoder layer each: {"self": a ring cache of ``max_len`` entries
    (``transformer.solo_ring``); "cross": k/v (B, T_enc, H, Dh), pos
    (T_enc,)}."""
    device = resolve_device(device)
    cross = (batch, cfg.enc_len, cfg.n_heads, cfg.head_dim)
    return {"self": [solo_ring(cfg, batch, max_len, cache_dtype, device)
                     for _ in range(cfg.n_layers)],
            "cross": [{"k": torch.zeros(cross, dtype=cache_dtype, device=device),
                       "v": torch.zeros(cross, dtype=cache_dtype, device=device),
                       "pos": torch.zeros(cfg.enc_len, dtype=torch.int32, device=device)}
                      for _ in range(cfg.n_layers)]}


def prefill(params, cfg: ModelConfig, tokens, positions=None, cache_dtype=torch.bfloat16,
            max_len=None, enc_frames=None):
    """Encode the frames (zeros when None), run the decoder over the prompt
    and store each layer's self K/V (ring layout) and its cross K/V once.
    Returns (the last position's logits (B, V) f32, the cache)."""
    compute_dtype = dt(cfg.compute_dtype)
    b, s = tokens.shape
    max_len = max_len or s
    enc_out = _encoded(params, cfg, b, enc_frames, compute_dtype, tokens.device)
    x, kvs = decode_stack(params, cfg, tokens, enc_out, compute_dtype, return_kv=True)
    enc_pos = torch.arange(cfg.enc_len, dtype=torch.int32, device=x.device)
    cache = {"self": [], "cross": []}
    for (k, v), (xk, xv) in kvs:
        k_c, v_c, pos_c = _ring_from_prefill(k, v, s, max_len, cache_dtype)
        cache["self"].append({"k": k_c, "v": v_c, "pos": pos_c})
        cache["cross"].append({"k": xk.to(cache_dtype), "v": xv.to(cache_dtype),
                               "pos": enc_pos.clone()})
    return unembed(x[:, -1:], params["embed"]["table"], compute_dtype)[:, 0], cache


def decode_step(params, cfg: ModelConfig, caches, tokens, pos, positions=None):
    """tokens (B, 1) at decoder position ``pos`` (a Python int or a device
    tensor; the batch shares it).  Returns logits (B, V) f32 and the cache,
    its self-attention rings updated in place."""
    del positions
    compute_dtype = dt(cfg.compute_dtype)
    aspecs, mspecs = attn_specs(cfg), mlp_specs(cfg, True)
    x = embed_lookup(params["embed"], tokens, compute_dtype)
    p_idx = _pos_index(pos, x.device)
    x = x + params["dec_pos"].index_select(0, p_idx).to(compute_dtype)
    for p, c_self, c_cross in zip(params["dec_blocks"], caches["self"], caches["cross"]):
        h = apply_norm(p["ln1"], x)
        a, _ = _mha(p["attn"], aspecs, cfg, h, h, causal=True, compute_dtype=compute_dtype,
                    cache=c_self, pos=p_idx, residual=x)
        y = a.to(x.dtype)
        a, _ = _mha(p["xattn"], aspecs, cfg, apply_norm(p["ln_x"], y), None, causal=False,
                    compute_dtype=compute_dtype, cache=c_cross, pos=p_idx, residual=y)
        y = a.to(y.dtype)
        x = apply_mlp(p["mlp"], apply_norm(p["ln2"], y), mspecs, cfg, compute_dtype,
                      residual=y).to(y.dtype)
    x = apply_norm(params["final_norm"], x)
    return unembed(x, params["embed"]["table"], compute_dtype)[:, 0], caches
