"""Griffin / RecurrentGemma serving path (counterpart of the session path in
``repro.models.griffin``): RG-LRU recurrent blocks and local (sliding-window)
MQA attention blocks in a (rec, rec, attn) pattern (arXiv:2402.19427).

RG-LRU, per channel:

    r_t = σ(W_a u_t + b_a);  i_t = σ(W_x u_t + b_x)
    log a_t = -c · softplus(Λ) · r_t          (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

with the gate math, the recurrence and the output gate ``y = h ⊙
gelu_tanh(W_g x)`` in one ``kernels.dispatch.rg_lru_gated`` call (one kernel
launch on the card) and the attention blocks over per-slot rings
(``transformer.attn_ring``).  ``params["groups"]``
is a list of pattern groups (the JAX tree stacks them on a leading axis),
``params["tail"]`` the remainder layers; the session state mirrors it.  The
state is updated in place.  The single-sequence path (``forward``,
``prefill``, ``decode_step``, for ``models.api.Model``) runs the same
blocks over whole sequences and over one token, its attention blocks over
plain-op attention and ring caches (``transformer.attn_full``,
``attn_decode``), its decode step's scan with h in f32 and the output gate
after it, as the JAX package's ``rg_lru_step``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..config import ModelConfig
from ..kernels import dispatch
from ..kernels.scan_rglru import C_RGLRU
from .modules import (
    apply_linear,
    apply_mlp,
    apply_norm,
    dt,
    embed_lookup,
    init_embed,
    init_linear,
    init_mlp,
    init_norm,
    linear_spec,
    mlp_specs,
    remat_wrap,
    ring_write_index,
    unembed,
)
from .transformer import (
    _paged_rope,
    _pos_index,
    _ring_from_prefill,
    _rope_tables,
    attn_decode,
    attn_full,
    attn_ring,
    init_block,
    logits_from_hidden,
    make_block_specs,
    new_ring,
    ring_width,
    solo_ring,
)

# ---------------------------------------------------------------------------
# Pattern planning, specs, init
# ---------------------------------------------------------------------------
def _pat(cfg: ModelConfig) -> tuple[str, ...]:
    return cfg.pattern or ("rec", "rec", "attn")


def pattern_plan(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    """(n_full_groups, tail_kinds)."""
    pat = _pat(cfg)
    n_groups = cfg.n_layers // len(pat)
    tail = cfg.n_layers - n_groups * len(pat)
    return n_groups, tuple(pat[:tail])


def layer_keys(cfg: ModelConfig) -> list[str]:
    """A group's layer keys, ``l{i}_{kind}`` as in the JAX tree."""
    return [f"l{i}_{kind}" for i, kind in enumerate(_pat(cfg))]


def rec_specs(cfg: ModelConfig, ttd_block: bool = True):
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "in_x": linear_spec(cfg, "lru_in", d, w, ttd_block=ttd_block),
        "in_g": linear_spec(cfg, "lru_in_gate", d, w, ttd_block=ttd_block),
        "gate_a": linear_spec(cfg, "lru_gate_a", w, w),
        "gate_x": linear_spec(cfg, "lru_gate_x", w, w),
        "out": linear_spec(cfg, "lru_out", w, d, ttd_block=ttd_block),
        "mlp": mlp_specs(cfg, ttd_block),
    }


def init_rec_block(cfg: ModelConfig, specs, param_dtype, *, generator, device):
    w = cfg.lru_width or cfg.d_model
    kw = dict(generator=generator, device=device)
    conv_w = torch.randn(cfg.conv_width, w, **kw) / math.sqrt(cfg.conv_width)
    return {
        "ln1": init_norm(cfg.d_model, param_dtype, device=device),
        "ln2": init_norm(cfg.d_model, param_dtype, device=device),
        **{nm: init_linear(specs[nm], param_dtype, **kw)
           for nm in ("in_x", "in_g", "gate_a", "gate_x", "out")},
        "conv_w": conv_w.to(param_dtype),
        "conv_b": torch.zeros(w, dtype=param_dtype, device=device),
        "lambda": torch.full((w,), 0.7, dtype=param_dtype, device=device),
        "mlp": init_mlp(specs["mlp"], param_dtype, **kw),
    }


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
    rspecs, aspecs = rec_specs(cfg), make_block_specs(cfg, True)

    def layer(kind):
        if kind == "rec":
            return init_rec_block(cfg, rspecs, param_dtype, **kw)
        return init_block(cfg, aspecs, param_dtype, **kw)

    n_groups, tail = pattern_plan(cfg)
    params: dict[str, Any] = {"embed": init_embed(cfg, param_dtype, **kw),
                              "final_norm": init_norm(cfg.d_model, param_dtype, device=device)}
    if n_groups:
        params["groups"] = [{key: layer(kind) for key, kind in zip(layer_keys(cfg), _pat(cfg))}
                            for _ in range(n_groups)]
    if tail:
        params["tail"] = [layer(kind) for kind in tail]
    if not cfg.tie_embeddings:
        w = torch.randn(cfg.d_model, cfg.vocab_size, **kw) / math.sqrt(cfg.d_model)
        params["head"] = {"w": w.to(param_dtype)}
    return params


def specs_tree(cfg: ModelConfig):
    """The params' structure with each linear's ``LinearSpec`` at its place
    and ``None`` for every other leaf (used by ``core.compress``): ``groups``
    is a list of pattern groups, as in ``init_lm``."""
    rsp, asp = rec_specs(cfg, True), make_block_specs(cfg, True)
    rec = {"ln1": None, "ln2": None, "conv_w": None, "conv_b": None, "lambda": None,
           **{nm: rsp[nm] for nm in ("in_x", "in_g", "gate_a", "gate_x", "out")},
           "mlp": dict(rsp["mlp"])}
    attn = {"ln1": None, "ln2": None, "attn": asp.attn_d(), "mlp": asp.mlp_d()}
    n_groups, tail = pattern_plan(cfg)
    tree: dict[str, Any] = {"embed": None, "final_norm": None}
    if n_groups:
        group = {key: rec if kind == "rec" else attn
                 for key, kind in zip(layer_keys(cfg), _pat(cfg))}
        tree["groups"] = [group for _ in range(n_groups)]
    if tail:
        tree["tail"] = [rec if kind == "rec" else attn for kind in tail]
    if not cfg.tie_embeddings:
        tree["head"] = None
    return tree


# ---------------------------------------------------------------------------
# Conv1d (causal depthwise) + RG-LRU
# ---------------------------------------------------------------------------
def causal_conv1d(p, u, conv_state=None):
    """u: (B, S, W); conv_state: (B, cw-1, W) previous inputs or None (t = 0).
    Returns y and the last cw-1 inputs."""
    cw = p["conv_w"].shape[0]
    if conv_state is None:
        u_pad = F.pad(u, (0, 0, cw - 1, 0))
    else:
        u_pad = torch.cat([conv_state.to(u.dtype), u], dim=1)
    s = u.shape[1]
    y = u_pad[:, 0:s] * p["conv_w"][0].to(u.dtype)
    for i in range(1, cw):
        y = y + u_pad[:, i:i + s] * p["conv_w"][i].to(u.dtype)
    y = y + p["conv_b"].to(u.dtype)
    return y, u_pad[:, -(cw - 1):]


def rg_lru(p, specs, u, g, h, compute_dtype, positions=None):
    """The RG-LRU and its output gate: u (B, S, W) the conv output, g (B, S,
    W) the ``in_g`` linear's output, h (B, W) f32 the carried state, updated
    in place to the last state; ``positions`` (B, S) marks padding steps -1
    (the state passes through bitwise).  The gate linears run here; the gate
    math in f32 (r = σ(W_a u), i = σ(W_x u), log a = -c·softplus(Λ)·r,
    gx = i·u), the scan with h in u's dtype and y = h·gelu_tanh(g) are one
    ``dispatch.rg_lru_gated`` call.  Returns y (B, S, W) in g's dtype."""
    ga = apply_linear(p["gate_a"], u, specs["gate_a"], compute_dtype)
    gxp = apply_linear(p["gate_x"], u, specs["gate_x"], compute_dtype)
    y, _ = dispatch.rg_lru_gated(ga, gxp, u, p["lambda"], g, h, positions, h_out=h)
    return y


def _conv_state_masked(conv0, u, mask):
    """Last ``cw-1`` *real* conv inputs per row (padding is tail-only).

    conv0: (B, cw-1, W) previous inputs; u: (B, S, W) this call's inputs;
    mask: (B, S) f32.  A row with L real tokens keeps the inputs ending at
    its L-th token; L = 0 keeps ``conv0`` (cast to u's dtype)."""
    full = torch.cat([conv0.to(u.dtype), u], dim=1)
    n_real = mask.sum(dim=1).to(torch.int64)
    idx = n_real[:, None] + torch.arange(conv0.shape[1], device=u.device)[None, :]
    return torch.gather(full, 1, idx[:, :, None].expand(-1, -1, u.shape[-1]))


# ---------------------------------------------------------------------------
# Session blocks
# ---------------------------------------------------------------------------
def rec_block_session(p, specs, cfg: ModelConfig, x, state, positions, compute_dtype):
    """Position-addressed recurrent block (prefill chunk or decode step).

    x: (B, S, D); state: ``{"h": (B, W) f32, "conv": (B, cw-1, W)}`` plus
    ``"conv_scale"`` (B, cw-1) f32 when the conv tail is int8 (a per-(slot,
    tap) amax/127 scale); positions (B, S) (-1 = padding step).  Updates
    ``state`` in place; an idle row keeps its int8 tail and scale bitwise.
    """
    f32 = torch.float32
    mask = (positions >= 0).to(f32)
    conv_scale = state.get("conv_scale")
    conv0 = state["conv"]
    if conv_scale is not None:
        conv0 = conv0.to(f32) * conv_scale[..., None]
    hid = apply_norm(p["ln1"], x)
    u = apply_linear(p["in_x"], hid, specs["in_x"], compute_dtype)
    g = apply_linear(p["in_g"], hid, specs["in_g"], compute_dtype)
    u_conv, _ = causal_conv1d(p, u, conv0)
    y = rg_lru(p, specs, u_conv, g, state["h"], compute_dtype, positions=positions)
    y = apply_linear(p["out"], y, specs["out"], compute_dtype, residual=x).to(x.dtype)
    hid = apply_norm(p["ln2"], y)
    y = apply_mlp(p["mlp"], hid, specs["mlp"], cfg, compute_dtype, residual=y).to(y.dtype)
    new_conv = _conv_state_masked(conv0, u, mask)
    if conv_scale is None:
        state["conv"].copy_(new_conv.to(state["conv"].dtype))
        return y, state
    nc = new_conv.to(f32)
    sc = nc.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(nc / sc[..., None]).to(torch.int8)
    idle = (mask.sum(dim=1) == 0)
    state["conv"].copy_(torch.where(idle[:, None, None], state["conv"], q))
    state["conv_scale"].copy_(torch.where(idle[:, None], conv_scale, sc))
    return y, state


def attn_block_session(p, aspecs, cfg: ModelConfig, x, cache, rope_cs, positions,
                       compute_dtype, index=None):
    """Windowed attention block over a per-slot ring (ragged positions)."""
    hid = apply_norm(p["ln1"], x)
    a, cache = attn_ring(p, aspecs, cfg, hid, rope_cs, cache, positions, compute_dtype,
                         residual=x, index=index)
    y = a.to(x.dtype)
    hid = apply_norm(p["ln2"], y)
    y = apply_mlp(p["mlp"], hid, aspecs.mlp_d(), cfg, compute_dtype,
                  residual=y).to(y.dtype)
    return y, cache


def _layers(cfg: ModelConfig, tree) -> list[tuple[str, Any]]:
    """(kind, subtree) for every layer, in order, of a params or state tree."""
    out = [(kind, grp[key]) for grp in tree.get("groups", [])
           for key, kind in zip(layer_keys(cfg), _pat(cfg))]
    _, tail = pattern_plan(cfg)
    return out + list(zip(tail, tree.get("tail", [])))


def _session_stack(params, cfg: ModelConfig, state, x, positions, compute_dtype):
    rope_cs = _paged_rope(cfg, positions)
    rspecs, aspecs = rec_specs(cfg), make_block_specs(cfg, True)
    index = None
    for (kind, p), (_, st) in zip(_layers(cfg, params), _layers(cfg, state)):
        if kind == "rec":
            x, _ = rec_block_session(p, rspecs, cfg, x, st, positions, compute_dtype)
        else:
            if index is None:  # shared by every attention layer of the step
                index = ring_write_index(positions, st["k"].shape[1])
            x, _ = attn_block_session(p, aspecs, cfg, x, st, rope_cs, positions,
                                      compute_dtype, index)
    return apply_norm(params["final_norm"], x), state


# ---------------------------------------------------------------------------
# Session state and steps
# ---------------------------------------------------------------------------
def init_session_state(cfg: ModelConfig, batch: int, max_len: int, chunk: int,
                       cache_dtype=torch.float32, *, device=None):
    """Per-slot state, every leaf with its slot axis first: RG-LRU carry h
    (f32 always) and conv tail (``cache_dtype``; int8 with a per-(slot, tap)
    scale table) for recurrent layers, K/V rings of ``window + chunk``
    entries for attention layers."""
    device = resolve_device(device)
    w = cfg.lru_width or cfg.d_model
    wr = ring_width(cfg, max_len, chunk)
    int8 = cache_dtype == torch.int8

    def layer(kind):
        if kind != "rec":
            return new_ring(cfg, batch, wr, cache_dtype, device)
        st = {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
              "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=cache_dtype,
                                  device=device)}
        if int8:
            st["conv_scale"] = torch.full((batch, cfg.conv_width - 1), 1e-8 / 127.0,
                                          dtype=torch.float32, device=device)
        return st

    n_groups, tail = pattern_plan(cfg)
    return {"groups": [{key: layer(kind) for key, kind in zip(layer_keys(cfg), _pat(cfg))}
                       for _ in range(n_groups)],
            "tail": [layer(kind) for kind in tail]}


def prefill_session_chunk(params, cfg: ModelConfig, state, tokens, positions,
                          logit_cols=None):
    """One chunk of batched prefill: tokens (B, C), positions (B, C)
    (``-1`` = padding).  Returns logits (B, C, V) f32, or (B, V) at column
    ``logit_cols[b]`` of each row when given, and the state (updated in
    place)."""
    compute_dtype = dt(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, compute_dtype) * math.sqrt(cfg.d_model)
    positions = positions.to(torch.int32).contiguous()
    x, state = _session_stack(params, cfg, state, x, positions, compute_dtype)
    if logit_cols is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logit_cols]
    return logits_from_hidden(params, cfg, x, compute_dtype), state


def decode_session_step(params, cfg: ModelConfig, state, tokens, positions):
    """One ragged decode tick: tokens (B, 1), positions (B,) (``-1`` =
    inactive row).  Returns logits (B, V) f32 and the state."""
    logits, state = prefill_session_chunk(params, cfg, state, tokens, positions[:, None])
    return logits[:, 0], state



# ---------------------------------------------------------------------------
# The single-sequence path: whole sequences, prefill into per-layer state
# and ring caches, one-token decode at a shared position
# ---------------------------------------------------------------------------
def head_weight(params, cfg: ModelConfig):
    """(D, V) unembedding weight (tied or separate)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["head"]["w"]


def rec_block_seq(p, specs, cfg: ModelConfig, x, compute_dtype, return_state=False,
                  state_dtype=None):
    """Recurrent block over whole sequences from the zero state: the session
    block with every step real.  Returns x, with ``return_state`` also
    {"h": (B, W) f32, "conv": (B, cw-1, W) in ``state_dtype`` (default the
    compute dtype)}."""
    b, s, _ = x.shape
    w = cfg.lru_width or cfg.d_model
    state = {"h": torch.zeros(b, w, dtype=torch.float32, device=x.device),
             "conv": torch.zeros(b, cfg.conv_width - 1, w, dtype=state_dtype or compute_dtype,
                                 device=x.device)}
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s).contiguous()
    x, state = rec_block_session(p, specs, cfg, x, state, positions, compute_dtype)
    return (x, state) if return_state else x


def rec_block_decode(p, specs, cfg: ModelConfig, x, state, compute_dtype):
    """One token through a recurrent block; ``state`` {"h", "conv"} is
    updated in place.  The gates in f32, ``dispatch.rglru_scan`` with h in
    f32, then y = (h · gelu_tanh(g)) rounded to the compute dtype."""
    f32 = torch.float32
    hid = apply_norm(p["ln1"], x)
    u = apply_linear(p["in_x"], hid, specs["in_x"], compute_dtype)
    g = F.gelu(apply_linear(p["in_g"], hid, specs["in_g"], compute_dtype).to(f32),
               approximate="tanh")
    u, conv = causal_conv1d(p, u, state["conv"])
    r = torch.sigmoid(apply_linear(p["gate_a"], u, specs["gate_a"], compute_dtype).to(f32))
    i = torch.sigmoid(apply_linear(p["gate_x"], u, specs["gate_x"], compute_dtype).to(f32))
    log_a = -C_RGLRU * F.softplus(p["lambda"].to(f32)) * r
    h, h_last = dispatch.rglru_scan(log_a, i * u.to(f32), state["h"].to(f32), None,
                                    scan_dtype=f32)
    y = (h * g).to(compute_dtype)
    x = apply_linear(p["out"], y, specs["out"], compute_dtype, residual=x).to(x.dtype)
    x = apply_mlp(p["mlp"], apply_norm(p["ln2"], x), specs["mlp"], cfg, compute_dtype,
                  residual=x).to(x.dtype)
    state["h"].copy_(h_last)
    state["conv"].copy_(conv)
    return x, state


def attn_block_seq(p, specs, cfg: ModelConfig, x, rope_cs, compute_dtype, return_cache=False,
                   cache_len=0, cache_dtype=torch.bfloat16):
    """Windowed attention block over whole sequences; with ``return_cache``
    also its ring cache of ``cache_len`` entries."""
    a, kv = attn_full(p, specs, cfg, apply_norm(p["ln1"], x), rope_cs, compute_dtype,
                      return_kv=return_cache, residual=x)
    x = a.to(x.dtype)
    x = apply_mlp(p["mlp"], apply_norm(p["ln2"], x), specs.mlp_d(), cfg, compute_dtype,
                  residual=x).to(x.dtype)
    if not return_cache:
        return x
    k_c, v_c, pos_c = _ring_from_prefill(kv[0], kv[1], x.shape[1], cache_len, cache_dtype)
    return x, {"k": k_c, "v": v_c, "pos": pos_c}


def attn_block_decode(p, specs, cfg: ModelConfig, x, cache, rope_cs, pos, compute_dtype):
    """One token through an attention block against its ring cache (updated
    in place)."""
    a, cache = attn_decode(p, specs, cfg, apply_norm(p["ln1"], x), rope_cs, cache, pos,
                           compute_dtype, residual=x)
    x = a.to(x.dtype)
    x = apply_mlp(p["mlp"], apply_norm(p["ln2"], x), specs.mlp_d(), cfg, compute_dtype,
                  residual=x).to(x.dtype)
    return x, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=torch.bfloat16, *,
               device=None):
    """The single-sequence state, laid out as ``init_lm``'s params: for a
    recurrent layer {"h": (B, W) f32, "conv": (B, cw-1, W)}, for an
    attention layer a ring cache of ``min(window, max_len)`` entries
    (``transformer.init_cache``'s layout)."""
    device = resolve_device(device)
    w = cfg.lru_width or cfg.d_model
    win = min(cfg.window or max_len, max_len)

    def layer(kind):
        if kind == "rec":
            return {"h": torch.zeros(batch, w, dtype=torch.float32, device=device),
                    "conv": torch.zeros(batch, cfg.conv_width - 1, w, dtype=cache_dtype,
                                        device=device)}
        return solo_ring(cfg, batch, win, cache_dtype, device)

    n_groups, tail = pattern_plan(cfg)
    return {"groups": [{key: layer(kind) for key, kind in zip(layer_keys(cfg), _pat(cfg))}
                       for _ in range(n_groups)],
            "tail": [layer(kind) for kind in tail]}


def _embed(params, cfg: ModelConfig, tokens, compute_dtype):
    return embed_lookup(params["embed"], tokens, compute_dtype) * math.sqrt(cfg.d_model)


def forward(params, cfg: ModelConfig, tokens, positions=None, *, remat="none"):
    """tokens (B, S) -> (hidden (B, S, D) after the final norm, aux 0).
    Each whole pattern group runs under ``remat_wrap(remat)``, the tail's
    layers without it, as the reference's scan over the groups."""
    compute_dtype = dt(cfg.compute_dtype)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens, compute_dtype)
    rope_cs = _rope_tables(cfg, positions, b, s, x.device)
    rspecs, aspecs = rec_specs(cfg), make_block_specs(cfg, True)

    def layer(kind, p, h):
        return rec_block_seq(p, rspecs, cfg, h, compute_dtype) if kind == "rec" else \
            attn_block_seq(p, aspecs, cfg, h, rope_cs, compute_dtype)

    def group_body(h, gp):
        for key, kind in zip(layer_keys(cfg), _pat(cfg)):
            h = layer(kind, gp[key], h)
        return h

    f = remat_wrap(group_body, remat)
    for gp in params.get("groups", []):
        x = f(x, gp)
    for kind, p in zip(pattern_plan(cfg)[1], params.get("tail", [])):
        x = layer(kind, p, x)
    return apply_norm(params["final_norm"], x), torch.zeros((), dtype=torch.float32,
                                                            device=x.device)


def prefill(params, cfg: ModelConfig, tokens, positions=None, cache_dtype=torch.bfloat16,
            max_len=None):
    """Whole-prompt prefill: (the last position's logits (B, V) f32, the
    state in :func:`init_cache`'s layout)."""
    compute_dtype = dt(cfg.compute_dtype)
    b, s = tokens.shape
    max_len = max_len or s
    win = min(cfg.window or max_len, max_len)
    x = _embed(params, cfg, tokens, compute_dtype)
    rope_cs = _rope_tables(cfg, positions, b, s, x.device)
    rspecs, aspecs = rec_specs(cfg), make_block_specs(cfg, True)
    states = []
    for kind, p in _layers(cfg, params):
        if kind == "rec":
            x, st = rec_block_seq(p, rspecs, cfg, x, compute_dtype, return_state=True,
                                  state_dtype=cache_dtype)
        else:
            x, st = attn_block_seq(p, aspecs, cfg, x, rope_cs, compute_dtype,
                                   return_cache=True, cache_len=win, cache_dtype=cache_dtype)
        states.append(st)
    n_groups, _ = pattern_plan(cfg)
    per = len(_pat(cfg))
    cache = {"groups": [dict(zip(layer_keys(cfg), states[i * per:(i + 1) * per]))
                        for i in range(n_groups)],
             "tail": states[n_groups * per:]}
    x = apply_norm(params["final_norm"], x[:, -1:])
    return unembed(x, head_weight(params, cfg).T, compute_dtype)[:, 0], cache


def decode_step(params, cfg: ModelConfig, caches, tokens, pos, positions=None):
    """tokens (B, 1) at absolute position ``pos`` (a Python int or a device
    tensor; the batch shares it).  Returns logits (B, V) f32 and the state,
    updated in place."""
    del positions  # the rotary table is pos's, as the JAX package's
    compute_dtype = dt(cfg.compute_dtype)
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens, compute_dtype)
    p_idx = _pos_index(pos, x.device)
    rope_cs = _rope_tables(cfg, p_idx, b, 1, x.device)
    rspecs, aspecs = rec_specs(cfg), make_block_specs(cfg, True)
    for (kind, p), (_, st) in zip(_layers(cfg, params), _layers(cfg, caches)):
        if kind == "rec":
            x, _ = rec_block_decode(p, rspecs, cfg, x, st, compute_dtype)
        else:
            x, _ = attn_block_decode(p, aspecs, cfg, x, st, rope_cs, p_idx, compute_dtype)
    x = apply_norm(params["final_norm"], x)
    return unembed(x, head_weight(params, cfg).T, compute_dtype)[:, 0], caches
