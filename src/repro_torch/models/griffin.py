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
state is updated in place.  The training/full-sequence bodies (``forward``,
``prefill``, ``decode_step``, ``*_seq``) are not ported: they are not on the
serving path.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..config import ModelConfig
from ..kernels import dispatch
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
    ring_write_index,
)
from .transformer import (
    _paged_rope,
    attn_ring,
    init_block,
    logits_from_hidden,
    make_block_specs,
    new_ring,
    ring_width,
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
