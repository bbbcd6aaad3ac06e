"""RWKV6 "Finch" serving path (counterpart of the session path in
``repro.models.rwkv``): an attention-free LM with data-dependent decay
(arXiv:2404.05892).  Time-mix recurrence per head (state S ∈ R^{hd×hd}):

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t;   y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

with w_t = exp(-exp(w0 + tanh(x_w W_d1) W_d2)) per token and channel, and
token-shift ddlerp mixing modulated by a LoRA.  The recurrence runs in
``kernels.dispatch.wkv_scan``; the LoRA mix/decay products and the per-head
LayerNorm are plain torch ops (they are not Pallas kernels in the JAX
package either).  ``params["blocks"]`` is a per-layer list (the JAX tree
stacks them), and so is the session state.  The single-sequence path
(``forward``, ``prefill``, ``decode_step``, for ``models.api.Model``) runs
the same blocks with its state given or from zeros.

Positions only carry the serving liveness convention (-1 = padding step or
inactive row): a padding step leaves the wkv state untouched and the
token-shift state keeps the last real token.
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
    apply_norm,
    dt,
    embed_lookup,
    init_embed,
    init_linear,
    init_norm,
    linear_spec,
    remat_wrap,
    unembed,
)

MIX_COMPONENTS = ("w", "k", "v", "r", "g")


# ---------------------------------------------------------------------------
# Specs / init
# ---------------------------------------------------------------------------
def rwkv_specs(cfg: ModelConfig, ttd_block: bool = True):
    d = cfg.d_model
    return {
        "tm": {
            "r": linear_spec(cfg, "tm_r", d, d, ttd_block=ttd_block),
            "k": linear_spec(cfg, "tm_k", d, d, ttd_block=ttd_block),
            "v": linear_spec(cfg, "tm_v", d, d, ttd_block=ttd_block),
            "g": linear_spec(cfg, "tm_g", d, d, ttd_block=ttd_block),
            "o": linear_spec(cfg, "tm_out", d, d, ttd_block=ttd_block),
        },
        "cm": {
            "k": linear_spec(cfg, "cm_key", d, cfg.d_ff, ttd_block=ttd_block),
            "v": linear_spec(cfg, "cm_value", cfg.d_ff, d, ttd_block=ttd_block),
            "r": linear_spec(cfg, "cm_r", d, d, ttd_block=ttd_block),
        },
    }


def init_rwkv_block(cfg: ModelConfig, specs, param_dtype, *, generator, device):
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    lm, ld = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay

    def full(shape, value):
        return torch.full(shape, value, dtype=param_dtype, device=device)

    def small(*shape, std=0.01):
        return (torch.randn(*shape, **kw) * std).to(param_dtype)

    return {
        "ln1": init_norm(d, param_dtype, device=device),
        "ln2": init_norm(d, param_dtype, device=device),
        "tm": {nm: init_linear(sp, param_dtype, **kw) for nm, sp in specs["tm"].items()},
        "cm": {nm: init_linear(sp, param_dtype, **kw) for nm, sp in specs["cm"].items()},
        "mu_base": full((d,), 0.5),
        "mu": full((5, d), 0.5),
        "mix_w1": small(d, 5 * lm),
        "mix_w2": small(5, lm, d),
        "decay_w0": full((d,), -3.0),
        "decay_w1": small(d, ld),
        "decay_w2": small(ld, d),
        "bonus_u": small(d, std=0.1),
        "ln_x": {"scale": full((d,), 1.0), "bias": full((d,), 0.0)},
        "mu_cm_k": full((d,), 0.5),
        "mu_cm_r": full((d,), 0.5),
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
    specs = rwkv_specs(cfg)
    params: dict[str, Any] = {
        "embed": init_embed(cfg, param_dtype, **kw),
        "blocks": [init_rwkv_block(cfg, specs, param_dtype, **kw) for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg.d_model, param_dtype, device=device),
    }
    if not cfg.tie_embeddings:
        w = torch.randn(cfg.d_model, cfg.vocab_size, **kw) / math.sqrt(cfg.d_model)
        params["head"] = {"w": w.to(param_dtype)}
    return params


def specs_tree(cfg: ModelConfig):
    """The params' structure with each linear's ``LinearSpec`` at its place
    and ``None`` for every other leaf (used by ``core.compress``): ``blocks``
    is a list of layers, as in ``init_lm``."""
    sp = rwkv_specs(cfg)
    block = {k: None for k in ("ln1", "ln2", "mu_base", "mu", "mix_w1", "mix_w2",
                               "decay_w0", "decay_w1", "decay_w2", "bonus_u",
                               "ln_x", "mu_cm_k", "mu_cm_r")}
    block["tm"] = dict(sp["tm"])
    block["cm"] = dict(sp["cm"])
    tree = {"embed": None, "blocks": [block for _ in range(cfg.n_layers)], "final_norm": None}
    if not cfg.tie_embeddings:
        tree["head"] = None
    return tree


def head_weight(params, cfg: ModelConfig):
    """(D, V) unembedding weight (tied or separate)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["head"]["w"]


# ---------------------------------------------------------------------------
# Token shift + ddlerp.  The JAX package promotes mixed operands (an f32
# token-shift state against compute-dtype activations) to the wider type;
# ``_mm`` and torch's own promotion do the same here.
# ---------------------------------------------------------------------------
def _mm(a, b):
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(t), b.to(t))


def _ddlerp(p, x, x_prev, compute_dtype):
    """dict component -> mixed input (B, S, D) for the five projections."""
    xx = x_prev - x
    base = x + xx * p["mu_base"].to(compute_dtype)
    lm = p["mix_w1"].shape[1] // 5
    a = torch.tanh(_mm(base, p["mix_w1"].to(compute_dtype)))
    a = a.reshape(*a.shape[:-1], 5, lm)  # (B, S, 5, lm)
    w2 = p["mix_w2"].to(compute_dtype)
    t = torch.promote_types(a.dtype, w2.dtype)
    off = torch.einsum("bscl,cld->cbsd", a.to(t), w2.to(t))
    return {c: x + xx * (p["mu"][i].to(compute_dtype) + off[i])
            for i, c in enumerate(MIX_COMPONENTS)}


def _decay(p, x_w):
    """Per-token per-channel decay w_t ∈ (0, 1): exp(-exp(·)), in f32."""
    f32 = torch.float32
    dd = torch.tanh(x_w.to(f32) @ p["decay_w1"].to(f32)) @ p["decay_w2"].to(f32)
    log_w = -torch.exp(torch.clamp(p["decay_w0"].to(f32) + dd, -20.0, 8.0))
    return torch.exp(log_w)


def _group_norm(p, y, eps=1e-5):
    """Per-head LayerNorm on (B, S, H, hd), flattened back to (B, S, D), f32."""
    b, s, h, hd = y.shape
    yf = y.to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yn = ((yf - mu) * torch.rsqrt(var + eps)).reshape(b, s, h * hd)
    return yn * p["ln_x"]["scale"].to(torch.float32) + p["ln_x"]["bias"].to(torch.float32)


def _last_real(x_prev, x, mask):
    """Last real token of the chunk per row (padding is tail-only); a row
    with no real token keeps ``x_prev``.  x_prev (B, 1, D), x (B, S, D),
    mask (B, S) bool."""
    full = torch.cat([x_prev, x], dim=1)
    n_real = mask.sum(dim=1)
    idx = n_real[:, None, None].expand(-1, 1, full.shape[-1])
    return torch.gather(full, 1, idx)


# ---------------------------------------------------------------------------
# Time mix / channel mix / block
# ---------------------------------------------------------------------------
def time_mix(p, specs, cfg: ModelConfig, x, x_prev, state0, compute_dtype, residual=None,
             positions=None, state_scale=None):
    """x (B, S, D); x_prev (B, 1, D) the previous chunk's last token; state0
    (B, H, hd, hd) f32, or int8 with ``state_scale`` (B, H).  Returns (y,
    last_x, new_state, new_scale or None); ``residual`` (the block's skip)
    fuses into the output projection's epilogue."""
    b, s, d = x.shape
    h, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    mask = None if positions is None else positions >= 0
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    mixed = _ddlerp(p, x, shifted, compute_dtype)
    tm, sp = p["tm"], specs["tm"]
    r = apply_linear(tm["r"], mixed["r"], sp["r"], compute_dtype)
    k = apply_linear(tm["k"], mixed["k"], sp["k"], compute_dtype)
    v = apply_linear(tm["v"], mixed["v"], sp["v"], compute_dtype)
    g = F.silu(apply_linear(tm["g"], mixed["g"], sp["g"], compute_dtype).to(torch.float32))
    w = _decay(p, mixed["w"])
    u = p["bonus_u"].to(torch.float32).reshape(h, hd)
    y, state, new_scale = dispatch.wkv_scan(
        r.reshape(b, s, h, hd), k.reshape(b, s, h, hd), v.reshape(b, s, h, hd),
        w.reshape(b, s, h, hd), u, state0, positions, state_scale=state_scale)
    y = _group_norm(p, y).to(compute_dtype) * g.to(compute_dtype)
    y = apply_linear(tm["o"], y, sp["o"], compute_dtype, residual=residual)
    last_x = x[:, -1:] if mask is None else _last_real(x_prev, x, mask)
    return y, last_x, state, new_scale


def channel_mix(p, specs, x, x_prev, compute_dtype, mask=None):
    """relu² rides the key projection's epilogue; the residual cannot fuse
    into cm_value because the r-gate multiplies its output first."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    xx = shifted - x
    xk = x + xx * p["mu_cm_k"].to(compute_dtype)
    xr = x + xx * p["mu_cm_r"].to(compute_dtype)
    cm, sp = p["cm"], specs["cm"]
    k = apply_linear(cm["k"], xk, sp["k"], compute_dtype, activation="relu2")
    kv = apply_linear(cm["v"], k, sp["v"], compute_dtype)
    rgate = torch.sigmoid(apply_linear(cm["r"], xr, sp["r"], compute_dtype).to(torch.float32))
    last_x = x[:, -1:] if mask is None else _last_real(x_prev, x, mask)
    return (rgate * kv.to(torch.float32)).to(compute_dtype), last_x


def apply_block(p, specs, cfg: ModelConfig, x, state, compute_dtype, positions=None):
    """state: {"wkv": (B, H, hd, hd), "x_tm": (B, 1, D), "x_cm": (B, 1, D)}
    with f32 token-shift leaves, plus ``"wkv_scale"`` (B, H) f32 when the
    wkv state is int8.  Returns x and the new state (new tensors)."""
    mask = None if positions is None else positions >= 0
    hid = apply_norm(p["ln1"], x)
    y, last_tm, wkv, wkv_scale = time_mix(
        p, specs, cfg, hid, state["x_tm"], state["wkv"], compute_dtype, residual=x,
        positions=positions, state_scale=state.get("wkv_scale"))
    x = y.to(x.dtype)
    hid = apply_norm(p["ln2"], x)
    y, last_cm = channel_mix(p, specs, hid, state["x_cm"], compute_dtype, mask=mask)
    x = x + y.to(x.dtype)
    new_state = {"wkv": wkv, "x_tm": last_tm, "x_cm": last_cm}
    if wkv_scale is not None:
        new_state["wkv_scale"] = wkv_scale
    return x, new_state


# ---------------------------------------------------------------------------
# Session state and steps
# ---------------------------------------------------------------------------
def _state_dtypes(dtype) -> dict:
    """The leaf dtypes of :func:`init_state`'s layers for a state ``dtype``."""
    int8 = dtype == torch.int8
    tail = torch.float32 if int8 else dtype
    return {"wkv": torch.int8 if int8 else torch.float32, "x_tm": tail, "x_cm": tail,
            "wkv_scale": torch.float32}


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *, device=None):
    """Per-layer list of per-slot state, every leaf with its slot axis first:
    the wkv matrices (f32; int8 with per-(slot, head) scales starting at
    1e-8/127, as the JAX package's) and the token-shift tails (``dtype``;
    f32 beside an int8 wkv state)."""
    device = resolve_device(device)
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    dts = _state_dtypes(dtype)

    def layer():
        st = {"wkv": torch.zeros((batch, h, hd, hd), dtype=dts["wkv"], device=device),
              "x_tm": torch.zeros((batch, 1, cfg.d_model), dtype=dts["x_tm"], device=device),
              "x_cm": torch.zeros((batch, 1, cfg.d_model), dtype=dts["x_cm"], device=device)}
        if dtype == torch.int8:
            st["wkv_scale"] = torch.full((batch, h), 1e-8 / 127.0, dtype=torch.float32,
                                         device=device)
        return st

    return [layer() for _ in range(cfg.n_layers)]


def init_session_state(cfg: ModelConfig, batch: int, cache_dtype=torch.float32, *,
                       device=None):
    return init_state(cfg, batch, cache_dtype, device=device)


def session_layer(p, specs, cfg: ModelConfig, x, st, compute_dtype, positions):
    """One layer of a session step: ``apply_block`` on the layer's state
    ``st`` with its token-shift tails in f32.  ``st`` is updated in place:
    it takes the new wkv tensors, and the tails are copied back in their
    stored dtype.  Returns x."""
    f32 = {k: (t.to(torch.float32) if k in ("x_tm", "x_cm") else t) for k, t in st.items()}
    x, new = apply_block(p, specs, cfg, x, f32, compute_dtype, positions=positions)
    st["wkv"] = new["wkv"]
    if "wkv_scale" in new:
        st["wkv_scale"] = new["wkv_scale"]
    st["x_tm"].copy_(new["x_tm"])
    st["x_cm"].copy_(new["x_cm"])
    return x


def session_logits(params, cfg: ModelConfig, x, logit_cols=None):
    """Final norm and head: logits (B, C, V) f32, or (B, V) at column
    ``logit_cols[b]`` of each row when given."""
    x = apply_norm(params["final_norm"], x)
    if logit_cols is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logit_cols]
    return unembed(x, head_weight(params, cfg).T, dt(cfg.compute_dtype))


def prefill_session_chunk(params, cfg: ModelConfig, state, tokens, positions,
                          logit_cols=None):
    """One chunk of batched prefill: tokens (B, C), positions (B, C) (-1 =
    padding).  Returns logits (B, C, V) f32, or (B, V) at column
    ``logit_cols[b]`` of each row when given, and the state, updated in
    place layer by layer (``session_layer``)."""
    compute_dtype = dt(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, compute_dtype)
    positions = positions.to(torch.int32).contiguous()
    specs = rwkv_specs(cfg)
    for p, st in zip(params["blocks"], state):
        x = session_layer(p, specs, cfg, x, st, compute_dtype, positions)
    return session_logits(params, cfg, x, logit_cols), state


def decode_session_step(params, cfg: ModelConfig, state, tokens, positions):
    """One ragged decode tick: tokens (B, 1), positions (B,) (-1 = inactive
    row).  Returns logits (B, V) f32 and the state."""
    logits, state = prefill_session_chunk(params, cfg, state, tokens, positions[:, None])
    return logits[:, 0], state



# ---------------------------------------------------------------------------
# The single-sequence path
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens, positions=None, *, remat="none", state=None,
            return_state=False, masked=False):
    """tokens (B, S) -> (hidden (B, S, D) after the final norm, aux 0), or
    with ``return_state`` (hidden, the new state: new tensors, ``state`` is
    left as it was).  ``state`` defaults to zeros (token-shift tails in the
    compute dtype); ``masked`` makes ``positions`` the serving liveness mask
    (-1 = padding step), else every step is real."""
    compute_dtype = dt(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, compute_dtype)
    if state is None:
        state = init_state(cfg, tokens.shape[0], compute_dtype, device=x.device)
    pos = positions if masked else None
    specs = rwkv_specs(cfg)

    def body(carry, p, st):
        return apply_block(p, specs, cfg, carry, st, compute_dtype, positions=pos)

    f = remat_wrap(body, remat)  # each block, as the reference's scan body
    new_state = []
    for p, st in zip(params["blocks"], state):
        x, st = f(x, p, st)
        new_state.append(st)
    x = apply_norm(params["final_norm"], x)
    if return_state:
        return x, new_state
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=torch.bfloat16, *,
               device=None):
    """The O(1) state (``max_len`` is not used): :func:`init_state`."""
    del max_len
    return init_state(cfg, batch, cache_dtype, device=device)


def decode_step(params, cfg: ModelConfig, state, tokens, pos, positions=None):
    """One token: the state's float leaves up-cast to f32 for the step and
    the new state cast back to the stored dtypes.  Returns logits (B, V)
    f32 and the new state."""
    del pos, positions
    f32 = [{k: (t if t.dtype == torch.int32 else t.to(torch.float32)) for k, t in st.items()}
           for st in state]
    x, new_state = forward(params, cfg, tokens, state=f32, return_state=True)
    logits = unembed(x[:, -1:], head_weight(params, cfg).T, dt(cfg.compute_dtype))[:, 0]
    return logits, [{k: t.to(old[k].dtype) for k, t in st.items()}
                    for st, old in zip(new_state, state)]


def prefill(params, cfg: ModelConfig, tokens, positions=None, cache_dtype=torch.bfloat16,
            max_len=None):
    """Whole-prompt prefill from the zero state: (the last position's logits
    (B, V) f32, the state cast to :func:`init_cache`'s dtypes)."""
    x, new_state = forward(params, cfg, tokens, return_state=True)
    logits = unembed(x[:, -1:], head_weight(params, cfg).T, dt(cfg.compute_dtype))[:, 0]
    dts = _state_dtypes(cache_dtype)
    return logits, [{k: t.to(dts[k]) for k, t in st.items()} for st in new_state]
