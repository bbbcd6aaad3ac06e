"""Mixture-of-Experts, single device (counterpart of ``repro.models.moe``).

Ported: the router (``route``: f32 logits, softmax, top-k, renormalized
gates), the load-balance loss (``aux_loss``) and ``apply_moe``, which
computes ``repro``'s no-mesh path (``_moe_dense``) on the routed rows only:
the T·K (token, expert) pairs are sorted by expert, each expert's rows run
through its gated MLP as one grouped call a linear (the TT experts' through
``dispatch.tt_linear_grouped``, one launch over every expert), and each
token sums its experts' outputs weighted by its gates.  Nothing on that path
reads a value back to the host: the rows an expert takes are counted and
offset on the device.  No token is dropped (``capacity_factor`` and
``moe_impl`` play no part on one device).

Numerics follow ``_moe_dense``: the gates are rounded to the compute dtype
(``combine.astype(compute_dtype)``), each token's sum over its experts is
taken in f32 and rounded once to the compute dtype, and the block's skip
connection is added by the caller after the combine, in x's dtype.

Not ported yet: the expert-parallel paths ``ep`` and ``ep_psum`` and the
tensor-parallel ``tp`` path (``_moe_ep``, ``_moe_ep_psum``, ``_moe_tp``), which
wait for ``dist/`` on ``torch.distributed``.
"""
from __future__ import annotations

from typing import Any

import torch

from ..config import ModelConfig
from ..kernels import dispatch
from .modules import LinearSpec, apply_linear, init_linear, init_mlp, linear_spec, mlp_specs

# what the card refuses up front (``dispatch.card_limits``) and the grouped
# linear raises on a CUDA tensor
NON_TT_EXPERTS = ("MoE experts take TT cores on the card (grouped tt_linear); int4/dense "
                  "experts wait for a grouped kernel")


# ---------------------------------------------------------------------------
# Specs / init
# ---------------------------------------------------------------------------
def moe_specs(cfg: ModelConfig, ttd_block: bool) -> dict[str, Any]:
    """The router's spec and one expert's gated-MLP specs (every expert
    shares them)."""
    e_specs = mlp_specs(cfg, ttd_block, d_in=cfg.d_model, d_ff=cfg.d_ff_expert,
                        prefix="expert")
    return {"router": linear_spec(cfg, "router", cfg.d_model, cfg.n_experts),
            "expert": e_specs}


def _stack(trees: list):
    """Per-expert trees of one structure -> one tree, each leaf stacked on a
    leading expert axis (TT cores: each core (E, r·n, m·r))."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def init_moe(cfg: ModelConfig, specs, param_dtype, *, generator, device) -> dict[str, Any]:
    """The router in f32 whatever ``param_dtype`` is (as ``repro``'s), the
    experts' MLPs stacked on a leading E axis."""
    kw = dict(generator=generator, device=device)
    return {
        "router": init_linear(specs["router"], torch.float32, **kw),
        "experts": _stack([init_mlp(specs["expert"], param_dtype, **kw)
                           for _ in range(cfg.n_experts)]),
    }


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
def route(params, x, specs, cfg: ModelConfig):
    """x (T, D) -> probs (T, E) f32, gates (T, K) f32, eids (T, K).  Equal
    probabilities go to the lower expert index, as ``jax.lax.top_k`` breaks
    ties: a stable descending sort cut to K."""
    logits = apply_linear(params["router"], x, specs["router"], torch.float32)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, eids = gates[:, :k], eids[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, eids


def _counts(flat, n_experts: int, dtype):
    """Rows each expert takes of the flat expert ids, on the device: a scatter-add
    (``torch.bincount`` reads the largest id back to the host on CUDA)."""
    return torch.zeros(n_experts, dtype=dtype, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=dtype))


def aux_loss(probs, eids, cfg: ModelConfig):
    """Switch-style load-balance loss over one device's tokens (``repro``'s
    ``_aux_loss`` with ``axes=None``)."""
    e = cfg.n_experts
    me = probs.mean(0)
    hits = _counts(eids.reshape(-1), e, torch.float32)
    ce = hits / hits.sum().clamp(min=1.0)
    return e * torch.sum(me * ce) * cfg.router_aux_coef


# ---------------------------------------------------------------------------
# Grouped expert FFN
# ---------------------------------------------------------------------------
def sort_by_expert(eids, n_experts: int):
    """(T, K) expert ids -> (order, offsets): ``order`` (T·K,) the pairs
    sorted by expert, stable (a token's pairs keep their slot order within an
    expert), and ``offsets`` (E + 1,) int32 where expert e's rows begin;
    counted on the device."""
    flat = eids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    offsets = torch.zeros(n_experts + 1, dtype=torch.int32, device=flat.device)
    offsets[1:] = torch.cumsum(_counts(flat, n_experts, torch.int32), 0)
    return order, offsets


def grouped_linear(params, x, offsets, spec: LinearSpec, compute_dtype, *,
                   activation: str | None = None):
    """Each expert's linear on its rows of ``x`` (R, n_in), sorted by expert
    at ``offsets``; ``params`` stacked on the expert axis.  TT experts take
    the grouped kernel; int4 and dense experts run expert by expert, which
    reads the offsets on the host, so only on the plain versions."""
    x = x.to(compute_dtype)
    if spec.kind == "tt":
        return dispatch.tt_linear_grouped(x, offsets, params["cores"], spec.tt,
                                          activation=activation)
    if x.is_cuda and not dispatch.plain_forced():
        raise ValueError(NON_TT_EXPERTS)
    off = offsets.tolist()
    out = x.new_empty(x.shape[0], spec.n_out)
    for e in range(len(off) - 1):
        if off[e + 1] > off[e]:
            p = {k: v[e] for k, v in params.items()}
            out[off[e]:off[e + 1]] = apply_linear(p, x[off[e]:off[e + 1]], spec, compute_dtype,
                                                  activation=activation)
    return out


def expert_ffn(expert_params, x, offsets, specs, cfg: ModelConfig, compute_dtype):
    """Rows (R, D) sorted by expert -> (R, D): grouped gate (the activation in
    its epilogue), grouped up, their product, grouped down."""
    act = "silu" if cfg.act == "swiglu" else "gelu"
    sp = specs["expert"]
    g = grouped_linear(expert_params["gate"], x, offsets, sp["gate"], compute_dtype,
                       activation=act)
    u = grouped_linear(expert_params["up"], x, offsets, sp["up"], compute_dtype)
    return grouped_linear(expert_params["down"], g * u, offsets, sp["down"], compute_dtype)


def apply_moe(params, x, specs, cfg: ModelConfig, compute_dtype):
    """x (B, S, D) -> (y (B, S, D) in the compute dtype, aux loss f32)."""
    b, s, d = x.shape
    t, k = b * s, cfg.experts_per_token
    xt = x.reshape(t, d)
    probs, gates, eids = route(params, xt, specs, cfg)
    order, offsets = sort_by_expert(eids, cfg.n_experts)
    ys = expert_ffn(params["experts"], xt[order // k], offsets, specs, cfg, compute_dtype)
    per_pair = torch.empty_like(ys)
    per_pair[order] = ys  # back to (token, slot) order
    per_pair = per_pair.reshape(t, k, d)
    g = gates.to(compute_dtype).to(torch.float32)
    y = per_pair[:, 0].to(torch.float32) * g[:, :1]
    for j in range(1, k):
        y = y + per_pair[:, j].to(torch.float32) * g[:, j:j + 1]
    return y.to(compute_dtype).reshape(b, s, d), aux_loss(probs, eids, cfg)
