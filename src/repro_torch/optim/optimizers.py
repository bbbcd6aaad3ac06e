"""AdamW and Adafactor (counterpart of ``repro.optim.optimizers``), with the
reference's arithmetic, written on ``torch._foreach_*`` lists (AdamW) and
per leaf (Adafactor).

``OptState.inner`` is a tree of f32 tensors named as the reference's: AdamW
``{"mu": <params tree>, "nu": <params tree>}``; Adafactor the params tree
with each leaf replaced by ``{"vr", "vc"}`` (factored: the last two dims
both >= 8) or ``{"v"}``.  ``step`` is a 0-dim int32 tensor on the host, as
is the learning rate: the bias corrections and the Adafactor decay are
computed there in f32, and the device ops take them as scalars, so an
update reads nothing back from the card.  ``apply_optimizer`` returns new
tensors (the inputs are left as they were), so a step that fails leaves
the state it was given.  ``opt_state_pspecs`` belongs to ``dist/``, which
is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..tree import leaves, tree_map, unflatten

EPS1 = 1e-30


@dataclass(frozen=True)
class OptState:
    kind: str  # adamw | adafactor
    inner: Any  # tree of per-param states
    step: torch.Tensor


def _is_factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def init_optimizer(kind: str, params) -> OptState:
    """Zero f32 state on each param's device; ``step`` 0 on the host."""
    if kind == "adamw":
        inner = {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                 "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
    elif kind == "adafactor":
        def leaf(p):
            if _is_factored(p.shape):
                return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        inner = tree_map(leaf, params)
    else:
        raise ValueError(kind)
    return OptState(kind=kind, inner=inner, step=torch.zeros((), dtype=torch.int32))


def _global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([g.to(torch.float32) for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def apply_optimizer(state: OptState, params, grads, lr: torch.Tensor, *,
                    weight_decay: float = 0.0, grad_clip: float = 0.0, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8) -> tuple[Any, OptState, dict]:
    """One update: global-norm clipping, then AdamW (decoupled decay, bias
    corrections 1 - b^t in f32) or Adafactor (decay 1 - t^-0.8, the RMS
    clip of the update).  ``lr`` is a 0-dim f32 tensor on the host.
    Returns (new params, new state, {"grad_norm": the norm before
    clipping})."""
    flat_p, flat_g = leaves(params), [g.to(torch.float32) for g in leaves(grads)]
    gnorm = _global_norm(flat_g)
    if grad_clip > 0:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        flat_g = torch._foreach_mul(flat_g, scale)
    step = state.step + 1
    sf = step.to(torch.float32)
    lr_f = float(lr)
    p32 = [p.to(torch.float32) for p in flat_p]

    if state.kind == "adamw":
        bc1, bc2 = float(1 - b1 ** sf), float(1 - b2 ** sf)
        mu = torch._foreach_mul(leaves(state.inner["mu"]), b1)
        torch._foreach_add_(mu, torch._foreach_mul(flat_g, 1 - b1))
        g2 = torch._foreach_mul(flat_g, 1 - b2)
        torch._foreach_mul_(g2, flat_g)
        nu = torch._foreach_mul(leaves(state.inner["nu"]), b2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        new_p = _decayed_step(p32, u, lr_f, weight_decay)
        new_state = OptState("adamw", {"mu": unflatten(state.inner["mu"], mu),
                                       "nu": unflatten(state.inner["nu"], nu)}, step)
        return (unflatten(params, [q.to(p.dtype) for q, p in zip(new_p, flat_p)]), new_state,
                {"grad_norm": gnorm})

    decay = float(1.0 - sf ** -0.8)  # \hat{beta}_2t
    flat_s = _state_leaves(state.inner, params)
    us, new_s = [], []
    for g, st in zip(flat_g, flat_s):
        g2 = g * g + EPS1
        if "vr" in st:
            vr = decay * st["vr"] + (1 - decay) * g2.mean(-1)
            vc = decay * st["vc"] + (1 - decay) * g2.mean(-2)
            denom = torch.clamp(vr.mean(-1, keepdim=True), min=EPS1)
            v_hat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            u = g * torch.rsqrt(v_hat + EPS1)
            new_s.append({"vr": vr, "vc": vc})
        else:
            v = decay * st["v"] + (1 - decay) * g2
            u = g * torch.rsqrt(v + EPS1)
            new_s.append({"v": v})
        rms = torch.sqrt(torch.mean(u * u) + EPS1)  # RMS-clip the update (Adafactor d=1)
        us.append(u / torch.clamp(rms, min=1.0))
    new_p = _decayed_step(p32, us, lr_f, weight_decay)
    new_state = OptState("adafactor", unflatten(params, new_s), step)
    return (unflatten(params, [q.to(p.dtype) for q, p in zip(new_p, flat_p)]), new_state,
            {"grad_norm": gnorm})


def _decayed_step(p32, u, lr: float, weight_decay: float):
    """p - lr (u + wd p), on f32 copies of the params."""
    if weight_decay:
        u = torch._foreach_add(u, torch._foreach_mul(p32, weight_decay))
    return torch._foreach_sub(p32, torch._foreach_mul(u, lr))


def _state_leaves(inner, params) -> list[dict]:
    """Adafactor's per-param state dicts, in the params' flatten order."""
    out = []

    def walk(s, p):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(s[k], p[k])
        elif isinstance(p, (list, tuple)):
            for a, b in zip(s, p):
                walk(a, b)
        elif p is not None:
            out.append(s)

    walk(inner, params)
    return out
