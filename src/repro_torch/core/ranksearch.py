"""Automatic rank / factorization search for TT compression (counterpart of
``repro.core.ranksearch``).

The paper fixes d=4, rank=16 by hand (Table I).  For arbitrary (M, N) this
module searches (d, factorization, rank) either analytically (target CR, no
weight needed) or empirically (relative Frobenius error budget on a given
weight), in the spirit of RankSearch [16].
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .ttd import TTSpec, factorize, tt_reconstruct, tt_svd

__all__ = ["RankChoice", "search_spec", "spec_for_layer", "tt_error"]


@dataclass(frozen=True)
class RankChoice:
    spec: TTSpec
    cr: float
    rel_error: float | None = None


def tt_error(w: torch.Tensor, spec: TTSpec, method: str = "auto") -> float:
    """Relative Frobenius reconstruction error of TT-SVD at this spec."""
    w_hat = tt_reconstruct(tt_svd(w, spec, method=method), spec)
    denom = float(torch.linalg.norm(w)) or 1.0
    return float(torch.linalg.norm(w - w_hat.to(w.dtype))) / denom


def search_spec(
    n_in: int,
    n_out: int,
    *,
    target_cr: float | None = None,
    max_error: float | None = None,
    weight: torch.Tensor | None = None,
    ds: tuple[int, ...] = (3, 4, 5),
    ranks: tuple[int, ...] = (4, 8, 16, 32, 64),
) -> RankChoice:
    """Pick (d, balanced factorization, uniform rank).

    - ``target_cr`` given: return the highest-rank spec whose CR >= target
      (ties broken by lower error when a weight is supplied).
    - ``max_error`` given (requires ``weight``): return the highest-CR spec
      with rel_error <= max_error.
    - neither: return the max-CR spec at the paper's defaults (d=4, r=16 when
      attainable).
    """
    candidates: list[RankChoice] = []
    for d in ds:
        in_m = factorize(n_in, d)
        out_m = factorize(n_out, d)
        if 1 in in_m or 1 in out_m:  # degenerate factorization, skip
            continue
        for r in ranks:
            spec = TTSpec.make(n_in, n_out, r, d=d, in_modes=in_m, out_modes=out_m)
            cr = spec.compression_ratio()
            if cr <= 1.0:
                continue
            err = tt_error(weight, spec) if weight is not None else None
            candidates.append(RankChoice(spec, cr, err))
    if not candidates:
        raise ValueError(f"no valid TT spec for ({n_out}x{n_in})")

    if max_error is not None:
        ok = [c for c in candidates if c.rel_error is not None and c.rel_error <= max_error]
        return max(ok or candidates, key=lambda c: c.cr)
    if target_cr is not None:
        ok = [c for c in candidates if c.cr >= target_cr]
        # most expressive (lowest CR above target = highest rank budget);
        # equal-CR candidates are distinguished by reconstruction error when
        # a weight was supplied (unmeasured candidates sort last)
        return min(ok or candidates, key=lambda c: (
            c.cr, c.rel_error if c.rel_error is not None else float("inf")))
    for c in candidates:  # paper default: d=4, r=16 if attainable
        if c.spec.d == 4 and max(c.spec.ranks) == 16:
            return c
    return max(candidates, key=lambda c: c.cr)


def spec_for_layer(n_in: int, n_out: int, rank: int = 16, d: int = 4, in_modes=None,
                   out_modes=None) -> TTSpec:
    """Paper-style spec: explicit modes when given (Table I), else balanced."""
    return TTSpec.make(n_in, n_out, rank, d=d, in_modes=in_modes, out_modes=out_modes)
