"""Tensor-Train spec of a linear layer (paper §II), plain Python.

A linear ``y = W x`` with ``W ∈ R^{M×N}``, ``M = Π m_k``, ``N = Π n_k`` keeps
its cores in matrix layout ``C_k ∈ R^{(r_{k-1}·n_k) × (m_k·r_k)}`` (rows
r-major, cols m-major), the shape the staged contraction (paper Eq. 4) and
the kernels consume.  Only the spec and the factorization helper live here;
TT-SVD belongs to the compression slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class TTSpec:
    """``in_modes`` (n_1..n_d), ``out_modes`` (m_1..m_d), ``ranks``
    (r_0..r_d) with r_0 = r_d = 1."""

    in_modes: tuple[int, ...]
    out_modes: tuple[int, ...]
    ranks: tuple[int, ...]

    def __post_init__(self):
        if len(self.in_modes) != len(self.out_modes):
            raise ValueError("in_modes and out_modes must have equal length")
        if len(self.ranks) != len(self.in_modes) + 1:
            raise ValueError("ranks must have length d+1")
        if self.ranks[0] != 1 or self.ranks[-1] != 1:
            raise ValueError("boundary ranks must be 1")

    @property
    def d(self) -> int:
        return len(self.in_modes)

    @property
    def n_in(self) -> int:
        return math.prod(self.in_modes)

    @property
    def n_out(self) -> int:
        return math.prod(self.out_modes)

    def core_matrix_shapes(self) -> list[tuple[int, int]]:
        return [
            (self.ranks[k] * self.in_modes[k], self.out_modes[k] * self.ranks[k + 1])
            for k in range(self.d)
        ]

    def n_params(self) -> int:
        return sum(r * c for r, c in self.core_matrix_shapes())

    def flops_per_token(self) -> int:
        """2·MAC count of the staged contraction for one input vector."""
        total = 0
        m_prod = 1
        for k in range(self.d):
            t_dim = math.prod(self.in_modes[k + 1:]) * m_prod
            total += 2 * t_dim * self.ranks[k] * self.in_modes[k] \
                * self.out_modes[k] * self.ranks[k + 1]
            m_prod *= self.out_modes[k]
        return total

    def max_intermediate(self) -> int:
        """Largest per-token intermediate element count across stages."""
        best = self.n_in
        m_prod = 1
        for k in range(self.d):
            m_prod *= self.out_modes[k]
            sz = math.prod(self.in_modes[k + 1:]) * m_prod * self.ranks[k + 1]
            best = max(best, sz)
        return best

    @staticmethod
    def make(n_in: int, n_out: int, rank: int | Sequence[int], d: int = 4,
             in_modes: Sequence[int] | None = None,
             out_modes: Sequence[int] | None = None) -> "TTSpec":
        """Build a spec, auto-factorizing dims unless modes are given."""
        in_modes = tuple(in_modes) if in_modes is not None else factorize(n_in, d)
        out_modes = tuple(out_modes) if out_modes is not None else factorize(n_out, d)
        d = len(in_modes)
        if isinstance(rank, int):
            ranks = [1] + [rank] * (d - 1) + [1]
        else:
            ranks = list(rank)
            if len(ranks) == d - 1:
                ranks = [1] + ranks + [1]
        v = [m * n for m, n in zip(out_modes, in_modes)]
        for k in range(1, d):
            ranks[k] = min(ranks[k], math.prod(v[:k]), math.prod(v[k:]))
        return TTSpec(tuple(in_modes), tuple(out_modes), tuple(ranks))


def _prime_factors(n: int) -> list[int]:
    out = []
    f = 2
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1
    if n > 1:
        out.append(n)
    return out


def factorize(n: int, d: int) -> tuple[int, ...]:
    """Split ``n`` into ``d`` factors, as balanced as possible: the largest
    remaining prime goes into the currently smallest bucket (first one on a
    tie); returns factors sorted descending."""
    if n <= 0:
        raise ValueError("n must be positive")
    buckets = [1] * d
    for p in sorted(_prime_factors(n), reverse=True):
        buckets[buckets.index(min(buckets))] *= p
    return tuple(sorted(buckets, reverse=True))
