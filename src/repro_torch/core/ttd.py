"""Tensor-Train decomposition of linear-layer weights (paper §II, Algorithm 1).

A linear ``y = W x`` with ``W ∈ R^{M×N}``, ``M = Π m_k``, ``N = Π n_k`` is
*tensorized* into a d-mode tensor with mode sizes ``v_k = m_k · n_k``
(m-major within each mode, ``μ_k = i_k·n_k + j_k``).  TT-SVD (Oseledets 2011;
paper Algorithm 1) factorizes it into cores ``G_k ∈ R^{r_{k-1} × v_k × r_k}``,
``r_0 = r_d = 1``.  For inference each core is kept in matrix layout
``C_k ∈ R^{(r_{k-1}·n_k) × (m_k·r_k)}`` (rows r-major, cols m-major), the
shape the staged contraction (paper Eq. 4) and the kernels consume.

Compression ratio (paper Eq. 2): ``CR = Π v_k / Σ v_k·r_{k-1}·r_k``.

The decomposition runs on tensors, on their device (float64 by default),
built on ``torch.linalg.svd`` / ``torch.linalg.eigh``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch


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

    @property
    def mode_sizes(self) -> tuple[int, ...]:
        return tuple(m * n for m, n in zip(self.out_modes, self.in_modes))

    def core_matrix_shapes(self) -> list[tuple[int, int]]:
        return [
            (self.ranks[k] * self.in_modes[k], self.out_modes[k] * self.ranks[k + 1])
            for k in range(self.d)
        ]

    def n_params(self) -> int:
        return sum(r * c for r, c in self.core_matrix_shapes())

    def compression_ratio(self) -> float:
        return (self.n_in * self.n_out) / self.n_params()

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


# ---------------------------------------------------------------------------
# Tensorization (paper §II.B)
# ---------------------------------------------------------------------------
def tensorize_weight(w: torch.Tensor, spec: TTSpec) -> torch.Tensor:
    """(M, N) weight -> (v_1, …, v_d) tensor with μ_k = i_k·n_k + j_k."""
    d = spec.d
    if tuple(w.shape) != (spec.n_out, spec.n_in):
        raise ValueError(f"weight shape {tuple(w.shape)} != ({spec.n_out},{spec.n_in})")
    t = w.reshape(*spec.out_modes, *spec.in_modes)
    perm = [x for k in range(d) for x in (k, d + k)]  # interleave (m_k, n_k)
    return t.permute(perm).reshape(spec.mode_sizes)


def untensorize_weight(t: torch.Tensor, spec: TTSpec) -> torch.Tensor:
    """Inverse of :func:`tensorize_weight`."""
    m, n, d = spec.out_modes, spec.in_modes, spec.d
    t = t.reshape([x for k in range(d) for x in (m[k], n[k])])
    perm = [2 * k for k in range(d)] + [2 * k + 1 for k in range(d)]
    return t.permute(perm).reshape(spec.n_out, spec.n_in)


# ---------------------------------------------------------------------------
# TT-SVD (paper Algorithm 1, lines 7-18)
# ---------------------------------------------------------------------------
def _truncated_left_factor(c: torch.Tensor, rank: int, method: str):
    """Return (U_r, rest) with c ≈ U_r @ rest, U_r orthonormal columns.

    method 'svd'  : exact thin SVD (reference path).
    method 'gram' : eigendecomposition of c @ c.T — O(rows²·cols), exact for
                    the retained subspace, much faster when rows ≪ cols.
    method 'auto' : 'gram' when cols > 4·rows and rows > 64, else 'svd'.
    """
    rows, cols = c.shape
    r = min(rank, rows, cols)
    if method == "auto":
        method = "gram" if cols > 4 * rows and rows > 64 else "svd"
    if method == "svd":
        u, s, vt = torch.linalg.svd(c, full_matrices=False)
        return u[:, :r], s[:r, None] * vt[:r]
    if method == "gram":
        _, v = torch.linalg.eigh(c @ c.T)  # ascending
        u = v[:, rows - r:].flip(1)
        return u, u.T @ c
    raise ValueError(f"unknown method {method}")


def tt_svd(w: torch.Tensor, spec: TTSpec, method: str = "auto",
           dtype=torch.float64) -> list[torch.Tensor]:
    """TT-SVD of a (M, N) weight on its device; returns 3D cores
    G_k (r_{k-1}, v_k, r_k) in ``dtype``."""
    c = tensorize_weight(w.to(dtype), spec)
    v = spec.mode_sizes
    cores: list[torch.Tensor] = []
    r_prev = 1
    c = c.reshape(r_prev * v[0], -1)
    for k in range(spec.d - 1):
        u, rest = _truncated_left_factor(c, spec.ranks[k + 1], method)
        r_k = u.shape[1]
        if r_k != spec.ranks[k + 1]:
            raise ValueError(
                f"attained rank {r_k} < requested {spec.ranks[k + 1]} at core {k}; "
                "clamp ranks via TTSpec.make")
        cores.append(u.reshape(r_prev, v[k], r_k))
        r_prev = r_k
        c = rest.reshape(r_prev * v[k + 1], -1)
    cores.append(c.reshape(r_prev, v[-1], 1))
    return cores


def tt_reconstruct(cores: list[torch.Tensor], spec: TTSpec) -> torch.Tensor:
    """Contract 3D cores back to the dense (M, N) weight (for validation)."""
    t = cores[0]  # (1, v_1, r_1)
    for g in cores[1:]:
        t = torch.tensordot(t, g, dims=([t.ndim - 1], [0]))  # (..., v_k, r_k)
    return untensorize_weight(t.reshape(spec.mode_sizes), spec)


# ---------------------------------------------------------------------------
# Layout conversion: 3D cores <-> matrix cores
# ---------------------------------------------------------------------------
def cores_to_matrices(cores: list[torch.Tensor], spec: TTSpec) -> list[torch.Tensor]:
    """G_k (r_{k-1}, v_k, r_k) -> C_k ((r_{k-1}·n_k), (m_k·r_k)).

    The mode index is m-major (μ = i·n + j), so the 3D core reshapes to
    (r_{k-1}, m_k, n_k, r_k); the matrix layout wants rows (r_{k-1}, n_k)
    and cols (m_k, r_k)."""
    out = []
    for k, g in enumerate(cores):
        r0, _, r1 = g.shape
        m_k, n_k = spec.out_modes[k], spec.in_modes[k]
        c = g.reshape(r0, m_k, n_k, r1).permute(0, 2, 1, 3).reshape(r0 * n_k, m_k * r1)
        out.append(c.contiguous())
    return out


def matrices_to_cores(mats: list[torch.Tensor], spec: TTSpec) -> list[torch.Tensor]:
    """Inverse of :func:`cores_to_matrices`."""
    out = []
    for k, c in enumerate(mats):
        r0, r1 = spec.ranks[k], spec.ranks[k + 1]
        m_k, n_k = spec.out_modes[k], spec.in_modes[k]
        g4 = c.reshape(r0, n_k, m_k, r1).permute(0, 2, 1, 3)
        out.append(g4.reshape(r0, m_k * n_k, r1).contiguous())
    return out


# ---------------------------------------------------------------------------
# Accounting (paper Eq. 2 / Table I)
# ---------------------------------------------------------------------------
def tt_params(spec: TTSpec) -> int:
    return spec.n_params()


def compression_ratio(spec: TTSpec) -> float:
    return spec.compression_ratio()
