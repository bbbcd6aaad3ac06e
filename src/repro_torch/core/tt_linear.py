"""TT-compressed linear layer: the staged contraction of paper Eq. 4.

Stage k multiplies the (T_k, r_{k-1}·n_k) view of each token's intermediate
by core ``C_k`` and reorders the result for the next stage (the paper's
ping-pong buffers).  ``_tt_apply`` is the plain version every backend is held
to; the CUDA kernel in ``kernels/tt_linear.py`` folds the reorder into its
store index instead.
"""
from __future__ import annotations

import math

import torch

from .ttd import TTSpec, cores_to_matrices, tt_svd


def tt_stage_shapes(spec: TTSpec, batch: int) -> list[tuple[int, int, int]]:
    """(rows, contract, cols) of each stage's matmul for a given token count."""
    shapes = []
    m_prod = 1
    for k in range(spec.d):
        t_dim = math.prod(spec.in_modes[k + 1:]) * m_prod
        shapes.append((batch * t_dim, spec.ranks[k] * spec.in_modes[k],
                       spec.out_modes[k] * spec.ranks[k + 1]))
        m_prod *= spec.out_modes[k]
    return shapes


def _tt_apply(cores, p: torch.Tensor, spec: TTSpec) -> torch.Tensor:
    """(*L, N) -> (*L, M).  Inter-stage tensors are stored in the input dtype
    (f32 for f64 input); every product runs in f32 on upcast operands."""
    lead = p.shape[:-1]
    nl = len(lead)
    n, m, d = spec.in_modes, spec.out_modes, spec.d
    store = p.dtype if p.dtype != torch.float64 else torch.float32

    p = p.reshape(*lead, n[0], math.prod(n[1:])).transpose(nl, nl + 1)
    m_prod = 1
    for k in range(d):
        c_k = cores[k].to(store).to(torch.float32)
        p = torch.matmul(p.to(store).to(torch.float32), c_k).to(store)
        if k < d - 1:
            # (*L, n_{k+1}, NR, MP, m_k, r_k) -> (*L, NR, MP*m_k, r_k, n_{k+1})
            nr = math.prod(n[k + 2:])
            p = p.reshape(*lead, n[k + 1], nr, m_prod, m[k], spec.ranks[k + 1])
            perm = tuple(range(nl)) + (nl + 1, nl + 2, nl + 3, nl + 4, nl)
            p = p.permute(perm)
            m_prod *= m[k]
            p = p.reshape(*lead, nr * m_prod, spec.ranks[k + 1] * n[k + 1])
    return p.reshape(*lead, spec.n_out)


def tt_linear_apply(params, x: torch.Tensor, spec: TTSpec) -> torch.Tensor:
    """Apply the TT linear to ``x`` of shape (..., N) -> (..., M)."""
    if x.ndim == 1:
        return _tt_apply(params["cores"], x[None], spec)[0].to(x.dtype)
    return _tt_apply(params["cores"], x, spec).to(x.dtype)


def init_tt_linear(spec: TTSpec, *, generator: torch.Generator, device,
                   dtype=torch.float32, scale: float | None = None):
    """Random cores whose implied dense weight has fan-in variance:
    σ_k = (σ_W² / Π r_interior)^(1/2d) with σ_W² = scale²/N."""
    scale = 1.0 if scale is None else scale
    var_w = scale ** 2 / spec.n_in
    r_interior = math.prod(spec.ranks[1:-1]) or 1
    sigma_k = (var_w / r_interior) ** (1.0 / (2 * spec.d))
    cores = [(torch.randn(shp, generator=generator, device=device,
                          dtype=torch.float32) * sigma_k).to(dtype)
             for shp in spec.core_matrix_shapes()]
    return {"cores": cores}


def tt_linear_from_dense(w: torch.Tensor, spec: TTSpec, dtype=torch.float32,
                         method: str = "auto"):
    """TT-SVD a dense (M, N) weight into matrix-layout cores (paper Alg. 1),
    on the weight's device."""
    mats = cores_to_matrices(tt_svd(w, spec, method=method), spec)
    return {"cores": [c.to(dtype) for c in mats]}
