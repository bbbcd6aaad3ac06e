"""The grouped tt_linear's redesigned arithmetic and plans, on the CPU.

The grouped kernel (the MoE experts' route) builds each expert's two
operators with a tensor-core pass: each half of the cores as one GEMM of
depth r, group by group, scattered into the operators' layout
(``op_groups``, ``operators_by_groups``); its CTAs find the experts with
rows on the device (``nth_active``); its contraction takes the decode tiles
or the wgmma route by rows an expert (``grouped_plan``).  None of it runs
here, so these tests hold the plain versions of that arithmetic, in the
kernel's order and layout, against the fused kernel's operators
(``test_torch_tt_plan._operators``) and ``repro``'s ``ref.tt_linear_bn_res``
on inputs from seeded numpy generators, at rtol = atol = 2e-4 in f32.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tt_plan import _operators

from repro.core.ttd import TTSpec as JTTSpec
from repro.kernels import ref as jref
from repro_torch.core.ttd import TTSpec
from repro_torch.kernels import tt_linear as tk

TOL = dict(rtol=2e-4, atol=2e-4)

# the four served expert specs: (in modes, out modes), rank 16
SERVED = {
    "mixtral gate": ((12, 8, 8, 8), (16, 16, 8, 8)),
    "mixtral down": ((16, 16, 8, 8), (12, 8, 8, 8)),
    "kimi-k2 gate": ((14, 8, 8, 8), (8, 8, 8, 4)),
    "kimi-k2 down": ((8, 8, 8, 4), (14, 8, 8, 8)),
}


def _check_operator_pass(spec: TTSpec, h: int, seed: int):
    """The group-by-group GEMMs equal the operators, with zeros past NL and
    NR, and through the two-half form (left half first, as the wgmma route
    contracts) give ``ref.tt_linear_bn_res``."""
    rng = np.random.default_rng(seed)
    cores = [rng.standard_normal(s).astype(np.float32) / math.sqrt(s[0])
             for s in spec.core_matrix_shapes()]
    tc = [torch.from_numpy(c) for c in cores]
    opl, opr = tk.operators_by_groups(tc, spec, h)
    want_l, want_r = _operators(tc, spec, h)
    nl, nr = want_l.shape[2], want_r.shape[2]
    np.testing.assert_allclose(opl[:, :, :nl].numpy(), want_l.numpy(), **TOL)
    np.testing.assert_allclose(opr[:, :, :nr].numpy(), want_r.numpy(), **TOL)
    assert not opl[:, :, nl:].any() and not opr[:, :, nr:].any()
    x = rng.standard_normal((2, spec.n_in)).astype(np.float32)
    z = torch.einsum("pji,bik->bpjk", opl[:, :, :nl], torch.from_numpy(x).reshape(2, nl, nr))
    y = torch.einsum("bpjk,pmk->bjm", z, opr[:, :, :nr]).reshape(2, spec.n_out)
    jspec = JTTSpec(spec.in_modes, spec.out_modes, spec.ranks)
    want = np.asarray(jax.jit(partial(jref.tt_linear_bn_res, spec=jspec))(
        jnp.asarray(x), [jnp.asarray(c) for c in cores]))
    np.testing.assert_allclose(y.numpy(), want, **TOL)


def test_operator_pass_as_gemm_on_served_specs():
    """Every served expert spec at its plan's split (h = 2: two cores a
    half, one GEMM of depth 16 each)."""
    for i, modes in enumerate(SERVED.values()):
        spec = TTSpec.make(0, 0, 16, in_modes=modes[0], out_modes=modes[1])
        h = tk.contraction_plan(spec).h
        assert tk.op_groups(spec, h) is not None
        _check_operator_pass(spec, h, i)


def test_operator_pass_with_a_one_core_half():
    """d = 3 at both splits: the one-core half takes the identity as its
    other core (ranks 4 and 3: rows and columns past 16-multiples)."""
    for modes, rank in ((((8, 4, 2), (3, 5, 7)), 4), (((5, 3, 2), (3, 2, 7)), 3)):
        spec = TTSpec.make(0, 0, rank, d=3, in_modes=modes[0], out_modes=modes[1])
        for h in (1, 2):
            _check_operator_pass(spec, h, rank + h)


def test_active_experts_compaction():
    """The slots' scan lists exactly the experts with rows, in order, over
    the routings of test_torch_moe's tile-schedule test, and offsets past R
    clamp as the schedule clamps them."""
    for n_experts in (4, 8, 384, 700):
        rng = np.random.default_rng(n_experts)
        routings = [rng.integers(0, 40, n_experts), rng.integers(0, 3, n_experts) * 17,
                    np.eye(n_experts, dtype=int)[n_experts // 2] * 301,
                    (rng.random(n_experts) < 0.1) * rng.integers(1, 9, n_experts)]
        for counts in routings:
            offsets = np.concatenate([[0], np.cumsum(counts)])
            rows = int(offsets[-1])
            assert tk.active_experts(offsets, rows) == [e for e in range(n_experts)
                                                        if counts[e] > 0]
            cut = rows // 2  # rows past R are not the call's
            want = [e for e in range(n_experts) if min(offsets[e + 1], cut) > offsets[e]
                    and offsets[e] < cut]
            assert tk.active_experts(offsets, cut) == want[:min(n_experts, cut)]


def test_grouped_plan_on_served_specs():
    """At 8 tokens (decode) the decode tiles, at 2048 (prefill) the wgmma
    contraction, whose tiles of rows fit the shared memory; the operator
    pass on the tensor cores at both; the pass's groups an expert."""
    experts = {"mixtral": (8, 2), "kimi-k2": (384, 8)}
    want = {  # wgmma (rows a warpgroup, MR columns a CTA, stages, ML blocks); pass groups
        "mixtral gate": ((4, 64, 4, 4), (32, 4)),
        "mixtral down": ((2, 64, 2, 2), (24, 4)),
        "kimi-k2 gate": ((4, 32, 4, 1), (8, 4)),
        "kimi-k2 down": ((4, 64, 4, 2), (8, 4)),
    }
    for name, modes in SERVED.items():
        spec = TTSpec.make(0, 0, 16, in_modes=modes[0], out_modes=modes[1])
        e, k = experts[name.split()[0]]
        halves = tk.op_groups(spec, tk.contraction_plan(spec).h)
        assert tuple(p.groups for p in halves) == want[name][1], name
        dec = tk.grouped_plan(spec, 8 * k, e)
        assert dec.ops_mma and dec.route == "decode tiles" and dec.iw == 0
        assert dec.slots == -(-8 * k // dec.tb) + e
        pre = tk.grouped_plan(spec, 2048 * k, e)
        iw, bms, stages, mlb = want[name][0]
        assert (pre.route, pre.iw, pre.bms, pre.stages, pre.tb) == ("wgmma", iw, bms, stages,
                                                                     2 * iw), name
        assert pre.smem <= tk.SMEM_MAX and pre.grid[:2] == (-(-2048 * k // pre.tb) + e, mlb)
        assert tk.grouped_plan(spec, tk.GROUPED_WGMMA_MIN_ROWS * e - 1, e).route == \
            "decode tiles"
