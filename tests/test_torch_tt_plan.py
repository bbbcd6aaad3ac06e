"""The arithmetic of the port's redesigned kernels, on the CPU.

The fused ``tt_linear`` kernel contracts x with two halves of the TT, each
half's cores first contracted into one operator; the ring decode kernel
splits the ring across CTAs and combines their partial softmaxes.  Neither
kernel runs here, so these tests hold plain versions of the same arithmetic,
in the kernels' layouts and orders, against ``repro``'s oracles
(``ref.tt_linear_bn_res`` and the ``pallas-interpret`` kernel,
``ref.ring_attention``) and the port's plain versions, on inputs from seeded
numpy generators, at rtol = atol = 2e-4 in f32 (the JAX suite's own
ref-vs-kernel tolerance).  ``contraction_plan`` and ``tt_order_flops`` are
checked on the serve specs.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ttd import TTSpec as JTTSpec
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro_torch.core.ttd import TTSpec
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.prefill_attention import decode_splits, ring_attention_ref
from repro_torch.kernels.tt_linear import contraction_plan, tt_order_flops

TOL = dict(rtol=2e-4, atol=2e-4)


def _operators(cores, spec: TTSpec, h: int):
    """The operator pass's output: OPL (r_h, ML, NL) from cores 1..h and OPR
    (r_h, MR, NR) from cores h+1..d, digits most significant first (an empty
    right half is the identity)."""
    n, m, r = spec.in_modes, spec.out_modes, spec.ranks
    g = [c.reshape(r[k], n[k], m[k], r[k + 1]) for k, c in enumerate(cores)]
    left = torch.ones(1, 1, 1)  # (ML, NL, a)
    for k in range(h):
        left = torch.einsum("JIa,aijb->JjIib", left, g[k]).reshape(
            left.shape[0] * m[k], left.shape[1] * n[k], r[k + 1])
    right = torch.ones(1, 1, 1)  # (NR, MR, b)
    for k in range(spec.d - 1, h - 1, -1):
        right = torch.einsum("aijb,IJb->iIjJa", g[k], right).reshape(
            n[k] * right.shape[0], m[k] * right.shape[1], r[k])
    return left.permute(2, 0, 1), right.permute(2, 1, 0)


def two_half_tt(x, cores, spec: TTSpec, h: int, left_first: bool):
    """y = sum_rho A_rho X B_rho in the fused kernel's order: X is a token's
    (NL, NR) view of x, and the half that meets X first is contracted
    first."""
    opl, opr = _operators(cores, spec, h)
    xv = x.reshape(x.shape[0], opl.shape[2], opr.shape[2])
    if left_first:
        z = torch.einsum("pji,bik->bpjk", opl, xv)   # Z_rho = A_rho X
        y = torch.einsum("bpjk,pmk->bjm", z, opr)    # Y += Z_rho B_rho
    else:
        u = torch.einsum("pmk,bik->bpmi", opr, xv)   # U_rho = X B_rho
        y = torch.einsum("pji,bpmi->bjm", opl, u)    # Y += A_rho U_rho
    return y.reshape(x.shape[0], spec.n_out)


@pytest.mark.parametrize("modes,rank", [
    (((8, 8, 8, 5), (12, 10, 8, 8)), 3),   # recurrentgemma-2b gate/up
    (((12, 10, 8, 8), (8, 8, 8, 5)), 3),   # recurrentgemma-2b down
    (((4, 3, 2), (2, 5, 7)), 4),
    (((24,), (10,)), 1),                   # d = 1: the right half is empty
])
def test_two_half_order_matches_ref_and_interpret(modes, rank):
    """Every split h, either half first, with the fused epilogue, against
    ``ref.tt_linear_bn_res`` and the ``pallas-interpret`` kernel."""
    rng = np.random.default_rng(sum(modes[0]) + rank)
    spec = TTSpec.make(0, 0, rank, d=len(modes[0]), in_modes=modes[0], out_modes=modes[1])
    jspec = JTTSpec(spec.in_modes, spec.out_modes, spec.ranks)
    cores = [rng.standard_normal(s).astype(np.float32) / math.sqrt(s[0])
             for s in spec.core_matrix_shapes()]
    x = rng.standard_normal((3, spec.n_in)).astype(np.float32)
    bias = rng.standard_normal(spec.n_out).astype(np.float32)
    res = rng.standard_normal((3, spec.n_out)).astype(np.float32)
    jc = [jnp.asarray(c) for c in cores]
    want = np.asarray(jax.jit(partial(jref.tt_linear_bn_res, spec=jspec, activation="silu"))(
        jnp.asarray(x), jc, bias=jnp.asarray(bias), residual=jnp.asarray(res)))
    interp = np.asarray(jdispatch.tt_linear(
        jnp.asarray(x), jc, jspec, bias=jnp.asarray(bias), residual=jnp.asarray(res),
        activation="silu", backend="pallas-interpret"))
    tc = [torch.from_numpy(c) for c in cores]
    for h in (range(1, spec.d) if spec.d > 1 else (1,)):
        for left_first in (True, False):
            y = two_half_tt(torch.from_numpy(x), tc, spec, h, left_first)
            got = apply_epilogue(y, bias=torch.from_numpy(bias), residual=torch.from_numpy(res),
                                 activation="silu").numpy()
            np.testing.assert_allclose(got, want, **TOL, err_msg=f"h={h} left={left_first}")
            np.testing.assert_allclose(got, interp, **TOL, err_msg=f"h={h} left={left_first}")


# (in modes, out modes) -> (h, left first, MFLOP a token) at rank 16
SERVE_PLANS = {
    ((8, 8, 8, 5), (12, 10, 8, 8)): (2, True, 19.6608),       # griffin gate/up
    ((12, 10, 8, 8), (8, 8, 8, 5)): (2, False, 19.6608),      # griffin down
    ((8, 8, 8, 5), (8, 8, 8, 5)): (2, True, 8.51968),         # griffin attn_o
    ((8, 8, 8, 8), (8, 8, 8, 8)): (2, True, 16.777216),       # rwkv tm_out
    ((8, 8, 8, 8), (16, 14, 8, 8)): (2, False, 37.748736),    # rwkv cm_key
    ((16, 14, 8, 8), (8, 8, 8, 8)): (2, True, 37.748736),     # rwkv cm_value
    ((16, 8, 8, 4), (4, 8, 8, 16)): (2, True, 8.388608),      # llama2 attn_o
    ((16, 8, 8, 4), (4, 4, 16, 43)): (2, True, 13.369344),    # llama2 gate/up
}


@pytest.mark.parametrize("modes", list(SERVE_PLANS), ids=lambda m: f"{m[0]}->{m[1]}")
def test_contraction_plan_on_serve_specs(modes):
    """The plan is the cheapest split; the bound is the cheapest order, which
    at llama2 gate/up is the staged one (8.22 MFLOP against 13.37)."""
    spec = TTSpec.make(0, 0, 16, in_modes=modes[0], out_modes=modes[1])
    h, left, mflop = SERVE_PLANS[modes]
    plan = contraction_plan(spec)
    assert (plan.h, plan.left_first) == (h, left)
    assert plan.flops == pytest.approx(mflop * 1e6)
    orders = tt_order_flops(spec)
    assert orders["staged left to right"] == spec.flops_per_token()
    assert orders[f"h={h} {'left' if left else 'right'} first"] == plan.flops
    assert min(orders.values()) == min(plan.flops, spec.flops_per_token(),
                                      orders["staged right to left"])
    rev = TTSpec(spec.out_modes, spec.in_modes, spec.ranks)  # the transposed layer
    assert contraction_plan(rev).flops == plan.flops


def split_combine_decode(q, k, v, qpos, kpos, window, k_scale, v_scale, splits, tile=64):
    """Ring decode (Sq = 1) as the kernel computes it: the ring's entries in
    ``splits`` ranges of a multiple of ``tile`` entries, each range's masked
    softmax kept as (m, l, unnormalized o) with m = -1e30, l = 0, o = 0 where
    nothing is visible, then the ranges rescaled to the largest m and
    summed."""
    b, _, h, dh = q.shape
    wr, hkv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale[..., None], vf * v_scale[..., None]
    qh = q[:, 0].float().reshape(b, hkv, h // hkv, dh) / math.sqrt(dh)
    vis = (kpos >= 0) & (kpos <= qpos) & (qpos >= 0)
    if window:
        vis &= qpos - kpos < window
    kps = -(-(-(-wr // splits)) // tile) * tile
    parts = []
    for s in range(splits):
        sl = slice(s * kps, min(wr, (s + 1) * kps))
        sc = torch.einsum("bhgd,bkhd->bhgk", qh, kf[:, sl])
        mask = vis[:, None, None, sl]
        sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
        m = sc.amax(-1, keepdim=True) if sc.shape[-1] else torch.full(
            sc.shape[:-1] + (1,), -1e30)
        p = torch.exp(sc - m) * mask
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum("bhgk,bkhd->bhgd", p,
                                                               vf[:, sl])))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - mx) for m, _, _ in parts]
    big_l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    big_o = sum(wi * oi for wi, (_, _, oi) in zip(w, parts))
    out = torch.where(big_l > 0, big_o / big_l.clamp(min=1e-30), torch.zeros_like(big_o))
    out = torch.where(qpos[:, :, None, None] >= 0, out, torch.zeros_like(out))
    return out.reshape(b, 1, h, dh)


@pytest.mark.parametrize("wr,fill,window,g,int8", [
    (300, (700, 40, 0, 300), 0, 10, False),   # wrapped; 40 entries (splits past it empty);
                                              # empty ring with a live query; full ring
    (300, (700, 250, 520, 12), 128, 4, False),  # window: whole splits masked
    (160, (500, 5, 90, 0), 48, 1, True),        # int8, window, idle slot
])
def test_split_combine_decode_matches_ref(wr, fill, window, g, int8):
    rng = np.random.default_rng(wr + window + g)
    b, hkv, dh = len(fill), 2, 16
    k = rng.standard_normal((b, wr, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, wr, hkv, dh)).astype(np.float32)
    kpos = np.full((b, wr), -1, np.int32)
    for i, n in enumerate(fill):
        p = np.arange(max(0, n - wr), n)
        kpos[i, p % wr] = p
    qpos = np.array([[max(n - 1, 0)] for n in fill], np.int32)  # fill 0: a query at 0, no key
    if int8:
        qpos[-1] = -1  # an idle slot
    q = rng.standard_normal((b, 1, hkv * g, dh)).astype(np.float32)
    ks = vs = None
    if int8:
        ks = np.maximum(np.abs(k).max(-1), 1e-8).astype(np.float32) / np.float32(127.0)
        vs = np.maximum(np.abs(v).max(-1), 1e-8).astype(np.float32) / np.float32(127.0)
        k = np.round(k / ks[..., None]).astype(np.int8)
        v = np.round(v / vs[..., None]).astype(np.int8)
    t = {n: (None if a is None else torch.from_numpy(a))
         for n, a in dict(q=q, k=k, v=v, kpos=kpos, qpos=qpos, ks=ks, vs=vs).items()}
    want = ring_attention_ref(t["q"], t["qpos"], k=t["k"], v=t["v"], kpos=t["kpos"],
                              window=window, k_scale=t["ks"], v_scale=t["vs"])
    jwant = np.asarray(jref.ring_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos), jnp.asarray(kpos),
        window=window, k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    for splits, tile in ((decode_splits(b, wr, hkv), 64), (7, 32), (3, 64)):
        got = split_combine_decode(t["q"], t["k"], t["v"], t["qpos"], t["kpos"], window,
                                   t["ks"], t["vs"], splits, tile)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL, err_msg=f"{splits} splits")
        np.testing.assert_allclose(got.numpy(), jwant, **TOL, err_msg=f"{splits} splits")
        assert torch.isfinite(got).all()
        for i, n in enumerate(fill):  # no visible key (an empty ring) or an idle slot: zeros
            if n == 0 or qpos[i, 0] < 0:
                assert not got[i].any()
