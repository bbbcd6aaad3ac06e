"""repro_torch kernels' plain versions vs repro's ``kernels/ref.py`` oracles.

Inputs come from seeded numpy generators and go through both packages on
the CPU (where every repro_torch wrapper runs its plain version).  Tolerance:
rtol = atol = 2e-4 in f32, the JAX suite's own ref-vs-kernel tolerance.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.ttd import TTSpec as JTTSpec
from repro.core.ttd import factorize as jfactorize
from repro.kernels import ref as jref
from repro_torch.core import quant as tquant
from repro_torch.core.ttd import TTSpec, factorize
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-4, atol=2e-4)
EPILOGUES = ["none", "bias", "bn", "res", "bn+res", "silu", "gelu+res"]


def _epi(rng, epi, lead, m):
    scale = rng.standard_normal(m).astype(np.float32) if "bn" in epi else None
    bias = rng.standard_normal(m).astype(np.float32) if epi in ("bias", "bn", "bn+res") else None
    res = rng.standard_normal(lead + (m,)).astype(np.float32) if "res" in epi else None
    act = {"silu": "silu", "gelu+res": "gelu"}.get(epi)
    return dict(scale=scale, bias=bias, residual=res), act


def _both(kw):
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in kw.items()}
    t = {k: (None if v is None else torch.from_numpy(v)) for k, v in kw.items()}
    return j, t


@pytest.mark.parametrize("lead", [(9,), (2, 7)], ids=["BN", "BSN"])
@pytest.mark.parametrize("epi", EPILOGUES)
def test_tt_linear_bn_res_matches_ref(epi, lead):
    rng = np.random.default_rng(1)
    spec = TTSpec.make(256, 344, 8, d=4, in_modes=(4, 8, 2, 4), out_modes=(2, 4, 43, 1))
    jspec = JTTSpec(spec.in_modes, spec.out_modes, spec.ranks)
    cores = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in spec.core_matrix_shapes()]
    x = rng.standard_normal(lead + (spec.n_in,)).astype(np.float32)
    kw, act = _epi(rng, epi, lead, spec.n_out)
    jkw, tkw = _both(kw)
    want = jax.jit(partial(jref.tt_linear_bn_res, spec=jspec, activation=act))(
        jnp.asarray(x), [jnp.asarray(c) for c in cores], **jkw)
    got = tref.tt_linear_bn_res(torch.from_numpy(x), [torch.from_numpy(c) for c in cores],
                                spec, activation=act, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    via = dispatch.tt_linear(torch.from_numpy(x), [torch.from_numpy(c) for c in cores], spec,
                             activation=act, **tkw)
    assert torch.equal(via, got)


@pytest.mark.parametrize("epi", ["none", "bias", "bn+res", "gelu+res"])
def test_int4_matmul_matches_ref(epi):
    rng = np.random.default_rng(2)
    m, k, g, lead = 96, 256, 64, (3, 5)
    w = rng.standard_normal((m, k)).astype(np.float32)
    qp = jax.jit(partial(jquant.quantize_int4, group_size=g))(w)
    qw, sc = np.asarray(qp["qweight"]), np.asarray(qp["scales"])
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    kw, act = _epi(rng, epi, lead, m)
    jkw, tkw = _both(kw)
    want = jax.jit(partial(jref.int4_matmul, group=g, activation=act))(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(sc), **jkw)
    tsc = torch.from_numpy(sc.view(np.uint16).copy()).view(torch.bfloat16)
    got = tref.int4_matmul(torch.from_numpy(x), torch.from_numpy(qw.copy()), tsc, g,
                           activation=act, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quant_pack_roundtrip_matches_ref():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((24, 128)).astype(np.float32)
    jq = jax.jit(partial(jquant.quantize_int4, group_size=32))(w)
    tq = tquant.quantize_int4(torch.from_numpy(w), 32)
    np.testing.assert_array_equal(tq["qweight"].numpy(), np.asarray(jq["qweight"]))
    np.testing.assert_array_equal(tq["scales"].view(torch.uint16).numpy(),
                                  np.asarray(jq["scales"]).view(np.uint16))
    q = rng.integers(-8, 8, (5, 64)).astype(np.int8)
    packed = tquant.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax.jit(jquant.pack_int4)(q)))
    np.testing.assert_array_equal(tquant.unpack_int4(packed).numpy(), q)
    dq = tquant.dequantize_int4(tq, dtype=torch.float32).numpy()
    np.testing.assert_array_equal(dq, np.asarray(jax.jit(partial(jquant.dequantize_int4, dtype=jnp.float32))(jq)))
    for n, d in ((13696, 4), (11008, 4), (4096, 4), (64, 3), (97, 2)):
        assert factorize(n, d) == jfactorize(n, d)


def _pool(rng, nb, bs, hkv, dh, int8):
    k = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
    if not int8:
        return {"k": k, "v": v}
    out = {}
    for nm, x in (("k", k), ("v", v)):
        sc = np.maximum(np.abs(x).max(-1), 1e-8) / 127.0
        out[nm] = np.round(x / sc[..., None]).astype(np.int8)
        out[nm + "_scale"] = sc.astype(np.float32)
    return out


@pytest.mark.parametrize("sq,h,hkv,window,int8", [
    (1, 4, 4, 0, False),
    (1, 8, 2, 0, True),
    (6, 4, 2, 0, False),
    (6, 8, 1, 3, False),
    (6, 4, 2, 5, True),
], ids=["decode-mha", "decode-gqa-int8", "prefill-gqa", "prefill-mqa-window",
        "prefill-int8-window"])
def test_paged_attention_matches_ref(sq, h, hkv, window, int8):
    rng = np.random.default_rng(4)
    b, dh, bs, w, nb = 3, 16, 4, 5, 18
    pool = _pool(rng, nb, bs, hkv, dh, int8)
    bt = rng.permutation(np.arange(1, nb))[:b * w].reshape(b, w).astype(np.int32)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    start = np.array([0, 7, 12])
    qpos = (start[:, None] + np.arange(sq)[None]).astype(np.int32)
    qpos[1, -2:] = -1  # padding rows
    qpos[2, 0] = -1
    jcache = {k: jnp.asarray(v) for k, v in pool.items()}
    tcache = {k: torch.from_numpy(v) for k, v in pool.items()}
    want = jax.jit(partial(jref.paged_attention, window=window))(
        jnp.asarray(q), jcache, jnp.asarray(bt), jnp.asarray(qpos))
    got = tref.paged_attention(torch.from_numpy(q), tcache, torch.from_numpy(bt),
                               torch.from_numpy(qpos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.any(got.numpy()[qpos < 0])  # padding rows are zero
    if sq == 1:
        via = dispatch.paged_attention(torch.from_numpy(q[:, 0]), tcache,
                                       torch.from_numpy(bt), torch.from_numpy(qpos[:, 0]))
        np.testing.assert_allclose(via.numpy(), np.asarray(want)[:, 0], **TOL)
    else:
        via = dispatch.prefill_attention(torch.from_numpy(q), torch.from_numpy(qpos),
                                         cache=tcache, block_tables=torch.from_numpy(bt),
                                         window=window)
        np.testing.assert_allclose(via.numpy(), np.asarray(want), **TOL)
