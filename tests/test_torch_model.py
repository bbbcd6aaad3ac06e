"""repro_torch paged prefill/decode logits vs repro's, through params_from_jax.

tinyllama-1.1b reduced with int4 (group 32) on and block 0 left out of the
TT range, so TT (attn_o, mlp) and int4 (q/k/v, and every linear of block 0)
kernels' plain versions are both on the path.  One JAX param tree per dtype
is shared by the module.  Tolerances: rtol = atol = 2e-4 in f32 (the JAX
suite's own); in bf16 atol = rtol = 5e-2 and a mean |diff| under 1e-2, on
logits of magnitude up to ~4: the two frameworks round bf16 intermediates at
different places (XLA fuses some casts away), and one bf16 ulp at 4.0 is
3.1e-2 (measured here: max |diff| 0.037, mean 0.006).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QuantConfig, config_to_dict
from repro.configs import get_config
from repro.models import transformer as jtf
from repro_torch.config import config_from_dict
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttf
from torch_parity import jax_params

_SETUPS = {}
TOLS = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
MEAN_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _setup(dtype):
    if dtype not in _SETUPS:
        base = get_config("tinyllama-1.1b", reduced=True)
        jcfg = base.replace(compute_dtype=dtype, param_dtype=dtype,
                            quant=QuantConfig(enabled=True, bits=4, group_size=32),
                            ttd=dataclasses.replace(base.ttd, first_tt_block=1))
        tcfg = config_from_dict(config_to_dict(jcfg))
        jparams = jax_params(jcfg)
        tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
        _SETUPS[dtype] = (jcfg, tcfg, jparams, tparams)
    return _SETUPS[dtype]


def _tables(nb, slots, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(1, nb))[:slots * w].reshape(slots, w).astype(np.int32)


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, **TOLS[dtype])
    assert np.abs(got.numpy() - want).mean() < MEAN_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_and_decode_logits_match(dtype):
    jcfg, tcfg, jparams, tparams = _setup(dtype)
    assert tcfg == config_from_dict(config_to_dict(jcfg))
    assert [len(s) for s in tparams["segments"]] == [1, 1]
    slots, bs, w, chunk = 3, 4, 8, 8
    nb = 1 + slots * w
    bt = _tables(nb, slots, w)
    cdt = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcache = jtf.init_paged_cache(jcfg, nb, bs, cdt[0])
    tcache = ttf.init_paged_cache(tcfg, nb, bs, cdt[1], device="cpu")
    jpre = jax.jit(partial(jtf.prefill_paged_chunk, cfg=jcfg))
    jdec = jax.jit(partial(jtf.decode_step_paged, cfg=jcfg))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (slots, 2 * chunk)).astype(np.int32)
    pos = np.full((slots, 2 * chunk), -1, np.int32)
    pos[0] = np.arange(2 * chunk)  # two full chunks
    pos[1, :5] = np.arange(5)      # a short prompt, padded
    tol = TOLS[dtype]              # row 2 stays idle (-1)
    for c in range(2):
        sl = slice(c * chunk, (c + 1) * chunk)
        jl, jcache = jpre(jparams, caches=jcache, tokens=jnp.asarray(toks[:, sl]),
                          block_tables=jnp.asarray(bt), positions=jnp.asarray(pos[:, sl]))
        tl, tcache = ttf.prefill_paged_chunk(tparams, tcfg, tcache,
                                             torch.from_numpy(toks[:, sl]),
                                             torch.from_numpy(bt), torch.from_numpy(pos[:, sl]))
        _close(tl, jl, dtype)
    for step in range(2):
        dpos = np.array([2 * chunk + step, 5 + step, -1], np.int32)
        dtok = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)
        jl, jcache = jdec(jparams, caches=jcache, tokens=jnp.asarray(dtok),
                          block_tables=jnp.asarray(bt), positions=jnp.asarray(dpos))
        tl, tcache = ttf.decode_step_paged(tparams, tcfg, tcache, torch.from_numpy(dtok),
                                           torch.from_numpy(bt), torch.from_numpy(dpos))
        _close(tl, jl, dtype)
    # the pools hold the same K/V (layer 0 of each segment)
    for jseg, tseg in zip(jcache, tcache):
        np.testing.assert_allclose(tseg[0]["k"].float().numpy(),
                                   np.asarray(jseg["k"][0].astype(jnp.float32)), **tol)
