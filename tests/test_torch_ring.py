"""repro_torch ring layout vs repro: the plain ring attention against
``repro.kernels.ref.ring_attention`` and the ``pallas-interpret`` kernel,
``ring_kv_update`` against repro's, and the dense ``RingKVSession`` against
repro's ring prefill/decode on reduced llama2-7b with a sliding window.

Inputs come from seeded numpy generators.  Tolerance: rtol = atol = 2e-4 in
f32, the JAX suite's own, for f32 and int8 rings alike: both packages
quantize the same f32 K/V the same way, so the int8 payloads agree.
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
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.models import modules as jmodules
from repro.models import transformer as jtf
from repro_torch.config import config_from_dict
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as tref
from repro_torch.models import modules as tmodules
from repro_torch.models.sessions import SessionSpec, make_session
from torch_parity import jax_params

TOL = dict(rtol=2e-4, atol=2e-4)


def _quantize(x):
    sc = np.maximum(np.abs(x).max(-1), 1e-8).astype(np.float32) / np.float32(127.0)
    return np.round(x / sc[..., None]).astype(np.int8), sc


def _ring_case(seed, *, wr, ctx_lens, chunk, hkv, g, dh=16, int8=False):
    """Rings in ring layout (position p at entry p % wr; a context longer
    than wr has wrapped, 0 = an empty ring) and a chunk of queries ending at
    each context length, the shorter rows tail-padded with -1."""
    rng = np.random.default_rng(seed)
    b = len(ctx_lens)
    k = rng.standard_normal((b, wr, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, wr, hkv, dh)).astype(np.float32)
    kpos = np.full((b, wr), -1, np.int32)
    qpos = np.full((b, chunk), -1, np.int32)
    for i, c in enumerate(ctx_lens):
        for p in range(max(0, c - wr), c):
            kpos[i, p % wr] = p
        n = min(c, chunk - i)  # row i leaves i padding rows at its tail
        qpos[i, :n] = np.arange(c - n, c)
    q = rng.standard_normal((b, chunk, hkv * g, dh)).astype(np.float32)
    out = dict(q=q, k=k, v=v, kpos=kpos, qpos=qpos, k_scale=None, v_scale=None)
    if int8:
        out["k"], out["k_scale"] = _quantize(k)
        out["v"], out["v_scale"] = _quantize(v)
    return out


@pytest.mark.parametrize("wr,ctx_lens,chunk,g,window,int8", [
    (16, (11, 3, 0), 5, 1, 0, False),    # full-attention rings, an empty one
    (12, (23, 9), 6, 4, 8, False),       # wrapped ring, window, GQA 4
    (12, (30, 7, 0), 6, 1, 8, True),     # int8 rings, wrapped twice
    (10, (17, 4), 4, 4, 0, True),        # int8, GQA 4, no window
])
def test_ring_attention_plain_matches_ref_and_interpret(wr, ctx_lens, chunk, g, window,
                                                        int8):
    c = _ring_case(wr * 97 + chunk, wr=wr, ctx_lens=ctx_lens, chunk=chunk, hkv=2, g=g,
                   int8=int8)
    j = {n: (None if a is None else jnp.asarray(a)) for n, a in c.items()}
    t = {n: (None if a is None else torch.from_numpy(a)) for n, a in c.items()}
    want = jref.ring_attention(j["q"], j["k"], j["v"], j["qpos"], j["kpos"], window=window,
                               k_scale=j["k_scale"], v_scale=j["v_scale"])
    interp = jdispatch.prefill_attention(
        j["q"], j["qpos"], k=j["k"], v=j["v"], kpos=j["kpos"], window=window,
        k_scale=j["k_scale"], v_scale=j["v_scale"], backend="pallas-interpret")
    got = tref.ring_attention(t["q"], t["k"], t["v"], t["qpos"], t["kpos"], window=window,
                              k_scale=t["k_scale"], v_scale=t["v_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), **TOL)
    assert not got.numpy()[c["qpos"] < 0].any()  # padding rows: exact zeros
    via = dispatch.prefill_attention(t["q"], t["qpos"], k=t["k"], v=t["v"], kpos=t["kpos"],
                                     window=window, k_scale=t["k_scale"],
                                     v_scale=t["v_scale"])
    assert torch.equal(via, got)


def test_prefill_attention_takes_exactly_one_layout():
    c = {n: (None if a is None else torch.from_numpy(a))
         for n, a in _ring_case(0, wr=8, ctx_lens=(5,), chunk=2, hkv=1, g=1).items()}
    cache = {"k": torch.zeros(2, 4, 1, 16), "v": torch.zeros(2, 4, 1, 16)}
    bt = torch.zeros(1, 2, dtype=torch.int32)
    for kw, msg in ((dict(), "exactly one layout"),
                    (dict(cache=cache, block_tables=bt, k=c["k"], v=c["v"], kpos=c["kpos"]),
                     "exactly one layout"),
                    (dict(cache=cache), "needs both"),
                    (dict(k=c["k"], v=c["v"]), "needs all"),
                    (dict(k=c["k"], v=c["v"], kpos=c["kpos"], k_scale=c["kpos"]),
                     "together"),
                    (dict(cache=cache, block_tables=bt, k_scale=bt, v_scale=bt),
                     "ring-layout only")):
        with pytest.raises(ValueError, match=msg):
            dispatch.prefill_attention(c["q"], c["qpos"], **kw)


@pytest.mark.parametrize("int8", [False, True])
def test_ring_kv_update_matches_repro(int8):
    """Writes with wrapped positions, a tail-padded row and an idle row
    (every write dropped): payloads, scales and positions equal repro's."""
    rng = np.random.default_rng(3 + int8)
    b, wr, hkv, dh, s = 3, 8, 2, 4, 5
    cache = {"k": rng.standard_normal((b, wr, hkv, dh)).astype(np.float32),
             "v": rng.standard_normal((b, wr, hkv, dh)).astype(np.float32),
             "pos": rng.integers(-1, 40, (b, wr)).astype(np.int32)}
    if int8:
        cache["k"], cache["k_scale"] = _quantize(cache["k"])
        cache["v"], cache["v_scale"] = _quantize(cache["v"])
    pos = np.full((b, s), -1, np.int32)
    pos[0] = np.arange(13, 13 + s)  # wraps the ring (entries 5, 6, 7, 0, 1)
    pos[1, :2] = [6, 7]             # tail padding; its spare entry is entry 0
    k_new = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v_new = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    want = jmodules.ring_kv_update({n: jnp.asarray(a) for n, a in cache.items()},
                                   jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos))
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got = tmodules.ring_kv_update(tcache, torch.from_numpy(k_new), torch.from_numpy(v_new),
                                  torch.from_numpy(pos))
    assert got is tcache and sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=n)
    for n in cache:  # the idle row is untouched
        np.testing.assert_array_equal(got[n][2].numpy(), cache[n][2])


_SETUP = {}


def _setup():
    if not _SETUP:
        base = get_config("llama2-7b", reduced=True)
        jcfg = base.replace(window=16, compute_dtype="float32", param_dtype="float32",
                            quant=QuantConfig(enabled=True, bits=4, group_size=32),
                            ttd=dataclasses.replace(base.ttd, first_tt_block=1))
        tcfg = config_from_dict(config_to_dict(jcfg))
        jparams = jax_params(jcfg, seed=2)
        tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
        _SETUP.update(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)
    return _SETUP


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_ring_session_logits_match_repro(cache_dtype):
    """Prefill of 3 slots (a 35-token prompt wraps its 24-entry ring twice
    over the chunks; a 6-token prompt; an idle slot), then decode steps with
    the idle slot still idle."""
    s = _setup()
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    slots, chunk, max_len = 3, 8, 64
    sess = make_session(tcfg, SessionSpec(slots=slots, max_len=max_len, prefill_chunk=chunk,
                                          cache_dtype=cache_dtype), device="cpu")
    assert sess.backend == "ring" and not sess.uses_blocks
    state = sess.init_state()
    assert state["kv"][0][0]["k"].shape == (slots, 16 + chunk, 2, 16)
    jdt = {"float32": jnp.float32, "int8": jnp.int8}[cache_dtype]
    jcache = jtf.init_ring_cache(jcfg, slots, max_len, chunk, jdt)
    jpre = jax.jit(partial(jtf.prefill_ring_chunk, cfg=jcfg))
    jdec = jax.jit(partial(jtf.decode_step_ring, cfg=jcfg))
    jparams = s["jparams"]
    rng = np.random.default_rng(9)
    n_chunks = 5
    toks = rng.integers(0, jcfg.vocab_size, (slots, n_chunks * chunk)).astype(np.int32)
    pos = np.full((slots, n_chunks * chunk), -1, np.int32)
    pos[0, :35] = np.arange(35)
    pos[1, :6] = np.arange(6)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        jl, jcache = jpre(jparams, caches=jcache, tokens=jnp.asarray(toks[:, sl]),
                          positions=jnp.asarray(pos[:, sl]))
        tl, state = sess.prefill_chunk(s["tparams"], state, torch.from_numpy(toks[:, sl]),
                                       torch.from_numpy(pos[:, sl]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for step in range(3):
        dpos = np.array([35 + step, 6 + step, -1], np.int32)
        dtok = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)
        jl, jcache = jdec(jparams, caches=jcache, tokens=jnp.asarray(dtok),
                          positions=jnp.asarray(dpos))
        tl, state = sess.decode_step(s["tparams"], state, torch.from_numpy(dtok),
                                     torch.from_numpy(dpos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for jseg, tseg in zip(jcache, state["kv"]):
        np.testing.assert_array_equal(tseg[0]["pos"].numpy(), np.asarray(jseg["pos"][0]))
