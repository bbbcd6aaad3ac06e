"""repro_torch TT embedding vs repro: the plain ``tt_embed`` against
``repro.kernels.ref.tt_embedding`` and the ``pallas-interpret`` kernel, the
paged and ring sessions' logits on reduced tinyllama with ``ttd.embed`` on
(untied, and tied, whose unembed runs through the cores as a ``tt_linear``),
the refusals of ``embed_lookup``, ``head_weight`` and ``logits_from_hidden``,
and the port's ``Engine`` tokens against repro's ``Engine``.

Inputs come from seeded numpy generators.  Tolerance: rtol = atol = 2e-4 in
f32 (the JAX suite's own) everywhere; the engines' greedy tokens must be
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import config_to_dict
from repro.configs import get_config
from repro.core.ttd import TTSpec as JTTSpec
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.models import sessions as jsessions
from repro.serve.engine import Engine as JEngine
from repro_torch.config import TTDConfig, config_from_dict
from repro_torch.convert import params_from_jax
from repro_torch.core.ttd import TTSpec
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as tref
from repro_torch.models import modules as tmodules
from repro_torch.models import sessions as tsessions
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Engine as TEngine
from torch_parity import jax_params

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_in,n_out,rank,d", [(4096, 32000, 16, 4), (64, 256, 4, 3)],
                         ids=["llama2-7b", "reduced"])
def test_tt_embed_plain_matches_ref_and_interpret(n_in, n_out, rank, d):
    """llama2-7b's real embed spec (out_modes (20, 16, 10, 10), in_modes
    (8, 8, 8, 8), ranks 16: 57 088 params) and the reduced one; ids wrap
    once (-1, -V-3) and clamp (V, V+7) like the dense gather."""
    spec = TTSpec.make(n_in, n_out, rank, d=d)
    jspec = JTTSpec.make(n_in, n_out, rank, d=d)
    assert (spec.in_modes, spec.out_modes, spec.ranks) == \
        (jspec.in_modes, jspec.out_modes, jspec.ranks)
    if n_out == 32000:
        assert spec.out_modes == (20, 16, 10, 10) and spec.n_params() == 57088
    rng = np.random.default_rng(n_out)
    cores = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
             for s in spec.core_matrix_shapes()]
    ids = np.concatenate([[0, 1, n_out - 1, -1, -n_out - 3, n_out, n_out + 7, -n_out],
                          rng.integers(0, n_out, 9)]).astype(np.int32)
    jc = [jnp.asarray(c) for c in cores]
    want = np.asarray(jref.tt_embedding(jnp.asarray(ids), jc, jspec))
    interp = np.asarray(jdispatch.tt_embed(jnp.asarray(ids), jc, jspec,
                                           backend="pallas-interpret"))
    tc = [torch.from_numpy(c) for c in cores]
    got = tref.tt_embedding(torch.from_numpy(ids), tc, spec)
    assert got.dtype == torch.float32 and got.shape == (len(ids), n_in)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), interp, **TOL)
    # -1 is row V-1; -V-3 wraps once to -3 and clamps to row 0; V+7 clamps to V-1
    assert torch.equal(got[3], got[2]) and torch.equal(got[4], got[0])
    assert torch.equal(got[5], got[2]) and torch.equal(got[6], got[2])
    assert torch.equal(got[7], got[0])
    via = dispatch.tt_embed(torch.from_numpy(ids).reshape(1, -1), tc, spec)
    assert via.shape == (1, len(ids), n_in) and torch.equal(via[0], got)


def test_tt_embed_rows_are_the_reconstructed_table():
    """The chain's rows are rows of the dense weight the cores describe
    (the TT linear applied to the identity), ids in order."""
    spec = TTSpec.make(24, 60, 3, d=3)
    rng = np.random.default_rng(1)
    cores = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in spec.core_matrix_shapes()]
    table = tref.tt_linear_bn_res(torch.eye(spec.n_in), cores, spec).T  # (V, D)
    got = tref.tt_embedding(torch.arange(spec.n_out), cores, spec)
    np.testing.assert_allclose(got.numpy(), table.numpy(), **TOL)


_SETUP = {}


def _setup(tied):
    if tied not in _SETUP:
        base = get_config("tinyllama-1.1b", reduced=True)
        jcfg = base.replace(compute_dtype="float32", param_dtype="float32",
                            tie_embeddings=tied, ttd=dataclasses.replace(base.ttd, embed=True))
        tcfg = config_from_dict(config_to_dict(jcfg))
        jparams = jax_params(jcfg, seed=5 + tied)
        tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
        _SETUP[tied] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)
    return _SETUP[tied]


def test_tt_embed_params_carry_cores():
    s = _setup(False)
    emb = s["tparams"]["embed"]
    assert sorted(emb) == ["cores"] and isinstance(emb["cores"], list)
    spec = tmodules.embed_spec(s["tcfg"]).tt
    assert [tuple(c.shape) for c in emb["cores"]] == spec.core_matrix_shapes()
    for got, want in zip(emb["cores"], s["jparams"]["embed"]["cores"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tmodules.embed_spec(s["tcfg"].replace(ttd=TTDConfig())) is None
    fresh = ttf.init_lm(s["tcfg"], device="cpu")
    assert [tuple(c.shape) for c in fresh["embed"]["cores"]] == spec.core_matrix_shapes()


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("backend", ["paged", "ring"])
def test_tt_embed_session_logits_match_repro(backend, tied):
    """3 slots: a 21-token prompt, a 6-token one and an idle slot, in 3
    chunks of 8, then 3 decode steps with the idle slot still idle."""
    s = _setup(tied)
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    slots, chunk, max_len, bs = 3, 8, 48, 8
    tsess = tsessions.make_session(tcfg, tsessions.SessionSpec(
        slots=slots, max_len=max_len, prefill_chunk=chunk, block_size=bs), backend=backend,
        device="cpu")
    jsess = jsessions.make_session(jcfg, jsessions.SessionSpec(
        slots=slots, max_len=max_len, prefill_chunk=chunk, block_size=bs), backend=backend)
    state, jstate = tsess.init_state(), jsess.init_state()
    if backend == "paged":
        w = tsess.spec.table_width()
        bt = np.arange(1, 1 + slots * w, dtype=np.int32).reshape(slots, w)
        state, jstate = tsess.with_tables(state, bt), jsess.with_tables(jstate, bt)
    jpre = jax.jit(jsess.prefill_chunk)
    jdec = jax.jit(jsess.decode_step)
    rng = np.random.default_rng(13)
    n_chunks = 3
    toks = rng.integers(0, jcfg.vocab_size, (slots, n_chunks * chunk)).astype(np.int32)
    toks[0, 3] = -1  # a negative id wraps to the last row in both packages
    pos = np.full((slots, n_chunks * chunk), -1, np.int32)
    pos[0, :21] = np.arange(21)
    pos[1, :6] = np.arange(6)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        jl, jstate = jpre(s["jparams"], jstate, jnp.asarray(toks[:, sl]),
                          jnp.asarray(pos[:, sl]))
        tl, state = tsess.prefill_chunk(s["tparams"], state, torch.from_numpy(toks[:, sl]),
                                        torch.from_numpy(pos[:, sl]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for step in range(3):
        dpos = np.array([21 + step, 6 + step, -1], np.int32)
        dtok = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)
        jl, jstate = jdec(s["jparams"], jstate, jnp.asarray(dtok), jnp.asarray(dpos))
        tl, state = tsess.decode_step(s["tparams"], state, torch.from_numpy(dtok),
                                      torch.from_numpy(dpos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_tt_embed_refusals():
    """Cores without a cfg that declares them, a tied TT embedding's dense
    head, and a tied TT unembed under a cfg with ``ttd.embed`` off all raise
    ``ValueError``, as in repro."""
    s = _setup(True)
    tcfg, tparams = s["tcfg"], s["tparams"]
    ids = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="ttd.embed"):
        tmodules.embed_lookup(tparams["embed"], ids, torch.float32)
    off = tcfg.replace(ttd=dataclasses.replace(tcfg.ttd, embed=False))
    with pytest.raises(ValueError, match="ttd.embed"):
        tmodules.embed_lookup(tparams["embed"], ids, torch.float32, off)
    with pytest.raises(ValueError, match="no dense head weight"):
        ttf.head_weight(tparams, tcfg)
    with pytest.raises(ValueError, match="ttd.embed is off"):
        ttf.logits_from_hidden(tparams, off, torch.zeros(1, tcfg.d_model))
    untied = _setup(False)
    assert ttf.head_weight(untied["tparams"], untied["tcfg"]) is untied["tparams"]["head"]["w"]


def test_tied_tt_unembed_is_the_tt_linear():
    """The tied TT embedding's logits are the cores' TT linear of f32 x,
    which equals x against the reconstructed table."""
    s = _setup(True)
    tcfg, tparams = s["tcfg"], s["tparams"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, tcfg.d_model))
                         .astype(np.float32))
    got = ttf.logits_from_hidden(tparams, tcfg, x)
    spec = tmodules.embed_spec(tcfg).tt
    table = tmodules.embed_lookup(tparams["embed"], torch.arange(tcfg.vocab_size),
                                  torch.float32, tcfg)
    assert got.shape == (2, 3, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), (x @ table.T).numpy(), **TOL)
    assert torch.equal(got, dispatch.tt_linear(x, tparams["embed"]["cores"], spec))


def _schedule():
    rng = np.random.default_rng(3007)
    lens, outs, arrivals = [9, 3, 12, 5, 7], [5, 4, 2, 5, 3], [0, 0, 1, 2, 4]
    return [(a, [int(t) for t in rng.integers(0, 256, n)], m)
            for a, n, m in zip(arrivals, lens, outs)]


def _drive(engine, sched):
    handles, t, pending = [], 0, list(sched)
    while pending or engine.pending():
        while pending and pending[0][0] <= t:
            _, prompt, max_tokens = pending.pop(0)
            handles.append(engine.submit(prompt, max_tokens=max_tokens))
        engine.tick()
        t += 1
        assert t < 500, "scheduler stalled"
    return [h.out_tokens for h in handles]


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("backend", ["paged", "ring"])
def test_tt_embed_engine_tokens_match_repro_engine(backend, tied):
    """5 requests on 2 slots (slots are reused), chunked prefill of 8."""
    s = _setup(tied)
    sched = _schedule()
    geometry = dict(slots=2, max_len=48, prefill_batch=2, prefill_chunk=8, backend=backend)
    want = _drive(JEngine(s["jcfg"], s["jparams"], **geometry), sched)
    got = _drive(TEngine(s["tcfg"], s["tparams"], device="cpu", **geometry), sched)
    assert got == want
    assert [len(o) for o in got] == [m for _, _, m in sched]


def test_dense_embed_lookup_ignores_the_tt_cfg():
    """Params that carry a table take the dense gather, whatever the cfg
    declares; a negative id wraps once and a large one clamps."""
    s = _setup(False)
    table = {"table": torch.arange(12.0).reshape(4, 3)}
    got = tmodules.embed_lookup(table, torch.tensor([-1, 5, -6]), torch.float32, s["tcfg"])
    np.testing.assert_array_equal(got.numpy(), [[9, 10, 11], [9, 10, 11], [0, 1, 2]])
