"""repro_torch griffin vs repro: the plain RG-LRU scan against
``repro.kernels.ref.rglru_scan`` and the ``pallas-interpret`` kernel, the
``GriffinSession`` logits against repro's on recurrentgemma-2b ``reduced()``,
the port's ``Engine`` tokens against repro's ``Engine``, and the device rule
for the new entry points.

Inputs come from seeded numpy generators.  Tolerances: rtol = atol = 2e-4 in
f32 (the JAX suite's own); a bf16 ``h`` within one bf16 ulp (2^-7 relative)
of the interpret kernel's, which carries the same f32 state and rounds it
once.  Pad steps and idle rows of the scan are held bitwise.  The session
runs the f32 compute config with f32 and bf16 caches at 2e-4 (both packages
round the same f32 values to bf16 the same way) and with the int8 cache at
rtol = atol = 2e-3: an f32 difference of ~1e-7 can move one conv-tail value
across a rounding boundary of its int8 grid, one 1/127 step of the row's
amax, and that shifts the next conv_width - 1 positions' logits (seen once
while this file was written, with other random params: one flipped value
after the 4th chunk, logits off by up to 5.3e-4; with these params none
flips).  The RG-LRU params get a long memory (a up to ~0.99), so a state
error persists.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import config_to_dict
from repro.configs import get_config
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.models import griffin as jgriffin
from repro.serve.engine import Engine as JEngine
from repro_torch.config import config_from_dict
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as tref
from repro_torch.models import griffin as tgriffin
from repro_torch.models import sessions as tsessions
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.steps import serve_config_of
from torch_parity import jax_params

TOL = dict(rtol=2e-4, atol=2e-4)


def _scan_case(seed, b, s, w):
    rng = np.random.default_rng(seed)
    log_a = (-4.0 * rng.random((b, s, w))).astype(np.float32)
    gx = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pos[1] = -1                      # an idle row
    if s > 1:
        pos[2, s // 3:] = -1         # a short prompt, tail-padded
    return log_a, gx, h0, pos


def _jax_scans(log_a, gx, h0, pos, scan_dtype):
    args = [jnp.asarray(a) for a in (log_a, gx, h0, pos)]
    return (jref.rglru_scan(*args, scan_dtype=scan_dtype),
            jdispatch.rglru_scan(*args, scan_dtype=scan_dtype, backend="pallas-interpret"))


@pytest.mark.parametrize("b,s,w", [(3, 20, 200), (4, 1, 136)], ids=["prefill", "decode"])
def test_rglru_scan_plain_matches_ref_and_interpret(b, s, w):
    """Ragged pads and a fully padded row (prefill) or idle rows (decode);
    W not a multiple of 128 and S not a multiple of the 16-step tile."""
    log_a, gx, h0, pos = _scan_case(b * 31 + s, b, s, w)
    (hr, lr), (hi, li) = _jax_scans(log_a, gx, h0, pos, jnp.float32)
    t = [torch.from_numpy(a) for a in (log_a, gx, h0, pos)]
    h, last = tref.rglru_scan(*t)
    for want_h, want_last in ((hr, lr), (hi, li)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
        np.testing.assert_allclose(last.numpy(), np.asarray(want_last), **TOL)
    idle = ~(pos >= 0).any(axis=1)
    assert idle[1]
    assert torch.equal(last[idle], t[2][idle])                    # h0 bitwise
    assert torch.equal(h[idle], t[2][idle][:, None].expand(-1, s, -1))
    if s > 1:  # pad steps pass the state through bitwise
        n = s // 3
        assert torch.equal(h[2, n:], h[2, n - 1:n].expand(s - n, w))
        assert torch.equal(last[2], h[2, n - 1])
    via = dispatch.rglru_scan(*t)
    assert torch.equal(via[0], h) and torch.equal(via[1], last)


def test_rglru_scan_bf16_h_matches_interpret():
    log_a, gx, h0, pos = _scan_case(5, 3, 24, 64)
    _, (hi, li) = _jax_scans(log_a, gx, h0, pos, jnp.bfloat16)
    h, last = tref.rglru_scan(*[torch.from_numpy(a) for a in (log_a, gx, h0, pos)],
                              scan_dtype=torch.bfloat16)
    assert h.dtype == torch.bfloat16 and last.dtype == torch.float32
    np.testing.assert_allclose(h.float().numpy(), np.asarray(hi.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=2.0 ** -7)
    np.testing.assert_allclose(last.numpy(), np.asarray(li), **TOL)


def test_rglru_scan_shape_checks():
    z = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="log_a/gx"):
        dispatch.rglru_scan(z, torch.zeros(2, 3, 5), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="h0 must be"):
        dispatch.rglru_scan(z, z, torch.zeros(2, 5))


_SETUP = {}


def _setup():
    if not _SETUP:
        jcfg = get_config("recurrentgemma-2b", reduced=True).replace(
            compute_dtype="float32", param_dtype="float32")
        tcfg = config_from_dict(config_to_dict(jcfg))
        jparams = jax_params(jcfg, seed=4)
        tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
        _SETUP.update(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)
    return _SETUP


def test_config_and_params_mirror_repro():
    s = _setup()
    assert tget_config("recurrentgemma-2b") == config_from_dict(
        config_to_dict(get_config("recurrentgemma-2b")))
    assert tget_config("recurrentgemma-2b", reduced=True) == config_from_dict(
        config_to_dict(get_config("recurrentgemma-2b", reduced=True)))
    assert tgriffin.pattern_plan(s["tcfg"]) == (1, ("rec",))
    assert len(s["tparams"]["groups"]) == 1 and len(s["tparams"]["tail"]) == 1
    assert sorted(s["tparams"]["groups"][0]) == ["l0_rec", "l1_rec", "l2_attn"]
    full = serve_config_of(tget_config("recurrentgemma-2b"))
    assert (full.family, full.pattern, full.lru_width, full.window, full.ttd, full.n_layers) == \
        ("griffin", ("rec", "rec", "attn"), 2560, 2048, tget_config("recurrentgemma-2b").ttd, 26)
    assert full.quant.enabled and full.param_dtype == "bfloat16"


@pytest.mark.parametrize("cache_dtype,tol", [("float32", TOL), ("bfloat16", TOL),
                                             ("int8", dict(rtol=2e-3, atol=2e-3))])
def test_griffin_session_logits_match_repro(cache_dtype, tol):
    """3 slots: a 40-token prompt (its 24-entry ring wraps), a 13-token one
    and an idle slot, in 5 chunks of 8; then 3 decode steps with the idle
    slot still idle.  Logits and the recurrent state match repro's."""
    s = _setup()
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    slots, chunk, max_len = 3, 8, 64
    sess = tsessions.make_session(tcfg, tsessions.SessionSpec(
        slots=slots, max_len=max_len, prefill_chunk=chunk, cache_dtype=cache_dtype),
        device="cpu")
    assert sess.backend == "recurrent" and not sess.uses_blocks and sess.slot_axis == 0
    state = sess.init_state()
    jstate = jgriffin.init_session_state(jcfg, slots, max_len, chunk, jnp.dtype(cache_dtype))
    jpre = jax.jit(partial(jgriffin.prefill_session_chunk, cfg=jcfg))
    jdec = jax.jit(partial(jgriffin.decode_session_step, cfg=jcfg))
    rng = np.random.default_rng(11)
    n_chunks = 5
    toks = rng.integers(0, jcfg.vocab_size, (slots, n_chunks * chunk)).astype(np.int32)
    pos = np.full((slots, n_chunks * chunk), -1, np.int32)
    pos[0] = np.arange(40)
    pos[1, :13] = np.arange(13)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        jl, jstate = jpre(s["jparams"], state=jstate, tokens=jnp.asarray(toks[:, sl]),
                          positions=jnp.asarray(pos[:, sl]))
        tl, state = sess.prefill_chunk(s["tparams"], state, torch.from_numpy(toks[:, sl]),
                                       torch.from_numpy(pos[:, sl]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for step in range(3):
        dpos = np.array([40 + step, 13 + step, -1], np.int32)
        dtok = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)
        jl, jstate = jdec(s["jparams"], state=jstate, tokens=jnp.asarray(dtok),
                          positions=jnp.asarray(dpos))
        tl, state = sess.decode_step(s["tparams"], state, torch.from_numpy(dtok),
                                     torch.from_numpy(dpos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    jtail, ttail = jstate["tail"][0], state["tail"][0]
    np.testing.assert_allclose(ttail["h"].numpy(), np.asarray(jtail["h"]), **tol)
    jattn, tattn = jstate["groups"]["l2_attn"], state["groups"][0]["l2_attn"]
    np.testing.assert_array_equal(tattn["pos"].numpy(), np.asarray(jattn["pos"][0]))
    if cache_dtype == "int8":  # the idle slot kept its initial tail and scale bitwise
        np.testing.assert_array_equal(ttail["conv_scale"][2].numpy(),
                                      np.asarray(jtail["conv_scale"][2]))
        assert not ttail["conv"][2].any()


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


def test_engine_tokens_match_repro_engine():
    """5 requests on 2 slots, so slots are reused (the reset of a freed
    slot's ring and recurrent state matters); a 30-token prompt is longer
    than the window of 16; one request runs into the max_len frontier."""
    s = _setup()
    rng = np.random.default_rng(21)
    lens, outs = [30, 5, 12, 3, 20], [6, 9, 4, 7, 25]
    sched = [(i, [int(x) for x in rng.integers(0, 256, n)], m)
             for i, (n, m) in enumerate(zip(lens, outs))]
    geometry = dict(slots=2, max_len=40, prefill_batch=2, prefill_chunk=8)
    jeng = JEngine(s["jcfg"], s["jparams"], **geometry)
    want = _drive(jeng, sched)
    eng = TEngine(s["tcfg"], s["tparams"], device="cpu", **geometry)
    assert eng.manager is None and eng.num_free_blocks is None
    got = _drive(eng, sched)
    assert got == want
    assert [len(o) for o in got] == [6, 9, 4, 7, 20]  # the last one stops at max_len
    # a random model's greedy token barely sees the recurrent state, so the
    # reset of reused slots is held on the final state: a stale h or ring
    # position left by an earlier occupant would differ from repro's
    for key in ("l0_rec", "l1_rec"):
        np.testing.assert_allclose(eng.state["groups"][0][key]["h"].numpy(),
                                   np.asarray(jeng.state["groups"][key]["h"][0]), **TOL)
    np.testing.assert_allclose(eng.state["tail"][0]["h"].numpy(),
                               np.asarray(jeng.state["tail"][0]["h"]), **TOL)
    np.testing.assert_array_equal(eng.state["groups"][0]["l2_attn"]["pos"].numpy(),
                                  np.asarray(jeng.state["groups"]["l2_attn"]["pos"][0]))


def test_griffin_entry_points_need_cuda_unless_cpu(monkeypatch):
    s = _setup()
    cfg = s["tcfg"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tsessions.SessionSpec(slots=2, max_len=32)
    for call in (lambda: tgriffin.init_lm(cfg),
                 lambda: tsessions.make_session(cfg, spec),
                 lambda: tgriffin.init_session_state(cfg, 2, 32, 8),
                 lambda: TEngine(cfg, s["tparams"], slots=2, max_len=32)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    params = tgriffin.init_lm(cfg, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="no 'ring' state backend"):
        tsessions.make_session(cfg, spec, backend="ring", device="cpu")
