"""repro_torch rwkv vs repro: the plain wkv scan against
``repro.kernels.ref.wkv_scan`` and the ``pallas-interpret`` kernel, the
``RwkvSession`` logits against repro's on rwkv6-7b ``reduced()``, the port's
``Engine`` tokens against repro's ``Engine``, and the device rule for the new
entry points.

Inputs come from seeded numpy generators.  Tolerances: rtol = atol = 2e-4 in
f32 (the JAX suite's own).  The scan cases hold decays below the prefill
floor (w ~ 1e-3 < e^-4.9 = 0.0075), which the chunked prefill clips and the
exact decode step does not, so a scan that ignores the floor (or applies it
at decode) fails them.  Padding steps and idle rows are held bitwise; an
int8 state within one int8 step (the requantized value of an f32 state that
differs in its last bits can round the other way) with the scale at 2e-4.
The session runs the f32 compute config with f32 and bf16 caches at 2e-4,
and with the int8 wkv state at rtol = atol = 1e-2: every chunk requantizes
each (slot, head) state to 1/127 of its amax, so an f32 difference of ~1e-7
can move one state value across a rounding boundary of that grid, one step
of ~amax/127, and every later chunk's outputs carry it.  With these params
that happens once: one of 6144 state values of layer 1 rounds to its
neighbour after the 2nd chunk, and the 4th chunk's logits then differ by up
to 3.4e-3 (the 1st and 2nd by < 6e-6).  The final int8 state is held within
one int8 step, its scales at 2e-4.
"""
import gc
import weakref
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
from repro.models import rwkv as jrwkv
from repro.serve.engine import Engine as JEngine
from repro_torch.config import config_from_dict
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scan_wkv
from repro_torch.models import rwkv as trwkv
from repro_torch.models import sessions as tsessions
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.steps import serve_config_of
from torch_parity import jax_params

TOL = dict(rtol=2e-4, atol=2e-4)


def _quantize(s):
    sc = np.maximum(np.abs(s).max(axis=(-2, -1)), 1e-8) / 127.0
    return np.round(s / sc[..., None, None]).astype(np.int8), sc.astype(np.float32)


def _wkv_case(seed, b, s, h, hd, int8=False):
    """Row 0 full, row 1 idle, row 2 tail-padded (S > 1); a quarter of the
    channels decay at w ~ 1e-3, the rest in (0.3, 1)."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, hd)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.3, 1.0, shape).astype(np.float32)
    w[..., : hd // 4] = rng.uniform(5e-4, 2e-3, shape[:-1] + (hd // 4,))
    u = (0.5 * rng.standard_normal((h, hd))).astype(np.float32)
    state0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    scale = None
    if int8:
        state0, scale = _quantize(state0)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1)) + 5
    pos[1] = -1
    if s > 1:
        pos[2, s // 3:] = -1
    return dict(r=r, k=k, v=v, w=w, u=u, state0=state0, pos=pos, state_scale=scale)


def _jax_scans(c):
    args = [jnp.asarray(c[n]) for n in ("r", "k", "v", "w", "u", "state0", "pos")]
    sc = None if c["state_scale"] is None else jnp.asarray(c["state_scale"])
    return (jref.wkv_scan(*args, state_scale=sc),
            jdispatch.wkv_scan(*args, state_scale=sc, backend="pallas-interpret"))


def _torch_case(c):
    return {n: None if a is None else torch.from_numpy(a) for n, a in c.items()}


@pytest.mark.parametrize("b,s,h,hd", [(3, 20, 2, 16), (3, 1, 2, 16), (3, 16, 1, 8)],
                         ids=["prefill-ragged", "decode", "prefill-one-chunk"])
def test_wkv_scan_plain_matches_ref_and_interpret(b, s, h, hd):
    """f32 state: y and the state at 2e-4; the idle row's state bitwise."""
    c = _wkv_case(b * 7 + s, b, s, h, hd)
    t = _torch_case(c)
    y, st, sc = tref.wkv_scan(t["r"], t["k"], t["v"], t["w"], t["u"], t["state0"], t["pos"])
    assert sc is None and y.dtype == st.dtype == torch.float32
    for want_y, want_st, want_sc in _jax_scans(c):
        assert want_sc is None
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **TOL)
    assert torch.equal(st[1], t["state0"][1])  # idle row
    via = dispatch.wkv_scan(t["r"], t["k"], t["v"], t["w"], t["u"], t["state0"], t["pos"])
    assert torch.equal(via[0], y) and torch.equal(via[1], st)


def test_wkv_scan_floor_is_the_serial_walk_with_floored_decay():
    """The chunked prefill equals the exact recurrence run with w' =
    exp(clip(log w, -4.9, 0)) (what the CUDA kernel walks), and differs from
    the recurrence with the raw w on these decays: the case sees the floor."""
    c = _wkv_case(3, 3, 37, 2, 16)
    t = _torch_case(c)
    m = (t["pos"] >= 0)[:, :, None, None]
    k = torch.where(m, t["k"], 0.0)
    w = torch.where(m, t["w"], 1.0)
    w_floor = torch.exp(torch.clamp(torch.log(w), scan_wkv.WKV_LOG_DECAY_FLOOR, 0.0))
    y, st, _ = tref.wkv_scan(t["r"], t["k"], t["v"], t["w"], t["u"], t["state0"], t["pos"])
    y_f, st_f = scan_wkv._sequential(t["r"], k, t["v"], w_floor, t["u"], t["state0"])
    np.testing.assert_allclose(y.numpy(), y_f.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), st_f.numpy(), **TOL)
    y_raw, _ = scan_wkv._sequential(t["r"], k, t["v"], w, t["u"], t["state0"])
    assert (y - y_raw).abs().max() > 100 * 2e-4


@pytest.mark.parametrize("s", [20, 1], ids=["prefill-ragged", "decode"])
def test_wkv_scan_plain_int8_state(s):
    """int8 state with per-(slot, head) scales: y at 2e-4, the payload
    within one int8 step, the scale at 2e-4, the idle row's payload and
    scale bitwise."""
    c = _wkv_case(40 + s, 3, s, 2, 16, int8=True)
    t = _torch_case(c)
    y, q, sc = tref.wkv_scan(t["r"], t["k"], t["v"], t["w"], t["u"], t["state0"], t["pos"],
                             state_scale=t["state_scale"])
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    for want_y, want_q, want_sc in _jax_scans(c):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        assert np.abs(q.numpy().astype(int) - np.asarray(want_q).astype(int)).max() <= 1
        np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), **TOL)
    assert torch.equal(q[1], t["state0"][1]) and torch.equal(sc[1], t["state_scale"][1])


def test_wkv_scan_shape_checks():
    c = _torch_case(_wkv_case(0, 3, 3, 2, 8))
    args = [c[n] for n in ("r", "k", "v", "w", "u", "state0")]
    with pytest.raises(ValueError, match="r/k/v/w"):
        dispatch.wkv_scan(args[0], args[1][:, :2], *args[2:])
    with pytest.raises(ValueError, match="state0 must be"):
        dispatch.wkv_scan(*args[:5], args[5][:, :1])
    with pytest.raises(ValueError, match="requires state_scale"):
        dispatch.wkv_scan(*args[:5], args[5].to(torch.int8))
    with pytest.raises(ValueError, match="u must be"):
        dispatch.wkv_scan(*args[:4], args[4][:1], args[5])


_SETUP = {}


def _setup():
    if not _SETUP:
        jcfg = get_config("rwkv6-7b", reduced=True).replace(
            compute_dtype="float32", param_dtype="float32")
        tcfg = config_from_dict(config_to_dict(jcfg))
        jparams = jax_params(jcfg, seed=6)
        tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
        _SETUP.update(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)
    return _SETUP


def test_config_and_params_mirror_repro():
    s = _setup()
    for reduced in (False, True):
        assert tget_config("rwkv6-7b", reduced=reduced) == config_from_dict(
            config_to_dict(get_config("rwkv6-7b", reduced=reduced)))
    assert len(s["tparams"]["blocks"]) == s["tcfg"].n_layers == 2
    blk, jblk = s["tparams"]["blocks"][1], s["jparams"]["blocks"]
    np.testing.assert_array_equal(blk["decay_w0"].numpy(), np.asarray(jblk["decay_w0"][1]))
    np.testing.assert_array_equal(blk["cm"]["k"]["cores"][2].numpy(),
                                  np.asarray(jblk["cm"]["k"]["cores"][2][1]))
    full = serve_config_of(tget_config("rwkv6-7b"))
    specs = trwkv.rwkv_specs(full)
    assert {nm: sp.kind for nm, sp in specs["tm"].items()} == \
        {"r": "int4", "k": "int4", "v": "int4", "g": "int4", "o": "tt"}
    assert {nm: sp.kind for nm, sp in specs["cm"].items()} == \
        {"k": "tt", "v": "tt", "r": "int4"}
    assert (specs["tm"]["o"].tt.in_modes, specs["tm"]["o"].tt.out_modes) == \
        ((8, 8, 8, 8), (8, 8, 8, 8))
    assert (specs["cm"]["k"].tt.out_modes, specs["cm"]["v"].tt.in_modes) == \
        ((16, 14, 8, 8), (16, 14, 8, 8))
    assert specs["cm"]["k"].tt.ranks == (1, 16, 16, 16, 1)


@pytest.mark.parametrize("cache_dtype,tol", [("float32", TOL), ("bfloat16", TOL),
                                             ("int8", dict(rtol=1e-2, atol=1e-2))])
def test_rwkv_session_logits_match_repro(cache_dtype, tol):
    """3 slots: a 37-token prompt, a 13-token one and an idle slot, in 5
    chunks of 8, then 3 decode steps with the idle slot still idle.  Logits
    and the final state match repro's."""
    s = _setup()
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    slots, chunk = 3, 8
    sess = tsessions.make_session(tcfg, tsessions.SessionSpec(
        slots=slots, max_len=64, prefill_chunk=chunk, cache_dtype=cache_dtype), device="cpu")
    assert type(sess) is tsessions.RwkvSession and sess.slot_axis == 0
    state = sess.init_state()
    jstate = jrwkv.init_session_state(jcfg, slots, jnp.dtype(cache_dtype))
    jpre = jax.jit(partial(jrwkv.prefill_session_chunk, cfg=jcfg))
    jdec = jax.jit(partial(jrwkv.decode_session_step, cfg=jcfg))
    rng = np.random.default_rng(17)
    n_chunks = 5
    toks = rng.integers(0, jcfg.vocab_size, (slots, n_chunks * chunk)).astype(np.int32)
    pos = np.full((slots, n_chunks * chunk), -1, np.int32)
    pos[0, :37] = np.arange(37)
    pos[1, :13] = np.arange(13)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        jl, jstate = jpre(s["jparams"], state=jstate, tokens=jnp.asarray(toks[:, sl]),
                          positions=jnp.asarray(pos[:, sl]))
        tl, state = sess.prefill_chunk(s["tparams"], state, torch.from_numpy(toks[:, sl]),
                                       torch.from_numpy(pos[:, sl]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for step in range(3):
        dpos = np.array([37 + step, 13 + step, -1], np.int32)
        dtok = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)
        jl, jstate = jdec(s["jparams"], state=jstate, tokens=jnp.asarray(dtok),
                          positions=jnp.asarray(dpos))
        tl, state = sess.decode_step(s["tparams"], state, torch.from_numpy(dtok),
                                     torch.from_numpy(dpos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for i, layer in enumerate(state):
        assert str(layer["x_tm"].dtype) == f"torch.{jnp.dtype(jstate['x_tm'].dtype).name}"
        for key in ("x_tm", "x_cm"):
            np.testing.assert_allclose(layer[key].float().numpy(),
                                       np.asarray(jstate[key][i], np.float32), **tol)
        if cache_dtype == "int8":
            q, jq = layer["wkv"].numpy().astype(int), np.asarray(jstate["wkv"][i]).astype(int)
            assert np.abs(q - jq).max() <= 1
            np.testing.assert_allclose(layer["wkv_scale"].numpy(),
                                       np.asarray(jstate["wkv_scale"][i]), **TOL)
            # the idle slot kept its initial payload and scale bitwise
            assert not layer["wkv"][2].any()
            np.testing.assert_array_equal(layer["wkv_scale"][2].numpy(),
                                          np.asarray(jstate["wkv_scale"][i][2]))
        else:
            np.testing.assert_allclose(layer["wkv"].numpy(), np.asarray(jstate["wkv"][i]),
                                       **tol)


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
    slot's wkv and token-shift state matters); one request runs into the
    max_len frontier.  The final state matches repro's."""
    s = _setup()
    rng = np.random.default_rng(23)
    lens, outs = [19, 5, 12, 3, 20], [6, 9, 4, 7, 25]
    sched = [(i, [int(x) for x in rng.integers(0, 256, n)], m)
             for i, (n, m) in enumerate(zip(lens, outs))]
    geometry = dict(slots=2, max_len=40, prefill_batch=2, prefill_chunk=8)
    jeng = JEngine(s["jcfg"], s["jparams"], **geometry)
    want = _drive(jeng, sched)
    eng = TEngine(s["tcfg"], s["tparams"], device="cpu", **geometry)
    assert eng.manager is None and eng.session.backend == "recurrent"
    got = _drive(eng, sched)
    assert got == want
    assert [len(o) for o in got] == [6, 9, 4, 7, 20]  # the last one stops at max_len
    # a stale wkv or token-shift row left by an earlier occupant would
    # differ from repro's final state
    for i, layer in enumerate(eng.state):
        for key in ("wkv", "x_tm", "x_cm"):
            np.testing.assert_allclose(layer[key].numpy(), np.asarray(jeng.state[key][i]),
                                       **TOL)


def test_dropped_engine_is_freed_without_the_cycle_collector():
    """An Engine that has served holds no reference cycle: dropping it frees
    its session state (on the card, its wkv matrices) at once."""
    s = _setup()
    eng = TEngine(s["tcfg"], s["tparams"], device="cpu", slots=2, max_len=40, prefill_chunk=8)
    for n in (5, 12, 3):
        eng.submit(list(range(1, n + 1)), max_tokens=3)
    eng.run()
    gone = weakref.ref(eng)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert gone() is None
    finally:
        if was_enabled:
            gc.enable()


def test_rwkv_entry_points_need_cuda_unless_cpu(monkeypatch):
    s = _setup()
    cfg = s["tcfg"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tsessions.SessionSpec(slots=2, max_len=32)
    for call in (lambda: trwkv.init_lm(cfg),
                 lambda: tsessions.make_session(cfg, spec),
                 lambda: trwkv.init_session_state(cfg, 2),
                 lambda: params_from_jax(jax.device_get(s["jparams"]), cfg),
                 lambda: TEngine(cfg, s["tparams"], slots=2, max_len=32)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    params = trwkv.init_lm(cfg, device="cpu")
    assert params["head"]["w"].device.type == "cpu" and len(params["blocks"]) == 2
    state = trwkv.init_session_state(cfg, 2, torch.int8, device="cpu")
    assert state[0]["wkv"].dtype == torch.int8 and state[0]["x_tm"].dtype == torch.float32
    assert torch.equal(state[0]["wkv_scale"], torch.full((2, 4), 1e-8 / 127.0))
    with pytest.raises(NotImplementedError, match="no 'paged' state backend"):
        tsessions.make_session(cfg, spec, backend="paged", device="cpu")
