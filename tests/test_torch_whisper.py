"""repro_torch whisper (``models/whisper.py``, ``EncDecSession``, ``enc_frames``
through the Engine) against ``repro``.

Reduced whisper-base (2 + 2 layers, enc_len 16, 4 heads of 16) in f32, with
int4 (group 32) on q/k/v, TT on attn-O and both MLP linears, every bias and
norm drawn from a numpy seed (``jax.eval_shape`` fills, no ``init_lm``), the
params carried across with ``params_from_jax``.  Numerics are held at rtol =
atol = 2e-4, greedy tokens exactly.  The encoder is also held at enc_len
1500, where ``repro`` takes its blocked online-softmax path
(``flash_attention``: 1500² > 2²¹ scores) and the port its dense one.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QuantConfig, config_to_dict
from repro.configs import get_config
from repro.models import sessions as jsessions
from repro.models import whisper as jwhisper
from repro.serve import steps as jsteps
from repro.serve.engine import Engine as JEngine
from repro_torch.config import config_from_dict
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels import dispatch
from repro_torch.models import sessions as tsessions
from repro_torch.models import whisper as twhisper
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.steps import serve_config_of
from torch_parity import _fill

TOL = dict(rtol=2e-4, atol=2e-4)
_SETUP = {}


def _jax_params(cfg, seed):
    """Seeded JAX whisper tree with ``init_lm``'s structure, shapes and dtypes."""
    shapes = jax.eval_shape(partial(jwhisper.init_lm, cfg=cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        keys = [str(p.key) for p in path if hasattr(p, "key")]
        x = np.asarray(_fill(keys[-1], "cores" in keys, leaf.shape, cfg, rng))
        out.append(jnp.asarray(x if x.dtype == np.uint8 else x.astype(np.float32), leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def _setup():
    if not _SETUP:
        jcfg = get_config("whisper-base", reduced=True).replace(
            compute_dtype="float32", param_dtype="float32",
            quant=QuantConfig(enabled=True, bits=4, group_size=32))
        tcfg = config_from_dict(config_to_dict(jcfg))
        jparams = _jax_params(jcfg, seed=3)
        tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
        _SETUP.update(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)
    return _SETUP


def _frames(rng, n, cfg):
    return rng.standard_normal((n, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **TOL)


def test_encode_ctx_matches_repro():
    """Each decoder layer's cross K/V from the encoder, at enc_len 16 (both
    packages dense) and at whisper-base's 1500 (repro blocked, the port
    dense), each at 2e-4."""
    s = _setup()
    rng = np.random.default_rng(0)
    for enc_len in (16, 1500):
        jcfg = s["jcfg"].replace(enc_len=enc_len)
        tcfg = config_from_dict(config_to_dict(jcfg))
        jp, tp = s["jparams"], s["tparams"]
        if enc_len != s["jcfg"].enc_len:
            pos = (0.1 * rng.standard_normal((enc_len, jcfg.d_model))).astype(np.float32)
            jp, tp = dict(jp, enc_pos=jnp.asarray(pos)), dict(tp, enc_pos=torch.tensor(pos))
        frames = _frames(rng, 2 if enc_len == 16 else 1, jcfg)
        want = jax.jit(lambda p, f, c=jcfg: jwhisper.encode_ctx(p, c, f))(jp, frames)
        got = twhisper.encode_ctx(tp, tcfg, torch.from_numpy(frames))
        for nm in ("k", "v"):
            assert got[nm].dtype == torch.float32
            _close(got[nm], want[nm], f"enc_len {enc_len} cross {nm}")


def _pools_agree(tst, jst, int8):
    """After a call on an int8 pool: each payload within one int8 step (a K/V
    value ~1e-7 from the reference's can round to the neighbouring step of
    its amax/127 grid) and the scales at 2e-4.  Then the reference's pools
    are copied into the port's state, so the next call reads the same pool
    values and its logits are held at 2e-4 like the f32 pool's; the f32 pool
    runs end to end."""
    if not int8:
        return
    jself = jax.device_get(jst["self"])  # stacked (layers, ...) leaves
    for layer, tc in enumerate(tst["self"]):
        for nm in ("k", "v"):
            want = np.array(jself[nm][layer])
            assert np.abs(tc[nm].numpy().astype(int) - want.astype(int)).max() <= 1
            tc[nm].copy_(torch.from_numpy(want))
            want_sc = np.array(jself[nm + "_scale"][layer])
            _close(tc[nm + "_scale"], want_sc, f"layer {layer} {nm}_scale")
            tc[nm + "_scale"].copy_(torch.from_numpy(want_sc))


def test_session_logits_match_repro():
    """``begin_sequence`` for each slot, then chunked prefill and decode
    steps through ``EncDecSession``: every position's logits and the cross
    context in the state, against repro's session, on f32 and int8 pools
    (``_pools_agree``)."""
    s = _setup()
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    slots, bs, chunk, max_len = 3, 4, 8, 32
    w = max_len // bs
    rng = np.random.default_rng(5)
    bt = rng.permutation(np.arange(1, 1 + slots * w)).reshape(slots, w).astype(np.int32)
    lens = (13, 5, 0)  # the idle third slot rides along at position -1
    frames = _frames(rng, slots, jcfg)
    toks = np.zeros((slots, 16), np.int32)
    pos = np.full((slots, 16), -1, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, jcfg.vocab_size, n)
        pos[i, :n] = np.arange(n)
    dec_toks = rng.integers(0, jcfg.vocab_size, (3, slots, 1)).astype(np.int32)
    for cache_dtype in ("float32", "int8"):
        kw = dict(slots=slots, max_len=max_len, prefill_chunk=chunk, block_size=bs,
                  cache_dtype=cache_dtype)
        jsess = jsessions.make_session(jcfg, jsessions.SessionSpec(**kw))
        tsess = tsessions.make_session(tcfg, tsessions.SessionSpec(**kw), device="cpu")
        assert tsess.needs_encoder_ctx and tsess.uses_blocks
        jpre, jdec, jbegin = jsteps.session_step_fns(jsess)
        jst = jsess.with_tables(jsess.init_state(), bt)
        tst = tsess.with_tables(tsess.init_state(), bt)
        for slot in range(slots):
            jst = jbegin(s["jparams"], jst, jnp.int32(slot), jnp.asarray(frames[slot])[None])
            tst = tsess.begin_sequence(s["tparams"], tst, slot,
                                       torch.from_numpy(frames[slot])[None])
        for nm in ("k", "v"):
            _close(tst["cross"][nm], jst["cross"][nm], f"{cache_dtype} state cross {nm}")
        for c in range(2):
            sl = slice(c * chunk, (c + 1) * chunk)
            jl, jst = jpre(s["jparams"], jst, toks[:, sl], pos[:, sl])
            tl, tst = tsess.prefill_chunk(s["tparams"], tst, torch.from_numpy(toks[:, sl]),
                                          torch.from_numpy(pos[:, sl]))
            real = pos[:, sl] >= 0
            _close(tl[torch.from_numpy(real)], np.asarray(jl)[real], f"{cache_dtype} chunk {c}")
            _pools_agree(tst, jst, cache_dtype == "int8")
        dpos = np.array([13, 5, -1], np.int32)
        for i, tok in enumerate(dec_toks):
            jl, jst = jdec(s["jparams"], jst, tok, dpos + i * (dpos >= 0))
            tl, tst = tsess.decode_step(s["tparams"], tst, torch.from_numpy(tok),
                                        torch.from_numpy(dpos + i * (dpos >= 0)))
            _close(tl[:2], np.asarray(jl)[:2], f"{cache_dtype} decode step {i}")
            _pools_agree(tst, jst, cache_dtype == "int8")


def _drive(engine, sched):
    handles, t, pending = [], 0, list(sched)
    while pending or engine.pending():
        while pending and pending[0][0] <= t:
            _, prompt, max_tokens, frames = pending.pop(0)
            handles.append(engine.submit(prompt, max_tokens=max_tokens, enc_frames=frames))
        engine.tick()
        t += 1
        assert t < 500, "scheduler stalled"
    return [h.out_tokens for h in handles]


def test_engine_tokens_match_repro_engine():
    """Greedy tokens of the port's Engine equal repro's Engine's for requests
    with their own ``enc_frames``, one without (zeros), on a pool small
    enough that the newest admission is preempted and, readmitted, replays
    its encoder pass."""
    s = _setup()
    jcfg = s["jcfg"]
    rng = np.random.default_rng(11)
    frames = _frames(rng, 4, jcfg)
    sched = [(0, [int(t) for t in rng.integers(0, 256, 9)], 10, frames[0]),
             (0, [int(t) for t in rng.integers(0, 256, 6)], 12, None),
             (1, [int(t) for t in rng.integers(0, 256, 11)], 9, frames[1]),
             (2, [int(t) for t in rng.integers(0, 256, 4)], 7, frames[2]),
             (3, [int(t) for t in rng.integers(0, 256, 7)], 8, frames[3])]
    geometry = dict(slots=3, max_len=40, block_size=4, num_blocks=14, prefill_batch=2,
                    prefill_chunk=8)
    want = _drive(JEngine(jcfg, s["jparams"], **geometry), sched)
    eng = TEngine(s["tcfg"], s["tparams"], device="cpu", **geometry)
    begun = []
    begin = eng.session.begin_sequence

    def counted(params, state, slot, enc_frames):
        begun.append(slot)
        return begin(params, state, slot, enc_frames)

    eng.session.begin_sequence = counted
    preempt = eng._preempt_newest
    preempted = []
    eng._preempt_newest = lambda: preempted.append(preempt()) or preempted[-1]
    got = _drive(eng, sched)
    assert got == want
    assert [len(t) for t in got] == [10, 12, 9, 7, 8]
    assert any(v is not None for v in preempted), "the schedule should preempt"
    assert len(begun) == len(sched) + sum(v is not None for v in preempted)
    assert eng.num_free_blocks == eng.manager.num_blocks - 1
    with pytest.raises(ValueError, match="enc_frames must be"):
        eng.submit([1, 2], enc_frames=np.zeros((3, jcfg.d_model), np.float32))


def test_params_round_trip_and_card_support():
    """``params_to_jax(params_from_jax(t))`` is ``t`` bitwise (bf16 leaves
    included) and ``specs_tree`` places a biased spec where a linear has a
    bias; a session longer than the learned positions and frames for a
    model without an encoder are refused; whisper-base's serving config
    crosses no hand-kernel limit on a CUDA device, and the encdec backend
    checks both paged kernels' head dims."""
    jcfg = get_config("whisper-base", reduced=True).replace(
        param_dtype="bfloat16", quant=QuantConfig(enabled=True, bits=4, group_size=32))
    tcfg = config_from_dict(config_to_dict(jcfg))
    tree = jax.device_get(_jax_params(jcfg, seed=4))
    back = params_to_jax(params_from_jax(tree, tcfg, device="cpu"), tcfg)
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(
        back, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert treedef_back == treedef
    for a, b in zip(flat, flat_back):
        a = np.asarray(a)
        b = b.view(torch.uint16).numpy() if b.dtype == torch.bfloat16 else b.numpy()
        assert b.shape == a.shape
        assert b.tobytes() == (a.view(np.uint16) if a.dtype.name == "bfloat16" else a).tobytes()
    params = params_from_jax(tree, tcfg, device="cpu")
    for blocks in ("enc_blocks", "dec_blocks"):  # specs_tree: a LinearSpec where a linear is
        for p, sp in zip(params[blocks], twhisper.specs_tree(tcfg)[blocks], strict=True):
            for sub in ("attn", "xattn", "mlp"):
                for nm, lin in sp.get(sub, {}).items():
                    assert ("b" in p[sub][nm]) == lin.bias, (blocks, sub, nm)
    with pytest.raises(ValueError, match="learns 128 positions"):
        tsessions.make_session(tcfg, tsessions.SessionSpec(slots=1, max_len=129), device="cpu")
    with pytest.raises(ValueError, match="has no encoder"):
        TEngine(tget("tinyllama-1.1b", reduced=True), None, slots=1, max_len=16,
                device="cpu").submit([1], enc_frames=np.zeros((16, 64), np.float32))
    cfg = serve_config_of(tget("whisper-base"))
    assert tsessions.default_backend(cfg) == "encdec"
    dispatch.check_card_support(cfg, torch.device("cuda"), "encdec")
    assert dispatch.card_limits(cfg.replace(head_dim=96), "encdec") == [
        "paged_attention (decode) takes head_dim (64, 112, 128, 256); head_dim is 96",
        "prefill_attention takes head_dim (64, 112, 128, 256); head_dim is 96"]
