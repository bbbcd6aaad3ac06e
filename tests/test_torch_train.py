"""repro_torch's training (``optim``, ``train``, ``data``, the
``AsyncCheckpointer``, remat, the tt_linear backward) against ``repro``'s
on the CPU.

The same seeded numpy inputs go through both packages: ``warmup_cosine`` at
1e-7; ``apply_optimizer`` (AdamW and Adafactor; factored and unfactored
leaves; the clip active) at 1e-6; ``chunked_cross_entropy`` (chunks and the
fallback, a z term) and its grads at 2e-4; the data sources bitwise; one
``train_step`` of reduced tinyllama-1.1b at f32 with one and two
microbatches — loss, grad_norm, every updated param and every
optimizer-state leaf — at 2e-4 (the ``ref`` / ``pallas-interpret``
tolerance, ``tests/test_dispatch.py``); ``loss_fn``'s grads of the other
families at 2e-4.  The port alone: remat none, full and dots give equal
grads; the tt_linear backward's own code (the transposed train, the cores'
GEMMs, the epilogue's grads), run with the plain contraction in the
kernel's place, against autograd of ``tt_linear_ref``; checkpoints both
ways; the ``Trainer``'s fault injection, straggler watchdog and resume.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_params

from repro.checkpoint import store as jstore
from repro.config import TrainConfig as JTrainConfig
from repro.config import config_to_dict
from repro.configs import get_config as jget
from repro.data import pipeline as jdata
from repro.models import build_model as jbuild
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import losses as jlosses
from repro.train import step as jstep
from repro_torch import data as tdata
from repro_torch.checkpoint import store as tstore
from repro_torch.config import TrainConfig, config_from_dict
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.ttd import TTSpec
from repro_torch.kernels import tt_linear as tk
from repro_torch.models import build_model
from repro_torch.optim import apply_optimizer, init_optimizer, warmup_cosine
from repro_torch.train import Trainer, build_train_step, chunked_cross_entropy, loss_fn
from repro_torch.train.step import TrainState
from repro_torch.tree import flatten_with_paths

TOL = dict(rtol=2e-4, atol=2e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got: dict, want: dict, tol, what=""):
    assert sorted(got) == sorted(want), what
    for name in want:
        np.testing.assert_allclose(_np(got[name]), np.asarray(want[name], np.float32),
                                   err_msg=f"{what} {name}", **tol)


def test_warmup_cosine():
    for lr, warm, total in ((3e-4, 100, 10000), (1e-2, 5, 60), (1.0, 0, 3)):
        js, ts = jsched.warmup_cosine(lr, warm, total), warmup_cosine(lr, warm, total)
        for step in (0, 1, 4, 5, 6, 30, 59, 60, 200, 20000):
            want = float(js(jnp.int32(step)))
            got = float(ts(torch.tensor(step, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=1e-7, abs=1e-7), (lr, warm, step)


def test_apply_optimizer():
    """Two updates of each optimizer on leaves factored (last two dims >= 8)
    and not, the global-norm clip active (norm ~ 40 against 1.0), weight
    decay on."""
    rng = np.random.default_rng(3)
    shapes = {"a": (16, 12), "b": {"c": (5,), "d": (3, 4)}, "e": [(2, 8, 9), (9, 7)]}

    def tree(fn):
        return {"a": fn(shapes["a"]), "b": {k: fn(v) for k, v in shapes["b"].items()},
                "e": [fn(s) for s in shapes["e"]]}

    p0 = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: (4 * rng.standard_normal(s)).astype(np.float32)) for _ in range(2)]
    for kind in ("adamw", "adafactor"):
        jp = jax.tree.map(jnp.asarray, p0)
        js = jopt.init_optimizer(kind, jp)
        tp = jax.tree.map(torch.from_numpy, p0)
        ts = init_optimizer(kind, tp)
        for i, g in enumerate(grads):
            lr = 1e-2 * (i + 1)
            kw = dict(weight_decay=0.1, grad_clip=1.0)
            jp, js, jm = jopt.apply_optimizer(js, jp, jax.tree.map(jnp.asarray, g),
                                              jnp.float32(lr), **kw)
            tp, ts, tm = apply_optimizer(ts, tp, jax.tree.map(torch.from_numpy, g),
                                         torch.tensor(lr, dtype=torch.float32), **kw)
            assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
            assert float(jm["grad_norm"]) > 10  # the clip is active
            _close(dict(flatten_with_paths(tp)), dict(jstore._flatten_with_paths(jp)),
                   OPT_TOL, f"{kind} step {i} params")
            _close(dict(flatten_with_paths(ts.inner)), dict(jstore._flatten_with_paths(js.inner)),
                   OPT_TOL, f"{kind} step {i} state")
            assert int(ts.step) == int(js.step)
        if kind == "adafactor":
            assert set(ts.inner["a"]) == {"vr", "vc"} and set(ts.inner["b"]["c"]) == {"v"}
            assert set(ts.inner["e"][1]) == {"v"}  # last dim 7 < 8


def test_chunked_cross_entropy():
    """Two chunks (each under checkpoint) and the fallback (S % chunk),
    with a z term and masked positions: loss, metrics, grads for hidden and
    head."""
    rng = np.random.default_rng(5)
    b, s, d, v = 2, 12, 16, 40
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (rng.standard_normal((d, v)) / 4).astype(np.float32)
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    for chunk in (6, 5):
        def jloss(h, w, chunk=chunk):
            return jlosses.chunked_cross_entropy(h, w, jnp.asarray(targets), jnp.asarray(mask),
                                                 chunk=chunk, z_coef=1e-3)

        (jl, jm), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(hidden), jnp.asarray(head))
        th = torch.from_numpy(hidden).requires_grad_()
        tw = torch.from_numpy(head).requires_grad_()
        tl, tm = chunked_cross_entropy(th, tw, torch.from_numpy(targets),
                                       torch.from_numpy(mask), chunk=chunk, z_coef=1e-3)
        tgh, tgw = torch.autograd.grad(tl, (th, tw))
        _close({"loss": tl, **tm, "d hidden": tgh, "d head": tgw},
               {"loss": jl, **jm, "d hidden": jgh, "d head": jgw}, TOL, f"chunk {chunk}")


def test_data_batches_bitwise():
    for kind in ("synthetic", "packed"):
        for seed in (0, 7):
            jc = jdata.DataConfig(vocab_size=97, seq_len=24, global_batch=3, seed=seed, kind=kind)
            tc = tdata.DataConfig(vocab_size=97, seq_len=24, global_batch=3, seed=seed, kind=kind)
            js, ts = jdata.make_source(jc), tdata.make_source(tc)
            for step in (0, 1, 17):
                want, got = js.batch(step), ts.batch(step)
                for k in want:
                    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            jb, tb = jdata.make_batches(jc, 5), tdata.make_batches(tc, 5)
            for _ in range(2):
                assert all(np.array_equal(a, b) for a, b in zip(next(jb).values(),
                                                                next(tb).values()))


_TINY = {}


def _tiny(optimizer="adamw", microbatches=1, remat="none"):
    """(jcfg, tcfg, repro params (numpy-seeded), port params, repro and
    port TrainConfigs, a batch) for reduced tinyllama-1.1b at f32."""
    if "base" not in _TINY:
        jcfg = jget("tinyllama-1.1b", reduced=True).replace(compute_dtype="float32",
                                                            param_dtype="float32")
        tcfg = config_from_dict(config_to_dict(jcfg))
        jp = jax_params(jcfg, seed=1)
        dc = jdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4, seed=0)
        _TINY["base"] = (jcfg, tcfg, jp, jdata.make_source(dc).batch(3))
    jcfg, tcfg, jp, batch = _TINY["base"]
    kw = dict(global_batch=4, seq_len=32, lr=3e-3, warmup_steps=5, total_steps=60,
              optimizer=optimizer, microbatches=microbatches, remat=remat)
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp, JTrainConfig(**kw), TrainConfig(**kw), batch


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_repro(microbatches):
    """One step of reduced tinyllama at f32 from a state one step in (so the
    optimizer state is not zero): loss, grad_norm, lr, every updated param
    and every optimizer-state leaf (names as the reference's checkpoint
    gives them) at 2e-4; AdamW with one microbatch, Adafactor with two."""
    kind = "adamw" if microbatches == 1 else "adafactor"
    jcfg, tcfg, jp, tp, jtc, ttc, batch = _tiny(kind, microbatches)
    jstate = jstep.TrainState(jp, jopt.init_optimizer(kind, jp), jnp.zeros((), jnp.int32))
    tstate = TrainState(tp, init_optimizer(kind, tp), torch.zeros((), dtype=torch.int32),
                        cfg=tcfg)
    jfn = jax.jit(jstep.build_train_step(jbuild(jcfg), jtc))
    tfn = build_train_step(build_model(tcfg), ttc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, jm = jfn(jstate, jb)
        tstate, tm = tfn(tstate, tb)
        _close({k: tm[k] for k in jm}, dict(jm), TOL, "metrics")
    want = dict(jstore._flatten_with_paths(jax.device_get(jstate)))
    got = dict(flatten_with_paths(tstate.checkpoint_tree("cpu")))
    assert sorted(got) == sorted(want)
    assert any("/mu/" in n or "/vr" in n for n in want)
    _close(got, want, TOL, "state")


def test_remat_policies_equal_grads():
    """loss_fn's grads under remat none, full and dots are bitwise equal on
    the CPU (the recomputed forward runs the same ops)."""
    _, tcfg, _, tp, _, ttc, batch = _tiny()
    model = build_model(tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [p for _, p in flatten_with_paths(tp)]
    out = {}
    for remat in ("none", "full", "dots"):
        live = [p.detach().requires_grad_() for p in leaves]
        tree = tstore._unflatten(tp, live)
        loss, _ = loss_fn(model, tree, tb, dataclasses.replace(ttc, remat=remat))
        out[remat] = (loss, torch.autograd.grad(loss, live))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1])), remat


def test_other_families_loss_grads():
    """loss_fn's loss and grads of reduced recurrentgemma-2b, rwkv6-7b,
    mixtral-8x22b and whisper-base (f32, remat full) against repro's."""
    for arch in ("recurrentgemma-2b", "rwkv6-7b", "mixtral-8x22b", "whisper-base"):
        jcfg = jget(arch, reduced=True).replace(compute_dtype="float32", param_dtype="float32")
        tcfg = config_from_dict(config_to_dict(jcfg))
        jp = jax_params(jcfg, seed=2)
        tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
        batch = jdata.make_source(jdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                                   global_batch=2, seed=4)).batch(0)
        kw = dict(global_batch=2, seq_len=16, remat="full")
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jstep.loss_fn(jbuild(jcfg), p, b, JTrainConfig(**kw)), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        leaves = [p for _, p in flatten_with_paths(tp)]
        live = [p.detach().requires_grad_() for p in leaves]
        tl, _ = loss_fn(build_model(tcfg), tstore._unflatten(tp, live),
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        TrainConfig(**kw))
        tg = torch.autograd.grad(tl, live, allow_unused=True)
        tg = [torch.zeros_like(p) if g is None else g for g, p in zip(tg, leaves)]
        got = dict(flatten_with_paths(params_to_jax(tstore._unflatten(tp, tg), tcfg)))
        _close({"loss": tl, **got}, {"loss": jl, **dict(jstore._flatten_with_paths(jg))},
               TOL, arch)


# The served specs' shapes (tinyllama's attn_o, gate/up and down at rank 16,
# llama2's attn_o) and d = 3 with a one-core half (whisper-base's).
_SPECS = [TTSpec.make(2048, 2048, 16), TTSpec.make(2048, 5632, 16), TTSpec.make(5632, 2048, 16),
          TTSpec.make(4096, 4096, 16), TTSpec.make(512, 2048, 16, d=3)]


def test_transposed_train():
    """tt_linear_ref on the transposed train is dz @ Wᵀ (W reconstructed),
    to f32 rounding (the plain version's products are f32)."""
    rng = np.random.default_rng(8)
    for spec in _SPECS:
        cores = [torch.from_numpy(rng.standard_normal(s) / np.sqrt(s[0])) for s in
                 spec.core_matrix_shapes()]
        w = tk.tt_linear_ref(torch.eye(spec.n_in, dtype=torch.float64), cores, spec)
        cores_t, spec_t = tk.transpose_train(cores, spec)
        assert spec_t.in_modes == spec.out_modes and spec_t.out_modes == spec.in_modes
        assert [tuple(c.shape) for c in cores_t] == spec_t.core_matrix_shapes()
        dz = torch.from_numpy(rng.standard_normal((3, spec.n_out)))
        want = dz @ w.T.to(torch.float64)  # the plain version multiplies in f32
        torch.testing.assert_close(tk.tt_linear_ref(dz, cores_t, spec_t).to(torch.float64),
                                   want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_backward_against_autograd():
    """tt_linear_backward (the epilogue's grads, the cores' GEMMs over the
    stage intermediates, dx on the transposed train), with the plain
    contraction in the kernel's place, against autograd of tt_linear_ref in
    f32 for the served specs, every activation, with and without scale,
    bias and residual; one row chunk and several (GRAD_CHUNK_ELEMS cut)."""
    rng = np.random.default_rng(9)
    plain = lambda x, cores, spec, what: tk.tt_linear_ref(x, cores, spec)  # noqa: E731
    acts = [None, *sorted(a for a in tk.ACT_CODES if a)]
    for i, spec in enumerate(_SPECS):
        b = 3
        cores = [torch.from_numpy(rng.standard_normal(s) / np.sqrt(s[0])).float()
                 for s in spec.core_matrix_shapes()]
        x = torch.from_numpy(rng.standard_normal((b, 1, spec.n_in))).float()
        for j, act in enumerate(acts if i == 0 else [None, "silu", acts[1 + i]]):
            full = (i + j) % 2 == 0
            epi = dict(scale=torch.from_numpy(rng.uniform(0.5, 1.5, spec.n_out)).float(),
                       bias=torch.from_numpy(0.1 * rng.standard_normal(spec.n_out)).float(),
                       residual=torch.from_numpy(
                           rng.standard_normal((b, 1, spec.n_out))).float()) if full else {}
            ins = [x, *cores, *epi.values()]
            live = [t.clone().requires_grad_() for t in ins]
            kw = dict(zip(epi, live[1 + spec.d:]))
            y = tk.tt_linear_ref(live[0], live[1:1 + spec.d], spec, activation=act, **kw)
            dy = torch.from_numpy(rng.standard_normal(y.shape)).float()
            want = torch.autograd.grad(y, live, dy)
            chunk = tk.GRAD_CHUNK_ELEMS
            tk.GRAD_CHUNK_ELEMS = 1 if j % 2 else chunk  # one row a chunk
            try:
                dx, dcores, dscale, dbias, dres = tk.tt_linear_backward(
                    dy, x, cores, spec, plain, scale=epi.get("scale"), bias=epi.get("bias"),
                    residual=full, activation=act)
            finally:
                tk.GRAD_CHUNK_ELEMS = chunk
            got = [dx, *dcores] + ([dscale, dbias, dres] if full else [])
            for name, g, w in zip(["x"] + [f"core {k}" for k in range(spec.d)]
                                  + ["scale", "bias", "residual"], got, want):
                assert g.dtype == w.dtype and g.shape == w.shape, name
                torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4 * w.abs().max().item(),
                                           msg=f"{spec.in_modes} {act} {name}")


def test_checkpoints_both_ways(tmp_path):
    """repro's AsyncCheckpointer saves a TrainState (AdamW, one step in); the
    port restores it bitwise and its next step's loss equals repro's; the
    port's AsyncCheckpointer saves its state and repro restores it bitwise
    (Adafactor, whose leaves are vr/vc/v)."""
    for kind, saver in (("adamw", "repro"), ("adafactor", "port")):
        jcfg, tcfg, jp, tp, jtc, ttc, batch = _tiny(kind)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jfn = jax.jit(jstep.build_train_step(jbuild(jcfg), jtc))
        tfn = build_train_step(build_model(tcfg), ttc)
        jstate, _ = jfn(jstep.TrainState(jp, jopt.init_optimizer(kind, jp),
                                         jnp.zeros((), jnp.int32)), jb)
        tstate, _ = tfn(TrainState(tp, init_optimizer(kind, tp),
                                   torch.zeros((), dtype=torch.int32), cfg=tcfg), tb)
        d = tmp_path / saver
        if saver == "repro":
            ck = jstore.AsyncCheckpointer(d, every=1)
            ck.maybe_save(1, jstate)
            ck.wait()
            restored, _ = tstore.restore_checkpoint(d, 1, tstate)
            assert isinstance(restored, TrainState) and restored.opt.kind == kind
            want = dict(jstore._flatten_with_paths(jax.device_get(jstate)))
            got = dict(flatten_with_paths(restored.checkpoint_tree("cpu")))
            _, jm = jfn(jstate, jb)
            _, tm = tfn(restored, tb)
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-4, abs=2e-4)
        else:
            ck = tstore.AsyncCheckpointer(d, every=1)
            ck.maybe_save(1, tstate)
            ck.wait()
            restored, _ = jstore.restore_checkpoint(d, 1, jstate)
            want = dict(flatten_with_paths(tstate.checkpoint_tree("cpu")))
            got = dict(jstore._flatten_with_paths(jax.device_get(restored)))
            assert any(n.endswith("/vr") for n in want)
        assert sorted(got) == sorted(want)
        for n in want:
            a, w = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                    for t in (got[n], want[n]))
            assert a.dtype == w.dtype and np.array_equal(a, w), n


def test_trainer_fault_straggler_resume(tmp_path):
    """The Trainer on reduced tinyllama at f32: a fault injected at step 12
    restores the async checkpoint of step 10 and all 20 steps are done
    (steps 10 and 11 twice, so the counter ends at 18, force-saved); a
    non-finite loss counts as a failure; a slow step fires the watchdog;
    a new Trainer resumes from the checkpoint directory; obs counters."""
    from repro_torch.obs import ObsConfig
    _, tcfg, _, tp, _, ttc, _ = _tiny()
    model = build_model(tcfg)
    tfn = build_train_step(model, ttc)
    dc = tdata.DataConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4, seed=0)
    state = TrainState(tp, init_optimizer("adamw", tp), torch.zeros((), dtype=torch.int32),
                       cfg=tcfg)
    boom = {"armed": True}

    def injector(s):
        if s == 12 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    tr = Trainer(tfn, state, dc, ckpt_dir=tmp_path / "a", ckpt_every=5, max_retries=3,
                 obs=ObsConfig())
    rep = tr.run(20, log_every=0, fault_injector=injector)
    assert rep.restarts == 1 and rep.steps_done == 20 and np.isfinite(rep.losses).all()
    assert tr.current_step() == 18 and tr.ckpt.saved_steps[-1] == 18
    reg = tr.obs.registry
    assert reg.counter("train_steps_total").value == 20
    assert reg.counter("train_restarts_total").value == 1

    def nan_step(st, b):
        new, m = tfn(st, b)
        return new, {**m, "loss": torch.tensor(float("nan"))}

    with pytest.raises(FloatingPointError):
        Trainer(nan_step, state, dc, max_retries=1).run(1, log_every=0)

    events = []

    def slow(s):
        if s == 8:
            time.sleep(1.0)

    Trainer(tfn, state, dc, straggler_factor=2.5,
            on_straggler=lambda s, dt, med: events.append(s)).run(10, log_every=0,
                                                                  fault_injector=slow)
    assert 8 in events

    tr2 = Trainer(tfn, state, dc, ckpt_dir=tmp_path / "a", ckpt_every=5)
    assert tr2._restore_latest() and tr2.current_step() == 18
    for (n, a), (_, b) in zip(flatten_with_paths(tr2.state.params),
                              flatten_with_paths(tr.state.params)):
        assert torch.equal(a, b), n
    assert tr2.run(5, log_every=0).steps_done == 5 and tr2.current_step() == 23
