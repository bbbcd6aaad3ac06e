"""The RG-LRU kernel's plan on the CPU: ``scan_rglru.rglru_chunk_plan`` (the
chunked scan over S of ``csrc/rglru_scan.cu`` in plain f32 ops, rounded as the
kernel rounds them) against ``repro.kernels.ref.rglru_scan`` and
``rglru_scan_pallas`` in interpret mode; and the fused entry's plain version
(``rg_lru_gated_plain``) against repro's ``griffin.rg_lru`` followed by the
output gate ``h·gelu_tanh(g)``.

Inputs come from seeded numpy generators.  Tolerance rtol = atol = 2e-4 in f32
(the JAX suite's own between ``ref`` and ``pallas-interpret``): the plan
reassociates the recurrence (prefix pairs within 16-step sub-chunks, a walk
of their end pairs), the reference scans associatively, the interpret kernel
in 16-step tiles.  Padding steps, idle rows and h_last are held bitwise: the
plan advances the state by one expression everywhere, and a padding step is
the identity pair.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.scan_rglru import rglru_scan_pallas
from repro.models import griffin as jgriffin
from repro.models.modules import LinearSpec
from repro_torch.kernels import dispatch
from repro_torch.kernels import scan_rglru as k

TOL = dict(rtol=2e-4, atol=2e-4)
_ref_scan = jax.jit(jref.rglru_scan)  # eager, its associative scan costs seconds a shape


def _case(s, w, seed):
    """5 slots: 0 all real, 1 idle, 2 tail-padded from s // 3, 3 with padding
    runs across a sub-chunk edge (step 16) and the panel edge (step 128), 4
    tail-padded from its last sub-chunk's middle."""
    rng = np.random.default_rng(seed)
    b = 5
    log_a = (-6.0 * rng.random((b, s, w))).astype(np.float32)
    log_a[:, :, : w // 2] *= 0.01  # half the channels with a long memory (a > 0.94)
    gx = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pos[1] = -1
    if s > 1:
        pos[2, s // 3:] = -1
        pos[3, 12:21] = -1
        pos[3, 120:140] = -1
        pos[4, max(1, s - 8):] = -1
    return log_a, gx, h0, pos


@pytest.mark.parametrize("s,w", [(1, 37), (15, 40), (16, 33), (17, 70), (37, 130), (300, 45)])
def test_chunk_plan_matches_ref_and_interpret(s, w):
    log_a, gx, h0, pos = _case(s, w, seed=s * 101 + w)
    args = [jnp.asarray(a) for a in (log_a, gx, h0, pos)]
    want = [_ref_scan(*args), rglru_scan_pallas(*args, interpret=True)]
    t = [torch.from_numpy(a) for a in (log_a, gx, h0, pos)]
    h, last = k.rglru_chunk_plan(*t)
    assert h.shape == (5, s, w) and h.dtype == last.dtype == torch.float32
    for wh, wl in want:
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)
        np.testing.assert_allclose(last.numpy(), np.asarray(wl), **TOL)
    # bitwise: the idle row is h0 throughout, h_last is the last h
    assert torch.equal(last[1], t[2][1]) and torch.equal(h[1], t[2][1].expand(s, w))
    assert torch.equal(last, h[:, -1])
    real = t[3] >= 0
    for row in range(5):  # every padding step repeats the state before it
        for step in range(1, s):
            if not real[row, step]:
                assert torch.equal(h[row, step], h[row, step - 1]), (row, step)
    # panels change nothing: the walk crosses a panel edge as it crosses a sub-chunk edge
    for panel in (16, 256):
        hp, lp = k.rglru_chunk_plan(*t, panel=panel)
        assert torch.equal(hp, h) and torch.equal(lp, last)


def test_chunk_plan_all_real_and_empty():
    """pos None (every step real) equals an all-real pos; S = 0 returns h0."""
    log_a, gx, h0, pos = _case(40, 24, seed=3)
    t = [torch.from_numpy(a) for a in (log_a, gx, h0)]
    h, last = k.rglru_chunk_plan(*t)
    hp, lp = k.rglru_chunk_plan(*t, torch.zeros(5, 40, dtype=torch.int32))
    assert torch.equal(h, hp) and torch.equal(last, lp)
    h_ref, last_ref = k.rglru_scan_plain(*t)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), **TOL)
    he, le = k.rglru_chunk_plan(t[0][:, :0], t[1][:, :0], t[2])
    assert he.shape == (5, 0, 24) and torch.equal(le, t[2])


@pytest.mark.parametrize("s", [1, 29])
def test_gated_plain_matches_repro_rg_lru(s):
    """The fused entry's plain version (gates from the gate linears' outputs,
    the scan, y = h·gelu_tanh(g)) against repro's ``griffin.rg_lru`` with
    dense f32 gate linears, then the same output gate, in f32."""
    b, w = 4, 48
    rng = np.random.default_rng(40 + s)
    u = rng.standard_normal((b, s, w)).astype(np.float32)
    g = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    lam = rng.uniform(-6.0, 2.0, w).astype(np.float32)
    lin = {nm: {"w": (rng.standard_normal((w, w)) / np.sqrt(w)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(w)).astype(np.float32)}
           for nm in ("gate_a", "gate_x")}
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pos[1] = -1
    if s > 1:
        pos[2, 11:] = -1
    spec = LinearSpec("dense", w, w, bias=True)
    jp = {nm: jax.tree.map(jnp.asarray, v) for nm, v in lin.items()} | {"lambda": jnp.asarray(lam)}
    jh, jlast = jax.jit(lambda p, u, h0, pos: jgriffin.rg_lru(
        p, {"gate_a": spec, "gate_x": spec}, u, h0, jnp.float32, positions=pos,
        scan_dtype=jnp.float32))(jp, jnp.asarray(u), jnp.asarray(h0), jnp.asarray(pos))
    want_y = np.asarray(jh * jax.nn.gelu(jnp.asarray(g), approximate=True))
    tu, tg, th0 = (torch.from_numpy(a) for a in (u, g, h0))
    ga, gxp = (dispatch.dense_linear(tu, torch.from_numpy(lin[nm]["w"]),
                                     bias=torch.from_numpy(lin[nm]["b"]))
               for nm in ("gate_a", "gate_x"))
    h_state = th0.clone()
    y, last = k.rg_lru_gated_plain(ga, gxp, tu, torch.from_numpy(lam), tg, h_state,
                                   torch.from_numpy(pos), h_out=h_state)
    assert last is h_state and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    assert torch.equal(last[1], th0[1])  # the idle row keeps h0 bitwise, in place
    via = dispatch.rg_lru_gated(ga, gxp, tu, torch.from_numpy(lam), tg, th0,
                                torch.from_numpy(pos))
    assert torch.equal(via[0], y) and torch.equal(via[1], last)
