"""The plans of two of repro_torch's Hopper kernels, emulated in plain
PyTorch on the CPU and held against repro: the paged decode attention's
split of each table across CTAs with the last arriver's in-launch merge
(``paged_attention.decode_plan`` / ``split_paged_decode``), and the wkv
prefill's chunked form on the tensor cores in 3xTF32
(``scan_wkv.wkv_chunk_plan``).

Inputs come from seeded numpy generators.  Tolerances: rtol = atol = 2e-4
in f32, the JAX suite's own; idle rows bitwise; an int8 wkv state within one
int8 step (an f32 difference in the last bits can round a value the other
way), its scale at 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.scan_wkv import wkv_scan_pallas
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import scan_wkv

TOL = dict(rtol=2e-4, atol=2e-4)


def _paged_case(seed, ctx, hkv, g, dh, int8, bs=16, w=9):
    """(q, cache, block tables, qpos) as numpy: contexts ``ctx`` (0 = an
    inactive row, qpos -1) over tables of ``w`` blocks of ``bs``."""
    rng = np.random.default_rng(seed)
    b = len(ctx)
    nb = 1 + b * w
    k = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
    cache = {"k": k, "v": v}
    if int8:
        for nm, x in (("k", k), ("v", v)):
            sc = (np.maximum(np.abs(x).max(-1), 1e-8) / np.float32(127.0)).astype(np.float32)
            cache[nm] = np.round(x / sc[..., None]).astype(np.int8)
            cache[nm + "_scale"] = sc
    bt = (rng.permutation(nb - 1)[:b * w].reshape(b, w) + 1).astype(np.int32)
    qpos = np.array([n - 1 for n in ctx], np.int32)
    q = rng.standard_normal((b, hkv * g, dh)).astype(np.float32)
    return q, cache, bt, qpos


@pytest.mark.parametrize("hkv,g,dh,int8", [(4, 1, 16, False), (2, 2, 64, True),
                                           (1, 16, 16, True), (2, 16, 64, False),
                                           (1, 8, 112, True)],
                         ids=["mha", "gqa2-int8", "gqa16-int8", "gqa16-dh64",
                              "gqa8-int8-dh112"])
def test_split_paged_decode_matches_ref_and_interpret(hkv, g, dh, int8):
    """Contexts ending mid-block (37), a single key (1), the full table
    (144), a context whose last split is partly past it (70) and an inactive
    row (0, qpos -1: zeros); the plan's own split (one of 256 here), a split
    count that does not divide the table (5 of 32: 144 = 4 x 32 + 16) and
    one that leaves whole splits past most rows' qpos (9 of 16)."""
    ctx = (37, 1, 144, 70, 0)
    q, cache, bt, qpos = _paged_case(hkv * 10 + g + dh, ctx, hkv, g, dh, int8)
    t = {nm: torch.from_numpy(a) for nm, a in cache.items()}
    tq, tbt, tqpos = torch.from_numpy(q), torch.from_numpy(bt), torch.from_numpy(qpos)
    want = pa.paged_attention_plain(tq[:, None], t, tbt, tqpos[:, None])[:, 0]
    jc = {nm: jnp.asarray(a) for nm, a in cache.items()}
    jwant = np.asarray(jref.paged_attention(jnp.asarray(q)[:, None], jc, jnp.asarray(bt),
                                            jnp.asarray(qpos)[:, None]))[:, 0]
    jint = np.asarray(paged_attention_pallas(jnp.asarray(q), jc, jnp.asarray(bt),
                                             jnp.asarray(qpos), interpret=True))
    plan = pa.decode_plan(bt.shape[1] * 16)
    for splits, kps, tile in (plan + (pa.KEY_TILE,), (5, 32, 32), (9, 16, 16)):
        got = pa.split_paged_decode(tq, t, tbt, tqpos, splits, kps, tile)
        for ref in (want.numpy(), jwant, jint):
            np.testing.assert_allclose(got.numpy(), ref, **TOL,
                                       err_msg=f"{splits} splits of {kps}")
        assert not got[-1].any()  # qpos -1: zeros


def test_decode_plan_shapes():
    """The splits cover the table exactly once, a split is a whole number of
    64-entry tiles, 256 entries a split while at most 64 splits (the merge's
    limit) cover the table.  At the serve shapes (tables of 2048): 8 splits
    of 256.  The head tile is the largest divisor of the group up to 16."""
    for entries in (2048, 192, 16, 640, 16384, 32768, 4096 + 16):
        splits, kps = pa.decode_plan(entries)
        assert splits * kps >= entries > (splits - 1) * kps
        assert kps % pa.KEY_TILE == 0 and 1 <= splits <= pa.MAX_SPLITS
        assert kps == pa.MAX_SPLIT or splits * pa.MAX_SPLIT < entries
    assert pa.decode_plan(2048) == (8, 256)
    assert pa.decode_plan(32768) == (64, 512)
    assert [pa.head_tile(g) for g in (1, 2, 10, 16, 32, 12, 17)] == [1, 2, 10, 16, 16, 12, 1]


def _wkv_case(seed, b, s, h, hd, int8=False):
    """Row 0 full, row 1 idle, row 2 with a padding run inside its first
    chunk and a padded tail; a quarter of the channels decay at w ~ 1e-3,
    below the prefill floor e^-4.9, the rest in (0.3, 1); r/k/v rounded to
    bf16 as the serve path hands them over."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, hd)
    r, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16).float().numpy() for _ in range(3))
    w = rng.uniform(0.3, 1.0, shape).astype(np.float32)
    w[..., : hd // 4] = rng.uniform(5e-4, 2e-3, shape[:-1] + (hd // 4,))
    u = (0.5 * rng.standard_normal((h, hd))).astype(np.float32)
    state0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    scale = None
    if int8:
        scale = (np.maximum(np.abs(state0).max(axis=(-2, -1)), 1e-8) / 127.0).astype(np.float32)
        state0 = np.round(state0 / scale[..., None, None]).astype(np.int8)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1)) + 7
    pos[1] = -1
    pos[2, 3:9] = -1
    pos[2, s - 4:] = -1
    return dict(r=r, k=k, v=v, w=w, u=u, state0=state0, pos=pos, state_scale=scale)


def _jax_wkv(c):
    args = [jnp.asarray(c[n]) for n in ("r", "k", "v", "w", "u", "state0", "pos")]
    sc = None if c["state_scale"] is None else jnp.asarray(c["state_scale"])
    return (jref.wkv_scan(*args, state_scale=sc),
            wkv_scan_pallas(*args, state_scale=sc, interpret=True))


@pytest.mark.parametrize("s,hd,int8", [(17, 16, False), (37, 32, False), (37, 32, True),
                                       (17, 64, True)])
def test_wkv_chunk_plan_matches_ref_and_interpret(s, hd, int8):
    """The 3xTF32 chunk plan against the reference and the Pallas kernel: y
    and the state at 2e-4, the idle row's state (and scale) bitwise; int8
    payload within one step."""
    c = _wkv_case(s * 3 + hd, 3, s, 2, hd, int8)
    t = {n: None if a is None else torch.from_numpy(a) for n, a in c.items()}
    args = [t[n] for n in ("r", "k", "v", "w", "u", "state0", "pos")]
    y, st, sc = scan_wkv.wkv_chunk_plan(*args, state_scale=t["state_scale"])
    for want_y, want_st, want_sc in _jax_wkv(c):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        if int8:
            assert np.abs(st.numpy().astype(int) - np.asarray(want_st).astype(int)).max() <= 1
            np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), **TOL)
        else:
            np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **TOL)
    assert torch.equal(st[1], t["state0"][1])
    if int8:
        assert torch.equal(sc[1], t["state_scale"][1])


def test_tf32_rounding_and_one_pass_misses_the_card_tolerance():
    """``tf32_round`` is cvt.rna.tf32.f32 (the low 13 mantissa bits rounded
    off, ties away from zero); with one TF32 pass instead of three, y misses
    the card's 1e-4 of max|y|, which the 3xTF32 plan meets."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 3.0])
    assert scan_wkv.tf32_round(x).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0]
    c = _wkv_case(5, 3, 64, 2, 64)
    t = {n: None if a is None else torch.from_numpy(a) for n, a in c.items()}
    args = [t[n] for n in ("r", "k", "v", "w", "u", "state0", "pos")]
    want, _, _ = scan_wkv.wkv_scan_plain(*args)
    y3, _, _ = scan_wkv.wkv_chunk_plan(*args)
    scale = want.abs().max()
    assert (y3 - want).abs().max() <= 1e-4 * scale
    three = scan_wkv.mm_3xtf32
    try:
        scan_wkv.mm_3xtf32 = lambda a, b: scan_wkv.tf32_round(a) @ scan_wkv.tf32_round(b)
        y1, _, _ = scan_wkv.wkv_chunk_plan(*args)
    finally:
        scan_wkv.mm_3xtf32 = three
    assert (y1 - want).abs().max() > 1e-4 * scale
