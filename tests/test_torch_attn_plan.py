"""The plan of the bf16 flash tile that both prefill attention layouts run on
the card (``csrc/flash_attention.cuh`` tc_kernel), on the CPU.

The kernel cannot run here, so its plan is held as plain functions of
``repro_torch.kernels.prefill_attention`` against ``repro``:

(a) ``visible_tiles`` never drops a 64-entry tile that holds a key visible
    to one of a CTA's rows, where visibility is ``repro.kernels.ref``'s own
    element mask (read out of ``ref.ring_attention`` / ``ref.paged_attention``
    with zero queries and one-hot values: each row then returns the mean of
    the one-hot rows of the keys it sees);
(b) ``row_map`` packs every (query, head) pair into exactly one row;
(c) ``tile_walk_attention``, the tile's loop in float32 (the kept tiles in
    order, an online softmax, fully masked rows at 0), matches
    ``ref.ring_attention`` / ``ref.paged_attention`` and the
    ``pallas-interpret`` kernel at rtol = atol = 2e-4 (the JAX suite's own
    ref-vs-kernel tolerance).

Inputs come from seeded numpy generators.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro_torch.kernels import prefill_attention as pf

TOL = dict(rtol=2e-4, atol=2e-4)


def _ring(rng, wr, ctx, sq, *, hole=None):
    """kpos (B, wr) of rings holding each context's last wr positions in
    ring order (entry p % wr) and qpos (B, sq) of the chunk ending there
    (shorter chunks tail-padded with -1); ``hole`` empties a span of
    entries of the first ring."""
    b = len(ctx)
    kpos = np.full((b, wr), -1, np.int32)
    qpos = np.full((b, sq), -1, np.int32)
    for i, n in enumerate(ctx):
        p = np.arange(max(0, n - wr), n)
        kpos[i, p % wr] = p
        m = min(n, sq)
        qpos[i, :m] = np.arange(n - m, n)
    if hole is not None:
        kpos[0, hole[0]:hole[1]] = -1
    qpos[qpos >= 0] = np.where(rng.random(int((qpos >= 0).sum())) < 0.1, -1, qpos[qpos >= 0])
    return kpos, qpos


def _paged(rng, kv, bs, nb_extra=3):
    """A pool (NB, bs, Hkv, Dh) holding kv (B, K, Hkv, Dh) through a shuffled
    block table, entry e of sequence b = its position e."""
    b, n, hkv, dh = kv[0].shape
    w = -(-n // bs)
    nb = 1 + b * w + nb_extra
    ids = rng.permutation(np.arange(1, nb))[:b * w].reshape(b, w).astype(np.int32)
    pools = []
    for x in kv:
        pool = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
        pad = np.zeros((b, w * bs, hkv, dh), np.float32)
        pad[:, :n] = x
        pool[ids] = pad.reshape(b, w, bs, hkv, dh)
        pools.append(pool)
    return pools, ids


def _ref_mask(kpos, qpos, window, layout):
    """(B, Sq, K) bool: ref's element mask, read out of its attention."""
    b, sq = qpos.shape
    n = kpos.shape[1]
    q = jnp.zeros((b, sq, 1, n), jnp.float32)
    onehot = np.broadcast_to(np.eye(n, dtype=np.float32)[None, :, None], (b, n, 1, n))
    if layout == "ring":
        o = jref.ring_attention(q, jnp.asarray(onehot), jnp.asarray(onehot), jnp.asarray(qpos),
                                jnp.asarray(kpos), window=window)
    else:
        (kp, vp), bt = _paged(np.random.default_rng(0), (onehot, onehot), 16)
        o = jref.paged_attention(q, {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
                                 jnp.asarray(bt), jnp.asarray(qpos), window=window)
    return np.asarray(o)[:, :, 0] > 0


@pytest.mark.parametrize("layout,wr,ctx,sq,g,window,hole", [
    ("ring", 320, (1000, 150, 0, 700), 40, 10, 0, (64, 192)),  # wrapped, interior hole, idle
    ("ring", 320, (1000, 330, 90), 70, 1, 100, None),    # window edges inside tiles
    ("ring", 200, (460, 47), 25, 16, 37, (100, 110)),
    ("paged", 384, (380, 100, 0), 70, 1, 0, None),
    ("paged", 384, (380, 260), 70, 10, 90, None),         # window: tiles behind it dropped
])
def test_visible_tiles_keep_every_visible_key(layout, wr, ctx, sq, g, window, hole):
    rng = np.random.default_rng(wr + sq + window)
    kpos, qpos = _ring(rng, wr, ctx, sq, hole=hole)
    if layout == "paged":
        kpos = np.broadcast_to(np.arange(wr, dtype=np.int32), kpos.shape).copy()
    mask = _ref_mask(kpos, qpos, window, layout)
    gt, qt = pf.row_plan(g)
    skipped = 0
    for b in range(len(ctx)):
        for q0 in range(0, sq, qt):
            rows = qpos[b, q0:q0 + qt]
            tiles = pf.visible_tiles(rows, None if layout == "paged" else kpos[b],
                                     window=window)
            seen = mask[b, q0:q0 + qt].any(0)  # entries some row of the CTA sees
            need = sorted({int(e) // pf.KEY_TILE for e in np.nonzero(seen)[0]})
            assert set(need) <= set(tiles), (b, q0, need, tiles)
            if (rows < 0).all():
                assert tiles == []
            skipped += -(-wr // pf.KEY_TILE) - len(tiles)
    assert skipped > 0  # the rule does skip tiles in every case


@pytest.mark.parametrize("g", [1, 10, 16])
@pytest.mark.parametrize("sq", [1, 70, 256])
def test_row_map_covers_each_query_head_once(g, sq):
    hkv = 2
    rows = pf.row_map(sq, hkv * g, hkv)
    gt, qt = pf.row_plan(g)
    assert gt * qt <= pf.ROW_TILE and g % gt == 0
    live = rows[(rows >= 0).all(-1)]
    pairs = live[:, 0] * (hkv * g) + live[:, 1]
    assert pairs.numel() == sq * hkv * g
    assert torch.equal(pairs.sort().values, torch.arange(sq * hkv * g))
    for cta in rows:  # a CTA's rows share one kv head
        heads = cta[(cta >= 0).all(-1)][:, 1]
        assert heads.numel() == 0 or (heads // g).unique().numel() == 1


def _quantize(x):
    sc = np.maximum(np.abs(x).max(-1), 1e-8).astype(np.float32) / np.float32(127.0)
    return np.round(x / sc[..., None]).astype(np.int8), sc


@pytest.mark.parametrize("layout,wr,ctx,sq,hkv,g,window,int8", [
    ("ring", 200, (460, 150, 0), 20, 2, 4, 0, False),
    ("ring", 160, (400, 37), 12, 1, 10, 50, True),
    ("paged", 160, (150, 60, 0), 20, 2, 4, 0, False),
    ("paged", 160, (140, 90), 12, 1, 10, 40, False),
])
def test_tile_walk_matches_ref_and_interpret(layout, wr, ctx, sq, hkv, g, window, int8):
    _tile_walk_case(layout, wr, ctx, sq, hkv, g, window, int8)


@pytest.mark.parametrize("ctx,sq", [((140, 90, 0), 20), ((150, 37), 12)])
def test_tile_walk_at_head_dim_112(ctx, sq):
    """kimi-k2-1t-a32b's head dim (112: seven 16-wide k-steps and n-tiles)
    and GQA group (8) over the paged layout, contexts not a multiple of the
    64-entry key tile."""
    _tile_walk_case("paged", 160, ctx, sq, 1, 8, 0, False, dh=112)


def _tile_walk_case(layout, wr, ctx, sq, hkv, g, window, int8, dh=16):
    """``tile_walk_attention`` against ``ref`` and ``pallas-interpret`` on
    seeded inputs of one layout."""
    rng = np.random.default_rng(wr * 7 + sq + window)
    kpos, qpos = _ring(rng, wr, ctx, sq)
    b = len(ctx)
    q = rng.standard_normal((b, sq, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, wr, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, wr, hkv, dh)).astype(np.float32)
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
    tq, tqpos = torch.from_numpy(q), torch.from_numpy(qpos)
    if layout == "ring":
        kw = dict(window=window, k_scale=None if ks is None else jnp.asarray(ks),
                  v_scale=None if vs is None else jnp.asarray(vs))
        j = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
        want = jref.ring_attention(*j, **kw)
        interp = jdispatch.prefill_attention(j[0], j[3], k=j[1], v=j[2], kpos=j[4],
                                             backend="pallas-interpret", **kw)
        got = pf.tile_walk_attention(
            tq, torch.from_numpy(k), torch.from_numpy(v), tqpos, torch.from_numpy(kpos),
            window=window, k_scale=None if ks is None else torch.from_numpy(ks),
            v_scale=None if vs is None else torch.from_numpy(vs))
    else:
        (kp, vp), bt = _paged(rng, (k, v), 16)
        cache = {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}
        j = [jnp.asarray(a) for a in (q, qpos, bt)]
        want = jref.paged_attention(j[0], cache, j[2], j[1], window=window)
        interp = jdispatch.prefill_attention(j[0], j[1], cache=cache, block_tables=j[2],
                                             window=window, backend="pallas-interpret")
        got = pf.tile_walk_attention(tq, torch.from_numpy(kp[bt].reshape(b, -1, hkv, dh)),
                                     torch.from_numpy(vp[bt].reshape(b, -1, hkv, dh)), tqpos,
                                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), **TOL)
    assert not got.numpy()[qpos < 0].any()
