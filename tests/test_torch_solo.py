"""repro_torch's single-sequence model surface (``models/api.py`` ``Model``:
``forward``, ``init_cache``, ``prefill``, ``decode_step``) against ``repro``'s,
and the port's Engine against it.

The reduced configs of every family (``tests/test_models.py``'s
``FAMILIES``) in f32, with params drawn from a numpy seed
(``torch_parity.jax_params``) and carried across with ``params_from_jax``:
``forward``'s hidden and aux, ``prefill``'s logits and every cache leaf, and
three chained ``decode_step``s' logits and caches are held at rtol = atol =
2e-4.  qwen2-vl takes M-RoPE positions whose three planes differ (text, an
image block, text; Qwen2-VL §2.1).  The blocked branch of
``flash_attention`` is held with padding on both sides, a window and a key
mask.  The port's Engine, on every family backend, must give each request
the greedy tokens the port's solo reference gives it alone (the schedules of
``tests/test_serve_fuzz.py``, its seeds that once crashed workers among
them), and the port's solo tokens must equal ``repro``'s.
"""
import dataclasses
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import _fill, jax_params

from repro.config import config_to_dict
from repro.configs import get_config
from repro.models import build_model as jbuild
from repro.models import modules as jmodules
from repro.models import rwkv as jrwkv
from repro.models import whisper as jwhisper
from repro_torch.config import config_from_dict
from repro_torch.convert import params_from_jax
from repro_torch.models import Model, build_model
from repro_torch.models import api as tapi
from repro_torch.models import modules as tmodules
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import blocks_for

TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN = 96
_MAX_NEW = 6
_PAIRS: dict = {}


def mrope_positions(n_text: int, grid: tuple[int, int], n_after: int, b: int = 1):
    """(3, b, S) M-RoPE position ids of ``n_text`` text tokens, an image block
    of ``grid`` (rows, cols) patches and ``n_after`` text tokens (Qwen2-VL
    §2.1): text at t = h = w = i; patch (r, c) at (p, p + r, p + c) with p
    the text prefix length; the text after resumes at the largest id + 1."""
    rows, cols = grid
    t = list(range(n_text))
    h, w = list(t), list(t)
    for r in range(rows):
        for c in range(cols):
            t.append(n_text)
            h.append(n_text + r)
            w.append(n_text + c)
    nxt = max(max(t), max(h), max(w)) + 1
    for i in range(n_after):
        for plane in (t, h, w):
            plane.append(nxt + i)
    pos = np.array([t, h, w], np.int32)[:, None]
    return np.repeat(pos, b, axis=1)


def _whisper_params(cfg, seed):
    shapes = jax.eval_shape(partial(jwhisper.init_lm, cfg=cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        keys = [str(p.key) for p in path if hasattr(p, "key")]
        x = np.asarray(_fill(keys[-1], "cores" in keys, leaf.shape, cfg, rng))
        out.append(jnp.asarray(x if x.dtype == np.uint8 else x.astype(np.float32), leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def _pair(arch, **replace):
    """(jcfg, tcfg, jax params, port params, repro's Model with jitted calls,
    the port's Model) for a reduced config in f32, cached."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _PAIRS:
        jcfg = get_config(arch, reduced=True).replace(compute_dtype="float32",
                                                      param_dtype="float32", **replace)
        tcfg = config_from_dict(config_to_dict(jcfg))
        jp = _whisper_params(jcfg, 0) if jcfg.family == "encdec" else jax_params(jcfg, 0)
        tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
        jm = jbuild(jcfg)
        jm = jm.__class__(**{**jm.__dict__, "forward": jax.jit(jm.forward),
                             "prefill": jax.jit(jm.prefill,
                                                static_argnames=("cache_dtype", "max_len")),
                             "decode_step": jax.jit(jm.decode_step)})
        _PAIRS[key] = (jcfg, tcfg, jp, tp, jm, build_model(tcfg))
    return _PAIRS[key]


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def _stacked_leaf(items):
    """Per-layer trees of one structure -> one tree of leaves stacked along a
    leading layer axis, as numpy (``repro``'s layout)."""
    if isinstance(items[0], dict):
        return {k: _stacked_leaf([t[k] for t in items]) for k in items[0]}
    return np.stack([_np(t) for t in items])


def _np(t):
    return t.detach().numpy()


def _port_cache(cfg, cache):
    """The port's cache laid out as ``repro``'s for ``cfg``'s family."""
    if cfg.family in ("dense", "moe"):
        return [_stacked_leaf(seg) for seg in cache]  # a list of segments
    if cfg.family == "griffin":
        out = {"tail": [_tree_np(st) for st in cache["tail"]]}
        if cache["groups"]:
            out["groups"] = _stacked_leaf(cache["groups"])
        return out
    if cfg.family == "rwkv":
        return _stacked_leaf(cache)
    return {k: _stacked_leaf(v) for k, v in cache.items()}  # whisper: self, cross


def _close_trees(got, want, what):
    leaves_g, tree_g = jax.tree_util.tree_flatten(got)
    leaves_w, tree_w = jax.tree_util.tree_flatten(jax.device_get(want))
    assert tree_g == tree_w, f"{what}: cache structure {tree_g} != {tree_w}"
    for g, w in zip(leaves_g, leaves_w):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape, g.dtype)
        np.testing.assert_allclose(g, w, err_msg=what, **TOL)


def _batch(cfg, rng, b, s):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.pos_type == "mrope":
        batch["positions"] = mrope_positions(2, (2, 3), s - 8, b)
        assert len({tuple(p) for p in batch["positions"][:, 0]}) == 3  # the planes differ
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(
            np.float32)
    return batch


def _slice(batch, lo, hi):
    return {k: (v[..., lo:hi] if k in ("tokens", "positions") else v)
            for k, v in batch.items()}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})


def _check_forward_options(arch, s=12, b=2):
    """The family ``forward``'s own option against repro's: the transformer's
    ``inputs_embeds`` (the embeddings of other tokens: hidden and aux equal
    repro's forward on those tokens) and rwkv's ``masked`` liveness with
    ``return_state`` (hidden and every state leaf; row 1 ends in padding
    steps that must leave its state as the last real token left it)."""
    jcfg, tcfg, jp, tp, jm, _ = _pair(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    if jcfg.family in ("dense", "moe"):
        other = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
        jb, tb = _both({"tokens": other})
        jh, jaux = jm.forward(jp, jb)  # the shapes _check_model compiled
        emb = tmodules.embed_lookup(tp["embed"], tb["tokens"], torch.float32, tcfg)
        th, taux = ttransformer.forward(tp, tcfg, torch.from_numpy(toks), inputs_embeds=emb)
        np.testing.assert_allclose(_np(th), np.asarray(jh), err_msg=f"{arch} inputs_embeds",
                                   **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
        return
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pos[1, s - 4:] = -1
    jh, jst = jax.jit(lambda p, t, q: jrwkv.forward(p, jcfg, t, q, return_state=True,
                                                    masked=True))(jp, toks, pos)
    th, tst = trwkv.forward(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(pos),
                            return_state=True, masked=True)
    np.testing.assert_allclose(_np(th), np.asarray(jh), err_msg=f"{arch} masked", **TOL)
    _close_trees(_stacked_leaf(tst), jst, f"{arch} masked state")
    _, unpadded = trwkv.forward(tp, tcfg, torch.from_numpy(toks[1:, :s - 4]),
                                return_state=True)
    for got, want in zip(tst, unpadded):
        for k in want:
            np.testing.assert_allclose(_np(got[k][1:]), _np(want[k]), err_msg=k, **TOL)


def _check_model(arch, s=12, max_len=16, n_dec=3, b=2, **replace):
    jcfg, tcfg, jp, tp, jm, tm = _pair(arch, **replace)
    rng = np.random.default_rng(1)
    batch = _batch(jcfg, rng, b, s)
    jb, tb = _both(batch)
    jh, jaux = jm.forward(jp, jb)
    th, taux = tm.forward(tp, tb)
    np.testing.assert_allclose(_np(th), np.asarray(jh), err_msg=f"{arch} forward", **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), err_msg=f"{arch} aux", **TOL)
    jb, tb = _both(_slice(batch, 0, s - n_dec))
    jl, jc = jm.prefill(jp, jb, cache_dtype=jnp.float32, max_len=max_len)
    tl, tc = tm.prefill(tp, tb, cache_dtype=torch.float32, max_len=max_len)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=f"{arch} prefill", **TOL)
    _close_trees(_port_cache(tcfg, tc), jc, f"{arch} prefill cache")
    for t in range(s - n_dec, s):
        jb, tb = _both(_slice(batch, t, t + 1))
        jl, jc = jm.decode_step(jp, jc, jb, jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, tb, t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=f"{arch} decode {t}",
                                   **TOL)
    _close_trees(_port_cache(tcfg, tc), jc, f"{arch} cache after {n_dec} decode steps")
    # the last decode step's logits are the whole sequence's last position's
    full = tmodules.unembed(th[:, -1:], tm.head_weight(tp).T, torch.float32)[:, 0]
    np.testing.assert_allclose(_np(tl), _np(full), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("archs", [
    ("tinyllama-1.1b", "chatglm3-6b", "qwen2-vl-7b"),
    ("mixtral-8x22b", "kimi-k2-1t-a32b"),
    ("recurrentgemma-2b", "rwkv6-7b"),
    ("whisper-base",),
], ids=["dense", "moe", "recurrent", "encdec"])
def test_model_matches_repro(archs):
    """forward (hidden, aux), prefill (logits, every cache leaf) and three
    chained decode steps (logits, caches) at 2e-4; qwen2-vl with an image
    block's distinct M-RoPE planes; tinyllama's ``inputs_embeds`` and
    rwkv's ``masked`` forward."""
    for arch in archs:
        _check_model(arch)
        if arch in ("tinyllama-1.1b", "rwkv6-7b"):
            _check_forward_options(arch)


def test_sliding_window_ring_wraps():
    """mixtral with window 8 and a prompt of 3x the window: the prefill
    keeps the last 8 keys in ring order, and decode steps wrap the ring."""
    _check_model("mixtral-8x22b", s=24, max_len=24, n_dec=4, b=1, window=8)


def test_flash_attention_blocked_matches_repro():
    """The blocked online-softmax branch (1450 x 1500 scores pass the 2**21
    floor): both sides padded (padded query rows see no key: the l > 0
    guard), GQA 2, a key mask; causal with a window at q_block = kv_block =
    32 (key blocks wholly outside the window), causal without one and
    non-causal at 128 (a block pair is one step of a Python loop, so the
    blocks are no smaller), against repro's."""
    rng = np.random.default_rng(0)
    sq, skv = 1450, 1500
    q = rng.standard_normal((1, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, skv, 2, 16)).astype(np.float32) for _ in range(2))
    qpos, kpos = np.arange(50, 50 + sq, dtype=np.int32), np.arange(skv, dtype=np.int32)
    kmask = rng.random(skv) > 0.1
    for causal, window, blk in ((True, 40, 32), (True, 0, 128), (False, 0, 128)):
        kw = dict(causal=causal, window=window, q_block=blk, kv_block=blk)
        want = jax.jit(lambda *a, kw=kw: jmodules.flash_attention(
            *a[:3], qpos=a[3], kpos=a[4], kmask=a[5], **kw))(q, k, v, qpos, kpos, kmask)
        got = tmodules.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       qpos=torch.from_numpy(qpos), kpos=torch.from_numpy(kpos),
                                       kmask=torch.from_numpy(kmask), **kw)
        np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=str(kw), **TOL)


# ---------------------------------------------------------------------------
# The port's Engine against the port's solo reference
# ---------------------------------------------------------------------------
FAMILY_ARCHS = {"dense": "tinyllama-1.1b", "moe": "kimi-k2-1t-a32b",
                "griffin": "recurrentgemma-2b", "rwkv": "rwkv6-7b", "encdec": "whisper-base"}


def _frames_for(cfg, prompt):
    """Deterministic per-request encoder frames (enc-dec only)."""
    rng = np.random.default_rng([97, len(prompt)] + list(prompt))
    return rng.standard_normal((cfg.enc_len, cfg.d_model)).astype(np.float32)


def _schedule(seed):
    """(arrival_tick, prompt, max_tokens, eos) list drawn from ``seed``, as
    ``tests/test_serve_fuzz.py``'s."""
    rng = np.random.default_rng(1000 + seed)
    n_req = int(rng.integers(3, 6))
    reqs = []
    for _ in range(n_req):
        plen = int(rng.integers(1, 11))
        prompt = [int(t) for t in rng.integers(0, 256, plen)]
        max_tokens = int(rng.integers(1, _MAX_NEW + 1))
        arrival = int(rng.integers(0, 5))
        reqs.append([arrival, prompt, max_tokens, None])
    reqs.sort(key=lambda r: r[0])
    return rng, reqs


def _solo_tokens(model, params, cfg, prompt, jax_side=False):
    """Greedy continuation of ``prompt`` alone through prefill + decode_step."""
    batch = {"tokens": np.asarray([prompt], np.int32)}
    if cfg.family == "encdec":
        batch["enc_frames"] = _frames_for(cfg, prompt)[None]
    jb, tb = _both(batch)
    if jax_side:
        logits, cache = model.prefill(params, jb, cache_dtype=jnp.float32, max_len=MAX_LEN)
    else:
        logits, cache = model.prefill(params, tb, cache_dtype=torch.float32, max_len=MAX_LEN)
    out = [int(np.argmax(np.asarray(logits)[0]))]
    for pos in range(len(prompt), len(prompt) + _MAX_NEW - 1):
        tok = np.asarray([[out[-1]]], np.int32)
        if jax_side:
            logits, cache = model.decode_step(params, cache, {"tokens": jnp.asarray(tok)},
                                              jnp.int32(pos))
        else:
            logits, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(tok)},
                                              pos)
        out.append(int(np.argmax(np.asarray(logits)[0])))
    return out


def _run_schedule(family, seed, backends, reference, tcfg, tp, chunks=(8,)):
    rng, sched = _schedule(seed)
    for r in sched:
        if rng.random() < 0.4:
            cont = reference(r[1])
            r[3] = cont[int(rng.integers(0, len(cont)))]
    expected = []
    for _, p, m, e in sched:
        out = reference(p)[:m]
        expected.append(out[:out.index(e) + 1] if e is not None and e in out else out)
    slots = int(rng.integers(1, 4))
    block_size = int(rng.choice([4, 8, 16]))
    max_seq = max(len(p) for _, p, _, _ in sched) + _MAX_NEW + 1
    min_blocks = blocks_for(max_seq, block_size)
    roomy = 1 + slots * blocks_for(MAX_LEN, block_size)
    num_blocks = int(rng.integers(min_blocks + 2, max(min_blocks + 3, roomy)))
    kw = dict(slots=slots, max_len=MAX_LEN, block_size=block_size, num_blocks=num_blocks,
              prefill_batch=int(rng.integers(1, 3)), prefill_chunk=int(rng.choice(chunks)),
              device="cpu")
    for backend in backends:
        eng = Engine(tcfg, tp, backend=backend, **kw)
        handles, pending, t = [], list(sched), 0
        while pending or eng.pending():
            while pending and pending[0][0] <= t:
                _, prompt, max_tokens, eos = pending.pop(0)
                frames = _frames_for(tcfg, prompt) if family == "encdec" else None
                handles.append(eng.submit(prompt, max_tokens=max_tokens, eos=eos,
                                          enc_frames=frames))
            eng.tick()
            t += 1
            assert t < 2000, "scheduler stalled"
        got = [h.out_tokens for h in handles]
        assert got == expected, f"{family} seed {seed} {eng.session.backend}: {got} != {expected}"
        if eng.manager is not None:
            assert eng.num_free_blocks == eng.manager.num_blocks - 1


# test_serve_fuzz.py's parameter ids: dense[19] is seed 19, families[<f>-i] seed 50 + i
ENGINE_CASES = {  # family -> (schedule seeds, backends)
    "dense": ((19, 4), ("paged", "ring")),
    "moe": ((52,), ("paged",)),
    "griffin": ((50,), ("recurrent",)),
    "rwkv": ((50,), ("recurrent",)),
    "encdec": ((52,), ("encdec",)),
}


@pytest.mark.parametrize("family", list(ENGINE_CASES))
def test_engine_matches_solo_reference(family):
    """The port's Engine, on each of the family's backends, gives every
    request of a fuzzed schedule the greedy tokens the port's solo reference
    gives it alone (test_serve_fuzz.py's dense[19], encdec-2 and moe-2 among
    the schedules); for one prompt, the port's solo tokens equal repro's."""
    jcfg, tcfg, jp, tp, jm, tm = _pair(FAMILY_ARCHS[family])
    memo = {}

    def reference(prompt):
        if tuple(prompt) not in memo:
            memo[tuple(prompt)] = _solo_tokens(tm, tp, tcfg, prompt)
        return memo[tuple(prompt)]

    seeds, backends = ENGINE_CASES[family]
    chunks = (4, 8, 16) if family == "dense" else (8,)
    for seed in seeds:
        _run_schedule(family, seed, backends, reference, tcfg, tp, chunks)
    prompt = [int(t) for t in np.random.default_rng(7).integers(0, 256, 9)]
    assert reference(prompt) == _solo_tokens(jm, jp, jcfg, prompt, jax_side=True)


def test_model_surface_rules():
    """``init`` and ``init_cache`` take the card unless asked (raising
    without one); remat "dots" gives "none"'s hidden and an unknown policy raises;
    ``get_model`` warns; handed a CUDA device, ``build_model`` refuses a
    config past a linear limit through the solo backend (naming a CUDA
    device needs no card); under M-RoPE a
    decode step without positions takes position 0's rotary table, as
    repro's."""
    tcfg = _pair("qwen2-vl-7b")[1]
    model = build_model(tcfg)
    assert isinstance(model, Model)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_cache(1, 8)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    again = model.init(generator=gen, device="cpu")
    assert torch.equal(params["embed"]["table"], again["embed"]["table"])
    cache = model.init_cache(1, 8, torch.float32, device="cpu")
    assert cache[0][0]["pos"].shape == (8,) and cache[0][0]["k"].shape[1] == 8
    toks = {"tokens": torch.tensor([[1, 2, 3]])}
    assert torch.equal(model.forward(params, toks, remat="dots")[0],
                       model.forward(params, toks, remat="none")[0])
    with pytest.raises(ValueError, match="remat"):
        model.forward(params, toks, remat="some")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tapi.get_model(tcfg)  # analyze: allow[deprecated-api] the warning is under test
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    bad = tcfg.replace(quant=dataclasses.replace(tcfg.quant, enabled=True, group_size=8),
                       ttd=dataclasses.replace(tcfg.ttd, enabled=False))
    with pytest.raises(ValueError, match="int4_matmul takes K % 32 == 0"):
        build_model(bad, device="cuda")
    build_model(bad, device="cpu")  # the plain versions take it
    # M-RoPE without positions: position 0's table at every decode step
    jcfg, tcfg, jp, tp, jm, tm = _pair("qwen2-vl-7b")
    batch = {"tokens": np.asarray([[5, 6, 7, 8]], np.int32)}
    jb, tb = _both(batch)
    _, jc = jm.prefill(jp, jb, cache_dtype=jnp.float32, max_len=8)
    _, tc = tm.prefill(tp, tb, cache_dtype=torch.float32, max_len=8)
    jb, tb = _both({"tokens": np.asarray([[9]], np.int32)})
    jl, _ = jm.decode_step(jp, jc, jb, jnp.int32(4))
    tl, _ = tm.decode_step(tp, tc, tb, 4)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
