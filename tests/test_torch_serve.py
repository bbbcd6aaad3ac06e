"""repro_torch serving: Engine tokens vs repro's Engine, BlockManager vs the
reference, the device rule, and the package's import boundary.

The engines serve tinyllama-1.1b reduced in f32 with TT (attn_o, mlp) and
int4 (q/k/v, group 32) on the path, on schedules drawn the way
``tests/test_serve_fuzz.py`` draws its dense paged ones.  Greedy tokens must
be identical.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import QuantConfig, config_to_dict
from repro.configs import get_config
from repro.serve import kv_cache as jkv
from repro.serve.engine import Engine as JEngine
from repro_torch.config import config_from_dict
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import sessions as tsessions
from repro_torch.models import transformer as ttf
from repro_torch.models import whisper as twhisper
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.frontend import AsyncEngine
from torch_parity import jax_params

ROOT = Path(__file__).resolve().parent.parent
MAX_LEN = 96
_SETUP = {}


def _setup():
    if not _SETUP:
        base = get_config("tinyllama-1.1b", reduced=True)
        jcfg = base.replace(compute_dtype="float32", param_dtype="float32",
                            quant=QuantConfig(enabled=True, bits=4, group_size=32),
                            ttd=dataclasses.replace(base.ttd, first_tt_block=1))
        tcfg = config_from_dict(config_to_dict(jcfg))
        jparams = jax_params(jcfg, seed=1)
        tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
        _SETUP.update(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)
    return _SETUP


def _schedule(seed):
    """(arrival_tick, prompt, max_tokens) list + engine geometry, drawn like
    test_serve_fuzz's dense schedules."""
    rng = np.random.default_rng(1000 + seed)
    reqs = []
    for _ in range(int(rng.integers(3, 6))):
        plen = int(rng.integers(1, 11))
        prompt = [int(t) for t in rng.integers(0, 256, plen)]
        reqs.append([int(rng.integers(0, 5)), prompt, int(rng.integers(1, 7)), None])
    reqs.sort(key=lambda r: r[0])
    slots = int(rng.integers(1, 4))
    block_size = int(rng.choice([4, 8, 16]))
    min_blocks = -(-(max(len(p) for _, p, _, _ in reqs) + 7) // block_size)
    roomy = 1 + slots * -(-MAX_LEN // block_size)
    geometry = dict(slots=slots, max_len=MAX_LEN, block_size=block_size,
                    num_blocks=int(rng.integers(min_blocks + 2, max(min_blocks + 3, roomy))),
                    prefill_batch=int(rng.integers(1, 3)),
                    prefill_chunk=int(rng.choice((4, 8, 16))))
    return rng, reqs, geometry


def _drive(engine, sched):
    handles, t, pending = [], 0, list(sched)
    while pending or engine.pending():
        while pending and pending[0][0] <= t:
            _, prompt, max_tokens, eos = pending.pop(0)
            handles.append(engine.submit(prompt, max_tokens=max_tokens, eos=eos))
        engine.tick()
        t += 1
        assert t < 2000, "scheduler stalled"
    return [h.out_tokens for h in handles]


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_engine_tokens_match_repro_engine(seed):
    s = _setup()
    rng, sched, geometry = _schedule(seed)
    first = _drive(JEngine(s["jcfg"], s["jparams"], backend="paged", **geometry), sched)
    for r, out in zip(sched, first):  # an eos from the request's own output
        if rng.random() < 0.5:
            r[3] = out[int(rng.integers(0, len(out)))]
    want = _drive(JEngine(s["jcfg"], s["jparams"], backend="paged", **geometry), sched)
    eng = TEngine(s["tcfg"], s["tparams"], device="cpu", **geometry)
    got = _drive(eng, sched)
    assert got == want
    assert eng.num_free_blocks == eng.manager.num_blocks - 1
    assert eng.manager.live_tokens() == 0


def test_block_manager_matches_reference():
    rng = np.random.default_rng(7)
    jm, tm = jkv.BlockManager(20, 4), tkv.BlockManager(20, 4)
    live = []
    for step in range(200):
        op = rng.integers(0, 3)
        if op == 0 or not live:
            n = int(rng.integers(1, 20))
            assert jm.allocate(step, n) == tm.allocate(step, n)
            if step in jm.seq_ids():
                live.append(step)
        elif op == 1:
            sid = live[int(rng.integers(0, len(live)))]
            n = jm.seq_len(sid) + int(rng.integers(0, 9))
            assert jm.ensure(sid, n) == tm.ensure(sid, n)
        else:
            sid = live.pop(int(rng.integers(0, len(live))))
            assert jm.free(sid) == tm.free(sid)
        assert (jm.num_free, jm.live_tokens(), jm.utilization()) == \
            (tm.num_free, tm.live_tokens(), tm.utilization())
        ids = [None] + live[:3]
        np.testing.assert_array_equal(jkv.pack_block_tables(jm, ids, 20),
                                      tkv.pack_block_tables(tm, ids, 20))
    assert tkv.blocks_for(17, 4) == jkv.blocks_for(17, 4) == 5


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    s = _setup()
    cfg = s["tcfg"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tsessions.SessionSpec(slots=2, max_len=32)
    for call in (lambda: ttf.init_lm(cfg),
                 lambda: params_from_jax(jax.device_get(s["jparams"]), cfg),
                 lambda: tsessions.make_session(cfg, spec),
                 lambda: ttf.init_paged_cache(cfg, 4, 4),
                 lambda: TEngine(cfg, s["tparams"], slots=2, max_len=32),
                 lambda: AsyncEngine(cfg, s["tparams"], slots=2, max_len=32),
                 lambda: ttf.init_lm(cfg, device="cuda"),
                 lambda: twhisper.init_lm(tget("whisper-base", reduced=True)),
                 lambda: tsessions.make_session(tget("whisper-base", reduced=True), spec)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    sess = tsessions.make_session(cfg, spec, device="cpu")
    assert sess.init_state()["block_tables"].device.type == "cpu"
    assert tsessions.make_session(cfg, spec, backend="ring", device="cpu").backend == "ring"
    # every family/backend pair is ported; the refusals that remain name why
    assert {(f, b) for f, bs in tsessions.FAMILY_BACKENDS.items() for b in bs} \
        <= set(tsessions._SESSION_TYPES)
    with pytest.raises(NotImplementedError, match="encdec"):
        tsessions.make_session(tget("whisper-base"), spec, backend="paged", device="cpu")
    with pytest.raises(NotImplementedError, match="pos_type"):
        tsessions.make_session(tget("qwen2-vl-7b"), spec, backend="paged", device="cpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), f"{f}: imports {mod}"
