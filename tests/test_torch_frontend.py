"""The port's AsyncEngine and the engine features behind it, against repro.

Reduced tinyllama (f32, TT + int4: ``test_torch_serve._setup``) serves
burst schedules (every request submitted before the pump first runs)
through repro's Engine, the port's Engine and the port's AsyncEngine with
dispatch-ahead on and off: greedy tokens must be identical.  Then
cancellation (a strict prefix of the uncancelled tokens, the slot and
blocks freed), deadline expiry of a queued request, EDF admission order
against repro's, submit validation, drained reuse, and seeded sampling:
reproducible, ``top_k=1`` equal to greedy, the same draw as
``torch.multinomial``, identical with dispatch-ahead on and off, and
frequencies that fit ``softmax(l / T)`` over the top k.
"""
import asyncio
import time

import numpy as np
import pytest
import torch
from test_torch_serve import _setup

from repro.serve.engine import EDFAdmission as JEDF
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.serve import steps
from repro_torch.serve.engine import EDFAdmission, Engine, Request
from repro_torch.serve.engine import PagedEngine  # analyze: allow[deprecated-api] pins its warning
from repro_torch.serve.frontend import AsyncEngine

_JAX_TOKENS = {}


def _burst(seed):
    """(prompts, max_tokens, geometry) of a seeded burst."""
    rng = np.random.default_rng(4000 + seed)
    n = int(rng.integers(4, 7))
    prompts = [[int(t) for t in rng.integers(0, 256, int(rng.integers(1, 12)))]
               for _ in range(n)]
    max_tokens = [int(rng.integers(2, 14)) for _ in range(n)]
    geometry = dict(slots=int(rng.integers(2, 4)), max_len=96,
                    block_size=int(rng.choice([4, 8])),
                    num_blocks=int(rng.integers(12, 30)), prefill_batch=2,
                    prefill_chunk=8)
    return prompts, max_tokens, geometry


def _run_async(fe, prompts, max_tokens, **kw):
    async def go():
        hs = [fe.submit(p, max_tokens=m, **kw) for p, m in zip(prompts, max_tokens)]
        await fe.drain()
        return hs
    return asyncio.run(go())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ahead", [True, False])
def test_async_tokens_match_engines(seed, ahead):
    s = _setup()
    prompts, max_tokens, geometry = _burst(seed)
    if seed not in _JAX_TOKENS:
        jeng = JEngine(s["jcfg"], s["jparams"], backend="paged", **geometry)
        jreqs = [jeng.submit(p, max_tokens=m) for p, m in zip(prompts, max_tokens)]
        jeng.run()
        _JAX_TOKENS[seed] = [r.out_tokens for r in jreqs]
    want = _JAX_TOKENS[seed]
    eng = Engine(s["tcfg"], s["tparams"], device="cpu", **geometry)
    reqs = [eng.submit(p, max_tokens=m) for p, m in zip(prompts, max_tokens)]
    eng.run()
    assert [r.out_tokens for r in reqs] == want
    fe = AsyncEngine(s["tcfg"], s["tparams"], dispatch_ahead=ahead, device="cpu", **geometry)
    hs = _run_async(fe, prompts, max_tokens)
    assert [h.out_tokens for h in hs] == want
    assert all(h.done and not h.cancelled for h in hs)
    assert (fe.stats["ahead_ticks"] > 0) == ahead
    assert fe.stats["ticks"] > 0
    assert fe.engine.num_free_blocks == fe.engine.manager.num_blocks - 1


def test_cancel_keeps_prefix_and_frees():
    s = _setup()
    kw = dict(slots=2, max_len=96, block_size=4, num_blocks=20, prefill_chunk=8,
              device="cpu")
    prompt = [9, 8, 7, 6, 5]
    full = Engine(s["tcfg"], s["tparams"], **kw)
    ref = full.submit(prompt, max_tokens=12)
    full.run()
    eng = Engine(s["tcfg"], s["tparams"], **kw)
    a = eng.submit(prompt, max_tokens=12)
    queued = [eng.submit([1, 2], max_tokens=3) for _ in range(3)]
    for _ in range(4):
        eng.tick()
    assert eng.cancel(queued[2]) and queued[2].finish_reason == "user" \
        and queued[2].out_tokens == []
    assert eng.cancel(a)
    assert not eng.cancel(a)  # already done
    assert a.cancelled and a.finish_reason == "user"
    assert 0 < len(a.out_tokens) < len(ref.out_tokens)
    assert a.out_tokens == ref.out_tokens[:len(a.out_tokens)]
    assert a not in eng.slot_req and a.rid not in eng.manager.seq_ids()
    eng.run()
    assert eng.num_free_blocks == eng.manager.num_blocks - 1

    # through the front end: cancel after the third streamed token
    fe = AsyncEngine(s["tcfg"], s["tparams"], **kw)

    async def go():
        h = fe.submit(prompt, max_tokens=12)
        other = fe.submit([3, 1], max_tokens=6)
        got = []
        async for tok in h.stream():
            got.append(tok)
            if len(got) == 3:
                h.cancel()
                h.cancel()  # idempotent
        await fe.drain()
        return h, other, got

    h, other, got = asyncio.run(go())
    assert h.cancelled and got == h.out_tokens
    assert 3 <= len(h.out_tokens) < 12 and h.out_tokens == ref.out_tokens[:len(h.out_tokens)]
    assert other.done and len(other.out_tokens) == 6
    assert fe.engine.num_free_blocks == fe.engine.manager.num_blocks - 1


def test_queued_request_expires_at_deadline():
    s = _setup()
    for engine_cls, kw in ((Engine, {"device": "cpu"}), (JEngine, {"backend": "paged"})):
        eng = engine_cls(s["tcfg"] if engine_cls is Engine else s["jcfg"],
                         s["tparams"] if engine_cls is Engine else s["jparams"], slots=1,
                         max_len=96, block_size=8, prefill_chunk=8, **kw)
        long = eng.submit([1, 2, 3], max_tokens=6)
        late = eng.submit([4, 5], max_tokens=4, deadline_s=1e-3)
        time.sleep(0.01)
        eng.tick()
        assert late.done and late.cancelled and late.finish_reason == "deadline"
        assert late.out_tokens == [] and late in eng.finished
        eng.run()
        assert long.done and len(long.out_tokens) == 6


def test_edf_orders_like_repro():
    rng = np.random.default_rng(9)
    specs = [(float(rng.random()), None if rng.random() < 0.3 else float(rng.random() * 3))
             for _ in range(12)]
    tq = [Request(i, [1], 1, t_submit=t, deadline_s=d) for i, (t, d) in enumerate(specs)]
    jq = [JRequest(i, [1], 1, t_submit=t, deadline_s=d) for i, (t, d) in enumerate(specs)]
    assert [r.rid for r in EDFAdmission().order(tq, 0.0)] == \
        [r.rid for r in JEDF().order(jq, 0.0)]

    # in the engine: one slot, the earliest deadline admits first
    s = _setup()
    orders = []
    for engine_cls, kw in ((Engine, {"device": "cpu"}), (JEngine, {"backend": "paged"})):
        eng = engine_cls(s["tcfg"] if engine_cls is Engine else s["jcfg"],
                         s["tparams"] if engine_cls is Engine else s["jparams"], slots=1,
                         max_len=96, block_size=8, prefill_chunk=8,
                         admission=EDFAdmission() if engine_cls is Engine else JEDF(), **kw)
        reqs = [eng.submit([i + 1, 2], max_tokens=2, deadline_s=d)
                for i, d in enumerate((500.0, None, 100.0, 300.0))]
        eng.run()
        orders.append([eng.finished.index(r) for r in reqs])
        assert all(len(r.out_tokens) == 2 for r in reqs)
    assert orders[0] == orders[1] == [2, 3, 0, 1]


def test_submit_validation_and_drained_reuse():
    s = _setup()
    fe = AsyncEngine(s["tcfg"], s["tparams"], slots=2, max_len=32, block_size=8,
                     num_blocks=4, prefill_chunk=8, device="cpu")
    with pytest.raises(RuntimeError):
        fe.submit([1, 2], max_tokens=2)  # no running event loop

    async def bad():
        for kwargs in (dict(prompt=[]), dict(prompt=[1], max_tokens=0),
                       dict(prompt=[1], deadline_s=0.0), dict(prompt=[1] * 32),
                       dict(prompt=[1] * 20, max_tokens=10)):
            with pytest.raises(ValueError):
                fe.submit(**kwargs)
    asyncio.run(bad())
    with pytest.raises(ValueError):
        AsyncEngine(s["tcfg"], s["tparams"], engine=fe.engine)
    eng = Engine(s["tcfg"], s["tparams"], slots=2, max_len=32, block_size=8, num_blocks=4,
                 prefill_chunk=8, device="cpu")
    want = [eng.submit(p, max_tokens=4) for p in ([5, 6], [7])]
    eng.run()
    first = _run_async(fe, [[5, 6]], [4])
    again = _run_async(fe, [[7]], [4])  # a drained front end starts a fresh pump
    assert [first[0].out_tokens, again[0].out_tokens] == [r.out_tokens for r in want]
    with pytest.warns(DeprecationWarning):
        alias = PagedEngine  # analyze: allow[deprecated-api] pins its warning
        alias(s["tcfg"], s["tparams"], slots=1, max_len=32, device="cpu")


def test_sample_tokens_is_multinomials_draw():
    logits = torch.randn(6, 50, generator=torch.Generator().manual_seed(1))
    for temperature, top_k in ((1.0, 0), (0.7, 5)):
        got = steps.sample_tokens(logits, torch.Generator().manual_seed(3),
                                  temperature=temperature, top_k=top_k)
        scaled = logits / temperature
        if top_k:
            kth = torch.topk(scaled, top_k).values[:, -1:]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        want = torch.multinomial(torch.softmax(scaled, -1), 1,
                                 generator=torch.Generator().manual_seed(3))
        assert torch.equal(got, want.to(torch.int32))
    assert torch.equal(steps.sample_tokens(logits, torch.Generator(), top_k=1),
                       steps.greedy_tokens(logits))


def test_sample_frequencies_fit_softmax():
    """20000 draws from one logits row at T 0.7 over the top 5 of 12: the
    masked entries never come up, and the chi-square of the counts against
    softmax(l / T) over the top 5 stays under 18.47 (the 0.999 quantile at
    4 degrees of freedom; the draws are seeded, so the value is fixed)."""
    row = torch.tensor([1.0, -0.5, 2.0, 0.3, 1.7, -2.0, 0.9, 0.0, 1.2, -1.0, 0.5, 2.2])
    n, t, k = 20000, 0.7, 5
    toks = steps.sample_tokens(row.expand(n, -1), torch.Generator().manual_seed(0),
                               temperature=t, top_k=k)[:, 0]
    counts = torch.bincount(toks, minlength=row.numel()).double()
    top = torch.topk(row, k).indices
    p = torch.softmax(row[top] / t, -1).double()
    masked = torch.ones(row.numel(), dtype=torch.bool)
    masked[top] = False
    assert counts[masked].sum() == 0
    chi2 = (((counts[top] - n * p) ** 2) / (n * p)).sum().item()
    assert chi2 < 18.47, chi2


def test_seeded_sampling_in_the_engines():
    s = _setup()
    prompts, max_tokens, geometry = _burst(2)
    kw = dict(device="cpu", **geometry)

    def engine_run(**sample):
        eng = Engine(s["tcfg"], s["tparams"], **kw, **sample)
        reqs = [eng.submit(p, max_tokens=m) for p, m in zip(prompts, max_tokens)]
        eng.run()
        return [r.out_tokens for r in reqs]

    sampled = dict(greedy=False, temperature=0.9, top_k=40, seed=5)
    first = engine_run(**sampled)
    assert engine_run(**sampled) == first
    assert engine_run(**(sampled | {"seed": 6})) != first
    assert engine_run(greedy=False, top_k=1, seed=5) == engine_run()
    for ahead in (True, False):
        fe = AsyncEngine(s["tcfg"], s["tparams"], dispatch_ahead=ahead, **kw, **sampled)
        assert [h.out_tokens for h in _run_async(fe, prompts, max_tokens)] == first
        assert (fe.stats["ahead_ticks"] > 0) == ahead
