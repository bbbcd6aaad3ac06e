"""repro_torch.obs against repro.obs: registry math, exporters, the event
schema, the engine's events and counters, and the dispatch counters.

Registries are filled with the same seeded observations in both packages
and must agree exactly (percentiles, merges, Prometheus text, bench
summaries).  The port's Engine and repro's Engine serve one tick-driven
schedule (reduced tinyllama, f32, TT + int4: ``test_torch_serve._setup``)
with a preemption and a cancellation; their event streams must be equal
event by event in every field but the clock's (``t``, ``ttft_s``) and
``seq``, and their counters and histogram counts equal.
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_serve import _setup

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.serve.engine import Engine as JEngine
from repro_torch.kernels import dispatch
from repro_torch.serve.engine import Engine as TEngine

ROOT = Path(__file__).resolve().parent.parent


def _fill(mod, seed):
    """A registry of ``mod`` (repro.obs or repro_torch.obs) with seeded
    counters, gauges and histograms, two label sets each."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for lab in ("a", "b"):
        reg.counter("reqs_total", kind=lab).inc(float(rng.integers(1, 9)))
        reg.gauge("util", kind=lab).set(float(rng.random()))
        h = reg.histogram("lat_seconds", kind=lab)
        for v in rng.exponential(0.05, 300):
            h.observe(float(v))
        h2 = reg.histogram("small", buckets=mod.exp_buckets(0.5, 2.0, 6), kind=lab)
        for v in rng.uniform(0, 40, 50):
            h2.observe(float(v))
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_percentiles_and_merge_match_repro(seed):
    j, t = _fill(jobs, seed), _fill(tobs, seed)
    j.merge(_fill(jobs, seed + 10))
    t.merge(_fill(tobs, seed + 10))
    for (jn, jl, jm), (tn, tl, tm) in zip(j.collect(), t.collect(), strict=True):
        assert (jn, jl) == (tn, tl)
        if isinstance(jm, jobs.Histogram):
            assert (jm.counts, jm.count, jm.sum, jm.vmin, jm.vmax) == \
                (tm.counts, tm.count, tm.sum, tm.vmin, tm.vmax)
            for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
                assert jm.percentile(q) == tm.percentile(q)
        else:
            assert jm.value == tm.value
    assert tobs.DEFAULT_LATENCY_BUCKETS == jobs.DEFAULT_LATENCY_BUCKETS
    with pytest.raises(ValueError, match="already registered"):
        t.gauge("reqs_total", kind="a")


def test_prometheus_text_and_bench_summary_match_repro():
    j, t = _fill(jobs, 3), _fill(tobs, 3)
    assert tobs.prometheus_text(t) == jobs.prometheus_text(j)
    assert tobs.bench_summary(t) == jobs.bench_summary(j)


def test_validate_events_catches_what_repro_catches(tmp_path):
    good = {"ev": "admit", "t": 1.0, "seq": 3, "rid": 0, "slot": 1, "tick": 2, "n_tokens": 5}
    bad = [good, {"ev": "nope", "t": 1.0, "seq": 4},
           {k: v for k, v in good.items() if k != "slot"} | {"seq": 5},
           good | {"rid": "0", "seq": 6}, good | {"t": float("inf"), "seq": 7},
           good | {"seq": 1}, good | {"tick": True, "seq": 8}, "not a dict",
           {"ev": "finish", "t": 2.0, "seq": 9, "rid": 0, "tick": 3, "reason": "eos",
            "n_out": 2.5}]
    assert tobs.validate_events(bad) == jobs.validate_events(bad)
    assert len(tobs.validate_events(bad)) == 8
    assert tobs.validate_events([good]) == []
    assert tobs.EVENT_FIELDS == jobs.trace.EVENT_FIELDS
    path = tmp_path / "t.jsonl"
    w = tobs.JsonlWriter(path)
    for e in bad[:3]:
        w.write(e)
    w.close()
    assert tobs.validate_jsonl(path) == jobs.validate_jsonl(path)
    assert tobs.read_jsonl(path)[0] == good
    assert tobs.validate_jsonl(tmp_path / "missing.jsonl")
    from repro_torch.obs.export import main
    assert main(["--validate", str(path)]) == 1


def test_resolve_observer_reads_no_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_OBS", "1")
    assert tobs.resolve_observer(None) is None
    assert tobs.resolve_observer(False) is None
    assert tobs.resolve_observer(tobs.ObsConfig(enabled=False)) is None
    obs = tobs.Observer()
    assert tobs.resolve_observer(obs) is obs
    on = tobs.resolve_observer(tobs.ObsConfig(jsonl_path=str(tmp_path / "x.jsonl")))
    on.event("decode_tick", tick=0, active=1)
    on.close()
    assert tobs.validate_jsonl(tmp_path / "x.jsonl") == []
    assert not hasattr(tobs.ObsConfig, "from_env")
    with pytest.raises(TypeError):
        tobs.resolve_observer("yes")
    with pytest.raises(ValueError):
        tobs.ObsConfig(pool_sample_every=0)


def test_port_reads_no_environment():
    """No module of the port reads an environment variable."""
    for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv", "putenv"):
                raise AssertionError(f"{f}:{node.lineno} reads the environment")


def _serve(engine_cls, cfg, params, obs, cancel_at):
    """One tick-driven schedule: 4 requests over 2 slots in a pool small
    enough to preempt, request 2 cancelled at tick ``cancel_at``."""
    eng = engine_cls(cfg, params, slots=2, max_len=96, block_size=4, num_blocks=7,
                     prefill_batch=2, prefill_chunk=8, obs=obs,
                     **({"device": "cpu"} if engine_cls is TEngine else {"backend": "paged"}))
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (6, 9, 3, 7)]
    reqs = [eng.submit(p, max_tokens=m) for p, m in zip(prompts[:2], (8, 6))]
    tick = 0
    while eng.pending():
        if tick == 1:
            reqs += [eng.submit(p, max_tokens=m) for p, m in zip(prompts[2:], (9, 4))]
        if tick == cancel_at:
            eng.cancel(reqs[2])
        eng.tick()
        tick += 1
        assert tick < 500
    return eng, reqs


@pytest.mark.parametrize("cancel_at", [1, 4])
def test_engine_events_and_counters_match_repro(cancel_at):
    s = _setup()
    jo, to = jobs.Observer(), tobs.Observer()
    jeng, jreqs = _serve(JEngine, s["jcfg"], s["jparams"], jo, cancel_at)
    teng, treqs = _serve(TEngine, s["tcfg"], s["tparams"], to, cancel_at)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [(r.finish_reason, r.cancelled) for r in treqs] == \
        [(r.finish_reason, r.cancelled) for r in jreqs]

    def strip(events):
        return [{k: v for k, v in e.items() if k not in ("t", "seq", "ttft_s")}
                for e in events]

    assert strip(to.trace.events) == strip(jo.trace.events)
    kinds = {e["ev"] for e in to.trace.events}
    assert {"preempt", "cancel", "pool_sample", "first_token"} <= kinds
    assert tobs.validate_events(to.trace.events) == []
    for name, lab, m in jo.registry.collect():
        tm = to.registry.get(name, **lab)
        if isinstance(m, jobs.Histogram):
            assert tm.count == m.count, name
        else:
            assert tm.value == m.value, name
    assert teng.num_free_blocks == teng.manager.num_blocks - 1 == \
        jeng.num_free_blocks


def test_dispatch_counts_and_kernel_timing():
    s = _setup()
    dispatch.reset_dispatch_metrics()
    eng = TEngine(s["tcfg"], s["tparams"], slots=2, max_len=32, block_size=8,
                  prefill_chunk=8, device="cpu")
    eng.submit([1, 2, 3], max_tokens=3)
    eng.run()
    counts = dispatch.dispatch_counts()
    for role in ("tt", "int4", "attn_paged", "attn_prefill"):
        assert counts[(role, "plain")] > 0, role
    assert not any(route == "cuda" for _, route in counts)
    assert dispatch.kernel_metrics().get("kernel_wall_seconds", role="tt",
                                         route="plain") is None
    x = torch.ones(2, 8)
    with dispatch.kernel_timing():
        dispatch.dense_linear(x, torch.ones(8, 4))
    h = dispatch.kernel_metrics().get("kernel_wall_seconds", role="dense", route="plain")
    assert h is not None and h.count == 1 and h.vmax > 0
    dispatch.dense_linear(x, torch.ones(8, 4))
    assert h.count == 1  # timing only inside the context
    dispatch.reset_dispatch_metrics()
    assert dispatch.dispatch_counts() == {}


def test_engine_kernel_timing_and_jsonl(tmp_path):
    """ObsConfig(kernel_timing=True) times the engine's kernel calls; the
    JSONL trace it streams validates and holds the in-memory events."""
    s = _setup()
    dispatch.reset_dispatch_metrics()
    obs = tobs.Observer(tobs.ObsConfig(jsonl_path=str(tmp_path / "e.jsonl"),
                                       kernel_timing=True, profiler_annotations=True,
                                       pool_sample_every=2))
    eng = TEngine(s["tcfg"], s["tparams"], slots=2, max_len=32, block_size=8,
                  prefill_chunk=8, obs=obs, device="cpu")
    eng.submit([4, 5, 6], max_tokens=4)
    eng.run()
    obs.close()
    assert tobs.validate_jsonl(tmp_path / "e.jsonl") == []
    assert json.loads((tmp_path / "e.jsonl").read_text().splitlines()[0])["ev"] == "submit"
    assert len(tobs.read_jsonl(tmp_path / "e.jsonl")) == len(obs.trace.events)
    assert all(e["tick"] % 2 == 0 for e in obs.trace.by_type("pool_sample"))
    h = dispatch.kernel_metrics().get("kernel_wall_seconds", role="tt", route="plain")
    assert h is not None and h.count == dispatch.dispatch_counts()[("tt", "plain")]
    dispatch.reset_dispatch_metrics()
