"""repro_torch.traffic against repro.traffic: workloads, report helpers, the
schema check, and a short replay through the port's AsyncEngine on the CPU.

One WorkloadSpec must expand to the same schedule in both packages (every
arrival, prompt token, budget and cancel point); the report helpers must
give the same rows on the same outcomes and registries; the port's schema
check must find exactly the errors ``repro.analyze.bench`` finds.  The
replay serves reduced tinyllama (f32, TT + int4: ``test_torch_serve._setup``)
and holds the traffic invariants the card's ``[traffic]`` phase holds.
"""
import dataclasses
import math

import numpy as np
import pytest
from test_torch_serve import _setup

import repro.obs as jobs
import repro.traffic as jtraffic
import repro_torch.obs as tobs
import repro_torch.traffic as ttraffic
from repro.analyze.bench import check_report
from repro_torch.serve.frontend import AsyncEngine

SPECS = {
    "poisson": dict(arrival="poisson", n_requests=24, rate_rps=4.0, seed=3),
    "bursty": dict(arrival="bursty", n_requests=13, rate_rps=6.0, burst_size=4, seed=11),
    "cancel_deadline": dict(arrival="poisson", n_requests=32, rate_rps=4.0,
                            prompt_len_buckets=(128, 512, 1536),
                            prompt_len_weights=(0.5, 0.35, 0.15),
                            out_tokens_buckets=(16, 64, 128),
                            out_tokens_weights=(0.5, 0.35, 0.15), vocab=32000,
                            ttft_slo_s=2.0, deadline_s=30.0, cancel_prob=0.2,
                            cancel_window_s=(0.2, 2.0), seed=7),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_make_workload_matches_repro(name):
    jw = jtraffic.make_workload(jtraffic.WorkloadSpec(**SPECS[name]))
    tspec = ttraffic.WorkloadSpec(**SPECS[name])
    tw = ttraffic.make_workload(tspec)
    assert [dataclasses.asdict(r) for r in tw] == [dataclasses.asdict(r) for r in jw]
    assert tspec.to_dict() == jtraffic.WorkloadSpec(**SPECS[name]).to_dict()
    if name == "cancel_deadline":
        assert any(r.cancel_after_s is not None for r in tw)
    with pytest.raises(ValueError):
        ttraffic.make_workload(dataclasses.replace(tspec, cancel_prob=1.5))


class _Req:
    def __init__(self, rid, n, reason, t_first, t_done, cancelled=False):
        self.rid, self.out_tokens, self.finish_reason = rid, list(range(n)), reason
        self.t_submit, self.t_first, self.t_done = 1.0, t_first, t_done
        self.done, self.cancelled = True, cancelled


REQS = [_Req(0, 16, "max_tokens", 1.5, 3.0), _Req(1, 4, "user", 2.5, 2.9, True),
        _Req(2, 0, "deadline", 0.0, 40.0, True), _Req(3, 64, "max_tokens", 3.5, 9.0),
        _Req(4, 9, "eos", 1.2, 2.0)]


def _registry(mod):
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(2)
    for name in ("serve_ttft_seconds", "serve_inter_token_seconds"):
        for v in rng.exponential(0.1, 40):
            reg.histogram(name).observe(float(v))
    reg.counter("serve_tokens_total").inc(93)
    reg.counter("serve_cancellations_total").inc(2)
    reg.counter("serve_deadline_miss_total").inc(1)
    reg.counter("serve_decode_ticks_total").inc(70)
    return reg


def _row(mod, traffic, slo):
    outs = [traffic.outcome_of(r, ttft_slo_s=slo, idx=i) for i, r in enumerate(REQS)]
    res = traffic.TrafficResult(outcomes=outs, wall_s=10.0, time_scale=1.0)
    return outs, traffic.traffic_row(result=res, registry=_registry(mod), family="dense",
                                     arch="tinyllama", scenario="poisson", workload={})


@pytest.mark.parametrize("slo", [None, 2.0])
def test_report_helpers_match_repro(slo):
    tout, trow = _row(tobs, ttraffic, slo)
    jout, jrow = _row(jobs, jtraffic, slo)
    assert [dataclasses.asdict(o) for o in tout] == [dataclasses.asdict(o) for o in jout]
    assert trow == jrow
    assert ttraffic.goodput_tok_per_s(tout, 2.0) == jtraffic.goodput_tok_per_s(jout, 2.0)
    assert ttraffic.registry_summary(tobs.MetricsRegistry()) == \
        jtraffic.registry_summary(jobs.MetricsRegistry())
    assert ttraffic.pct_row(None) == jtraffic.pct_row(None)
    with pytest.raises(ValueError):
        ttraffic.goodput_tok_per_s(tout, 0.0)


def _report():
    rows = []
    for fam, scen in (("dense", "poisson"), ("moe", "bursty"), ("griffin", "poisson")):
        _, row = _row(tobs, ttraffic, 2.0)
        row.update(family=fam, scenario=scen)
        rows.append(row)
    return {"scenarios": ["poisson", "bursty"], "note": "", "rows": rows}


BREAKS = {
    "valid": lambda rec: None,
    "top_key": lambda rec: rec.pop("note"),
    "field": lambda rec: rec["rows"][0].pop("tokens"),
    "partition": lambda rec: rec["rows"][1].update(n_completed=rec["rows"][1]["n_completed"] + 1),
    "cancels": lambda rec: rec["rows"][2].update(cancels=0),
    "goodput": lambda rec: rec["rows"][0].update(goodput_tok_per_s=1e9),
    "empty_hist": lambda rec: rec["rows"][1]["ttft_s"].update(count=0),
    "pct": lambda rec: rec["rows"][0]["inter_token_s"].update(p95=None),
    "block": lambda rec: rec["rows"][2].update(ttft_s=3.0),
    "wall": lambda rec: rec["rows"][0].update(wall_s=-1.0),
    "diversity": lambda rec: [r.update(family="dense") for r in rec["rows"]],
    "no_rows": lambda rec: rec.update(rows=[]),
}


@pytest.mark.parametrize("brk", sorted(BREAKS))
def test_check_traffic_schema_matches_repro(brk):
    rec = _report()
    BREAKS[brk](rec)
    want = check_report("traffic", rec)
    assert ttraffic.traffic_schema_errors(rec) == want
    assert bool(want) == (brk != "valid")
    if want:
        with pytest.raises(ValueError):
            ttraffic.check_traffic_schema(rec)
    else:
        ttraffic.check_traffic_schema(rec)


def test_drive_replay_on_cpu(tmp_path):
    """A short open-loop replay (Poisson arrivals, deadlines, client cancels)
    through the port's AsyncEngine: the report passes the schema check, the
    JSONL trace validates, completed requests hold exactly max_tokens
    tokens, cancelled ones fewer, and the pool drains."""
    s = _setup()
    spec = ttraffic.WorkloadSpec(n_requests=8, rate_rps=40.0, prompt_len_buckets=(4, 12),
                                 prompt_len_weights=(0.5, 0.5), out_tokens_buckets=(3, 12),
                                 out_tokens_weights=(0.5, 0.5), vocab=256, ttft_slo_s=5.0,
                                 deadline_s=60.0, cancel_prob=0.4,
                                 cancel_window_s=(0.0, 0.02), seed=4)
    work = ttraffic.make_workload(spec)
    rows = []
    for ahead in (True, False):
        obs = tobs.Observer(tobs.ObsConfig(jsonl_path=str(tmp_path / f"{ahead}.jsonl")))
        fe = AsyncEngine(s["tcfg"], s["tparams"], dispatch_ahead=ahead, obs=obs, slots=3,
                         max_len=96, block_size=8, prefill_batch=2, prefill_chunk=8,
                         device="cpu")
        res = ttraffic.drive(fe, work, time_scale=1.0)
        obs.close()
        assert tobs.validate_jsonl(tmp_path / f"{ahead}.jsonl") == []
        rows.append(ttraffic.traffic_row(result=res, registry=obs.registry, family="dense",
                                         arch="tinyllama", scenario=f"ahead={ahead}",
                                         workload=spec.to_dict()))
        for o, w in zip(res.outcomes, work):
            if o.completed:
                assert o.n_tokens == w.max_tokens and o.ttft_s is not None
            else:
                assert o.finish_reason in ("user", "deadline")
                assert o.n_tokens < w.max_tokens
        assert fe.engine.num_free_blocks == fe.engine.manager.num_blocks - 1
        assert not fe.engine.pending()
        assert math.isfinite(rows[-1]["tok_per_s"])
    ttraffic.check_traffic_schema({"scenarios": [r["scenario"] for r in rows], "note": "",
                                   "rows": rows}, diversity={"scenario": 2})
    with pytest.raises(ValueError):
        ttraffic.drive(fe, work, time_scale=0.0)
