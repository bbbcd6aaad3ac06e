"""Traffic accounting: outcomes, goodput, and the shared summary schema
(counterpart of ``repro.traffic.report``).

Pure bookkeeping: no asyncio, no torch.  The rows have ``repro``'s shape,
so one reader takes both packages' reports:

* :func:`pct_row` — ``{count, mean, p50, p95, p99}`` from an obs histogram
  (``None``-safe: an absent/empty histogram yields null fields, not a crash).
* :func:`registry_summary` — the serving metrics every row embeds (TTFT /
  inter-token / queue-time percentiles plus token, tick, preemption,
  cancellation, and deadline-miss totals), pulled from the engine's
  :class:`~repro_torch.obs.registry.MetricsRegistry` — the obs layer is the
  single source of truth for latency percentiles.
* :class:`RequestOutcome` / :func:`outcome_of` — per-request accounting from
  the engine's monotonic stamps; ``slo_attained`` means *completed with the
  first token inside its TTFT SLO*.
* :func:`goodput_tok_per_s` — SLO-attained tokens per wall second: tokens
  from requests that missed their SLO (or were cancelled / deadline-expired)
  spent compute but delivered no client value, so they count in ``tok_per_s``
  but not in goodput.
* :func:`check_traffic_schema` — the traffic report's acceptance shape and
  invariants, a copy of ``repro.analyze.bench``'s traffic schema (the port
  imports nothing of ``repro``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

PCT_FIELDS = ("count", "mean", "p50", "p95", "p99")


def pct_row(h) -> dict:
    """``{count, mean, p50, p95, p99}`` from an obs histogram (None-safe)."""
    if h is None or h.count == 0:
        return {"count": 0, "mean": None, "p50": None, "p95": None, "p99": None}
    return {"count": h.count, "mean": h.mean(), "p50": h.percentile(0.50),
            "p95": h.percentile(0.95), "p99": h.percentile(0.99)}


def registry_summary(reg) -> dict:
    """The shared serving-metrics block for BENCH rows.

    ``reg`` is a :class:`~repro_torch.obs.registry.MetricsRegistry`; metrics the
    run never touched report zero / null rather than raising.
    """
    def total(name: str) -> int:
        c = reg.get(name)
        return int(c.value) if c is not None else 0

    return {
        "ttft_s": pct_row(reg.get("serve_ttft_seconds")),
        "inter_token_s": pct_row(reg.get("serve_inter_token_seconds")),
        "queue_s": pct_row(reg.get("serve_queue_seconds")),
        "tokens": total("serve_tokens_total"),
        "decode_ticks": total("serve_decode_ticks_total"),
        "preempts": total("serve_preemptions_total"),
        "cancels": total("serve_cancellations_total"),
        "deadline_misses": total("serve_deadline_miss_total"),
    }


@dataclass
class RequestOutcome:
    """Per-request accounting derived from the engine's monotonic stamps."""

    idx: int
    rid: int
    n_tokens: int
    finish_reason: str        # eos | max_tokens | max_len | user | deadline
    completed: bool           # finished normally (not cancelled/expired)
    ttft_s: float | None      # first-token latency (None: never got one)
    latency_s: float | None   # submit -> done
    slo_attained: bool        # completed and TTFT within its SLO


def outcome_of(req, *, ttft_slo_s: float | None = None,
               idx: int = -1) -> RequestOutcome:
    """Account one finished engine :class:`~repro_torch.serve.engine.Request`.

    ``ttft_slo_s`` (already time-scaled by the caller when the schedule was)
    gates ``slo_attained``; ``None`` means every completed request attains.
    """
    completed = bool(req.done and not req.cancelled)
    ttft = (req.t_first - req.t_submit) if req.t_first else None
    latency = (req.t_done - req.t_submit) if req.t_done else None
    attained = completed and (ttft_slo_s is None
                              or (ttft is not None and ttft <= ttft_slo_s))
    return RequestOutcome(idx=idx, rid=req.rid, n_tokens=len(req.out_tokens),
                          finish_reason=req.finish_reason, completed=completed,
                          ttft_s=ttft, latency_s=latency, slo_attained=attained)


def goodput_tok_per_s(outcomes, wall_s: float) -> float:
    """SLO-attained tokens per wall-clock second (0 when nothing attained)."""
    if wall_s <= 0:
        raise ValueError("wall_s must be > 0")
    return sum(o.n_tokens for o in outcomes if o.slo_attained) / wall_s


def traffic_row(*, result, registry, **labels) -> dict:
    """One BENCH_traffic.json row: labels + outcome counts + shared summary.

    ``result`` is a :class:`~repro_torch.traffic.runner.TrafficResult`; ``labels``
    (family/arch/scenario/…) pass through verbatim.
    """
    outs = result.outcomes
    toks = sum(o.n_tokens for o in outs)
    return {
        **labels,
        "n_requests": len(outs),
        "n_completed": sum(o.completed for o in outs),
        "n_cancelled": sum(o.finish_reason == "user" for o in outs),
        "n_deadline_missed": sum(o.finish_reason == "deadline" for o in outs),
        "n_slo_attained": sum(o.slo_attained for o in outs),
        "wall_s": result.wall_s,
        "time_scale": result.time_scale,
        "tok_per_s": toks / result.wall_s if result.wall_s > 0 else 0.0,
        "goodput_tok_per_s": goodput_tok_per_s(outs, result.wall_s),
        **registry_summary(registry),
    }


# The traffic report's acceptance shape (``repro/analyze/bench.py``: the
# "traffic" BenchSchema and ``_invariants_traffic``).
TRAFFIC_TOP_KEYS = ("scenarios", "note", "rows")
TRAFFIC_ROW_FIELDS = ("family", "arch", "scenario", "workload", "n_requests",
                      "n_completed", "n_cancelled", "n_deadline_missed",
                      "wall_s", "tok_per_s", "goodput_tok_per_s", "ttft_s",
                      "inter_token_s", "tokens", "decode_ticks", "preempts",
                      "cancels", "deadline_misses")
TRAFFIC_PCT_BLOCKS = ("ttft_s", "inter_token_s")
TRAFFIC_DIVERSITY = {"family": 3, "scenario": 2}


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x)


def traffic_schema_errors(rec: dict, diversity: dict | None = None) -> list[str]:
    """Every schema error of a traffic report (``[]`` = valid), in
    ``repro``'s words: top-level keys, row fields, positive percentiles,
    distinct-value floors (``diversity``, ``repro``'s by default), and the
    invariants — positive ``wall_s``, goodput ≤ throughput, outcome counts
    partition ``n_requests``, the registry's cancels equal cancelled plus
    deadline-missed, and non-empty TTFT and inter-token histograms."""
    diversity = TRAFFIC_DIVERSITY if diversity is None else diversity
    errors = [f"traffic: missing top-level key {k!r}" for k in TRAFFIC_TOP_KEYS
              if k not in rec]
    rows = rec.get("rows")
    if not isinstance(rows, list) or not rows:
        return errors + ["traffic: 'rows' missing or empty"]
    for i, r in enumerate(rows):
        errors += [f"traffic row {i}: missing field {k!r}" for k in TRAFFIC_ROW_FIELDS
                   if k not in r]
        for block in TRAFFIC_PCT_BLOCKS:
            b = r.get(block)
            if not isinstance(b, dict):
                errors.append(f"traffic row {i}: {block} is not a percentile block")
                continue
            errors += [f"traffic row {i}: {block}.{f} not positive" for f in ("p50", "p95", "p99")
                       if f in b and not (b[f] is not None and _num(b[f]) and b[f] > 0)]
    for key, floor in diversity.items():
        seen = {r.get(key) for r in rows if key in r}
        if len(seen) < floor:
            errors.append(f"traffic: need >= {floor} distinct {key!r} values, got "
                          f"{len(seen)} ({sorted(map(str, seen))})")
    for i, r in enumerate(rows):
        ctx = f"traffic row {i} ({r.get('family')}/{r.get('scenario')})"
        if "wall_s" in r and not (_num(r["wall_s"]) and r["wall_s"] > 0):
            errors.append(f"{ctx}: wall_s not positive")
        if _num(r.get("goodput_tok_per_s")) and _num(r.get("tok_per_s")) and \
                r["goodput_tok_per_s"] > r["tok_per_s"] + 1e-9:
            errors.append(f"{ctx}: goodput exceeds throughput")
        if all(k in r for k in ("n_completed", "n_cancelled", "n_deadline_missed",
                                "n_requests")) and \
                r["n_completed"] + r["n_cancelled"] + r["n_deadline_missed"] != r["n_requests"]:
            errors.append(f"{ctx}: outcome counts do not partition n_requests")
        if all(k in r for k in ("cancels", "n_cancelled", "n_deadline_missed")) and \
                r["cancels"] != r["n_cancelled"] + r["n_deadline_missed"]:
            errors.append(f"{ctx}: registry cancel count disagrees with outcomes")
        for block in TRAFFIC_PCT_BLOCKS:
            b = r.get(block)
            if isinstance(b, dict) and not (b.get("count") or 0) > 0:
                errors.append(f"{ctx}: empty {block} histogram")
    return errors


def check_traffic_schema(rec: dict, diversity: dict | None = None) -> None:
    """Raise ``ValueError`` listing every error :func:`traffic_schema_errors`
    finds in ``rec``."""
    errors = traffic_schema_errors(rec, diversity)
    if errors:
        raise ValueError("; ".join(errors))
