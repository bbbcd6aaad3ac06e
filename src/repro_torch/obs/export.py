"""Exporters for the obs layer: JSONL event logs, Prometheus text, BENCH JSON
(counterpart of ``repro.obs.export``; the formats are ``repro``'s).

Three consumers, three formats:

* :class:`JsonlWriter` — streams trace events to disk one JSON object per
  line (line-buffered, so the file is valid after a crash mid-run);
  :func:`validate_jsonl` checks the result, runnable standalone as
  ``python -m repro_torch.obs --validate <path>``.
* :func:`prometheus_text` — the Prometheus text exposition format
  (``name{labels} value``, histogram ``_bucket``/``_sum``/``_count``
  series with cumulative ``le`` edges) from a
  :class:`~repro_torch.obs.registry.MetricsRegistry` snapshot.
* :func:`bench_summary` — the compact JSON summary the ``BENCH_*.json``
  files embed: per-histogram count/mean/p50/p95/p99, counters and gauges
  verbatim.
"""
from __future__ import annotations

import atexit
import json
import math
from pathlib import Path

from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .trace import EVENT_FIELDS

# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------


class JsonlWriter:
    """Append-only JSONL sink; opens lazily, one ``json.dumps`` per event.

    Line-buffered text IO: every event is flushed at its newline, so the
    log is complete even if the process dies without a clean close.
    """

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None

    def write(self, rec: dict) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)  # noqa: SIM115  long-lived handle, closed in close()
            atexit.register(self.close)
        self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_jsonl(path) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


# ---------------------------------------------------------------------------
# Event schema validation
# ---------------------------------------------------------------------------
_COMMON = {"ev": str, "t": (int, float), "seq": int}
_FIELD_TYPES = {
    "rid": int, "slot": int, "tick": int, "prompt_len": int,
    "max_tokens": int, "n_tokens": int, "chunk": int, "n_chunks": int,
    "rids": list, "ttft_s": (int, float), "active": int, "reason": str,
    "n_out": int, "utilization": (int, float), "free_blocks": int,
    "live_tokens": int, "active_slots": int, "deadline_s": (int, float),
}
EVENT_SCHEMA = {
    ev: {**_COMMON, **{f: _FIELD_TYPES[f] for f in fields}}
    for ev, fields in EVENT_FIELDS.items()
}


def validate_events(events) -> list[str]:
    """Schema errors for an iterable of event dicts ([] = valid).

    Checks: known event type, required fields present with the right types,
    finite timestamps, and non-decreasing ``seq`` (emission order survived
    serialization).
    """
    errors = []
    last_seq = -1
    for i, e in enumerate(events):
        where = f"event {i}"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ev = e.get("ev")
        schema = EVENT_SCHEMA.get(ev)
        if schema is None:
            errors.append(f"{where}: unknown event type {ev!r}")
            continue
        for f, typ in schema.items():
            if f not in e:
                errors.append(f"{where} ({ev}): missing field {f!r}")
            elif not isinstance(e[f], typ) or isinstance(e[f], bool):
                errors.append(f"{where} ({ev}): field {f!r} has "
                              f"{type(e[f]).__name__}, want {typ}")
        t = e.get("t")
        if isinstance(t, (int, float)) and not math.isfinite(t):
            errors.append(f"{where} ({ev}): non-finite timestamp {t}")
        seq = e.get("seq")
        if isinstance(seq, int):
            if seq < last_seq:
                errors.append(f"{where} ({ev}): seq {seq} < previous {last_seq}")
            last_seq = seq
    return errors


def validate_jsonl(path) -> list[str]:
    try:
        events = read_jsonl(path)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: {e}"]
    if not events:
        return [f"{path}: no events"]
    return validate_events(events)


# ---------------------------------------------------------------------------
# Registry snapshots
# ---------------------------------------------------------------------------
def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_val(v: float) -> str:
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition format snapshot of ``registry``."""
    lines = []
    typed: set[str] = set()
    for name, labels, m in registry.collect():
        if name not in typed:
            typed.add(name)
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(m)]
            lines.append(f"# TYPE {name} {kind}")
        if isinstance(m, (Counter, Gauge)):
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_val(m.value)}")
            continue
        cum = 0
        for edge, c in zip(m.boundaries, m.counts):
            cum += c
            lab = _fmt_labels({**labels, "le": _fmt_val(edge)})
            lines.append(f"{name}_bucket{lab} {cum}")
        lab = _fmt_labels({**labels, "le": "+Inf"})
        lines.append(f"{name}_bucket{lab} {m.count}")
        lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_val(m.sum)}")
        lines.append(f"{name}_count{_fmt_labels(labels)} {m.count}")
    return "\n".join(lines) + "\n"


def bench_summary(registry: MetricsRegistry) -> dict:
    """BENCH-compatible JSON summary: histograms as percentile rows."""
    out: dict[str, list] = {}
    for name, labels, m in registry.collect():
        if isinstance(m, Histogram):
            row = {"labels": labels, "count": m.count, "mean": m.mean(),
                   "min": m.vmin, "max": m.vmax,
                   "p50": m.percentile(0.50), "p95": m.percentile(0.95),
                   "p99": m.percentile(0.99)}
        else:
            row = {"labels": labels, "value": m.value}
        out.setdefault(name, []).append(row)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate an obs JSONL event log against the schema")
    ap.add_argument("--validate", metavar="PATH", required=True,
                    help="JSONL trace to check; exits 1 on any schema error")
    args = ap.parse_args(argv)
    errors = validate_jsonl(args.validate)
    if errors:
        for e in errors[:50]:
            print(f"INVALID: {e}")
        return 1
    n = len(read_jsonl(args.validate))
    print(f"OK: {args.validate} ({n} events, schema-valid)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
