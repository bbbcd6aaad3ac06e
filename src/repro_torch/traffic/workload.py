"""Reproducible serving workloads: seeded arrivals, lengths, SLOs, cancels
(counterpart of ``repro.traffic.workload``, copied: one spec expands to the
same schedule in both packages).

A :class:`WorkloadSpec` describes a traffic pattern declaratively and
:func:`make_workload` expands it into a concrete, fully deterministic list of
:class:`TrafficRequest` — every arrival time, prompt token, output budget,
and cancellation point is drawn from one ``numpy`` generator seeded by
``spec.seed``, so a scenario re-runs bit-identically across machines and the
fuzz suite can shrink failures by seed.

Arrival processes:

* ``poisson`` — independent exponential inter-arrival gaps at ``rate_rps``
  requests/second (the classic open-loop serving assumption).
* ``bursty`` — arrivals come in bursts of ``burst_size`` *simultaneous*
  requests; the gaps between bursts are exponential at
  ``rate_rps / burst_size`` bursts/second, so the long-run request rate
  still equals ``rate_rps`` while the instantaneous load spikes (the
  admission/preemption stress case).

Lengths are drawn from small bucket mixtures (``prompt_len_buckets`` /
``out_tokens_buckets`` with matching weights) rather than continuous
distributions: buckets keep the step shapes repeatable while still mixing
short/long requests in one schedule.  Per-request service levels ride along:
``ttft_slo_s`` marks a request SLO-attained only when its first token
arrived in time (goodput accounting, ``repro_torch.traffic.report``),
``deadline_s`` is handed to ``Engine.submit`` and *enforced* by the
scheduler, and ``cancel_prob`` picks requests that a client will abandon
mid-stream after a uniform draw from ``cancel_window_s`` seconds.

All times here are *unscaled* seconds; the runner's ``time_scale`` stretches
arrivals, deadlines, SLOs, and cancel points uniformly so one spec serves
both a CPU test and the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class WorkloadSpec:
    """Declarative traffic pattern; expand with :func:`make_workload`."""

    n_requests: int = 32
    arrival: str = "poisson"               # poisson | bursty
    rate_rps: float = 8.0                  # long-run request arrival rate
    burst_size: int = 4                    # requests per burst (bursty only)
    prompt_len_buckets: Sequence[int] = (8, 24, 48)
    prompt_len_weights: Sequence[float] = (0.5, 0.35, 0.15)
    out_tokens_buckets: Sequence[int] = (4, 16, 32)
    out_tokens_weights: Sequence[float] = (0.55, 0.3, 0.15)
    vocab: int = 256                       # prompt tokens drawn from [1, vocab)
    ttft_slo_s: float | None = None        # first-token SLO (goodput gate)
    deadline_s: float | None = None        # engine-enforced completion budget
    cancel_prob: float = 0.0               # P(client abandons mid-stream)
    cancel_window_s: tuple[float, float] = (0.05, 0.5)
    seed: int = 0

    def validate(self) -> None:
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(f"arrival must be 'poisson' or 'bursty', "
                             f"got {self.arrival!r}")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        if self.arrival == "bursty" and self.burst_size < 1:
            raise ValueError("burst_size must be >= 1")
        for name, buckets, weights in (
                ("prompt_len", self.prompt_len_buckets, self.prompt_len_weights),
                ("out_tokens", self.out_tokens_buckets, self.out_tokens_weights)):
            if not buckets or len(buckets) != len(weights):
                raise ValueError(f"{name}_buckets and {name}_weights must be "
                                 "non-empty and the same length")
            if any(b < 1 for b in buckets):
                raise ValueError(f"{name}_buckets must be positive")
            if any(w < 0 for w in weights) or sum(weights) <= 0:
                raise ValueError(f"{name}_weights must be non-negative and "
                                 "sum > 0")
        if self.vocab < 2:
            raise ValueError("vocab must be >= 2")
        if not 0.0 <= self.cancel_prob <= 1.0:
            raise ValueError("cancel_prob must be in [0, 1]")
        lo, hi = self.cancel_window_s
        if lo < 0 or hi < lo:
            raise ValueError("cancel_window_s must be 0 <= lo <= hi")
        if self.ttft_slo_s is not None and self.ttft_slo_s <= 0:
            raise ValueError("ttft_slo_s must be > 0 (or None)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")

    def to_dict(self) -> dict:
        """JSON-ready spec record (embedded in BENCH rows for provenance)."""
        return {
            "n_requests": self.n_requests, "arrival": self.arrival,
            "rate_rps": self.rate_rps, "burst_size": self.burst_size,
            "prompt_len_buckets": list(self.prompt_len_buckets),
            "prompt_len_weights": list(self.prompt_len_weights),
            "out_tokens_buckets": list(self.out_tokens_buckets),
            "out_tokens_weights": list(self.out_tokens_weights),
            "vocab": self.vocab, "ttft_slo_s": self.ttft_slo_s,
            "deadline_s": self.deadline_s, "cancel_prob": self.cancel_prob,
            "cancel_window_s": list(self.cancel_window_s), "seed": self.seed,
        }


@dataclass
class TrafficRequest:
    """One concrete arrival: everything the runner needs to play it."""

    idx: int                          # position in the schedule
    t_arrival: float                  # seconds from scenario start (unscaled)
    prompt: list[int] = field(repr=False, default_factory=list)
    max_tokens: int = 16
    ttft_slo_s: float | None = None
    deadline_s: float | None = None
    cancel_after_s: float | None = None  # client abandons this long after submit


def _arrival_times(spec: WorkloadSpec, rng: np.random.Generator) -> np.ndarray:
    n = spec.n_requests
    if spec.arrival == "poisson":
        gaps = rng.exponential(1.0 / spec.rate_rps, size=n)
        return np.cumsum(gaps)
    # bursty: bursts of burst_size simultaneous arrivals, exponential gaps
    # between bursts at rate_rps / burst_size so the long-run rate matches
    n_bursts = -(-n // spec.burst_size)
    gaps = rng.exponential(spec.burst_size / spec.rate_rps, size=n_bursts)
    burst_t = np.cumsum(gaps)
    return np.repeat(burst_t, spec.burst_size)[:n]


def _bucket_draws(buckets, weights, n: int, rng: np.random.Generator):
    p = np.asarray(weights, np.float64)
    p = p / p.sum()
    return rng.choice(np.asarray(buckets, np.int64), size=n, p=p)


def make_workload(spec: WorkloadSpec) -> list[TrafficRequest]:
    """Expand ``spec`` into its deterministic request schedule.

    Same spec (same seed) → bit-identical schedule: arrivals, prompt tokens,
    output budgets, and cancellation points all come from one seeded
    generator, drawn in a fixed order.
    """
    spec.validate()
    rng = np.random.default_rng(spec.seed)
    arrivals = _arrival_times(spec, rng)
    plens = _bucket_draws(spec.prompt_len_buckets, spec.prompt_len_weights,
                          spec.n_requests, rng)
    outs = _bucket_draws(spec.out_tokens_buckets, spec.out_tokens_weights,
                         spec.n_requests, rng)
    cancel_u = rng.random(spec.n_requests)
    lo, hi = spec.cancel_window_s
    cancel_at = rng.uniform(lo, hi, size=spec.n_requests)
    reqs = []
    for i in range(spec.n_requests):
        prompt = [int(t) for t in rng.integers(1, spec.vocab, int(plens[i]))]
        cancels = spec.cancel_prob > 0 and cancel_u[i] < spec.cancel_prob
        reqs.append(TrafficRequest(
            idx=i, t_arrival=float(arrivals[i]), prompt=prompt,
            max_tokens=int(outs[i]), ttft_slo_s=spec.ttft_slo_s,
            deadline_s=spec.deadline_s,
            cancel_after_s=float(cancel_at[i]) if cancels else None))
    return reqs
