"""repro_torch.traffic — reproducible serving traffic: workloads, replay,
reports (counterpart of ``repro.traffic``).

* :mod:`~repro_torch.traffic.workload` — declarative :class:`WorkloadSpec`
  (seeded Poisson/bursty arrivals, bucket-mixture lengths, SLOs, deadlines,
  client cancellations) expanded deterministically by :func:`make_workload`,
  to the same schedule as ``repro``'s.
* :mod:`~repro_torch.traffic.runner` — :func:`play`/:func:`drive` replay a
  schedule open-loop against the port's
  :class:`~repro_torch.serve.frontend.AsyncEngine`, with ``time_scale``
  stretching the whole clock.
* :mod:`~repro_torch.traffic.report` — obs-registry percentile rows,
  per-request outcomes, goodput (SLO-attained tok/s), and the traffic
  report's schema check.
"""
from .report import (  # noqa: F401
    RequestOutcome,
    check_traffic_schema,
    goodput_tok_per_s,
    outcome_of,
    pct_row,
    registry_summary,
    traffic_row,
    traffic_schema_errors,
)
from .runner import TrafficResult, drive, play  # noqa: F401
from .workload import TrafficRequest, WorkloadSpec, make_workload  # noqa: F401
