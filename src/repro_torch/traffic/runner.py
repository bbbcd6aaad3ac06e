"""Open-loop traffic player: replay a workload against the async front end
(counterpart of ``repro.traffic.runner``).

:func:`play` drives an :class:`~repro_torch.serve.frontend.AsyncEngine` with
a :func:`~repro_torch.traffic.workload.make_workload` schedule, open-loop: requests
are submitted at their scheduled arrival times whether or not the engine has
kept up (the realistic serving regime — a slow engine builds a queue, it
does not slow the clients down).  Each submission gets a consumer coroutine
draining its token stream and, when the schedule says the client abandons,
a cancel timer racing the request's completion.  Everything shares one event
loop with the engine pump, so consumer wakeups interleave with device
dispatch exactly as they would in a real server.

``time_scale`` stretches the *entire* schedule uniformly — arrivals,
deadlines, TTFT SLOs, and cancel points — so one workload spec is meaningful
on both a CPU test (``time_scale`` above 1) and the card
(``time_scale=1``): the shape of the contention is preserved, only the clock
changes.

Latency accounting deliberately reuses the **engine's** monotonic stamps
(``Request.t_submit`` / ``t_first`` / ``t_done``) via
:func:`~repro_torch.traffic.report.outcome_of` rather than timing in the consumer
coroutines — the obs registry is the single source of truth for percentiles
and the outcomes must agree with it.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

from .report import RequestOutcome, outcome_of
from .workload import TrafficRequest


@dataclass
class TrafficResult:
    """One scenario replay: per-request outcomes + the wall clock."""

    outcomes: list[RequestOutcome]
    wall_s: float
    time_scale: float


async def play(frontend, requests: list[TrafficRequest], *,
               time_scale: float = 1.0) -> TrafficResult:
    """Replay ``requests`` (sorted by arrival) against ``frontend``.

    Returns when every request finished, cancelled, or expired; a pump
    failure propagates.  ``frontend`` is any object with the
    :class:`~repro_torch.serve.frontend.AsyncEngine` submit/drain surface.
    """
    if time_scale <= 0:
        raise ValueError("time_scale must be > 0")
    handles = []
    aux: list[asyncio.Task] = []

    async def consume(handle):
        async for _ in handle.stream():
            pass

    async def cancel_later(handle, delay: float):
        # race the client's patience against the request finishing first
        try:
            await asyncio.wait_for(handle.wait_done(), timeout=delay)
        except asyncio.TimeoutError:
            handle.cancel()

    t0 = time.perf_counter()
    for treq in requests:
        delay = treq.t_arrival * time_scale - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        handle = frontend.submit(
            treq.prompt, max_tokens=treq.max_tokens,
            deadline_s=(None if treq.deadline_s is None
                        else treq.deadline_s * time_scale))
        handles.append(handle)
        aux.append(asyncio.create_task(consume(handle)))
        if treq.cancel_after_s is not None:
            aux.append(asyncio.create_task(
                cancel_later(handle, treq.cancel_after_s * time_scale)))
    await frontend.drain()
    await asyncio.gather(*aux)
    wall = time.perf_counter() - t0
    outcomes = [
        outcome_of(h.req, idx=treq.idx,
                   ttft_slo_s=(None if treq.ttft_slo_s is None
                               else treq.ttft_slo_s * time_scale))
        for treq, h in zip(requests, handles)]
    return TrafficResult(outcomes=outcomes, wall_s=wall,
                         time_scale=time_scale)


def drive(frontend, requests: list[TrafficRequest], *,
          time_scale: float = 1.0) -> TrafficResult:
    """Synchronous wrapper: run :func:`play` on a fresh event loop."""
    return asyncio.run(play(frontend, requests, time_scale=time_scale))
