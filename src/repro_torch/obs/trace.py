"""Structured scheduler event trace and optional ``torch.profiler`` spans
(counterpart of ``repro.obs.trace``).

The serving engine narrates its scheduling decisions as a flat stream of
dict events — one per submit / admit / prefill chunk / first token / decode
tick / preemption / cancel / deadline miss / finish / pool sample — each
stamped with a **monotonic** timestamp (``time.perf_counter``; wall-clock
never enters duration math) and a process-wide sequence number.  The event
types and their fields are ``repro``'s, so one validator reads both
packages' logs.

``annotate`` wraps a region in ``torch.profiler.record_function`` (in place
of ``jax.profiler.TraceAnnotation``), so the engine's prefill and decode
dispatches show up as named spans in a ``torch.profiler`` trace; disabled,
it is a ``nullcontext``.
"""
from __future__ import annotations

import contextlib
import itertools
import time

# Event types and their required per-type fields (beyond the common
# ``ev`` / ``t`` / ``seq``).  ``export.EVENT_SCHEMA`` builds the full
# field-type map from this table.
EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "submit": ("rid", "prompt_len", "max_tokens"),
    "admit": ("rid", "slot", "tick", "n_tokens"),
    "prefill_chunk": ("tick", "chunk", "n_chunks", "rids"),
    "first_token": ("rid", "tick", "ttft_s"),
    "decode_tick": ("tick", "active"),
    "preempt": ("rid", "slot", "tick"),
    "cancel": ("rid", "slot", "tick", "reason"),
    "deadline_miss": ("rid", "tick", "deadline_s"),
    "finish": ("rid", "tick", "reason", "n_out"),
    "pool_sample": ("tick", "utilization", "free_blocks", "live_tokens",
                    "active_slots"),
}

_seq = itertools.count()


class Trace:
    """Append-only event log with monotonic timestamps.

    ``writer`` (anything with a ``write(dict)`` method — see
    ``export.JsonlWriter``) receives every event as it is emitted; ``keep``
    retains events in memory for in-process inspection.
    """

    def __init__(self, writer=None, keep: bool = True):
        self.events: list[dict] = []
        self._writer = writer
        self._keep = keep

    def emit(self, ev: str, t: float | None = None, **fields) -> dict:
        """Record one event; ``t`` defaults to ``perf_counter()`` now but may
        be passed in so an event reuses a stamp already taken (the TTFT stamp
        taken after the prefill's tokens reached the host)."""
        rec = {"ev": ev, "t": time.perf_counter() if t is None else t,
               "seq": next(_seq), **fields}
        if self._keep:
            self.events.append(rec)
        if self._writer is not None:
            self._writer.write(rec)
        return rec

    def by_type(self, ev: str) -> list[dict]:
        return [e for e in self.events if e["ev"] == ev]

    def close(self) -> None:
        if self._writer is not None and hasattr(self._writer, "close"):
            self._writer.close()


def annotate(name: str):
    """A ``torch.profiler.record_function`` region named ``name``; the import
    is local so the metrics path never pulls in torch."""
    from torch.profiler import record_function
    return record_function(name)


def maybe_annotate(name: str, enabled: bool):
    return annotate(name) if enabled else contextlib.nullcontext()
