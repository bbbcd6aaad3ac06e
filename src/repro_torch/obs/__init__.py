"""repro_torch.obs — observability for the port's serving stack (counterpart
of ``repro.obs``).

One :class:`Observer` bundles three layers:

* a :class:`~repro_torch.obs.registry.MetricsRegistry` (counters / gauges /
  mergeable fixed-bucket histograms with exact-to-one-bucket percentiles),
* a :class:`~repro_torch.obs.trace.Trace` of structured scheduler events
  (monotonic timestamps, optionally streamed to JSONL),
* optional ``torch.profiler.record_function`` spans around the engine's
  prefill and decode dispatches.

**Off unless asked for, and no environment.**  Components take an
``obs=None`` argument: ``None`` and ``False`` mean no observer (the hot path
pays one ``is None`` check a site, no allocation, no device sync), and an
:class:`Observer` or an enabled :class:`ObsConfig` turns instrumentation on.
The port reads no environment variable: ``repro``'s ``REPRO_OBS*`` knobs and
its process-default observer have no counterpart here, so ``ObsConfig`` has
no ``from_env``.  Enabling obs adds host-side bookkeeping only; it inserts
no device sync the engine was not already making.  ``kernel_timing`` is the
one exception by design: it opens ``kernels.dispatch.kernel_timing()``
around the engine's dispatches, which fences each kernel call with
``torch.cuda.synchronize()`` to time it.
"""
from __future__ import annotations

from dataclasses import dataclass

from .export import (  # noqa: F401  (public re-exports)
    JsonlWriter,
    bench_summary,
    prometheus_text,
    read_jsonl,
    validate_events,
    validate_jsonl,
)
from .registry import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exp_buckets,
)
from .trace import EVENT_FIELDS, Trace, annotate, maybe_annotate  # noqa: F401


@dataclass(frozen=True)
class ObsConfig:
    """What to record.  ``enabled=False`` means "no observer at all"."""

    enabled: bool = True
    jsonl_path: str | None = None       # stream trace events here
    profiler_annotations: bool = False  # record_function spans on dispatch
    kernel_timing: bool = False         # fenced per-kernel wall histograms
    pool_sample_every: int = 1          # ticks between pool gauge samples

    def __post_init__(self):
        if self.pool_sample_every < 1:
            raise ValueError("pool_sample_every must be >= 1")


class Observer:
    """Live instrumentation handle: registry + trace (+ profiler spans)."""

    def __init__(self, config: ObsConfig | None = None, *,
                 registry: MetricsRegistry | None = None):
        self.config = config if config is not None else ObsConfig()
        self.registry = registry if registry is not None else MetricsRegistry()
        writer = (JsonlWriter(self.config.jsonl_path)
                  if self.config.jsonl_path else None)
        self.trace = Trace(writer=writer)

    def event(self, ev: str, t: float | None = None, **fields) -> dict:
        return self.trace.emit(ev, t=t, **fields)

    def annotate(self, name: str):
        """Profiler span when ``profiler_annotations`` is on, else no-op."""
        return maybe_annotate(name, self.config.profiler_annotations)

    def close(self) -> None:
        self.trace.close()


def resolve_observer(obs) -> Observer | None:
    """Normalize a component's ``obs`` argument: ``None`` or ``False`` → no
    observer; an :class:`Observer` passes through; an :class:`ObsConfig`
    builds a fresh observer (or ``None`` when ``enabled=False``)."""
    if obs is None or obs is False:
        return None
    if isinstance(obs, Observer):
        return obs
    if isinstance(obs, ObsConfig):
        return Observer(obs) if obs.enabled else None
    raise TypeError(f"obs must be None, False, ObsConfig or Observer; "
                    f"got {type(obs).__name__}")
