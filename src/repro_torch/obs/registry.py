"""Process-local metrics registry: counters, gauges, fixed-bucket histograms
(counterpart of ``repro.obs.registry``, copied: the port imports nothing of
``repro``).

Zero-dependency (stdlib only — no torch, no numpy) so the serving scheduler
and the kernel dispatcher can record into one registry without import
cycles or device work.  The three metric kinds mirror the
Prometheus data model (``repro_torch.obs.export`` renders the text exposition
format), but percentiles are computed *here*, from the buckets, so
benchmarks never need a scrape pipeline:

* :class:`Counter` — monotonically increasing float.
* :class:`Gauge` — last-written float (pool utilization, tokens/sec).
* :class:`Histogram` — fixed upper-bound buckets; ``percentile(q)`` is
  exact to one bucket width (it returns the upper edge of the bucket
  holding the rank-``q`` observation, or the observed max for the overflow
  bucket), and histograms with identical boundaries :meth:`~Histogram.merge`
  losslessly — the multi-process story is "merge the snapshots".

All operations are O(1) except ``percentile`` (O(buckets)); nothing here
allocates on the observe path beyond float arithmetic, which is what lets
the serving engine keep its overhead contract.
"""
from __future__ import annotations

import bisect
from typing import Iterator


def exp_buckets(start: float, factor: float, count: int) -> tuple[float, ...]:
    """``count`` exponentially spaced bucket upper bounds from ``start``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# 10µs … ~160s at ~35% resolution: covers one kernel launch up to a
# multi-minute CPU prefill with one bucket scheme, so histograms recorded
# anywhere in the stack stay mergeable (and merge with ``repro``'s, which
# use the same edges).
DEFAULT_LATENCY_BUCKETS = exp_buckets(1e-5, 1.35, 56)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram over ascending upper bounds.

    Bucket *i* counts observations ``v <= boundaries[i]`` (and above the
    previous bound); one implicit overflow bucket catches the rest.  Tracks
    count / sum / min / max exactly.
    """

    __slots__ = ("boundaries", "counts", "count", "sum", "vmin", "vmax")

    def __init__(self, boundaries=DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in boundaries)
        if not bounds or any(a >= b for a, b in zip(bounds, bounds[1:])):
            raise ValueError("boundaries must be non-empty and ascending")
        self.boundaries = bounds
        self.counts = [0] * (len(bounds) + 1)  # [-1] = overflow
        self.count = 0
        self.sum = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.boundaries, v)] += 1
        self.count += 1
        self.sum += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> float | None:
        """Value at quantile ``q`` ∈ [0, 1], exact to one bucket width.

        Returns the upper edge of the bucket containing the rank-``q``
        observation (the true value is ≤ that edge and > the previous one);
        the overflow bucket reports the observed max.  ``None`` when empty.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return None
        rank = max(1, -(-q * self.count // 1))  # ceil(q * count), at least 1
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                if i == len(self.boundaries):
                    return self.vmax
                # tighten to observed extremes: a single-bucket histogram
                # should still report a value that was actually seen
                edge = self.boundaries[i]
                return min(edge, self.vmax) if self.vmax is not None else edge
        return self.vmax  # unreachable

    def merge(self, other: "Histogram") -> None:
        if self.boundaries != other.boundaries:
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for v in (other.vmin, other.vmax):
            if v is None:
                continue
            if self.vmin is None or v < self.vmin:
                self.vmin = v
            if self.vmax is None or v > self.vmax:
                self.vmax = v


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create store of named, labelled metrics.

    A metric identity is ``(name, sorted label items)``; a name is pinned to
    one kind at first use (asking for the same name as a different kind
    raises, mirroring Prometheus).  Registries merge (counters/sums add,
    gauges take the other's last write, histograms bucket-merge), which is
    the aggregation story for per-engine or per-process registries.
    """

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._kinds: dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: dict, **kw):
        seen = self._kinds.setdefault(name, kind)
        if seen != kind:
            raise ValueError(f"metric {name!r} already registered as {seen}")
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = _KINDS[kind](**kw)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        kw = {} if buckets is None else {"boundaries": buckets}
        return self._get("histogram", name, labels, **kw)

    def get(self, name: str, **labels):
        """Existing metric or ``None`` (never creates)."""
        return self._metrics.get((name, tuple(sorted(labels.items()))))

    def kind(self, name: str) -> str | None:
        return self._kinds.get(name)

    def collect(self) -> Iterator[tuple[str, dict, object]]:
        """(name, labels, metric) in insertion order."""
        for (name, labels), m in self._metrics.items():
            yield name, dict(labels), m

    def merge(self, other: "MetricsRegistry") -> None:
        for name, labels, m in other.collect():
            kind = other._kinds[name]
            mine = self._get(kind, name, labels,
                             **({"boundaries": m.boundaries}
                                if kind == "histogram" else {}))
            if kind == "counter":
                mine.inc(m.value)
            elif kind == "gauge":
                mine.set(m.value)
            else:
                mine.merge(m)

    def reset(self) -> None:
        self._metrics.clear()
        self._kinds.clear()
