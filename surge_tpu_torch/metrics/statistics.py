"""Metric value providers — the statistics behind every sensor.

Equivalents of modules/metrics/src/main/scala/surge/metrics/statistics/*: Count, Min,
Max, MostRecentValue, ExponentialWeightedMovingAverage (timers use EWMA(0.95),
Metrics.scala:134-172), RateHistogram over 1/5/15-minute windows, and a fixed-bucket
time histogram. Providers are updated by :class:`~surge_tpu_torch.metrics.Sensor` and read by
the registry snapshot."""

from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Callable, Deque, List, Protocol, Sequence, Tuple

from surge_tpu_torch.tracing import active_trace_id


class MetricValueProvider(Protocol):
    def update(self, value: float, timestamp: float) -> None: ...

    def get_value(self) -> float: ...


class Count:
    """Running total of recorded values (statistics/Count.scala)."""

    def __init__(self) -> None:
        self._total = 0.0

    def update(self, value: float, timestamp: float) -> None:
        self._total += value

    def get_value(self) -> float:
        return self._total


class MostRecentValue:
    def __init__(self) -> None:
        self._value = 0.0

    def update(self, value: float, timestamp: float) -> None:
        self._value = value

    def get_value(self) -> float:
        return self._value


class Min:
    def __init__(self) -> None:
        self._value: float | None = None

    def update(self, value: float, timestamp: float) -> None:
        self._value = value if self._value is None else min(self._value, value)

    def get_value(self) -> float:
        return 0.0 if self._value is None else self._value


class Max:
    def __init__(self) -> None:
        self._value: float | None = None

    def update(self, value: float, timestamp: float) -> None:
        self._value = value if self._value is None else max(self._value, value)

    def get_value(self) -> float:
        return 0.0 if self._value is None else self._value


class ExponentialWeightedMovingAverage:
    """EWMA with the reference's timer smoothing (alpha weight on history, 0.95
    default — Metrics.scala:141-147)."""

    def __init__(self, alpha: float = 0.95) -> None:
        self.alpha = alpha
        self._value = 0.0
        self._initialized = False

    def update(self, value: float, timestamp: float) -> None:
        if not self._initialized:
            self._value = value
            self._initialized = True
        else:
            self._value = self.alpha * self._value + (1.0 - self.alpha) * value

    def get_value(self) -> float:
        return self._value


class _StatView:
    """Read-only registry adapter over one statistic of a fused provider —
    registered under its export name (``<timer>.min`` etc.) while the ONE
    fused provider does the per-record work."""

    __slots__ = ("_fn",)

    def __init__(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def update(self, value: float, timestamp: float) -> None:
        """No-op: the owning FusedTimerStats records; views only export."""

    def get_value(self) -> float:
        return self._fn()


class FusedTimerStats:
    """All four timer statistics — EWMA, min, max and the bucket histogram —
    in ONE provider update. A timer recording used to dispatch four provider
    ``update`` calls per observation; at command-path rates (several timers
    per command, one per broker Transact) the call overhead alone was
    measurable, so the sensor now fans into this single provider and the
    registry exports the individual statistics through views
    (:class:`_StatView`) and the embedded :class:`TimeBucketHistogram`.
    ``get_value`` reports the EWMA — the fused provider itself registers
    under the timer's base name, exactly like the EWMA it replaces."""

    __slots__ = ("histogram", "alpha", "_ewma", "_ewma_init", "_min", "_max")

    def __init__(self, histogram: "TimeBucketHistogram",
                 alpha: float = 0.95) -> None:
        self.histogram = histogram
        self.alpha = alpha
        self._ewma = 0.0
        self._ewma_init = False
        self._min: float | None = None
        self._max: float | None = None

    def update(self, value: float, timestamp: float) -> None:
        if self._ewma_init:
            self._ewma = self.alpha * self._ewma + (1.0 - self.alpha) * value
        else:
            self._ewma = value
            self._ewma_init = True
        mn = self._min
        if mn is None or value < mn:
            self._min = value
        mx = self._max
        if mx is None or value > mx:
            self._max = value
        self.histogram.update(value, timestamp)

    def get_value(self) -> float:
        return self._ewma

    def min_view(self) -> _StatView:
        return _StatView(lambda: 0.0 if self._min is None else self._min)

    def max_view(self) -> _StatView:
        return _StatView(lambda: 0.0 if self._max is None else self._max)


class RateHistogram:
    """Events/second over a sliding window (statistics/RateHistogram.scala; the
    registry exposes 1/5/15-minute variants). ``clock`` is injectable so rate
    assertions can run against a frozen time source instead of ``time.time``."""

    def __init__(self, window_s: float,
                 clock: Callable[[], float] = time.time) -> None:
        self.window_s = window_s
        self._clock = clock
        self._events: Deque[Tuple[float, float]] = deque()  # (timestamp, weight)
        self._sum = 0.0

    def update(self, value: float, timestamp: float) -> None:
        self._events.append((timestamp, value))
        self._sum += value
        self._evict(timestamp)

    def _evict(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            _, w = self._events.popleft()
            self._sum -= w

    def get_value(self) -> float:
        self._evict(self._clock())
        return self._sum / self.window_s


class TimeBucketHistogram:
    """Counts of recorded durations falling into fixed latency buckets
    (statistics/TimeBucketHistogram.scala analog). ``get_value`` reports the p-th
    percentile estimate (upper bucket bound). The full distribution —
    ``bucket_counts()`` (cumulative), ``total_count``, ``sum_value`` — backs the
    OpenMetrics ``_bucket``/``_sum``/``_count`` series
    (:mod:`surge_tpu_torch.metrics.exposition`).

    With ``exemplars=True`` each recording also captures the ACTIVE trace id
    (:func:`surge_tpu_torch.tracing.active_trace_id` — the span the recording thread
    or task is inside of), keeping the newest exemplar per bucket; the
    exposition renders them in OpenMetrics ``# {trace_id="..."}`` syntax so a
    p99 latency bucket links straight to one JSONL trace that landed in it."""

    def __init__(self, buckets_ms: Sequence[float] = (1, 5, 10, 25, 50, 100, 250, 500,
                                                      1000, 2500, 5000, 10000),
                 percentile: float = 0.99, exemplars: bool = False) -> None:
        self.bounds: List[float] = sorted(buckets_ms)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.percentile = percentile
        self._total = 0
        self._sum = 0.0
        #: bucket index -> (trace_id, recorded value, unix timestamp); None
        #: when exemplar capture is off (the default — no per-update overhead)
        self._exemplars: "dict[int, Tuple[str, float, float]] | None" = (
            {} if exemplars else None)

    def update(self, value: float, timestamp: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        self.counts[idx] += 1
        self._total += 1
        self._sum += value
        if self._exemplars is not None:
            trace_id = active_trace_id()
            if trace_id is not None:
                self._exemplars[idx] = (trace_id, value, timestamp)

    def exemplars(self) -> "dict[int, Tuple[str, float, float]]":
        """Newest captured exemplar per bucket index (empty when disabled)."""
        return dict(self._exemplars) if self._exemplars else {}

    def get_value(self) -> float:
        """Percentile estimate. An overflow-bucket hit reports the largest
        FINITE bound: a ``float("inf")`` here broke every numeric export (JSON
        has no Infinity; the text format would emit a non-plottable point) —
        the true unbounded tail is visible in the exposition's ``+Inf`` bucket
        instead."""
        if self._total == 0:
            return 0.0
        target = self.percentile * self._total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]

    @property
    def total_count(self) -> int:
        return self._total

    @property
    def sum_value(self) -> float:
        return self._sum

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative ``(upper_bound, count)`` pairs ending with ``(+Inf, total)``
        — exactly the Prometheus/OpenMetrics histogram contract."""
        out: List[Tuple[float, int]] = []
        running = 0
        for bound, c in zip(self.bounds, self.counts):
            running += c
            out.append((bound, running))
        out.append((float("inf"), self._total))
        return out
