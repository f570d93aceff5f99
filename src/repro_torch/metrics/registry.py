"""Always-on serving metrics: counters, gauges, histograms, one registry.

``repro_torch.trace`` captures bounded, after-the-fact trace files; a
long-lived serving engine needs the complement -- *always-on* telemetry
it can report at any instant without ever filling a buffer.  This module
is that layer's core: three Prometheus-shaped primitives and a registry
that hands them out by (name, labels) identity.

Design points, in the same spirit as ``trace.Tracer``:

  * **Lock-cheap hot path.**  ``Counter.inc`` / ``Gauge.set`` /
    ``Histogram.observe`` are a handful of attribute ops under the GIL
    -- no locks, no allocation.  Only registry *creation* (get-or-create
    of a metric series) takes a lock, and instrumented code hoists that
    to init time.
  * **Falsy null object.**  :data:`NULL_REGISTRY` mirrors
    ``trace.NULL``: ``bool(NULL_REGISTRY)`` is False, every factory
    method returns one shared no-op metric, so disabled metering costs
    one truthiness check and allocates nothing per call site.
  * **Fixed log-spaced buckets.**  Histograms bucket into a fixed
    geometric ladder (:func:`log_buckets`), so exposition is O(buckets)
    regardless of observation count; exact quantiles come from a bounded
    recent window (the one quantile implementation in the codebase --
    ``runtime.RequestLatency`` delegates here).
"""
from __future__ import annotations

import bisect
import math
import re
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple


class MetricsError(ValueError):
    """A metrics identity or invariant was violated (bad metric name,
    type conflict on re-registration, snapshot self-check failure)."""


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> Tuple[float, ...]:
    """A fixed geometric bucket ladder: ``per_decade`` upper bounds per
    decade from ``lo`` up to (at least) ``hi``, inclusive."""
    if lo <= 0 or hi <= lo:
        raise MetricsError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise MetricsError(f"per_decade must be >= 1, got {per_decade}")
    out: List[float] = []
    k = 0
    while True:
        b = lo * 10.0 ** (k / per_decade)
        # round to 3 significant figures: exposition-friendly bounds
        # (consecutive rungs differ >2x, so rounding cannot collide)
        b = float(f"{b:.2e}")
        out.append(b)
        if b >= hi:
            return tuple(out)
        k += 1


def linear_buckets(lo: float, hi: float, n: int) -> Tuple[float, ...]:
    """``n`` evenly spaced upper bounds covering ``(lo, hi]`` -- for
    bounded ratios where a log ladder wastes resolution."""
    if n < 1:
        raise MetricsError(f"n must be >= 1, got {n}")
    step = (hi - lo) / n
    return tuple(lo + step * (i + 1) for i in range(n))


#: default histogram ladder: 1 us .. 100 s, 3 buckets per decade --
#: wide enough for a dispatch tick and a cold compile alike
DEFAULT_TIME_BUCKETS = log_buckets(1e-6, 100.0, 3)


def _check_name(name: str) -> None:
    if not _NAME_RE.match(name or ""):
        raise MetricsError(f"invalid metric name {name!r}")


def _label_items(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    for k in labels:
        if not _LABEL_RE.match(k) or k.startswith("__"):
            raise MetricsError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count.  ``inc`` with a negative amount
    is a :class:`MetricsError` -- use a :class:`Gauge` for levels."""

    __slots__ = ("name", "help", "labels", "value")
    kind = "counter"

    def __init__(self, name: str = "", help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise MetricsError(
                f"counter {self.name!r} cannot decrease (inc {n})"
            )
        self.value += n

    def data(self) -> Dict[str, Any]:
        return {"value": self.value}


class Gauge:
    """A level that goes up and down (queue depth, in-flight count)."""

    __slots__ = ("name", "help", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str = "", help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def data(self) -> Dict[str, Any]:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket distribution with exact recent-window quantiles.

    ``buckets`` is an ascending tuple of upper bounds; one implicit
    ``+Inf`` overflow bucket closes the ladder.  ``observe`` is a bisect
    plus four attribute updates.  ``quantile`` is nearest-rank over the
    most recent ``window`` raw observations -- exact where it matters
    (a serving engine reports p95 over recent traffic, not its whole
    lifetime) and the codebase's single quantile implementation.
    """

    __slots__ = ("name", "help", "labels", "buckets", "bucket_counts",
                 "count", "sum", "min", "max", "_recent")
    kind = "histogram"

    def __init__(self, name: str = "", help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = (),
                 buckets: Optional[Iterable[float]] = None,
                 window: int = 1024) -> None:
        bounds = tuple(buckets) if buckets is not None else DEFAULT_TIME_BUCKETS
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise MetricsError(
                f"histogram {name!r} buckets must be strictly ascending"
            )
        self.name = name
        self.help = help
        self.labels = labels
        self.buckets = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)  # last bucket: +Inf
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._recent: deque = deque(maxlen=max(1, window))

    def observe(self, x: float) -> None:
        self.bucket_counts[bisect.bisect_left(self.buckets, x)] += 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        self._recent.append(x)

    def quantile(self, q: float) -> float:
        """q-quantile (nearest-rank) over the recent window; 0 if empty."""
        if not self._recent:
            return 0.0
        xs = sorted(self._recent)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
        }

    def data(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "buckets": [
                {"le": le, "count": c}
                for le, c in zip(self.buckets, self.bucket_counts)
            ] + [{"le": "+Inf", "count": self.bucket_counts[-1]}],
        }


class MetricsRegistry:
    """Get-or-create home for metric series, keyed (name, labels).

    Repeat registration with the same name and labels returns the same
    object (the instrumented layers each grab their series at init);
    re-registering a name as a different metric kind is a
    :class:`MetricsError` -- one name, one type, as in Prometheus.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._kinds: Dict[str, str] = {}

    def __bool__(self) -> bool:
        return True

    def _get(self, cls, name: str, help: str, labels: Dict[str, Any],
             **kwargs) -> Any:
        _check_name(name)
        key = (name, _label_items(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                if m.kind != cls.kind:
                    raise MetricsError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}"
                    )
                return m
            prior = self._kinds.get(name)
            if prior is not None and prior != cls.kind:
                raise MetricsError(
                    f"metric {name!r} already registered as {prior}, "
                    f"requested {cls.kind}"
                )
            m = cls(name, help, key[1], **kwargs)
            self._metrics[key] = m
            self._kinds[name] = cls.kind
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  window: int = 1024, **labels) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         buckets=buckets, window=window)

    def collect(self) -> List[Any]:
        """Every live series, sorted by (name, labels) for stable output."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, Any]:
        """The registry as one JSON-ready dict (`python -m repro_torch.metrics`
        validates these; ``repro_torch.metrics.check`` runs the invariants)."""
        return {
            "schema": "repro.metrics/v1",
            "metrics": [
                {
                    "name": m.name,
                    "type": m.kind,
                    "help": m.help,
                    "labels": dict(m.labels),
                    **m.data(),
                }
                for m in self.collect()
            ],
        }


class _NullMetric:
    """The one no-op metric behind :class:`NullRegistry`: accepts every
    mutator, reports zeros, allocates nothing per call site."""

    __slots__ = ()
    kind = "null"
    name = ""
    help = ""
    labels: Tuple[Tuple[str, str], ...] = ()
    value = 0.0
    count = 0
    sum = 0.0
    min = 0.0
    max = 0.0
    buckets: Tuple[float, ...] = ()

    def __bool__(self) -> bool:
        return False

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, x: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    def summary(self) -> Dict[str, float]:
        return {}

    def data(self) -> Dict[str, Any]:
        return {}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Falsy no-op registry, the ``trace.NullTracer`` of metrics.

    Every factory method returns the same shared :class:`_NullMetric`,
    so an unmetered hot path costs one truthiness check and zero
    allocations -- pass :data:`NULL_REGISTRY` (or nothing) wherever a
    ``metrics=`` parameter is accepted.
    """

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def counter(self, name: str, help: str = "", **labels) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, help: str = "", **labels) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  window: int = 1024, **labels) -> _NullMetric:
        return _NULL_METRIC

    def collect(self) -> List[Any]:
        return []

    def snapshot(self) -> Dict[str, Any]:
        return {"schema": "repro.metrics/v1", "metrics": []}


NULL_REGISTRY = NullRegistry()
