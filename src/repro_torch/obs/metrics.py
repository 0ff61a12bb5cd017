"""Process-local metrics: counters, gauges, log-scale histograms
(counterpart of ``repro.obs.metrics``, the same semantics).

Stdlib-only on purpose: the metrics layer must be importable (and cheap)
everywhere the serving stack runs, including tooling contexts with no
torch. All writes are host-side; a value read from the card is copied
to the host before it is observed.

Histograms use fixed log-scale buckets (so the memory footprint is
bounded and two snapshots merge bucket-wise) but additionally retain the
raw samples, so ``p50``/``p90``/``p99`` in a snapshot are EXACT
(nearest-rank on the sorted samples), not bucket-interpolated. Benchmark
and serving workloads here are thousands of observations, not millions;
exactness is worth the list. An empty histogram snapshots its mean and
percentiles as NaN.

Recording is globally gated by :func:`set_enabled`: the bit-parity
tests flip it to pin that telemetry never changes results.
"""
from __future__ import annotations

import bisect
import math
import threading

_LOCK = threading.RLock()
_ENABLED = [True]


def set_enabled(flag: bool) -> None:
    """Globally enable/disable metric writes (reads always work)."""
    _ENABLED[0] = bool(flag)


def enabled() -> bool:
    return _ENABLED[0]


def _log_bucket_edges(lo: float, hi: float, per_decade: int) -> list:
    """Geometric bucket upper edges covering [lo, hi]; observations
    outside land in the first/last (unbounded) bucket."""
    if not (lo > 0.0 and hi > lo and per_decade > 0):
        raise ValueError("need 0 < lo < hi and per_decade >= 1")
    decades = math.log10(hi / lo)
    k = int(math.ceil(decades * per_decade))
    return [lo * 10.0 ** (i / per_decade) for i in range(k + 1)]


class Counter:
    """Monotone event count."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not _ENABLED[0]:
            return
        with _LOCK:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> int:
        return self._value

    def reset(self) -> None:
        with _LOCK:
            self._value = 0


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value: float) -> None:
        if not _ENABLED[0]:
            return
        with _LOCK:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> float:
        return self._value

    def reset(self) -> None:
        with _LOCK:
            self._value = 0.0


class Histogram:
    """Log-scale fixed-bucket histogram with exact percentile readout.

    Default edges span 1e-9 .. 1e6 at 5 buckets/decade — wide enough for
    seconds-scale latencies at one end and iteration counts at the
    other. Non-positive observations land in the underflow bucket.
    """

    __slots__ = ("name", "_edges", "_counts", "_samples", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, *, lo: float = 1e-9, hi: float = 1e6,
                 per_decade: int = 5):
        self.name = name
        self._edges = _log_bucket_edges(lo, hi, per_decade)
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._counts = [0] * (len(self._edges) + 1)  # +underflow/overflow
        self._samples: list = []
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        if not _ENABLED[0]:
            return
        v = float(value)
        with _LOCK:
            # bucket i holds values <= edges[i]; the last holds overflow
            self._counts[bisect.bisect_left(self._edges, v)] += 1
            self._samples.append(v)
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return len(self._samples)

    def percentile(self, q: float) -> float:
        """Exact nearest-rank percentile (numpy's ``inverted_cdf``):
        the smallest sample with at least ``ceil(q/100 * n)`` samples at
        or below it. NaN on an empty histogram."""
        with _LOCK:
            n = len(self._samples)
            if n == 0:
                return math.nan
            if not 0.0 < q <= 100.0:
                raise ValueError(f"percentile q must be in (0, 100], got {q}")
            rank = max(1, math.ceil(q / 100.0 * n))
            return sorted(self._samples)[rank - 1]

    def snapshot(self) -> dict:
        with _LOCK:
            n = len(self._samples)
            out = {
                "count": n,
                "sum": self._sum,
                "min": self._min if n else math.nan,
                "max": self._max if n else math.nan,
                "mean": (self._sum / n) if n else math.nan,
            }
            if n:
                s = sorted(self._samples)
                for q in (50, 90, 99):
                    out[f"p{q}"] = s[max(1, math.ceil(q / 100.0 * n)) - 1]
            else:
                out["p50"] = out["p90"] = out["p99"] = math.nan
            # only the occupied buckets — snapshots stay readable
            out["buckets"] = [
                [self._edges[i] if i < len(self._edges) else math.inf, c]
                for i, c in enumerate(self._counts) if c
            ]
            return out

    def reset(self) -> None:
        with _LOCK:
            self._reset_locked()


class MetricsRegistry:
    """Named get-or-create store for counters/gauges/histograms.

    One module-level default registry backs the free functions below;
    subsystems that need isolated lifecycles (each ``BIFEngine``) hold
    their own instance.
    """

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, cls, **kwargs):
        with _LOCK:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self._get(name, Histogram, **kwargs)

    def snapshot(self) -> dict:
        """Plain-dict snapshot: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {count, sum, min, max, mean, p50, p90,
        p99, buckets}}}``."""
        with _LOCK:
            out = {"counters": {}, "gauges": {}, "histograms": {}}
            for name in sorted(self._metrics):
                m = self._metrics[name]
                kind = {Counter: "counters", Gauge: "gauges",
                        Histogram: "histograms"}[type(m)]
                out[kind][name] = m.snapshot()
            return out

    def reset(self) -> None:
        with _LOCK:
            for m in self._metrics.values():
                m.reset()


REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, **kwargs) -> Histogram:
    return REGISTRY.histogram(name, **kwargs)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
