"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Design constraints (the hot paths this feeds are the transport's per-message
loop and the worker's per-chunk handlers):

- **lock-cheap**: no locks at all. Every mutation is a single attribute
  store or in-place add on a Python int/float — atomic under the GIL, and
  the control plane is single-threaded asyncio besides. Cross-thread
  readers (the flight-recorder signal handler) can only ever see a
  consistent previous value, never a torn one.
- **allocation-free on the hot path**: ``Counter.inc``/``Gauge.set`` touch
  one slot; ``Histogram.observe`` walks a small tuple of precomputed
  bounds. Metric objects are created once (module import / first use) and
  cached by name — ``counter("x")`` in a loop is a dict hit, but callers
  on hot paths should hold the object.
- **snapshot-to-dict**: ``Registry.snapshot()`` returns one flat
  JSON-ready dict, so any JSONL sink (``MetricsLogger.log_snapshot``, the
  flight recorder, bench_suite records) gets the whole registry for free.

Naming convention (OBSERVABILITY.md): dotted ``<layer>.<noun>[.<detail>]``
— e.g. ``transport.dropped.no_route``, ``worker.rounds_completed``,
``master.round_latency_s``. Seconds-valued metrics end in ``_s``.
"""

from __future__ import annotations

import time
from typing import Any, Callable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Series",
    "Registry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "series",
]


class Counter:
    """Monotonic accumulator (int or float increments)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    add = inc  # alias for float-valued accumulation (e.g. seconds)


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: int | float = 0

    def set(self, v: int | float) -> None:
        self.value = v

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    def dec(self, n: int | float = 1) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram: bounds are set at creation, observe() walks
    them (no allocation, no resizing — predictable hot-path cost)."""

    __slots__ = ("name", "bounds", "counts", "total", "count")

    #: default bounds suit latencies in seconds (100us .. 100s, log-ish)
    DEFAULT_BOUNDS = (
        1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
        100.0,
    )

    def __init__(self, name: str, bounds: tuple[float, ...] | None = None) -> None:
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else self.DEFAULT_BOUNDS
        if any(b >= a for b, a in zip(self.bounds, self.bounds[1:])):
            raise ValueError(f"histogram bounds must increase: {self.bounds}")
        self.counts = [0] * (len(self.bounds) + 1)  # last = overflow
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = 0
        bounds = self.bounds
        n = len(bounds)
        while i < n and v > bounds[i]:
            i += 1
        self.counts[i] += 1
        self.total += v
        self.count += 1

    def as_dict(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else 0.0,
            "buckets": {
                (f"le_{b:g}" if i < len(self.bounds) else "inf"): c
                for i, (b, c) in enumerate(
                    zip((*self.bounds, float("inf")), self.counts)
                )
            },
        }


class Series:
    """Bounded list of structured events (e.g. re-mesh records): the
    registry's answer to ad-hoc ``events.append({...})`` bookkeeping —
    whoever reads the registry sees exactly what the producer recorded."""

    __slots__ = ("name", "maxlen", "values", "dropped")

    def __init__(self, name: str, maxlen: int = 1024) -> None:
        self.name = name
        self.maxlen = maxlen
        self.values: list[Any] = []
        self.dropped = 0

    def append(self, value: Any) -> None:
        if len(self.values) >= self.maxlen:
            self.dropped += 1  # bounded: never silently unbounded memory
            return
        self.values.append(value)


class Registry:
    """Name -> metric, get-or-create, plus pull-time collectors.

    A *collector* is a zero-arg callable returning a dict merged into every
    ``snapshot()`` — how per-instance state (e.g. each transport's
    ``stage_seconds``) joins the registry without paying a registry write
    on its hot path.
    """

    def __init__(self) -> None:
        self._metrics: dict[str, Any] = {}
        self._collectors: list[Callable[[], dict[str, Any]]] = []

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args)
        elif type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(
        self, name: str, bounds: tuple[float, ...] | None = None
    ) -> Histogram:
        return self._get(name, Histogram, bounds)

    def series(self, name: str, maxlen: int = 1024) -> Series:
        return self._get(name, Series, maxlen)

    def register_collector(self, fn: Callable[[], dict[str, Any]]) -> None:
        self._collectors.append(fn)

    def snapshot(self) -> dict[str, Any]:
        """One flat JSON-ready dict of everything the registry knows."""
        out: dict[str, Any] = {"t": time.time()}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = m.as_dict()
            elif isinstance(m, Series):
                out[name] = list(m.values)
            else:
                out[name] = m.value
        for fn in self._collectors:
            try:
                out.update(fn())
            except Exception:  # a broken collector must not kill a dump
                out.setdefault("collector_errors", 0)
                out["collector_errors"] += 1
        return out


#: the process-wide default registry — the one the transport, workers,
#: masters, trainers, and the flight recorder all share
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, bounds: tuple[float, ...] | None = None) -> Histogram:
    return REGISTRY.histogram(name, bounds)


def series(name: str, maxlen: int = 1024) -> Series:
    return REGISTRY.series(name, maxlen)
