"""Structured per-round metrics: the port's copy of
``akka_allreduce_tpu/utils/metrics.py`` (which imports no JAX; the port keeps
its own copy rather than importing the JAX package).

Every round emits a structured record — round latency, achieved GB/s,
contributor count — to JSONL. ``comm.bandwidth.measure_allreduce`` logs one
record per timed iteration.
"""

from __future__ import annotations

import dataclasses
import io
import json
import time
from typing import Any, TextIO


@dataclasses.dataclass
class RoundMetrics:
    round_num: int
    latency_s: float
    data_bytes: int
    n_devices: int
    contributors: float  # mean contributor count across chunks
    schedule: str = "psum"
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def bus_gbps(self) -> float:
        """Bus bandwidth: 2*(n-1)/n * bytes / t (BASELINE.md measurement rules)."""
        if self.latency_s <= 0 or self.n_devices <= 0:
            return 0.0
        scale = 2.0 * (self.n_devices - 1) / self.n_devices
        return scale * self.data_bytes / self.latency_s / 1e9

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("extra")
        d.update(self.extra)
        d["bus_gbps"] = self.bus_gbps
        return json.dumps(d)


class MetricsLogger:
    """Append-only JSONL sink; file path, open stream, or in-memory."""

    def __init__(self, sink: str | TextIO | None = None) -> None:
        self._own = False
        self._final: str | None = None  # StringIO contents cached at close
        if sink is None:
            self._stream: TextIO = io.StringIO()
        elif isinstance(sink, str):
            self._stream = open(sink, "a", buffering=1)
            self._own = True
        else:
            self._stream = sink
        self.records: list[RoundMetrics] = []

    def log_round(self, m: RoundMetrics) -> None:
        self.records.append(m)
        self._stream.write(m.to_json() + "\n")

    def log_event(self, **fields: Any) -> None:
        fields.setdefault("t", time.time())
        self._stream.write(json.dumps(fields) + "\n")

    def log_snapshot(self, registry, **extra: Any) -> None:
        """One ``metrics_snapshot`` record carrying a whole
        ``obs.metrics.Registry`` — how existing JSONL consumers
        (bench_suite, soak, the training CLIs) get the registry stream
        without learning a new sink."""
        self.log_event(
            kind="metrics_snapshot", metrics=registry.snapshot(), **extra
        )

    def close(self) -> None:
        """Flush buffered writes on EVERY sink — a caller-owned stream is
        flushed (not closed: its lifetime is the caller's), an owned file
        is flushed and closed, and an in-memory sink's contents stay
        readable via ``dump()`` even if someone closes the StringIO."""
        if isinstance(self._stream, io.StringIO):
            try:
                self._final = self._stream.getvalue()
            except ValueError:  # owner closed it first: keep what we have
                pass
            return
        try:
            self._stream.flush()
        except ValueError:  # already closed by its owner: nothing buffered
            pass
        if self._own:
            self._stream.close()

    def dump(self) -> str:
        if self._final is not None:
            return self._final
        if isinstance(self._stream, io.StringIO):
            try:
                return self._stream.getvalue()
            except ValueError:
                return ""
        return ""
