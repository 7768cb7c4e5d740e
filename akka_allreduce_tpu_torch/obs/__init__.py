"""Observability: the port's own copy of the JAX package's ``obs/``.

Stdlib only, as there: ``metrics`` (a process-wide registry of counters,
gauges, fixed-bucket histograms and series), ``trace`` (spans with
round-scoped trace ids and a Chrome/Perfetto exporter), ``flight`` (an
always-on ring of recent spans and events, dumped to JSONL on demand) and
``watchdog`` (a round that outlives its deadline dumps the flight
recorder). The host engine's worker and masters count and trace through
them under the same names as the JAX engine (OBSERVABILITY.md).
"""

from __future__ import annotations

from akka_allreduce_tpu_torch.obs import flight, metrics, trace, watchdog

__all__ = ["flight", "metrics", "trace", "watchdog"]
