"""Spans with round-scoped trace IDs + a Chrome/Perfetto exporter.

Model (OBSERVABILITY.md "Span model"):

- A **trace** is one allreduce round (or any other unit of work): the line
  master mints a fresh 63-bit trace id when it starts a round and stamps it
  onto the ``StartAllreduce`` envelopes; every hop after that — worker
  scatter, peer reduce, completion report — inherits the id through the
  wire trailer (``control/wire.py``), so one round stitches across every
  process it touched.
- A **span** is one timed operation inside a trace: name, wall-clock start,
  duration, attributes, and parent span id. The *current* trace context is
  a ``contextvars.ContextVar`` set by the transport around each handler
  invocation; ``span()`` opens a child of it.
- Finished spans land in a bounded in-process buffer (and the flight
  recorder's ring); ``write_chrome_trace`` renders them as Chrome
  ``trace_event`` JSON that Perfetto / ``chrome://tracing`` open directly,
  and ``merge_chrome_traces`` folds multiple processes' files into one
  timeline (events carry real pids, timestamps are epoch-based).

Sampling: ``AKKA_OBS_TRACE=0`` disables span *recording* entirely (context
still propagates, so re-enabling downstream works); the default records
every span — span volume here is per control message, not per byte, so the
steady-state cost is two clock reads and one small dict per span.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Iterable, NamedTuple

from akka_allreduce_tpu_torch.obs import flight as _flight

__all__ = [
    "TraceContext",
    "Span",
    "current",
    "use",
    "new_context",
    "span",
    "start_span",
    "enabled",
    "set_enabled",
    "drain",
    "snapshot",
    "chrome_events",
    "write_chrome_trace",
    "merge_chrome_traces",
]


class TraceContext(NamedTuple):
    """What propagates across the wire: 8+8 bytes of ids + a sampled bit."""

    trace_id: int
    span_id: int
    sampled: bool = True


_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "akka_obs_trace", default=None
)

# finished-span buffer: bounded so an unexported long run cannot grow without
# limit (drain() or write_chrome_trace() empties it)
_BUFFER_MAX = 65536
_finished: deque = deque(maxlen=_BUFFER_MAX)

_enabled = os.environ.get("AKKA_OBS_TRACE", "1") not in ("0", "false", "off")

# random.Random instance: never perturbs the global RNG the payload
# generators seed deterministically
_ids = random.Random()


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def _new_id() -> int:
    return _ids.getrandbits(63) or 1


def new_context(*, sampled: bool | None = None) -> TraceContext:
    """Mint a fresh trace root (e.g. one per allreduce round)."""
    return TraceContext(
        _new_id(), _new_id(), _enabled if sampled is None else sampled
    )


def current() -> TraceContext | None:
    return _current.get()


@contextlib.contextmanager
def use(ctx: TraceContext | None):
    """Make ``ctx`` the current trace context for the with-body (the
    transport wraps every handler invocation in this)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


class Span:
    """One timed operation. Create via ``span()`` (context manager) or
    ``start_span()`` (manual ``end()`` — for spans that outlive a single
    callback, e.g. the line master's per-round span)."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "sampled", "attrs",
        "_t_wall", "_t0", "ended",
    )

    def __init__(
        self,
        name: str,
        ctx: TraceContext | None,
        attrs: dict[str, Any] | None,
        *,
        root: bool = False,
    ) -> None:
        self.name = name
        if root:
            ctx = None
        if ctx is not None:
            self.trace_id = ctx.trace_id
            self.parent_id = ctx.span_id
            self.sampled = ctx.sampled and _enabled
        else:
            self.trace_id = _new_id()
            self.parent_id = 0
            self.sampled = _enabled
        self.span_id = _new_id()
        self.attrs = attrs
        self._t_wall = time.time()
        self._t0 = time.perf_counter()
        self.ended = False

    @property
    def context(self) -> TraceContext:
        """The context a child (or an outgoing envelope) should inherit."""
        return TraceContext(self.trace_id, self.span_id, self.sampled)

    def set(self, **attrs: Any) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def end(self) -> None:
        if self.ended:
            return
        self.ended = True
        if not self.sampled:
            return
        rec = {
            "name": self.name,
            "ts": self._t_wall,
            "dur": time.perf_counter() - self._t0,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        _finished.append(rec)
        # the flight recorder keeps its own ring of recent spans
        _flight.record_span(rec)


def start_span(
    name: str,
    *,
    ctx: TraceContext | None = None,
    root: bool = False,
    **attrs: Any,
) -> Span:
    """Open a span (parent = ``ctx`` or the current context); caller ends
    it. ``root=True`` forces a FRESH trace id regardless of any ambient
    context — how a new allreduce round starts its own trace even when the
    scheduler runs inside the previous round's completion handler."""
    return Span(
        name,
        ctx if ctx is not None else _current.get(),
        attrs or None,
        root=root,
    )


@contextlib.contextmanager
def span(
    name: str,
    *,
    ctx: TraceContext | None = None,
    root: bool = False,
    **attrs: Any,
):
    """Span around the with-body; the body runs with the span as the
    current context, so nested spans (and envelopes sent from inside) are
    its children."""
    s = start_span(name, ctx=ctx, root=root, **attrs)
    token = _current.set(s.context)
    try:
        yield s
    finally:
        _current.reset(token)
        s.end()


def snapshot() -> list[dict]:
    """Finished spans recorded so far (oldest first), without clearing."""
    return list(_finished)


def drain() -> list[dict]:
    out = list(_finished)
    _finished.clear()
    return out


# -- Chrome trace_event export -------------------------------------------------


def _layer(name: str) -> str:
    """Span-name prefix = its layer (grid_master / line_master / worker /
    transport / ...), used as the Chrome event category."""
    return name.split(".", 1)[0]


def chrome_events(
    records: Iterable[dict], *, pid: int | None = None
) -> list[dict]:
    """Span records -> Chrome ``trace_event`` complete ('X') events.

    Timestamps are wall-clock epoch microseconds, so events from different
    processes land on one timeline when merged. Trace/span ids ride in
    ``args`` (hex strings — Perfetto keeps them queryable).
    """
    pid = os.getpid() if pid is None else pid
    tid = threading.get_ident() & 0x7FFFFFFF
    out = []
    for r in records:
        args = {
            "trace_id": format(r["trace_id"], "016x"),
            "span_id": format(r["span_id"], "016x"),
            "parent_id": format(r.get("parent_id", 0), "016x"),
        }
        args.update(r.get("attrs") or {})
        out.append(
            {
                "name": r["name"],
                "cat": _layer(r["name"]),
                "ph": "X",
                "ts": r["ts"] * 1e6,
                "dur": max(r["dur"], 1e-6) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    return out


def write_chrome_trace(
    path: str, records: Iterable[dict] | None = None, *, drain_buffer: bool = True
) -> str:
    """Write (and by default drain) the span buffer as a Chrome/Perfetto
    trace JSON file; returns ``path``."""
    if records is None:
        records = drain() if drain_buffer else snapshot()
    doc = {
        "traceEvents": chrome_events(records),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "akka_allreduce_tpu_torch.obs", "pid": os.getpid()},
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def merge_chrome_traces(paths: Iterable[str], out_path: str) -> str:
    """Fold several processes' trace files into one timeline (events carry
    their producing pid, so Perfetto shows one track group per process)."""
    events: list[dict] = []
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        events.extend(doc.get("traceEvents", []))
    events.sort(key=lambda e: e.get("ts", 0))
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return out_path
