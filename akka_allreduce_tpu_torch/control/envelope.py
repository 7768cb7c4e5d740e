"""Addressed messages between control-plane handlers (the port's own copy
of the JAX package's ``control/envelope.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

MASTER = "master"


def peer_addr(worker_id: int) -> str:
    return f"worker:{worker_id}"


def master_addr(line_id: int = 0) -> str:
    return f"line_master:{line_id}"


@dataclasses.dataclass(frozen=True, eq=False)
class Envelope:
    """One outgoing message: deliver ``msg`` to ``dest`` (an address string).

    ``via``, when set, pins the delivery endpoint explicitly instead of
    resolving ``dest`` through the route table (a TCP transport's reply to
    a joiner); local routers ignore it.

    ``trace``, when set, pins the trace context this message propagates
    (``obs.trace.TraceContext``); when ``None`` a transport stamps the
    current context at send time.

    ``wire``, when set, pins this frame's wire precision ("f32"/"f16"/
    "int8") instead of the transport's default: how a ``RoundPolicy``
    applies per-round compression to payload frames.
    """

    dest: str
    msg: Any
    via: Any = None  # a transport's endpoint | None
    trace: Any = None  # obs.trace.TraceContext | None
    wire: str | None = None  # per-frame wire precision override
