"""Flight recorder: always-on ring of recent events, dumped on demand.

The ring costs one bounded ``deque.append`` per event — cheap enough to
leave on in production — and turns "the soak hung at round 412" into a
post-mortem artifact. A dump is triggered by:

- an **unhandled crash** (``sys.excepthook`` wrapper, via ``install()``),
- **SIGUSR1** (``install()``; with ``signal_exit=True`` the handler dumps
  and then dies by the signal — kill-with-post-mortem),
- the **round watchdog** (``obs.watchdog``) when a round blows its
  deadline,
- an explicit ``dump()`` call.

Dump format (JSONL, one object per line — OBSERVABILITY.md):

    {"kind": "flight_header", "reason": ..., "pid": ..., "argv": ..., ...}
    {"kind": "state", ...}          # last-known values (set_state)
    {"kind": "metrics", ...}        # obs.metrics.REGISTRY.snapshot()
    {"kind": "event"|"span", ...}   # the ring, oldest first

``state`` carries the pointers a post-mortem needs first: the in-flight
round (``worker.round_in_flight``) and the last transport stage
(``transport.last_stage``) are maintained by the worker and transport.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from collections import deque
from typing import Any

from akka_allreduce_tpu_torch.obs import metrics

__all__ = [
    "note",
    "record_span",
    "set_state",
    "get_state",
    "dump",
    "install",
    "uninstall",
    "events",
    "clear",
]

_RING_MAX = 4096
_ring: deque = deque(maxlen=_RING_MAX)

#: last-known values — one dict store per update, safe from signal handlers
_state: dict[str, Any] = {}

_dump_dir: str | None = None
_installed = False
_signal_exit = False
_prev_excepthook = None
_prev_sigusr1 = None


def note(kind: str, **attrs: Any) -> None:
    """Record a point event into the ring."""
    _ring.append({"kind": "event", "t": time.time(), "event": kind, **attrs})


def record_span(rec: dict) -> None:
    """Called by obs.trace when a span ends."""
    _ring.append({"kind": "span", **rec})


def set_state(key: str, value: Any) -> None:
    # Deliberately lock-free: one dict store per update, last-writer-wins.
    # dump() must stay callable from signal handlers and excepthooks, and a
    # lock here could deadlock a handler that fires mid-update.
    _state[key] = value  # arlint: disable=THRD001 -- single-opcode store


def get_state(key: str, default: Any = None) -> Any:
    return _state.get(key, default)


def events() -> list[dict]:
    return list(_ring)


def clear() -> None:
    _ring.clear()
    _state.clear()


def _default_dir() -> str:
    return _dump_dir or os.environ.get("AKKA_OBS_DIR") or os.getcwd()


def dump(path: str | None = None, *, reason: str = "manual") -> str:
    """Write the flight record as JSONL; returns the file path.

    Safe to call from a signal handler or excepthook: everything read here
    is either immutable or mutated only by single opcode stores.
    """
    if path is None:
        path = os.path.join(
            _default_dir(),
            f"flightrec-{os.getpid()}-{reason}-{int(time.time() * 1e3)}.jsonl",
        )
    header = {
        "kind": "flight_header",
        "reason": reason,
        "pid": os.getpid(),
        "argv": sys.argv,
        "t": time.time(),
        "n_events": len(_ring),
    }
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        f.write(json.dumps({"kind": "state", **_state}) + "\n")
        f.write(
            json.dumps(
                {"kind": "metrics", **metrics.REGISTRY.snapshot()},
                default=str,
            )
            + "\n"
        )
        for rec in list(_ring):
            f.write(json.dumps(rec, default=str) + "\n")
    return path


def _on_crash(exc_type, exc, tb) -> None:
    try:
        note("unhandled_exception", type=exc_type.__name__, message=str(exc))
        path = dump(reason="crash")
        print(f"flight recorder: crash dump written to {path}", file=sys.stderr)
    except Exception:  # the dump must never mask the original crash
        pass
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _on_sigusr1(signum, frame) -> None:
    path = dump(reason="sigusr1")
    print(f"flight recorder: SIGUSR1 dump written to {path}", file=sys.stderr)
    if _signal_exit:
        # die BY the signal (proper waitstatus for the parent): restore the
        # default disposition and re-raise at ourselves
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGUSR1)


def install(dump_dir: str | None = None, *, signal_exit: bool = False) -> None:
    """Arm the crash and SIGUSR1 dump triggers for this process.

    ``signal_exit=True`` makes SIGUSR1 fatal after the dump (the
    kill-with-post-mortem mode the cluster CLI roles use); the default
    dumps and keeps running. Idempotent; ``uninstall()`` undoes it.
    """
    global _dump_dir, _installed, _signal_exit, _prev_excepthook, _prev_sigusr1
    if dump_dir is not None:
        _dump_dir = dump_dir
        os.makedirs(dump_dir, exist_ok=True)
    _signal_exit = signal_exit
    if _installed:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _on_crash
    try:
        _prev_sigusr1 = signal.signal(signal.SIGUSR1, _on_sigusr1)
    except ValueError:
        # not the main thread: crash hook still works, the signal trigger
        # is simply unavailable here
        _prev_sigusr1 = None
    _installed = True


def uninstall() -> None:
    global _installed, _prev_excepthook, _prev_sigusr1, _dump_dir, _signal_exit
    if not _installed:
        return
    if sys.excepthook is _on_crash and _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
    if _prev_sigusr1 is not None:
        try:
            signal.signal(signal.SIGUSR1, _prev_sigusr1)
        except ValueError:
            pass
    _prev_excepthook = None
    _prev_sigusr1 = None
    _dump_dir = None
    _signal_exit = False
    _installed = False
