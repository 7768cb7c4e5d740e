"""Stall watchdog: a round that exceeds its deadline dumps the flight
recorder instead of becoming a shrug.

``RoundWatchdog`` is fed round lifecycle events (``round_started`` /
``round_completed``, keyed by ``(line_id, round)``) by whoever schedules
rounds — the master process wires it to its line masters — and checks ages
either from the caller's own poll loop (``check()``) or from its own
periodic task (``start()``, whose done-callback logs a crash, so a dead
watchdog is an ERROR log, not silence).

On the first deadline crossing of a given round it:

- increments ``watchdog.round_stalls`` in the metrics registry,
- records a ``round_stall`` flight event, and
- dumps the flight recorder (``flightrec-…-stall-….jsonl``) naming the
  stalled round — one dump per stalled round, not one per poll.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable

from akka_allreduce_tpu_torch.obs import flight, metrics

__all__ = ["RoundWatchdog"]

log = logging.getLogger(__name__)


def _observed_task(coro, *, name: str) -> asyncio.Task:
    """``create_task`` with a done-callback that logs a crashed task (the
    JAX package's ``control/remote.py::observed_task``; the port's TCP
    transport is not written yet). The caller keeps the handle."""
    task = asyncio.get_running_loop().create_task(coro, name=name)

    def _done(t: asyncio.Task) -> None:
        if not t.cancelled() and t.exception() is not None:
            log.error("background task %r died: %r", name, t.exception())

    task.add_done_callback(_done)
    return task


class RoundWatchdog:
    """Deadline monitor over in-flight rounds."""

    def __init__(
        self,
        deadline_s: float,
        *,
        clock: Callable[[], float] = time.monotonic,
        poll_interval_s: float | None = None,
        on_stall: Callable[[int, int, float], None] | None = None,
        dump: bool = True,
    ) -> None:
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        self.deadline_s = deadline_s
        self.clock = clock
        self.poll_interval_s = poll_interval_s or max(deadline_s / 4.0, 0.05)
        self.on_stall = on_stall
        self.dump = dump
        self._inflight: dict[tuple[int, int], float] = {}
        self._reported: set[tuple[int, int]] = set()
        self._task = None
        self.stalls = metrics.counter("watchdog.round_stalls")
        self.last_dump_path: str | None = None

    # -- lifecycle events (called by the round scheduler) ----------------------

    def round_started(self, line_id: int, round_num: int) -> None:
        self._inflight[(line_id, round_num)] = self.clock()

    def round_completed(self, line_id: int, round_num: int) -> None:
        """A completed round also retires older in-flight rounds of its
        line (the schedulers abandon them — same discipline)."""
        for key in [
            k for k in self._inflight if k[0] == line_id and k[1] <= round_num
        ]:
            self._inflight.pop(key, None)
            self._reported.discard(key)

    def reset(self) -> None:
        """Retire EVERY in-flight round — called on grid reorganization:
        the replaced line masters' rounds are abandoned by design (their
        line ids may not even exist in the new configuration), so letting
        their deadlines ride would turn every re-mesh into spurious stall
        dumps. Rounds of the new configuration re-register via
        ``round_started``."""
        self._inflight.clear()
        self._reported.clear()

    # -- checking --------------------------------------------------------------

    def check(self, now: float | None = None) -> list[tuple[int, int, float]]:
        """Report rounds newly past deadline as ``(line, round, age_s)``."""
        now = self.clock() if now is None else now
        stalled = []
        for key, started in self._inflight.items():
            age = now - started
            if age > self.deadline_s and key not in self._reported:
                self._reported.add(key)
                stalled.append((key[0], key[1], age))
        for line_id, round_num, age in stalled:
            self.stalls.inc()
            flight.set_state("watchdog.stalled_round", round_num)
            flight.set_state("watchdog.stalled_line", line_id)
            flight.note(
                "round_stall",
                line=line_id,
                round=round_num,
                age_s=round(age, 3),
                deadline_s=self.deadline_s,
            )
            if self.dump:
                self.last_dump_path = flight.dump(
                    reason=f"stall-round{round_num}"
                )
            if self.on_stall is not None:
                self.on_stall(line_id, round_num, age)
        return stalled

    # -- optional self-driven polling ------------------------------------------

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.poll_interval_s)
            self.check()

    def start(self) -> None:
        """Spawn the periodic check task (requires a running event loop)."""
        if self._task is None or self._task.done():
            self._task = _observed_task(self._run(), name="round-watchdog")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
