"""Congestion-aware stripe scheduling for the multi-stream data plane (the
port's own copy of the JAX package's ``control/stripes.py``).

The transport stripes payload frames across an endpoint's payload streams by chunk
id — a fixed assignment, so one persistently slow stream (a congested
path, a flaky NIC queue, a chaos ``delay``) gates every round that owns a
chunk on it. This module closes that loop the way the adapt ladder closed
the threshold loop: the per-stream byte gauges the sender threads already
maintain feed a :class:`StripeScheduler` whose DEFICIT-WEIGHTED assignment
(stride scheduling: pick the stream with the least weighted virtual time)
shifts work away from a stream that demonstrably is not draining, with
hysteresis on both edges so a noisy window cannot flap the weights.

Decision rule, evaluated once per ``window_s`` of the caller's clock
(every entry point takes ``now`` — the scheduler owns no clock, so tests
and the bench replay it deterministically under a fake one, exactly the
``GossipState`` discipline):

- a stream's window **drain ratio** is ``sent / (backlog_at_window_start +
  assigned_this_window)`` — self-normalizing, so a stream that was
  assigned little is judged on what it WAS given, not against busier
  peers;
- a ratio below ``SLOW_RATIO`` with at least ``MIN_EVIDENCE_BYTES`` of
  work outstanding counts one *slow* window; ``HYSTERESIS`` consecutive
  slow windows halve the stream's weight (``stripe.sheds``), floored at
  ``MIN_WEIGHT`` so evidence keeps flowing to a shed stream;
- a ratio at/above ``RESTORE_RATIO`` counts one *fast* window;
  ``HYSTERESIS`` consecutive fast windows double a shed stream's weight
  back toward parity (``stripe.restores``) — distinct bars, like the
  adapt ladder's degrade/restore thresholds.

The scheduler is shared between the event loop (``pick`` at enqueue) and
the per-stream sender threads (``note_sent`` after each batch), so every
entry point locks; the hot path is a handful of float ops per payload
frame.
"""

from __future__ import annotations

import threading

from akka_allreduce_tpu_torch.obs import metrics as _metrics

__all__ = ["StripeScheduler"]

# weight-shift accounting (OBSERVABILITY.md): how often congestion evidence
# actually moved assignment weight, process-wide
_SHEDS = _metrics.counter("stripe.sheds")
_RESTORES = _metrics.counter("stripe.restores")


class StripeScheduler:
    """Deficit-weighted stripe assignment over ``n`` payload streams."""

    #: evaluation window of the caller's clock
    WINDOW_S = 0.25
    #: drain ratio below this (with evidence) = one slow window
    SLOW_RATIO = 0.5
    #: drain ratio at/above this = one fast window (the restore bar —
    #: deliberately far from SLOW_RATIO: the hysteresis gap)
    RESTORE_RATIO = 0.9
    #: consecutive slow/fast windows before a weight shift
    HYSTERESIS = 2
    #: weight multiplier per shed (and divisor per restore)
    SHED_FACTOR = 0.5
    #: floor: a shed stream keeps receiving SOME work, so recovery
    #: evidence can accumulate (a zero-weight stream could never heal)
    MIN_WEIGHT = 0.125
    #: ignore windows where a stream had less than this much work pending
    #: (an idle stream is not a slow stream)
    MIN_EVIDENCE_BYTES = 64 << 10

    def __init__(self, n: int, *, window_s: float | None = None) -> None:
        if n < 1:
            raise ValueError(f"need at least one stripe, got {n}")
        self.n = n
        self.window_s = float(window_s) if window_s else self.WINDOW_S
        self.weights = [1.0] * n
        self.sheds = 0
        self.restores = 0
        self._lock = threading.Lock()
        self._vtime = [0.0] * n  # weighted bytes assigned this window
        self._assigned = [0] * n  # bytes assigned this window
        self._sent = [0] * n  # bytes the sender threads moved this window
        self._outstanding = [0] * n  # assigned-but-unsent, across windows
        self._backlog0 = [0] * n  # outstanding at window start
        self._slow = [0] * n  # consecutive slow windows
        self._fast = [0] * n  # consecutive fast windows
        self._window_start: float | None = None

    # -- assignment ----------------------------------------------------------

    def pick(self, nbytes: int, now: float) -> int:
        """The stripe (0-based) to carry ``nbytes`` — least weighted
        virtual time wins (ties to the lowest index: deterministic)."""
        with self._lock:
            self._roll(now)
            best = min(range(self.n), key=lambda i: (self._vtime[i], i))
            self._vtime[best] += nbytes / self.weights[best]
            self._assigned[best] += nbytes
            self._outstanding[best] += nbytes
            return best

    def note_sent(self, idx: int, nbytes: int, now: float) -> None:
        """Sender-thread feedback: ``nbytes`` of stripe ``idx``'s queue
        reached the socket."""
        with self._lock:
            self._sent[idx] += nbytes
            self._outstanding[idx] = max(0, self._outstanding[idx] - nbytes)
            self._roll(now)

    def note_dropped(self, idx: int, nbytes: int, now: float) -> None:
        """``nbytes`` assigned to stripe ``idx`` were DROPPED unsent
        (dead-letter, backpressure withdrawal). The phantom backlog must
        leave the books: it will never produce a ``note_sent``, and
        uncleared it would read as permanent congestion — a stream that
        dead-lettered one burst could otherwise never restore its
        weight."""
        with self._lock:
            self._outstanding[idx] = max(0, self._outstanding[idx] - nbytes)
            self._roll(now)

    def share(self, idx: int) -> float:
        """Stripe ``idx``'s current fraction of the assignment weight."""
        with self._lock:
            return self.weights[idx] / sum(self.weights)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "weights": list(self.weights),
                "sheds": self.sheds,
                "restores": self.restores,
                "outstanding": list(self._outstanding),
            }

    # -- the window decision -------------------------------------------------

    def _roll(self, now: float) -> None:
        if self._window_start is None:
            self._window_start = now
            return
        if now - self._window_start < self.window_s:
            return
        for i in range(self.n):
            pending = self._backlog0[i] + self._assigned[i]
            if pending < self.MIN_EVIDENCE_BYTES:
                continue  # thin evidence: neither advances nor resets
            ratio = self._sent[i] / pending
            if ratio < self.SLOW_RATIO:
                self._fast[i] = 0
                self._slow[i] += 1
                if self._slow[i] >= self.HYSTERESIS:
                    self._slow[i] = 0
                    shed = max(
                        self.MIN_WEIGHT, self.weights[i] * self.SHED_FACTOR
                    )
                    if shed < self.weights[i]:
                        self.weights[i] = shed
                        self.sheds += 1
                        _SHEDS.inc()
            elif ratio >= self.RESTORE_RATIO:
                self._slow[i] = 0
                if self.weights[i] < 1.0:
                    self._fast[i] += 1
                    if self._fast[i] >= self.HYSTERESIS:
                        self._fast[i] = 0
                        self.weights[i] = min(
                            1.0, self.weights[i] / self.SHED_FACTOR
                        )
                        self.restores += 1
                        _RESTORES.inc()
            else:
                self._slow[i] = 0
                self._fast[i] = 0
        self._window_start = now
        self._assigned = [0] * self.n
        self._sent = [0] * self.n
        self._vtime = [0.0] * self.n
        self._backlog0 = list(self._outstanding)
