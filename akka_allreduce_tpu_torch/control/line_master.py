"""Per-line round scheduler — the reference's ``LineMaster`` (SURVEY.md §3),
the port's own copy of the JAX package's ``control/line_master.py``.

Keeps a bounded number of rounds in flight; a round completes when
``ceil(th_allreduce * n_workers)`` workers report ``CompleteAllreduce``; each
completion advances the window (new rounds start immediately — never wait for
stragglers). Rounds older than a completed round are abandoned (their
completions are ignored), matching the worker's discipline.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable

from akka_allreduce_tpu_torch.config import LineMasterConfig, ThresholdConfig
from akka_allreduce_tpu_torch.control.envelope import Envelope, peer_addr
from akka_allreduce_tpu_torch.obs import metrics as obs_metrics
from akka_allreduce_tpu_torch.obs import trace as obs_trace
from akka_allreduce_tpu_torch.protocol import (
    DEFAULT_POLICY,
    CompleteAllreduce,
    ConfirmPreparation,
    PrepareAllreduce,
    RoundPolicy,
    StartAllreduce,
)

log = logging.getLogger(__name__)

# (line_id, round_num, latency_s, completions at threshold, n_workers)
RoundObserver = Callable[[int, int, float, int, int], None]
# (line_id, round_num) at the moment StartAllreduce envelopes are built
RoundStartObserver = Callable[[int, int], None]

_ROUNDS_COMPLETED = obs_metrics.counter("master.rounds_completed")
_ROUND_LATENCY = obs_metrics.histogram("master.round_latency_s")
# per-wire-mode round accounting (OBSERVABILITY.md adapt.*), held as
# objects so the per-completion hot path is an attribute read, not a
# registry name lookup
_MODE_ROUNDS = {
    wire: obs_metrics.counter(f"adapt.mode_rounds.{wire or 'full'}")
    for wire in RoundPolicy.WIRE_MODES
}
_ROUNDS_ABANDONED = obs_metrics.counter("master.rounds_abandoned")
_ROUNDS_DEGRADED = obs_metrics.counter("master.rounds_degraded")
_ROUNDS_RESTARTED = obs_metrics.counter("master.rounds_restarted")


class LineMaster:
    """Drives rounds for one line (worker group) of the grid."""

    def __init__(
        self,
        threshold: ThresholdConfig,
        config: LineMasterConfig = LineMasterConfig(),
        line_id: int = 0,
        *,
        clock: Callable[[], float] = time.monotonic,
        on_round_complete: RoundObserver | None = None,
        on_round_start: RoundStartObserver | None = None,
        epoch: int = -1,
    ) -> None:
        self.threshold = threshold
        self.config = config
        self.line_id = line_id
        # stamped onto every Prepare/Start so nodes can fence a zombie
        # master's round triggers after a failover (-1 = unfenced)
        self.epoch = epoch
        # cross-shard barrier (RESILIENCE.md "Scale"): when set, round r
        # may only START once gate(r) answers True. The ONLY user is the
        # butterfly's dims-2 exchange — the grid master gates each
        # column line on every row line having completed the round, so a
        # column Start never outruns the chain data it consumes; dims-1
        # shards carry no gate and free-run their own sequences.
        self.start_gate: Callable[[int], bool] | None = None
        # the CURRENT RoundPolicy (control/adapt.py): stamped onto each
        # round's StartAllreduce AT START — the per-round record below is
        # what re-Starts re-send, so a re-issued Start can never disagree
        # with buffers already reduced under the round's original policy
        self.policy: RoundPolicy = DEFAULT_POLICY
        self._round_policies: dict[int, RoundPolicy] = {}
        self._prepare_policy: RoundPolicy = DEFAULT_POLICY
        self.clock = clock
        self.on_round_complete = on_round_complete
        self.on_round_start = on_round_start
        self._started_at: dict[int, float] = {}
        self._restarted_at: dict[int, float] = {}  # restart_stalled rate limit
        # round -> open root span: this line master is where a round's
        # trace is BORN — the id stamped onto the StartAllreduce envelopes
        # is the one every downstream hop inherits
        self._round_spans: dict[int, obs_trace.Span] = {}
        self.worker_ids: tuple[int, ...] = ()
        self.config_id: int = -1
        self.next_round = 0  # next round number to start
        self.completed_up_to = -1
        self.started_rounds: set[int] = set()
        self.completions: dict[int, set[int]] = {}  # round -> worker ids
        self.total_completed = 0
        # line-rounds completed by this line's predecessors (earlier configs);
        # max_rounds budgets COMPLETED rounds across the lineage, not round
        # numbers — reorganization churn burns round numbers (they are never
        # reused, stale messages must not collide) but must not burn budget
        self.completed_so_far = 0
        self._confirmed: set[int] = set()
        self._preparing = False
        self._prepared_at = 0.0
        # workers the detector marked unreachable mid-config: the effective
        # completion trigger degrades to what the REACHABLE set can deliver,
        # so in-flight rounds at th=1.0 complete gracefully at detection
        # instead of wedging until the watchdog trips (degraded mode)
        self.unreachable: set[int] = set()
        # highest round each worker EVER asserted complete — updated even
        # for stale/late completions (which _on_complete otherwise drops),
        # because the gap between this watermark and completed_up_to IS the
        # straggler evidence the AdaptiveController consumes: a worker
        # whose completions chronically arrive after the round retired is
        # lagging by that many rounds, in round units, no wall clock
        self.worker_last_complete: dict[int, int] = {}

    # -- configuration / handshake ------------------------------------------

    def abandon_open_spans(self) -> None:
        """End every still-open round span as abandoned — called when this
        line master is superseded by a grid reorganization, so in-flight
        rounds' root spans reach the trace buffer (and the abandoned
        counter) instead of being silently GC'd with the instance."""
        for span in self._round_spans.values():
            _ROUNDS_ABANDONED.inc()
            span.set(abandoned=True, reorganized=True)
            span.end()
        self._round_spans.clear()

    def prepare(
        self,
        worker_ids: tuple[int, ...],
        config_id: int,
        from_round: int,
        completed_so_far: int = 0,
    ) -> list[Envelope]:
        """Begin the PrepareAllreduce handshake with a (new) worker set."""
        self.worker_ids = tuple(worker_ids)
        self.config_id = config_id
        self.next_round = from_round
        self.completed_so_far = completed_so_far
        # every worker starts the config with zero lag: from_round - 1 is
        # the shared watermark (nothing of this config completed yet)
        self.worker_last_complete = {w: from_round - 1 for w in worker_ids}
        self.started_rounds.clear()
        self.completions.clear()
        self.completed_up_to = from_round - 1
        self._confirmed.clear()
        self.unreachable.clear()  # a new config is built from live members
        self._round_policies.clear()
        # the policy in force when this configuration was prepared:
        # re-sent Prepares (reprepare_pending) carry the SAME stamp, so a
        # retried handshake cannot smuggle a newer level in
        self._prepare_policy = self.policy
        self._preparing = True
        self._prepared_at = self.clock()
        return self._prepare_envelopes(self.worker_ids)

    def _prepare_envelopes(self, workers) -> list[Envelope]:
        return [
            Envelope(
                peer_addr(w),
                PrepareAllreduce(
                    self.config_id, self.worker_ids, w, self.next_round,
                    self.line_id, self.epoch, self._prepare_policy,
                ),
            )
            for w in workers
        ]

    def restart_stalled(self, min_age_s: float) -> list[Envelope]:
        """Re-send ``StartAllreduce`` for in-flight rounds that made no
        completion progress for ``min_age_s`` — only to workers missing
        from the round's completion set.

        Delivery is at-most-once: under sustained loss a dropped Start
        starves a worker out of the round and a dropped Complete starves
        the round out of its trigger — with a bounded window both in-flight
        rounds can wedge PERMANENTLY (the chaos harness exposes this within
        seconds at drop:p=0.05). The retry is idempotent on every path: a
        worker mid-round re-scatters into dedup'd buffers, a worker that
        already finished re-asserts its lost CompleteAllreduce, a worker
        that never started simply starts."""
        if self._preparing:
            return []
        now = self.clock()
        out: list[Envelope] = []
        for r in sorted(self.started_rounds):
            if r <= self.completed_up_to:
                continue
            last = max(
                self._started_at.get(r, 0.0), self._restarted_at.get(r, 0.0)
            )
            if now - last < min_age_s:
                continue
            done = self.completions.get(r, set())
            pending = [w for w in self.worker_ids if w not in done]
            if not pending:
                continue
            self._restarted_at[r] = now  # rate limit; latency stays honest
            _ROUNDS_RESTARTED.inc()
            log.info(
                "line %d: round %d stalled %.2fs at %d/%d completions; "
                "re-starting %s",
                self.line_id, r, now - last, len(done),
                self.completion_trigger, pending,
            )
            span = self._round_spans.get(r)
            ctx = span.context if span is not None else None
            # the round's ORIGINAL policy, never the controller's current
            # one: workers that already reduced buffers for r did so under
            # the stamp the first Start carried, and a re-issued Start
            # that disagreed would split the round's threshold semantics
            pol = self._round_policies.get(r, DEFAULT_POLICY)
            out.extend(
                Envelope(
                    peer_addr(w), StartAllreduce(r, self.epoch, pol), trace=ctx
                )
                for w in pending
            )
        return out

    def reprepare_pending(self, min_age_s: float) -> list[Envelope]:
        """Re-send PrepareAllreduce to workers that have not confirmed within
        ``min_age_s`` — delivery is at-most-once (a send can vanish into a
        connection whose peer just restarted), so the handshake must retry
        rather than wedge the line (SURVEY.md §4.5)."""
        if not self._preparing or self.clock() - self._prepared_at < min_age_s:
            return []
        pending = [w for w in self.worker_ids if w not in self._confirmed]
        self._prepared_at = self.clock()
        log.info(
            "line %d: re-sending Prepare(config %d) to unconfirmed %s",
            self.line_id,
            self.config_id,
            pending,
        )
        return self._prepare_envelopes(pending)

    @property
    def n_workers(self) -> int:
        return len(self.worker_ids)

    @property
    def completion_trigger(self) -> int:
        """Completions required for a round — the configured threshold,
        DEGRADED to the reachable-worker count when the detector has marked
        members unreachable mid-config: the dead cannot report, so waiting
        for them is a wedge, not a guarantee (never below 1)."""
        base = self.threshold.allreduce_count(self.n_workers)
        reachable = self.n_workers - len(self.unreachable)
        return max(1, min(base, reachable))

    def member_unreachable(self, worker_ids) -> list[Envelope]:
        """Degraded mode: the detector marked these workers unreachable.

        Lowers the effective completion trigger and immediately re-checks
        every in-flight round against it — a round that already has every
        completion the REACHABLE set can deliver completes NOW (graceful
        degradation) instead of wedging until the watchdog dumps a stall
        or a reorganization abandons it. No new rounds are started here:
        the grid master reorganizes right after, and feeding the window of
        a dying config would only burn round numbers.
        """
        affected = set(worker_ids) & set(self.worker_ids)
        new = affected - self.unreachable
        if not new:
            return []
        self.unreachable |= new
        trigger = self.completion_trigger
        for r in sorted(self.started_rounds):
            if r <= self.completed_up_to or r not in self.started_rounds:
                continue  # retired by an earlier completion this loop
            if len(self.completions.get(r, ())) >= trigger:
                log.info(
                    "line %d: round %d completes DEGRADED (%d/%d workers "
                    "unreachable, trigger %d)",
                    self.line_id, r, len(self.unreachable),
                    self.n_workers, trigger,
                )
                _ROUNDS_DEGRADED.inc()
                self._complete_round(r, degraded=True)
        return []

    # -- message dispatch ----------------------------------------------------

    def handle(self, msg: Any) -> list[Envelope]:
        if isinstance(msg, ConfirmPreparation):
            return self._on_confirm(msg)
        if isinstance(msg, CompleteAllreduce):
            return self._on_complete(msg)
        raise TypeError(f"line master cannot handle {type(msg).__name__}")

    def _on_confirm(self, msg: ConfirmPreparation) -> list[Envelope]:
        if msg.config_id != self.config_id or not self._preparing:
            return []
        self._confirmed.add(msg.worker_id)
        if self._confirmed != set(self.worker_ids):
            return []
        # all workers rebuilt their buffers: open the round window
        self._preparing = False
        log.info(
            "line %d: config %d confirmed by all %d workers; starting at round %d",
            self.line_id,
            self.config_id,
            self.n_workers,
            self.next_round,
        )
        return self._fill_window()

    def worker_lags(self) -> dict[int, int]:
        """Per-worker contribution lag in ROUNDS: how far each worker's
        newest completion assertion trails the line's completed horizon.
        Reachable workers only — the detector owns the unreachable story
        (degraded mode), the controller owns the slow-but-alive one."""
        return {
            w: max(0, self.completed_up_to - self.worker_last_complete.get(w, -1))
            for w in self.worker_ids
            if w not in self.unreachable
        }

    def _on_complete(self, msg: CompleteAllreduce) -> list[Envelope]:
        r = msg.round_num
        if msg.src_id in self.worker_last_complete:
            # the lag watermark advances on EVERY assertion, stale ones
            # included: a late completion is exactly the straggler signal
            prev = self.worker_last_complete.get(msg.src_id, -1)
            self.worker_last_complete[msg.src_id] = max(prev, r)
        if self._preparing or r <= self.completed_up_to or r not in self.started_rounds:
            return []  # stale or unknown round
        done = self.completions.setdefault(r, set())
        if msg.src_id in done:
            return []
        done.add(msg.src_id)
        if len(done) < self.completion_trigger:
            return []
        self._complete_round(r)
        return self._fill_window()

    def _complete_round(self, r: int, *, degraded: bool = False) -> None:
        """The completion body: advance the watermark, account the round,
        close its span, and abandon older in-flight rounds (the workers'
        own discipline). Callers decide whether to refill the window —
        threshold completions do, degraded completions don't (the config
        is about to be replaced)."""
        done = self.completions.get(r, set())
        self.completed_up_to = max(self.completed_up_to, r)
        self.total_completed += 1
        _ROUNDS_COMPLETED.inc()
        # per-mode round accounting (OBSERVABILITY.md adapt.*): which wire
        # mode this round actually ran under — the A/B attribution signal
        # soak/bench reports carry
        pol = self._round_policies.get(r, DEFAULT_POLICY)
        _MODE_ROUNDS[pol.wire].inc()
        started = self._started_at.get(r)
        latency = self.clock() - started if started is not None else -1.0
        if latency >= 0:
            _ROUND_LATENCY.observe(latency)
        if self.on_round_complete is not None:
            self.on_round_complete(
                self.line_id, r, latency, len(done), self.n_workers
            )
        span = self._round_spans.pop(r, None)
        if span is not None:
            span.set(completions=len(done))
            if degraded:
                span.set(degraded=True)
            span.end()
        for stale in [x for x in self.started_rounds if x <= r]:
            self.started_rounds.discard(stale)
            self.completions.pop(stale, None)
            self._started_at.pop(stale, None)
            self._restarted_at.pop(stale, None)
            self._round_policies.pop(stale, None)
            stale_span = self._round_spans.pop(stale, None)
            if stale_span is not None:
                _ROUNDS_ABANDONED.inc()
                stale_span.set(abandoned=True)
                stale_span.end()

    # -- round window --------------------------------------------------------

    def refill(self) -> list[Envelope]:
        """Re-check the window after an EXTERNAL event opened a start
        gate (a row line completing the round a column line waits on) —
        a no-op while the Prepare handshake is still in flight."""
        if self._preparing:
            return []
        return self._fill_window()

    def _fill_window(self) -> list[Envelope]:
        out: list[Envelope] = []
        while len(self.started_rounds) < self.config.round_window:
            if (
                self.config.max_rounds >= 0
                and self.completed_so_far
                + self.total_completed
                + len(self.started_rounds)
                >= self.config.max_rounds
            ):
                break
            if self.start_gate is not None and not self.start_gate(
                self.next_round
            ):
                # gated: the window stops filling HERE (rounds start in
                # order); the grid master refill()s us when the gate's
                # upstream round completes
                break
            r = self.next_round
            self.next_round += 1
            self.started_rounds.add(r)
            self._started_at[r] = self.clock()
            # the policy is FROZEN per round at start (the stamp every
            # worker and every re-Start of r must agree on) — recorded
            # unconditionally, so a round started under the DEFAULT policy
            # can never inherit a later level through a re-Start fallback
            pol = self.policy
            self._round_policies[r] = pol
            # the round's trace is minted HERE: one fresh trace id, a
            # line_master.round root span that stays open until the
            # threshold completion, and the context stamped onto every
            # StartAllreduce so workers/transports continue the same trace
            span = obs_trace.start_span(
                "line_master.round",
                root=True,  # fresh trace id per round, never a child of the
                # completion handler's ambient context
                line=self.line_id,
                round=r,
                config=self.config_id,
            )
            if not pol.is_default:
                span.set(policy=pol.describe())
            self._round_spans[r] = span
            if self.on_round_start is not None:
                self.on_round_start(self.line_id, r)
            out.extend(
                Envelope(
                    peer_addr(w),
                    StartAllreduce(r, self.epoch, pol),
                    trace=span.context,
                )
                for w in self.worker_ids
            )
        return out

    @property
    def is_done(self) -> bool:
        """max_rounds line-rounds COMPLETED across the line's lineage (only
        meaningful with max_rounds >= 0). Budgeting completions, not round
        numbers, means reorganization churn can never satisfy the budget
        without actual work."""
        return (
            self.config.max_rounds >= 0
            and not self._preparing
            and self.completed_so_far + self.total_completed
            >= self.config.max_rounds
        )
