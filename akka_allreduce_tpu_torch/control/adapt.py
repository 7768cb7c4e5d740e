"""Closed-loop adaptive degradation (RESILIENCE.md "Tier 5 — adaptation"; the
port's own copy of the JAX package's ``control/adapt.py``).

The paper's core idea — threshold (partial) completion — was statically
configured at cluster start. This module closes the loop: the LEADER
master owns one :class:`AdaptiveController` that, once per round window,
reads straggler evidence and emits a per-round
:class:`~akka_allreduce_tpu_torch.protocol.RoundPolicy` — an effective
``th_reduce`` (bounded by a configured floor) plus a wire compression
mode (``f32 → f16 → int8``) — and a restore path back to full fidelity
when the tail recovers. Fault *tolerance* becomes fault *adaptation*.

Evidence (gathered by the master FROM the metrics registry and the
grid, then handed in — the controller itself is a pure state machine over
its inputs, which is what makes its decisions replayable):

- **contribution lag** (rounds): how far each worker's newest
  ``CompleteAllreduce`` assertion trails the completed horizon
  (``LineMaster.worker_lags`` — stale/late assertions move the watermark,
  so a chronically-late worker shows its lag in round units, no clock);
- **round latency** vs a learned healthy baseline (the registry's
  ``master.round_latency_s`` observations, folded in per round) — catches
  the straggler everyone must wait for (``th == 1.0``), which produces no
  lag because no round completes without it;
- **registry counter deltas**: ``master.rounds_restarted`` (loss so bad
  rounds had to be re-Started), ``remote.endpoint_reconnects``,
  ``chaos.injected.drop`` (when the chaos layer is armed, its own count
  is the ground-truth drop rate), and ``master.reorganizations``
  (membership churn in the window BLOCKS restores — a heal is not proven
  while the grid is still re-meshing).

Hysteresis: degrade and restore use DISTINCT thresholds
(``lag_degrade``/``lag_restore``, ``slow_factor``/recovered-mean) and
every transition requires ``min_dwell`` rounds at the current level — a
noisy tail cannot flap the mode. Decisions are paced by ROUND
COMPLETIONS (one evaluation per ``window`` observed rounds), never by a
wall-clock timer; the decision log records logical fields only, so the
same evidence sequence replays the same log byte for byte (pinned in
tests/test_adapt.py).

Failover: the controller's compact state rides the ``StateDigest``
(``digest()``/``restore()``), so a promoted standby inherits the current
level mid-incident instead of resetting to full fidelity — the promoted
master's FIRST Prepare already carries the inherited policy (pinned in
tests/test_failover.py).
"""

from __future__ import annotations

import json
import logging
from typing import Any

from akka_allreduce_tpu_torch.config import AdaptConfig, ThresholdConfig
from akka_allreduce_tpu_torch.obs import flight as _flight
from akka_allreduce_tpu_torch.obs import metrics as _metrics
from akka_allreduce_tpu_torch.protocol import DEFAULT_POLICY, RoundPolicy

log = logging.getLogger(__name__)

__all__ = ["AdaptiveController"]

# adapt.* observability (OBSERVABILITY.md): the current ladder level, the
# transition counters the soak/bench A/B reports carry, and a decisions
# counter so "the controller ran and chose to hold" is visible too
_LEVEL = _metrics.gauge("adapt.level")
_DEGRADES = _metrics.counter("adapt.degrades")
_RESTORES = _metrics.counter("adapt.restores")
_DECISIONS = _metrics.counter("adapt.decisions")

#: wire modes per degrade level past full fidelity (level 1, level 2)
_WIRE_LADDER = ("f16", "int8")

#: RoundPolicy wire stamp -> the trainer's gradient ``compress`` mode: the
#: ONE mapping that closes the trainer half of the loop (train/elastic.py's
#: ``apply_policy_wire``). The host wire's half-width float is f16; the
#: trainer's gradient sync's is bf16 (the tensor cores' half) — same ladder
#: step, per-plane dtype. "" (the default stamp) means inherit, i.e. the
#: trainer's construction-time mode, NOT necessarily full fidelity.
WIRE_TO_COMPRESS = {"f32": None, "f16": "bf16", "int8": "int8"}

#: registry counters whose WINDOW DELTAS are degrade pressure / restore
#: blockers — the master snapshots these and hands them to observe_round
COUNTER_EVIDENCE = ("restarts", "reconnects", "drops", "reorgs")


class AdaptiveController:
    """Per-round threshold + wire-precision controller (leader-owned).

    Feed it one :meth:`observe_round` per completed line-round; every
    ``config.window`` observations it evaluates the evidence and returns a
    NEW :class:`RoundPolicy` when the level changes (None = hold). The
    caller (``MasterProcess``) pushes a returned policy into the grid so
    rounds started from then on carry the stamp.
    """

    def __init__(
        self, config: AdaptConfig, threshold: ThresholdConfig
    ) -> None:
        self.config = config
        self.threshold = threshold
        self.level = 0
        # decision pacing + per-window evidence accumulators (reset each
        # evaluation) — all in round units or plain counts
        self._observed = 0  # rounds observed since the last evaluation
        self._rounds_at_level = 0  # dwell, in observed rounds
        self._window_latency_s = 0.0  # sum of this window's round latencies
        self._window_rounds = 0
        self._last_counters: dict[str, int] = {}
        # per-endpoint cumulative byte watermarks (the transport's bandwidth
        # gauges): the controller diffs them per window, like counters
        self._last_bw: dict[str, float] = {}
        # healthy-latency baseline: learned from the FIRST full window
        # observed at level 0 with no pressure, then frozen — the yardstick
        # "slow" is measured against (0 until learned; latency evidence is
        # inert until then, lag/restart evidence never is)
        self.baseline_latency_s = 0.0
        # bounded decision log: logical fields only (NO timestamps), so
        # the same evidence sequence replays the same log byte for byte
        self.decisions: list[dict[str, Any]] = []
        # the most recent transition's record, even past the log cap —
        # what per-event consumers (metrics JSONL) must read, NOT
        # decisions[-1], which freezes once the bounded log fills
        self.last_decision: dict[str, Any] | None = None
        self.transitions = 0
        _LEVEL.set(0)

    # -- the ladder ----------------------------------------------------------

    def policy_for_level(self, level: int) -> RoundPolicy:
        """The RoundPolicy of ladder step ``level`` (0 = full fidelity =
        the default inherit-everything policy). th_reduce interpolates
        from the configured value down to ``floor_th_reduce`` across the
        ladder; the wire mode walks f16 then int8."""
        if level <= 0:
            return DEFAULT_POLICY
        levels = self.config.levels
        level = min(level, levels)
        base = self.threshold.th_reduce
        floor = min(self.config.floor_th_reduce, base)
        th = base - (base - floor) * (level / levels)
        return RoundPolicy(
            th_reduce=round(max(floor, th), 6),
            wire=_WIRE_LADDER[min(level, len(_WIRE_LADDER)) - 1],
        )

    def policy(self) -> RoundPolicy:
        return self.policy_for_level(self.level)

    # -- evidence intake -----------------------------------------------------

    @property
    def deciding_next(self) -> bool:
        """True when the NEXT :meth:`observe_round` call evaluates the
        window — callers can skip gathering the lag map and counter
        snapshot for the calls that would discard them."""
        return self._observed + 1 >= self.config.window

    def observe_round(
        self,
        round_num: int,
        worker_lags: dict[int, int],
        counters: dict[str, int],
        latency_s: float | None = None,
        bandwidth: dict[str, float] | None = None,
    ) -> RoundPolicy | None:
        """One completed line-round of evidence; returns the new policy on
        a level transition, else None.

        ``worker_lags`` is the grid's per-worker contribution lag in
        rounds; ``counters`` holds the CUMULATIVE registry counters named
        in :data:`COUNTER_EVIDENCE` (the controller diffs them against the
        previous window); ``latency_s`` is the round's latency observation
        (the same number the registry histogram absorbed) — optional, for
        callers without a clock (the soak simulation). ``bandwidth`` maps
        peer endpoints to CUMULATIVE bytes moved (the transport's
        ``transport.endpoint.<host:port>.tx_bytes + rx_bytes`` gauges, as
        visible to the gathering process) — the bandwidth-imbalance arm
        (``AdaptConfig.bw_degrade_ratio``) diffs them per window and
        reads one endpoint moving far less than the median as straggler
        pressure, with its own hysteresis bar on the restore side.
        """
        self._observed += 1
        self._rounds_at_level += 1
        self._window_rounds += 1
        if latency_s is not None and latency_s >= 0:
            self._window_latency_s += latency_s
        if self._observed < self.config.window:
            return None
        return self._decide(round_num, worker_lags, counters, bandwidth)

    # -- the decision --------------------------------------------------------

    def _bw_ratio(self, bandwidth: dict[str, float] | None) -> float | None:
        """slowest-endpoint / median-endpoint byte delta for the window,
        or None when the arm is disabled or the evidence is too thin
        (fewer than 3 endpoints that moved anything: no median to stand
        out against)."""
        if self.config.bw_degrade_ratio <= 0 or bandwidth is None:
            return None
        known = self._last_bw
        deltas = sorted(
            d
            for k, v in bandwidth.items()
            if k in known and (d := max(0.0, float(v) - known[k])) > 0.0
            # zero-delta endpoints are excluded for the QUIET-WINDOW case
            # only: a link that moved nothing this window indicts nobody
            # (membership — tiers 3/6 — owns silent peers, and the
            # transport now EVICTS an expelled peer's rows outright via
            # forget_endpoint, so a dead peer's frozen row can no longer
            # masquerade as one); this arm judges links that are MOVING
            # data, just too little. First-seen endpoints (no watermark
            # yet) are excluded too: a peer that joined mid-window
            # carries only partial-window bytes and would read as a
            # spurious straggler — it gets its watermark seeded now and
            # is judged from the next window
        )
        self._last_bw = {k: float(v) for k, v in bandwidth.items()}
        if len(deltas) < 3:
            return None
        median = deltas[len(deltas) // 2]
        if median <= 0.0:
            return None  # a quiet window indicts nobody
        return deltas[0] / median

    def _decide(
        self,
        round_num: int,
        worker_lags: dict[int, int],
        counters: dict[str, int],
        bandwidth: dict[str, float] | None = None,
    ) -> RoundPolicy | None:
        cfg = self.config
        deltas = {
            k: max(0, int(counters.get(k, 0)) - self._last_counters.get(k, 0))
            for k in COUNTER_EVIDENCE
        }
        self._last_counters = {
            k: int(counters.get(k, 0)) for k in COUNTER_EVIDENCE
        }
        mean_latency = (
            self._window_latency_s / self._window_rounds
            if self._window_rounds
            else 0.0
        )
        max_lag = max(worker_lags.values(), default=0)
        slow = (
            self.baseline_latency_s > 0.0
            and mean_latency > cfg.slow_factor * self.baseline_latency_s
        )
        lagging = max_lag >= cfg.lag_degrade
        # connectivity noise: endpoint reconnects + (chaos-armed) dropped
        # sends this window — retried/absorbed loss that never forces a
        # re-Start still reads as pressure once it reaches the threshold
        noise = deltas["reconnects"] + deltas["drops"]
        noisy = cfg.noise_degrade > 0 and noise >= cfg.noise_degrade
        # bandwidth-imbalance arm (the transport's gauges): one endpoint moving far
        # below the median endpoint's bytes this window is a straggling
        # link even when completions still arrive in time
        bw_ratio = self._bw_ratio(bandwidth)
        bw_lagging = bw_ratio is not None and bw_ratio < cfg.bw_degrade_ratio
        pressed = (
            lagging or slow or deltas["restarts"] > 0 or noisy or bw_lagging
        )
        # the healthy baseline is learned from the first quiet full window
        # at full fidelity, then frozen — degraded rounds are FASTER by
        # design and must not drag the yardstick down with them
        if (
            self.baseline_latency_s == 0.0
            and self.level == 0
            and not pressed
            and mean_latency > 0.0
        ):
            self.baseline_latency_s = mean_latency
        self._observed = 0
        self._window_latency_s = 0.0
        self._window_rounds = 0
        _DECISIONS.inc()
        dwelt = self._rounds_at_level >= cfg.min_dwell
        if pressed and self.level < cfg.levels and dwelt:
            return self._transition(
                round_num, self.level + 1, max_lag, deltas,
                [
                    name
                    for name, hit in (
                        ("lag", lagging), ("latency", slow),
                        ("restarts", deltas["restarts"] > 0),
                        ("noise", noisy),
                        ("bandwidth", bw_lagging),
                    )
                    if hit
                ],
            )
        recovered = (
            max_lag <= cfg.lag_restore
            and not slow
            and deltas["restarts"] == 0
            # a reorganization in the window means membership is still
            # churning (an expelled straggler re-joining reads as healed
            # for a moment): never restore on churn evidence
            and deltas["reorgs"] == 0
            # hysteresis gap on the noise arm: restore only when the
            # window's reconnects+drops fell below HALF the degrade bar
            and (cfg.noise_degrade <= 0 or noise * 2 < cfg.noise_degrade)
            # the bandwidth arm's own hysteresis bar: the slow endpoint
            # must be back above DOUBLE the degrade ratio (thin evidence
            # — too few endpoints, a quiet window — never blocks)
            and (bw_ratio is None or bw_ratio >= 2.0 * cfg.bw_degrade_ratio)
        )
        if recovered and self.level > 0 and dwelt:
            return self._transition(
                round_num, self.level - 1, max_lag, deltas, ["recovered"]
            )
        return None

    def _transition(
        self,
        round_num: int,
        to_level: int,
        max_lag: int,
        deltas: dict[str, int],
        why: list[str],
    ) -> RoundPolicy:
        frm = self.level
        self.level = to_level
        self._rounds_at_level = 0
        self.transitions += 1
        pol = self.policy()
        _LEVEL.set(to_level)
        (_DEGRADES if to_level > frm else _RESTORES).inc()
        rec = {
            "seq": self.transitions - 1,
            "round": round_num,
            "from": frm,
            "to": to_level,
            "policy": pol.describe(),
            "why": why,
            "lag": max_lag,
            **deltas,
        }
        self.last_decision = rec
        if len(self.decisions) < 4096:  # bounded, like the chaos log
            self.decisions.append(rec)
        _flight.note("adapt", **rec)
        log.warning(
            "adapt: level %d -> %d at round %d (%s): policy %s "
            "(lag=%d rounds, restarts=%d, reconnects=%d, drops=%d)",
            frm, to_level, round_num, "+".join(why), pol.describe(),
            max_lag, deltas["restarts"], deltas["reconnects"], deltas["drops"],
        )
        return pol

    # -- logs / replication --------------------------------------------------

    def decision_log_jsonl(self) -> str:
        """The decision log, one sorted-key JSON object per line — logical
        fields only, so same evidence => byte-identical log (the chaos
        event log's determinism contract, applied to decisions)."""
        return "\n".join(json.dumps(d, sort_keys=True) for d in self.decisions)

    def write_log(self, path: str) -> str:
        with open(path, "w") as f:
            text = self.decision_log_jsonl()
            f.write(text + ("\n" if text else ""))
        return path

    def digest(self) -> dict[str, Any]:
        """The compact state a warm standby needs to CONTINUE the loop
        mid-incident (rides the StateDigest): the level (so the
        promoted master's first Prepare carries the inherited policy), the
        dwell so a takeover cannot reset the hysteresis clock, the learned
        baseline, and the counter watermarks so the first post-takeover
        window does not read the whole run's counters as one spike."""
        return {
            "level": self.level,
            "dwell": self._rounds_at_level,
            "baseline_s": self.baseline_latency_s,
            "counters": dict(self._last_counters),
            "bw": dict(self._last_bw),
            "transitions": self.transitions,
        }

    def restore(self, state: dict[str, Any] | None) -> None:
        """Adopt a replicated :meth:`digest` (standby takeover)."""
        if not state:
            return
        self.level = int(state.get("level", 0))
        self._rounds_at_level = int(state.get("dwell", 0))
        self.baseline_latency_s = float(state.get("baseline_s", 0.0))
        self._last_counters = {
            k: int(v) for k, v in dict(state.get("counters", {})).items()
        }
        self._last_bw = {
            k: float(v) for k, v in dict(state.get("bw", {})).items()
        }
        self.transitions = int(state.get("transitions", 0))
        _LEVEL.set(self.level)
