"""Failure detection for the elastic control plane (the port's own copy of
the JAX package's ``control/failure.py``).

The reference gets membership from Akka Cluster's gossip + phi-accrual failure
detector (SURVEY.md §3 "Membership"; §4.5 call stack). This build keeps the
same two-tier contract: within-round straggling is absorbed by thresholds (no
detector involvement), while *sustained* silence trips the detector and drives
the master's re-mesh (SURVEY.md §8.4).

``PhiAccrualFailureDetector`` is the standard Hayashibara et al. estimator the
reference relies on: per node, keep a window of heartbeat inter-arrival times,
model them as normal, and report suspicion ``phi = -log10(P(heartbeat still
coming after t_silent))``. ``phi >= threshold`` (default 8, Akka's default)
marks the node unreachable. ``HeartbeatMonitor`` turns that into edge-triggered
membership events for the GridMaster.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from enum import Enum
from typing import Callable

from akka_allreduce_tpu_torch.obs import flight as _flight


class MemberState(Enum):
    UP = "up"
    UNREACHABLE = "unreachable"


@dataclasses.dataclass
class MembershipEvent:
    node_id: int
    state: MemberState
    at: float
    phi: float


class PhiAccrualFailureDetector:
    """Suspicion-level failure detector over heartbeat inter-arrival times."""

    def __init__(
        self,
        *,
        threshold: float = 8.0,
        window: int = 100,
        min_std: float = 0.05,
        first_heartbeat_estimate: float = 1.0,
    ) -> None:
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        self.threshold = threshold
        self.window = window
        self.min_std = min_std
        self.first_estimate = first_heartbeat_estimate
        self._intervals: dict[int, deque[float]] = {}
        self._last: dict[int, float] = {}

    def heartbeat(self, node_id: int, now: float) -> None:
        last = self._last.get(node_id)
        if last is None:
            # seed the history with the configured estimate (the Akka
            # detector's bootstrap) so the first few real samples — which may
            # be tiny — cannot collapse the estimated interval to ~0
            self._intervals[node_id] = deque(
                [self.first_estimate], maxlen=self.window
            )
        else:
            self._intervals[node_id].append(max(now - last, 0.0))
        self._last[node_id] = now

    def remove(self, node_id: int) -> None:
        self._intervals.pop(node_id, None)
        self._last.pop(node_id, None)

    def _mean_std(self, node_id: int) -> tuple[float, float]:
        xs = self._intervals.get(node_id)
        if not xs:
            # one (or zero) heartbeats seen: assume the configured estimate
            # with generous spread, as the Akka detector does on first contact
            return self.first_estimate, self.first_estimate / 2.0
        mean = sum(xs) / len(xs)
        var = sum((x - mean) ** 2 for x in xs) / len(xs)
        return mean, max(math.sqrt(var), self.min_std, mean * 0.1)

    def phi(self, node_id: int, now: float) -> float:
        """Suspicion level; 0 for a node never heard from (can't suspect it)."""
        last = self._last.get(node_id)
        if last is None:
            return 0.0
        mean, std = self._mean_std(node_id)
        t = now - last
        y = (t - mean) / std
        # P(X > t) for X ~ N(mean, std), via the logistic approximation to the
        # normal CDF used by the reference detector family
        p_later = 1.0 / (1.0 + math.exp(min(y * 1.5976 + 0.070566 * y**3, 700.0)))
        if p_later <= 0.0:
            return float("inf")
        return -math.log10(p_later)

    def is_available(self, node_id: int, now: float) -> bool:
        return self.phi(node_id, now) < self.threshold


class LeaderLease:
    """Standby-side lease on the leader, fed by ``StateDigest`` arrivals.

    The phi detector with a single pseudo-member (the leader): ``renew``
    on every digest, and ``expired`` once suspicion crosses the threshold
    — the takeover trigger of the master-HA protocol (RESILIENCE.md
    "Tier 4"). A standby that never received a digest can NOT expire the
    lease: it cannot distinguish "leader dead" from "my registration never
    landed", so it keeps re-registering instead of seizing an epoch whose
    state it does not hold.
    """

    _LEADER = -1  # MASTER_ROLE: the only member this detector tracks

    def __init__(
        self,
        *,
        threshold: float = 8.0,
        first_heartbeat_estimate: float = 1.0,
    ) -> None:
        self.detector = PhiAccrualFailureDetector(
            threshold=threshold,
            first_heartbeat_estimate=first_heartbeat_estimate,
        )
        self.renewals = 0

    def renew(self, now: float) -> None:
        self.detector.heartbeat(self._LEADER, now)
        self.renewals += 1

    def phi(self, now: float) -> float:
        return self.detector.phi(self._LEADER, now)

    def expired(self, now: float) -> bool:
        return self.renewals > 0 and not self.detector.is_available(
            self._LEADER, now
        )

    def reset(self) -> None:
        """Forget the lease history (a fresh leader identity: its digest
        cadence must not inherit the dead leader's inter-arrival model)."""
        self.detector.remove(self._LEADER)
        self.renewals = 0


class HeartbeatMonitor:
    """Edge-triggered membership tracking on top of the phi detector.

    Feed it heartbeats; ``poll(now)`` returns the membership *changes* since
    the last poll — the events the GridMaster's ``member_up`` /
    ``member_unreachable`` handlers consume (SURVEY.md §4.5).
    """

    def __init__(
        self,
        detector: PhiAccrualFailureDetector | None = None,
        *,
        on_event: Callable[[MembershipEvent], None] | None = None,
    ) -> None:
        self.detector = detector or PhiAccrualFailureDetector()
        self.states: dict[int, MemberState] = {}
        self._on_event = on_event

    @property
    def members_up(self) -> list[int]:
        return sorted(
            n for n, s in self.states.items() if s is MemberState.UP
        )

    def heartbeat(self, node_id: int, now: float) -> MembershipEvent | None:
        """Record a heartbeat; returns an UP event if this (re)joins the node."""
        if self.states.get(node_id) is not MemberState.UP:
            # (re)joining after death or silence: the dead gap must not enter
            # the inter-arrival model — each such sample inflates mean/std and
            # makes the detector progressively slower until real crashes go
            # undetected (observed across repeated crash/rejoin cycles)
            self.detector.remove(node_id)
            self.detector.heartbeat(node_id, now)
            return self._transition(node_id, MemberState.UP, now)
        self.detector.heartbeat(node_id, now)
        return None

    def leave(self, node_id: int, now: float) -> MembershipEvent | None:
        """Graceful departure (the reference's Cluster leave)."""
        self.detector.remove(node_id)
        if self.states.get(node_id) is MemberState.UP:
            return self._transition(node_id, MemberState.UNREACHABLE, now)
        self.states.pop(node_id, None)
        return None

    def force_unreachable(self, node_id: int, now: float) -> MembershipEvent | None:
        """Subscriber entry point for an EXTERNAL failure verdict — the
        SWIM gossip layer's confirmed-dead (control/gossip.py): with
        decentralized membership this monitor no longer judges liveness
        itself for gossip-speaking members, it only keeps the same
        edge-triggered event contract the GridMaster consumes. Returns
        the UNREACHABLE edge, or None when the node was already down."""
        self.detector.remove(node_id)
        if self.states.get(node_id) is not MemberState.UP:
            return None
        return self._transition(node_id, MemberState.UNREACHABLE, now)

    def poll(self, now: float) -> list[MembershipEvent]:
        """Detect silent nodes; returns newly-unreachable events."""
        events = []
        for node_id, state in list(self.states.items()):
            if state is MemberState.UP and not self.detector.is_available(
                node_id, now
            ):
                events.append(
                    self._transition(node_id, MemberState.UNREACHABLE, now)
                )
        return events

    def _transition(
        self, node_id: int, state: MemberState, now: float
    ) -> MembershipEvent:
        self.states[node_id] = state
        ev = MembershipEvent(
            node_id, state, now, self.detector.phi(node_id, now)
        )
        # membership edges into the flight-recorder ring: a chaos/stall
        # post-mortem reads WHEN the detector acted next to what the
        # transports dropped (RESILIENCE.md)
        _flight.note(
            "membership",
            node=node_id,
            state=state.value,
            phi=round(ev.phi, 2) if math.isfinite(ev.phi) else "inf",
        )
        if self._on_event:
            self._on_event(ev)
        return ev
