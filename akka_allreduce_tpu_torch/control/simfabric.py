"""Deterministic pod-scale membership simulator (RESILIENCE.md "Scale"; the
port's own copy of the JAX package's ``control/simfabric.py``).

``Fabric`` drives N :class:`~akka_allreduce_tpu_torch.control.gossip.GossipState`
machines over a synchronous in-process message fabric on a PURELY LOGICAL
clock, with an optional per-role :class:`ChaosInjector` compiled from the
real spec grammar — each role gets its own injector, exactly like each OS
process does over TCP. Same seed + same schedule = byte-identical chaos
logs and identical membership judgements, at 256–1024 nodes in seconds:
this is how the ladder's guarantees (zero false expulsions under a
partition, bounded confirmed-dead detection, leader failover + re-mesh)
are ASSERTED at production node counts that no CI box can spawn as real
processes (tests/test_gossip_scale.py; the ``chaos-scale`` drill records
the sim rate next to its real-process phases).

Grew out of tests/test_gossip.py's 64-node harness; promoted here so the
drill CLI and the scale suite share one definition. The only mechanics a
fabric applies are loss (drop/fail) — delay/reorder belong to the async
transports; a synchronous fabric models the CONTROL decisions, which are
clock-free by construction (every GossipState method takes ``now``).
"""

from __future__ import annotations

import time

from akka_allreduce_tpu_torch.config import GossipConfig
from akka_allreduce_tpu_torch.control.chaos import ChaosInjector
from akka_allreduce_tpu_torch.control.envelope import Envelope
from akka_allreduce_tpu_torch.control.gossip import (
    DEAD,
    MASTER_ID,
    GossipState,
)

__all__ = ["Fabric", "sim_rate"]


class Fabric:
    """Synchronous message fabric over N member state machines."""

    def __init__(
        self,
        n_nodes: int,
        *,
        config: GossipConfig | None = None,
        chaos_spec: str = "",
        chaos_seed: int = 99,
    ) -> None:
        self.now = 0.0
        self.n_nodes = n_nodes
        cfg = config or GossipConfig(
            enabled=True,
            probe_interval_s=0.5,
            probe_timeout_s=0.15,
            indirect=3,
            suspicion_periods=4,
            seed=7,
        )
        self.config = cfg
        self.states: dict[int, GossipState] = {
            MASTER_ID: GossipState(MASTER_ID, 1, cfg)
        }
        for i in range(n_nodes):
            # distinct incarnations, like distinct processes
            self.states[i] = GossipState(i, 1000 + i, cfg)
        roster = set(self.states)
        for st in self.states.values():
            st.set_members(roster)  # set_members drops the self id
        self.dead: set[int] = set()  # roles whose process is gone
        self.ticks = 0  # node-ticks executed (the sim-rate numerator)
        self.injectors: dict[int, ChaosInjector] = {}
        if chaos_spec:
            for role in self.states:
                self.injectors[role] = ChaosInjector(
                    chaos_seed, chaos_spec, role=role,
                    clock=lambda: self.now, t0=0.0,
                )

    def deliver(self, sender: int, envelopes: list[Envelope]) -> None:
        for env in envelopes:
            inj = self.injectors.get(sender)
            if inj is not None:
                act = inj.plan_send(env)
                if act is not None and (act.drop or act.fail):
                    continue  # the fabric's only mechanics: loss
            target = int(env.dest.rpartition(":")[2])
            st = self.states.get(target)
            if st is None or target in self.dead:
                continue
            self.deliver(target, st.handle(env.msg, self.now))

    def step(self, dt: float = 0.1) -> None:
        self.now += dt
        for role in sorted(self.states):
            if role in self.dead:
                continue
            self.ticks += 1
            self.deliver(role, self.states[role].tick(self.now))

    def run(self, seconds: float, dt: float = 0.1) -> None:
        for _ in range(int(seconds / dt)):
            self.step(dt)

    # -- failure scripting -----------------------------------------------------

    def kill(self, role: int) -> None:
        """The role's process is gone: it stops ticking and every frame
        addressed to it vanishes (the fabric's SIGKILL)."""
        self.dead.add(role)

    def promote_master(self, incarnation: int) -> GossipState:
        """A standby takes over the MASTER_ID ring identity under a
        bumped incarnation (a takeover joins the ring exactly like
        this: fresh epoch = fresh incarnation, same member id). The dead
        leader's state object is replaced wholesale and the role
        resumes ticking."""
        st = GossipState(MASTER_ID, incarnation, self.config)
        st.set_members(set(self.states))
        self.states[MASTER_ID] = st
        self.dead.discard(MASTER_ID)
        return st

    def run_until(self, pred, timeout_s: float, dt: float = 0.1) -> float | None:
        """Step until ``pred(self)`` holds; logical seconds elapsed, or
        None when the timeout ran out first."""
        t0 = self.now
        while self.now - t0 < timeout_s:
            self.step(dt)
            if pred(self):
                return self.now - t0
        return None

    # -- views -----------------------------------------------------------------

    @property
    def master(self) -> GossipState:
        return self.states[MASTER_ID]

    def dead_count_at_master(self) -> int:
        return sum(
            1
            for nid in range(self.n_nodes)
            if self.master.status_of(nid) == DEAD
        )

    def judgement(self) -> tuple:
        """A compact, hashable view of every state machine's verdicts +
        counters — what the same-seed determinism pins compare."""
        return tuple(
            (
                role,
                st.incarnation,
                st.probes_sent,
                st.indirect_sent,
                st.suspicions,
                st.confirms,
                st.refutations,
                st.digest_truncations,
                tuple(
                    (n, r.incarnation, r.status)
                    for n, r in sorted(st.members.items())
                ),
            )
            for role, st in sorted(self.states.items())
        )


def sim_rate(n_nodes: int = 256, seconds: float = 10.0) -> dict:
    """Measure the fabric's throughput on THIS box: node-ticks/second
    over a quiet ``n_nodes`` sim — the number the chaos-scale drill
    records in its summary (a regression here is the O(N²) class the
    1024-node arms exist to keep out)."""
    fab = Fabric(n_nodes)
    t0 = time.perf_counter()
    fab.run(seconds)
    wall = time.perf_counter() - t0
    return {
        "nodes": n_nodes,
        "sim_seconds": seconds,
        "wall_seconds": round(wall, 3),
        "node_ticks": fab.ticks,
        "node_ticks_per_s": round(fab.ticks / max(wall, 1e-9)),
    }
