"""Multi-process cluster bootstrap: master and node roles over TCP (the
port's own copy of the JAX package's ``control/bootstrap.py``).

The reference's deployment (SURVEY.md §2 L4, §4.1): one ``main`` per role; the
master JVM binds a seed address, worker JVMs join via Akka Cluster, the grid
master organizes lines and rounds begin. Here:

- ``MasterProcess`` — binds the seed endpoint; owns the ``GridMaster`` (and
  thus every ``LineMaster``), the address book, and the phi-accrual
  ``HeartbeatMonitor``. Nodes join with ``JoinCluster``, are ``Welcome``d with
  an assigned node id + the cluster config, then heartbeat. Silence trips the
  detector -> ``member_unreachable`` -> re-organize (SURVEY.md §4.5); a
  late joiner re-runs the Prepare/Confirm handshake.
- ``NodeProcess`` — dials the seed, then hosts one ``AllreduceNode`` (one
  worker per grid dimension) whose scatter/reduce chunks travel as wire frames
  directly between nodes — the master never relays payloads, matching the
  reference where workers message peers point-to-point.

Addressing: ``master`` and every ``line_master:<id>`` live on the master
process; ``worker:<id>`` lives on node ``id // dims``; ``client:<port>`` is a
pre-welcome return address (the joiner does not yet know its node id);
``node:<id>`` receives master broadcasts (address book, shutdown).

The port's node holds its round buffers and its payload on ``device`` (the
card unless the caller asks for the CPU); its transport moves payloads off
and onto the card at the socket. The master holds no payload and opens no
CUDA context. A node arms the chaos injector from the spec its ``Welcome``
carries; the leader arms its own and runs the adaptive controller.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import time
from typing import Any, Callable

import torch

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.config import AllreduceConfig
from akka_allreduce_tpu_torch.control import cluster as cl
from akka_allreduce_tpu_torch.control.envelope import Envelope
from akka_allreduce_tpu_torch.control.failure import (
    HeartbeatMonitor,
    LeaderLease,
    MemberState,
    PhiAccrualFailureDetector,
)
from akka_allreduce_tpu_torch.control import gossip as gsp
from akka_allreduce_tpu_torch.control.grid_master import GridMaster
from akka_allreduce_tpu_torch.control.node import AllreduceNode
from akka_allreduce_tpu_torch.control.remote import (
    RemoteTransport,
    observed_task,
    run_periodic,
)
from akka_allreduce_tpu_torch.control import statetransfer as st
from akka_allreduce_tpu_torch.control.worker import DataSink, DataSource
from akka_allreduce_tpu_torch.obs import flight as _flight
from akka_allreduce_tpu_torch.obs import metrics as _metrics

log = logging.getLogger(__name__)

# master-HA observability (OBSERVABILITY.md): the current leadership epoch,
# takeover/fence/walk counters, and the digest stream volume — the signals a
# failover post-mortem reads next to the chaos event log
_EPOCH_GAUGE = _metrics.gauge("master.epoch")
_TAKEOVERS = _metrics.counter("failover.takeovers")
_DIGESTS_SENT = _metrics.counter("failover.digests_sent")
_DIGESTS_RECEIVED = _metrics.counter("failover.digests_received")
_FENCED = _metrics.counter("failover.fenced")
_WALKS = _metrics.counter("failover.walks")
_SOLICITS = _metrics.counter("failover.advert_solicits")
# decentralized-membership observability (RESILIENCE.md "Tier 6"): how
# many expulsions the GOSSIP verdict drove (vs the legacy phi hub's), and
# how often a freshly-admitted member was shielded from a stale rumor
_GOSSIP_EXPULSIONS = _metrics.counter("gossip.expulsions")
_GOSSIP_SHIELDED = _metrics.counter("gossip.rumors_shielded")
# the AdaptiveController's registry evidence (control/adapt.py): cumulative
# counters whose window deltas are degrade pressure / restore blockers,
# held as objects so the per-round gather is attribute reads, not lookups
_EV_RESTARTS = _metrics.counter("master.rounds_restarted")
_EV_RECONNECTS = _metrics.counter("remote.endpoint_reconnects")
_EV_DROPS = _metrics.counter("chaos.injected.drop")
_EV_REORGS = _metrics.counter("master.reorganizations")


class MasterProcess:
    """Seed-node role: membership, line organization, round scheduling.

    Master high availability (RESILIENCE.md "Tier 4 — control-plane
    failover"): every master runs with a monotonically-bumped leadership
    ``epoch`` stamped onto all master->node control messages (nodes fence
    stale-epoch senders, so a zombie deposed leader can never split-brain
    a healed partition). With ``standby_of`` set, this process is a WARM
    STANDBY instead: it registers with the leader, absorbs the replicated
    :class:`cl.StateDigest` stream (membership + incarnations, round
    counters, the peer-checkpoint holder registry, the full config), and
    takes over — bumping the epoch — when its :class:`LeaderLease` expires
    on digest silence. Nodes then walk the standby list distributed via
    ``Welcome``/``AddressBook`` and re-join the new leader.
    """

    def __init__(
        self,
        config: AllreduceConfig,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        clock: Callable[[], float] = time.monotonic,
        phi_threshold: float = 8.0,
        metrics=None,  # utils.metrics.MetricsLogger | None
        epoch: int = 1,
        standby_of: cl.Endpoint | None = None,
        allow_crash: bool = False,
        chaos_log: str | None = None,
    ) -> None:
        self.config = config
        self.clock = clock
        self.metrics = metrics
        self.epoch = epoch
        self.standby_of = standby_of
        self.allow_crash = allow_crash
        self.chaos_log = chaos_log
        self._took_over = False
        self._fenced_out = False
        self.shutdown_reason: str | None = None
        # standby endpoints registered with THIS leader, in registration
        # order (the walk order nodes follow on leader loss)
        self.standby_eps: list[cl.Endpoint] = []
        self._digest_seq = 0
        # the digest's slow-moving half (config, membership, the ckpt
        # registry) is cached between state changes AS SERIALIZED JSON:
        # the per-tick lease heartbeat pays for the tiny round-counter
        # object and a string splice, not a full re-serialization of the
        # config and every retained checkpoint manifest
        self._digest_static: str | None = None
        # standby-side lease on the leader, renewed per received digest
        self._lease = LeaderLease(
            threshold=phi_threshold,
            first_heartbeat_estimate=config.master.heartbeat_interval_s,
        )
        self._last_digest: cl.StateDigest | None = None
        self._register_countdown = 0
        self._standby_task: asyncio.Task | None = None
        # observers the CLI can hook (the chaos-failover drill watches the
        # TAKEOVER line this callback prints)
        self.on_takeover: Callable[["MasterProcess"], None] | None = None
        self.watchdog = None
        if config.master.round_deadline_s > 0:
            from akka_allreduce_tpu_torch.obs.watchdog import RoundWatchdog

            self.watchdog = RoundWatchdog(
                config.master.round_deadline_s, clock=clock
            )
        # closed-loop adaptive degradation (control/adapt.py): the LEADER
        # drives it; a passive standby builds its own at takeover (from
        # the adopted config) and inherits the level via the digest
        self.adapt = None
        if config.adapt.enabled and standby_of is None:
            from akka_allreduce_tpu_torch.control.adapt import AdaptiveController

            self.adapt = AdaptiveController(config.adapt, config.threshold)
        self.grid = self._build_grid()
        self.monitor = HeartbeatMonitor(
            PhiAccrualFailureDetector(
                threshold=phi_threshold,
                first_heartbeat_estimate=config.master.heartbeat_interval_s,
            )
        )
        self.book: dict[int, cl.Endpoint] = {}
        self.unreachable: set[int] = set()
        self._incarnations: dict[int, int] = {}
        # last superseded incarnation per node id: (incarnation, endpoint) of
        # the process whose id was reclaimed — so its surviving heartbeats can
        # be answered with a Shutdown instead of silently orphaning it
        self._superseded: dict[int, tuple[int, cl.Endpoint]] = {}
        self.transport = RemoteTransport(host, port)
        self.transport.wire_f16 = config.metadata.wire_dtype == "f16"
        self.transport.retry_policy = config.master.retry
        self.transport.configure_data_plane(config.data_plane)
        if config.chaos.enabled:
            self._arm_chaos()
        # peer checkpoint registry (statetransfer, RESILIENCE.md "Recovery"):
        # origin node id -> newest advertised manifest + which nodes hold it.
        # The master never touches chunk BYTES — it is the directory a
        # rejoiner consults for "what was my newest state, who has it".
        self._ckpt: dict[int, dict] = {}
        self.transport.register("master", self._on_cluster_msg)
        # forwarding lambda, NOT the bound method: a standby takeover
        # replaces self.grid wholesale, and the registration must follow it
        self.transport.register_prefix(
            "line_master", lambda lid, m: self.grid.handle_for_line(lid, m)
        )
        self.transport.set_prefix_route("worker", self._worker_endpoint)
        # method, not self.book.get: a standby takeover replaces the book
        self.transport.set_prefix_route("node", self._node_book_endpoint)
        self.transport.set_prefix_route("ckpt", self._node_endpoint)
        self.transport.set_prefix_route("gossip", self._gossip_endpoint)
        # SWIM gossip membership (control/gossip.py, RESILIENCE.md
        # "Tier 6"): with it enabled, nodes stop heartbeating into this
        # process's phi detector — the master becomes ONE member of the
        # probe ring and the HeartbeatMonitor a SUBSCRIBER of the gossip
        # verdict (mirror-refreshed for live members, force_unreachable
        # on confirmed deaths). A passive standby builds its own ring
        # identity at takeover (fresh epoch = fresh incarnation).
        self.gossip: gsp.GossipState | None = None
        self._gossip_agent: gsp.GossipAgent | None = None
        # members observed HUB-HEARTBEATING under a gossip-enabled config:
        # a legacy node that negotiated down (it never joined the ring)
        # stays under the phi hub's judgement — gossip's verdict never
        # expels it, its own heartbeats keep the monitor fresh. Everyone
        # else is the ring's to judge from the moment of admission (the
        # capability must default ring-ward: learning it per member takes
        # O(N) probe periods, far longer than a phi timeout).
        self._hub_speakers: set[int] = set()
        # clock of each member's latest (re)admission: a DEAD rumor that
        # predates the admission window is a stale slander about the old
        # process, never grounds to expel the one just welcomed
        self._gossip_admitted: dict[int, float] = {}
        if config.gossip.enabled and standby_of is None:
            self._build_gossip()
        self._poll_task: asyncio.Task | None = None
        self._done = asyncio.Event()

    def _build_grid(self) -> GridMaster:
        """One definition of the grid wiring — the ctor and a standby
        takeover (which replaces the grid under the adopted config) must
        never drift apart."""
        grid = GridMaster(
            self.config.threshold,
            self.config.master,
            self.config.line_master,
            on_round_complete=(
                self._on_round_complete
                if (self.metrics or self.watchdog or self.adapt)
                else None
            ),
            on_round_start=(
                self.watchdog.round_started if self.watchdog else None
            ),
            # a re-mesh abandons the replaced lines' rounds by design —
            # their deadlines must retire with them, not fire as stalls
            on_reorganize=(self.watchdog.reset if self.watchdog else None),
            epoch=self.epoch,
        )
        if self.adapt is not None:
            # the controller's current level survives grid rebuilds (a
            # takeover replaces the grid wholesale mid-incident)
            grid.set_policy(self.adapt.policy())
        return grid

    def _build_gossip(self) -> None:
        """One definition of the master's ring identity — the ctor and a
        standby takeover (fresh epoch) must never drift apart."""
        self.gossip = gsp.GossipState(
            gsp.MASTER_ID,
            self.epoch,
            self.config.gossip,
            seed=self.config.gossip.seed,
        )
        self._gossip_agent = gsp.GossipAgent(
            self.transport,
            self.gossip,
            clock=self.clock,
            # a fenced-out / finished master must not keep acking probes:
            # its silence is what lets the ring converge on the successor
            gate=lambda: self.active and not self._done.is_set(),
            on_message=self._on_gossip_msg,
        )

    def _gossip_roster(self) -> None:
        """Re-derive the probe ring's member set from the authoritative
        membership (book minus unreachable) after any change."""
        if self.gossip is not None:
            self.gossip.set_members(set(self.book) - self.unreachable)

    def _on_gossip_msg(self, msg) -> list[Envelope] | None:
        """Pre-handle hook on every inbound gossip frame: the unknown-
        pinger arm — a REPLACEMENT master that does not know the sender
        replies ``Rejoin`` + ``AdvertSolicit``, exactly like the hub's
        unknown-heartbeat path (a gossip cluster must not lose that
        recovery)."""
        sender = getattr(msg, "sender", None)
        if not isinstance(sender, int) or sender < 0 or not self.active:
            return None
        if sender in self.book:
            inc = getattr(msg, "incarnation", None)
            if inc is not None:
                sup = self._superseded.get(sender)
                if sup is not None and sup[0] == inc:
                    # zombie: the REMEMBERED superseded predecessor of
                    # the id's current holder is gossiping — the hub's
                    # heartbeat path had exactly this guard; tell the
                    # ghost to stand down like the hub did.
                    return [
                        Envelope(
                            f"node:{sender}",
                            cl.Shutdown("superseded", self.epoch),
                            via=sup[1],
                        )
                    ]
                if inc < self._incarnations.get(sender, inc):
                    # BELOW the admitted cluster incarnation: a stale
                    # predecessor we don't remember — not evidence, not
                    # healable. Strictly-below only: the HOLDER's gossip
                    # incarnation legitimately drifts ABOVE its cluster
                    # incarnation with every slander refutation
                    # (GossipState bumps itself past the rumor), and a
                    # `!=` check here once locked a refuted-then-expelled
                    # healthy node out of the heal arm forever.
                    return None
            # a ring member speaking gossip is certainly not negotiated
            # down — clear any stale legacy marking from a predecessor
            self._hub_speakers.discard(sender)
            if sender in self.unreachable:
                # an EXPELLED member is alive and talking to us: the hub
                # flow healed this through resumed heartbeats
                # (_on_heartbeat's re-line path); the ring edition heals
                # it here — without this, a member expelled on a
                # transient freeze could never get back in (its gossip
                # record was dropped with the roster, so no vouch arm
                # can fire for it)
                log.info(
                    "master: expelled node %d is gossiping -> rejoin",
                    sender,
                )
                return self._readmit(sender, self.clock())
            return None
        if isinstance(msg, gsp.Ping) and msg.port > 0:
            via = cl.Endpoint(msg.host, msg.port)
            _SOLICITS.inc()
            return [
                Envelope(
                    f"node:{sender}", cl.Rejoin("unknown-node", self.epoch),
                    via=via,
                ),
                Envelope(
                    f"node:{sender}", st.AdvertSolicit("unknown-node"),
                    via=via,
                ),
            ]
        return None

    def _readmit(self, nid: int, now: float) -> list[Envelope]:
        """ONE definition of re-lining a member whose process turned out
        to be alive (resumed heartbeats, or gossip frames from an
        expelled member): clear the unreachable mark, reset the detector
        history (the outage gap must not poison the inter-arrival
        model), refresh the ring record + admission-grace window, and
        re-run the membership machinery. Three call sites used to
        hand-roll drifting copies of this."""
        self.unreachable.discard(nid)
        self.monitor.detector.remove(nid)
        self.monitor.heartbeat(nid, now)
        self._gossip_roster()
        if self.gossip is not None:
            self.gossip.reset_member(nid, self._incarnations.get(nid, 0))
            self._gossip_admitted[nid] = now
        self._digest_static = None
        return (
            self._broadcast(self._address_book())
            + self.grid.member_up(nid)
            + self._digest_envelopes()
        )

    def _arm_chaos(self) -> None:
        from akka_allreduce_tpu_torch.control.chaos import MASTER_ROLE, ChaosInjector

        self.transport.chaos = ChaosInjector(
            self.config.chaos.seed,
            self.config.chaos.spec,
            role=MASTER_ROLE,
            dims=self.config.master.dimensions,
            # crash:node=m fires for real only in a real OS process (the
            # CLI roles arm this); in-process masters record a suppressed
            # crash, exactly like nodes
            allow_crash=self.allow_crash,
            log_path=self.chaos_log,
        )

    @property
    def active(self) -> bool:
        """Leading right now: a plain master or a standby post-takeover —
        unless a newer epoch fenced us out (a deposed leader must stop
        ANSWERING the cluster protocol too, or it would keep Welcoming
        walking nodes into a dead end while its scheduler is silenced)."""
        return (
            self.standby_of is None or self._took_over
        ) and not self._fenced_out

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> cl.Endpoint:
        ep = await self.transport.start()
        interval = self.config.master.heartbeat_interval_s
        self._poll_task = observed_task(
            run_periodic(interval, self._poll_detector), name="master-detector"
        )
        if self.watchdog is not None:
            self.watchdog.start()  # its own observed_task poll loop
        if self.standby_of is not None:
            # standby replication lease loop: (re-)register with the leader
            # and take over when the digest stream goes silent
            self._standby_task = observed_task(
                run_periodic(interval, self._standby_poll),
                name="standby-lease",
            )
            log.info(
                "standby listening on %s (leader %s)", ep, self.standby_of
            )
        else:
            _EPOCH_GAUGE.set(self.epoch)
            log.info("master listening on %s (epoch %d)", ep, self.epoch)
        if self._gossip_agent is not None:
            self.gossip.host, self.gossip.port = ep.host, ep.port
            self._gossip_agent.start()
        return ep

    async def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self._gossip_agent is not None:
            await self._gossip_agent.stop()
        for attr in ("_poll_task", "_standby_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)
        await self.transport.stop()

    async def run_until_done(self, timeout: float | None = None) -> None:
        """Wait until every line finished ``max_rounds`` (requires
        ``line_master.max_rounds >= 0``); the detector poll loop broadcasts
        ``Shutdown`` to all nodes the moment that happens."""
        await asyncio.wait_for(self._done.wait(), timeout)

    async def shutdown(self, reason: str = "terminated") -> None:
        """End an open-ended run from the outside (SIGTERM in the CLI, the
        chaos runner's --duration mode): broadcast ``Shutdown`` so nodes
        exit cleanly — flushing metrics and chaos logs — then release
        ``run_until_done``. Registered standbys are released too (a
        finished run must not read as a dead leader and trigger a
        takeover)."""
        await self.transport.send_all(
            self._broadcast(cl.Shutdown(reason, self.epoch))
            + self._standby_shutdowns(reason)
        )
        self.shutdown_reason = reason
        self._done.set()

    def _standby_shutdowns(self, reason: str) -> list[Envelope]:
        return [
            Envelope("master", cl.Shutdown(reason, self.epoch), via=ep)
            for ep in self.standby_eps
        ]

    # -- routing helpers -------------------------------------------------------

    def _worker_endpoint(self, worker_id: int) -> cl.Endpoint | None:
        nid = worker_id // self.config.master.dimensions
        return None if nid in self.unreachable else self.book.get(nid)

    def _node_endpoint(self, node_id: int) -> cl.Endpoint | None:
        return None if node_id in self.unreachable else self.book.get(node_id)

    def _node_book_endpoint(self, node_id: int) -> cl.Endpoint | None:
        return self.book.get(node_id)

    def _gossip_endpoint(self, node_id: int) -> cl.Endpoint | None:
        # the master never dials its own ring address; expelled members
        # leave the roster, so probing stops with the membership
        return self.book.get(node_id) if node_id >= 0 else None

    def _broadcast(self, msg: Any) -> list[Envelope]:
        return [
            Envelope(f"node:{nid}", msg)
            for nid in sorted(self.book)
            if nid not in self.unreachable
        ]

    # -- cluster protocol ------------------------------------------------------

    def _on_cluster_msg(self, msg: Any) -> list[Envelope]:
        now = self.clock()
        # failover protocol first: these arms exist in BOTH roles
        if isinstance(msg, cl.StateDigest):
            return self._on_state_digest(msg, now)
        if isinstance(msg, cl.StandbyRegister):
            return self._on_standby_register(msg)
        if isinstance(msg, cl.Shutdown):
            return self._on_peer_shutdown(msg)
        if not self.active:
            # a PASSIVE standby must not answer the cluster protocol:
            # welcoming a join (or feeding the detector) before the lease
            # expires would split the membership between two masters —
            # nodes that walked here early just keep retrying until the
            # takeover makes this process answerable
            return []
        if isinstance(msg, cl.JoinCluster):
            return self._on_join(msg, now) + self._digest_envelopes()
        if isinstance(msg, cl.Heartbeat):
            return self._on_heartbeat(msg, now)
        if isinstance(msg, st.CheckpointAdvert):
            # NO digest piggyback here: adverts arrive in bursts (every
            # holding of every member after one solicit), and the per-tick
            # lease digest already replicates the registry within one
            # heartbeat — per-advert full-state sends would be O(members x
            # holdings) redundant serializations in a single tick
            return self._on_ckpt_advert(msg)
        if isinstance(msg, st.ManifestRequest):
            return self._on_manifest_request(msg)
        if isinstance(msg, cl.LeaveCluster):
            self.monitor.leave(msg.node_id, now)
            out = self.grid.member_unreachable(msg.node_id)
            self.book.pop(msg.node_id, None)
            self.unreachable.discard(msg.node_id)
            self._incarnations.pop(msg.node_id, None)
            self._superseded.pop(msg.node_id, None)
            if self.gossip is not None:
                self.gossip.remove_member(msg.node_id)
                self._hub_speakers.discard(msg.node_id)
                self._gossip_admitted.pop(msg.node_id, None)
            self._digest_static = None  # membership changed
            # a departed process can no longer serve chunks; its manifests
            # stay known (replicas may still hold the bytes)
            self._drop_ckpt_holder(msg.node_id)
            return (
                out
                + self._broadcast(self._address_book())
                + self._digest_envelopes()
            )
        raise TypeError(f"master cannot handle {type(msg).__name__}")

    # -- master HA: digests, standby registration, takeover --------------------

    def _on_standby_register(self, msg: cl.StandbyRegister) -> list[Envelope]:
        if not self.active:
            return []  # standbys do not chain
        ep = cl.Endpoint(msg.host, msg.port)
        out: list[Envelope] = []
        if ep not in self.standby_eps:
            self.standby_eps.append(ep)
            self._digest_static = None  # standby list changed
            log.info("master: standby registered at %s", ep)
            _flight.note(
                "failover", event="standby_register", endpoint=str(ep)
            )
            # nodes already in the cluster learn the standby list via the
            # address-book broadcast (Welcome only covers future joiners)
            out.extend(self._broadcast(self._address_book()))
        # ack with a full digest either way: registration is idempotent,
        # periodically re-sent, and the digest warms a fresh standby NOW
        # instead of at the next state change
        out.extend(self._digest_envelopes(only=ep))
        return out

    def _on_state_digest(
        self, msg: cl.StateDigest, now: float
    ) -> list[Envelope]:
        if self.active:
            if msg.epoch == self.epoch and not (
                msg.host == self.transport.endpoint.host
                and msg.port == self.transport.endpoint.port
            ):
                # two ACTIVE claimants of the SAME epoch (co-promoted from
                # disjoint histories): neither outranks the other, so break
                # the tie deterministically by endpoint — the greater
                # (host, port) yields, the lesser deposes it. Both sides
                # apply the same rule, so exactly one survives.
                me = (self.transport.endpoint.host, self.transport.endpoint.port)
                if me > (msg.host, msg.port):
                    self._stand_down(f"equal-epoch tiebreak vs {msg.host}:{msg.port}")
                    return []
                log.warning(
                    "master epoch %d: deposing equal-epoch co-claimant at "
                    "%s:%d (endpoint tiebreak)",
                    self.epoch, msg.host, msg.port,
                )
                return [
                    Envelope(
                        "master",
                        cl.Shutdown("superseded-epoch", self.epoch),
                        via=cl.Endpoint(msg.host, msg.port),
                    )
                ]
            if msg.epoch < self.epoch:
                # a fenced zombie leader is still replicating to us: tell
                # it to stand down — this closes the split-brain loop (the
                # zombie's own digest stream is what delivers its fencing)
                log.warning(
                    "master epoch %d: fencing zombie leader at %s:%d "
                    "(epoch %d)",
                    self.epoch, msg.host, msg.port, msg.epoch,
                )
                return [
                    Envelope(
                        "master",
                        cl.Shutdown("superseded-epoch", self.epoch),
                        via=cl.Endpoint(msg.host, msg.port),
                    )
                ]
            if msg.epoch > self.epoch:
                # someone with a NEWER epoch is leading: WE are the zombie
                self._stand_down(f"superseded by epoch {msg.epoch}")
            return []
        _DIGESTS_RECEIVED.inc()
        prev = self._last_digest
        if prev is not None and msg.epoch < prev.epoch:
            # an epoch-REGRESSING digest is a not-yet-fenced zombie still
            # replicating: its pre-failover state must not shadow the
            # successor's (a takeover from it would resurrect dead
            # membership and collide with the successor's epoch history)
            return []
        if prev is not None and msg.epoch == prev.epoch and msg.seq <= prev.seq:
            return []  # reordered/duplicate digest: keep the newer state
        if prev is not None and msg.epoch > prev.epoch:
            # a NEW leader identity: its digest cadence must not inherit
            # the dead leader's inter-arrival model
            self._lease.reset()
        self._last_digest = msg
        self._lease.renew(now)
        # follow the leadership: periodic re-registration must go to
        # whoever is digesting us NOW — after a failover the promoted
        # master is the one to re-register with, not the dead seed
        leader = cl.Endpoint(msg.host, msg.port)
        if leader != self.standby_of:
            log.info(
                "standby: following new leader %s (epoch %d)",
                leader, msg.epoch,
            )
            self.standby_of = leader
        return []

    def _on_peer_shutdown(self, msg: cl.Shutdown) -> list[Envelope]:
        if not self.active:
            # the leader ended the run gracefully: release this standby
            # (a finished run must not read as a dead leader)
            log.info("standby released: %s", msg.reason)
            self.shutdown_reason = msg.reason
            self._done.set()
            return []
        if msg.epoch > self.epoch or msg.reason == "superseded-epoch":
            self._stand_down(msg.reason)
        return []

    def _stand_down(self, reason: str) -> None:
        """Fenced out by a newer leadership epoch: stop acting as master.

        The poll loop goes quiet (no more expulsions, re-prepares, round
        restarts or broadcasts) and ``run_until_done`` returns so the CLI
        can exit — a deposed leader must drain, not fight the fence."""
        if self._fenced_out:
            return
        self._fenced_out = True
        self.shutdown_reason = reason
        log.warning("master epoch %d fenced out: %s", self.epoch, reason)
        _flight.note(
            "failover", event="stand_down", epoch=self.epoch, reason=reason
        )
        self._done.set()

    def _digest_state(self) -> str:
        """The compact replicated state a warm standby needs to take over:
        enough to keep scheduling (round counters, config), keep membership
        (book + incarnations), and keep answering ``ManifestRequest`` (the
        peer-checkpoint holder registry). The slow-moving half is rebuilt
        only when a state change invalidated it (``_digest_static``) — the
        per-tick lease heartbeat pays for the round counters and one dump,
        not a config reparse plus the whole manifest registry."""
        if self._digest_static is None:
            static = {
                "config": json.loads(self.config.to_json()),
                "book": [
                    [nid, ep.host, ep.port]
                    for nid, ep in sorted(self.book.items())
                ],
                "incarnations": {
                    str(n): i for n, i in self._incarnations.items()
                },
                "unreachable": sorted(self.unreachable),
                "ckpt": {
                    str(origin): {
                        "manifests": {
                            str(s): m for s, m in rec["manifests"].items()
                        },
                        "holders": {
                            str(n): s for n, s in rec["holders"].items()
                        },
                    }
                    for origin, rec in self._ckpt.items()
                },
                "standbys": [
                    [ep.host, ep.port] for ep in self.standby_eps
                ],
                # per-shard replication (RESILIENCE.md "Scale"): each
                # live line's worker set and the per-worker resume
                # floors change only on reorganization — every
                # reorganization path invalidates this cache, so the
                # static half stays truthful
                "lines": self.grid.lines_static_state(),
                "floors": self.grid.resume_floor_state(),
            }
            if self.gossip is not None:
                # the ring's judgement rides failover too: a promoted
                # standby inherits WHO was suspect/dead mid-incident and
                # which members actually speak gossip, instead of
                # re-learning both from scratch under a fresh epoch
                static["gossip_view"] = self.gossip.digest_state()
                static["hub_speakers"] = sorted(self._hub_speakers)
            # serialized once per state change, held OPEN (trailing `}`
            # stripped) so the per-tick round counters splice in cheaply
            self._digest_static = json.dumps(static)[:-1]
        round_state = {
            "next": max(
                (lm.next_round for lm in self.grid.line_masters.values()),
                default=self.grid.resume_round,
            ),
            # per-shard round counters, one per live line: a promoted
            # standby resumes EVERY shard past its own sequence instead
            # of snapping all of them to the global max
            "shards": self.grid.lines_round_state(),
            "completed": self.grid.total_completed,
            "config_id": self.grid.config_id,
        }
        if self.adapt is not None:
            # the controller's level/dwell/baseline ride the per-tick half:
            # a promoted standby inherits the current policy mid-incident
            # instead of resetting to full fidelity (RESILIENCE.md Tier 5)
            round_state["adapt"] = self.adapt.digest()
        return (
            self._digest_static + ', "round": ' + json.dumps(round_state) + "}"
        )

    def _digest_envelopes(
        self, only: cl.Endpoint | None = None
    ) -> list[Envelope]:
        """StateDigest envelopes for the registered standbys — piggybacked
        after every state-changing event AND once per detector poll (the
        lease heartbeat)."""
        targets = [only] if only is not None else list(self.standby_eps)
        if not self.active or self._fenced_out or not targets:
            return []
        self._digest_seq += 1
        me = self.transport.endpoint
        msg = cl.StateDigest(
            self.epoch, self._digest_seq, me.host, me.port,
            self._digest_state(),
        )
        _DIGESTS_SENT.inc(len(targets))
        return [Envelope("master", msg, via=ep) for ep in targets]

    async def _standby_poll(self) -> None:
        """The standby's lease loop (one tick per heartbeat interval)."""
        if self.active or self._done.is_set():
            return
        now = self.clock()
        if self._last_digest is None or self._register_countdown <= 0:
            # (re-)register: idempotent at the leader, and a RESTARTED
            # leader (fresh process, empty standby list) re-learns us
            self._register_countdown = 5
            me = self.transport.endpoint
            await self.transport.send(
                Envelope(
                    "master",
                    cl.StandbyRegister(me.host, me.port),
                    via=self.standby_of,
                )
            )
        else:
            self._register_countdown -= 1
        if self._lease.expired(now):
            self._takeover(now)

    def _takeover(self, now: float) -> None:
        """The lease expired: become the leader under a bumped epoch.

        Restores the digest's membership, round counters and checkpoint
        registry, adopts the dead leader's config (chaos + retry knobs
        included), and waits for nodes to walk the standby list and
        re-join — each re-join of a known member forces a reorganization,
        so rounds resume once the quorum is back, numbered PAST everything
        the old epoch started. A digest that lagged the leader's death by
        a round is absorbed by the workers' cross-epoch flush floor (a
        re-issued round id is re-asserted, never re-applied)."""
        digest = self._last_digest
        assert digest is not None
        state = json.loads(digest.state_json)
        self.config = AllreduceConfig.from_json(json.dumps(state["config"]))
        # epoch bump, tie-broken by standby RANK in the replicated list:
        # two standbys whose leases expire on the same silence must not
        # both claim the same epoch (an equal-epoch pair could never fence
        # each other). Rank 0 takes +1, rank 1 takes +2, ... — distinct by
        # construction, and the higher-ranked (later-registered) standby's
        # digests depose a lower-ranked co-claimant within one exchange;
        # the equal-epoch arm in _on_state_digest is the defense in depth
        # for claimants from disjoint histories.
        me = self.transport.endpoint
        rank = next(
            (
                i
                for i, (h, p) in enumerate(state["standbys"])
                if cl.Endpoint(h, int(p)) == me
            ),
            0,
        )
        self.epoch = max(self.epoch, digest.epoch) + 1 + rank
        self._took_over = True
        # speak the dead leader's wire dialect: nodes were welcomed with
        # these knobs
        self.transport.wire_f16 = self.config.metadata.wire_dtype == "f16"
        self.transport.retry_policy = self.config.master.retry
        self.transport.configure_data_plane(self.config.data_plane)
        if self.config.chaos.enabled and self.transport.chaos is None:
            self._arm_chaos()
            from akka_allreduce_tpu_torch.control.chaos import MASTER_ROLE

            for f in self.transport.chaos.faults:
                if f.name == "crash" and f.node == MASTER_ROLE:
                    # the leader-kill fault consumed its one shot on the
                    # epoch that died of it: a digest that lagged the death
                    # (round counters below the trigger) must not let the
                    # promoted master arm the same fault and kill itself
                    # mid-failover
                    f.done = True
        fresh_watchdog = None
        if self.watchdog is None and self.config.master.round_deadline_s > 0:
            # the leader ran a round-stall watchdog: the promoted master
            # must keep watching (the standby's placeholder config has no
            # deadline, so none was built at construction)
            from akka_allreduce_tpu_torch.obs.watchdog import RoundWatchdog

            fresh_watchdog = self.watchdog = RoundWatchdog(
                self.config.master.round_deadline_s, clock=self.clock
            )
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass  # driven synchronously (sims/tests): caller owns pacing
        else:
            if fresh_watchdog is not None:
                fresh_watchdog.start()
            # re-pace the detector/reprepare/restart/digest loop at the
            # ADOPTED heartbeat interval — the standby's placeholder
            # cadence may differ from the cluster's
            if self._poll_task is not None:
                self._poll_task.cancel()
            self._poll_task = observed_task(
                run_periodic(
                    self.config.master.heartbeat_interval_s,
                    self._poll_detector,
                ),
                name="master-detector",
            )
        self.book = {
            int(nid): cl.Endpoint(h, int(p)) for nid, h, p in state["book"]
        }
        self._incarnations = {
            int(n): int(i) for n, i in state["incarnations"].items()
        }
        self.unreachable = {int(n) for n in state["unreachable"]}
        self._superseded.clear()
        self._ckpt = {
            int(origin): {
                "manifests": {
                    int(s): m for s, m in rec["manifests"].items()
                },
                "holders": {int(n): int(s) for n, s in rec["holders"].items()},
            }
            for origin, rec in state["ckpt"].items()
        }
        me = self.transport.endpoint
        self.standby_eps = [
            cl.Endpoint(h, int(p))
            for h, p in state["standbys"]
            if cl.Endpoint(h, int(p)) != me
        ]
        self._digest_static = None  # everything above changed
        # the grid continues the dead leader's numbering under the adopted
        # config: organized with the known-live member set, so the first
        # re-join (a "restart" of a known member) drives the reorganize
        # that re-prepares everyone under the new epoch
        rnd = state["round"]
        if self.config.adapt.enabled:
            # inherit the dead leader's controller mid-incident: level,
            # dwell and counter watermarks come from the digest, so the
            # promoted master's first Prepare carries the inherited policy
            # and the hysteresis clock does not reset with the leader
            from akka_allreduce_tpu_torch.control.adapt import AdaptiveController

            self.adapt = AdaptiveController(self.config.adapt, self.config.threshold)
            self.adapt.restore(rnd.get("adapt"))
        self.grid = self._build_grid()  # stamps the bumped epoch + policy
        live = set(self.book) - self.unreachable
        self.grid.nodes = set(live)
        self.grid.organized = bool(live)
        self.grid.resume_round = int(rnd["next"])
        self.grid.config_id = int(rnd["config_id"])
        self.grid._completed_before_reorg = int(rnd["completed"])
        # per-shard resume: the replicated floors + each replicated
        # line's live next round over its worker set — the takeover's
        # first reorganization resumes every shard past ITS OWN
        # high-water (a digest without the fields restores the legacy
        # global-max behavior through resume_round above)
        self.grid.restore_shard_state(
            state.get("floors"), state.get("lines"), rnd.get("shards"),
            fallback_round=int(rnd["next"]),
            fallback_workers=[
                nid * self.config.master.dimensions + d
                for nid in live
                for d in range(self.config.master.dimensions)
            ],
        )
        # seed the detector with the members we expect back: one that
        # never re-joins is expelled by the normal poll path
        for nid in sorted(live):
            self.monitor.heartbeat(nid, now)
        if self.config.gossip.enabled:
            # join the probe ring under the bumped epoch (a fresh leader
            # identity — nodes' record of gossip:-1 updates to the higher
            # incarnation on first contact), inheriting the replicated
            # view and the per-member speaker capability
            self._build_gossip()
            self._gossip_roster()
            self.gossip.restore_state(state.get("gossip_view"))
            self._hub_speakers = {
                int(n) for n in state.get("hub_speakers", [])
            }
            self._gossip_admitted = {nid: now for nid in live}
            me_ep = self.transport.endpoint
            self.gossip.host, self.gossip.port = me_ep.host, me_ep.port
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                pass  # sync-driven sims tick the state machine directly
            else:
                self._gossip_agent.start()
        _EPOCH_GAUGE.set(self.epoch)
        _TAKEOVERS.inc()
        _flight.note(
            "failover",
            event="takeover",
            epoch=self.epoch,
            members=sorted(live),
            resume_round=self.grid.resume_round,
            completed=self.grid._completed_before_reorg,
        )
        log.warning(
            "standby TAKEOVER: epoch %d, %d member(s), resume round %d, "
            "%d completed round(s) carried, %d checkpoint origin(s)",
            self.epoch, len(live), self.grid.resume_round,
            self.grid._completed_before_reorg, len(self._ckpt),
        )
        if self.on_takeover is not None:
            self.on_takeover(self)

    # -- peer checkpoint registry ----------------------------------------------

    #: manifests remembered per origin — enough to fall back past an
    #: owner-only newest step (saved, crashed before replication finished)
    _CKPT_KEEP = 3

    def _on_ckpt_advert(self, msg: st.CheckpointAdvert) -> list[Envelope]:
        rec = self._ckpt.setdefault(msg.origin, {"manifests": {}, "holders": {}})
        if msg.manifest_json:
            manifests = rec["manifests"]
            manifests[msg.step] = msg.manifest_json
            for old in sorted(manifests)[: -self._CKPT_KEEP]:
                manifests.pop(old)
        holders = rec["holders"]
        holders[msg.node_id] = max(holders.get(msg.node_id, -1), msg.step)
        self._digest_static = None  # holder registry changed
        log.info(
            "master: node %d holds checkpoint of node %d at step %d",
            msg.node_id, msg.origin, msg.step,
        )
        return []

    def _on_manifest_request(self, msg: st.ManifestRequest) -> list[Envelope]:
        """Answer with the NEWEST step that has at least one live holder
        other than the requester — not merely the newest step advertised:
        an owner that saved and then crashed before replication finished
        must get its replicas' (slightly older) step back, not an
        unservable newest step and a dead end.

        When NO step has a complete live holder (the owner died mid-
        replication — partial replicas hold chunks but never advertised),
        fall back to SCAVENGE mode: offer the OLDEST remembered manifest
        (its chunks were pushed first, so they are the most likely to have
        landed) with every live member as a candidate — content addressing
        plus the rejoiner's per-chunk ChunkMissing failover reassemble the
        state from whatever partial replicas hold; a chunk that truly
        exists nowhere surfaces as an incomplete restore, not a wedge."""
        rec = self._ckpt.get(msg.node_id)
        reply = st.ManifestReply(-1, "", ())
        if rec is not None and rec["manifests"]:
            for step in sorted(rec["manifests"], reverse=True):
                holders = tuple(
                    sorted(
                        nid
                        for nid, hstep in rec["holders"].items()
                        if hstep >= step
                        and nid != msg.node_id
                        and nid in self.book
                        and nid not in self.unreachable
                    )
                )
                if holders:
                    reply = st.ManifestReply(
                        step, rec["manifests"][step], holders
                    )
                    break
            else:
                candidates = tuple(
                    sorted(
                        nid
                        for nid in self.book
                        if nid != msg.node_id and nid not in self.unreachable
                    )
                )
                if candidates:
                    oldest = min(rec["manifests"])
                    log.info(
                        "master: no complete holder for node %d; offering "
                        "step %d for scavenge from %s",
                        msg.node_id, oldest, candidates,
                    )
                    reply = st.ManifestReply(
                        oldest, rec["manifests"][oldest], candidates
                    )
        out = [Envelope(st.ChunkService.addr(msg.node_id), reply)]
        if reply.step < 0 or not reply.holders:
            # a dead-end answer from a (possibly replacement) master whose
            # holder registry is empty or stale: solicit adverts from every
            # live member so the requester's retry rounds find the state
            # that actually survived (regression-pinned: a restore issued
            # immediately after a master restart must still converge)
            solicit = [
                Envelope(f"node:{nid}", st.AdvertSolicit("manifest-miss"))
                for nid in sorted(self.book)
                if nid != msg.node_id and nid not in self.unreachable
            ]
            if solicit:
                _SOLICITS.inc(len(solicit))
                log.info(
                    "master: no holders for node %d; soliciting adverts "
                    "from %d member(s)", msg.node_id, len(solicit),
                )
            out.extend(solicit)
        return out

    def _drop_ckpt_holder(self, node_id: int) -> None:
        """``node_id``'s process is gone (leave, or restart with a new
        incarnation): whatever its old process advertised holding is no
        longer servable — and after a disk loss may not even exist. Its
        next adverts rebuild the truth from what actually survived."""
        for rec in self._ckpt.values():
            rec["holders"].pop(node_id, None)
        self._digest_static = None  # holder registry changed

    def _on_join(self, msg: cl.JoinCluster, now: float) -> list[Envelope]:
        nid = msg.preferred_node_id
        ep = cl.Endpoint(msg.host, msg.port)
        # A join retry must resolve to the id assigned on the FIRST attempt,
        # even with auto-assigned ids (preferred -1): match by incarnation +
        # endpoint before minting a fresh id, or the retry would admit the
        # same process as a ghost second member
        for known_nid, inc in self._incarnations.items():
            if inc == msg.incarnation and self.book.get(known_nid) == ep:
                nid = known_nid
                break
        else:
            # a preferred id may be reclaimed from a NEW endpoint when its
            # previous holder is dead (crashed on another port) — only a
            # LIVE member's identity is protected from takeover
            taken = (
                nid in self.book
                and self.book[nid] != ep
                and nid in self.grid.nodes
            )
            if nid < 0 or taken:
                # an endpoint hosts at most one node process, so a fresh
                # incarnation from a booked endpoint is that node reborn —
                # reclaim its id; otherwise mint the next one
                reborn = next(
                    (k for k, v in self.book.items() if v == ep), None
                )
                nid = (
                    reborn
                    if reborn is not None
                    else max(self.book, default=-1) + 1
                )
        # Welcome goes straight to the joiner's endpoint (``via``): it doesn't
        # know its node id yet, so it can't be in any route table.
        welcome = Envelope(
            "client",
            cl.Welcome(
                nid, self.config.to_json(), self.epoch, self._standby_tuple()
            ),
            via=ep,
        )
        if (
            self._incarnations.get(nid) == msg.incarnation
            and nid in self.grid.nodes
        ):
            # join RETRY from a node we already admitted: its Welcome was
            # lost in flight — re-send it, change no membership state
            self.monitor.heartbeat(nid, now)
            return [welcome]
        restarted = nid in self.grid.nodes
        # a NEW incarnation under this id is a new process: anything the old
        # process claimed to hold may have died with it (or its disk) — its
        # own fresh adverts will restore the holder map from what survived
        self._drop_ckpt_holder(nid)
        prev_inc = self._incarnations.get(nid)
        prev_ep = self.book.get(nid)
        if prev_inc is not None and prev_ep is not None and prev_ep != ep:
            # id reclaimed from a different endpoint: remember the superseded
            # process so a late heartbeat from it gets a Shutdown reply
            self._superseded[nid] = (prev_inc, prev_ep)
        self.book[nid] = ep
        self._incarnations[nid] = msg.incarnation
        self.unreachable.discard(nid)
        self._digest_static = None  # membership changed
        # a new incarnation is a new process: its predecessor's inter-arrival
        # history (and the death gap since) must not poison the detector —
        # this covers the fast same-endpoint restart where the monitor state
        # is still UP and HeartbeatMonitor's own reset branch would not run
        self.monitor.detector.remove(nid)
        self.monitor.heartbeat(nid, now)
        if self.gossip is not None:
            # the probe ring adopts the admission: fresh ALIVE record at
            # the cluster incarnation (a predecessor's DEAD record must
            # not shadow the process the master just vouched for), and a
            # fresh grace window against rumors that predate it
            self._gossip_roster()
            self.gossip.reset_member(nid, msg.incarnation)
            self._gossip_admitted[nid] = now
            self._hub_speakers.discard(nid)  # re-learned per process
        log.info("master: node %d joined from %s:%d", nid, msg.host, msg.port)
        out = [welcome]
        out.extend(self._broadcast(self._address_book()))
        if restarted:
            # same identity re-joining before the detector noticed the crash:
            # its workers are fresh and unconfigured, so member_up's no-op is
            # wrong — force the Prepare/Confirm handshake for everyone
            log.info("master: node %d restarted -> reorganize", nid)
            out.extend(self.grid.reorganize())
        else:
            out.extend(self.grid.member_up(nid))
        return out

    def _on_heartbeat(self, msg: cl.Heartbeat, now: float) -> list[Envelope]:
        node_id, incarnation = msg.node_id, msg.incarnation
        if node_id not in self.book:
            # A heartbeat from a node this master has never admitted: either a
            # stale beat from an expelled node, or — the dangerous case — this
            # is a REPLACEMENT master (restarted on the seed endpoint, empty
            # book) and the sender is a healthy member of its predecessor.
            # Its sends all succeed, so the node's failure counter never
            # trips; without a reply it heartbeats into the void forever.
            # Tell it to re-run the join handshake at its advertised
            # endpoint — and solicit its checkpoint adverts NOW, so a
            # replacement master's empty holder registry repopulates
            # before the first restore asks for it (not only after the
            # full rejoin lands).
            if msg.port > 0:
                via = cl.Endpoint(msg.host, msg.port)
                _SOLICITS.inc()
                return [
                    Envelope(
                        f"node:{node_id}",
                        cl.Rejoin("unknown-node", self.epoch),
                        via=via,
                    ),
                    Envelope(
                        f"node:{node_id}",
                        st.AdvertSolicit("unknown-node"),
                        via=via,
                    ),
                ]
            return []
        if self._incarnations.get(node_id) != incarnation:
            # zombie: a partitioned process whose id was reclaimed by a newer
            # joiner — its stale heartbeats must not alias the current
            # holder's liveness. Tell it to stand down rather than letting it
            # run (and heartbeat) orphaned forever.
            sup = self._superseded.get(node_id)
            if sup is not None and sup[0] == incarnation:
                return [
                    Envelope(
                        f"node:{node_id}",
                        cl.Shutdown("superseded", self.epoch),
                        via=sup[1],
                    )
                ]
            return []
        if self.gossip is not None:
            # a member hub-heartbeating under a gossip-enabled config
            # negotiated down (legacy binary): the phi detector keeps
            # owning its liveness, and the ring's inevitable slander of
            # the never-acking member is ignored (_consume_gossip)
            self._hub_speakers.add(node_id)
        event = self.monitor.heartbeat(node_id, now)
        if event is not None and node_id not in self.grid.nodes:
            # silence marked it unreachable but the process lives: rejoin it
            log.info("master: node %d heartbeat resumed -> rejoin", node_id)
            return self._readmit(node_id, now)
        return []

    def _on_round_complete(
        self, line_id: int, r: int, latency_s: float, done: int, n: int
    ) -> None:
        """Per-round observability (SURVEY.md §6): one JSONL record per
        completed line-round — latency, contributors at threshold, config —
        the watchdog's completion signal (retires the round's deadline),
        and one tick of straggler evidence into the AdaptiveController
        (RESILIENCE.md "Tier 5"): the master gathers the grid's lag map
        and the registry counters here and hands them in, so the
        controller stays a pure, replayable state machine."""
        if self.watchdog is not None:
            self.watchdog.round_completed(line_id, r)
        if self.adapt is not None and self.active:
            # the O(lines x workers) lag merge + counter snapshot are only
            # read on the window-boundary call: skip the gather otherwise
            if self.adapt.deciding_next:
                lags = self.grid.worker_lags()
                counters = {
                    "restarts": _EV_RESTARTS.value,
                    "reconnects": _EV_RECONNECTS.value,
                    "drops": _EV_DROPS.value,
                    "reorgs": _EV_REORGS.value,
                }
                bandwidth = self._gather_bandwidth()
            else:
                lags, counters, bandwidth = {}, {}, None
            pol = self.adapt.observe_round(
                r, lags, counters, latency_s=latency_s, bandwidth=bandwidth
            )
            if pol is not None:
                # rounds started from now on (this very completion's
                # window refill included) carry the new stamp; the level
                # rides the digest's per-tick round state, so the standby
                # learns it within one lease heartbeat
                self.grid.set_policy(pol)
                if self.metrics is not None and self.adapt.last_decision:
                    self.metrics.log_event(kind="adapt", **self.adapt.last_decision)
        if self.metrics is not None:
            self.metrics.log_event(
                kind="round",
                line=line_id,
                round=r,
                latency_s=round(latency_s, 6),
                completions=done,
                workers=n,
                config=self.grid.config_id,
                data_bytes=self.config.metadata.data_size * 4,
            )

    def _forget_endpoint_rows(self, node_id: int) -> None:
        """Membership just expelled ``node_id``: evict its per-endpoint
        transport telemetry rows (tx/rx/stream/reconnect gauges are
        otherwise cumulative forever — a dead peer's frozen row would
        pollute every later snapshot, and the adaptive controller's
        bandwidth arm would read it). A re-joining process regrows rows
        from zero."""
        ep = self.book.get(node_id)
        if ep is not None:
            self.transport.forget_endpoint(ep)

    def _gather_bandwidth(self) -> dict[str, float] | None:
        """Per-endpoint cumulative tx+rx bytes from the transport's gauges,
        as visible to this process (in-process transports all report
        through the shared registry collector): the bandwidth evidence
        arm's input, gathered only on window-boundary calls. None when the
        arm is disabled (skips the collector sweep)."""
        if self.adapt is None or self.adapt.config.bw_degrade_ratio <= 0:
            return None
        prefix = "transport.endpoint."
        out: dict[str, float] = {}
        for key, value in _metrics.REGISTRY.snapshot().items():
            if not key.startswith(prefix):
                continue
            endpoint, _, field = key[len(prefix):].rpartition(".")
            if field in ("tx_bytes", "rx_bytes") and endpoint:
                out[endpoint] = out.get(endpoint, 0.0) + float(value)
        return out

    def _standby_tuple(self) -> tuple[tuple[str, int], ...]:
        return tuple((ep.host, ep.port) for ep in self.standby_eps)

    def _address_book(self) -> cl.AddressBook:
        return cl.AddressBook(
            tuple(
                (nid, ep.host, ep.port)
                for nid, ep in sorted(self.book.items())
                if nid not in self.unreachable
            ),
            self.epoch,
            self._standby_tuple(),
        )

    async def _poll_detector(self) -> None:
        if not self.active or self._fenced_out:
            return  # passive standby / deposed leader: no scheduling
        now = self.clock()
        out: list[Envelope] = []
        expelled = False
        if self.gossip is not None:
            out2, expelled2 = self._consume_gossip(now)
            out.extend(out2)
            expelled = expelled or expelled2
        for event in self.monitor.poll(now):
            if event.state is MemberState.UNREACHABLE:
                log.info(
                    "master: node %d unreachable (phi=%.1f)",
                    event.node_id,
                    event.phi,
                )
                out.extend(self.grid.member_unreachable(event.node_id))
                # stop dialing and advertising the silent endpoint, but keep
                # its book entry + detector state: if the process is alive and
                # heartbeats resume, _on_heartbeat re-lines it without a new
                # JoinCluster; a genuine restart re-joins explicitly.
                self.unreachable.add(event.node_id)
                self._forget_endpoint_rows(event.node_id)
                self._digest_static = None  # membership changed
                expelled = True
        if expelled:
            out.extend(self._broadcast(self._address_book()))
        # at-most-once delivery can eat a Prepare (e.g. into a connection
        # whose peer just restarted): re-send to unconfirmed workers. The
        # same discipline covers Start/Complete loss: an in-flight round
        # with no completion progress for several intervals is re-Started
        # at the workers that never reported (idempotent on every path —
        # under sustained loss a bounded round window wedges without this)
        interval = self.config.master.heartbeat_interval_s
        for lm in self.grid.line_masters.values():
            out.extend(lm.reprepare_pending(2.0 * interval))
            out.extend(lm.restart_stalled(5.0 * interval))
        # the digest doubles as the leader's lease heartbeat: one per poll
        # tick keeps the standby's phi detector renewed even when no state
        # changed
        out.extend(self._digest_envelopes())
        if out:
            await self.transport.send_all(out)
        if self.grid.is_done and not self._done.is_set():
            self._done.set()
            await self.transport.send_all(
                self._broadcast(cl.Shutdown("done", self.epoch))
                + self._standby_shutdowns("done")
            )

    def _consume_gossip(self, now: float) -> tuple[list[Envelope], bool]:
        """One subscriber pass over the gossip view (RESILIENCE.md
        "Tier 6"): mirror ALIVE/SUSPECT members into the phi monitor (a
        suspect is innocent until the suspicion times out — the hub's
        clock must never front-run the ring's verdict), then act on the
        edge events: a CONFIRMED death drives the exact
        ``member_unreachable`` path a phi expulsion always drove."""
        assert self.gossip is not None
        out: list[Envelope] = []
        expelled = False
        window = self.config.gossip.suspicion_window_s
        for nid in self.gossip.alive_or_suspect():
            if (
                nid not in self._hub_speakers
                and nid in self.book
                and nid not in self.unreachable
            ):
                event = self.monitor.heartbeat(nid, now)
                if event is not None and nid not in self.grid.nodes:
                    # the ring vouches for a member the grid dropped (a
                    # refutation landed after a phi expulsion): re-line it,
                    # exactly like the hub's heartbeat-resume path
                    log.info(
                        "master: gossip vouches node %d alive -> rejoin", nid
                    )
                    out.extend(self._readmit(nid, now))
        for gev in self.gossip.poll_events():
            nid = gev.node_id
            if nid < 0 or gev.status != gsp.DEAD:
                continue
            if self.gossip.status_of(nid) != gsp.DEAD:
                # a refutation (or direct frame) flipped the record back
                # between the confirm and this poll: the queued verdict
                # is already stale — acting on it would expel a node the
                # ring no longer believes dead, and under the asymmetric
                # partition no direct frame could ever heal it back
                continue
            if nid in self._hub_speakers:
                continue  # negotiated-down legacy member: the phi hub owns it
            if nid not in self.book or nid in self.unreachable:
                continue
            admitted = self._gossip_admitted.get(nid)
            if admitted is not None and now - admitted < window + \
                    self.config.gossip.probe_interval_s:
                # stale slander: this verdict's suspicion predates (or
                # straddles) the member's latest admission — shield the
                # fresh process and outrank the rumor so it dies out
                _GOSSIP_SHIELDED.inc()
                self.gossip.reset_member(nid, gev.incarnation + 1)
                continue
            log.info(
                "master: node %d confirmed dead by gossip (incarnation %d)",
                nid, gev.incarnation,
            )
            _GOSSIP_EXPULSIONS.inc()
            self.monitor.force_unreachable(nid, now)
            out.extend(self.grid.member_unreachable(nid))
            self.unreachable.add(nid)
            self._forget_endpoint_rows(nid)
            self._gossip_roster()
            self._digest_static = None
            expelled = True
        return out, expelled

    @property
    def rounds_completed(self) -> int:
        """Line-rounds completed across ALL configurations, not just the
        current one (re-organization replaces the line masters)."""
        return self.grid.total_completed


_incarnation_counter = itertools.count(1)


def _new_incarnation() -> int:
    """Unique per NodeProcess lifetime across processes on one host."""
    return (os.getpid() << 20) | (next(_incarnation_counter) & 0xFFFFF)


class NodeProcess:
    """Worker-node role: joins the seed, hosts one worker per dimension."""

    def __init__(
        self,
        seed: cl.Endpoint,
        data_source: DataSource,
        data_sink: DataSink,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        preferred_node_id: int = -1,
        join_retry_s: float = 0.5,
        allow_crash: bool = False,
        chaos_log: str | None = None,
        state_dir: str | None = None,
        replicas: int = 2,
        device=None,  # str | torch.device | None: the card unless "cpu"
    ) -> None:
        self.seed = seed
        # the round buffers' and the transport's device, resolved once so
        # a node that cannot reach the card fails here, not mid-round
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # create the CUDA context now, before the node joins: its first
            # use inside a handler would stall the event loop, and with it
            # the heartbeats, for seconds
            torch.zeros(1, device=self.device)
        self.data_source = data_source
        self.data_sink = data_sink
        self.preferred_node_id = preferred_node_id
        self.join_retry_s = join_retry_s
        # peer state transfer (statetransfer.py): when set, this node hosts
        # a chunk service over the delta-store directory, replicates its
        # saves to `replicas` peers, and can restore from peers on rejoin
        self.state_dir = state_dir
        self.replicas = replicas
        self.state: st.ChunkService | None = None
        self._chunk_store: st.ChunkStore | None = (
            st.ChunkStore(state_dir) if state_dir else None
        )
        # EVERY live replication task, not a single slot: a later save's
        # (insta-skipping) task must not shadow a still-running one at
        # stop() — all of them get cancelled at teardown
        self._replicate_tasks: set[asyncio.Task] = set()
        # chaos plumbing: the spec itself arrives with Welcome (one master
        # flag arms the cluster); allow_crash gates the `crash` fault to
        # real subprocesses (the CLI role sets it: an in-process harness
        # must record a suppressed crash, not end the process)
        self.allow_crash = allow_crash
        self.chaos_log = chaos_log
        self._chaos_t0: float | None = None
        self.incarnation = _new_incarnation()
        self.node_id: int | None = None
        self.node: AllreduceNode | None = None
        self.config: AllreduceConfig | None = None
        self.book = cl.AddressBook(())
        self._endpoints: dict[int, cl.Endpoint] = {}
        self.transport = RemoteTransport(host, port, device=self.device)
        self.transport.set_route("master", seed)
        self.transport.set_prefix_route("line_master", lambda _lid: seed)
        self.transport.set_prefix_route("worker", self._peer_endpoint)
        # lambda, not a bound .get: the AddressBook handler REASSIGNS
        # self._endpoints wholesale on every membership change
        self.transport.set_prefix_route(
            "ckpt", lambda nid: self._endpoints.get(nid)
        )
        self.transport.set_prefix_route("gossip", self._gossip_peer_endpoint)
        # SWIM gossip membership (control/gossip.py): built at Welcome
        # when the config arms it — this node then probes peers instead
        # of heartbeating into the master's phi hub
        self.gossip: gsp.GossipState | None = None
        self._gossip_agent: gsp.GossipAgent | None = None
        self._heartbeat_task: asyncio.Task | None = None
        self._join_task: asyncio.Task | None = None
        self._welcomed = asyncio.Event()
        self._shutdown = asyncio.Event()
        self.shutdown_reason: str | None = None
        # master-loss detection: consecutive failed sends to the master seed.
        # The reference restarts its seed JVM and workers re-join via Akka
        # Cluster; here the node notices its heartbeats bouncing and re-runs
        # the join handshake against whatever master now owns the endpoint —
        # or, with a standby list distributed via Welcome/AddressBook, WALKS
        # that list and re-joins the promoted leader (master HA,
        # RESILIENCE.md "Tier 4").
        self._master_send_failures = 0
        self._rejoining = False
        self._left = False  # graceful leave announced; never rejoin after
        self._rejoin_task: asyncio.Task | None = None
        self.rejoin_after_failures = 3
        # leadership-epoch fencing watermark: set by the Welcome that
        # admitted us; anything a master of an OLDER epoch sends afterwards
        # is dropped (split-brain prevention)
        self.master_epoch = -1
        self.standbys: list[cl.Endpoint] = []
        # joins sent per candidate endpoint before walking to the next
        self.failover_walk_attempts = 3
        self.transport.on_send_error = self._on_send_error
        self.transport.on_send_ok = self._on_send_ok
        # workload-resilience seam (RESILIENCE.md "Tier 7"): the trainer
        # loop riding this node can FOLLOW the cluster — on_members fires
        # with the AddressBook's live node ids after every membership
        # change (event-loop context: keep it a cheap cell swap), and
        # policy_wire() reads the newest RoundPolicy wire stamp the
        # workers observed, so one leader controller can drive the
        # trainer's ICI compression too
        self.on_members: Callable[[tuple[int, ...]], None] | None = None
        # the carried policy-wire observation: workers are rebuilt on
        # every re-Welcome (fresh last_policy), but the leader's ladder
        # level did not change just because WE re-joined — the last
        # observed stamp bridges the gap until the new epoch's first
        # Start re-stamps it (otherwise every re-mesh would flap the
        # trainer to full fidelity and back, two spurious re-jits)
        self._policy_wire = ""

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> None:
        ep = await self.transport.start()
        self.transport.register(
            "client", lambda msg: self._on_cluster_msg(msg)
        )
        # The joiner owns the handshake retry (Akka Cluster joins the same
        # way): re-send JoinCluster until Welcomed — the Welcome can vanish
        # into a connection whose peer only just noticed we restarted.
        join = cl.JoinCluster(
            ep.host, ep.port, self.preferred_node_id, self.incarnation
        )

        async def join_until_welcomed() -> None:
            while not self._welcomed.is_set():
                await self.transport.send(Envelope("master", join))
                await asyncio.sleep(self.join_retry_s)

        self._join_task = observed_task(join_until_welcomed(), name="node-join")

    async def wait_welcomed(self, timeout: float = 10.0) -> int:
        await asyncio.wait_for(self._welcomed.wait(), timeout)
        assert self.node_id is not None
        return self.node_id

    async def run_until_shutdown(self, timeout: float | None = None) -> str:
        await asyncio.wait_for(self._shutdown.wait(), timeout)
        return self.shutdown_reason or "done"

    async def leave(self) -> None:
        """Graceful departure (the reference's Cluster leave)."""
        # Stop heartbeating BEFORE announcing the leave, and latch _left so a
        # master reply to an already-in-flight heartbeat (Rejoin from a
        # replacement that no longer knows us) cannot drag this node back
        # into the cluster on its way out.
        self._left = True
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            self._heartbeat_task = None
        if self._gossip_agent is not None:
            # stop probing (and answering) on the way out: lingering acks
            # from a leaver would keep vouching for a dead membership
            self._gossip_agent.cancel()
        if self.node_id is not None:
            await self.transport.send(
                Envelope("master", cl.LeaveCluster(self.node_id))
            )

    async def stop(self) -> None:
        if self._gossip_agent is not None:
            await self._gossip_agent.stop()
        for attr in ("_heartbeat_task", "_join_task", "_rejoin_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)
        for task in list(self._replicate_tasks):
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._replicate_tasks.clear()
        await self.transport.stop()

    # -- routing helpers -------------------------------------------------------

    def _peer_endpoint(self, worker_id: int) -> cl.Endpoint | None:
        if self.config is None:
            return None
        # dict lookup: this resolver runs per outgoing chunk on the data path
        return self._endpoints.get(worker_id // self.config.master.dimensions)

    def policy_wire(self) -> str:
        """The newest RoundPolicy wire stamp this node's workers observed
        ("" until any Start arrived, or when the leader runs full
        fidelity). Survives worker rebuilds (re-Welcome / rejoin): the
        carried value answers until the new epoch's first Start. Reads +
        one reference write, GIL-atomic — safe to poll from a learner
        thread (train/cluster.py's compress-follows-policy loop)."""
        if self.node is not None and self.node.workers:
            w = max(
                self.node.workers.values(),
                key=lambda w: w.last_policy_round,
            )
            if w.last_policy_round >= 0:
                self._policy_wire = w.last_policy.wire
        return self._policy_wire

    def _gossip_peer_endpoint(self, node_id: int) -> cl.Endpoint | None:
        if node_id < 0:
            # the master's ring address follows the leader this node
            # believes in (self.seed is repointed by the failover walk)
            return self.seed
        return self._endpoints.get(node_id)

    # -- cluster protocol ------------------------------------------------------

    #: master-bound destinations for the loss-detection counter (the
    #: gossip ring's master address fails exactly when the master does)
    _MASTER_DESTS = ("master", gsp.gossip_addr(gsp.MASTER_ID))

    def _on_send_ok(self, ep: cl.Endpoint, env: Envelope) -> None:
        # rejoin triggers on CONSECUTIVE master-send failures: a transient
        # blip must not accumulate forever toward a spurious cluster-wide
        # rejoin (the master rarely sends anything back in steady state, so
        # resetting only on inbound traffic would never clear the counter)
        if env.dest in self._MASTER_DESTS:
            self._master_send_failures = 0

    def _on_send_error(self, ep: cl.Endpoint, env: Envelope) -> None:
        if self.state is not None:
            # a lost replication push must be re-pushed next round, not
            # dedup-skipped forever (statetransfer.note_send_failure)
            self.state.note_send_failure(env)
        if (
            env.dest not in self._MASTER_DESTS
            or not self._welcomed.is_set()
            or self._left
        ):
            return
        self._master_send_failures += 1
        if self.gossip is not None:
            # decentralized membership: our own failed sends are ONE
            # vantage point — the master may be fine behind a bad direct
            # link (indirect probes still vouch for it). The walk is
            # triggered by the ring's CONFIRMED verdict on gossip:-1
            # (_on_gossip_events), never by direct loss alone.
            return
        if (
            self._master_send_failures >= self.rejoin_after_failures
            and not self._rejoining
        ):
            self._rejoining = True
            log.info(
                "node %s: master unreachable (%d failed sends) -> re-join",
                self.node_id,
                self._master_send_failures,
            )
            self._rejoin_task = observed_task(
                self._rejoin_master(), name="node-rejoin"
            )

    def _point_master(self, ep: cl.Endpoint) -> None:
        """Route all master-bound traffic (joins, heartbeats, line-master
        confirms/completions, manifest requests) at ``ep`` — the whole
        control-plane conversation follows the leader we believe in."""
        self.seed = ep
        self.transport.set_route("master", ep)
        self.transport.set_prefix_route(
            "line_master", lambda _lid, _ep=ep: _ep
        )

    async def _rejoin_master(self) -> None:
        """The master endpoint stopped answering: run the join handshake
        again (keeping our preferred id) against whatever owns the endpoint
        — and when THAT keeps going unanswered, walk the standby list the
        leader distributed via Welcome/AddressBook (master-HA failover:
        the promoted standby answers once its lease on the dead leader
        expires; until then it ignores joins, so the walk just cycles).

        A rejoin wipes this node's worker state, so it presents a NEW
        incarnation: a replacement master welcomes it normally, and a master
        that was merely unreachable for a moment treats it as a restart and
        re-runs the Prepare handshake — either way the fresh workers get
        configured instead of silently wedging.
        """
        try:
            if self._heartbeat_task is not None:
                self._heartbeat_task.cancel()
                self._heartbeat_task = None
            if self._join_task is not None:
                # the ORIGINAL join task retries until _welcomed is set and
                # may still be sleeping off its first retry interval:
                # clearing _welcomed below would resurrect it, and its join
                # carries the STALE incarnation — the master could admit
                # that ghost identity first and drop the bumped
                # incarnation's heartbeats as a zombie's until this loop's
                # join lands (race found by the chaos partition test)
                self._join_task.cancel()
                self._join_task = None
            self._welcomed.clear()
            self.incarnation = _new_incarnation()
            join = cl.JoinCluster(
                self.transport.endpoint.host,
                self.transport.endpoint.port,
                self.node_id if self.node_id is not None else -1,
                self.incarnation,
            )
            candidates = [self.seed] + [
                s for s in self.standbys if s != self.seed
            ]
            lap = 0
            while not self._welcomed.is_set() and not self._shutdown.is_set():
                target = candidates[lap % len(candidates)]
                if lap > 0 and len(candidates) > 1:
                    _WALKS.inc()
                    _flight.note(
                        "failover", event="walk", node=self.node_id,
                        endpoint=str(target),
                    )
                    log.info(
                        "node %s: walking to candidate master %s",
                        self.node_id, target,
                    )
                self._point_master(target)
                for _ in range(max(1, self.failover_walk_attempts)):
                    if self._welcomed.is_set() or self._shutdown.is_set():
                        break
                    await self.transport.send(Envelope("master", join))
                    await asyncio.sleep(self.join_retry_s)
                lap += 1
        finally:
            self._rejoining = False
            self._master_send_failures = 0

    def _fenced(self, msg: Any) -> bool:
        """True when ``msg`` carries a leadership epoch OLDER than the one
        that welcomed us — a zombie deposed master still sending after a
        failover. The fence is the split-brain guarantee: whatever the old
        leader still believes, its round triggers, address books and
        shutdowns no longer move this node (RESILIENCE.md "Tier 4")."""
        epoch = getattr(msg, "epoch", None)
        if isinstance(epoch, int) and 0 <= epoch < self.master_epoch:
            _FENCED.inc()
            _flight.note(
                "failover", event="fenced", node=self.node_id,
                msg=type(msg).__name__, epoch=epoch,
                current=self.master_epoch,
            )
            log.info(
                "node %s: fenced stale-epoch %d %s (current epoch %d)",
                self.node_id, epoch, type(msg).__name__, self.master_epoch,
            )
            return True
        return False

    def _on_cluster_msg(self, msg: Any) -> list[Envelope]:
        # Welcome is EXEMPT from the fence: a node actively (re)joining has
        # abandoned its cluster state and follows WHOEVER admits it — an
        # operator-restarted replacement master legitimately starts at
        # epoch 1 again, and strict ratcheting would fence it out forever
        # once any failover had happened. A zombie that admits a walking
        # node is only a transient capture: it is stood down through its
        # own digest stream, the node's sends fail again, and the next walk
        # lands at the live leader. A node that is already settled ignores
        # stray Welcomes via the _welcomed guard below.
        if isinstance(msg, cl.Welcome):
            self._master_send_failures = 0
            return self._on_welcome(msg)
        if self._fenced(msg):
            return []  # a zombie master talking must not reset anything
        self._master_send_failures = 0  # the master is talking to us
        if isinstance(msg, cl.AddressBook):
            self.book = msg
            prev = self._endpoints
            self._endpoints = {
                nid: cl.Endpoint(host, port) for nid, host, port in msg.entries
            }
            # a peer the membership dropped (expulsion or leave) takes its
            # per-endpoint transport telemetry rows with it — cumulative
            # gauges must not carry dead peers forever (the master does
            # the same at its expulsion sites)
            live = set(self._endpoints.values())
            for ep in set(prev.values()) - live:
                self.transport.forget_endpoint(ep)
            # a standby registering mid-run reaches us here (Welcome only
            # covers the join); the walk order follows the leader's list
            self.standbys = [
                cl.Endpoint(h, p) for h, p in msg.standbys
            ]
            if self.gossip is not None:
                # the book is the authoritative roster: expelled members
                # leave the ring, admitted ones get fresh ALIVE records
                self.gossip.set_members(
                    set(self._endpoints) | {gsp.MASTER_ID}
                )
            if self.on_members is not None:
                self.on_members(msg.node_ids())
            return []
        if isinstance(msg, st.AdvertSolicit):
            # a (replacement) master wants to know what this disk holds —
            # re-advertise everything without waiting for a full rejoin
            return self._advert_envelopes()
        if isinstance(msg, cl.Shutdown):
            self.shutdown_reason = msg.reason
            self._shutdown.set()
            return []
        if isinstance(msg, cl.Rejoin):
            # the master does not recognize us (replacement master on the
            # seed endpoint): run the join handshake again, fresh incarnation
            # — unless we are the reason it doesn't know us (graceful leave)
            if self._welcomed.is_set() and not self._rejoining and not self._left:
                log.info(
                    "node %s: master replied Rejoin(%s) -> re-join",
                    self.node_id,
                    msg.reason,
                )
                self._rejoining = True
                self._rejoin_task = observed_task(
                    self._rejoin_master(), name="node-rejoin"
                )
            return []
        raise TypeError(f"node cannot handle {type(msg).__name__}")

    def _on_welcome(self, msg: cl.Welcome) -> list[Envelope]:
        if self._welcomed.is_set():
            return []  # duplicate Welcome from a join retry race
        if self._heartbeat_task is not None:  # re-welcome after master loss
            self._heartbeat_task.cancel()
            self._heartbeat_task = None
        # the fencing watermark tracks the CURRENT leader (not a max over
        # history): fencing protects a SETTLED node from masters older
        # than the one it follows — a fresh admission re-bases it, so an
        # epoch-1 replacement after a crashed epoch-2 leader still works
        prev_epoch = self.master_epoch
        self.master_epoch = msg.epoch
        self.standbys = [cl.Endpoint(h, p) for h, p in msg.standbys]
        self.config = AllreduceConfig.from_json(msg.config_json)
        # the wire-compression knob arrives with the config, like every
        # other knob: payloads we send from now on ride at the configured
        # width (decode is stateless — the flag travels per frame)
        self.transport.wire_f16 = self.config.metadata.wire_dtype == "f16"
        self.transport.retry_policy = self.config.master.retry
        # the data-plane knobs arrive the same way: connections made
        # BEFORE Welcome (the join itself) were legacy stream-0 links and
        # stay valid; new payload senders stripe (and split, and schedule)
        # from here on
        self.transport.configure_data_plane(self.config.data_plane)
        self.node_id = msg.node_id
        dims = self.config.master.dimensions
        if self.config.chaos.enabled:
            from akka_allreduce_tpu_torch.control.chaos import ChaosInjector

            # anchor the fault timeline once per process: a rejoin rebuilds
            # the injector (the role may even change with the assigned id)
            # but must not restart partition/stall windows from zero
            if self._chaos_t0 is None:
                self._chaos_t0 = time.monotonic()
            prev = self.transport.chaos
            if (
                prev is not None
                and prev.seed == self.config.chaos.seed
                and prev.spec == self.config.chaos.spec
                and prev.role == msg.node_id
            ):
                pass  # re-welcome under the same identity: keep the injector
            else:
                inj = ChaosInjector(
                    self.config.chaos.seed,
                    self.config.chaos.spec,
                    role=msg.node_id,
                    dims=dims,
                    t0=self._chaos_t0,
                    allow_crash=self.allow_crash,
                    log_path=self.chaos_log,
                )
                if prev is not None:
                    # a rejoin (or id change) rebuilds the decision streams,
                    # but the process's event history must survive: the
                    # exit-time log write reports the whole run, not just
                    # the last membership epoch
                    inj.events = list(prev.events) + inj.events
                self.transport.chaos = inj
        self.node = AllreduceNode(
            msg.node_id,
            dims,
            self.data_source,
            self.data_sink,
            self.config.metadata,
            self.config.threshold,
            self.config.worker,
            # cross-epoch round dedup: the rounds the PREVIOUS instance's
            # workers already flushed stay flushed — a SUCCESSOR epoch
            # re-issuing one of those round ids (stale digest) gets a
            # CompleteAllreduce re-assert, never a second application.
            # Carried ONLY when the welcoming epoch is strictly newer: a
            # promoted standby continues the dead leader's numbering (the
            # overlap is real), but a from-scratch replacement master
            # (equal or lower epoch) legitimately RE-NUMBERS from 0 — a
            # carried floor there would turn this node into a silent
            # yes-asserter for thousands of rounds it never ran. Within
            # one live master's lineage round numbers never regress, so
            # dropping the floor on an equal-epoch re-welcome is safe.
            flush_floors=(
                self.node.flush_floors()
                if self.node is not None and msg.epoch > prev_epoch
                else None
            ),
            device=self.device,
        )
        for dim in range(dims):
            wid = msg.node_id * dims + dim
            self.transport.register(
                f"worker:{wid}",
                # worker traffic is fenced too: a deposed master's
                # Prepare/StartAllreduce must not reconfigure or trigger us
                lambda m, _wid=wid: (
                    [] if self._fenced(m) else self.node.handle(_wid, m)
                ),
            )
        self.transport.register_prefix(
            "node", lambda _nid, m: self._on_cluster_msg(m)
        )
        out: list[Envelope] = []
        if self._chunk_store is not None:
            # (re)build the chunk service under the assigned identity — the
            # STORE persists across rejoins (it is the disk), the service's
            # per-peer push dedup resets with the membership epoch
            self.state = st.ChunkService(
                self.transport,
                msg.node_id,
                self._chunk_store,
                replicas=self.replicas,
                retry=self.config.master.retry,
            )
            self.transport.register(
                st.ChunkService.addr(msg.node_id), self.state.handle
            )
            # the disk survived whatever restarted us: advertise everything
            # it holds — our OWN state and any replica holdings — so the
            # master's holder map (wiped of our old incarnation's entries)
            # re-learns what actually survived on this disk
            out.extend(self._advert_envelopes())
        if self.config.gossip.enabled:
            # decentralized membership: NO hub heartbeat loop — this node
            # joins the probe ring instead (the master is member -1). A
            # node welcomed WITHOUT the section (a legacy master) lands in
            # the else-branch and heartbeats exactly as before — the
            # negotiate-down contract, pinned in tests/test_gossip.py.
            self._start_gossip(msg.node_id)
        else:
            if self._gossip_agent is not None:
                # re-welcomed by a gossip-DISABLED master (an operator-
                # restarted replacement without --gossip): the old probe
                # loop must die with the old cluster, or it would keep
                # probing a stale roster, eventually confirm the OLD
                # master dead, and walk this healthily-attached node
                # away from the live one
                self._gossip_agent.cancel()
                self._gossip_agent = None
                self.gossip = None
            interval = self.config.master.heartbeat_interval_s
            self._heartbeat_task = observed_task(
                run_periodic(interval, self._send_heartbeat),
                name=f"node-{msg.node_id}-heartbeat",
            )
        self._welcomed.set()
        log.info("node %d welcomed (dims=%d)", msg.node_id, dims)
        return out

    # -- gossip membership (RESILIENCE.md "Tier 6") ----------------------------

    def _start_gossip(self, node_id: int) -> None:
        """(Re)build this node's ring identity under the welcomed id. A
        rejoin re-welcome cancels the old probe loop first — a superseded
        identity must not keep answering probes under a stale address."""
        if self._gossip_agent is not None:
            self._gossip_agent.cancel()
        ep = self.transport.endpoint
        self.gossip = gsp.GossipState(
            node_id,
            self.incarnation,
            self.config.gossip,
            host=ep.host,
            port=ep.port,
        )
        # roster: everyone in the current address book plus the master;
        # refreshed on every AddressBook broadcast
        self.gossip.set_members(set(self._endpoints) | {gsp.MASTER_ID})
        self._gossip_agent = gsp.GossipAgent(
            self.transport,
            self.gossip,
            clock=time.monotonic,
            # a node mid-rejoin (or shutting down) must go quiet: its
            # probes would carry a stale incarnation and its acks would
            # vouch for an identity it has abandoned
            gate=lambda: self._welcomed.is_set()
            and not self._shutdown.is_set(),
            on_message=self._on_gossip_leader_ping,
            on_events=self._on_gossip_events,
        )
        self._gossip_agent.start()

    def _on_gossip_leader_ping(self, msg) -> None:
        """Leadership discovery through the ring: a promoted standby joins
        the ring as member -1 under its bumped epoch and PROBES us from
        its own endpoint. Without this hook those pings would keep our
        master record ALIVE (so the confirmed-dead walk never fires)
        while our master-bound traffic — acks included — still flowed to
        the DEAD seed: the promoted master would read our silence as
        death and expel the whole cluster. A master ping from a NEW
        endpoint at >= the incarnation we know repoints the master route
        and re-runs the join handshake there (the same walk a confirmed
        death starts, aimed by the ring instead of cycling candidates);
        a deposed zombie's lower incarnation cannot steal the route."""
        if (
            not isinstance(msg, gsp.Ping)
            or msg.sender != gsp.MASTER_ID
            or msg.port <= 0
        ):
            return None
        ep = cl.Endpoint(msg.host, msg.port)
        if ep == self.seed:
            return None
        rec = self.gossip.members.get(gsp.MASTER_ID) if self.gossip else None
        if rec is not None and msg.incarnation < rec.incarnation:
            return None  # stale leader identity: ignore
        log.info(
            "node %s: master ring identity moved to %s (incarnation %d) "
            "-> re-join",
            self.node_id, ep, msg.incarnation,
        )
        self._point_master(ep)
        if (
            self._welcomed.is_set()
            and not self._rejoining
            and not self._left
        ):
            self._rejoining = True
            self._rejoin_task = observed_task(
                self._rejoin_master(), name="node-rejoin"
            )
        return None

    def _on_gossip_events(self, events: list[gsp.GossipEvent]) -> None:
        """Subscriber drain: the only verdict a NODE acts on is the ring
        confirming the MASTER dead — that (not direct send loss) starts
        the standby walk, so a bad direct link to the leader can no
        longer make a healthy node abandon its membership."""
        for ev in events:
            if (
                ev.node_id == gsp.MASTER_ID
                and ev.status == gsp.DEAD
                and self._welcomed.is_set()
                and not self._rejoining
                and not self._left
            ):
                log.info(
                    "node %s: gossip confirmed the master dead -> re-join",
                    self.node_id,
                )
                self._rejoining = True
                self._rejoin_task = observed_task(
                    self._rejoin_master(), name="node-rejoin"
                )

    # -- peer state transfer ---------------------------------------------------

    def _advert_envelopes(self) -> list[Envelope]:
        """CheckpointAdverts for everything this node's disk holds — its
        OWN state and any replica holdings. Rides every Welcome, and is
        re-sent on demand when a (replacement) master solicits
        (``st.AdvertSolicit``) so an empty holder registry repopulates
        without waiting for rejoin churn."""
        if self.state is None or self._chunk_store is None:
            return []
        out: list[Envelope] = []
        nid = self.state.node_id
        latest = self._chunk_store.latest()
        if latest is not None:
            out.append(
                Envelope(
                    "master",
                    st.CheckpointAdvert(nid, nid, latest[0], latest[1]),
                )
            )
        for origin in sorted(self._chunk_store.replica_origins()):
            held = self._chunk_store.latest(origin)
            if held is not None:
                out.append(
                    Envelope(
                        "master",
                        st.CheckpointAdvert(nid, origin, held[0], held[1]),
                    )
                )
        return out

    @staticmethod
    def _manifest_leaves(manifest_json: str) -> dict:
        """{leaf key: blob sha} of a manifest — restore evidence callers
        (the chaos-recover drill) can verify against replicas without
        racing this node's later saves and prunes."""
        import json

        try:
            return dict(json.loads(manifest_json).get("leaves", {}))
        except (ValueError, AttributeError):
            return {}

    def replica_peers(self) -> list[int]:
        """Live peers chosen as replica targets (address-book ring)."""
        if self.state is None:
            return []
        return self.state.replica_peers(list(self._endpoints))

    async def save_state(self, step: int, state: dict) -> dict | None:
        """Delta-save a flat ``{name: array}`` state dict, advertise it to
        the master, and kick a bounded background replication to the K
        replica peers (skipped, counted, when one is already in flight).
        Returns the save stats, or None when no state dir is configured."""
        if self.state is None or self._chunk_store is None:
            return None
        # deliberately ON the event loop: ChunkStore is single-threaded by
        # design (prune sweeps tmp files; a concurrent thread's in-flight
        # write would be swept mid-publish), and the whole save is
        # synchronous — nothing else interleaves with it. Demo states are
        # small; big states belong to the train-side AsyncDeltaCheckpointer
        # whose writer THREAD owns its store exclusively.
        stats = self._chunk_store.save_state(step, state)
        latest = self._chunk_store.latest()
        assert latest is not None
        await self.transport.send(
            Envelope(
                "master",
                st.CheckpointAdvert(
                    self.state.node_id, self.state.node_id, latest[0], latest[1]
                ),
            )
        )
        peers = self.replica_peers()
        if peers:
            # replicate_latest self-skips (and COUNTS) when a round is
            # already in flight — no pre-check here, or the documented
            # replicate.skipped_busy metric would never fire on this path
            task = observed_task(
                self.state.replicate_latest(peers),
                name=f"node-{self.node_id}-replicate-{step}",
            )
            self._replicate_tasks.add(task)
            task.add_done_callback(self._replicate_tasks.discard)
        return stats

    async def restore_state(
        self, *, rounds: int = 3, give_up: Callable[[], bool] | None = None
    ) -> dict | None:
        """The rejoin restore path (RESILIENCE.md "Recovery"): prefer the
        local disk when it already holds the newest known step; otherwise
        pull the manifest's chunks from live peer holders — per-chunk
        retry/failover, resumable across ``rounds`` attempts with a FRESH
        holder map each time (a partition heal mid-restore changes who is
        reachable). Returns restore stats (``source`` disk|peer) or None
        when there is nothing to restore anywhere.

        ``give_up`` is the caller's OWN-PROGRESS evidence for the blind
        patience below: a callable answering True once the caller has
        demonstrably moved on (the cluster-node role passes its flushed-
        round count against a couple of save periods). Rounds completing
        THROUGH this node prove the master is alive and scheduling — so
        when the registry still answers "nothing known" while our rounds
        race past the first save window, waiting longer only pushes the
        first checkpoint further out (on a loaded box the restore
        coroutine shares the event loop with round traffic, and each
        manifest exchange can cost a second of queueing — patience that
        outruns a seeded early crash was exactly the chaos-recover
        failure mode). It caps ONLY the nothing-known patience: an active
        chunk pull (holders known) is never abandoned by it."""
        if self.state is None or self._chunk_store is None:
            return None
        hb_interval = (
            self.config.master.heartbeat_interval_s
            if self.config is not None
            else 0.5
        )
        t0 = time.perf_counter()
        reply = await self.state.request_manifest()
        latest = self._chunk_store.latest()
        if latest is None and (reply is None or reply.step < 0):
            # nothing local AND the master knows nothing: a REPLACEMENT
            # master's holder registry starts empty, and our request just
            # made it solicit adverts from every live member — patience
            # (one heartbeat interval per round) converges on the
            # re-advertised holders instead of abandoning live peer state.
            # But patience is bounded by EVIDENCE, not just rounds: on a
            # genuinely fresh cluster the master keeps ANSWERING "nothing
            # known" — after a few explicit misses (each of which already
            # triggered a solicit round-trip) we stop stalling the caller
            # (the cluster-node role gates its first SAVE on this decision,
            # and a long blind wait can push the first checkpoint past an
            # early failure). Silence (no answer at all) keeps the full
            # retry budget: that is a master still coming up.
            interval = hb_interval
            explicit_misses = 1 if reply is not None else 0
            members_seen = len(self._endpoints)

            async def _patient_ask() -> None:
                nonlocal reply, explicit_misses, members_seen
                for _ in range(max(1, rounds)):
                    if explicit_misses >= 3:
                        return
                    await asyncio.sleep(interval)
                    if len(self._endpoints) != members_seen:
                        # membership is still converging on the
                        # (replacement) master — every rejoin may bring a
                        # holder's adverts, so visible progress resets
                        # the miss budget
                        members_seen = len(self._endpoints)
                        explicit_misses = 0
                    r = await self.state.request_manifest()
                    if r is not None:
                        reply = r
                        if r.step >= 0:
                            return
                        explicit_misses += 1

            if give_up is None:
                await _patient_ask()
            else:
                # the caller's round progress bounds the blind window HARD
                # — checked between iterations alone it loses to one slow
                # exchange (the reply queues behind MB-scale round frames
                # in OUR inbox; a single manifest round-trip measured ~10
                # rounds of latency on a saturated box), so the whole
                # patience phase races a cheap progress poll and is
                # cancelled mid-await once rounds outrun it
                ask = observed_task(
                    _patient_ask(), name="restore-patience"
                )
                while not ask.done():
                    # the cut needs BOTH kinds of evidence: our own rounds
                    # outrunning the window AND at least one explicit
                    # "nothing known" answer — pure silence is reply
                    # LATENCY (a busy master, our own backlogged inbox),
                    # and cutting on it alone would abandon peer state a
                    # slow first reply was about to offer (seen against a
                    # freshly promoted standby mid-failover)
                    if explicit_misses >= 1 and give_up():
                        ask.cancel()
                        break
                    await asyncio.sleep(0.05)
                await asyncio.wait([ask])
        known_step = reply.step if reply is not None else -1
        if latest is not None and latest[0] >= known_step:
            stats = {
                "source": "disk",
                "step": latest[0],
                "seconds": round(time.perf_counter() - t0, 3),
                "complete": True,
                "leaves": self._manifest_leaves(latest[1]),
            }
            st.note_disk_restore(stats["seconds"])
            return stats
        if reply is None or reply.step < 0:
            return None
        stats = None
        for attempt in range(max(1, rounds)):
            if not reply.holders:
                break
            if not any(h in self._endpoints for h in reply.holders):
                # right after a (re)join the address book may still be in
                # flight: every ``ckpt:<holder>`` send would drop no_route
                # INSTANTLY, burning the whole per-chunk retry budget in
                # microseconds — give the book one heartbeat to land
                # before spending an attempt
                await asyncio.sleep(hb_interval)
            stats = await self.state.restore_from_peers(
                reply.step, reply.manifest_json, list(reply.holders)
            )
            if stats["complete"]:
                stats["seconds"] = round(time.perf_counter() - t0, 3)
                stats["leaves"] = self._manifest_leaves(reply.manifest_json)
                return stats
            if attempt + 1 < rounds:
                fresh = await self.state.request_manifest()
                if fresh is not None and fresh.step >= reply.step:
                    reply = fresh
        log.warning(
            "node %s: peer restore of step %d incomplete (holders=%s)",
            self.node_id, reply.step, list(reply.holders),
        )
        return stats

    async def _send_heartbeat(self) -> None:
        assert self.node_id is not None
        # advertise our server endpoint: a replacement master (same seed
        # address, empty address book) uses it to reply Rejoin
        ep = self.transport.endpoint
        await self.transport.send(
            Envelope(
                "master",
                cl.Heartbeat(self.node_id, self.incarnation, ep.host, ep.port),
            )
        )
