"""Cluster membership protocol — the reference's Akka Cluster seam (the
port's own copy of the JAX package's ``control/cluster.py``).

The reference gets membership from Akka Cluster: nodes join via seed-node
addresses, gossip carries MemberUp/Unreachable, and the grid master reacts to
those events (SURVEY.md §3 "Membership", §4.1 bootstrap, §4.5 recovery). This
module is the same seam as explicit messages: a node dials the master (the
single seed), is welcomed with its node id + the cluster config, then
heartbeats; the master's phi-accrual detector (control/failure.py) turns
heartbeat silence into ``member_unreachable`` and the grid re-organizes.

These are control-plane-only messages (no float payloads) carried by the same
wire codec and TCP transport as the round protocol.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """A reachable transport address (host, port) — the actor-system address."""

    host: str
    port: int

    def __str__(self) -> str:  # "host:port", the CLI's --seed format
        return f"{self.host}:{self.port}"

    @classmethod
    def parse(cls, text: str) -> "Endpoint":
        host, _, port = text.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"expected host:port, got {text!r}")
        return cls(host, int(port))


@dataclasses.dataclass(frozen=True)
class JoinCluster:
    """Node -> master (seed): request membership.

    ``host``/``port`` is the joiner's own server endpoint — peers will dial it
    to deliver ScatterBlock/ReduceBlock. ``preferred_node_id`` lets a restarted
    node ask for its old identity back (-1 = master assigns).

    ``incarnation`` identifies one NodeProcess lifetime. Joins are retried
    until Welcomed (delivery is at-most-once), so the master uses it to tell
    a retry (same incarnation: just re-send Welcome) from a process restart
    on the same endpoint (new incarnation: the workers are fresh — force the
    Prepare handshake).
    """

    host: str
    port: int
    preferred_node_id: int = -1
    incarnation: int = 0


@dataclasses.dataclass(frozen=True)
class Welcome:
    """Master -> node: membership granted.

    Carries the assigned node id and the full cluster config as JSON
    (``AllreduceConfig.to_json``) so every node runs identical geometry and
    thresholds — the reference distributes the same knobs via
    ``application.conf`` on each JVM.

    ``epoch`` is the welcoming master's leadership epoch: the node records
    it as its fencing watermark (messages from older epochs are dropped —
    RESILIENCE.md "Tier 4"). ``standbys`` is the warm-standby endpoint list
    the node walks when the leader stops answering.
    """

    node_id: int
    config_json: str
    epoch: int = 0
    standbys: tuple[tuple[str, int], ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "standbys", tuple((h, int(p)) for h, p in self.standbys)
        )


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    """Node -> master: liveness signal feeding the phi-accrual detector.

    Carries the sender's incarnation so a zombie (a partitioned process
    whose node id was legitimately reclaimed by a newer joiner) cannot
    alias the current holder's liveness with its stale heartbeats, and the
    sender's own server endpoint (``host``/``port``) so a master that does
    NOT know the sender — a replacement master that restarted on the seed
    endpoint with an empty address book — can reply ``Rejoin`` instead of
    dropping the heartbeat and leaving the node wedged forever.
    """

    node_id: int
    incarnation: int = 0
    host: str = ""
    port: int = 0


@dataclasses.dataclass(frozen=True)
class Rejoin:
    """Master -> node: your membership is not recognized here — run the join
    handshake again (new incarnation). Sent by a replacement master that
    receives heartbeats from nodes of its predecessor."""

    reason: str = "unknown-node"
    epoch: int = -1  # sender's leadership epoch (-1 = unfenced)


@dataclasses.dataclass(frozen=True)
class LeaveCluster:
    """Node -> master: graceful departure (Akka Cluster leave)."""

    node_id: int


@dataclasses.dataclass(frozen=True)
class AddressBook:
    """Master -> all nodes: node id -> endpoint map after every membership
    change, so workers can dial their current peers.

    Carries the sender's leadership ``epoch`` (fencing: a zombie master's
    stale book must not overwrite the new leader's) and the current
    ``standbys`` list, so nodes that joined before a standby registered
    still learn where to walk on leader loss.
    """

    entries: tuple[tuple[int, str, int], ...]  # (node_id, host, port)
    epoch: int = -1
    standbys: tuple[tuple[str, int], ...] = ()

    def node_ids(self) -> tuple[int, ...]:
        """The live membership this book describes, sorted — what the
        node-side elastic cycle re-meshes to (RESILIENCE.md "Tier 7")."""
        return tuple(sorted(nid for nid, _h, _p in self.entries))

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "entries", tuple(tuple(e) for e in self.entries)
        )
        object.__setattr__(
            self, "standbys", tuple((h, int(p)) for h, p in self.standbys)
        )

    def endpoint_of(self, node_id: int) -> Endpoint | None:
        for nid, host, port in self.entries:
            if nid == node_id:
                return Endpoint(host, port)
        return None


@dataclasses.dataclass(frozen=True)
class Shutdown:
    """Master -> all nodes: the run is over (max_rounds reached); exit.

    Also master -> master: a promoted standby answers a fenced zombie
    leader's digests with ``Shutdown("superseded-epoch")`` so the zombie
    stands down instead of scheduling into the void forever.
    """

    reason: str = "done"
    epoch: int = -1  # sender's leadership epoch (-1 = unfenced)


@dataclasses.dataclass(frozen=True)
class StandbyRegister:
    """Standby master -> leader: replicate your control-plane state to me.

    ``host``/``port`` is the standby's own server endpoint — the leader
    records it, distributes it to nodes (``Welcome``/``AddressBook``
    ``standbys``), and starts piggybacking :class:`StateDigest` after every
    state-changing event. Registration is idempotent and periodically
    re-sent, so a restarted leader re-learns its standbys.
    """

    host: str
    port: int


@dataclasses.dataclass(frozen=True)
class StateDigest:
    """Leader -> standby: the compact replicated control-plane state.

    Everything a warm standby needs to take over as master: membership
    (address book + incarnations + unreachable set), the round counters
    (next round / completed budget / config id), the peer-checkpoint
    holder registry, and the full cluster config (so chaos + retry knobs
    survive failover). Doubles as the leader's lease heartbeat: the
    standby's phi detector expires on digest silence and the standby takes
    over by bumping ``epoch``. ``host``/``port`` is the leader's endpoint,
    so a promoted standby can fence a still-digesting zombie leader with
    ``Shutdown("superseded-epoch")``.
    """

    epoch: int
    seq: int
    host: str
    port: int
    state_json: str
