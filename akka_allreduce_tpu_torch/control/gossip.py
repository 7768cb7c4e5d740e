"""SWIM-style decentralized membership (RESILIENCE.md "Tier 6"), the port's
own copy of the JAX package's ``control/gossip.py``.

The hub design — all N nodes heartbeating into
ONE master's phi detector (control/failure.py) — makes the leader both a
throughput cap and a single *vantage point*: one congested master-side
link reads as N dead nodes, and detection work scales O(N) on one process.
This module replaces it with the SWIM protocol family the reference's Akka
Cluster gossip belongs to (SURVEY.md §3 "Membership"):

- **probe**: every process pings ONE member per probe period, chosen by a
  shuffled round-robin cycle (every member is probed within one cycle —
  SWIM's time-bounded-detection property, not coupon-collector luck);
- **indirect probe**: a missed direct ack escalates to K ``PingReq``
  relays through other members before anything is suspected — aliveness
  is judged from K+1 vantage points, so one bad link cannot expel a
  healthy node;
- **suspicion**: a member that failed the direct AND indirect round is
  SUSPECTED (gossiped, not acted on); unrefuted suspicion times out into
  CONFIRMED DEAD — the only state the master's membership machinery acts
  on (expulsion, re-mesh: exactly the old ``member_unreachable`` path);
- **refutation**: a member that hears itself suspected bumps its own
  incarnation (the same ordering token the rejoin path mints per
  process lifetime) and gossips itself ALIVE — higher incarnation wins,
  so a slandered-but-alive node un-suspects itself cluster-wide;
- **dissemination**: membership updates piggyback on probe/ack traffic as
  bounded digests (``digest_max`` entries, freshest-first by remaining
  spread budget) — no broadcast storms, no hub.

``GossipState`` is a PURE state machine: every method takes ``now``
explicitly, every random decision draws from a stream seeded by
``(seed, node_id)``, and nothing reads a wall clock — the 64..256-node
LocalRouter simulations in tests/test_gossip.py replay byte-identically.
``GossipAgent`` binds one state to a live transport (the async side:
probe loop task, handler registration).

Wire: ``Ping``/``PingReq``/``Ack`` are ordinary control messages (tags
24-26, control/wire.py) on the existing codec — trailing-bytes tolerant,
round-tripped in tests/test_wire_roundtrip.py, WIRE001-exhaustive.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Any, Callable

from akka_allreduce_tpu_torch.config import GossipConfig
from akka_allreduce_tpu_torch.control.envelope import Envelope
from akka_allreduce_tpu_torch.obs import flight as _flight
from akka_allreduce_tpu_torch.obs import metrics as _metrics

__all__ = [
    "ALIVE",
    "SUSPECT",
    "DEAD",
    "MASTER_ID",
    "Ping",
    "PingReq",
    "Ack",
    "GossipEvent",
    "GossipState",
    "GossipAgent",
    "gossip_addr",
]

# member status bytes — the wire form of a digest entry's third field
ALIVE = 0
SUSPECT = 1
DEAD = 2

#: the master's member id in the gossip ring (== chaos.MASTER_ROLE, so
#: partitions cut gossip traffic by the same role ids as round traffic)
MASTER_ID = -1

_STATUS_NAMES = {ALIVE: "alive", SUSPECT: "suspect", DEAD: "dead"}

# gossip.* observability (OBSERVABILITY.md): probe traffic volume and the
# suspicion state machine's edges — what a membership post-mortem reads
# next to the chaos event log
_PROBES = _metrics.counter("gossip.probes")
_INDIRECT = _metrics.counter("gossip.indirect_probes")
_ACKS_RELAYED = _metrics.counter("gossip.acks_relayed")
_SUSPICIONS = _metrics.counter("gossip.suspicions")
_CONFIRMS = _metrics.counter("gossip.confirmed_dead")
_REFUTATIONS = _metrics.counter("gossip.refutations")
_DIGEST_ENTRIES = _metrics.counter("gossip.digest_entries")
# digest-budget pressure (RESILIENCE.md "Scale"): how often a digest had
# MORE spreadable news than digest_max slots — the ~3·log2(n) spread
# bound is an assumption until this stays ~0; at n=1024 under churn it
# is the first thing to watch
_DIGEST_TRUNCATIONS = _metrics.counter("gossip.digest_truncations")


def gossip_addr(node_id: int) -> str:
    """Transport address of a process's gossip endpoint (the master is
    ``gossip:-1`` — chaos MASTER_ROLE, same id space as partitions)."""
    return f"gossip:{node_id}"


# one digest entry: (node_id, incarnation, status byte)
DigestEntry = tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class Ping:
    """Direct probe (also the relay leg of an indirect probe).

    ``host``/``port`` is the sender's server endpoint, carried for the
    same reason ``Heartbeat`` carries it: a replacement master that does
    not know the pinger must be able to reply ``Rejoin`` instead of
    dropping the frame and leaving the node wedged.
    """

    sender: int
    incarnation: int
    seq: int
    host: str = ""
    port: int = 0
    digest: tuple[DigestEntry, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "digest", tuple(tuple(e) for e in self.digest)
        )


@dataclasses.dataclass(frozen=True)
class PingReq:
    """Indirect-probe request: ``sender`` could not get a direct ack from
    ``target`` — please ping it and relay the ack back (``seq`` is the
    ORIGIN's probe sequence; the relayed Ack carries it back)."""

    sender: int
    target: int
    seq: int
    digest: tuple[DigestEntry, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "digest", tuple(tuple(e) for e in self.digest)
        )


@dataclasses.dataclass(frozen=True)
class Ack:
    """Probe acknowledgement. ``sender`` is the node whose aliveness this
    ack vouches for — for a direct ack that is the responder itself; for
    a relayed ack the relay re-sends the target's identity under the
    origin's ``seq``, so the origin matches it to its pending probe."""

    sender: int
    incarnation: int
    seq: int
    digest: tuple[DigestEntry, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "digest", tuple(tuple(e) for e in self.digest)
        )


@dataclasses.dataclass(frozen=True)
class GossipEvent:
    """Edge-triggered membership change for subscribers (the master's
    expulsion path, a node's master-loss trigger)."""

    node_id: int
    status: int  # ALIVE / SUSPECT / DEAD
    incarnation: int
    at: float  # caller's clock (logical in sims)


@dataclasses.dataclass
class _Member:
    incarnation: int = 0
    status: int = ALIVE
    spread: int = 0  # piggyback transmissions already spent on this state
    suspect_at: float | None = None  # local clock when suspicion started


@dataclasses.dataclass
class _Probe:
    target: int
    sent_at: float
    direct_deadline: float
    deadline: float
    indirect_sent: bool = False


def _derive_seed(seed: int, node_id: int) -> int:
    digest = hashlib.blake2b(
        f"gossip:{seed}:{node_id}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "little")


class GossipState:
    """One process's SWIM membership state machine (clock-free, seeded).

    The member set is AUTHORITATIVELY the master's address book (joins and
    expulsions stay master-decided, exactly as before): callers feed it
    via :meth:`set_members` / :meth:`reset_member` / :meth:`remove_member`.
    Gossip owns only the alive/suspect/dead judgement within that set —
    what used to be the phi hub's job.
    """

    #: piggyback budget per state change, scaled by ln(membership): SWIM's
    #: O(log n) retransmission bound for whole-cluster dissemination
    SPREAD_MULT = 3

    def __init__(
        self,
        node_id: int,
        incarnation: int,
        config: GossipConfig,
        *,
        host: str = "",
        port: int = 0,
        seed: int | None = None,
    ) -> None:
        self.node_id = node_id
        self.incarnation = incarnation
        self.config = config
        self.host = host
        self.port = port
        self._rng = random.Random(
            _derive_seed(config.seed if seed is None else seed, node_id)
        )
        self.members: dict[int, _Member] = {}
        self._cycle: list[int] = []  # shuffled probe order (round-robin)
        # incremental indexes over `members` — what keeps tick()/digest()
        # O(changes) instead of O(membership) so the 256..1024-node sims
        # (and a real pod's per-message hot path) stay allocation-light:
        # ids currently SUSPECT (the only records the confirm scan needs)
        # and ids with remaining piggyback budget (the only digest
        # candidates). Both are maintained at every status/spread edge
        # and lazily validated where staleness is harmless.
        self._suspects: set[int] = set()
        self._fresh: set[int] = set()
        self._seq = 0
        self._pending: dict[int, _Probe] = {}  # my probe seq -> probe
        # relay bookkeeping: my relay-ping seq -> (origin id, origin seq,
        # expiry) — expired in tick() like _pending, or a target that
        # never acks (the PingReq case par excellence) would leak one
        # entry per relayed probe forever
        self._relays: dict[int, tuple[int, int, float]] = {}
        self._next_probe_at = 0.0
        # how many more digests must lead with our own ALIVE entry (a
        # refutation in flight); self is otherwise not in `members`
        self._refute_spread = 0
        self.events: list[GossipEvent] = []
        # per-instance counters (the process-global gossip.* metrics
        # aggregate across instances; sims pin THESE)
        self.probes_sent = 0
        self.indirect_sent = 0
        self.suspicions = 0
        self.confirms = 0
        self.refutations = 0
        self.digest_truncations = 0

    # -- membership roster (master-book-driven) --------------------------------

    def set_members(self, node_ids) -> None:
        """Adopt the roster: new ids get fresh ALIVE records, ids gone
        from the roster are dropped (expelled/left — the master decided).
        Existing records keep their state (a roster refresh must not
        amnesty a suspect)."""
        ids = {int(n) for n in node_ids if int(n) != self.node_id}
        fresh_ids = sorted(ids - set(self.members))
        for nid in fresh_ids:
            self.members[nid] = _Member()
        if fresh_ids:
            # a roster addition is NOT gossip news: the master already
            # broadcast the book to everyone (membership is hub-
            # authoritative), and an ALIVE-at-inc-0 entry outranks
            # nothing anywhere. Starting these settled is also what
            # keeps a 1024-member boot from spending O(N) digest sorts
            # per message on un-news until every budget drains —
            # liveness NEWS (suspicion, refutation, readmission via
            # reset_member's incarnation bump) still spreads from a
            # fresh budget.
            limit = self._spread_limit()
            for nid in fresh_ids:
                self.members[nid].spread = limit
        gone = sorted(set(self.members) - ids)
        for nid in gone:
            self.members.pop(nid, None)
            self._suspects.discard(nid)
            self._fresh.discard(nid)
        if gone:
            self._cycle = [n for n in self._cycle if n not in gone]

    def reset_member(self, node_id: int, incarnation: int = 0) -> None:
        """A (re)admitted member: fresh ALIVE record at the given
        incarnation — its predecessor's DEAD record must not shadow the
        new process (the master vouched for the rejoin)."""
        if node_id == self.node_id:
            return
        self.members[node_id] = _Member(incarnation=incarnation)
        self._suspects.discard(node_id)
        self._fresh.add(node_id)

    def remove_member(self, node_id: int) -> None:
        self.members.pop(node_id, None)
        self._suspects.discard(node_id)
        self._fresh.discard(node_id)
        self._cycle = [n for n in self._cycle if n != node_id]

    # -- views -----------------------------------------------------------------

    def status_of(self, node_id: int) -> int | None:
        rec = self.members.get(node_id)
        return None if rec is None else rec.status

    def alive_or_suspect(self) -> list[int]:
        """Members gossip has NOT confirmed dead — the set the master's
        monitor mirror keeps fresh (a suspect is innocent until the
        suspicion times out; phi must not front-run the confirm)."""
        return sorted(
            n for n, r in self.members.items() if r.status != DEAD
        )

    def poll_events(self) -> list[GossipEvent]:
        """Drain the edge-triggered event queue (confirmed deaths and
        post-suspicion revivals) — the subscriber interface."""
        out, self.events = self.events, []
        return out

    def digest_state(self) -> dict[str, list[int]]:
        """Replication form for the master-HA StateDigest: a promoted
        standby inherits WHO was suspect/dead mid-incident instead of
        re-learning it from scratch."""
        return {
            str(n): [r.incarnation, r.status]
            for n, r in sorted(self.members.items())
        }

    def restore_state(self, state: dict | None) -> None:
        """Adopt a replicated :meth:`digest_state` (standby takeover)."""
        if not state:
            return
        for key, (inc, status) in state.items():
            nid = int(key)
            if nid == self.node_id:
                continue
            rec = self.members.setdefault(nid, _Member())
            rec.incarnation = int(inc)
            rec.status = int(status)
            # inherited suspicions restart their timer at takeover: the
            # digest has no clock, and a fresh window errs alive-ward
            rec.suspect_at = None
            (self._suspects.add if rec.status == SUSPECT
             else self._suspects.discard)(nid)
            # the inherited judgement is NEWS from this identity: the
            # takeover path runs set_members() first, which marks every
            # roster record settled (the boot rule) — without a fresh
            # budget here the promoted master would never gossip WHO was
            # suspect/dead mid-incident, and members that missed the
            # rumor would re-learn it only by their own probe timeouts
            rec.spread = 0
            self._fresh.add(nid)

    # -- the probe loop --------------------------------------------------------

    def tick(self, now: float) -> list[Envelope]:
        """One scheduler pass: expire pending probes (escalate to
        ping-reqs, then suspicion), confirm timed-out suspicions, and
        launch the period's direct probe. Returns the envelopes to send."""
        cfg = self.config
        out: list[Envelope] = []
        for seq in [
            s for s, (_, _, exp) in self._relays.items() if now >= exp
        ]:
            del self._relays[seq]
        for seq in sorted(self._pending):
            probe = self._pending[seq]
            rec = self.members.get(probe.target)
            if rec is None or rec.status == DEAD:
                self._pending.pop(seq, None)
                continue
            if not probe.indirect_sent and now >= probe.direct_deadline:
                probe.indirect_sent = True
                # a LATE escalation (this process stalled past the
                # period — the loaded-host case) still gives the relays
                # their FULL window before suspicion: the rule is
                # "direct AND indirect both came up empty", never "we
                # were too busy to ask"
                probe.deadline = max(
                    probe.deadline,
                    now + (probe.deadline - probe.direct_deadline),
                )
                out.extend(self._ping_reqs(probe, seq))
            if now >= probe.deadline:
                self._pending.pop(seq, None)
                self._suspect(probe.target, now)
        if self._suspects:
            # only the SUSPECT records can confirm — scanning the whole
            # membership here was the sims' O(N) * N-nodes per tick wall
            for nid in sorted(self._suspects):
                rec = self.members.get(nid)
                if (
                    rec is not None
                    and rec.status == SUSPECT
                    and rec.suspect_at is not None
                    and now - rec.suspect_at
                    >= cfg.suspicion_periods * cfg.probe_interval_s
                ):
                    self._confirm_dead(nid, rec, now)
        if now >= self._next_probe_at:
            self._next_probe_at = now + cfg.probe_interval_s
            target = self._next_target()
            if target is not None:
                self._seq += 1
                self._pending[self._seq] = _Probe(
                    target,
                    now,
                    now + cfg.probe_timeout_s,
                    now + cfg.probe_interval_s,
                )
                self.probes_sent += 1
                _PROBES.inc()
                out.append(
                    Envelope(gossip_addr(target), self._ping(self._seq))
                )
        return out

    def _next_target(self) -> int | None:
        """Shuffled round-robin over the probe-able membership (SWIM §4.3:
        randomized cycling bounds worst-case time-to-probe by one cycle,
        where pure random sampling only bounds the expectation).

        Candidacy is checked per POP (an O(1) status read), and the full
        membership is only walked when the cycle runs dry — amortized
        O(1) per probe, where rebuilding the candidate set per call was
        an O(N) allocation that multiplied into the sims' N² wall."""
        for _ in range(2):
            while self._cycle:
                nid = self._cycle.pop()
                rec = self.members.get(nid)
                if rec is not None and rec.status != DEAD:
                    return nid
            candidates = sorted(
                n for n, r in self.members.items() if r.status != DEAD
            )
            if not candidates:
                return None
            self._cycle = candidates
            self._rng.shuffle(self._cycle)
        return None  # unreachable: a rebuilt non-empty cycle always pops

    def _ping_reqs(self, probe: _Probe, seq: int) -> list[Envelope]:
        """K indirect probes through other members — the vantage-point
        fan-out that makes one bad link insufficient for expulsion."""
        relays = sorted(
            n
            for n, r in self.members.items()
            if r.status != DEAD and n != probe.target
        )
        if not relays or self.config.indirect == 0:
            return []
        self._rng.shuffle(relays)
        chosen = relays[: self.config.indirect]
        self.indirect_sent += len(chosen)
        _INDIRECT.inc(len(chosen))
        msg = PingReq(self.node_id, probe.target, seq, self._digest())
        return [Envelope(gossip_addr(n), msg) for n in chosen]

    def _ping(self, seq: int) -> Ping:
        return Ping(
            self.node_id,
            self.incarnation,
            seq,
            self.host,
            self.port,
            self._digest(),
        )

    # -- the message handler ---------------------------------------------------

    def handle(self, msg: Any, now: float) -> list[Envelope]:
        out: list[Envelope] = []
        if isinstance(msg, Ping):
            self._absorb(msg.digest, now)
            self._note_direct(msg.sender, msg.incarnation, now)
            out.append(
                Envelope(
                    gossip_addr(msg.sender),
                    Ack(self.node_id, self.incarnation, msg.seq, self._digest()),
                )
            )
        elif isinstance(msg, PingReq):
            self._absorb(msg.digest, now)
            self._note_direct(msg.sender, None, now)
            # relay leg: ping the target with a fresh seq of our own and
            # remember whose probe this answers — the target's ack comes
            # back to us and is re-issued to the origin under ITS seq
            # (bounded: the entry expires with the origin's probe period)
            self._seq += 1
            self._relays[self._seq] = (
                msg.sender, msg.seq, now + self.config.probe_interval_s
            )
            out.append(Envelope(gossip_addr(msg.target), self._ping(self._seq)))
        elif isinstance(msg, Ack):
            self._absorb(msg.digest, now)
            self._note_direct(msg.sender, msg.incarnation, now)
            if msg.seq in self._pending:
                probe = self._pending[msg.seq]
                if probe.target == msg.sender:
                    del self._pending[msg.seq]
            relay = self._relays.pop(msg.seq, None)
            if relay is not None:
                origin, origin_seq, _exp = relay
                _ACKS_RELAYED.inc()
                out.append(
                    Envelope(
                        gossip_addr(origin),
                        Ack(
                            msg.sender,
                            msg.incarnation,
                            origin_seq,
                            self._digest(),
                        ),
                    )
                )
        else:
            raise TypeError(f"gossip cannot handle {type(msg).__name__}")
        return out

    # -- evidence and state transitions ----------------------------------------

    def _note_direct(
        self, sender: int, incarnation: int | None, now: float
    ) -> None:
        """First-hand evidence: a frame FROM the member itself (or a relay
        vouching for it). Clears local suspicion WITHOUT an incarnation
        bump — we hold proof, but only the member itself may refute the
        cluster-wide rumor (SWIM's ordering rule), so nothing is spread."""
        if sender == self.node_id:
            return
        rec = self.members.get(sender)
        if rec is None:
            return  # not in the roster (the master decides membership)
        if incarnation is not None and incarnation < rec.incarnation:
            # a STALE incarnation's frame (a zombie predecessor of the
            # id's current holder) is not evidence for the holder: the
            # hub's heartbeat path ignored exactly this (zombie guard),
            # and clearing suspicion on it would let a dead rejoiner be
            # vouched alive by its own ghost forever
            return
        # a bump PAST A KNOWN token is news; learning a member's first
        # real incarnation (record still at the 0 placeholder — nothing
        # was ever claimed) is not, or every boot would flood digests
        # with N un-news entries per node
        bumped = (
            incarnation is not None and 0 < rec.incarnation < incarnation
        )
        if incarnation is not None and incarnation > rec.incarnation:
            rec.incarnation = incarnation
        was_dead = rec.status == DEAD
        if rec.status != ALIVE:
            rec.status = ALIVE
            rec.suspect_at = None
            self._suspects.discard(sender)
            if bumped:
                # a STRICTLY higher incarnation heard first-hand is a
                # fresh fact, not a rumor we must leave to its owner:
                # ALIVE@inc outranks every lower-incarnation state by
                # the absorb precedence, so spreading it is safe — and
                # without the spread, a promoted master's (or any
                # rejoiner's) revival reaches each member only by
                # DIRECT contact: O(N) probe periods of re-mesh time,
                # the 256-node sims' measured 145 s wall (bounded at
                # ~3·log2(n) periods with it — pinned at scale)
                rec.spread = 0
                self._fresh.add(sender)
            else:
                # equal incarnation: local-only amnesty — we hold
                # first-hand proof, but only the member itself may
                # refute the cluster-wide rumor (SWIM's ordering rule),
                # so nothing is spread
                self._fresh.discard(sender)
                rec.spread = self._spread_limit()
            if was_dead:
                # first-hand proof trumps a rumor we already acted on:
                # surface the revival so the subscriber can re-admit
                self.events.append(
                    GossipEvent(sender, ALIVE, rec.incarnation, now)
                )
        elif bumped:
            # already alive, but the incarnation moved (a refutation or
            # readmission we witnessed first-hand): the new token is
            # news — spread it so stale lower-inc rumors die everywhere
            rec.spread = 0
            self._fresh.add(sender)

    def _suspect(self, node_id: int, now: float) -> None:
        rec = self.members.get(node_id)
        if rec is None or rec.status != ALIVE:
            return
        rec.status = SUSPECT
        rec.suspect_at = now
        rec.spread = 0  # news: spend a fresh piggyback budget on it
        self._suspects.add(node_id)
        self._fresh.add(node_id)
        self.suspicions += 1
        _SUSPICIONS.inc()
        _flight.note(
            "gossip", event="suspect", node=node_id, by=self.node_id,
            incarnation=rec.incarnation,
        )
        self.events.append(GossipEvent(node_id, SUSPECT, rec.incarnation, now))

    def _confirm_dead(self, node_id: int, rec: _Member, now: float) -> None:
        rec.status = DEAD
        rec.suspect_at = None
        rec.spread = 0
        self._suspects.discard(node_id)
        self._fresh.add(node_id)
        self.confirms += 1
        _CONFIRMS.inc()
        _flight.note(
            "gossip", event="confirm_dead", node=node_id, by=self.node_id,
            incarnation=rec.incarnation,
        )
        self.events.append(GossipEvent(node_id, DEAD, rec.incarnation, now))

    def _absorb(self, digest, now: float) -> None:
        """Merge a received membership digest under SWIM's precedence
        rules: higher incarnation wins; at equal incarnation suspect
        overrides alive and dead overrides both (dead is terminal per
        incarnation — only a HIGHER-incarnation alive revives)."""
        for entry in digest:
            nid, inc, status = int(entry[0]), int(entry[1]), int(entry[2])
            if nid == self.node_id:
                if status in (SUSPECT, DEAD) and inc >= self.incarnation:
                    # the refutation rule: the rumor is about US and is
                    # current — bump our incarnation past it and lead the
                    # next digests with the fresh ALIVE claim, which
                    # outranks the suspicion everywhere it spread
                    self.incarnation = inc + 1
                    self._refute_spread = self._spread_limit()
                    self.refutations += 1
                    _REFUTATIONS.inc()
                    _flight.note(
                        "gossip", event="refute", node=self.node_id,
                        incarnation=self.incarnation,
                    )
                continue
            rec = self.members.get(nid)
            if rec is None:
                continue  # roster is master-decided; rumors don't add members
            if status == ALIVE:
                takes = inc > rec.incarnation
            elif status == SUSPECT:
                takes = (
                    inc > rec.incarnation
                    or (inc == rec.incarnation and rec.status == ALIVE)
                )
            else:  # DEAD
                takes = inc >= rec.incarnation and rec.status != DEAD
            if not takes:
                continue
            prev = rec.status
            rec.incarnation = inc
            rec.status = status
            rec.spread = 0  # fresh news spreads onward from here
            self._fresh.add(nid)
            (self._suspects.add if status == SUSPECT
             else self._suspects.discard)(nid)
            if status == SUSPECT:
                if prev != SUSPECT:
                    # start OUR OWN suspicion clock: every process confirms
                    # independently (no single confirmer to lose)
                    rec.suspect_at = now
            else:
                rec.suspect_at = None
            if status == DEAD and prev != DEAD:
                self.confirms += 1
                _CONFIRMS.inc()
                self.events.append(GossipEvent(nid, DEAD, inc, now))
            elif status == ALIVE and prev == DEAD:
                self.events.append(GossipEvent(nid, ALIVE, inc, now))

    # -- digest assembly -------------------------------------------------------

    def _spread_limit(self) -> int:
        """Per-state-change piggyback budget: ~3·ln(n) transmissions
        reaches every member whp (SWIM §5's dissemination bound)."""
        n = max(2, len(self.members) + 1)
        return max(3, int(self.SPREAD_MULT * n.bit_length()))

    def _digest(self) -> tuple[DigestEntry, ...]:
        """Bounded membership digest: our own refutation first (when one
        is in flight), then the entries with the most remaining spread
        budget — fresh news travels, settled state stays off the wire.

        Only the ``_fresh`` index is walked (lazily pruned of entries
        whose budget was spent through another path): in steady state it
        is EMPTY, so the per-message cost is O(1), not O(membership).
        News that did not fit the ``digest_max`` slots counts a
        truncation — the observable form of digest-budget pressure the
        ~3·log2(n) spread bound silently assumed away (OBSERVABILITY.md
        ``gossip.digest_truncations``)."""
        out: list[DigestEntry] = []
        if self._refute_spread > 0:
            self._refute_spread -= 1
            out.append((self.node_id, self.incarnation, ALIVE))
        if self._fresh:
            limit = self._spread_limit()
            fresh: list[tuple[int, int]] = []
            stale: list[int] = []
            for nid in sorted(self._fresh):
                rec = self.members.get(nid)
                if rec is None or rec.spread >= limit:
                    stale.append(nid)
                else:
                    fresh.append((rec.spread, nid))
            for nid in stale:
                self._fresh.discard(nid)
            fresh.sort()
            budget = max(0, self.config.digest_max - len(out))
            for _, nid in fresh[:budget]:
                rec = self.members[nid]
                rec.spread += 1
                if rec.spread >= limit:
                    self._fresh.discard(nid)
                out.append((nid, rec.incarnation, rec.status))
            if len(fresh) > budget:
                self.digest_truncations += 1
                _DIGEST_TRUNCATIONS.inc()
        if out:
            _DIGEST_ENTRIES.inc(len(out))
        return tuple(out)


class GossipAgent:
    """Async binding of one :class:`GossipState` to a live transport:
    registers the ``gossip:<id>`` handler and runs the probe loop as a
    ``run_periodic`` task (through ``observed_task``, like every other
    background loop — a dead probe loop is an ERROR log, not silence).

    ``gate`` (when given) pauses both the probe loop and the handler —
    a fenced-out master or a mid-rejoin node must go quiet, not keep
    acking probes under a stale identity. ``on_message`` is a pre-handle
    hook that may return EXTRA envelopes (the master's unknown-pinger
    ``Rejoin`` reply); ``on_events`` is the subscriber drain — when set,
    the agent hands it every batch of edge events after each tick/handle
    (when unset, the owner drains :meth:`GossipState.poll_events` itself).
    """

    def __init__(
        self,
        transport,
        state: GossipState,
        *,
        clock: Callable[[], float],
        gate: Callable[[], bool] | None = None,
        on_message: Callable[[Any], Any] | None = None,
        on_events: Callable[[list[GossipEvent]], None] | None = None,
    ) -> None:
        self.transport = transport
        self.state = state
        self.clock = clock
        self.gate = gate
        self.on_message = on_message
        self.on_events = on_events
        self._task = None
        transport.register(gossip_addr(state.node_id), self._handle)

    def _handle(self, msg: Any) -> list[Envelope]:
        if self.gate is not None and not self.gate():
            return []
        extra = self.on_message(msg) if self.on_message is not None else None
        out = self.state.handle(msg, self.clock())
        self._drain_events()
        return list(extra or []) + out

    def _drain_events(self) -> None:
        if self.on_events is None:
            return  # the owner polls the state directly (master-side)
        events = self.state.poll_events()
        if events:
            self.on_events(events)

    def start(self) -> None:
        """Spawn the probe loop (requires a running event loop). Sync by
        design: callable from inside a transport handler (the node's
        Welcome path)."""
        from akka_allreduce_tpu_torch.control.remote import (
            observed_task,
            run_periodic,
        )

        # sub-period cadence so ack timeouts (fractions of the probe
        # interval) are observed promptly; tick() itself rate-limits the
        # actual probes to one per probe_interval_s
        period = self.state.config.probe_timeout_s / 2.0
        self._task = observed_task(
            run_periodic(period, self._tick),
            name=f"gossip-{self.state.node_id}",
        )

    async def _tick(self) -> None:
        if self.gate is not None and not self.gate():
            return
        out = self.state.tick(self.clock())
        self._drain_events()
        if out:
            await self.transport.send_all(out)

    def cancel(self) -> None:
        """Tear down synchronously (a rejoin's re-welcome runs inside a
        transport handler): the probe loop is cancelled and the address
        registration is replaced with a drop handler, so a superseded
        identity can never keep answering probes."""
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.transport.register(
            gossip_addr(self.state.node_id), lambda _msg: []
        )

    async def stop(self) -> None:
        import asyncio

        task = self._task
        self.cancel()
        if task is not None:
            try:
                await task
            except asyncio.CancelledError:
                pass
