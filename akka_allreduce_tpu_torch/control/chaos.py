"""Deterministic chaos layer for the control-plane transports (the port's own
copy of the JAX package's ``control/chaos.py``, its decisions and logs byte
for byte the same).

The reference tests fault tolerance by omitting messages (SURVEY.md §5);
this module generalizes that into a seed-driven fault-injection layer that
interposes on BOTH transports through one shared hook point: a transport
carries an optional ``chaos`` attribute (a :class:`ChaosInjector`) and asks
it ``plan_send(env)`` for every envelope headed to the wire. The injector
answers with a :class:`ChaosAction` (or ``None`` — the fast path), and the
transport applies the mechanics it supports:

- ``RemoteTransport`` (control/remote.py): drop, fail (partition semantics
  — the drop fires ``on_send_error`` so failure counting sees it, exactly
  like a refused connection), delay/stall (the frame is held and sent
  later — later frames overtake it, so delay IS reordering pressure),
  duplicate, and payload corruption (a bit flip in the tag-2/3 payload
  bytes, which the wire checksum must reject on the receive side).
- ``LocalRouter`` (control/local.py): drop, duplicate, reorder
  (push-to-back), and corruption via a wire-codec round trip — the same
  checksum rejects the flip even though no socket is involved.

Faults are compiled from a spec string (see :func:`parse_spec`)::

    drop:p=0.05;delay:ms=20;corrupt:p=0.01
    partition:groups=m+0|1+2,at=round10,heal=5s
    partition:from=1+2,to=m,at=8s,heal=8s   (one-directional)
    stall:node=1,at=3s,for=2s;crash:node=2,at=round8

Determinism: every probabilistic decision draws from a per-fault
``random.Random`` seeded by ``(seed, role, fault index, fault name)``, and
the event log records NO wall-clock timestamps — only logical fields (seq,
fault, dest, message type, round). Two injectors with the same seed fed
the same traffic emit byte-identical logs (``event_log_jsonl``), which is
the tier-1 determinism ratchet in tests/test_chaos.py. Injected events are
also mirrored to the flight recorder ring and the metrics registry
(``chaos.injected.<fault>``), so a post-mortem dump shows what the chaos
layer did alongside what the system did about it.

No new wire tags: chaos configuration travels inside ``Welcome``'s config
JSON (``config.ChaosConfig``), and every fault is applied to frames of the
EXISTING protocol — arlint's WIRE001 exhaustiveness surface is unchanged
by design (pinned in tests/test_chaos.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import random
import sys
import time
from typing import Any, Callable

from akka_allreduce_tpu_torch.obs import flight as _flight
from akka_allreduce_tpu_torch.obs import metrics as _metrics
from akka_allreduce_tpu_torch.protocol import ReduceBlock, ScatterBlock

log = logging.getLogger(__name__)

__all__ = [
    "MASTER_ROLE",
    "CRASH_EXIT_CODE",
    "ChaosAction",
    "ChaosInjector",
    "FaultSpec",
    "parse_spec",
    "membership_schedule",
    "leader_kill_step",
]

#: role value of the master process (nodes use their node id >= 0)
MASTER_ROLE = -1

#: exit status of a chaos-injected crash (distinguishable from real crashes)
CRASH_EXIT_CODE = 23

_FAULTS = (
    "drop",
    "delay",
    "duplicate",
    "reorder",
    "corrupt",
    "partition",
    "stall",
    "crash",
)

_EVENTS_TOTAL = _metrics.counter("chaos.events")


@dataclasses.dataclass
class ChaosAction:
    """What a transport should do to ONE outgoing envelope."""

    drop: bool = False  # swallow silently (packet-loss semantics)
    fail: bool = False  # swallow AND fire on_send_error (partition semantics)
    delay_s: float = 0.0  # hold the frame; later sends overtake it
    duplicate: bool = False  # send the frame twice
    corrupt: bool = False  # flip one payload bit (checksum must reject)
    # corruption coordinates, decided at plan time so the decision stream
    # (and thus the event log) never depends on frame geometry
    corrupt_at: float = 0.0  # fraction into the payload bytes
    corrupt_bit: int = 0  # which bit of that byte flips


def _parse_when(text: str, what: str) -> tuple[str, float]:
    """``round10`` -> ("round", 10); ``5s``/``5`` -> ("time", 5.0)."""
    if text.startswith("round"):
        try:
            return "round", float(int(text[len("round"):]))
        except ValueError:
            raise ValueError(f"bad {what} {text!r}: expected roundN") from None
    try:
        return "time", float(text[:-1] if text.endswith("s") else text)
    except ValueError:
        raise ValueError(
            f"bad {what} {text!r}: expected roundN, <sec>s, or a number"
        ) from None


def _parse_role(text: str, what: str) -> int:
    if text == "m":
        return MASTER_ROLE
    if text.lstrip("-").isdigit():
        return int(text)
    raise ValueError(f"bad {what} {text!r}: expected a node id or 'm'")


@dataclasses.dataclass
class FaultSpec:
    """One compiled fault from the spec string."""

    name: str
    p: float = 1.0
    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    groups: tuple[frozenset[int], ...] = ()
    # one-directional partition (`partition:from=m,to=1`): sends FROM a
    # member of `src` TO a member of `dst` fail; the reverse direction
    # flows — the asymmetric-loss case that makes a hub misjudge N nodes
    # from one congested link (gossip's indirect probes route around it)
    src: frozenset[int] = frozenset()
    dst: frozenset[int] = frozenset()
    node: int | None = None
    at: tuple[str, float] = ("time", 0.0)
    until: tuple[str, float] | None = None  # heal= / for= (absolute or span)
    # runtime window state (set by the injector)
    active_since_s: float | None = None
    done: bool = False
    # one-shot round triggers ARM only after this process observes a round
    # BELOW the trigger: a process that joins a cluster already past the
    # trigger round (the chaos-recover respawn) must not re-fire a crash
    # that belongs to the epoch that approached it — without this, a
    # crash:node=K,at=roundN kills node K again on every rejoin forever
    armed: bool = False


def parse_spec(spec: str) -> list[FaultSpec]:
    """Compile a chaos spec string into fault specs.

    Grammar: ``fault(;fault)*`` where ``fault := name[:k=v(,k=v)*]``.
    Group lists use ``+`` within a group and ``|`` between groups
    (``groups=m+0|1+2``; ``m`` is the master) because ``,`` separates
    parameters. Raises ``ValueError`` with the offending token on any
    malformed input — a bad spec must fail at startup, not mid-run.
    """
    faults: list[FaultSpec] = []
    for i, part in enumerate(p for p in spec.split(";") if p.strip()):
        name, _, rest = part.strip().partition(":")
        name = name.strip()
        if name not in _FAULTS:
            raise ValueError(
                f"unknown chaos fault {name!r}; expected one of {_FAULTS}"
            )
        f = FaultSpec(name=name)
        params: dict[str, str] = {}
        for kv in (x for x in rest.split(",") if x.strip()):
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"bad chaos param {kv!r} (expected k=v)")
            params[k.strip()] = v.strip()
        for k, v in params.items():
            if k == "p":
                f.p = float(v)
                if not 0.0 <= f.p <= 1.0:
                    raise ValueError(f"{name}: p must be in [0,1], got {v}")
            elif k == "ms" and name == "delay":
                f.delay_ms = float(v)
            elif k == "jitter_ms" and name == "delay":
                f.jitter_ms = float(v)
            elif k == "groups" and name == "partition":
                f.groups = tuple(
                    frozenset(
                        _parse_role(m, "partition group member")
                        for m in g.split("+")
                        if m
                    )
                    for g in v.split("|")
                )
                if len(f.groups) < 2:
                    raise ValueError(
                        f"partition needs >= 2 groups, got {v!r}"
                    )
            elif k in ("from", "to") and name == "partition":
                members = frozenset(
                    _parse_role(m, f"partition {k} member")
                    for m in v.split("+")
                    if m
                )
                if not members:
                    raise ValueError(f"partition: empty {k}= member list")
                if k == "from":
                    f.src = members
                else:
                    f.dst = members
            elif k == "node" and name in ("stall", "crash", "delay"):
                # delay:node=K is the STAGED STRAGGLER (RESILIENCE.md
                # "Tier 5"): one process's sends run late while its
                # heartbeats keep their cadence (a constant hold preserves
                # spacing) — slow-but-alive, the case the adaptive
                # controller exists for, distinct from stall's silence
                f.node = _parse_role(v, f"{name} node")
            elif k == "at":
                f.at = _parse_when(v, f"{name} at")
            elif k == "heal" and name == "partition":
                f.until = _parse_when(v, "partition heal")
            elif k == "for" and name in ("stall", "delay"):
                f.until = _parse_when(v, f"{name} for")
            else:
                raise ValueError(f"{name}: unknown param {k!r}")
        if name == "partition":
            if f.groups and (f.src or f.dst):
                raise ValueError(
                    "partition: groups= and from=/to= are mutually "
                    "exclusive (symmetric vs one-directional form)"
                )
            if bool(f.src) != bool(f.dst):
                raise ValueError(
                    "partition: from= and to= must be given together"
                )
            if not f.groups and not f.src:
                raise ValueError("partition requires groups= or from=/to=")
        if name in ("stall", "crash") and f.node is None:
            raise ValueError(f"{name} requires node=")
        # crash:node=m is allowed since the master-HA PR: a real
        # cluster-master process arms allow_crash, and the warm-standby
        # failover protocol is exactly what absorbs the kill (the
        # chaos-failover drill). In-process masters keep allow_crash off
        # and record a suppressed crash, like nodes always did.
        if name == "crash" and f.at == ("round", 0.0):
            # round triggers arm only after a round BELOW the trigger is
            # observed (so a rejoined process cannot re-fire a past crash);
            # round0 can never arm — reject it instead of silently never
            # firing
            raise ValueError(
                "crash:at=round0 cannot arm (round triggers fire when the "
                "round sequence crosses them from below); use at=round1+ "
                "or a time trigger"
            )
        if name == "stall" and f.until is None:
            raise ValueError("stall requires for=")
        if name == "delay" and f.delay_ms <= 0:
            raise ValueError("delay requires ms= > 0")
        faults.append(f)
    return faults


def _derive_seed(seed: int, role: int, index: int, name: str) -> int:
    digest = hashlib.blake2b(
        f"{seed}:{role}:{index}:{name}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "little")


class ChaosInjector:
    """Per-process chaos runtime: compiled faults + seeded decision streams.

    One injector per transport; ``role`` is the process's identity
    (:data:`MASTER_ROLE` or a node id) so partitions/stalls/crashes know
    which side of the spec this process is. ``t0`` anchors time-based
    triggers — pass the SAME anchor when rebuilding an injector after a
    rejoin, or the fault timeline would restart with the membership.
    """

    def __init__(
        self,
        seed: int,
        spec: str,
        *,
        role: int,
        dims: int = 1,
        clock: Callable[[], float] = time.monotonic,
        t0: float | None = None,
        allow_crash: bool = False,
        log_path: str | None = None,
    ) -> None:
        self.seed = seed
        self.role = role
        self.dims = max(1, dims)
        self.clock = clock
        self.t0 = clock() if t0 is None else t0
        self.allow_crash = allow_crash
        self.log_path = log_path
        self.spec = spec
        self.faults = parse_spec(spec)
        self._rngs = [
            random.Random(_derive_seed(seed, role, i, f.name))
            for i, f in enumerate(self.faults)
        ]
        self.events: list[dict[str, Any]] = []
        self.round = -1
        self.crashes_suppressed = 0
        self._counters = {
            name: _metrics.counter(f"chaos.injected.{name}")
            for name in _FAULTS
        }

    # -- bookkeeping ----------------------------------------------------------

    def _now(self) -> float:
        return self.clock() - self.t0

    def _log(self, fault: str, env, **extra: Any) -> None:
        """One injected event: logical fields only (NO timestamps), so the
        log is byte-identical across same-seed same-traffic runs."""
        rec = {
            "seq": len(self.events),
            "fault": fault,
            "role": self.role,
            "dest": env.dest if env is not None else None,
            "msg": type(env.msg).__name__ if env is not None else None,
            "round": self.round if self.round >= 0 else None,
            **extra,
        }
        self.events.append(rec)
        self._counters[fault].inc()
        _EVENTS_TOTAL.inc()
        _flight.note("chaos_inject", **rec)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e["fault"]] = out.get(e["fault"], 0) + 1
        return out

    def event_log_jsonl(self) -> str:
        """The deterministic event log, one sorted-key JSON object per
        line — the byte-identity surface of the same-seed guarantee."""
        return "\n".join(json.dumps(e, sort_keys=True) for e in self.events)

    def write_log(self, path: str | None = None) -> str | None:
        path = path or self.log_path
        if not path:
            return None
        with open(path, "w") as f:
            text = self.event_log_jsonl()
            f.write(text + ("\n" if text else ""))
        return path

    # -- routing helpers ------------------------------------------------------

    def _dest_role(self, dest: str) -> int | None:
        """Which process an address lives on (None = unattributable, e.g.
        the pre-Welcome ``client`` reply — chaos leaves those alone)."""
        if dest == "master" or dest.startswith("line_master:"):
            return MASTER_ROLE
        prefix, _, suffix = dest.rpartition(":")
        if suffix.lstrip("-").isdigit():
            if prefix == "worker":
                return int(suffix) // self.dims
            if prefix in ("node", "gossip"):
                # gossip endpoints use the same role id space (the master
                # is gossip:-1 == MASTER_ROLE), so partitions/stalls cut
                # membership traffic exactly like round traffic
                return int(suffix)
        return None

    def _group_of(self, groups, role: int | None) -> int | None:
        if role is None:
            return None
        for i, g in enumerate(groups):
            if role in g:
                return i
        return None

    def _window_active(self, f: FaultSpec, now: float) -> bool:
        """Evaluate (and advance) a partition/stall window's state."""
        kind, value = f.at
        started = (
            self.round >= value if kind == "round" else now >= value
        )
        if not started:
            return False
        if f.active_since_s is None:
            f.active_since_s = now
        if f.until is None:
            return True
        ukind, uvalue = f.until
        if ukind == "round":
            return self.round < uvalue
        # time spans are relative to activation (heal=5s / for=2s)
        return now - f.active_since_s < uvalue

    def _fired(self, f: FaultSpec, now: float) -> bool:
        """One-shot trigger (crash)."""
        if f.done:
            return False
        kind, value = f.at
        if kind == "round":
            # arm only while approaching the trigger from below (see
            # FaultSpec.armed): a rejoined process observing round 122
            # must not re-fire an at=round30 crash
            if 0 <= self.round < value:
                f.armed = True
            if f.armed and self.round >= value:
                f.done = True
                return True
            return False
        if now >= value:
            f.done = True
            return True
        return False

    # -- the hook point -------------------------------------------------------

    def plan_send(self, env) -> ChaosAction | None:
        """Decide this envelope's fate. Called by the transport for every
        envelope headed to the wire; ``None`` means untouched (fast path).
        May not return at all: a fired ``crash`` fault ``os._exit``\\ s the
        process (only when ``allow_crash`` — cluster subprocesses; the
        in-process harness records a suppressed crash instead)."""
        r = getattr(env.msg, "round_num", None)
        if isinstance(r, int) and r > self.round:
            self.round = r
        now = self._now()
        act = ChaosAction()
        hit = False
        for f, rng in zip(self.faults, self._rngs):
            name = f.name
            if name == "crash":
                if f.node == self.role and self._fired(f, now):
                    if self.allow_crash:
                        self._log("crash", env, exit=CRASH_EXIT_CODE)
                        self.write_log()
                        sys.stderr.write(
                            f"chaos: injected crash (role {self.role}, "
                            f"round {self.round})\n"
                        )
                        sys.stderr.flush()
                        os._exit(CRASH_EXIT_CODE)
                    # in-process harness: the log must record what actually
                    # happened — a suppressed crash, not an exit
                    self._log("crash", env, suppressed=True)
                    self.crashes_suppressed += 1
                continue
            if name == "partition":
                if not self._window_active(f, now):
                    continue
                if f.src:
                    # one-directional form: only the src -> dst direction
                    # is cut (the acks/replies flow back fine — the
                    # asymmetric-loss case a hub detector cannot tell
                    # from death)
                    theirs = self._dest_role(env.dest)
                    if self.role not in f.src or theirs not in f.dst:
                        continue
                    self._log("partition", env, oneway=True, peer=theirs)
                    act.fail = True
                    hit = True
                    break  # the direction is down; nothing else applies
                mine = self._group_of(f.groups, self.role)
                theirs = self._group_of(f.groups, self._dest_role(env.dest))
                if mine is None or theirs is None or mine == theirs:
                    continue
                self._log("partition", env, group=mine, peer_group=theirs)
                act.fail = True
                hit = True
                break  # the link is down; nothing else applies
            if name == "stall":
                if f.node != self.role or not self._window_active(f, now):
                    continue
                assert f.until is not None and f.active_since_s is not None
                ukind, uvalue = f.until
                remain = (
                    max(uvalue - now + f.active_since_s, 0.0)
                    if ukind == "time"
                    else 0.05  # round-bounded stalls re-check per send
                )
                # log the CONFIGURED window, not the live remainder: the
                # remainder is wall-clock-derived and would break the
                # byte-identical same-seed log guarantee
                self._log("stall", env, window=f"{ukind}:{uvalue:g}")
                act.delay_s = max(act.delay_s, remain)
                hit = True
                continue
            if name == "delay" and (
                f.node is not None or f.at != ("time", 0.0) or f.until
            ):
                # the targeted/windowed delay form (the staged straggler):
                # role and window are checked BEFORE the rng draw, so an
                # un-targeted un-windowed spec's decision stream is
                # byte-identical to the historical one
                if f.node is not None and f.node != self.role:
                    continue
                if not self._window_active(f, now):
                    continue
            # probabilistic faults consume exactly one sample per send so
            # the decision stream depends only on (seed, traffic order)
            if rng.random() >= f.p:
                continue
            if name == "drop":
                self._log("drop", env)
                act.drop = True
                hit = True
                break  # dropped; later faults moot
            if name == "delay":
                extra = rng.random() * f.jitter_ms if f.jitter_ms else 0.0
                ms = f.delay_ms + extra
                self._log("delay", env, delay_ms=round(ms, 3))
                act.delay_s = max(act.delay_s, ms / 1e3)
                hit = True
            elif name == "duplicate":
                self._log("duplicate", env)
                act.duplicate = True
                hit = True
            elif name == "reorder":
                # mechanically a tiny hold: per-connection FIFO is violated
                # because later sends overtake the held frame
                self._log("reorder", env)
                act.delay_s = max(act.delay_s, 0.005)
                hit = True
            elif name == "corrupt":
                if not isinstance(env.msg, (ScatterBlock, ReduceBlock)):
                    continue  # only payload frames carry the checksum
                act.corrupt = True
                act.corrupt_at = rng.random()
                act.corrupt_bit = rng.randrange(8)
                self._log(
                    "corrupt", env,
                    at=round(act.corrupt_at, 6), bit=act.corrupt_bit,
                )
                hit = True
        return act if hit else None

    def corrupt_frame_parts(self, parts: list, act: ChaosAction) -> list:
        """Flip one bit of the frame's PAYLOAD segment — the float bytes
        the tag-2/3 checksum covers. The payload is the unique
        ``memoryview`` segment of ``encode_frame_parts`` (headers, dest and
        the trace trailer are ``bytes``); a frame may also END with the
        trace trailer, so "last part" would miss. The segment is COPIED
        first: the original is a zero-copy view of engine memory, and
        chaos must corrupt the wire, never the engine."""
        parts = list(parts)
        views = [
            i for i, p in enumerate(parts) if isinstance(p, memoryview)
        ]
        if len(views) == 1:
            target = views[0]
        else:  # fall back to the largest segment (the payload dominates)
            target = max(range(len(parts)), key=lambda i: len(parts[i]))
        buf = bytearray(parts[target])
        if buf:
            i = min(int(act.corrupt_at * len(buf)), len(buf) - 1)
            buf[i] ^= 1 << act.corrupt_bit
            parts[target] = bytes(buf)
        return parts


def membership_schedule(
    seed: int,
    nodes: int,
    steps: int,
    *,
    flap_p: float = 0.03,
    flap_len: tuple[int, int] = (3, 8),
) -> dict[int, frozenset[int]]:
    """Seeded membership chaos for the soak loop (``soak --chaos SEED``).

    Returns ``{step: frozenset(silent node ids)}`` — per step, which nodes
    withhold their heartbeat. Each node other than 0 independently enters
    silence windows (probability ``flap_p`` per step, uniform length in
    ``flap_len``); node 0 never flaps, so the cluster always has a
    survivor. A pure function of its arguments: the same seed replays the
    same churn.
    """
    rng = random.Random(_derive_seed(seed, MASTER_ROLE, 0, "membership"))
    silent: dict[int, set[int]] = {}
    lo, hi = flap_len
    for k in range(1, nodes):
        step = 0
        while step < steps:
            if rng.random() < flap_p:
                span = rng.randint(lo, hi)
                for s in range(step, min(step + span, steps)):
                    silent.setdefault(s, set()).add(k)
                step += span
            else:
                step += 1
    return {s: frozenset(v) for s, v in silent.items()}


def leader_kill_step(seed: int, steps: int) -> int | None:
    """Seeded step at which the soak's simulated control-plane leader dies
    (the leader-kill entry of ``soak --chaos SEED``'s schedule).

    A pure function of its arguments — the same seed replays the same
    kill. Lands in the middle 40-60% of the run so checkpoint and
    membership churn exist on both sides of the failover; ``None`` for
    runs too short to fit a leaderless window plus recovery."""
    if steps < 20:
        return None
    rng = random.Random(_derive_seed(seed, MASTER_ROLE, 1, "leader_kill"))
    return int(steps * (0.4 + 0.2 * rng.random()))
