"""Remote transport: asyncio TCP delivery of control-plane envelopes (the
port's own copy of the JAX package's ``control/remote.py``).

The reference's L0 is Akka remoting — ``ActorSelection ! msg`` serialized by
Netty onto TCP (SURVEY.md §2 L0). This is the same layer, idiomatic Python:
each process runs one ``RemoteTransport`` = one inbound TCP server + a pool of
outbound connections + a single-consumer delivery loop, so every local handler
processes one message at a time (the actor guarantee the reference's buffers
rely on — SURVEY.md §6 "Race detection": actor model, buffers actor-private).

Routing mirrors ``LocalRouter`` (control/local.py) but resolves non-local
addresses to endpoints: exact routes ("master" -> seed) and prefix resolvers
("worker:<id>" -> the owning node's endpoint via the address book). Delivery
is at-most-once: a dead or unknown destination drops the message — exactly the
reference's remoting semantics, and what the threshold design expects
(SURVEY.md §4.2: rounds complete at threshold, never wait for lost messages).

Data plane (zero-copy, both directions):

- **send**: frames are scatter-gather segment lists from
  ``wire.encode_frame_parts`` — the float payload segment is a ``memoryview``
  of the engine's array — handed to ``socket.sendmsg`` (writev), so the
  kernel gathers header + payload with NO user-space concatenation copy.
  Small control frames coalesce into a per-connection buffer flushed on the
  next event-loop pass (or as the prefix of the next big send), so a burst
  of heartbeats/acks costs one syscall, not one each.
- **receive**: a ``BufferedProtocol`` reads each frame body straight into a
  pooled preallocated buffer via the event loop's ``recv_into`` (no
  per-frame ``bytes`` allocation, no readexactly join copy), and the decoded
  float payloads are ``np.frombuffer`` views INTO that buffer. A buffer
  returns to the pool only after the handler has run and no decoded view
  still aliases it (checked via the bytearray export count), so zero-copy
  can never turn into use-after-recycle.

Payloads on the card (the port's): a transport built with a CUDA ``device``
copies each outbound Scatter/ReduceBlock value to the host when the message
is sent, on the event loop's current stream (``wire.to_host``, the
``d2h`` stage timer), before any deferred encode on a sender thread, so a
frame holds the values the message held when it was sent and no side
thread ever reads memory on the card. Inbound payload values are copied
onto the device before the handler runs (the ``h2d`` stage timer); that
copy is synchronous from pageable memory, so the receive buffer is free
again when it returns. Counts, flags and every decision stay on the host.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import errno as _errno
import logging
import random
import select
import socket
import struct
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Awaitable, Callable

from akka_allreduce_tpu_torch import native
from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.config import RetryPolicy
from akka_allreduce_tpu_torch.control import wire
from akka_allreduce_tpu_torch.control.cluster import Endpoint
from akka_allreduce_tpu_torch.control.stripes import StripeScheduler
from akka_allreduce_tpu_torch.control.envelope import Envelope
from akka_allreduce_tpu_torch.obs import flight as _flight
from akka_allreduce_tpu_torch.obs import metrics as _metrics
from akka_allreduce_tpu_torch.obs import trace as _trace
from akka_allreduce_tpu_torch.protocol import ReduceBlock, ScatterBlock

log = logging.getLogger(__name__)

# Silent-loss accounting (OBSERVABILITY.md): every drop path increments a
# registry counter alongside the per-transport ``dropped`` total, so message
# loss is countable per CAUSE across the process. Module-level: counter
# lookups stay off the hot path.
_DROP_UNDECODABLE = _metrics.counter("transport.dropped.undecodable")
_DROP_NO_ROUTE = _metrics.counter("transport.dropped.no_route")
_DROP_NO_HANDLER = _metrics.counter("transport.dropped.no_handler")
_DROP_OVERSIZE = _metrics.counter("transport.dropped.oversize_frame")
_DROP_EMPTY = _metrics.counter("transport.dropped.empty_frame")
_DROP_FILTERED = _metrics.counter("transport.dropped.drop_filter")
_DROP_BACKPRESSURE = _metrics.counter("transport.dropped.backpressure")
_DROP_SEND_FAILED = _metrics.counter("transport.dropped.send_failed")
_DROP_CHAOS = _metrics.counter("transport.dropped.chaos")
_DELIVERED = _metrics.counter("transport.delivered")
_HANDLER_ERRORS = _metrics.counter("transport.handler_errors")
# every reconnect-retry any sender performed in this process (a flight dump
# must show WHY a peer was declared dead — the per-endpoint detail rides the
# pull-time collector below)
_RECONNECTS = _metrics.counter("remote.endpoint_reconnects")

Handler = Callable[[Any], list[Envelope]]
PrefixHandler = Callable[[int, Any], list[Envelope]]
_U32 = wire._U32

# Frames at or below this many bytes coalesce into the sender queue's tail
# entry (one small memcpy) instead of costing an iovec slot and a frame entry
# each; payload frames are far above it and always go vectored.
_COALESCE_MAX = 1024

# Size bound of one coalesce entry — a burst larger than this just starts a
# new entry (still one sendmsg, one extra iovec slot).
_COALESCE_ENTRY_MAX = 64 << 10

# Kernel socket buffer request for both directions: payload frames are
# MB-scale, and the kernel buffer is the send pipeline now that frames go
# straight from engine memory to the socket (no user-space staging copy) —
# the default ~208 KB would cost several writability round-trips per frame.
_SOCK_BUF_BYTES = 4 << 20

# Pump-pool sizing cap (DataPlaneConfig.pump_pool = 0 -> auto: streams x
# live endpoints, capped here) — the pool offloads INBOUND decode+checksum
# of state-transfer-scale bodies (>= _DECODE_OFFLOAD_MIN); the SEND side
# never touches it (each payload stream has a dedicated sender thread).
_PUMP_POOL_CAP = 8

# SO_SNDTIMEO slice for the pump-pool's blocking sockets: each syscall
# blocks at most this long, so a worker thread re-checks the sender's
# closed flag (teardown) and its progress deadline at this cadence. The
# OVERALL stall bound stays connect_timeout_s, exactly like the event-loop
# writers' per-writability-wait timeout.
_SEND_SLICE_S = 1.0

# Messages striped across payload streams by chunk id (everything else —
# Prepare/Start/epoch fencing, membership, state transfer — stays on the
# ordering-preserving stream 0).
_STRIPED_TYPES = (ScatterBlock, ReduceBlock)

# Sequence gaps observed on inbound payload streams: a gap means a peer's
# reconnect dropped frames mid-stream (at-most-once absorbs the loss; the
# counter makes it visible per process).
_STREAM_SEQ_GAPS = _metrics.counter("transport.stream_seq_gaps")

# io_uring submission accounting (OBSERVABILITY.md): ring submissions the
# sender threads made, and runtime fallbacks — a kernel that probed fine but
# rejects the first real submit (5.1/5.2) latches the transport back to the
# sendmmsg/sendmsg path and counts it here, once.
_URING_SUBMITS = _metrics.counter("uring.submits")
_URING_FALLBACKS = _metrics.counter("uring.fallbacks")

# Intra-chunk striping accounting: sub-chunk continuation frames sent, whole
# frames reassembled from stripes, and assemblies evicted half-built (a
# sender died mid-frame; bounded by _FRAG_ASM_MAX so a lossy peer cannot
# grow assembly buffers forever).
_FRAGS_SENT = _metrics.counter("transport.frags_sent")
_FRAGS_REASSEMBLED = _metrics.counter("transport.frags_reassembled")
_DROP_FRAG_STALE = _metrics.counter("transport.dropped.frag_stale")

# In-flight fragment assemblies per transport: each holds one pooled
# frame-sized buffer, so the cap bounds memory against a peer whose stripes
# never complete (dead sender mid-frame, sustained loss).
_FRAG_ASM_MAX = 32

# Inbound payload bodies at least this big decode in a pump-pool thread;
# smaller ones decode inline on the event loop. The crossover is where the
# native checksum+frombuffer pass outweighs an executor hop on a CONTENDED
# box (~100µs of queue/wake/GIL): measured on the pair cluster, offloading
# 1-2MB frames (round-payload scale — a 1M-float vector reduce-scattered
# over 2 nodes is a 2MB chunk) lost ~10-20% throughput, so the bar sits at
# state-transfer blob scale, strictly above round payloads.
_DECODE_OFFLOAD_MIN = 4 << 20


def _byte_views(parts) -> list[memoryview]:
    return [
        p if isinstance(p, memoryview) else memoryview(p) for p in parts
    ]


def observed_task(coro, *, name: str) -> asyncio.Task:
    """``create_task`` with a done-callback that logs a crashed task.

    The event loop holds only a weak reference to tasks, and an un-retained
    handle can be garbage-collected mid-flight; worse, a retained-but-never-
    awaited background task (pump, writer, heartbeat ticker) that dies on an
    unexpected exception dies SILENTLY — the transport just stops moving
    messages. Every background spawn in this package goes through here
    (arlint ASYNC003 enforces the shape), so a crash is at least an ERROR
    log with the task's name before the silence. The task is also strongly
    referenced in a module-level set until done — the helper must CLOSE the
    weak-reference hole, not depend on every caller retaining the return
    value."""
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _observed_tasks.add(task)

    def _done(t: asyncio.Task) -> None:
        _observed_tasks.discard(t)
        if t.cancelled():
            return  # cancellation is the normal teardown path
        exc = t.exception()
        if exc is not None:
            log.error("background task %r died: %r", name, exc)

    task.add_done_callback(_done)
    return task


_observed_tasks: set[asyncio.Task] = set()


# Every live transport's per-instance accounting, folded into REGISTRY
# snapshots by one pull-time collector: the hot paths keep their plain dict
# float-adds, the registry absorbs them only when somebody asks.
_live_transports: "weakref.WeakSet" = weakref.WeakSet()


def _collect_transport_stats() -> dict:
    stages: dict[str, float] = {}
    delivered = dropped = 0
    endpoints: dict[str, dict] = {}

    def _rec(key: str) -> dict:
        return endpoints.setdefault(
            key,
            {
                "reconnects": 0, "backoff_s": 0.0,
                "tx_bytes": 0, "rx_bytes": 0, "stream_count": 0,
            },
        )

    for t in list(_live_transports):
        # list() snapshots throughout: sender THREADS insert keys into
        # these dicts concurrently, and a collector that dies mid-iteration
        # ("dictionary changed size") would silently drop the whole
        # transport stats section from that dump
        for k, v in list(t.stage_seconds.items()):
            stages[k] = stages.get(k, 0.0) + v
        delivered += t.delivered
        dropped += t.dropped
        for ep, n in list(t.endpoint_reconnects.items()):
            rec = _rec(f"{ep.host}:{ep.port}")
            rec["reconnects"] += n
            rec["backoff_s"] = max(
                rec["backoff_s"], t.endpoint_backoff.get(ep, 0.0)
            )
        # bandwidth telemetry (the ROADMAP "feed bandwidth in as evidence"
        # follow-on): bytes moved per peer endpoint plus how many stream
        # connections are live right now (outbound sender sockets, or
        # preamble-identified inbound streams — whichever direction this
        # process has)
        for key, v in list(t.endpoint_tx.items()):
            _rec(key)["tx_bytes"] += v
        for key, v in list(t.endpoint_rx.items()):
            _rec(key)["rx_bytes"] += v
        live_out: dict[str, int] = {}
        for (ep, _stream), snd in list(t._senders.items()):
            if snd.sock is not None:
                k = f"{ep.host}:{ep.port}"
                live_out[k] = live_out.get(k, 0) + 1
        for key, n in live_out.items():
            rec = _rec(key)
            rec["stream_count"] = max(rec["stream_count"], n)
        for key, n in list(t._rx_streams.items()):
            rec = _rec(key)
            rec["stream_count"] = max(rec["stream_count"], n)
    out = {
        f"transport.stage_seconds.{k}": round(v, 6) for k, v in stages.items()
    }
    out["transport.instances"] = len(list(_live_transports))
    out["transport.delivered_live"] = delivered
    out["transport.dropped_live"] = dropped
    # per-endpoint escalation state: how many reconnect-retries this process
    # burned against each peer and the backoff currently in force — the
    # flight-recorder's "why was this peer declared dead" line — plus the
    # bandwidth gauges above
    for key, rec in sorted(endpoints.items()):
        out[f"transport.endpoint.{key}.reconnects"] = rec["reconnects"]
        out[f"transport.endpoint.{key}.backoff_s"] = round(
            rec["backoff_s"], 4
        )
        out[f"transport.endpoint.{key}.tx_bytes"] = rec["tx_bytes"]
        out[f"transport.endpoint.{key}.rx_bytes"] = rec["rx_bytes"]
        out[f"transport.endpoint.{key}.stream_count"] = rec["stream_count"]
    return out


_metrics.REGISTRY.register_collector(_collect_transport_stats)


class _Frame:
    """One queued outbound frame: segments + the envelope(s) it carries.

    Payload-stream frames defer their encode to the pump pool: ``parts``
    stays ``None`` and ``encode_job`` carries ``(env, tctx, mode,
    chaos_act)`` until the worker thread runs the encode + checksum pass
    just before the batch syscall (``nbytes`` is exact anyway —
    ``wire.payload_frame_nbytes`` — so backpressure accounting is charged
    at enqueue time)."""

    __slots__ = (
        "parts", "envs", "nbytes", "coalesced", "inflight", "encode_job",
        "frag",
    )

    def __init__(self, parts: list | None, envs: list, nbytes: int, coalesced: bool) -> None:
        self.parts = parts
        self.envs = envs
        self.nbytes = nbytes
        self.coalesced = coalesced
        # set once the writer exports this frame's buffers into a sendmsg
        # batch: no further merging (a resize with live exports raises
        # BufferError) and no backpressure drop (stream would desync)
        self.inflight = False
        self.encode_job: tuple | None = None
        # intra-chunk stripe: (shared encode, frag_id, total_len, offset,
        # length) — this frame carries bytes [offset, offset+length) of one
        # split payload frame's body behind a continuation header
        self.frag: tuple | None = None


class _SharedEncode:
    """One deferred encode shared by every stripe of a split payload frame.

    The stripes ride DIFFERENT sender threads; whichever reaches its batch
    first runs the encode + checksum (and any chaos corruption — applied to
    the WHOLE frame once, so a corrupt fault hits the reassembled bytes
    exactly as it would an unsplit frame) under the lock, and the rest
    slice the same segment list. The payload views alias the engine's
    memory — splitting adds framing bytes, never a payload copy.

    NB every stripe's _Frame carries the SAME envelope, so per-send
    accounting is per STRIPE for a split frame: on_send_ok fires up to
    nstripes times, a lost stripe counts one drop, and a partially failed
    split can emit both ok and error callbacks for one logical send.
    Today's consumers are type-filtered (the statetransfer repair path
    keys on ChunkData/ReplicaManifest, which never split; the rejoin
    counter keys on master destinations), so the multiplicity on payload
    frames is inert — a future consumer keying per-envelope semantics off
    payload-frame callbacks must dedupe here first."""

    __slots__ = ("lock", "env", "tctx", "mode", "act", "parts")

    def __init__(self, env: Envelope, tctx, mode: str, act) -> None:
        self.lock = threading.Lock()
        self.env = env
        self.tctx = tctx
        self.mode = mode
        self.act = act
        self.parts: list | None = None

    def ensure(self, transport: "RemoteTransport") -> tuple[list, float]:
        """(encoded parts, encode seconds charged to THIS caller — zero
        for every stripe after the first)."""
        with self.lock:
            if self.parts is not None:
                return self.parts, 0.0
            t0 = time.perf_counter()
            parts = wire.encode_frame_parts(
                self.env.dest, self.env.msg, wire=self.mode, trace=self.tctx
            )
            act = self.act
            if act is not None and act.corrupt and transport.chaos is not None:
                parts = transport.chaos.corrupt_frame_parts(parts, act)
            self.parts = parts
            return parts, time.perf_counter() - t0


class _FragAssembly:
    """One split frame mid-reassembly: a pooled frame-sized buffer the
    stripes land in directly (each fragment recv_intos its own byte range
    — no join copy ever happens), plus the received-byte watermark.

    ``seen`` records each counted stripe's offset: a sender's partial-
    batch reconnect RESENDS already-delivered stripes (identical bytes —
    the shared encode is cached), and counting one twice would complete
    the assembly with another stripe's range still unwritten. ``writers``
    counts connections currently in direct-mode recv INTO this buffer, so
    completion never pools a buffer a late duplicate is still writing."""

    __slots__ = ("buf", "total", "got", "seen", "writers")

    def __init__(self, buf: bytearray, total: int) -> None:
        self.buf = buf
        self.total = total
        self.got = 0
        self.seen: set[int] = set()
        self.writers = 0


class _Sender:
    """Per-endpoint outbound state: a frame queue drained by ONE writer task.

    ``send`` enqueues frame segments (zero-copy views of engine memory) and
    returns; the writer connects lazily and drains the queue with
    multi-frame vectored ``sendmsg`` calls — the queue is the pipeline, so
    the pump keeps decoding/handling while the kernel drains bytes. Small
    control frames coalesce into the queue's tail entry (one tiny memcpy)
    instead of costing an iovec slot and a wakeup each.
    """

    __slots__ = (
        "queue", "queued_bytes", "sock", "writer_task", "attempts",
        "waiters", "closed", "stream_id", "seq", "need_preamble",
        "cond", "thread", "uring",
    )

    def __init__(self, stream_id: int = 0) -> None:
        self.queue: "deque[_Frame]" = deque()
        self.queued_bytes = 0
        self.sock: socket.socket | None = None
        self.writer_task: asyncio.Task | None = None
        # payload-stream senders (stream_id >= 1) are drained by a DEDICATED
        # thread, not a loop task: cond guards queue/queued_bytes/inflight
        # across the loop/thread boundary and wakes the thread on enqueue
        self.cond = threading.Condition()
        self.thread: threading.Thread | None = None
        # consecutive failures in the CURRENT burst (connect or send); a
        # burst may consume up to RetryPolicy.max_retries reconnect-resend
        # cycles (exponential backoff + full jitter) before the queue is
        # declared dead. Reset to zero by any successfully sent batch.
        self.attempts = 0
        self.waiters: list[asyncio.Future] = []
        self.closed = False
        # multi-stream state: which stream of the endpoint this sender is
        # (0 = control, >=1 = payload), the next per-stream sequence number
        # (scoped to one connection on the receive side — a reconnect
        # resets the peer's expectation), and whether the next batch must
        # open with the stream preamble (set at connect when streams > 1)
        self.stream_id = stream_id
        self.seq = 0
        self.need_preamble = False
        # io_uring submission ring (DataPlaneConfig.uring): created and
        # closed by the OWNING sender thread — rings are never shared
        self.uring = None

    def close_sock(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:  # pragma: no cover - close is best effort
                pass
            self.sock = None

    def close(self) -> None:
        self.closed = True
        task = self.writer_task
        if (
            task is not None
            and not task.done()
            and task is not asyncio.current_task()
        ):
            task.cancel()
        self.close_sock()
        self.queue.clear()
        self.queued_bytes = 0
        self.wake_waiters()

    def wake_waiters(self) -> None:
        for fut in self.waiters:
            if not fut.done():
                fut.set_result(None)
        self.waiters.clear()


class _FrameReceiver(asyncio.BufferedProtocol):
    """Inbound framing over a preallocated receive ring.

    The event loop ``recv_into``s a fixed ring buffer (no per-frame
    ``bytes``), and every COMPLETE frame in it is parsed per recv — a
    coalesced burst of control frames costs one syscall, not one each.
    Small bodies decode via a tiny copy out of the ring (control messages
    and sub-16KB payloads — the ring is reused, so views must not alias
    it); payload-scale bodies switch the protocol to direct mode, where
    the remainder of the body is received straight into a pooled
    frame-sized buffer and decode hands the engine zero-copy views INTO
    that buffer (recycled only once no view aliases it)."""

    _RING_BYTES = 64 << 10
    # bodies at/below this are served out of the ring (one small memcpy);
    # anything larger gets a dedicated pooled buffer and zero-copy decode
    _SMALL_BODY_MAX = 16 << 10

    def __init__(self, owner: "RemoteTransport") -> None:
        self._owner = owner
        self._ring = bytearray(self._RING_BYTES)
        self._rlen = 0  # valid bytes at the ring's start
        self._body: bytearray | None = None  # direct-mode target buffer
        self._need = 0
        self._got = 0
        # direct mode lands bytes at [base+got, base+need) of _body: base
        # stays 0 for whole frame bodies; a sub-chunk continuation frame
        # (intra-chunk striping) sets it to the fragment's offset in the
        # shared assembly buffer, with _frag_info = (key, assembly,
        # fragment length) so completion can advance the reassembly
        self._body_base = 0
        self._frag_info: tuple | None = None
        self._transport: asyncio.Transport | None = None
        # multi-stream state: the first 4 bytes of a connection decide its
        # framing (STREAM_MAGIC's 0xFFFFFFFF prefix can never be a legal
        # legacy length) — until then the connection is unsniffed
        self._sniffed = False
        self._stream_id = 0  # >=1: payload stream ([u32 len][u32 seq] frames)
        self._peer_key: str | None = None  # telemetry key (host:port)
        self._rx_registered = False
        # rx bytes counted BEFORE the framing sniff resolves the peer's
        # canonical key (a stream preamble may rename the connection)
        self._pending_rx = 0
        # per-connection ordered decode pipeline (streams > 1 only):
        # frames decode in arrival order, but connection A's checksum pass
        # runs in a pump-pool thread while the loop serves connection B.
        # _decode_busy counts frames handed to the queue and not yet
        # delivered — while nonzero, inline decode would overtake them.
        self._decode_q: "asyncio.Queue | None" = None
        self._decode_task: asyncio.Task | None = None
        self._decode_busy = 0

    def connection_made(self, transport) -> None:
        self._transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            try:  # payload frames are MB-scale: a roomy kernel buffer keeps
                # the sender streaming instead of bouncing on EAGAIN
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF_BYTES
                )
            except OSError:  # pragma: no cover - kernel may clamp/refuse
                pass
        # rx telemetry stays UNKEYED until a stream preamble names the
        # peer's canonical endpoint: the TCP peername port is ephemeral,
        # so keying by it would grow endpoint_rx by one dead entry per
        # inbound connection forever (reconnect churn = unbounded memory
        # and metric cardinality). Legacy connections (streams=1, or
        # pre-Welcome joins) never send a preamble and contribute no
        # per-endpoint rx rows — exactly the pre-round-8 behavior.
        self._owner._server_conns.add(transport)

    def connection_lost(self, exc) -> None:
        self._owner._server_conns.discard(self._transport)
        if self._frag_info is not None:
            # a fragment died mid-direct-recv: release the write claim so
            # the assembly's eventual completion can pool its buffer
            self._frag_info[1].writers -= 1
            self._frag_info = None
            self._body = None
            self._body_base = 0
        if self._rx_registered and self._peer_key is not None:
            n = self._owner._rx_streams.get(self._peer_key, 1) - 1
            if n <= 0:
                self._owner._rx_streams.pop(self._peer_key, None)
            else:
                self._owner._rx_streams[self._peer_key] = n
            self._rx_registered = False
        if self._decode_q is not None:
            self._decode_q.put_nowait(None)  # drain, then end the pump

    def eof_received(self) -> bool:
        return False  # close the transport; at-most-once, nothing to recover

    def get_buffer(self, sizehint: int) -> memoryview:
        if self._body is not None:
            base = self._body_base
            return memoryview(self._body)[base + self._got : base + self._need]
        # the BufferedProtocol contract REQUIRES handing out this view: the
        # event loop recv_intos it and reports back via buffer_updated before
        # the ring is ever parsed or compacted, so the view cannot outlive a
        # recycle — and decoded messages never alias the ring (small bodies
        # are copied out, large ones land in pooled per-frame buffers)
        return memoryview(self._ring)[self._rlen :]  # arlint: disable=BUF001

    def buffer_updated(self, nbytes: int) -> None:
        owner = self._owner
        if self._sniffed:
            owner._note_rx(self._peer_key, nbytes)
        else:
            # held until the framing sniff lands on this connection's
            # canonical telemetry key (the preamble may rename it)
            self._pending_rx += nbytes
        if self._body is not None:  # direct mode: body lands in its buffer
            self._got += nbytes
            if self._got < self._need:
                return
            body, need = self._body, self._need
            frag = self._frag_info
            self._body = None
            self._body_base = 0
            self._frag_info = None
            if frag is not None:
                # one stripe of a split frame finished: advance the shared
                # assembly; the whole frame delivers when the last stripe
                # (whichever stream it rode) completes the byte count
                key, rec, offset, frag_len = frag
                rec.writers -= 1
                owner._frag_advance(self, key, rec, offset, frag_len)
                return
            self._deliver(body, need, pooled=body)
            return
        self._rlen += nbytes
        ring = self._ring
        pos = 0
        if not self._sniffed:
            if self._rlen < 4:
                return
            if ring[:4] != b"\xff\xff\xff\xff":
                self._sniffed = True  # legacy framing, no preamble
                owner._note_rx(self._peer_key, self._pending_rx)
                self._pending_rx = 0
            else:
                try:
                    res = wire.parse_stream_preamble(
                        memoryview(ring)[: self._rlen]
                    )
                except ValueError:
                    log.warning("bad stream preamble; closing connection")
                    owner.dropped += 1
                    _DROP_UNDECODABLE.inc()
                    assert self._transport is not None
                    self._transport.close()
                    return
                if res is None:
                    return  # preamble incomplete: wait for more bytes
                stream_id, _total, host, port, consumed = res
                self._sniffed = True
                self._stream_id = stream_id
                self._peer_key = f"{host}:{port}"
                owner._note_rx(self._peer_key, self._pending_rx)
                self._pending_rx = 0
                owner._rx_streams[self._peer_key] = (
                    owner._rx_streams.get(self._peer_key, 0) + 1
                )
                self._rx_registered = True
                pos = consumed
        hdr = 8 if self._stream_id >= 1 else 4
        while True:
            avail = self._rlen - pos
            if avail < hdr:
                break
            (length,) = _U32.unpack_from(ring, pos)
            if length > owner.max_frame_bytes:
                # a corrupt/hostile length prefix must not make us buffer
                # gigabytes; drop the connection (the peer's framing is
                # gone — nothing after this parses)
                log.warning(
                    "frame length %d exceeds limit %d; closing connection",
                    length,
                    owner.max_frame_bytes,
                )
                owner.dropped += 1
                _DROP_OVERSIZE.inc()
                assert self._transport is not None
                self._transport.close()
                return
            # NB the seq check must run exactly ONCE per frame — only on
            # the paths that CONSUME the header. An incomplete small body
            # breaks out with pos unmoved, so its header is re-parsed on
            # the next recv: checking here would advance the expectation
            # twice and count a bogus gap for a frame that merely straddled
            # a TCP read boundary.
            if length == 0:
                if hdr == 8:
                    self._check_seq(_U32.unpack_from(ring, pos + 4)[0])
                owner.dropped += 1  # vacuous frame: nothing to decode
                _DROP_EMPTY.inc()
                pos += hdr
                continue
            if self._stream_id >= 1 and length >= 2 and avail < hdr + 2:
                # a payload-stream body's first two bytes decide its shape
                # (0xFFFF = sub-chunk continuation, anything else a whole
                # frame's dest-length prefix) — never enter direct mode
                # before the peek, or a fragment's bytes would land in a
                # whole-frame buffer and decode as garbage
                break
            if (
                self._stream_id >= 1
                # a real continuation frame is always longer than its
                # header — the bound also keeps the 2-byte peek inside
                # the guard above (a length-1 body would otherwise read
                # one byte past what this frame owns)
                and length > wire.FRAG_HDR_LEN
                and ring[pos + hdr] == 0xFF
                and ring[pos + hdr + 1] == 0xFF
            ):
                nxt = self._begin_fragment(ring, pos, avail, hdr, length)
                if nxt == -2:
                    return  # protocol error: connection closed
                if nxt == -1:
                    break  # continuation header straddles the recv: wait
                pos = nxt
                if self._body is not None:
                    break  # fragment tail arrives in direct mode
                continue
            if length > self._SMALL_BODY_MAX:
                if hdr == 8:
                    self._check_seq(_U32.unpack_from(ring, pos + 4)[0])
                body = owner._acquire_recv_buf(length)
                got = min(avail - hdr, length)
                body[:got] = memoryview(ring)[pos + hdr : pos + hdr + got]
                pos += hdr + got
                if got == length:  # whole body was already buffered
                    self._deliver(body, length, pooled=body)
                    continue
                # switch to direct mode: the rest of the body is received
                # straight into the frame buffer — by construction nothing
                # can follow an incomplete body in the ring
                self._body, self._need, self._got = body, length, got
                break
            if avail - hdr < length:
                break  # incomplete small body: wait for more bytes
            if hdr == 8:
                self._check_seq(_U32.unpack_from(ring, pos + 4)[0])
            # small frame fully buffered: decode via a tiny copy so its
            # decoded views can never alias the (reused) ring
            frame = bytes(memoryview(ring)[pos + hdr : pos + hdr + length])
            pos += hdr + length
            self._deliver(frame, length, pooled=None)
        if pos:  # compact the unconsumed tail to the ring's start
            rest = self._rlen - pos
            if rest:
                ring[:rest] = ring[pos : self._rlen]
            self._rlen = rest

    def _check_seq(self, seq: int) -> None:
        """Per-stream sequence discipline. The expectation lives on the
        OWNER keyed by (peer endpoint, stream id) so it SURVIVES
        reconnects — within one TCP connection a gap is impossible
        (ordered byte stream), so per-connection state would be
        structurally blind to the only loss that can happen: a sender
        whose retry budget died mid-queue is rebuilt with seq=0, and a
        partial-batch reconnect re-stamps its resent frames. Either way
        the cross-connection discontinuity is counted (at-most-once
        absorbs the loss/duplication; the counter makes the disruption
        visible), then the expectation resynchronizes."""
        key = (self._peer_key, self._stream_id)
        expect = self._owner._rx_seq_expect.get(key)
        if expect is not None and seq != expect:
            _STREAM_SEQ_GAPS.inc()
            log.warning(
                "stream %d from %s: sequence discontinuity "
                "(expected %d, got %d)",
                self._stream_id, self._peer_key, expect, seq,
            )
        self._owner._rx_seq_expect[key] = (seq + 1) & 0xFFFF_FFFF

    def _begin_fragment(
        self, ring: bytearray, pos: int, avail: int, hdr: int, length: int
    ) -> int:
        """Consume one sub-chunk continuation frame's header + whatever of
        its bytes the ring already holds, landing them at the fragment's
        offset in the shared assembly buffer. Returns the new parse
        position; -1 = header incomplete (wait for more bytes, nothing
        consumed); -2 = protocol error, connection closed. Leaves the
        connection in direct mode (``_body`` set) when the fragment's tail
        is still in flight."""
        owner = self._owner
        if avail - hdr < wire.FRAG_HDR_LEN:
            return -1
        try:
            if length <= wire.FRAG_HDR_LEN:
                raise ValueError(f"continuation frame of {length} bytes")
            frag_id, total, offset = wire.parse_frag_header(
                memoryview(ring)[pos + hdr : pos + hdr + wire.FRAG_HDR_LEN]
            )
            frag_len = length - wire.FRAG_HDR_LEN
            if offset + frag_len > total:
                raise ValueError("fragment overruns its frame body")
            if total > owner.max_frame_bytes:
                raise ValueError(f"reassembled frame of {total} bytes")
        except ValueError as exc:
            # a malformed continuation header means this stream's framing
            # can no longer be trusted (an offset lie would corrupt a
            # shared assembly buffer): drop the connection, like oversize
            log.warning("bad continuation frame (%s); closing connection", exc)
            owner.dropped += 1
            _DROP_UNDECODABLE.inc()
            assert self._transport is not None
            self._transport.close()
            return -2
        self._check_seq(_U32.unpack_from(ring, pos + 4)[0])
        rec = owner._frag_get((self._peer_key, frag_id), total)
        if rec is None:
            log.warning(
                "continuation frame total mismatch from %s; closing",
                self._peer_key,
            )
            owner.dropped += 1
            _DROP_UNDECODABLE.inc()
            assert self._transport is not None
            self._transport.close()
            return -2
        body_off = pos + hdr + wire.FRAG_HDR_LEN
        got = min(avail - hdr - wire.FRAG_HDR_LEN, frag_len)
        if got:
            rec.buf[offset : offset + got] = memoryview(ring)[
                body_off : body_off + got
            ]
        if got == frag_len:
            owner._frag_advance(
                self, (self._peer_key, frag_id), rec, offset, frag_len
            )
            return body_off + got
        # direct mode into the assembly buffer at the fragment's remaining
        # range — by construction nothing can follow an incomplete body
        self._body = rec.buf
        self._body_base = offset
        self._got = got
        self._need = frag_len
        rec.writers += 1
        self._frag_info = ((self._peer_key, frag_id), rec, offset, frag_len)
        return body_off + got

    def _deliver(self, buf, need: int, *, pooled: bytearray | None) -> None:
        owner = self._owner
        if (
            owner._pool_enabled()
            and (need >= _DECODE_OFFLOAD_MIN or self._decode_busy)
        ):
            # body big enough that the checksum pass beats the thread-hop
            # cost: decode in a pump-pool thread via the connection's
            # ordered queue. This includes STREAM 0 — state-transfer
            # chunks (the >=4MB bodies the pool exists for) ride the
            # control stream, and the per-connection FIFO queue below
            # preserves its ordering guarantees: frames decode strictly
            # in arrival order, only on another thread. Smaller frames
            # decode inline on the loop (measured: at ~1MB frames on a
            # contended box the executor hop LOSES to the native checksum
            # it offloads) — UNLESS an offloaded decode is still in
            # flight, in which case they queue behind it so the
            # connection never reorders. streams=1 never offloads (the
            # pool is off), keeping the legacy plane byte- and
            # behavior-identical.
            if self._decode_q is None:
                self._decode_q = asyncio.Queue()
                # lifecycle is owner-transferred, not protocol-owned: the
                # task joins owner._decoder_tasks (cancelled in the
                # transport's stop()) and connection_lost() ends the pump
                # by queueing the None sentinel
                self._decode_task = observed_task(  # arlint: disable=LIFE001 -- owner-transferred
                    owner._decode_pump(self._decode_q, self),
                    name=f"decode-{self._peer_key}-s{self._stream_id}",
                )
                owner._decoder_tasks.add(self._decode_task)
                self._decode_task.add_done_callback(
                    owner._decoder_tasks.discard
                )
            self._decode_busy += 1
            self._decode_q.put_nowait((buf, need, pooled))
            return
        try:
            dest, msg, tctx = owner._decode_timed(buf, need)
        except Exception as exc:  # malformed body: drop THIS frame
            # framing is length-prefixed, so the stream stays in sync —
            # one bad message must not kill the connection
            log.warning("undecodable frame (%s); dropping", exc)
            owner.dropped += 1
            _DROP_UNDECODABLE.inc()
            if pooled is not None:
                owner._release_recv_buf(pooled)
            return
        owner._inbox.put_nowait((dest, msg, pooled, tctx))


class RemoteTransport:
    """One process's transport: local handlers + remote routes."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        connect_timeout_s: float = 5.0,
        device=None,  # str | torch.device | None
    ) -> None:
        self._host = host
        # the engine's device: payloads bound for the wire leave it at send
        # time and payloads off the wire land on it before the handler runs
        # (None or the CPU: payloads stay where they are)
        self.device = None if device is None else resolve_device(device)
        self._on_card = self.device is not None and self.device.type != "cpu"
        self._port = port
        self.connect_timeout_s = connect_timeout_s
        self._server: asyncio.Server | None = None
        self._handlers: dict[str, Handler] = {}
        self._prefix_handlers: dict[str, PrefixHandler] = {}
        self._routes: dict[str, Endpoint] = {}
        self._prefix_routes: dict[str, Callable[[int], Endpoint | None]] = {}
        # one sender per (endpoint, stream): stream 0 is the legacy control
        # connection, streams 1..N-1 the payload stripes
        self._senders: dict[tuple[Endpoint, int], _Sender] = {}
        self._server_conns: set = set()
        self._inbox: asyncio.Queue[
            tuple[str, Any, bytearray | None]
        ] = asyncio.Queue()
        self._pump: asyncio.Task | None = None
        self._recv_pool: list[bytearray] = []
        self.delivered = 0
        self.dropped = 0
        self.on_send_error: Callable[[Endpoint, Envelope], None] | None = None
        # called after a frame reaches the socket buffer — lets callers treat
        # failure counts as CONSECUTIVE (reset on success) rather than
        # cumulative-since-forever
        self.on_send_ok: Callable[[Endpoint, Envelope], None] | None = None
        # fault injection (the reference tests by omitting messages,
        # SURVEY.md §5): return True to swallow an outgoing envelope
        self.drop_filter: Callable[[Envelope], bool] | None = None
        # the chaos hook point (control/chaos.py): when set, every envelope
        # headed to the wire is offered to plan_send and the returned
        # ChaosAction is applied (drop/fail/delay/duplicate/corrupt)
        self.chaos = None  # control.chaos.ChaosInjector | None
        # send-retry escalation (config.RetryPolicy): reconnect budget and
        # backoff shape per failure burst, distributed via Welcome
        self.retry_policy = RetryPolicy()
        # per-endpoint escalation bookkeeping, exported by the pull-time
        # collector so flight dumps show why a peer was declared dead
        self.endpoint_reconnects: dict[Endpoint, int] = {}
        self.endpoint_backoff: dict[Endpoint, float] = {}
        self._chaos_tasks: set[asyncio.Task] = set()
        self._stopped = False
        # wire compression (MetaDataConfig.wire_dtype == "f16"): float
        # payloads cross the socket at half width; local deliveries and the
        # decode side are unaffected (the flag travels in the frame)
        self.wire_f16 = False
        # multi-stream data plane (DataPlaneConfig, distributed via Welcome
        # like every section): sockets per peer endpoint. 1 = the legacy
        # single-connection wire, byte for byte; > 1 stripes payload frames
        # across streams 1..N-1 by chunk id and shards their encode/
        # checksum/sendmmsg (and inbound decode) into the pump pool.
        self.streams = 1
        self.pump_pool_size = 0  # 0 = auto (streams x endpoints, capped)
        # data plane v3 levers (DataPlaneConfig, BENCHMARKS.md round 9),
        # each defaulting OFF so a legacy config negotiates them down:
        # io_uring burst submission in the sender threads (runtime-probed;
        # _uring_off latches after the first kernel refusal), intra-chunk
        # striping of payload frames at/above the byte bar, and the
        # congestion-aware stripe scheduler (control/stripes.py)
        self.uring = False
        self.intra_chunk_min_bytes = 0
        self.congestion = False
        self._uring_off = False
        self._stripe_sched: dict[Endpoint, StripeScheduler] = {}
        # in-flight sub-chunk reassemblies, keyed (peer key, frag id) —
        # loop-only (the receive path is loop-only), bounded by
        # _FRAG_ASM_MAX
        self._frag_asm: dict[tuple, _FragAssembly] = {}
        self._next_frag_id = 0
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        # the loop the transport runs on, captured at first stream send —
        # sender threads post their loop-side callbacks through it
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stats_lock = threading.Lock()
        self._decoder_tasks: set[asyncio.Task] = set()
        # per-endpoint bandwidth telemetry (OBSERVABILITY.md): bytes moved
        # to/from each peer, exported by the pull-time collector as
        # transport.endpoint.<host:port>.tx_bytes/rx_bytes/stream_count
        self.endpoint_tx: dict[str, int] = {}
        self.endpoint_rx: dict[str, int] = {}
        self._rx_streams: dict[str, int] = {}
        # per-(peer endpoint, stream) inbound sequence expectation — on the
        # transport, NOT the connection, so it survives reconnects (see
        # _FrameReceiver._check_seq). Bounded by peers x streams; only the
        # event loop touches it (the receive path is loop-only).
        self._rx_seq_expect: dict[tuple[str | None, int], int] = {}
        # per-stage wall-time accounting: where a node's
        # protocol budget goes — codec vs socket vs engine. Two
        # perf_counter calls per message per stage on >=KB-scale frames;
        # noise next to the work being measured.
        self.stage_seconds: dict[str, float] = {
            "encode": 0.0,  # wire.encode_frame_parts (+ checksum pass)
            "socket_write": 0.0,  # connect + vectored sendmsg + coalesce flush
            "decode": 0.0,  # wire.decode_frame_body (views into recv buffer)
            "handler": 0.0,  # engine: buffer store/reduce + replies built
            "d2h": 0.0,  # outbound payloads copied off the card at send
            "h2d": 0.0,  # inbound payloads copied onto the card
        }
        # the registry sees this transport's stage/drop totals at snapshot
        # time (pull-model collector — zero registry writes on the hot path)
        _live_transports.add(self)

    def configure_data_plane(self, dp) -> None:
        """Adopt a ``DataPlaneConfig`` (ctor / Welcome / standby takeover
        — every site must arm the same knobs, so there is ONE of these):
        stream count, pump pool, and the three v3 levers. A config from an
        older master simply lacks the new fields' section and lands on the
        defaults — every lever negotiates down."""
        self.streams = dp.streams
        self.pump_pool_size = dp.pump_pool
        self.uring = dp.uring
        self.intra_chunk_min_bytes = dp.intra_chunk_min_bytes
        self.congestion = dp.congestion

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> Endpoint:
        self._stopped = False
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _FrameReceiver(self), self._host, self._port
        )
        self._port = self._server.sockets[0].getsockname()[1]
        self._pump = observed_task(self._pump_inbox(), name="transport-pump")
        return self.endpoint

    @property
    def endpoint(self) -> Endpoint:
        return Endpoint(self._host, self._port)

    async def stop(self) -> None:
        self._stopped = True
        # held (delayed) chaos frames must not re-open senders mid-teardown
        for task in list(self._chaos_tasks):
            task.cancel()
        self._chaos_tasks.clear()
        if self._server is not None:
            self._server.close()
        # close accepted connections BEFORE wait_closed: on Python >= 3.12
        # wait_closed waits for them
        for transport in list(self._server_conns):
            transport.close()
        self._server_conns.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        if self._pump is not None:
            # re-cancel until the task actually ends: a wait_for inside the
            # pump's write path (connect) can eat one cancellation on
            # Python < 3.12 when its future completes in the same tick
            while not self._pump.done():
                self._pump.cancel()
                await asyncio.wait([self._pump], timeout=1.0)
            self._pump = None
        writers = [
            s.writer_task
            for s in self._senders.values()
            if s.writer_task is not None and not s.writer_task.done()
        ]
        if writers:
            # bounded courtesy drain BEFORE teardown: send() returns at
            # enqueue time, so a goodbye frame (LeaveCluster) may still sit
            # in a sender queue — give the writers one timeout window to
            # flush it; a stalled peer is already bounded by their own waits
            await asyncio.wait(writers, timeout=self.connect_timeout_s)
        for task in list(self._decoder_tasks):
            task.cancel()
        self._decoder_tasks.clear()
        # teardown ordering for the data-plane threads: flag senders closed
        # under their conds (sender threads observe it at the next wait
        # wakeup or SO_SNDTIMEO slice), cancel loop-task writers, JOIN the
        # threads and the pool's in-flight decode jobs, and only then close
        # the sockets — closing an fd a thread still has in a syscall could
        # hand its number to an unrelated new socket
        for sender in self._senders.values():
            with sender.cond:
                sender.closed = True
                sender.cond.notify_all()
            task = sender.writer_task
            if (
                task is not None
                and not task.done()
                and task is not asyncio.current_task()
            ):
                task.cancel()
            sender.wake_waiters()
        loop = asyncio.get_running_loop()
        threads = [
            s.thread
            for s in self._senders.values()
            if s.thread is not None and s.thread.is_alive()
        ]
        for thread in threads:
            await loop.run_in_executor(
                None, thread.join, self.connect_timeout_s + 2 * _SEND_SLICE_S
            )
        if self._pool is not None:
            pool, self._pool = self._pool, None
            await loop.run_in_executor(None, pool.shutdown)
        for sender in self._senders.values():
            sender.close()
        if writers:
            await asyncio.gather(*writers, return_exceptions=True)
        self._senders.clear()
        self._recv_pool.clear()
        self._frag_asm.clear()
        self._stripe_sched.clear()

    # -- receive-buffer pool ----------------------------------------------------

    # Bound on pooled buffers (count and per-buffer bytes): payload frames at
    # the benchmark scale are ~1-4 MB, so a handful of retained buffers serve
    # a steady stream without per-frame allocation; anything larger is given
    # back to the allocator.
    _recv_pool_max = 8
    _recv_buf_max = 16 << 20

    def _acquire_recv_buf(self, length: int) -> bytearray:
        pool = self._recv_pool
        best = -1
        for i, b in enumerate(pool):
            if len(b) >= length and (best < 0 or len(b) < len(pool[best])):
                best = i
        if best >= 0:
            return pool.pop(best)
        return bytearray(length)

    def _release_recv_buf(self, buf: bytearray) -> None:
        if (
            len(self._recv_pool) >= self._recv_pool_max
            or len(buf) > self._recv_buf_max
        ):
            return
        try:
            # a bytearray with live buffer exports refuses to resize — the
            # exact guard we need: if any decoded view still aliases this
            # buffer (a handler kept the payload), recycling would corrupt
            # it, so the buffer is simply dropped instead of pooled
            last = buf.pop()
        except (BufferError, IndexError):
            return
        buf.append(last)
        self._recv_pool.append(buf)

    # -- sub-chunk reassembly (intra-chunk striping) -----------------------------

    def _frag_get(self, key: tuple, total: int) -> _FragAssembly | None:
        """The assembly record for split frame ``key``, created on the
        first stripe (one pooled frame-sized buffer every later stripe
        lands in directly). None = the peer re-used a frag id with a
        different total — a protocol error the caller treats like a bad
        length prefix."""
        rec = self._frag_asm.get(key)
        if rec is not None:
            return rec if rec.total == total else None
        while len(self._frag_asm) >= _FRAG_ASM_MAX:
            # bound memory against stripes that will never complete (a
            # sender dead-lettered mid-frame): evict the OLDEST assembly —
            # at-most-once absorbs the loss, the counter makes it visible.
            # The buffer is DROPPED, never pooled: a connection may still
            # be mid-recv into it (direct mode), and pooling it would hand
            # the same bytearray to a second assembly — two writers, one
            # buffer. The GC reclaims it once the last writer lets go.
            self._frag_asm.pop(next(iter(self._frag_asm)))
            self.dropped += 1
            _DROP_FRAG_STALE.inc()
        rec = _FragAssembly(self._acquire_recv_buf(total), total)
        self._frag_asm[key] = rec
        return rec

    def _frag_advance(
        self, conn: "_FrameReceiver", key: tuple, rec: _FragAssembly,
        offset: int, frag_len: int,
    ) -> None:
        """One stripe of ``key`` fully landed: deliver the reassembled
        frame once every body byte has (whichever stream carried the last
        stripe delivers — stripe arrival order is free)."""
        if offset in rec.seen:
            return  # duplicate stripe (sender reconnect resend): the
            # rewrite was byte-identical, the count must not move
        rec.seen.add(offset)
        rec.got += frag_len
        if rec.got < rec.total:
            return
        # identity-guarded pop: ``rec`` may have been cap-evicted and its
        # key since reused by a NEWER assembly — completing the orphan
        # must not tear the replacement out of the table (the orphan's
        # data is complete and correct, so it still delivers; a duplicate
        # of the frame is at-most-once's bread and butter)
        if self._frag_asm.get(key) is rec:
            self._frag_asm.pop(key)
        _FRAGS_REASSEMBLED.inc()
        # pool the buffer only when NO connection is still direct-recving
        # into it (a late duplicate stripe): pooling under a live writer
        # would hand the next inbound frame a buffer that stripe keeps
        # scribbling on
        conn._deliver(
            rec.buf, rec.total,
            pooled=rec.buf if rec.writers == 0 else None,
        )

    # -- per-endpoint telemetry lifecycle ----------------------------------------

    def forget_endpoint(self, ep: Endpoint) -> None:
        """Evict every per-endpoint accounting row for ``ep`` — called when
        MEMBERSHIP expels the peer, so the registry snapshot stops carrying
        dead ``transport.endpoint.<host:port>.*`` rows forever (they are
        otherwise cumulative: before this hook the adapt controller's
        bandwidth arm had to special-case frozen rows as permanent
        straggler pressure). A peer that re-joins regrows its rows from
        zero, which is also the honest reading of a fresh process.

        The peer's senders close too — an expelled endpoint is one this
        process has stopped dialing, and a live sender would re-seed the
        collector's row (its stream_count gauge) on the next snapshot.
        Queued frames are DEAD-LETTERED, never silently cleared: the
        at-most-once error callback per envelope is what lets higher
        layers repair themselves (the state-transfer push dedup un-marks
        a lost ChunkData on ``on_send_error`` and re-pushes next lap — a
        silent drop here once wedged replication for a whole run when a
        transient phi flap shrank the address book)."""
        log.info("evicting endpoint %s (telemetry rows + senders)", ep)
        for skey in [k for k in self._senders if k[0] == ep]:
            snd = self._senders.pop(skey)
            if snd.thread is not None:
                # the sender THREAD owns its socket and its queue: flag it
                # closed and let the thread dead-letter the leftovers and
                # close the fd on its way out (draining from here would
                # race the thread's in-flight batch bookkeeping, and
                # closing the fd could yank it mid-syscall)
                with snd.cond:
                    snd.closed = True
                    snd.cond.notify_all()
                continue
            # loop-task sender: cancel the writer FIRST (it is parked at an
            # await and cannot resume before this method returns, so the
            # cancellation lands at its await point — never inside its
            # post-send queue bookkeeping), then _fail_sender drains with
            # the full at-most-once accounting
            task = snd.writer_task
            if task is not None and not task.done():
                task.cancel()
            snd.closed = True
            self._fail_sender(ep, snd, OSError("endpoint evicted"))
        key = f"{ep.host}:{ep.port}"
        with self._stats_lock:
            self.endpoint_tx.pop(key, None)
            self.endpoint_rx.pop(key, None)
            self.endpoint_reconnects.pop(ep, None)
            self.endpoint_backoff.pop(ep, None)
        # loop-only structures (the receive path and the scheduler map are
        # owned by the event loop this runs on)
        self._rx_streams.pop(key, None)
        self._stripe_sched.pop(ep, None)
        for k in [k for k in self._rx_seq_expect if k[0] == key]:
            del self._rx_seq_expect[k]
        for k in [k for k in self._frag_asm if k[0] == key]:
            # dropped, never pooled: a connection may still be mid-recv
            # into the assembly (see _frag_get's eviction note)
            self._frag_asm.pop(k)

    # -- pump pool (multi-stream data plane) ------------------------------------

    def _pool_enabled(self) -> bool:
        return self.streams > 1

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        """The transport's pump pool, created lazily at first payload-stream
        use: sized streams x live endpoints (capped) unless pinned by
        DataPlaneConfig.pump_pool."""
        pool = self._pool
        if pool is None:
            eps = {k[0] for k in self._senders} | set(self._routes.values())
            size = self.pump_pool_size or min(
                _PUMP_POOL_CAP, max(2, self.streams * max(1, len(eps)))
            )
            pool = self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=size, thread_name_prefix="aw-pump"
            )
        return pool

    def _note_rx(self, key: str | None, nbytes: int) -> None:
        if key is not None:
            self.endpoint_rx[key] = self.endpoint_rx.get(key, 0) + nbytes

    def _decode_timed(self, buf, need: int):
        """One frame body -> (dest, msg, tctx), with the decode stage timer
        charged under the stats lock (this runs on the event loop for
        legacy connections and in pump-pool threads for payload streams)."""
        t0 = time.perf_counter()
        out = wire.decode_frame_body_ex(memoryview(buf)[:need])
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.stage_seconds["decode"] += dt
        _flight.set_state("transport.last_stage", "decode")
        return out

    async def _decode_pump(
        self, q: asyncio.Queue, conn: "_FrameReceiver"
    ) -> None:
        """Per-connection ordered decode: frames of ONE connection decode
        strictly in arrival order (so stream 0 keeps its FIFO contract and
        a payload stream's sequence stays meaningful), but offload-scale
        checksum/frombuffer work runs in a pump-pool thread — connection
        A's decode overlaps connection B's handler. Sub-threshold frames
        land here only when queued behind an in-flight offload (ordering),
        and decode inline."""
        loop = asyncio.get_running_loop()
        while True:
            item = await q.get()
            if item is None:
                return  # connection closed and queue drained
            buf, need, pooled = item
            try:
                if need >= _DECODE_OFFLOAD_MIN:
                    dest, msg, tctx = await loop.run_in_executor(
                        self._executor(), self._decode_timed, buf, need
                    )
                else:
                    dest, msg, tctx = self._decode_timed(buf, need)
            except asyncio.CancelledError:
                raise  # transport teardown, not a bad frame
            except Exception as exc:
                log.warning("undecodable frame (%s); dropping", exc)
                self.dropped += 1
                _DROP_UNDECODABLE.inc()
                if pooled is not None:
                    self._release_recv_buf(pooled)
                continue
            finally:
                conn._decode_busy -= 1
            self._inbox.put_nowait((dest, msg, pooled, tctx))

    # -- registration / routing -------------------------------------------------

    def register(self, addr: str, handler: Handler) -> None:
        self._handlers[addr] = handler

    def register_prefix(self, prefix: str, handler: PrefixHandler) -> None:
        self._prefix_handlers[prefix] = handler

    def set_route(self, addr: str, endpoint: Endpoint) -> None:
        self._routes[addr] = endpoint

    def set_prefix_route(
        self, prefix: str, resolver: Callable[[int], Endpoint | None]
    ) -> None:
        self._prefix_routes[prefix] = resolver

    def _local_handler(self, dest: str) -> Callable[[Any], list[Envelope]] | None:
        handler = self._handlers.get(dest)
        if handler is not None:
            return handler
        prefix, _, suffix = dest.rpartition(":")
        ph = self._prefix_handlers.get(prefix)
        if ph is not None and suffix.lstrip("-").isdigit():
            return lambda m, _ph=ph, _id=int(suffix): _ph(_id, m)
        return None

    def _resolve(self, dest: str) -> Endpoint | None:
        ep = self._routes.get(dest)
        if ep is not None:
            return ep
        prefix, _, suffix = dest.rpartition(":")
        resolver = self._prefix_routes.get(prefix)
        if resolver is not None and suffix.lstrip("-").isdigit():
            return resolver(int(suffix))
        return None

    # -- sending -----------------------------------------------------------------

    async def send(self, env: Envelope) -> None:
        if self.drop_filter is not None and self.drop_filter(env):
            self.dropped += 1
            _DROP_FILTERED.inc()
            return
        # the round trace rides every hop: an explicit envelope context
        # wins, otherwise the CURRENT context (set by the pump around the
        # handler that built this reply) propagates
        tctx = env.trace if env.trace is not None else _trace.current()
        if env.via is None:
            handler = self._local_handler(env.dest)
            if handler is not None:  # local delivery: no wire, same FIFO inbox
                await self._inbox.put((env.dest, env.msg, None, tctx))
                return
        chaos = self.chaos
        if chaos is not None:
            act = chaos.plan_send(env)
            if act is not None:
                await self._apply_chaos(env, tctx, act)
                return
        await self._send_wire(env, tctx)

    async def _apply_chaos(self, env: Envelope, tctx, act) -> None:
        """Mechanics for a ChaosAction (control/chaos.py) on this envelope."""
        if act.drop or act.fail:
            self.dropped += 1
            _DROP_CHAOS.inc()
            if act.fail and self.on_send_error is not None:
                # partition semantics: the loss is OBSERVABLE, like a refused
                # connection — failure counting (and thus rejoin-on-heal)
                # must see it, unlike the silent packet-loss `drop`. An
                # unroutable dest gets no callback, matching the normal
                # no-route drop (the callback contract promises an Endpoint)
                ep = env.via if env.via is not None else self._resolve(env.dest)
                if ep is not None:
                    self.on_send_error(ep, env)
            return
        if act.delay_s > 0:
            # hold the frame WITHOUT blocking the caller: later sends to the
            # same peer overtake it, so delay doubles as reordering pressure
            task = observed_task(
                self._chaos_delayed(env, tctx, act), name="chaos-delay"
            )
            self._chaos_tasks.add(task)
            task.add_done_callback(self._chaos_tasks.discard)
            return
        await self._send_wire(env, tctx, chaos_act=act)
        if act.duplicate:
            await self._send_wire(env, tctx)

    async def _chaos_delayed(self, env: Envelope, tctx, act) -> None:
        await asyncio.sleep(act.delay_s)
        if self._stopped:
            return
        await self._send_wire(env, tctx, chaos_act=act)
        if act.duplicate:
            await self._send_wire(env, tctx)

    def _payload_to_host(self, env: Envelope) -> Envelope:
        """``env`` with its payload copied to the host now, on this
        thread's current stream (the one the engine queued the payload's
        writes on), timed as ``d2h``: the encode, inline or deferred to a
        sender thread, then reads host memory only."""
        t0 = time.perf_counter()
        msg = wire.to_host(env.msg)
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.stage_seconds["d2h"] += dt
        return env if msg is env.msg else dataclasses.replace(env, msg=msg)

    def _payload_to_device(self, msg: Any) -> Any:
        """A decoded Scatter/ReduceBlock with its value copied onto the
        engine's device, timed as ``h2d``. The copy from pageable memory
        returns once the source is read, so the receive buffer the value
        aliased is free again."""
        t0 = time.perf_counter()
        msg = dataclasses.replace(msg, value=msg.value.to(self.device))
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.stage_seconds["h2d"] += dt
        return msg

    def _pick_stream(self, ep: Endpoint, env: Envelope, nbytes: int) -> int:
        """Which payload stream of ``ep`` carries this frame: by chunk id
        (deterministic — a chaos-delayed resend of the same chunk rides
        the same stream), or through the endpoint's congestion-aware
        :class:`StripeScheduler` when the lever is on — a persistently
        slow stream then sheds assignment weight instead of gating every
        round that owns a chunk on it."""
        n_payload = self.streams - 1
        if self.congestion and n_payload > 1:
            sched = self._stripe_sched.get(ep)
            if sched is None:
                sched = self._stripe_sched[ep] = StripeScheduler(n_payload)
            return 1 + sched.pick(nbytes, time.monotonic())
        return 1 + (env.msg.chunk_id % n_payload)

    async def _send_wire(self, env: Envelope, tctx, *, chaos_act=None) -> None:
        if self._stopped:
            return  # a held chaos frame outlived the transport
        ep = env.via if env.via is not None else self._resolve(env.dest)
        if ep is None:
            log.warning("no route for %s; dropping", env.dest)
            self.dropped += 1
            _DROP_NO_ROUTE.inc()
            return
        if self._on_card and type(env.msg) in _STRIPED_TYPES:
            env = self._payload_to_host(env)
        if self.streams > 1 and type(env.msg) in _STRIPED_TYPES:
            await self._send_wire_payload(env, tctx, ep, chaos_act)
            return
        t0 = time.perf_counter()
        parts = wire.encode_frame_parts(
            env.dest, env.msg, f16=self.wire_f16, wire=env.wire, trace=tctx
        )
        if chaos_act is not None and chaos_act.corrupt:
            parts = self.chaos.corrupt_frame_parts(parts, chaos_act)
        with self._stats_lock:
            self.stage_seconds["encode"] += time.perf_counter() - t0
        _flight.set_state("transport.last_stage", "encode")
        sender = self._senders.get((ep, 0))
        if sender is None or sender.closed:
            sender = self._senders[(ep, 0)] = _Sender()
        nbytes = sum(len(p) for p in parts)
        tail = sender.queue[-1] if sender.queue else None
        if (
            nbytes <= _COALESCE_MAX
            and tail is not None
            and tail.coalesced
            and not tail.inflight
            and tail.nbytes + nbytes <= _COALESCE_ENTRY_MAX
        ):
            # small control frame: merge into the queue's coalesce tail — a
            # burst of heartbeats/acks becomes one segment of one sendmsg
            tail.parts[0] += b"".join(parts)
            tail.envs.append(env)
            tail.nbytes += nbytes
            frame = tail
        elif nbytes <= _COALESCE_MAX:
            frame = _Frame([bytearray(b"".join(parts))], [env], nbytes, True)
            sender.queue.append(frame)
        else:
            # payload frame: the segments (header bytes + payload view of
            # the engine's memory) go on the queue as-is — the vectored
            # write is the first and only place the payload bytes move
            frame = _Frame(parts, [env], nbytes, False)
            sender.queue.append(frame)
        sender.queued_bytes += nbytes
        loop = asyncio.get_running_loop()
        if sender.writer_task is None or sender.writer_task.done():
            sender.writer_task = observed_task(
                self._drain_sender(ep, sender), name=f"writer-{ep}"
            )
        if sender.queued_bytes > self.write_buffer_high_water:
            await self._backpressure_wait(ep, sender, frame, loop)

    async def _send_wire_payload(
        self, env: Envelope, tctx, ep: Endpoint, chaos_act
    ) -> None:
        """Route a payload frame onto the endpoint's payload streams with
        its encode DEFERRED to the sender thread(s): the thread runs
        encode + checksum + chaos corruption just before the batch
        syscall, so peer A's codec work overlaps peer B's handler on the
        loop — and the enqueue here is the loop's ONLY involvement per
        frame (no per-batch executor round-trips). Backpressure is charged
        NOW — ``wire.payload_frame_nbytes`` is exact without encoding.

        Frames whose encoded body reaches ``intra_chunk_min_bytes`` (and
        the endpoint has >= 2 payload streams to split across) go through
        the intra-chunk path instead: sub-frames striped across streams,
        so a ONE-chunk round no longer serializes onto one socket."""
        mode = wire._wire_mode(self.wire_f16, env.wire)
        nbytes = wire.payload_frame_nbytes(
            env.dest, env.msg, mode, tctx is not None
        )
        if (
            self.intra_chunk_min_bytes
            and self.streams >= 3
            and nbytes >= self.intra_chunk_min_bytes
        ):
            await self._send_wire_striped(env, tctx, ep, chaos_act, mode, nbytes)
            return
        stream = self._pick_stream(ep, env, nbytes)
        # + 4: the per-stream seq header the sender thread stamps between
        # the length prefix and the body ([u32 len][u32 seq][body])
        frame = _Frame(None, [env], nbytes + 4, False)
        frame.encode_job = (env, tctx, mode, chaos_act)
        loop = asyncio.get_running_loop()
        sender = self._enqueue_stream_frame(ep, stream, frame)
        if sender.queued_bytes > self.stream_write_buffer_high_water:
            await self._backpressure_wait(ep, sender, frame, loop)

    async def _send_wire_striped(
        self, env: Envelope, tctx, ep: Endpoint, chaos_act, mode: str,
        nbytes: int,
    ) -> None:
        """Intra-chunk striping: split ONE payload frame's encoded body
        into sub-frames across the endpoint's payload streams. The encode
        stays deferred and runs ONCE (``_SharedEncode`` — whichever sender
        thread drains a stripe first pays it); each stripe is its own
        ``[u32 len][u32 seq]`` frame wrapping a continuation header plus a
        zero-copy slice of the shared body, and the receive side lands
        every stripe at its offset in one pooled buffer — no join copy,
        the zero-copy contract end to end."""
        n_payload = self.streams - 1
        body_len = nbytes - 4  # the u32 length prefix is per-stripe framing
        # enough stripes to use the streams, but never stripes so small
        # the continuation framing outweighs the parallelism (each stripe
        # carries at least ~half the bar)
        nstripes = min(
            n_payload,
            max(2, body_len // max(1, self.intra_chunk_min_bytes // 2)),
        )
        frag_sz = -(-body_len // nstripes)  # ceil
        frag_id = self._next_frag_id
        self._next_frag_id = (frag_id + 1) & 0xFFFF_FFFF
        shared = _SharedEncode(env, tctx, mode, chaos_act)
        loop = asyncio.get_running_loop()
        sched = None
        if self.congestion and n_payload > 1:
            sched = self._stripe_sched.get(ep)
            if sched is None:
                sched = self._stripe_sched[ep] = StripeScheduler(n_payload)
        now = time.monotonic()
        pressured: dict[_Sender, _Frame] = {}
        for i in range(nstripes):
            offset = i * frag_sz
            ln = min(frag_sz, body_len - offset)
            if ln <= 0:
                break
            stream = (
                1 + sched.pick(ln, now)
                if sched is not None
                else 1 + ((frag_id + i) % n_payload)
            )
            frame = _Frame(
                None, [env], 4 + 4 + wire.FRAG_HDR_LEN + ln, False
            )
            frame.frag = (shared, frag_id, body_len, offset, ln)
            sender = self._enqueue_stream_frame(ep, stream, frame)
            _FRAGS_SENT.inc()
            if sender.queued_bytes > self.stream_write_buffer_high_water:
                pressured[sender] = frame
        for sender, frame in pressured.items():
            await self._backpressure_wait(ep, sender, frame, loop)

    def _enqueue_stream_frame(
        self, ep: Endpoint, stream: int, frame: _Frame
    ) -> _Sender:
        """Land ``frame`` on the (endpoint, stream) sender's queue, waking
        (or starting) its dedicated thread."""
        self._loop = asyncio.get_running_loop()
        while True:
            sender = self._senders.get((ep, stream))
            if sender is None or sender.closed:
                sender = self._senders[(ep, stream)] = _Sender(stream)
            with sender.cond:
                # closed is re-checked UNDER the cond: the sender thread
                # sets it in _dead_letter_stream from its own lock scope,
                # so an unlocked check could land a frame in a queue that
                # was already drained and abandoned — never sent, never
                # dead-lettered, invisible to on_send_error
                if sender.closed:
                    continue  # lost the race: rebuild a fresh sender
                sender.queue.append(frame)
                sender.queued_bytes += frame.nbytes
                sender.cond.notify()
                break
        if sender.thread is None:
            # With data-plane threads live, the GIL switch interval IS the
            # frame handoff latency: a sender thread woken by the enqueue's
            # notify still waits for the loop thread's next GIL release —
            # up to the default 5ms — before it can even read the queue.
            # 1ms keeps the handoff off the round's critical path; the
            # extra switch overhead is noise against MB-scale frames (and
            # single-threaded streams=1 processes never reach this line).
            if sys.getswitchinterval() > 0.001:
                sys.setswitchinterval(0.001)
            sender.thread = threading.Thread(
                target=self._stream_sender_loop,
                args=(ep, sender),
                name=f"aw-stream-{ep.host}:{ep.port}-s{stream}",
                daemon=True,
            )
            sender.thread.start()
        return sender

    async def _backpressure_wait(
        self, ep: Endpoint, sender: _Sender, frame: _Frame, loop
    ) -> None:
        # Bounded user-space buffering, with a DEADLINE: a dead peer
        # empties the queue via the writer's own bounded waits, but a
        # trickling peer (accepts a few bytes per writability window)
        # could otherwise park the pump here indefinitely — the stalled
        # peer must become dropped messages, never a stalled control
        # plane. On timeout this send's frame is withdrawn (at-most-
        # once) unless the writer already has its buffers on the wire.
        fut = loop.create_future()
        sender.waiters.append(fut)
        timer = loop.call_later(
            self.connect_timeout_s,
            lambda: None if fut.done() else fut.set_result("timeout"),
        )
        try:
            timed_out = (await fut) == "timeout"
        finally:
            timer.cancel()
        if not timed_out:
            return
        # withdrawal races the sender thread on payload streams, so the
        # inflight check and the removal are one critical section (the
        # control sender's loop-task writer never contends — the lock is
        # uncontended there)
        with sender.cond:
            if frame.inflight:
                return
            try:
                sender.queue.remove(frame)
            except ValueError:
                return  # completed/dropped while we timed out
            sender.queued_bytes -= frame.nbytes
        self._note_stripe_dropped(ep, sender, frame.nbytes)
        for e in frame.envs:
            self.dropped += 1
            _DROP_BACKPRESSURE.inc()
            if self.on_send_error is not None:
                self.on_send_error(ep, e)

    async def send_all(self, envelopes: list[Envelope]) -> None:
        for env in envelopes:
            await self.send(env)

    # Largest frame we will buffer from a peer: a corrupt length prefix must
    # not turn into an unbounded allocation. Generous for real payloads
    # (dominated by max_chunk_size floats; 256 MB = a 64M-float chunk).
    max_frame_bytes = 256 << 20

    # Back-pressure point: a send whose endpoint has more than this many
    # bytes queued-but-unsent waits for the writer to drain below it, so a
    # slow peer bounds memory instead of growing the queue forever.
    write_buffer_high_water = 1 << 20

    # Back-pressure point for PAYLOAD streams (streams > 1). These queue
    # deferred-encode frames drained by a dedicated thread, and payload
    # frames are MB-scale — against the 1 MB control high-water every send
    # would trip backpressure and lock-step the producer coroutine with the
    # sender thread (enqueue -> park -> cross-thread wake per frame), which
    # is exactly the serialization the sharded plane exists to remove. At
    # 8 MB a stream holds a few payload frames in flight, so the engine's
    # next chunk overlaps the thread's encode+sendmmsg; a dead peer is
    # still bounded (per stream) and at-most-once drop semantics on
    # timeout are unchanged.
    stream_write_buffer_high_water = 8 << 20

    # Cap on frames/bytes folded into one sendmsg batch: bounds both the
    # iovec count and how much a single syscall can monopolize the writer.
    _batch_max_frames = 16
    _batch_max_bytes = 8 << 20

    async def _connect_sender(self, ep: Endpoint, sender: _Sender) -> None:
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            await asyncio.wait_for(
                loop.sock_connect(sock, (ep.host, ep.port)),
                self.connect_timeout_s,
            )
        except BaseException:
            sock.close()
            raise
        # control frames: latency-sensitive (vectored writes already emit
        # whole frames, so Nagle only adds latency here)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF_BYTES
            )
        except OSError:  # pragma: no cover - kernel may clamp/refuse
            pass
        sender.sock = sock
        # with streams > 1 every connection (stream 0 included) announces
        # itself, so the receive side can attribute rx bytes to the peer's
        # canonical endpoint; at streams=1 nothing is prepended and the
        # wire stays byte-identical to the legacy transport
        sender.need_preamble = self.streams > 1

    async def _sendmsg(self, sock: socket.socket, views: list[memoryview]) -> None:
        """Vectored write of ``views``, bounded: a peer that stops reading
        turns into dropped messages (TimeoutError via the writability
        wait), never a stalled control plane."""
        loop = asyncio.get_running_loop()
        while views:
            try:
                n = sock.sendmsg(views)
            except (BlockingIOError, InterruptedError):
                n = 0
            if n:
                while n:
                    head = views[0]
                    if n >= len(head):
                        n -= len(head)
                        views.pop(0)
                    else:
                        views[0] = head[n:]
                        n = 0
                if not views:
                    return
            await _wait_writable(loop, sock, self.connect_timeout_s)

    def _fail_sender(self, ep: Endpoint, sender: _Sender, exc: BaseException) -> None:
        """At-most-once: everything queued for the dead endpoint drops, with
        the error callback fired per envelope (consecutive-failure counting
        at the control plane relies on per-send callbacks).

        This fires only after the writer's full escalation — a bounded send
        on the existing connection, then ``retry_policy.max_retries``
        reconnect-and-resend cycles with jittered backoff — has failed, so
        a burst of callbacks here means the peer was unresponsive across
        several connection lifetimes, not one transient stall; a
        briefly-slow peer is absorbed by the retries and the kernel
        buffer."""
        log.warning("send to %s failed: %s", ep, exc)
        frames = list(sender.queue)
        sender.queue.clear()
        sender.queued_bytes = 0
        sender.close_sock()
        # the burst is over: a LATER send to this endpoint starts a fresh
        # retry budget (the peer may have come back); locked like
        # _note_retry's read-modify-write — sender threads and the stats
        # collector touch the same dict
        sender.attempts = 0
        with self._stats_lock:
            self.endpoint_backoff[ep] = 0.0
        sender.wake_waiters()
        for frame in frames:
            for env in frame.envs:
                self.dropped += 1
                _DROP_SEND_FAILED.inc()
                if self.on_send_error is not None:
                    self.on_send_error(ep, env)

    def _note_retry(self, ep: Endpoint, sender: _Sender) -> float | None:
        """Burn one retry of the burst's budget (``retry_policy``): record
        the escalation and return the jittered backoff to sleep, or
        ``None`` when the budget is exhausted — the caller escalates to
        ``_fail_sender``. The sleep itself belongs to the CALLER, outside
        the stage-timing window (idle backoff must never read as
        socket_write time in the per-stage profile)."""
        sender.attempts += 1
        if sender.attempts > self.retry_policy.max_retries or sender.closed:
            return None
        backoff = self.retry_policy.backoff_s(
            sender.attempts - 1, random.random()
        )
        # sender THREADS reach here too (payload streams): the read-modify-
        # write must not lose counts to a concurrent stream of the same
        # endpoint, and the stats collector snapshots these dicts
        with self._stats_lock:
            self.endpoint_reconnects[ep] = (
                self.endpoint_reconnects.get(ep, 0) + 1
            )
            self.endpoint_backoff[ep] = backoff
        _RECONNECTS.inc()
        log.info(
            "send to %s failed; retry %d/%d after %.3fs backoff",
            ep, sender.attempts, self.retry_policy.max_retries, backoff,
        )
        return backoff

    async def _drain_sender(self, ep: Endpoint, sender: _Sender) -> None:
        """The endpoint's single writer: drains whole frames, in order, in
        multi-frame vectored batches; a failure burst escalates through the
        RetryPolicy's reconnect budget (exponential backoff, full jitter)
        before the queue is declared dead."""
        backoff: float | None = None
        try:
            while sender.queue and not sender.closed:
                if backoff is not None:
                    await asyncio.sleep(backoff)
                    backoff = None
                    if sender.closed:
                        return
                t0 = time.perf_counter()
                try:
                    if sender.sock is None:
                        try:
                            await self._connect_sender(ep, sender)
                        except (OSError, asyncio.TimeoutError) as exc:
                            backoff = self._note_retry(ep, sender)
                            if backoff is not None:
                                continue
                            self._fail_sender(ep, sender, exc)
                            return
                    batch: list[_Frame] = []
                    views: list[memoryview] = []
                    batch_bytes = 0
                    if sender.need_preamble:
                        views.append(
                            memoryview(
                                wire.encode_stream_preamble(
                                    0, self.streams, self._host, self._port
                                )
                            )
                        )
                    for frame in sender.queue:
                        frame.inflight = True
                        batch.append(frame)
                        views.extend(_byte_views(frame.parts))
                        batch_bytes += frame.nbytes
                        if (
                            len(batch) >= self._batch_max_frames
                            or batch_bytes >= self._batch_max_bytes
                        ):
                            break
                    try:
                        await self._sendmsg(sender.sock, views)
                        sender.need_preamble = False
                    except (OSError, asyncio.TimeoutError) as exc:
                        # frames stay queued: a retry resends them whole on a
                        # fresh connection (the peer discards the partial
                        # frame with the broken stream)
                        sender.close_sock()
                        backoff = self._note_retry(ep, sender)
                        if backoff is not None:
                            continue
                        self._fail_sender(ep, sender, exc)
                        return
                finally:
                    with self._stats_lock:
                        self.stage_seconds["socket_write"] += (
                            time.perf_counter() - t0
                        )
                    _flight.set_state("transport.last_stage", "socket_write")
                if sender.attempts:
                    sender.attempts = 0  # a sent batch ends the burst
                    with self._stats_lock:
                        self.endpoint_backoff[ep] = 0.0
                key = f"{ep.host}:{ep.port}"
                # locked like the thread-side update: payload sender
                # threads increment the same key for this endpoint
                with self._stats_lock:
                    self.endpoint_tx[key] = (
                        self.endpoint_tx.get(key, 0) + batch_bytes
                    )
                for frame in batch:
                    sender.queue.popleft()
                    sender.queued_bytes -= frame.nbytes
                    if self.on_send_ok is not None:
                        for env in frame.envs:
                            self.on_send_ok(ep, env)
                if sender.queued_bytes <= self.write_buffer_high_water:
                    sender.wake_waiters()
        finally:
            sender.wake_waiters()

    # -- payload-stream senders (dedicated threads) ------------------------------

    def _stream_sender_loop(self, ep: Endpoint, sender: _Sender) -> None:
        """THREAD: a payload stream's single writer — same queue/retry/
        backoff shape as ``_drain_sender``, but the whole drain (connect,
        encode+checksum, batch syscall) lives in ONE dedicated thread on a
        BLOCKING socket. The event loop's only per-frame cost is the
        enqueue+notify in ``_send_wire_stream``; there are no per-batch
        loop round-trips, so this stream's byte-moving never serializes
        with another peer's decode or the engine's handler. Exits when the
        sender closes (teardown) or its retry budget dies (dead-letter)."""
        backoff: float | None = None
        try:
            while True:
                batch: list[_Frame] = []
                batch_bytes = 0
                evicted = False
                with sender.cond:
                    while not sender.queue and not sender.closed:
                        # bounded wait: a lost wakeup degrades to a 1s poll
                        sender.cond.wait(timeout=_SEND_SLICE_S)
                    if sender.closed:
                        # closed from OUTSIDE the thread (endpoint
                        # eviction) with frames still queued: they get the
                        # full dead-letter accounting below — a silent
                        # drop would leave senders (statetransfer's push
                        # dedup above all) believing the frames arrived.
                        # Teardown (_stopped) keeps the historical
                        # silent-drop semantics: callbacks into a stopping
                        # control plane help nobody.
                        evicted = bool(sender.queue) and not self._stopped
                        if not evicted:
                            return
                if evicted:
                    self._dead_letter_stream(
                        ep, sender, OSError("endpoint evicted")
                    )
                    return
                with sender.cond:
                    for frame in sender.queue:
                        frame.inflight = True
                        batch.append(frame)
                        batch_bytes += frame.nbytes
                        if (
                            len(batch) >= self._batch_max_frames
                            or batch_bytes >= self._batch_max_bytes
                        ):
                            break
                if backoff is not None:
                    time.sleep(backoff)  # outside the stage-timing window
                    backoff = None
                    if sender.closed:
                        # an evicted endpoint's sender is USUALLY here (its
                        # sends were failing — that is why it got expelled):
                        # the queue still gets the dead-letter accounting, a
                        # silent exit would strand the frames unreported
                        if sender.queue and not self._stopped:
                            self._dead_letter_stream(
                                ep, sender, OSError("endpoint evicted")
                            )
                        return
                if sender.sock is None:
                    try:
                        self._connect_stream_blocking(ep, sender)
                    except (OSError, asyncio.TimeoutError) as exc:
                        with sender.cond:  # retried frames re-batch fresh
                            for frame in batch:
                                frame.inflight = False
                        backoff = self._note_retry(ep, sender)
                        if backoff is not None:
                            continue
                        self._dead_letter_stream(ep, sender, exc)
                        return
                try:
                    sent = self._blocking_send_batch(sender, batch)
                except (OSError, asyncio.TimeoutError) as exc:
                    sender.close_sock()
                    with sender.cond:
                        for frame in batch:
                            frame.inflight = False
                    backoff = self._note_retry(ep, sender)
                    if backoff is not None:
                        continue
                    self._dead_letter_stream(ep, sender, exc)
                    return
                if sender.attempts:
                    sender.attempts = 0  # a sent batch ends the burst
                    with self._stats_lock:
                        self.endpoint_backoff[ep] = 0.0
                key = f"{ep.host}:{ep.port}"
                with self._stats_lock:
                    self.endpoint_tx[key] = (
                        self.endpoint_tx.get(key, 0) + sent
                    )
                if self.congestion and sender.stream_id >= 1:
                    # drain feedback for the congestion-aware scheduler: a
                    # stream that stops moving its assigned bytes sheds
                    # assignment weight (control/stripes.py)
                    sched = self._stripe_sched.get(ep)
                    if sched is not None:
                        sched.note_sent(
                            sender.stream_id - 1, sent, time.monotonic()
                        )
                sent_envs: list = []
                with sender.cond:
                    for frame in batch:
                        sender.queue.popleft()
                        sender.queued_bytes -= frame.nbytes
                        sent_envs.extend(frame.envs)
                self._post_to_loop(self._stream_batch_sent, ep, sender, sent_envs)
        except BaseException as exc:  # noqa: BLE001 - the thread must never
            # die silently: anything the retry paths above did not expect
            # (a deferred-encode bug, native.batch_send raising after a
            # library unload, chaos corrupt_frame_parts on a malformed
            # frame) is NOT retryable — a wedged (endpoint, stream) stripe
            # with closed=False would otherwise swallow every later frame
            # with no dead-letter and no on_send_error, invisible to the
            # control plane's failure accounting.
            self._dead_letter_stream(ep, sender, exc)
        finally:
            ring, sender.uring = sender.uring, None
            if ring is not None:  # the ring belongs to this thread
                try:
                    ring.close()
                except Exception:  # pragma: no cover - teardown best effort
                    pass
            if sender.closed:
                # a sender closed from outside (eviction, teardown) hands
                # the fd close to THIS thread — the only place it is
                # guaranteed out of any syscall (transport.stop() joins
                # before its own close_sock pass, which then no-ops)
                sender.close_sock()
            self._post_to_loop(sender.wake_waiters)

    def _stream_batch_sent(self, ep: Endpoint, sender: _Sender, envs: list) -> None:
        """LOOP: post-send bookkeeping a thread must not run — success
        callbacks (control-plane failure counting expects loop context)
        and waking backpressure waiters (futures belong to the loop)."""
        if self.on_send_ok is not None:
            for env in envs:
                self.on_send_ok(ep, env)
        if sender.queued_bytes <= self.stream_write_buffer_high_water:
            sender.wake_waiters()

    def _dead_letter_stream(
        self, ep: Endpoint, sender: _Sender, exc: BaseException
    ) -> None:
        """THREAD: the stream's retry budget is exhausted — drain the queue
        under the lock, mark the sender dead (the next send builds a fresh
        one with a fresh budget), and hand the dropped envelopes to the
        loop for the at-most-once error callbacks (``_fail_sender``'s
        contract, split across the thread boundary)."""
        log.warning("send to %s failed: %s", ep, exc)
        with sender.cond:
            frames = list(sender.queue)
            sender.queue.clear()
            sender.queued_bytes = 0
            sender.closed = True
        sender.close_sock()
        sender.attempts = 0
        # sender-thread side of the same dict _note_retry and the loop's
        # _fail_sender write: every cross-context mutation holds the lock
        with self._stats_lock:
            self.endpoint_backoff[ep] = 0.0
        self._note_stripe_dropped(
            ep, sender, sum(f.nbytes for f in frames)
        )
        envs = [env for frame in frames for env in frame.envs]
        self._post_to_loop(self._stream_dead_letter_cb, ep, sender, envs)

    def _note_stripe_dropped(
        self, ep: Endpoint, sender: _Sender, nbytes: int
    ) -> None:
        """Reconcile the congestion scheduler's backlog for frames dropped
        UNSENT (dead-letter, backpressure withdrawal): phantom outstanding
        bytes never produce a ``note_sent`` and would otherwise read as
        permanent congestion, pinning the stream at the weight floor."""
        if not nbytes or not self.congestion or sender.stream_id < 1:
            return
        sched = self._stripe_sched.get(ep)
        if sched is not None:
            sched.note_dropped(
                sender.stream_id - 1, nbytes, time.monotonic()
            )

    def _stream_dead_letter_cb(
        self, ep: Endpoint, sender: _Sender, envs: list
    ) -> None:
        """LOOP: the dead-lettered envelopes become per-send error
        callbacks + drop accounting, and any backpressure waiters wake."""
        for env in envs:
            self.dropped += 1
            _DROP_SEND_FAILED.inc()
            if self.on_send_error is not None:
                self.on_send_error(ep, env)
        sender.wake_waiters()

    def _post_to_loop(self, fn, *args) -> None:
        """THREAD: schedule ``fn(*args)`` on the transport's loop; a loop
        already torn down just drops it (teardown has its own wakeups)."""
        loop = self._loop
        if loop is None:
            return
        try:
            loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:  # loop closed mid-teardown
            pass

    def _connect_stream_blocking(self, ep: Endpoint, sender: _Sender) -> None:
        """THREAD: blocking connect for a payload stream. The socket stays
        kernel-blocking with an SO_SNDTIMEO slice, so the native batch
        syscalls block productively (GIL released) yet the thread re-checks
        teardown/progress every ``_SEND_SLICE_S``."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(self.connect_timeout_s)
        try:
            sock.connect((ep.host, ep.port))
        except BaseException:
            sock.close()
            raise
        sock.setblocking(True)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF_BYTES
            )
        except OSError:  # pragma: no cover - kernel may clamp/refuse
            pass
        sock.setsockopt(
            socket.SOL_SOCKET,
            socket.SO_SNDTIMEO,
            struct.pack(
                "ll", int(_SEND_SLICE_S), int((_SEND_SLICE_S % 1.0) * 1e6)
            ),
        )
        sender.sock = sock
        sender.need_preamble = True

    def _blocking_send_batch(self, sender: _Sender, batch: list[_Frame]) -> int:
        """THREAD: encode deferred frames, stamp per-stream sequence
        headers, and drain the whole batch — one ``sendmmsg`` per syscall
        when the native path is live, a ``sendmsg`` loop otherwise (same
        bytes either way). Returns bytes sent."""
        enc = 0.0
        frames_views: list[list[memoryview]] = []
        if sender.need_preamble:
            frames_views.append(
                [
                    memoryview(
                        wire.encode_stream_preamble(
                            sender.stream_id,
                            self.streams,
                            self._host,
                            self._port,
                        )
                    )
                ]
            )
        for frame in batch:
            seq_hdr = _U32.pack(sender.seq)
            sender.seq = (sender.seq + 1) & 0xFFFF_FFFF
            if frame.frag is not None:
                # one stripe of a split frame: the shared encode runs once
                # (whichever stripe's thread gets here first pays it), and
                # this frame's views are a continuation header plus a
                # zero-copy slice of the shared body
                shared, frag_id, total, offset, ln = frame.frag
                parts, enc_dt = shared.ensure(self)
                enc += enc_dt
                frames_views.append(
                    [
                        memoryview(_U32.pack(wire.FRAG_HDR_LEN + ln)),
                        memoryview(seq_hdr),
                        memoryview(
                            wire.encode_frag_header(frag_id, total, offset)
                        ),
                        *wire.slice_parts(parts[1:], offset, offset + ln),
                    ]
                )
                continue
            if frame.parts is None:
                env, tctx, mode, act = frame.encode_job
                t0 = time.perf_counter()
                parts = wire.encode_frame_parts(
                    env.dest, env.msg, wire=mode, trace=tctx
                )
                if act is not None and act.corrupt and self.chaos is not None:
                    parts = self.chaos.corrupt_frame_parts(parts, act)
                enc += time.perf_counter() - t0
                frame.parts = parts
            # frame views: [u32 len][u32 seq][body...] — the length prefix
            # is parts[0]; the sequence is FRAMING, assigned per attempt
            # (a reconnect resets the receiver's expectation with the
            # connection, so retried frames re-number cleanly)
            frames_views.append(
                [
                    memoryview(frame.parts[0]),
                    memoryview(seq_hdr),
                    *_byte_views(frame.parts[1:]),
                ]
            )
        t0 = time.perf_counter()
        try:
            sent = self._send_views_blocking(sender, frames_views)
        finally:
            sock_dt = time.perf_counter() - t0
            with self._stats_lock:
                self.stage_seconds["encode"] += enc
                self.stage_seconds["socket_write"] += sock_dt
        sender.need_preamble = False
        return sent

    # kernel answers that latch io_uring OFF for the whole transport (a
    # kernel that probed fine may still refuse the op — 5.1/5.2 without
    # SENDMSG answer EINVAL, a policy change answers EPERM); everything
    # else is an ordinary socket error for the retry path
    _URING_DISABLE_ERRNOS = frozenset(
        {_errno.ENOSYS, _errno.EINVAL, _errno.EOPNOTSUPP, _errno.EPERM}
    )

    def _uring_ring(self, sender: _Sender):
        """THREAD: the sender's submission ring, created on first use —
        None when the lever is off, the probe failed, or a prior submit
        latched the transport back to the batch syscalls."""
        if not self.uring or self._uring_off:
            return None
        if sender.uring is None:
            try:
                sender.uring = native.UringRing()
            except RuntimeError as exc:
                # check-and-set under the lock: N sender threads race to
                # their first batch before any latch lands, and the
                # fallback must count (and log) once per transport, not
                # once per thread
                with self._stats_lock:
                    first = not self._uring_off
                    self._uring_off = True
                if first:
                    _URING_FALLBACKS.inc()
                    log.info(
                        "io_uring unavailable (%s); staying on batch "
                        "syscalls",
                        exc,
                    )
                return None
        return sender.uring

    def _drop_uring(self, sender: _Sender) -> None:
        """THREAD: the kernel refused a submit the probe promised — latch
        the whole transport off io_uring (once) and fall back."""
        with self._stats_lock:
            first = not self._uring_off
            self._uring_off = True
        if first:
            _URING_FALLBACKS.inc()
            log.warning(
                "io_uring submit refused; falling back to batch syscalls"
            )
        ring, sender.uring = sender.uring, None
        if ring is not None:
            ring.close()

    def _send_views_blocking(
        self, sender: _Sender, frames: list[list[memoryview]]
    ) -> int:
        """THREAD: push every byte of ``frames`` out, advancing across
        short writes; stalls are bounded like the event-loop writers — any
        progress resets a ``connect_timeout_s`` deadline, no progress past
        it raises ``asyncio.TimeoutError`` for the writer's retry path.

        With the io_uring lever on, the whole burst goes through ONE ring
        submission (a single SENDMSG op gathering every segment). The op
        is submitted non-blocking — a stalled peer surfaces as EAGAIN and
        parks in the bounded select below, never inside an uninterruptible
        ring enter — so the teardown/deadline discipline is identical to
        the batch-syscall path."""
        sock = sender.sock
        assert sock is not None
        use_native = native.batch_send_available()
        ring = self._uring_ring(sender)
        deadline = time.monotonic() + self.connect_timeout_s
        total = 0
        while frames:
            if sender.closed:
                raise OSError("sender closed during send")
            try:
                if ring is not None:
                    try:
                        n = ring.send(
                            sock.fileno(),
                            [v for frame in frames for v in frame],
                        )
                        _URING_SUBMITS.inc()
                    except BlockingIOError:
                        raise
                    except OSError as exc:
                        if exc.errno in self._URING_DISABLE_ERRNOS:
                            self._drop_uring(sender)
                            ring = None
                            continue
                        raise
                elif use_native:
                    n = native.batch_send(sock.fileno(), frames)
                else:
                    n = sock.sendmsg(
                        [v for frame in frames for v in frame]
                    )
            except (BlockingIOError, InterruptedError):
                n = 0
            if n:
                deadline = time.monotonic() + self.connect_timeout_s
                total += n
                while n and frames:
                    head = frames[0]
                    while n and head:
                        seg = head[0]
                        if n >= len(seg):
                            n -= len(seg)
                            head.pop(0)
                        else:
                            head[0] = seg[n:]
                            n = 0
                    if not head:
                        frames.pop(0)
            elif time.monotonic() > deadline:
                raise asyncio.TimeoutError("socket write stalled")
            else:
                # bounded wait for socket room: the blocking-socket paths
                # already waited an SO_SNDTIMEO slice inside the syscall;
                # the non-blocking uring submit parks here instead (same
                # slice, same teardown re-check cadence)
                select.select([], [sock], [], _SEND_SLICE_S)
        return total

    # -- receiving ----------------------------------------------------------------

    async def _pump_inbox(self) -> None:
        """Single consumer: every handler runs one message at a time.

        Each delivery runs under the message's trace context (set for the
        handler AND the replies it sends, so the round trace propagates
        hop to hop), wrapped in a ``transport.handle`` span when the
        context is sampled — the per-node transport layer of the merged
        round timeline.
        """
        while True:
            dest, msg, buf, tctx = await self._inbox.get()
            handler = self._local_handler(dest)
            if handler is None:
                log.warning("no handler for %s; dropping", dest)
                self.dropped += 1
                _DROP_NO_HANDLER.inc()
                if buf is not None:
                    self._release_recv_buf(buf)
                continue
            # the whole delivery — handler AND the replies it returns —
            # runs under the message's context; one token reset restores
            # the pre-delivery state on every exit path
            token = _trace._current.set(tctx)
            try:
                hspan = (
                    _trace.start_span(
                        "transport.handle", msg=type(msg).__name__
                    )
                    if tctx is not None and tctx.sampled and _trace.enabled()
                    else None
                )
                if hspan is not None:
                    _trace._current.set(hspan.context)
                try:
                    if (
                        self._on_card
                        and type(msg) in _STRIPED_TYPES
                        and msg.value.device != self.device
                    ):
                        msg = self._payload_to_device(msg)
                    t0 = time.perf_counter()
                    out = handler(msg)
                    # pump-pool threads charge stage_seconds["decode"] under
                    # this lock; the loop's handler timer must match
                    with self._stats_lock:
                        self.stage_seconds["handler"] += (
                            time.perf_counter() - t0
                        )
                    _flight.set_state("transport.last_stage", "handler")
                except asyncio.CancelledError:
                    # defense-in-depth for the arlint ASYNC004 shape: today
                    # the try body has no await (cancellation lands at the
                    # queue get / send_all instead), but a future await
                    # inside a handler must find teardown cancellation
                    # escaping, not absorbed into the broad handler-crash
                    # arm below
                    raise
                except Exception:
                    log.exception(
                        "handler for %s failed on %s", dest, type(msg).__name__
                    )
                    _HANDLER_ERRORS.inc()
                    msg = None
                    if buf is not None:
                        self._release_recv_buf(buf)
                    continue
                finally:
                    if hspan is not None:
                        hspan.end()
                self.delivered += 1
                _DELIVERED.inc()
                # drop our reference to the decoded payload views BEFORE
                # recycling; the export check in _release_recv_buf protects
                # against anything the handler (or the replies) retained
                msg = None
                await self.send_all(out)
            finally:
                _trace._current.reset(token)
            if buf is not None:
                self._release_recv_buf(buf)

    async def drain(self, timeout: float = 5.0) -> None:
        """Wait until the local inbox is empty (test convenience).

        Polls with a growing sleep (1ms -> 50ms) instead of a fixed tight
        interval, on the RUNNING loop's clock — shutdown paths that call
        this must never busy-spin the event loop."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        pause = 0.001
        while not self._inbox.empty():
            if loop.time() > deadline:
                raise TimeoutError("transport did not drain")
            await asyncio.sleep(pause)
            pause = min(pause * 2.0, 0.05)


async def _wait_writable(
    loop: asyncio.AbstractEventLoop, sock: socket.socket, timeout: float
) -> None:
    """Wait until ``sock`` accepts more bytes (writev drained), raising
    ``asyncio.TimeoutError`` after ``timeout``.

    Deliberately NOT ``asyncio.wait_for``: this wait sits under every frame
    write, and on Python < 3.12 ``wait_for`` can swallow an external task
    cancellation that races the future's completion — a cancelled pump that
    keeps running turns ``transport.stop()`` into a deadlock. A plain
    ``await fut`` with a manual timer propagates cancellation verbatim."""
    fut = loop.create_future()
    fd = sock.fileno()

    def ready() -> None:
        if not fut.done():
            fut.set_result(None)

    def timed_out() -> None:
        if not fut.done():
            fut.set_exception(asyncio.TimeoutError("socket write stalled"))

    loop.add_writer(fd, ready)
    timer = loop.call_later(timeout, timed_out)
    try:
        await fut
    finally:
        timer.cancel()
        loop.remove_writer(fd)


async def run_periodic(
    interval_s: float, fn: Callable[[], Awaitable[None]]
) -> None:
    """Fixed-interval async ticker (heartbeats, detector polls)."""
    while True:
        await asyncio.sleep(interval_s)
        await fn()
