"""The worker engine: the per-round scatter-reduce-allgather state machine,
the port's own copy of the JAX package's ``control/worker.py``.

On ``StartAllreduce`` fetch from the data source, partition into P blocks,
chunk by ``max_chunk_size``, scatter to peers; on ``ScatterBlock`` accumulate
and — at the ``th_reduce`` crossing — reduce and broadcast; on
``ReduceBlock`` assemble and — at ``th_complete`` — flush to the data sink
and report completion.

Round discipline: a bounded out-of-order window absorbs peers running ahead;
when a newer round completes first, older in-flight rounds are abandoned.

Payloads are tensors on the worker's device (the card unless the caller
passes ``device="cpu"``): a chunk is a view or a clone of the source's
tensor, a sum or an output lives in the round buffers there. The
bookkeeping — windows, counts, policies, flags — stays on the host, and the
worker delivers its own chunks in the middle of the scatter loop, as the
JAX worker does, so the order of every f32 sum is the JAX engine's.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import torch

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.buffers import RoundBuffers, RoundOutOfWindowError
from akka_allreduce_tpu_torch.config import (
    MetaDataConfig,
    ThresholdConfig,
    WorkerConfig,
)
from akka_allreduce_tpu_torch.control import wire as wire_codec
from akka_allreduce_tpu_torch.control.envelope import Envelope, master_addr, peer_addr
from akka_allreduce_tpu_torch.obs import flight as obs_flight
from akka_allreduce_tpu_torch.obs import metrics as obs_metrics
from akka_allreduce_tpu_torch.obs import trace as obs_trace
from akka_allreduce_tpu_torch.protocol import (
    DEFAULT_POLICY,
    AllReduceInput,
    AllReduceInputRequest,
    AllReduceOutput,
    CompleteAllreduce,
    ConfirmPreparation,
    PrepareAllreduce,
    ReduceBlock,
    RoundPolicy,
    ScatterBlock,
    StartAllreduce,
)

log = logging.getLogger(__name__)

DataSource = Callable[[AllReduceInputRequest], AllReduceInput]
DataSink = Callable[[AllReduceOutput], None]

# process-wide worker stats (summed over a node's per-dimension workers)
_ROUNDS_COMPLETED = obs_metrics.counter("worker.rounds_completed")
_DROPPED = obs_metrics.counter("worker.dropped_messages")
_ROUND_IN_FLIGHT = obs_metrics.gauge("worker.round_in_flight")


class AllreduceWorker:
    """Transport-agnostic worker: feed messages to ``handle``, send what it returns."""

    def __init__(
        self,
        data_source: DataSource,
        data_sink: DataSink,
        config: WorkerConfig = WorkerConfig(),
        line_id: int = 0,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        self.data_source = data_source
        self.data_sink = data_sink
        self.config = config
        self.line_id = line_id
        self.device = resolve_device(device)
        # configured state (set by PrepareAllreduce)
        self.worker_id: int | None = None
        self.peer_ids: tuple[int, ...] = ()
        self.config_id: int = -1
        self.metadata: MetaDataConfig | None = None
        self.threshold: ThresholdConfig | None = None
        self.rounds: RoundBuffers | None = None
        self.completed_rounds = 0
        self.dropped_messages = 0
        # highest round this worker ever flushed to its sink: a re-Start of a
        # round at or below it is answered with a CompleteAllreduce re-assert
        # instead of a second flush (carried across rebuilds by the node)
        self.flushed_up_to = -1
        # per-round RoundPolicy stamps, applied to that round's reduce
        # trigger and its outgoing payload frames
        self._policies: dict[int, RoundPolicy] = {}
        # the newest Start's stamp (monotone by round id)
        self.last_policy: RoundPolicy = DEFAULT_POLICY
        self.last_policy_round: int = -1
        # int8 wire error feedback: per-(dest worker, chunk) residual of the
        # last quantized send, added into the next round's chunk
        self._ef_residual: dict[tuple[int, int], torch.Tensor] = {}

    # -- configuration -------------------------------------------------------

    def configure(self, metadata: MetaDataConfig, threshold: ThresholdConfig) -> None:
        """Set payload geometry + thresholds (bootstrap, before Prepare)."""
        self.metadata = metadata
        self.threshold = threshold

    @property
    def peer_size(self) -> int:
        return len(self.peer_ids)

    def _require_ready(self) -> RoundBuffers:
        if self.rounds is None:
            raise RuntimeError(
                "worker not prepared: PrepareAllreduce must precede rounds"
            )
        return self.rounds

    # -- message dispatch ----------------------------------------------------

    def handle(self, msg: Any) -> list[Envelope]:
        if isinstance(msg, PrepareAllreduce):
            return self._on_prepare(msg)
        if isinstance(msg, StartAllreduce):
            return self._on_start(msg)
        if isinstance(msg, ScatterBlock):
            return self._on_scatter(msg)
        if isinstance(msg, ReduceBlock):
            return self._on_reduce(msg)
        raise TypeError(f"worker cannot handle {type(msg).__name__}")

    # -- handlers ------------------------------------------------------------

    def _on_prepare(self, msg: PrepareAllreduce) -> list[Envelope]:
        if self.metadata is None or self.threshold is None:
            raise RuntimeError("configure(metadata, threshold) before Prepare")
        if (
            msg.config_id == self.config_id
            and msg.worker_id == self.worker_id
            and self.rounds is not None
        ):
            # a re-sent Prepare of the current config: re-confirm only —
            # rebuilding would destroy in-flight round state
            return [
                Envelope(
                    master_addr(self.line_id),
                    ConfirmPreparation(msg.config_id, msg.worker_id),
                )
            ]
        self.worker_id = msg.worker_id
        self.peer_ids = msg.peer_ids
        self.config_id = msg.config_id
        self.line_id = msg.line_id
        # a new configuration resets per-round policies and the EF keys
        # (both keyed against the old peer set); the Prepare's own stamp
        # seeds rounds whose Start has not arrived
        self._policies.clear()
        self._ef_residual.clear()
        if not msg.policy.is_default:
            self._policies[msg.round_num] = msg.policy
        self.rounds = RoundBuffers(
            self.metadata,
            self.threshold,
            peer_size=len(msg.peer_ids),
            window=self.config.round_window,
            device=self.device,
        )
        # resume numbering where the master says, floored at the rounds this
        # worker already flushed
        self.rounds.completed_up_to = max(msg.round_num - 1, self.flushed_up_to)
        log.info(
            "worker %s prepared: config=%d peers=%s from round %d",
            self.worker_id,
            msg.config_id,
            msg.peer_ids,
            msg.round_num,
        )
        return [
            Envelope(
                master_addr(self.line_id),
                ConfirmPreparation(msg.config_id, msg.worker_id),
            )
        ]

    def _on_start(self, msg: StartAllreduce) -> list[Envelope]:
        rounds = self._require_ready()
        r = msg.round_num
        if not rounds.in_window(r):
            if r > rounds.completed_up_to + rounds.window:
                # the master started r, so older rounds are abandoned
                # cluster-wide: fast-forward instead of wedging
                rounds.fast_forward(r)
                log.info(
                    "worker %s: fast-forwarded to round window ending at %d",
                    self.worker_id,
                    r,
                )
            else:  # stale round: already completed locally
                self.dropped_messages += 1
                _DROPPED.inc()
                # a re-Start of a round this worker finished means its
                # CompleteAllreduce was lost: re-assert it
                assert self.worker_id is not None
                return [
                    Envelope(
                        master_addr(self.line_id),
                        CompleteAllreduce(self.worker_id, r),
                    )
                ]
        _ROUND_IN_FLIGHT.set(r)
        obs_flight.set_state("worker.round_in_flight", r)
        # apply the round's policy stamp before scattering: the trigger must
        # be in force when the self-delivered contributions land, and chunks
        # peers already filled past a lowered trigger fire now
        for stale in [k for k in self._policies if k <= rounds.completed_up_to]:
            del self._policies[stale]
        out: list[Envelope] = []
        pol = msg.policy
        if r >= self.last_policy_round:
            self.last_policy = pol
            self.last_policy_round = r
        if pol.is_default:
            # the Start's stamp is authoritative for its round id: drop a
            # Prepare-seeded policy it supersedes
            self._policies.pop(r, None)
        else:
            self._policies[r] = pol
        trig = pol.reduce_count(self.peer_size)
        if trig is not None:
            buf = rounds.scattered(r)
            for chunk_id in buf.set_reduce_trigger(trig):
                out.extend(self._reduce_and_broadcast(buf, r, chunk_id))
        with obs_trace.span("worker.round_start", worker=self.worker_id, round=r):
            out.extend(self._scatter_round(msg))
        return out

    def _round_policy(self, r: int) -> RoundPolicy:
        return self._policies.get(r, DEFAULT_POLICY)

    def _wire_for(self, r: int) -> str | None:
        """Per-frame wire precision for round ``r``'s payload envelopes
        (None = the transport's configured default)."""
        return self._round_policy(r).wire or None

    def _scatter_round(self, msg: StartAllreduce) -> list[Envelope]:
        r = msg.round_num
        data = self.data_source(AllReduceInputRequest(r)).data
        meta = self.metadata
        assert meta is not None
        if tuple(data.shape) != (meta.data_size,):
            raise ValueError(
                f"dataSource returned shape {tuple(data.shape)}, expected "
                f"({meta.data_size},)"
            )
        out: list[Envelope] = []
        block = meta.block_size(self.peer_size)
        n_chunks = meta.chunks_per_block(self.peer_size)
        # Partition the input into one block per peer, chunk each block;
        # only chunks running past data_size get a zero-padded tail (peers
        # cut the padding at flush). With zero_copy_scatter the chunks are
        # views of the source's tensor (sound only for sources that publish
        # a new tensor a round, see WorkerConfig); otherwise each is cloned.
        # A source on another device is moved here once a round.
        data = data.to(self.device).contiguous()
        zero_copy = self.config.zero_copy_scatter
        pol = self._round_policy(r)
        wire_mode = pol.wire or None
        int8 = pol.wire == "int8"
        if not int8 and self._ef_residual:
            # the mode restored out of int8: drop the pending corrections
            self._ef_residual.clear()
        my_id = self.worker_id
        assert my_id is not None
        my_rank = self.peer_ids.index(my_id)
        for dest_rank, dest_id in enumerate(self.peer_ids):
            for c in range(n_chunks):
                lo = dest_rank * block + c * meta.max_chunk_size
                hi = min(lo + meta.max_chunk_size, (dest_rank + 1) * block)
                if hi <= meta.data_size:
                    chunk = data[lo:hi] if zero_copy else data[lo:hi].clone()
                else:
                    chunk = torch.zeros(hi - lo, dtype=torch.float32, device=self.device)
                    if lo < meta.data_size:
                        chunk[: meta.data_size - lo] = data[lo:]
                if int8 and dest_id != my_id:
                    # error feedback on the wire-bound copy (self-delivery
                    # never quantizes): fold the last send's residual in,
                    # then carry this send's residual forward, computed with
                    # the wire's own quantizer
                    prev = self._ef_residual.pop((dest_id, c), None)
                    if prev is not None and prev.shape == chunk.shape:
                        chunk = chunk + prev
                    self._ef_residual[(dest_id, c)] = (
                        chunk - wire_codec.int8_roundtrip(chunk)
                    )
                sb = ScatterBlock(chunk, my_rank, dest_rank, c, r)
                if dest_id == my_id:
                    out.extend(self._on_scatter(sb))  # self-delivery, no wire
                else:
                    out.append(Envelope(peer_addr(dest_id), sb, wire=wire_mode))
        return out

    def _on_scatter(self, msg: ScatterBlock) -> list[Envelope]:
        rounds = self._require_ready()
        r = msg.round_num
        try:
            buf = rounds.scattered(r)
        except RoundOutOfWindowError:
            self.dropped_messages += 1
            _DROPPED.inc()
            return []
        crossed = buf.store(msg.value, msg.src_id, msg.chunk_id)
        if not crossed:
            return []
        return self._reduce_and_broadcast(buf, r, msg.chunk_id)

    def _reduce_and_broadcast(self, buf, r: int, chunk_id: int) -> list[Envelope]:
        """The once-per-chunk reduce + broadcast, fired by ``store``'s
        trigger crossing or by a RoundPolicy lowering the trigger under
        contributions that already satisfy it."""
        with obs_trace.span("worker.reduce", worker=self.worker_id, round=r,
                            chunk=chunk_id):
            value, count = buf.reduce(chunk_id)
            my_rank = self.peer_ids.index(self.worker_id)
            wire_mode = self._wire_for(r)
            out: list[Envelope] = []
            for dest_id in self.peer_ids:
                rb = ReduceBlock(value, my_rank, 0, chunk_id, r, count)
                if dest_id == self.worker_id:
                    out.extend(self._on_reduce(rb))
                else:
                    out.append(Envelope(peer_addr(dest_id), rb, wire=wire_mode))
            return out

    def _on_reduce(self, msg: ReduceBlock) -> list[Envelope]:
        rounds = self._require_ready()
        r = msg.round_num
        try:
            buf = rounds.reduced(r)
        except RoundOutOfWindowError:
            self.dropped_messages += 1
            _DROPPED.inc()
            return []
        buf.store(msg.value, msg.src_id, msg.chunk_id, msg.count)
        if not buf.reach_completion_threshold():
            return []
        # copy=False: the round is evicted on the next line, so the flushed
        # view's storage is never written again
        with obs_trace.span("worker.flush", worker=self.worker_id, round=r):
            data, counts = buf.get_with_counts(copy=False)
            rounds.complete(r)  # evicts this round AND abandons older ones
            self.completed_rounds += 1
            self.flushed_up_to = max(self.flushed_up_to, r)
            for stale in [k for k in self._policies if k <= r]:
                del self._policies[stale]  # evicted with their rounds
            self.data_sink(AllReduceOutput(data, counts, r))
        _ROUNDS_COMPLETED.inc()
        obs_flight.set_state("worker.last_completed_round", r)
        # between rounds nothing is in flight
        if obs_flight.get_state("worker.round_in_flight") == r:
            _ROUND_IN_FLIGHT.set(-1)
            obs_flight.set_state("worker.round_in_flight", None)
        my_id = self.worker_id
        assert my_id is not None
        if (
            self.config.stats_reporting_round_frequency > 0
            and self.completed_rounds % self.config.stats_reporting_round_frequency == 0
        ):
            log.info(
                "worker %s: %d rounds complete (dropped=%d)",
                my_id,
                self.completed_rounds,
                self.dropped_messages,
            )
        return [Envelope(master_addr(self.line_id), CompleteAllreduce(my_id, r))]
