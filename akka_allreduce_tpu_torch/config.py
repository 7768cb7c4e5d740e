"""Typed configuration: the port's own copy of the JAX package's
``akka_allreduce_tpu/config.py``, every class with the same fields, defaults
and validation, and ``AllreduceConfig`` with the same JSON form.

The three threshold fractions decide when a round completes with whichever
workers have contributed; the single-card round uses
``ThresholdConfig.reduce_count`` to decide which virtual workers count, the
host engine (``control/``) all three. The transport's sections
(``RetryPolicy``, ``DataPlaneConfig``, ``GossipConfig``, ``ChaosConfig``,
``AdaptConfig``) are carried so that a configuration written by either
package loads in the other; the port's in-process engine reads none of
them and refuses an enabled ``ChaosConfig``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


def _check_fraction(name: str, value: float) -> None:
    if not (0.0 < value <= 1.0):
        raise ValueError(f"{name} must be in (0, 1], got {value}")


@dataclasses.dataclass(frozen=True)
class ThresholdConfig:
    """The three completion fractions governing partial (threshold) completion.

    - ``th_reduce``: fraction of peers whose contribution must arrive before a
      chunk is reduced.
    - ``th_complete``: fraction of expected reduced chunks that must arrive
      before a worker flushes its output.
    - ``th_allreduce``: fraction of workers that must report completion before
      the next round starts.
    """

    th_allreduce: float = 1.0
    th_reduce: float = 1.0
    th_complete: float = 1.0

    def __post_init__(self) -> None:
        _check_fraction("th_allreduce", self.th_allreduce)
        _check_fraction("th_reduce", self.th_reduce)
        _check_fraction("th_complete", self.th_complete)

    def reduce_count(self, peer_size: int) -> int:
        """Contributions required before a chunk may be reduced."""
        return max(1, math.ceil(self.th_reduce * peer_size))

    def complete_count(self, total_chunks: int) -> int:
        """Reduced chunks required before a worker flushes its round output."""
        return max(1, math.ceil(self.th_complete * total_chunks))

    def allreduce_count(self, num_workers: int) -> int:
        """Worker completions required before the next round starts."""
        return max(1, math.ceil(self.th_allreduce * num_workers))


@dataclasses.dataclass(frozen=True)
class MetaDataConfig:
    """Payload geometry: total element count and chunking granularity.

    ``wire_dtype`` "f16" halves the bytes of every host-plane payload;
    accumulation stays float32.
    """

    data_size: int
    max_chunk_size: int = 262_144
    wire_dtype: str = "f32"

    def __post_init__(self) -> None:
        if self.data_size <= 0:
            raise ValueError(f"data_size must be positive, got {self.data_size}")
        if self.max_chunk_size <= 0:
            raise ValueError(
                f"max_chunk_size must be positive, got {self.max_chunk_size}"
            )
        if self.wire_dtype not in ("f32", "f16"):
            raise ValueError(
                f"wire_dtype must be 'f32' or 'f16', got {self.wire_dtype!r}"
            )

    def block_size(self, peer_size: int) -> int:
        """Size of one worker's block when data is partitioned across peers."""
        return math.ceil(self.data_size / peer_size)

    def chunks_per_block(self, peer_size: int) -> int:
        return math.ceil(self.block_size(peer_size) / self.max_chunk_size)

    def chunk_size(self, peer_size: int, chunk_id: int) -> int:
        """Length of ``chunk_id`` within a block (the last chunk may be short)."""
        block = self.block_size(peer_size)
        n_chunks = self.chunks_per_block(peer_size)
        if not 0 <= chunk_id < n_chunks:
            raise IndexError(f"chunk_id {chunk_id} out of range [0, {n_chunks})")
        start = chunk_id * self.max_chunk_size
        return min(self.max_chunk_size, block - start)


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """Per-worker engine config (reference ``WorkerConfig``)."""

    stats_reporting_round_frequency: int = 10
    round_window: int = 4  # max out-of-order rounds buffered concurrently
    # Scatter the data source's array as zero-copy views instead of copying
    # each chunk. Saves a full-buffer copy per round, but is only sound when
    # the source publishes SNAPSHOTS — a fresh (or never-mutated) array per
    # round, replaced by reference — because frames may be encoded after the
    # handler returns (deferred queues / event-loop awaits). Sources that
    # reuse and mutate one buffer in place must leave this False.
    zero_copy_scatter: bool = False


@dataclasses.dataclass(frozen=True)
class LineMasterConfig:
    """Per-line control-plane config (reference ``LineMasterConfig``)."""

    round_window: int = 4  # bounded number of rounds in flight
    max_rounds: int = -1  # -1 = unbounded
    start_up_time_ms: int = 0


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """Per-host supervisor config (reference ``NodeConfig``): how many grid
    dimensions this node participates in (dim 0 = rows, dim 1 = cols, ...)."""

    dimensions: int = 1
    report_stats: bool = True
    elastic_rate: float = 1.0  # elastic-averaging alpha for the weight binder


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Transport send-retry budget: exponential backoff with FULL jitter.

    A failure burst against one endpoint may consume up to ``max_retries``
    reconnect-and-resend cycles before the queued envelopes are declared
    dead (``on_send_error`` per envelope); each retry sleeps a uniform
    sample of ``[0, min(backoff_max_s, backoff_base_s * 2**attempt))`` —
    full jitter, so a partition heal is not greeted by every peer
    reconnecting in the same millisecond. ``max_retries=0`` restores
    fail-fast semantics (useful under chaos tests that want every fault
    surfaced immediately).
    """

    max_retries: int = 1
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )
        if self.backoff_base_s <= 0 or self.backoff_max_s <= 0:
            raise ValueError(
                "backoff_base_s/backoff_max_s must be positive, got "
                f"{self.backoff_base_s}/{self.backoff_max_s}"
            )

    def backoff_s(self, attempt: int, u: float) -> float:
        """Backoff before retry ``attempt`` (0-based); ``u`` is the caller's
        uniform [0,1) sample (kept outside so the policy stays a pure
        value object)."""
        cap = min(self.backoff_max_s, self.backoff_base_s * (2.0**attempt))
        return u * cap


@dataclasses.dataclass(frozen=True)
class DataPlaneConfig:
    """Host TCP data-plane sharding (the JAX package's ``control/remote.py``).

    ``streams`` parallel sockets a peer endpoint: stream 0 carries control
    traffic, payload frames stripe across streams ``1..N-1`` by chunk id.
    ``pump_pool`` caps the threads that decode large inbound bodies (0 =
    auto). ``uring`` submits each send batch through io_uring where the
    kernel has it; ``intra_chunk_min_bytes`` splits payload frames at least
    that large across the payload streams (0 = off, else >= 65536);
    ``congestion`` weights stripe assignment by each stream's bytes. Every
    lever defaults off, and a cluster at the defaults speaks the one-stream
    wire.
    """

    streams: int = 1
    pump_pool: int = 0
    uring: bool = False
    intra_chunk_min_bytes: int = 0
    congestion: bool = False

    def __post_init__(self) -> None:
        if not 1 <= self.streams <= 16:
            raise ValueError(
                f"streams must be in [1, 16], got {self.streams}"
            )
        if not 0 <= self.pump_pool <= 64:
            raise ValueError(
                f"pump_pool must be in [0, 64], got {self.pump_pool}"
            )
        if self.intra_chunk_min_bytes != 0 and not (
            65536 <= self.intra_chunk_min_bytes <= (1 << 31)
        ):
            raise ValueError(
                "intra_chunk_min_bytes must be 0 (off) or in [65536, 2^31], "
                f"got {self.intra_chunk_min_bytes}"
            )


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """SWIM-style decentralized membership (the JAX package's
    ``control/gossip.py``).

    With ``enabled``, each process probes one random member every
    ``probe_interval_s``, asks ``indirect`` other members to ping the target
    when the direct ack misses ``probe_timeout_s``, and suspects the target
    only when those come back empty too. A suspicion left unrefuted for
    ``suspicion_periods`` probe periods is confirmed dead; a suspected node
    refutes by bumping its incarnation. Membership digests ride on probe
    and ack traffic, at most ``digest_max`` entries a message; ``seed``
    seeds the decision stream.
    """

    enabled: bool = False
    probe_interval_s: float = 0.5
    probe_timeout_s: float = 0.15  # direct-ack deadline before ping-reqs
    indirect: int = 3  # K ping-req relays per failed direct probe
    suspicion_periods: int = 4  # probe periods before suspect -> dead
    digest_max: int = 12  # piggybacked membership entries per message
    seed: int = 0  # decision-stream seed (sims replay byte-identically)

    def __post_init__(self) -> None:
        if self.probe_interval_s <= 0:
            raise ValueError(
                f"probe_interval_s must be positive, got {self.probe_interval_s}"
            )
        if not 0 < self.probe_timeout_s < self.probe_interval_s:
            raise ValueError(
                "need 0 < probe_timeout_s < probe_interval_s, got "
                f"{self.probe_timeout_s}/{self.probe_interval_s}"
            )
        if not 0 <= self.indirect <= 16:
            raise ValueError(f"indirect must be in [0, 16], got {self.indirect}")
        if self.suspicion_periods < 1:
            raise ValueError(
                f"suspicion_periods must be >= 1, got {self.suspicion_periods}"
            )
        if not 1 <= self.digest_max <= 256:
            raise ValueError(
                f"digest_max must be in [1, 256], got {self.digest_max}"
            )

    @property
    def suspicion_window_s(self) -> float:
        """How long an unrefuted suspicion lives before it is confirmed."""
        return self.suspicion_periods * self.probe_interval_s


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault injection for the transports (the JAX package's
    ``control/chaos.py``).

    ``spec`` is the fault grammar (``"drop:p=0.05;partition:groups=m+0|1,
    at=round10,heal=5s"``, RESILIENCE.md); empty = chaos disabled. Every
    process derives its own decision stream from (seed, role), so the same
    seed replays the same event log.
    """

    seed: int = 0
    spec: str = ""

    @property
    def enabled(self) -> bool:
        return bool(self.spec)


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Closed-loop adaptive degradation (the JAX package's
    ``control/adapt.py``): the leader's per-round controller that trades
    ``th_reduce`` and wire precision against stragglers.

    It walks a ladder of ``levels`` steps (level 1: f16 wire and an
    interpolated threshold; level 2: int8 wire and ``floor_th_reduce``),
    once per ``window`` observed round completions. It degrades when a
    worker's contribution lag reaches ``lag_degrade`` rounds, the window's
    mean round latency passes ``slow_factor`` x the learned healthy one,
    rounds were re-started, reconnects and dropped sends reach
    ``noise_degrade``, or an endpoint's bytes fall below
    ``bw_degrade_ratio`` of the median endpoint's; it restores one level
    when lags are back under ``lag_restore``, the window was quiet and the
    level has held ``min_dwell`` rounds. Workers never read this section:
    the controller's output rides every message as the ``RoundPolicy``
    stamp.
    """

    enabled: bool = False
    levels: int = 2  # degrade steps past full fidelity (ladder depth)
    floor_th_reduce: float = 0.5  # th_reduce never degrades below this
    window: int = 8  # round completions per decision
    lag_degrade: int = 12  # worker contribution lag (rounds) that degrades
    lag_restore: int = 4  # lag must fall to this before a restore
    min_dwell: int = 16  # rounds at a level before the next transition
    slow_factor: float = 5.0  # window mean latency vs baseline that degrades
    noise_degrade: int = 8  # reconnects + drops a window; 0 = arm off
    bw_degrade_ratio: float = 0.0  # of the median endpoint's bytes; 0 = off

    def __post_init__(self) -> None:
        _check_fraction("floor_th_reduce", self.floor_th_reduce)
        if self.levels not in (1, 2):
            raise ValueError(f"levels must be 1 or 2, got {self.levels}")
        if self.window <= 0 or self.min_dwell < 0:
            raise ValueError(
                f"window must be > 0 and min_dwell >= 0, got "
                f"{self.window}/{self.min_dwell}"
            )
        if not 0 <= self.lag_restore < self.lag_degrade:
            raise ValueError(
                "need 0 <= lag_restore < lag_degrade, got "
                f"{self.lag_restore}/{self.lag_degrade}"
            )
        if self.slow_factor <= 1.0:
            raise ValueError(
                f"slow_factor must be > 1, got {self.slow_factor}"
            )
        if self.noise_degrade < 0:
            raise ValueError(
                f"noise_degrade must be >= 0, got {self.noise_degrade}"
            )
        if not 0.0 <= self.bw_degrade_ratio <= 0.5:
            # the restore bar is 2x the degrade bar; past 0.5 the restore
            # bar would exceed 1.0 and no balance could ever satisfy it
            raise ValueError(
                f"bw_degrade_ratio must be in [0, 0.5], got "
                f"{self.bw_degrade_ratio}"
            )


@dataclasses.dataclass(frozen=True)
class MasterConfig:
    """Cluster-wide control-plane config (reference ``MasterConfig``)."""

    node_num: int = 1  # expected nodes before lines are organized
    dimensions: int = 1  # grid dimensionality (2 => butterfly)
    # dims-1 round-scheduling shards: split the single all-workers line
    # into up to this many LineMasters, each owning a contiguous worker
    # subset (the paper's grid generalized: round fan-out stops being one
    # scheduler's job as the member count grows). 1 = the historical one
    # line; each line runs its own independent round sequence, so sharded
    # lines reduce within their subset (the grid reorganizes shards from
    # the membership view on every change).
    line_shards: int = 1
    # pod-grid coordinate bootstrap (control/pod.py, RESILIENCE.md
    # "Scale"): a configured RxC layout anchors node ids to grid
    # coordinates (row-major; nodes derive their preferred id from
    # process_index via ``--grid``), so shard membership and dims-2
    # row/column lines follow the POD LAYOUT instead of join order, and
    # every reorganize re-derives them from the current view with fixed
    # boundaries. 0/0 = no grid (the historical join-order behavior).
    grid_rows: int = 0
    grid_cols: int = 0
    heartbeat_interval_s: float = 1.0
    heartbeat_timeout_s: float = 5.0
    # stall watchdog (obs.watchdog): a line round in flight longer than this
    # dumps the flight recorder and counts a stall; 0 disables. Should be
    # generously above the expected round latency — it exists to turn a hung
    # run into a post-mortem artifact, not to police slow rounds.
    round_deadline_s: float = 0.0
    # transport send-retry budget, distributed via Welcome so every node's
    # transport escalates identically before declaring a peer dead
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)

    def __post_init__(self) -> None:
        # from_json hands sections to their dataclass as plain dicts;
        # coerce the nested policy so MasterConfig(**json_dict) just works
        if isinstance(self.retry, dict):
            object.__setattr__(self, "retry", RetryPolicy(**self.retry))
        if self.line_shards < 1:
            raise ValueError(
                f"line_shards must be >= 1, got {self.line_shards}"
            )
        if self.line_shards > 1 and self.dimensions != 1:
            raise ValueError(
                "line_shards applies to dimensions=1 only (2D grids are "
                f"already sharded into row/column lines), got dims="
                f"{self.dimensions}"
            )
        if (self.grid_rows > 0) != (self.grid_cols > 0):
            raise ValueError(
                "grid_rows/grid_cols must be set together (an RxC pod "
                f"layout), got {self.grid_rows}/{self.grid_cols}"
            )
        if self.grid_rows < 0 or self.grid_cols < 0:
            raise ValueError(
                f"grid sides must be >= 0, got "
                f"{self.grid_rows}/{self.grid_cols}"
            )
        if self.grid_rows > 0 and self.node_num > self.grid_rows * self.grid_cols:
            raise ValueError(
                f"node_num {self.node_num} exceeds the "
                f"{self.grid_rows}x{self.grid_cols} grid"
            )


@dataclasses.dataclass(frozen=True)
class AllreduceConfig:
    """Bundle threading every layer's knobs together (bootstrap convenience)."""

    threshold: ThresholdConfig = dataclasses.field(default_factory=ThresholdConfig)
    metadata: MetaDataConfig = dataclasses.field(
        default_factory=lambda: MetaDataConfig(data_size=1_048_576)
    )
    worker: WorkerConfig = dataclasses.field(default_factory=WorkerConfig)
    line_master: LineMasterConfig = dataclasses.field(default_factory=LineMasterConfig)
    node: NodeConfig = dataclasses.field(default_factory=NodeConfig)
    master: MasterConfig = dataclasses.field(default_factory=MasterConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    adapt: AdaptConfig = dataclasses.field(default_factory=AdaptConfig)
    data_plane: DataPlaneConfig = dataclasses.field(
        default_factory=DataPlaneConfig
    )
    gossip: GossipConfig = dataclasses.field(default_factory=GossipConfig)

    @classmethod
    def from_json(cls, text: str) -> "AllreduceConfig":
        raw: dict[str, Any] = json.loads(text)
        sections = {
            "threshold": ThresholdConfig,
            "metadata": MetaDataConfig,
            "worker": WorkerConfig,
            "line_master": LineMasterConfig,
            "node": NodeConfig,
            "master": MasterConfig,
            "chaos": ChaosConfig,
            "adapt": AdaptConfig,
            "data_plane": DataPlaneConfig,
            "gossip": GossipConfig,
        }
        unknown = set(raw) - set(sections)
        if unknown:
            raise ValueError(
                f"unknown config section(s) {sorted(unknown)}; "
                f"expected among {sorted(sections)}"
            )
        return cls(
            **{name: klass(**raw[name]) for name, klass in sections.items() if name in raw}
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)
