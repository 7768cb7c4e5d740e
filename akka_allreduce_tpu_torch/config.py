"""Typed configuration: the port's own copy of the JAX package's
``ThresholdConfig`` and ``MetaDataConfig`` (``akka_allreduce_tpu/config.py``),
with the same fields, defaults and validation.

The three threshold fractions decide when a round completes with whichever
workers have contributed; the single-card round uses
``ThresholdConfig.reduce_count`` to decide which virtual workers count.
"""

from __future__ import annotations

import dataclasses
import math


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
