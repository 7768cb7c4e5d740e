"""Per-round data-plane buffers with threshold accounting: the port's own
copy of the JAX package's ``buffers.py``, with its payloads on a device.

- ``ScatteredDataBuffer`` — storage for incoming scatter chunks of this
  worker's block; counts contributions per chunk; answers "reached the
  reduce threshold?"; sums the chunk.
- ``ReducedDataBuffer`` — storage for reduced chunks received back from
  peers; tracks the fill against ``th_complete``; hands out the round's
  output with per-element contributor counts.
- ``RoundBuffers`` — the bounded out-of-order window of per-round buffer
  pairs.

The sums and the assembled output are tensors on the engine's device (the
card, or the CPU); each store is one copy or one add there. Every decision a
message makes — the contribution flags, the per-chunk counts, the filled
flags, the once-only edge flags — is numpy on the host, as in the JAX
buffers, so no store and no threshold check waits on the card. Per-element
counts reach the device only at flush (``tensor_reduce.expand_counts``).
"""

from __future__ import annotations

import numpy as np
import torch

from akka_allreduce_tpu_torch import tensor_reduce
from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.config import MetaDataConfig, ThresholdConfig
from akka_allreduce_tpu_torch.protocol import as_tensor


class RoundOutOfWindowError(Exception):
    """A message referenced a round outside the bounded out-of-order window —
    either already flushed (stale duplicate) or too far in the future."""


def _check_chunk(value: torch.Tensor, length: int, what: str) -> None:
    if tuple(value.shape) != (length,):
        raise ValueError(
            f"{what} expects shape ({length},), got {tuple(value.shape)}"
        )


class ScatteredDataBuffer:
    """Accumulates scatter contributions for one worker's block in one round.

    The owner's block is partitioned into chunks of at most ``max_chunk_size``.
    Each peer (including the owner) sends one contribution per chunk; when a
    chunk's contribution count reaches ``ceil(th_reduce * peer_size)`` the
    chunk is ready to reduce. ``reduce`` returns the running sum and the
    contributor count (contributions after the threshold still accumulate
    until reduce is called).
    """

    def __init__(
        self,
        metadata: MetaDataConfig,
        threshold: ThresholdConfig,
        peer_size: int,
        block_size: int | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        if peer_size <= 0:
            raise ValueError(f"peer_size must be positive, got {peer_size}")
        if block_size is not None and block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.metadata = metadata
        self.threshold = threshold
        self.peer_size = peer_size
        self.device = resolve_device(device)
        self.block_size = (
            metadata.block_size(peer_size) if block_size is None else block_size
        )
        self.num_chunks = max(1, -(-self.block_size // metadata.max_chunk_size))
        # torch.empty, not zeros: the first store per chunk copies instead of
        # accumulating, so the storage is never read uninitialized
        self._sums = torch.empty(self.block_size, dtype=torch.float32, device=self.device)
        self._counts = np.zeros(self.num_chunks, dtype=np.int32)
        self._contributed = np.zeros((self.num_chunks, peer_size), dtype=bool)
        self._reduced = np.zeros(self.num_chunks, dtype=bool)
        # the once-only crossing signal per chunk, apart from _reduced so the
        # edge fires exactly once even when the caller defers reduce() and
        # when set_reduce_trigger lowers the bar under counts already past it
        self._edge_fired = np.zeros(self.num_chunks, dtype=bool)
        self.reduce_trigger = threshold.reduce_count(peer_size)

    def _chunk_bounds(self, chunk_id: int) -> tuple[int, int]:
        if not 0 <= chunk_id < self.num_chunks:
            raise IndexError(f"chunk_id {chunk_id} out of [0, {self.num_chunks})")
        start = chunk_id * self.metadata.max_chunk_size
        return start, min(start + self.metadata.max_chunk_size, self.block_size)

    def chunk_size(self, chunk_id: int) -> int:
        start, stop = self._chunk_bounds(chunk_id)
        return stop - start

    def store(self, value, src_id: int, chunk_id: int) -> bool:
        """Accumulate one peer's contribution to one chunk (idempotent per src).

        Returns True iff this store just *crossed* the reduce trigger — the
        edge-triggered signal the worker uses to reduce-and-broadcast exactly
        once per chunk. Duplicate deliveries return False without accumulating.
        """
        start, stop = self._chunk_bounds(chunk_id)  # validates chunk_id
        if not 0 <= src_id < self.peer_size:
            raise IndexError(f"src_id {src_id} out of [0, {self.peer_size})")
        if self._contributed[chunk_id, src_id]:
            return False  # duplicate delivery
        value = as_tensor(value)
        _check_chunk(value, stop - start, f"chunk {chunk_id}")
        # After reduce() the sum has been broadcast: late arrivals are counted
        # but no longer accumulated, so the view reduce() handed out stays as
        # it was broadcast.
        if not self._reduced[chunk_id]:
            if self._counts[chunk_id] == 0:  # first contribution: plain copy
                self._sums[start:stop].copy_(value)
            else:
                tensor_reduce.accumulate(self._sums[start:stop], value.to(self.device))
        self._counts[chunk_id] += 1
        self._contributed[chunk_id, src_id] = True
        # >= guarded by the once-only edge flag (not ==): the trigger may
        # have been lowered by set_reduce_trigger under counts already past
        # it, and the first store at or beyond the bar must still fire once
        if (
            self._edge_fired[chunk_id]
            or self._reduced[chunk_id]
            or int(self._counts[chunk_id]) < self.reduce_trigger
        ):
            return False
        self._edge_fired[chunk_id] = True
        return True

    def set_reduce_trigger(self, trigger: int) -> list[int]:
        """Apply a per-round effective reduce trigger (``RoundPolicy``).
        Returns the chunks that already satisfy the new trigger and await
        reduce — the caller must reduce-and-broadcast them now, exactly as
        if ``store`` had just crossed. Clamped to [1, peer_size]."""
        trigger = max(1, min(int(trigger), self.peer_size))
        if trigger == self.reduce_trigger:
            return []
        self.reduce_trigger = trigger
        ready = [
            c
            for c in range(self.num_chunks)
            if not self._reduced[c]
            and not self._edge_fired[c]
            and int(self._counts[c]) >= trigger
        ]
        for c in ready:
            self._edge_fired[c] = True
        return ready

    def count(self, chunk_id: int) -> int:
        self._chunk_bounds(chunk_id)
        return int(self._counts[chunk_id])

    def reach_reducing_threshold(self, chunk_id: int) -> bool:
        """Level query: chunk has enough contributions and awaits ``reduce``.

        Stays True from the trigger crossing until ``reduce`` is called; for
        the once-only broadcast decision use ``store``'s return value instead.
        """
        self._chunk_bounds(chunk_id)  # reject out-of-range (incl. negative) ids
        return (
            not self._reduced[chunk_id]
            and int(self._counts[chunk_id]) >= self.reduce_trigger
        )

    def reduce(self, chunk_id: int) -> tuple[torch.Tensor, int]:
        """Return (summed chunk, contributor count) and mark the chunk reduced.

        The returned tensor is a view into the buffer's storage, with no copy
        on the broadcast path. Torch has no read-only flag to match the JAX
        buffer's ``flags.writeable = False``; the view stays as it was
        broadcast because ``store`` never adds into a reduced chunk again.
        """
        start, stop = self._chunk_bounds(chunk_id)
        if int(self._counts[chunk_id]) == 0 and not self._reduced[chunk_id]:
            # no contributions: the storage was never written — present zeros
            self._sums[start:stop].zero_()
        self._reduced[chunk_id] = True
        return self._sums[start:stop], int(self._counts[chunk_id])


class ReducedDataBuffer:
    """Assembles reduced chunks received back from peers into the round output.

    The full output buffer (size ``data_size``) is the concatenation of every
    peer's block. Each incoming ``ReduceBlock`` fills one chunk of one block
    and carries the contributor count for that chunk; completion fires when
    the number of filled chunks reaches ``ceil(th_complete * total_chunks)``.
    """

    def __init__(
        self,
        metadata: MetaDataConfig,
        threshold: ThresholdConfig,
        peer_size: int,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        if peer_size <= 0:
            raise ValueError(f"peer_size must be positive, got {peer_size}")
        self.metadata = metadata
        self.threshold = threshold
        self.peer_size = peer_size
        self.device = resolve_device(device)
        self.block_size = metadata.block_size(peer_size)
        self.chunks_per_block = metadata.chunks_per_block(peer_size)
        self.total_chunks = self.chunks_per_block * peer_size
        # covers peer_size * block_size >= data_size; the trailing pad is cut
        self._data = torch.zeros(
            peer_size * self.block_size, dtype=torch.float32, device=self.device
        )
        # one contributor count per chunk on the host, expanded to elements
        # on the device only at flush
        self._chunk_counts = np.zeros((peer_size, self.chunks_per_block), dtype=np.int32)
        self._filled = np.zeros((peer_size, self.chunks_per_block), dtype=bool)
        self.completion_trigger = threshold.complete_count(self.total_chunks)
        # chunk lengths within one block (the same for every block): full
        # chunks then a possibly short tail
        self._chunk_lengths = np.array(
            [metadata.chunk_size(peer_size, c) for c in range(self.chunks_per_block)],
            dtype=np.int64,
        )

    def _bounds(self, src_id: int, chunk_id: int) -> tuple[int, int]:
        if not 0 <= src_id < self.peer_size:
            raise IndexError(f"src_id {src_id} out of [0, {self.peer_size})")
        if not 0 <= chunk_id < self.chunks_per_block:
            raise IndexError(
                f"chunk_id {chunk_id} out of [0, {self.chunks_per_block})"
            )
        start = src_id * self.block_size + chunk_id * self.metadata.max_chunk_size
        stop = min(start + self.metadata.max_chunk_size, (src_id + 1) * self.block_size)
        return start, stop

    def store(self, value, src_id: int, chunk_id: int, count: int) -> None:
        """Place a reduced chunk from peer ``src_id`` into the output buffer."""
        start, stop = self._bounds(src_id, chunk_id)  # validates ids first
        if self._filled[src_id, chunk_id]:
            return  # duplicate delivery
        value = as_tensor(value)
        _check_chunk(value, stop - start, f"block {src_id} chunk {chunk_id}")
        self._data[start:stop].copy_(value)
        self._chunk_counts[src_id, chunk_id] = count
        self._filled[src_id, chunk_id] = True

    @property
    def filled_chunks(self) -> int:
        return int(self._filled.sum())

    def reach_completion_threshold(self) -> bool:
        return self.filled_chunks >= self.completion_trigger

    def get_with_counts(self, copy: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """(data, per-element contributor counts), trimmed to ``data_size``,
        both on the buffer's device.

        Unfilled chunks read as zeros with count 0. ``copy=False`` returns a
        view into the buffer's storage — only for callers that immediately
        retire the buffer (the worker flushes and evicts the round in the
        same step); later ``store`` calls would write through the view.
        """
        n = self.metadata.data_size
        lengths = np.tile(self._chunk_lengths, self.peer_size)
        counts = tensor_reduce.expand_counts(
            self._chunk_counts.reshape(-1), lengths, n, self.device
        )
        data = self._data[:n]
        return (data.clone() if copy else data), counts


class RoundBuffers:
    """Bounded out-of-order window of per-round buffer pairs.

    The worker may receive ``ScatterBlock``/``ReduceBlock`` for rounds it has
    not started yet (peers run ahead within the line master's round window);
    those land in buffers created on demand. Rounds older than the completed
    horizon are dropped.
    """

    def __init__(
        self,
        metadata: MetaDataConfig,
        threshold: ThresholdConfig,
        peer_size: int,
        window: int = 4,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.metadata = metadata
        self.threshold = threshold
        self.peer_size = peer_size
        self.window = window
        self.device = resolve_device(device)
        self._scattered: dict[int, ScatteredDataBuffer] = {}
        self._reduced: dict[int, ReducedDataBuffer] = {}
        self.completed_up_to = -1  # all rounds <= this are flushed

    def in_window(self, round_num: int) -> bool:
        return self.completed_up_to < round_num <= self.completed_up_to + self.window

    def _check_window(self, round_num: int) -> None:
        if not self.in_window(round_num):
            raise RoundOutOfWindowError(
                f"round {round_num} outside window "
                f"({self.completed_up_to}, {self.completed_up_to + self.window}]"
            )

    def scattered(self, round_num: int) -> ScatteredDataBuffer:
        self._check_window(round_num)
        if round_num not in self._scattered:
            self._scattered[round_num] = ScatteredDataBuffer(
                self.metadata, self.threshold, self.peer_size, device=self.device
            )
        return self._scattered[round_num]

    def reduced(self, round_num: int) -> ReducedDataBuffer:
        self._check_window(round_num)
        if round_num not in self._reduced:
            self._reduced[round_num] = ReducedDataBuffer(
                self.metadata, self.threshold, self.peer_size, device=self.device
            )
        return self._reduced[round_num]

    def complete(self, round_num: int) -> None:
        """Mark ``round_num`` flushed and evict everything at or below it."""
        self.completed_up_to = max(self.completed_up_to, round_num)
        for store in (self._scattered, self._reduced):
            for r in [r for r in store if r <= self.completed_up_to]:
                del store[r]

    def fast_forward(self, round_num: int) -> None:
        """Re-sync a lagging worker: abandon all rounds that can no longer fit
        in the window once ``round_num`` is admitted. Only call on
        master-authoritative evidence (a ``StartAllreduce``) that older rounds
        are already abandoned cluster-wide."""
        self.complete(round_num - self.window)
