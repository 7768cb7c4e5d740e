"""Per-node supervisor: one worker per grid dimension (reference
``AllreduceNode`` / ``AllreduceDimensionNode``, SURVEY.md §3), the port's
own copy of the JAX package's ``control/node.py``.

Butterfly composition (SURVEY.md §4.3): the dim-0 worker allreduces along
this node's row line; its per-round output feeds the dim-1 worker's data
source, which allreduces along the column line. To keep contributor counts
exact under thresholds, the dim-0 -> dim-1 chain payload is
``concat(sum, counts)``: dim 1 sums both halves, so the final count of an
element is the number of original contributors that reached it through both
stages. The chain stays on the workers' device.

Because line masters run independently, dim-1's ``StartAllreduce(r)`` can
arrive before dim-0 has produced round r's output; the node stashes the
start and replays it when the chain data is ready.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.config import (
    MetaDataConfig,
    ThresholdConfig,
    WorkerConfig,
)
from akka_allreduce_tpu_torch.control.envelope import Envelope
from akka_allreduce_tpu_torch.control.worker import AllreduceWorker, DataSink, DataSource
from akka_allreduce_tpu_torch.protocol import (
    AllReduceInput,
    AllReduceInputRequest,
    AllReduceOutput,
    StartAllreduce,
)

log = logging.getLogger(__name__)


class AllreduceNode:
    """Hosts ``dims`` chained workers; routes their messages by worker id."""

    def __init__(
        self,
        node_id: int,
        dims: int,
        data_source: DataSource,
        data_sink: DataSink,
        metadata: MetaDataConfig,
        threshold: ThresholdConfig,
        worker_config: WorkerConfig = WorkerConfig(),
        stash_window: int = 8,
        flush_floors: dict[int, int] | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        if dims not in (1, 2):
            raise ValueError(f"dims must be 1 or 2, got {dims}")
        self.node_id = node_id
        self.dims = dims
        self.metadata = metadata
        self.stash_window = stash_window
        self.device = resolve_device(device)
        self._chain: dict[int, torch.Tensor] = {}  # round -> concat(sum, counts)
        self._pending_starts: dict[int, StartAllreduce] = {}
        self.workers: dict[int, AllreduceWorker] = {}

        if dims == 1:
            w0 = AllreduceWorker(data_source, data_sink, worker_config, device=self.device)
            w0.configure(metadata, threshold)
            self.workers[0] = w0
        else:
            w0 = AllreduceWorker(data_source, self._chain_sink, worker_config,
                                 device=self.device)
            w0.configure(metadata, threshold)
            chain_meta = MetaDataConfig(
                data_size=2 * metadata.data_size,
                max_chunk_size=metadata.max_chunk_size,
            )
            w1 = AllreduceWorker(
                self._chain_source,
                self._final_sink_wrapper(data_sink),
                worker_config,
                device=self.device,
            )
            w1.configure(chain_meta, threshold)
            self.workers[0] = w0
            self.workers[1] = w1
        # the dedup floor survives node rebuilds: pass flush_floors() of the
        # instance being replaced
        for dim, floor in (flush_floors or {}).items():
            if dim in self.workers:
                self.workers[dim].flushed_up_to = floor

    def flush_floors(self) -> dict[int, int]:
        """Per-dimension highest flushed round — hand to the replacement
        AllreduceNode so re-issued round ids dedup across rebuilds."""
        return {dim: w.flushed_up_to for dim, w in self.workers.items()}

    # -- chain plumbing (dims == 2) -----------------------------------------

    def _chain_sink(self, out: AllReduceOutput) -> None:
        payload = torch.cat([out.data, out.count.to(torch.float32)])
        self._chain[out.iteration] = payload
        for stale in [r for r in self._chain if r < out.iteration - self.stash_window]:
            del self._chain[stale]
        for stale in [
            r for r in self._pending_starts if r < out.iteration - self.stash_window
        ]:
            del self._pending_starts[stale]  # dim-0 abandoned these rounds

    def _chain_source(self, req: AllReduceInputRequest) -> AllReduceInput:
        payload = self._chain.get(req.iteration)
        if payload is None:
            raise RuntimeError(
                f"node {self.node_id}: dim-1 round {req.iteration} started "
                "before dim-0 produced it (stash ordering bug)"
            )
        return AllReduceInput(payload)

    @staticmethod
    def _final_sink_wrapper(user_sink: DataSink):
        def sink(out: AllReduceOutput) -> None:
            n = out.data.shape[0] // 2
            # An element is valid only if BOTH its halves survived dim-1's
            # th_complete (sum at i, count at n+i land in different chunks,
            # so one can be dropped without the other); masking with dim-1's
            # own fill counts keeps sums and counts exactly paired. The
            # counts come back through rint (torch.round: half to even).
            ok = (out.count[:n] > 0) & (out.count[n:] > 0)
            total = torch.where(ok, out.data[:n], torch.zeros_like(out.data[:n]))
            counts = torch.where(
                ok,
                torch.round(out.data[n:]).to(torch.int32),
                torch.zeros(n, dtype=torch.int32, device=out.data.device),
            )
            user_sink(AllReduceOutput(total, counts, out.iteration))

        return sink

    # -- message routing -----------------------------------------------------

    def dim_of(self, worker_id: int) -> int:
        return worker_id % self.dims

    def handle(self, worker_id: int, msg: Any) -> list[Envelope]:
        dim = self.dim_of(worker_id)
        worker = self.workers[dim]
        if (
            self.dims == 2
            and dim == 1
            and isinstance(msg, StartAllreduce)
            and msg.round_num not in self._chain
        ):
            self._pending_starts[msg.round_num] = msg
            return []
        out = worker.handle(msg)
        if self.dims == 2 and dim == 0:
            out.extend(self._replay_ready_starts())
        return out

    def _replay_ready_starts(self) -> list[Envelope]:
        out: list[Envelope] = []
        for r in sorted(self._pending_starts):
            if r in self._chain:
                msg = self._pending_starts.pop(r)
                out.extend(self.workers[1].handle(msg))
        return out
