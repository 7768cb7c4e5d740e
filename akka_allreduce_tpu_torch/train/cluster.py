"""Distributed elastic-averaging training over the TCP cluster.

Counterpart of ``akka_allreduce_tpu/train/cluster.py``
(``ElasticClusterNode``): per node process, a local trainer steps on its
own data shard on a learner thread while the ``NodeProcess``
(``control/bootstrap.py``) runs allreduce rounds over TCP, and the
elastic-averaging binder pulls the weights toward the group's average.

Learner and binder never block each other. The learner publishes a weight
snapshot after each step; binder rounds read the newest snapshot and
deposit their averaged result in a mailbox the learner folds in before its
next step. Both hand-offs are single reference swaps, so no lock is held
across a step or a round and heartbeats keep flowing while the learner
works.

On the card both cells hold tensors on the node's device. The learner
thread writes a snapshot on its current stream and the event loop's
transport copies it off the card on its own current stream (``d2h``, when
the message is sent), so each cell carries a CUDA event recorded after the
writes, and the reading thread's stream waits on it before it touches the
tensor; the deposit crosses the other way the same way. A published tensor
is never written again (the next publish is a new tensor), as the worker's
zero-copy scatter requires.

The learner runs on one dedicated thread, so its CUDA state (cuBLAS
handles, the caching allocator's streams) is made once; its first step
creates it. The node itself creates the CUDA context before it joins.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import time
from typing import Callable, Iterator

import torch

from akka_allreduce_tpu_torch.binder.elastic import ElasticAverageBinder
from akka_allreduce_tpu_torch.control.bootstrap import NodeProcess
from akka_allreduce_tpu_torch.control.cluster import Endpoint
from akka_allreduce_tpu_torch.control.remote import observed_task

log = logging.getLogger(__name__)


class _Cell:
    """A tensor handed from one thread to another: the tensor, and on the
    card the event recorded on the writer's stream after its writes."""

    __slots__ = ("tensor", "ready")

    def __init__(self, tensor: torch.Tensor) -> None:
        self.tensor = tensor
        self.ready = None
        if tensor.is_cuda:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(tensor.device))

    def take(self) -> torch.Tensor:
        """The tensor, the reader's current stream ordered after its writes."""
        if self.ready is not None:
            torch.cuda.current_stream(self.tensor.device).wait_event(self.ready)
        return self.tensor


class ElasticClusterNode:
    """One training node: local steps + asynchronous weight allreduce.

    Args:
      seed: the master's endpoint.
      trainer: a ``DPTrainer``, ``Zero1DPTrainer`` or ``LongContextTrainer``
        (typically over one rank), or an ``ElasticTrainer``, whose mesh then
        follows the cluster's membership view (``apply_membership``) and
        whose compress mode follows the leader's ``RoundPolicy`` wire stamp
        (``apply_policy_wire``), both applied on the learner thread.
      batches: an iterator of ``(x, y)`` global batches, or a callable
        ``trainer -> (x, y) | None`` for elastic trainers (the batch follows
        the current mesh; None ends training).
      elastic_rate: pull strength toward the group average.
      allow_crash: let a seeded chaos ``crash`` end this process (a real
        OS process only; in-process the injector records a suppressed
        crash).
      chaos_log: the injector's event-log path (written when a seeded
        crash ends the process).
    """

    def __init__(
        self,
        seed: Endpoint,
        trainer,
        batches: Iterator | Callable,
        *,
        elastic_rate: float = 0.5,
        host: str = "127.0.0.1",
        port: int = 0,
        preferred_node_id: int = -1,
        on_step: Callable[[object], None] | None = None,
        allow_crash: bool = False,
        chaos_log: str | None = None,
    ) -> None:
        self.trainer = trainer
        self.batches = batches
        self.on_step = on_step
        # the elastic plumbing is armed by capability, not by type
        self._elastic = hasattr(trainer, "apply_membership")
        # the node's round buffers live where the trainer's weights do
        self.device = trainer.device
        # cross-thread hand-off cells, each access one reference swap:
        #   _snapshot: newest weights, published by the learner, read by
        #              binder rounds on the event loop;
        #   _incoming: newest averaged weights, deposited by the binder,
        #              folded in by the learner before its next step;
        #   _members:  newest membership view, deposited by the event loop,
        #              applied by the learner before its next step (a newer
        #              view overwrites an unapplied one)
        self._snapshot = self._publish()
        self._incoming: _Cell | None = None
        self._members: tuple[int, ...] | None = None
        self._last_wire = ""
        self._policy_unsupported = False
        self.remeshes = 0
        self.compress_changes = 0
        self.paused = False  # below min_nodes: waiting for a rejoin
        self.binder = ElasticAverageBinder(self._read_snapshot, self._deposit, elastic_rate)
        self.node = NodeProcess(seed, self.binder.data_source, self.binder.data_sink,
                                host, port, preferred_node_id=preferred_node_id,
                                allow_crash=allow_crash, chaos_log=chaos_log,
                                device=self.device)
        if self._elastic:
            self.node.on_members = self._on_members
        self.losses: list[float] = []
        self._learner: concurrent.futures.ThreadPoolExecutor | None = None

    # -- binder seam (the event loop's thread; must never block) -------------

    def _publish(self) -> _Cell:
        return _Cell(self.trainer.flat_params_tensor())

    def _read_snapshot(self) -> torch.Tensor:
        return self._snapshot.take()

    def _deposit(self, vec: torch.Tensor) -> None:
        self._incoming = _Cell(vec)

    def _on_members(self, members: tuple[int, ...]) -> None:
        self._members = members

    # -- learner thread ------------------------------------------------------

    def _apply_cluster_view(self) -> None:
        """Fold the cluster's state into the elastic trainer: the newest
        membership view, then the newest policy wire stamp, each through
        the wrapper's rebuild path."""
        members, self._members = self._members, None
        if members is not None:
            try:
                if self.trainer.apply_membership(members):
                    self.remeshes += 1
            except RuntimeError as e:
                # a view without any assigned node (mid-rejoin): keep
                # stepping on the old mesh until the next view lands
                log.warning("membership %s not applied: %s", members, e)
        wire = self.node.policy_wire()
        if wire != self._last_wire and not self._policy_unsupported:
            self._last_wire = wire
            try:
                if self.trainer.apply_policy_wire(wire):
                    self.compress_changes += 1
                    log.info("policy wire %r -> compress %s", wire, self.trainer.compress_mode)
            except RuntimeError as e:
                # a factory without a `compress` kwarg has no rebuild path:
                # keep the construction mode and stop retrying
                self._policy_unsupported = True
                log.warning("policy wire %r not applied: %s", wire, e)

    def _next_batch(self):
        if callable(self.batches):
            return self.batches(self.trainer)
        try:
            return next(self.batches)
        except StopIteration:
            return None

    def _fold_incoming(self) -> None:
        incoming, self._incoming = self._incoming, None  # one reference swap
        if incoming is not None:
            self.trainer.set_flat_params(incoming.take())

    def _train_one(self) -> str:
        """One learner iteration: "stepped", "paused" (below min_nodes,
        holding position) or "end" (the batches ran out)."""
        if self._elastic:
            self._apply_cluster_view()
            if self.trainer.n_nodes < self.trainer.min_nodes:
                # hold position until a rejoin regrows the mesh; the binder
                # keeps answering rounds with the last snapshot
                self.paused = True
                time.sleep(0.2)
                return "paused"
            self.paused = False
        batch = self._next_batch()
        if batch is None:
            return "end"
        x, y = batch
        self._fold_incoming()
        m = self.trainer.train_step(x, y)
        self._snapshot = self._publish()
        self.losses.append(m.loss)
        if self.on_step is not None:
            self.on_step(m)
        return "stepped"

    async def _learn(self) -> str:
        return await asyncio.get_running_loop().run_in_executor(self._learner, self._train_one)

    # -- lifecycle -----------------------------------------------------------

    async def run(self, max_steps: int | None = None, *, warmup_steps: int = 0) -> int:
        """Join the cluster, then train until the batches run out,
        ``max_steps`` is reached, or the master broadcasts Shutdown.
        Returns the steps taken, warm-up included. ``warmup_steps`` run
        before the join, so the node enters with weights worth averaging
        and its learner's CUDA state made."""
        self._learner = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="learner")
        try:
            return await self._run(max_steps, warmup_steps)
        finally:
            self._learner.shutdown(wait=True)

    async def _run(self, max_steps: int | None, warmup_steps: int) -> int:
        warmed = 0
        for _ in range(warmup_steps):
            if await self._learn() != "stepped":
                break
            warmed += 1
        await self.node.start()
        node_id = await self.node.wait_welcomed()
        expected = self.node.config.metadata.data_size
        if expected != self.trainer.param_count:
            raise ValueError(
                f"cluster data_size {expected} != model param count "
                f"{self.trainer.param_count}: master and nodes must be started with "
                "the same model flags")
        log.info("trainer node %d: %d params, elastic_rate=%.2f", node_id,
                 self.trainer.param_count, self.binder.elastic_rate)
        steps = warmed
        shutdown = observed_task(self.node.run_until_shutdown(), name="shutdown-watch")
        try:
            # a step budget is the node's own contract: train it to the end,
            # syncing while rounds last; only an unbounded learner stops on
            # the master's Shutdown
            while max_steps is None or steps < max_steps:
                if max_steps is None and shutdown.done():
                    break
                outcome = await self._learn()
                if outcome == "end":
                    break
                if outcome == "paused" and shutdown.done():
                    break  # a paused learner cannot finish its budget
                if outcome == "stepped":
                    steps += 1
            if not shutdown.done():
                # depart gracefully so the others re-line without waiting
                # for the detector
                await self.node.leave()
            # fold the last round's average in before reporting weights
            await asyncio.get_running_loop().run_in_executor(self._learner,
                                                             self._fold_incoming)
        finally:
            if not shutdown.done():
                shutdown.cancel()
            await self.node.stop()
        return steps

    @property
    def rounds_applied(self) -> int:
        return self.binder.rounds_applied
