"""In-process router + local N-worker system — the reference's single-JVM dev
mode (BASELINE.json:7 "4 local JVM workers"), the port's own copy of the JAX
package's ``control/local.py``.

``LocalRouter`` is the whole transport: FIFO delivery between registered
handlers, with a pluggable drop filter for fault injection (the reference's
tests inject faults exactly this way — by omitting messages) and the shared
``chaos`` hook point (``control/chaos.py``, the same injector the TCP
transport takes). A corrupted payload goes through the real wire codec: its
values are copied off the card on the current stream (the stream that wrote
them), framed, flipped and decoded, so the checksum rejects it as it would
on a socket.

``LocalAllreduceSystem`` keeps every node's payloads on one device: the card
unless the caller passes ``device="cpu"``.

``local_engine`` builds such a system over seeded inputs already on the
device (config 1's shape by default) and ``EngineRun.run`` times it; the
config-1 record, the demo and the card's checks all run through it. Run as
a module (or ``python -m akka_allreduce_tpu_torch local-demo``) for the
config-1 throughput demo:

    python -m akka_allreduce_tpu_torch.control.local --nodes 4 --size 1000000 --rounds 20
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.config import (
    AllreduceConfig,
    ChaosConfig,
    LineMasterConfig,
    MasterConfig,
    MetaDataConfig,
    ThresholdConfig,
    WorkerConfig,
)
from akka_allreduce_tpu_torch.control.envelope import Envelope, peer_addr
from akka_allreduce_tpu_torch.control.grid_master import GridMaster
from akka_allreduce_tpu_torch.control.node import AllreduceNode
from akka_allreduce_tpu_torch.protocol import AllReduceInput

log = logging.getLogger(__name__)

DropFilter = Callable[[Envelope], bool]


class LocalRouter:
    """FIFO in-process message delivery with fault injection.

    Fault injection comes in two strengths: the ``drop_filter`` (omit
    matching messages, the reference's own technique) and the ``chaos``
    hook point: drop, duplicate, reorder (push-to-back; also how a planned
    delay shows in a synchronous router) and payload corruption through a
    wire-codec round trip, so the in-process mode exercises the real
    checksum rejection too.
    """

    def __init__(self, drop_filter: DropFilter | None = None) -> None:
        self._handlers: dict[str, Callable[[Any], list[Envelope]]] = {}
        self._prefix_handlers: dict[str, Callable[[int, Any], list[Envelope]]] = {}
        self._queue: deque[Envelope] = deque()
        self.drop_filter = drop_filter
        self.chaos = None  # control.chaos.ChaosInjector | None
        self.delivered = 0
        self.dropped = 0

    def register(self, addr: str, handler: Callable[[Any], list[Envelope]]) -> None:
        self._handlers[addr] = handler

    def register_prefix(
        self, prefix: str, handler: Callable[[int, Any], list[Envelope]]
    ) -> None:
        """Handle every ``prefix:<int>`` address (e.g. all ``worker:N``)."""
        self._prefix_handlers[prefix] = handler

    def send_all(self, envelopes: list[Envelope]) -> None:
        held: list[Envelope] = []
        for env in envelopes:
            if self.drop_filter is not None and self.drop_filter(env):
                self.dropped += 1
                continue
            if self.chaos is not None:
                act = self.chaos.plan_send(env)
                if act is not None:
                    self._apply_chaos(env, act, held)
                    continue
            self._queue.append(env)
        # a synchronous router has no clock to hold a message against:
        # delay/reorder become hold-until-end-of-batch, so every message
        # sent later in the same batch overtakes the held one (the FIFO
        # violation the TCP transport's delay produces)
        self._queue.extend(held)

    def _apply_chaos(self, env: Envelope, act, held: list[Envelope]) -> None:
        if act.drop or act.fail:
            self.dropped += 1  # no failure callbacks in-process: both drop
            return
        if act.corrupt:
            corrupted = self._corrupt_roundtrip(env, act)
            if corrupted is None:
                self.dropped += 1  # the checksum rejected the flip, as it must
                return
            env = corrupted
        sink = held if act.delay_s > 0 else self._queue
        sink.append(env)
        if act.duplicate:
            sink.append(env)

    def _corrupt_roundtrip(self, env: Envelope, act) -> Envelope | None:
        """Apply the payload bit flip through the real wire codec: encode
        (in the envelope's own wire mode, so an int8 or f16 round corrupts
        the bytes the TCP path would send), flip, decode. None when decode
        rejects the frame (the checksum doing its job)."""
        from akka_allreduce_tpu_torch.control import wire

        try:
            parts = wire.encode_frame_parts(env.dest, wire.to_host(env.msg), wire=env.wire)
            parts = self.chaos.corrupt_frame_parts(parts, act)
            body = b"".join(bytes(p) for p in parts)[4:]
            dest, msg = wire.decode_frame_body(body)
            return Envelope(dest, msg, via=env.via)
        except Exception:
            return None

    def run(self, max_messages: int = 1_000_000) -> int:
        """Deliver until quiescent; returns messages delivered."""
        n = 0
        while self._queue and n < max_messages:
            env = self._queue.popleft()
            handler = self._handlers.get(env.dest)
            if handler is None:
                prefix, _, suffix = env.dest.rpartition(":")
                ph = self._prefix_handlers.get(prefix)
                if ph is not None:
                    handler = lambda m, _ph=ph, _id=int(suffix): _ph(_id, m)
            if handler is None:
                log.warning("no handler for %s; dropping", env.dest)
                self.dropped += 1
                continue
            self.send_all(handler(env.msg))
            n += 1
        self.delivered += n
        return n


class LocalAllreduceSystem:
    """N nodes + grid master + router, fully in-process (dev/test mode), the
    payloads on ``device`` (default: the card)."""

    def __init__(
        self,
        n_nodes: int,
        data_sources,
        data_sinks,
        config: AllreduceConfig,
        drop_filter: DropFilter | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        if len(data_sources) != n_nodes or len(data_sinks) != n_nodes:
            raise ValueError(
                f"need {n_nodes} data sources and sinks, got "
                f"{len(data_sources)} and {len(data_sinks)}"
            )
        self.config = config
        self.device = resolve_device(device)
        self.master = GridMaster(config.threshold, config.master, config.line_master)
        self.router = LocalRouter(drop_filter)
        if config.chaos.enabled:
            # dev-mode chaos: one injector plays the whole single-process
            # cluster (role: master, which owns the router), with the spec
            # grammar and seed determinism of the TCP deployment
            from akka_allreduce_tpu_torch.control.chaos import MASTER_ROLE, ChaosInjector

            self.router.chaos = ChaosInjector(
                config.chaos.seed, config.chaos.spec, role=MASTER_ROLE,
                dims=config.master.dimensions,
            )
        self.nodes: dict[int, AllreduceNode] = {}
        for i in range(n_nodes):
            self.add_node(i, data_sources[i], data_sinks[i], join=False)
        self.router.register_prefix("worker", self._route_to_node)
        self.router.register_prefix("line_master", self.master.handle_for_line)

    def _route_to_node(self, worker_id: int, msg: Any) -> list[Envelope]:
        node = self.nodes.get(worker_id // self.config.master.dimensions)
        if node is None:
            return []  # node left the cluster; transport drops the message
        return node.handle(worker_id, msg)

    def add_node(self, node_id: int, source, sink, *, join: bool = True) -> None:
        self.nodes[node_id] = AllreduceNode(
            node_id,
            self.config.master.dimensions,
            source,
            sink,
            self.config.metadata,
            self.config.threshold,
            self.config.worker,
            device=self.device,
        )
        if join:
            self.router.send_all(self.master.member_up(node_id))

    def remove_node(self, node_id: int) -> None:
        self.nodes.pop(node_id, None)
        self.router.send_all(self.master.member_unreachable(node_id))

    def start(self) -> None:
        for node_id in sorted(self.nodes):
            self.router.send_all(self.master.member_up(node_id))

    def run_until_quiescent(self) -> int:
        return self.router.run()


@dataclasses.dataclass
class EngineRun:
    """One local engine system and what it flushed: ``outputs[i]`` is node
    i's flushes in order (the sink's ``AllReduceOutput``s when kept, else
    their round numbers); after :meth:`run`, ``seconds`` is the host clock
    from ``start()`` to quiescence, ended by a synchronize on the card."""

    system: LocalAllreduceSystem
    outputs: list[list]
    seconds: float = 0.0

    @property
    def rounds(self) -> int:
        """Rounds every node flushed (one collective across all nodes)."""
        return min(len(o) for o in self.outputs)

    def run(self) -> "EngineRun":
        sync = (torch.cuda.synchronize if self.system.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        self.system.start()
        self.system.run_until_quiescent()
        sync()
        self.seconds = time.perf_counter() - t0
        return self


def local_engine(
    size: int,
    *,
    nodes: int = 4,
    chunk: int = 262_144,
    rounds: int = 30,
    th: float = 1.0,
    dims: int = 1,
    drop_worker: int | None = None,
    device: str | torch.device | None = None,
    keep_outputs: bool = False,
    chaos: ChaosConfig | None = None,
) -> EngineRun:
    """A ``LocalAllreduceSystem``, not started, in which ``nodes`` nodes
    allreduce ``size`` seeded floats each for ``rounds`` rounds (round
    window 2, every threshold ``th``, zero-copy scatter of fixed input
    tensors already on the device). With ``drop_worker`` every message from
    that worker to another is lost, as the JAX suite's config 5 loses it;
    with an enabled ``chaos`` the router's injector runs that spec."""
    dev = resolve_device(device)
    cfg = AllreduceConfig(
        threshold=ThresholdConfig(th, th, th),
        metadata=MetaDataConfig(data_size=size, max_chunk_size=chunk),
        line_master=LineMasterConfig(round_window=2, max_rounds=rounds),
        master=MasterConfig(node_num=nodes, dimensions=dims),
        worker=WorkerConfig(zero_copy_scatter=True),  # fixed input tensors
        chaos=chaos or ChaosConfig(),
    )
    # seeded by numpy, so every device gets the same floats, and moved to the
    # device once, before any clock starts
    rng = np.random.default_rng(0)
    inputs = [torch.from_numpy(rng.standard_normal(size).astype(np.float32)).to(dev)
              for _ in range(nodes)]
    outputs: list[list] = [[] for _ in range(nodes)]

    def sink_for(i):
        if keep_outputs:
            return outputs[i].append
        return lambda out: outputs[i].append(out.iteration)

    def lost(env) -> bool:
        return (getattr(env.msg, "src_id", None) == drop_worker
                and env.dest != peer_addr(drop_worker))

    system = LocalAllreduceSystem(
        nodes,
        [lambda req, i=i: AllReduceInput(inputs[i]) for i in range(nodes)],
        [sink_for(i) for i in range(nodes)],
        cfg,
        drop_filter=None if drop_worker is None else lost,
        device=dev,
    )
    return EngineRun(system, outputs)


def main(argv: list[str] | None = None) -> int:
    """The config-1 throughput demo: ``--nodes`` nodes allreduce seeded
    ``--size``-float inputs for ``--rounds`` rounds; prints one line with
    the rounds every node flushed, the time, the throughput and the engine's
    device."""
    parser = argparse.ArgumentParser(
        "local-demo", description="local N-worker allreduce demo on the host engine"
    )
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--size", type=int, default=1_000_000)
    parser.add_argument("--rounds", type=int, default=20)
    parser.add_argument("--chunk", type=int, default=262_144)
    parser.add_argument("--dims", type=int, default=1)
    parser.add_argument("--th", type=float, default=1.0, help="all three thresholds")
    parser.add_argument("--chaos-seed", type=int, default=0)
    parser.add_argument(
        "--chaos-spec", default="",
        help="dev-mode chaos on the in-process router (drop/duplicate/"
        "reorder/corrupt, RESILIENCE.md); empty = off",
    )
    parser.add_argument(
        "--device", default=None,
        help="'cpu' keeps the payloads on the CPU; default: the CUDA card",
    )
    args = parser.parse_args(argv)
    if args.chaos_spec:
        from akka_allreduce_tpu_torch.control.chaos import parse_spec

        try:
            parse_spec(args.chaos_spec)  # a bad spec fails before any run
        except ValueError as e:
            parser.error(str(e))
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from akka_allreduce_tpu_torch.utils.benchmarking import device_fields

    dev = resolve_device(args.device)
    run = local_engine(args.size, nodes=args.nodes, chunk=args.chunk, rounds=args.rounds,
                       th=args.th, dims=args.dims, device=dev,
                       chaos=ChaosConfig(seed=args.chaos_seed, spec=args.chaos_spec)).run()
    # a "round" is one collective across ALL nodes; count rounds every node
    # flushed, not per-node flush events
    total_bytes = args.size * 4 * run.rounds
    print(
        f"nodes={args.nodes} size={args.size} rounds_completed={run.rounds} "
        f"(per-node flushes: {[len(o) for o in run.outputs]}) "
        f"elapsed={run.seconds:.3f}s "
        f"allreduce_throughput={total_bytes / run.seconds / 1e6:.1f} MB/s "
        f"engine={dev.type} ({device_fields(dev)['device']}; round buffers on "
        f"this device, bookkeeping on the host)",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
