"""The TCP control plane's commands: the port's copies of the JAX CLI's
``cluster-master``, ``cluster-node``, ``cluster-standby``, ``bench-wire`` and
``obs``, with the same flags and the same output lines.

- ``cluster-master`` holds no payload and opens no CUDA context: it
  schedules rounds and keeps the membership.
- ``cluster-node`` runs its round buffers and its payload on the card unless
  given ``--device cpu``. It draws its payload with numpy's
  ``default_rng(seed).standard_normal(size)``, as the JAX command does, and
  puts it on its device once. Its shutdown line adds ``device=`` and, on the
  card, the card's name and power limit; ``--flush-out FILE`` writes its last
  flush (``data``, ``count``, ``iteration``) as ``.npz``.
- ``bench-wire`` frames payload tensors that lie on ``--device`` (the card
  unless ``cpu``), so on the card its encode leg includes the copy to the
  host; its records add ``device`` and ``power_limit``.
- ``obs demo`` starts the master and ``--nodes`` node processes as new
  interpreters (``python -m akka_allreduce_tpu_torch``), never by forking a
  process that has started CUDA.

``--chaos-seed``/``--chaos-spec`` on a master arm the seeded chaos injector
on every process of the cluster (the spec travels with ``Welcome``);
``--chaos-log`` writes a process's deterministic event log on exit; the
``--adapt*`` flags run the leader's adaptive controller. The chaos drills
that drive these roles live in ``chaos_cli.py``.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

# -- flags ------------------------------------------------------------------


def _add_obs_flags(p: argparse.ArgumentParser) -> None:
    """Observability flags shared by the cluster roles (``obs/``)."""
    p.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="write this process's spans as Chrome/Perfetto trace_event "
        "JSON on exit (merge multiple processes' files with "
        "`obs merge-trace`)",
    )
    p.add_argument(
        "--flight-dir", default=None, metavar="DIR",
        help="arm the flight recorder: dump a post-mortem JSONL here on "
        "unhandled crash or SIGUSR1 (SIGUSR1 dumps, then kills the process)",
    )


def _install_obs(args) -> None:
    if getattr(args, "flight_dir", None):
        from akka_allreduce_tpu_torch.obs import flight

        flight.install(args.flight_dir, signal_exit=True)


def _write_trace(args) -> None:
    if getattr(args, "trace_out", None):
        from akka_allreduce_tpu_torch.obs import trace as obs_trace

        path = obs_trace.write_chrome_trace(args.trace_out)
        print(f"trace written to {path}", flush=True)


def _add_chaos_flags(p: argparse.ArgumentParser) -> None:
    """Chaos + retry-policy flags for the cluster master roles. The chaos
    spec is distributed to every node via Welcome (like every other knob),
    so one master flag arms the whole cluster with the same seed; the
    retry policy travels the same way (RESILIENCE.md)."""
    p.add_argument(
        "--chaos-seed", type=int, default=0,
        help="seed of the deterministic chaos schedule (same seed -> same "
        "per-process event log)",
    )
    p.add_argument(
        "--chaos-spec", default="",
        metavar="SPEC",
        help="fault spec, e.g. 'drop:p=0.05;delay:ms=20;corrupt:p=0.01;"
        "partition:groups=m+0|1,at=round10,heal=5s' (empty = chaos off)",
    )
    p.add_argument(
        "--chaos-log", default=None, metavar="FILE",
        help="write this process's chaos event log (JSONL, deterministic "
        "per seed) here on exit",
    )
    p.add_argument(
        "--send-retries", type=int, default=1,
        help="transport reconnect-resend budget per failure burst "
        "(exponential backoff + full jitter; 0 = fail fast)",
    )
    p.add_argument(
        "--send-backoff-base", type=float, default=0.05,
        help="base backoff seconds (doubles per retry, capped)",
    )
    p.add_argument(
        "--send-backoff-max", type=float, default=2.0,
        help="backoff cap in seconds",
    )


def _add_adapt_flags(p: argparse.ArgumentParser) -> None:
    """Closed-loop adaptive degradation (``control/adapt.py``, RESILIENCE.md
    'Tier 5'): the leader's per-round controller. Master-role flags only:
    workers need no config, the policy rides every Prepare/Start."""
    p.add_argument(
        "--adapt", action="store_true",
        help="enable the per-round adaptive controller: degrade th_reduce "
        "and wire precision (f16 -> int8) when straggler evidence grows, "
        "restore when the tail recovers",
    )
    p.add_argument(
        "--adapt-floor", type=float, default=0.5,
        help="th_reduce never degrades below this fraction",
    )
    p.add_argument(
        "--adapt-window", type=int, default=8,
        help="round completions per controller decision",
    )
    p.add_argument(
        "--adapt-dwell", type=int, default=16,
        help="minimum rounds at a level before the next transition "
        "(the anti-flap hysteresis dwell)",
    )
    p.add_argument(
        "--adapt-lag", type=int, default=12,
        help="worker contribution lag (rounds) that triggers a degrade; "
        "restore requires lag back under a third of this (min 1)",
    )
    p.add_argument(
        "--adapt-log", default=None, metavar="FILE",
        help="write the controller's decision log (JSONL, logical fields "
        "only: same evidence replays the same bytes) here on exit",
    )


def adapt_config_from(args):
    """The ``AdaptConfig`` the ``--adapt*`` flags describe (disabled
    without ``--adapt``)."""
    from akka_allreduce_tpu_torch.config import AdaptConfig

    if not args.adapt:
        return AdaptConfig()
    lag = max(2, args.adapt_lag)
    return AdaptConfig(
        enabled=True,
        floor_th_reduce=args.adapt_floor,
        window=args.adapt_window,
        min_dwell=args.adapt_dwell,
        lag_degrade=lag,
        lag_restore=max(1, lag // 3),
    )


def chaos_config_from(args):
    """The ``ChaosConfig`` of ``--chaos-seed``/``--chaos-spec`` (disabled
    with an empty spec); a malformed spec raises ``ValueError`` here,
    before any process is spawned."""
    from akka_allreduce_tpu_torch.config import ChaosConfig

    if args.chaos_spec:
        from akka_allreduce_tpu_torch.control.chaos import parse_spec

        parse_spec(args.chaos_spec)
    return ChaosConfig(seed=args.chaos_seed, spec=args.chaos_spec)


def _add_gossip_flags(p: argparse.ArgumentParser) -> None:
    """SWIM gossip membership (``control/gossip.py``). Master-role flags:
    the section rides Welcome, so one flag switches the whole cluster from
    hub heartbeats to decentralized probing."""
    p.add_argument(
        "--gossip", action="store_true",
        help="decentralized membership: nodes probe each other (SWIM "
        "ping / ping-req / suspicion) instead of all heartbeating into "
        "the master's phi detector",
    )
    p.add_argument(
        "--gossip-interval", type=float, default=0.5, metavar="S",
        help="gossip probe period in seconds (ack timeout is 0.3x this; "
        "suspicion confirms after 4 unrefuted periods)",
    )


def _gossip_config_from(args):
    import math

    from akka_allreduce_tpu_torch.config import GossipConfig

    if not getattr(args, "gossip", False):
        return GossipConfig()
    interval = args.gossip_interval
    return GossipConfig(
        enabled=True,
        probe_interval_s=interval,
        probe_timeout_s=interval * 0.3,
        # keep the suspicion window >= ~2 s whatever the probe cadence: a
        # loaded host can stall a healthy process past 1 s, and refutation
        # needs time to travel
        suspicion_periods=max(4, math.ceil(2.0 / interval)),
        seed=0,
    )


def _add_wire_dtype_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--wire-dtype", choices=("f32", "f16"), default="f32",
        help="float width of Scatter/ReduceBlock payloads on the TCP wire; "
        "f16 halves the network bytes (accumulation stays f32)",
    )


def _add_data_plane_flags(p: argparse.ArgumentParser) -> None:
    """Host data-plane sharding knobs (cluster masters only: distributed to
    every node with Welcome, like --wire-dtype)."""
    p.add_argument(
        "--streams", type=int, default=1,
        help="parallel TCP sockets per peer endpoint: stream 0 carries "
        "control, payload frames stripe across streams 1..N-1 by chunk id, "
        "each drained by a dedicated sender thread; 1 = one socket",
    )
    p.add_argument(
        "--pump-pool", type=int, default=0,
        help="worker threads for inbound decode of >=4MB bodies "
        "(0 = auto: streams x endpoints, capped at 8)",
    )
    p.add_argument(
        "--uring", action="store_true",
        help="drain sender-thread bursts through io_uring (runtime-probed; "
        "falls back to the sendmmsg/sendmsg path, byte-identical)",
    )
    p.add_argument(
        "--intra-chunk", type=int, default=0, metavar="BYTES",
        dest="intra_chunk",
        help="split payload frames at/above this many encoded bytes across "
        "the payload streams (needs --streams >= 3; 0 = off)",
    )
    p.add_argument(
        "--congestion", action="store_true",
        help="congestion-aware stripe scheduling: per-stream drain evidence "
        "shifts assignment weight away from a slow stream",
    )


def node_device(p: argparse.ArgumentParser, device):
    """The device of a ``cluster-node`` or ``chaos-train-node`` process (the
    card unless ``"cpu"``; a parser error where it cannot be had)."""
    from akka_allreduce_tpu_torch._device import resolve_device

    try:
        return resolve_device(device)
    except (RuntimeError, ValueError) as e:
        p.error(str(e))


def _card_note(device) -> str:
    """``device=...`` for a result line, with the card's name and power
    limit on the card."""
    if device.type != "cuda":
        return f"device={device}"
    from akka_allreduce_tpu_torch.utils.benchmarking import card_info

    info = card_info(device)
    return f"device={device} ({info['name']}, {info['power_limit']})"


# -- cluster-master ---------------------------------------------------------


def _cluster_master_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "cluster-master",
        description="seed/master role: membership + round scheduling over "
        "TCP (the reference's master main)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--nodes", type=int, default=2, help="nodes before organizing")
    p.add_argument("--dims", type=int, default=1, choices=(1, 2))
    p.add_argument("--size", type=int, default=1_000_000)
    p.add_argument("--chunk", type=int, default=262_144)
    p.add_argument("--rounds", type=int, default=20, help="-1 = run forever")
    p.add_argument(
        "--round-window", type=int, default=2,
        help="line rounds in flight (at most the workers' out-of-order "
        "buffer window)",
    )
    p.add_argument("--th", type=float, default=1.0, help="all three thresholds")
    p.add_argument("--heartbeat", type=float, default=1.0, help="interval (s)")
    p.add_argument(
        "--line-shards", type=int, default=1,
        help="dims-1 round-scheduling shards: split the membership into up "
        "to N LineMasters, each owning a contiguous worker subset",
    )
    p.add_argument(
        "--grid", default="", metavar="RxC",
        help="pod-grid coordinate bootstrap: anchor node ids to an RxC "
        "layout, so shard membership follows the layout, not join order",
    )
    p.add_argument("--metrics-out", default=None, help="per-round JSONL path")
    p.add_argument(
        "--round-deadline", type=float, default=0.0,
        help="stall watchdog: a round in flight longer than this many "
        "seconds dumps the flight recorder (0 = off)",
    )
    _add_wire_dtype_flag(p)
    _add_data_plane_flags(p)
    _add_chaos_flags(p)
    _add_adapt_flags(p)
    _add_gossip_flags(p)
    _add_obs_flags(p)
    return p


def cluster_master_defaults() -> dict:
    """Every cluster-master flag at its default, by attribute name.
    train-cluster-master carries only the JAX command's smaller flag set and
    runs the master with these for the flags it lacks."""
    return vars(_cluster_master_parser().parse_args([]))


def cmd_cluster_master(argv: list[str]) -> int:
    p = _cluster_master_parser()
    args = p.parse_args(argv)
    try:
        chaos_config_from(args)  # fail fast on a malformed spec
    except ValueError as e:
        p.error(str(e))
    from akka_allreduce_tpu_torch.config import WorkerConfig

    worker_window = WorkerConfig().round_window
    if not 1 <= args.round_window <= worker_window:
        p.error(
            f"--round-window must be in [1, {worker_window}] (the "
            f"workers' out-of-order buffer window), got {args.round_window}"
        )
    return _run_cluster_master(args)


def _run_cluster_master(args) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import asyncio
    import signal

    import torch

    from akka_allreduce_tpu_torch.config import (
        AllreduceConfig,
        DataPlaneConfig,
        LineMasterConfig,
        MasterConfig,
        MetaDataConfig,
        RetryPolicy,
        ThresholdConfig,
        WorkerConfig,
    )
    from akka_allreduce_tpu_torch.control.bootstrap import MasterProcess
    from akka_allreduce_tpu_torch.control.remote import observed_task
    from akka_allreduce_tpu_torch.utils.metrics import MetricsLogger

    chaos = chaos_config_from(args)  # a malformed spec fails here
    grid_rows = grid_cols = 0
    if args.grid:
        from akka_allreduce_tpu_torch.control.pod import parse_grid

        grid_rows, grid_cols = parse_grid(args.grid)
    cfg = AllreduceConfig(
        threshold=ThresholdConfig(args.th, args.th, args.th),
        metadata=MetaDataConfig(
            data_size=args.size,
            max_chunk_size=args.chunk,
            wire_dtype=args.wire_dtype,
        ),
        line_master=LineMasterConfig(
            round_window=args.round_window, max_rounds=args.rounds
        ),
        master=MasterConfig(
            node_num=args.nodes,
            dimensions=args.dims,
            line_shards=args.line_shards,
            grid_rows=grid_rows,
            grid_cols=grid_cols,
            heartbeat_interval_s=args.heartbeat,
            round_deadline_s=args.round_deadline,
            retry=RetryPolicy(
                max_retries=args.send_retries,
                backoff_base_s=args.send_backoff_base,
                backoff_max_s=args.send_backoff_max,
            ),
        ),
        # a node publishes each payload as a tensor it never writes again
        # (the training node publishes a new tensor a step), so the
        # zero-copy scatter path is sound
        worker=WorkerConfig(zero_copy_scatter=True),
        data_plane=DataPlaneConfig(
            streams=args.streams,
            pump_pool=args.pump_pool,
            uring=args.uring,
            intra_chunk_min_bytes=args.intra_chunk,
            congestion=args.congestion,
        ),
        gossip=_gossip_config_from(args),
        chaos=chaos,
        adapt=adapt_config_from(args),
    )
    _install_obs(args)

    async def run() -> None:
        metrics = MetricsLogger(args.metrics_out) if args.metrics_out else None
        master = MasterProcess(
            cfg, args.host, args.port, metrics=metrics,
            # a real OS process: the chaos `crash:node=m` fault may os._exit
            # here (the chaos-failover drill's leader kill), and the
            # injector writes the chaos log on its way down
            allow_crash=True,
            chaos_log=args.chaos_log,
        )
        ep = await master.start()
        print(f"master listening on {ep}", flush=True)
        # SIGTERM ends an open-ended (--rounds -1) run gracefully: nodes get
        # a Shutdown broadcast and every process flushes its metrics
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(
                signal.SIGTERM,
                lambda: observed_task(
                    master.shutdown("sigterm"), name="sigterm-shutdown"
                ),
            )
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass  # non-Unix event loops: SIGTERM stays abrupt
        try:
            t0, c0 = time.perf_counter(), time.process_time()
            await master.run_until_done()
            print(
                f"master done: {master.rounds_completed} line-rounds "
                f"completed (wall {time.perf_counter() - t0:.2f}s, own cpu "
                f"{time.process_time() - c0:.2f}s over the round window)",
                flush=True,
            )
            await asyncio.sleep(2 * args.heartbeat)  # let Shutdown flush
        finally:
            await master.stop()
            if args.chaos_log and master.transport.chaos:
                path = master.transport.chaos.write_log(args.chaos_log)
                print(f"chaos event log: {path}", flush=True)
            if args.adapt_log and master.adapt is not None:
                path = master.adapt.write_log(args.adapt_log)
                print(f"adapt decision log: {path}", flush=True)
            if metrics is not None:
                from akka_allreduce_tpu_torch.obs.metrics import REGISTRY

                metrics.log_snapshot(REGISTRY, role="master")
                metrics.close()

    asyncio.run(run())
    # the master holds no payload: it must never have started CUDA
    print(f"master cuda_initialized={torch.cuda.is_initialized()}", flush=True)
    _write_trace(args)
    return 0


# -- cluster-node -----------------------------------------------------------


def _cluster_node_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "cluster-node",
        description="worker-node role: joins the seed, serves one worker per "
        "grid dimension (the reference's worker main), its round buffers "
        "on the card",
    )
    p.add_argument("--seed", required=True, help="master host:port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--node-id", type=int, default=-1, help="-1 = master assigns")
    p.add_argument(
        "--grid", default="", metavar="RxC",
        help="pod-grid coordinate bootstrap: derive this node's id from its "
        "process index, row-major over the RxC layout",
    )
    p.add_argument(
        "--process-index", type=int, default=-1,
        help="this process's pod index for --grid (-1 = resolve from "
        "AKKA_PROCESS_INDEX & friends)",
    )
    p.add_argument("--data-seed", type=int, default=None, help="payload RNG seed")
    p.add_argument(
        "--metrics-out", default=None,
        help="JSONL path for the node's per-stage protocol timing",
    )
    p.add_argument(
        "--chaos-log", default=None, metavar="FILE",
        help="write this node's chaos event log (JSONL) on exit; the "
        "chaos spec itself arrives from the master via Welcome",
    )
    p.add_argument(
        "--state-dir", default=None, metavar="DIR",
        help="arm peer state transfer: delta-checkpoint this node's running "
        "state here, replicate the chunks to peers after every save, and on "
        "(re)join restore from disk or from live peers",
    )
    p.add_argument(
        "--state-every", type=int, default=5,
        help="save + replicate state every N flushed rounds",
    )
    p.add_argument(
        "--replicas", type=int, default=2,
        help="how many peers each checkpoint is pushed to (K)",
    )
    p.add_argument(
        "--uniform-check", action="store_true",
        help="with every node on the SAME --data-seed, track the max "
        "deviation of each round's average from the payload and report it "
        "as max_err= in the shutdown line",
    )
    p.add_argument(
        "--device", default=None,
        help="'cpu' keeps the round buffers on the host; default: the card",
    )
    p.add_argument(
        "--flush-out", default=None, metavar="FILE",
        help="write the last flush (data, count, iteration) here as .npz",
    )
    _add_obs_flags(p)
    return p


def cmd_cluster_node(argv: list[str]) -> int:
    p = _cluster_node_parser()
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.grid:
        from akka_allreduce_tpu_torch.control import pod as _pod

        rows, cols = _pod.parse_grid(args.grid)
        idx = _pod.resolve_process_index(
            args.process_index if args.process_index >= 0 else None
        )
        row, col = _pod.grid_coords(idx, rows, cols)
        if args.node_id >= 0 and args.node_id != idx:
            p.error(
                f"--node-id {args.node_id} contradicts the grid "
                f"coordinate {idx} ({row},{col}); drop one of them"
            )
        args.node_id = idx
        print(
            f"pod grid {rows}x{cols}: process {idx} -> coords "
            f"({row},{col}), node id {idx}",
            flush=True,
        )
    device = node_device(p, args.device)
    _install_obs(args)

    import asyncio
    import json

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch import native
    from akka_allreduce_tpu_torch.control.bootstrap import NodeProcess
    from akka_allreduce_tpu_torch.control.cluster import Endpoint
    from akka_allreduce_tpu_torch.control.remote import observed_task
    from akka_allreduce_tpu_torch.protocol import AllReduceInput

    state = {"payload": None, "flushes": 0, "t0": None, "node": None,
             "save_task": None, "step_base": 0, "save_enabled": False,
             "last_flush_round": -1, "dup_flushes": 0, "max_err": 0.0,
             "last": None}

    def source(req):
        if state["payload"] is None:
            raise RuntimeError("source called before Welcome sized the payload")
        return AllReduceInput(state["payload"])

    def sink(out):
        state["flushes"] += 1
        state["last"] = out
        # flushed round ids increase by construction: a non-increasing
        # flush means a round was applied twice
        if out.iteration <= state["last_flush_round"]:
            state["dup_flushes"] += 1
        else:
            state["last_flush_round"] = out.iteration
        if args.uniform_check and state["payload"] is not None:
            # identical payloads on every node => the true average is the
            # payload wherever a contribution landed; any deviation is
            # wire-compression error
            mask = out.count > 0
            if bool(mask.any()):
                err = float(
                    (out.average()[mask] - state["payload"][mask]).abs().max()
                )
                state["max_err"] = max(state["max_err"], err)
        node = state["node"]
        n = state["flushes"]
        if (
            node is None
            or node.state is None
            or not state["save_enabled"]
            or not args.state_every
            or n % args.state_every
        ):
            # saves stay gated until the startup restore decided
            return
        prev = state["save_task"]
        if prev is not None and not prev.done():
            return  # at most one save+replicate cycle in flight
        snap = {
            "payload": state["payload"].cpu().numpy(),
            "reduced": out.data.cpu().numpy().astype(np.float32, copy=True),
        }
        step = state["step_base"] + n
        state["save_task"] = observed_task(
            node.save_state(step, snap), name=f"state-save-{step}"
        )

    async def run() -> int:
        node = NodeProcess(
            Endpoint.parse(args.seed),
            source,
            sink,
            args.host,
            args.port,
            preferred_node_id=args.node_id,
            # a real OS process: the chaos `crash` fault may os._exit here
            allow_crash=True,
            chaos_log=args.chaos_log,
            state_dir=args.state_dir,
            replicas=args.replicas,
            device=device,
        )
        state["node"] = node
        await node.start()
        nid = await node.wait_welcomed()
        size = node.config.metadata.data_size
        seed = args.data_seed if args.data_seed is not None else nid
        payload = np.random.default_rng(seed).standard_normal(size).astype(np.float32)
        state["payload"] = torch.from_numpy(payload).to(device)
        if args.state_dir:
            flushes0 = state["flushes"]
            budget = max(1, args.state_every or 1)
            rest = await node.restore_state(
                give_up=lambda: state["flushes"] - flushes0 >= budget
            )
            if rest is not None and rest.get("complete"):
                try:
                    step, saved = node.state.store.load_state()
                except (FileNotFoundError, ValueError) as e:
                    print(f"state restore unreadable: {e}", flush=True)
                else:
                    restored = saved.get("payload")
                    if restored is not None and restored.size == size:
                        state["payload"] = torch.from_numpy(
                            np.ascontiguousarray(restored, dtype=np.float32)
                        ).to(device)
                    state["step_base"] = int(step)
            state["save_enabled"] = True
            print(
                "RESTORE "
                + json.dumps(rest if rest is not None else {"source": "none"}),
                flush=True,
            )
        state["t0"] = time.perf_counter()
        cpu0 = time.process_time()
        print(f"node {nid} joined {args.seed}", flush=True)
        try:
            reason = await node.run_until_shutdown()
        finally:
            await node.stop()
            if args.chaos_log and node.transport.chaos is not None:
                node.transport.chaos.write_log(args.chaos_log)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - state["t0"]
        cpu = time.process_time() - cpu0
        mbs = state["flushes"] * size * 4 / max(dt, 1e-9) / 1e6
        stages = dict(node.transport.stage_seconds)
        accounted = sum(stages.values())
        stage_note = ", ".join(f"{k}={v:.3f}s" for k, v in stages.items())
        # which wire codec ran (the C++ hot loop vs the struct/numpy path):
        # loaded(), not available(), which may compile and then describe a
        # library the finished run never used
        wire_path = "native" if native.loaded() else "python"
        err_note = (
            f", max_err={state['max_err']:.6f}" if args.uniform_check else ""
        )
        print(
            f"node {nid} shut down ({reason}): {state['flushes']} rounds, "
            f"{mbs:.1f} MB/s reduced, dup_flushes={state['dup_flushes']}"
            f"{err_note}, {_card_note(device)}",
            flush=True,
        )
        # two views of the wall: own-cpu vs off-cpu partition, and the stage
        # timers, which are wall spans (an overlay, not a partition)
        print(
            f"node {nid} stage times over {dt:.2f}s wall: {stage_note} "
            f"(wall spans, {accounted:.2f}s total; partition: own cpu "
            f"{cpu:.2f}s, off-cpu {max(dt - cpu, 0.0):.2f}s = "
            f"peer/master scheduled or socket idle; wire={wire_path})",
            flush=True,
        )
        last = state["last"]
        if args.flush_out and last is not None:
            np.savez(
                args.flush_out,
                data=last.data.cpu().numpy(),
                count=last.count.cpu().numpy(),
                iteration=np.int64(last.iteration),
            )
        if args.metrics_out:
            from akka_allreduce_tpu_torch.obs.metrics import REGISTRY
            from akka_allreduce_tpu_torch.utils.benchmarking import device_fields
            from akka_allreduce_tpu_torch.utils.metrics import MetricsLogger

            m = MetricsLogger(args.metrics_out)
            m.log_event(
                kind="node_stage_times", node=nid, wall_s=round(dt, 3),
                cpu_s=round(cpu, 3),
                rounds=state["flushes"], mb_per_s=round(mbs, 1),
                dup_flushes=state["dup_flushes"],
                wire=wire_path,
                **device_fields(device),
                **{k: round(v, 4) for k, v in stages.items()},
            )
            m.log_snapshot(REGISTRY, role="node", node=nid)
            m.close()
        return 0

    rc = asyncio.run(run())
    _write_trace(args)
    return rc


# -- cluster-standby --------------------------------------------------------


def cmd_cluster_standby(argv: list[str]) -> int:
    """Warm-standby master role: registers with the leader, absorbs the
    replicated state-digest stream, and takes over — bumping the leadership
    epoch — when its lease on the leader expires. Nodes walk the standby
    list distributed with Welcome/AddressBook and re-join here; the round
    budget then completes under the new epoch."""
    p = argparse.ArgumentParser(
        "cluster-standby",
        description="warm-standby master: replicate the leader's control-"
        "plane state and take over on leader loss (epoch-fenced failover)",
    )
    p.add_argument("--seed", required=True, help="leader master host:port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument(
        "--heartbeat", type=float, default=1.0,
        help="lease tick + expected digest cadence (s); match the leader's "
        "--heartbeat",
    )
    p.add_argument(
        "--phi", type=float, default=8.0,
        help="phi-accrual threshold of the leader lease (lower = faster, "
        "riskier takeover)",
    )
    p.add_argument("--metrics-out", default=None, help="per-round JSONL path")
    _add_obs_flags(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    _install_obs(args)

    import asyncio
    import json
    import signal

    from akka_allreduce_tpu_torch.config import AllreduceConfig, MasterConfig
    from akka_allreduce_tpu_torch.control.bootstrap import MasterProcess
    from akka_allreduce_tpu_torch.control.cluster import Endpoint
    from akka_allreduce_tpu_torch.control.remote import observed_task
    from akka_allreduce_tpu_torch.utils.metrics import MetricsLogger

    async def run() -> int:
        metrics = MetricsLogger(args.metrics_out) if args.metrics_out else None
        # placeholder config: everything that matters is adopted from the
        # leader's digest at takeover — only the lease cadence is ours
        cfg = AllreduceConfig(
            master=MasterConfig(heartbeat_interval_s=args.heartbeat)
        )
        master = MasterProcess(
            cfg, args.host, args.port,
            standby_of=Endpoint.parse(args.seed),
            phi_threshold=args.phi,
            metrics=metrics,
        )

        def on_takeover(m: MasterProcess) -> None:
            print(
                "TAKEOVER "
                + json.dumps(
                    {
                        "epoch": m.epoch,
                        "members": sorted(m.grid.nodes),
                        "resume_round": m.grid.resume_round,
                        "completed_carried": m.grid._completed_before_reorg,
                        "ckpt_origins": sorted(m._ckpt),
                    }
                ),
                flush=True,
            )

        master.on_takeover = on_takeover
        ep = await master.start()
        print(f"standby listening on {ep} (leader {args.seed})", flush=True)
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(
                signal.SIGTERM,
                lambda: observed_task(
                    master.shutdown("sigterm"), name="sigterm-shutdown"
                ),
            )
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass
        try:
            t0 = time.perf_counter()
            await master.run_until_done()
            if master.active:
                print(
                    f"master done: {master.rounds_completed} line-rounds "
                    f"completed (epoch {master.epoch}, wall "
                    f"{time.perf_counter() - t0:.2f}s since standby start)",
                    flush=True,
                )
                await asyncio.sleep(2 * args.heartbeat)  # let Shutdown flush
            else:
                print(
                    f"standby released ({master.shutdown_reason})", flush=True
                )
        finally:
            await master.stop()
            if metrics is not None:
                from akka_allreduce_tpu_torch.obs.metrics import REGISTRY

                metrics.log_snapshot(REGISTRY, role="standby")
                metrics.close()
        return 0

    rc = asyncio.run(run())
    _write_trace(args)
    return rc


# -- bench-wire -------------------------------------------------------------


def _advance(frames: list, n: int) -> None:
    """Drop the first ``n`` sent bytes from a list of frames of segments."""
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


def _loopback_pair():
    """A connected (sender, receiver) pair of loopback TCP sockets."""
    import socket

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    tx = socket.create_connection(srv.getsockname())
    rx, _ = srv.accept()
    srv.close()
    return tx, rx


def _start_drain(rx):
    """A thread that reads and discards ``rx`` until the returned event is
    set or the peer closes."""
    import threading

    stop = threading.Event()

    def drain() -> None:
        sink = bytearray(1 << 20)
        while not stop.is_set():
            try:
                if not rx.recv_into(sink):
                    return
            except OSError:
                return

    thread = threading.Thread(target=drain, daemon=True)
    thread.start()
    return stop, thread


def cmd_bench_wire(argv: list[str]) -> int:
    """Deterministic host data-plane microbench: per-core codec throughput
    (encode+checksum / decode+verify) and the syscall-batching comparison
    (one ``sendmsg`` per frame vs one ``sendmmsg`` per burst, plus the recv
    side) over loopback TCP. Legs are interleaved and the medians reported.
    The payloads are tensors on ``--device``: on the card the encode leg
    includes each frame's copy to the host."""
    p = argparse.ArgumentParser(
        "bench-wire",
        description="wire codec + batch-syscall microbench (JSON output)",
    )
    p.add_argument(
        "--size", type=int, default=4096,
        help="floats per payload frame (default 16KB frames)",
    )
    p.add_argument("--frames", type=int, default=64, help="frames per burst")
    p.add_argument("--reps", type=int, default=9, help="interleaved reps/leg")
    p.add_argument("--json", action="store_true", help="print the JSON record")
    p.add_argument("--out", default=None, help="append the JSON record here")
    p.add_argument(
        "--uring", action="store_true",
        help="A/B io_uring burst submission vs sendmmsg (or record the "
        "runtime probe's fallback reason)",
    )
    p.add_argument(
        "--intra-chunk", action="store_true", dest="intra_chunk",
        help="A/B a one-chunk round on one stream vs split across payload "
        "streams, over per-stream-paced loopback drains",
    )
    p.add_argument(
        "--congestion", action="store_true",
        help="run the stripe scheduler's shed/restore simulation under a "
        "fake clock",
    )
    p.add_argument(
        "--device", default=None,
        help="'cpu' keeps the payload tensors on the host; default: the card",
    )
    args = p.parse_args(argv)
    from akka_allreduce_tpu_torch._device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        p.error(str(e))

    import json
    import socket
    import statistics

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch import native
    from akka_allreduce_tpu_torch.control import wire
    from akka_allreduce_tpu_torch.protocol import ScatterBlock
    from akka_allreduce_tpu_torch.utils.benchmarking import device_fields

    native.available()  # build the codec's library before timing it
    rng = np.random.default_rng(7)
    payloads = [
        torch.from_numpy(rng.standard_normal(args.size).astype(np.float32)).to(device)
        for _ in range(args.frames)
    ]
    msgs = [ScatterBlock(v, 0, 1, i, 1) for i, v in enumerate(payloads)]
    host_payloads = [v.cpu().numpy() for v in payloads]
    dest = "worker:1"
    payload_bytes = args.size * 4 * args.frames

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # -- codec legs (pure compute, no sockets) --------------------------------
    def leg_encode() -> None:
        for m in msgs:
            wire.encode_frame_parts(dest, m)

    frames_bytes = [b"".join(wire.encode_frame_parts(dest, m)) for m in msgs]

    def leg_decode() -> None:
        for f in frames_bytes:
            wire.decode_frame_body_ex(memoryview(f)[4:])

    def leg_checksum() -> None:
        for v in host_payloads:
            native.wire_checksum(memoryview(v).cast("B"))

    codec: dict[str, list[float]] = {"encode": [], "decode": [], "checksum": []}
    for _ in range(args.reps):
        codec["encode"].append(timed(leg_encode))
        codec["decode"].append(timed(leg_decode))
        codec["checksum"].append(timed(leg_checksum))

    # -- syscall legs: loopback TCP, a drain thread on the far end ------------
    tx, rx = _loopback_pair()
    tx.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    for sk in (tx, rx):
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                sk.setsockopt(socket.SOL_SOCKET, opt, 8 << 20)
            except OSError:
                pass
    stop, drainer = _start_drain(rx)

    def send_all(batched: bool, force_fallback: bool = False) -> None:
        frames = [[memoryview(f)] for f in frames_bytes]
        if batched:
            while frames:
                n = native.batch_send(
                    tx.fileno(), frames, force_fallback=force_fallback
                )
                _advance(frames, n)
            return
        for f in frames:  # one syscall per frame: the un-batched baseline
            one = [f]
            while one:
                _advance(one, tx.sendmsg(one[0]))

    have_native = native.batch_send_available()
    have_mmsg = native.sendmmsg_available()
    sysc: dict[str, list[float]] = {
        "sendmsg_loop": [], "sendmmsg": [], "sendmmsg_fallback": [],
    }
    try:
        for _ in range(args.reps):  # interleaved: noise hits every leg alike
            sysc["sendmsg_loop"].append(timed(lambda: send_all(False)))
            if have_native:
                sysc["sendmmsg"].append(timed(lambda: send_all(True)))
                sysc["sendmmsg_fallback"].append(
                    timed(lambda: send_all(True, force_fallback=True))
                )
    finally:
        stop.set()
        tx.close()
        rx.close()
        drainer.join(timeout=2.0)

    # -- recv legs: recvmmsg batch vs recv loop over a pre-pumped stream ------
    recv: dict[str, list[float]] = {"recv_loop": [], "recvmmsg": []}
    if have_native:
        import threading

        bufs = [bytearray(64 << 10) for _ in range(16)]
        total = payload_bytes

        def recv_bench(batched: bool) -> float:
            c, b = _loopback_pair()
            blob = b"\x00" * total

            def pump() -> None:
                try:
                    c.sendall(blob)
                finally:
                    c.close()

            th = threading.Thread(target=pump, daemon=True)
            th.start()
            got = 0
            t0 = time.perf_counter()
            try:
                while got < total:
                    if batched:
                        n = native.batch_recv(b.fileno(), bufs)
                    else:
                        n = b.recv_into(bufs[0])
                    if n <= 0:
                        break
                    got += n
                return time.perf_counter() - t0
            finally:
                b.close()
                th.join(timeout=2.0)

        for _ in range(args.reps):
            recv["recv_loop"].append(recv_bench(False))
            recv["recvmmsg"].append(recv_bench(True))

    def mbps(times: list[float]) -> float | None:
        if not times:
            return None
        return round(payload_bytes / statistics.median(times) / 1e6, 1)

    card = device_fields(device)
    record = {
        "bench": "wire",
        "size_floats": args.size,
        "frames": args.frames,
        "reps": args.reps,
        "native_loaded": native.loaded(),
        "sendmmsg_available": have_mmsg,
        "encode_mbps": mbps(codec["encode"]),
        "decode_mbps": mbps(codec["decode"]),
        "checksum_mbps": mbps(codec["checksum"]),
        "sendmsg_loop_mbps": mbps(sysc["sendmsg_loop"]),
        "sendmmsg_mbps": mbps(sysc["sendmmsg"]),
        "sendmmsg_fallback_mbps": mbps(sysc["sendmmsg_fallback"]),
        "recv_loop_mbps": mbps(recv["recv_loop"]),
        "recvmmsg_mbps": mbps(recv["recvmmsg"]),
        **card,
    }
    records = [record]
    if args.uring:
        records.append({**_bench_wire_uring(args, frames_bytes, payload_bytes), **card})
    if args.intra_chunk:
        records.append({**_bench_wire_intra_chunk(args, device), **card})
    if args.congestion:
        records.append(_bench_wire_congestion())
    out_lines = [json.dumps(r, sort_keys=True) for r in records]
    if args.out:
        with open(args.out, "a") as f:
            for line in out_lines:
                f.write(line + "\n")
    if args.json or not args.out:
        for line in out_lines:
            print(line)
    return 0


def _bench_wire_uring(args, frames_bytes, payload_bytes) -> dict:
    """io_uring burst submission vs the sendmmsg batch: same frame mix,
    same loopback drain, interleaved legs. On a kernel without io_uring the
    record carries the probe's fallback reason instead of a number."""
    import socket
    import statistics

    from akka_allreduce_tpu_torch import native

    rec: dict = {
        "bench": "wire",
        "lever": "uring",
        "uring_available": native.uring_available(),
        "uring_probe_reason": native.uring_probe_reason(),
        "uring_mbps": None,
        "sendmmsg_mbps": None,
    }
    if not native.uring_available() or not native.batch_send_available():
        return rec
    tx, rx = _loopback_pair()
    tx.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    stop, drainer = _start_drain(rx)
    ring = native.UringRing()

    def send_all(use_uring: bool) -> None:
        frames = [[memoryview(f)] for f in frames_bytes]
        while frames:
            if use_uring:
                flat = [v for fr in frames for v in fr]
                try:
                    n = ring.send(tx.fileno(), flat)
                except BlockingIOError:
                    continue
            else:
                n = native.batch_send(tx.fileno(), frames)
            _advance(frames, n)

    times: dict[str, list[float]] = {"sendmmsg": [], "uring": []}
    try:
        for _ in range(args.reps):
            for key, flag in (("sendmmsg", False), ("uring", True)):
                t0 = time.perf_counter()
                send_all(flag)
                times[key].append(time.perf_counter() - t0)
    finally:
        ring.close()
        stop.set()
        tx.close()
        rx.close()
        drainer.join(timeout=2.0)
    for key in times:
        rec[f"{key}_mbps"] = round(
            payload_bytes / statistics.median(times[key]) / 1e6, 1
        )
    rec["uring_ge_sendmmsg"] = rec["uring_mbps"] >= rec["sendmmsg_mbps"]
    return rec


def _bench_wire_intra_chunk(args, device) -> dict:
    """A one-chunk round's bytes over one stream vs split across 3 payload
    streams, over loopback connections whose drains are paced to a fixed
    per-stream rate (each TCP stream has a bandwidth ceiling; on loopback
    the kernel would otherwise hide it). The bytes are a real encoded frame
    of a payload on ``device``, split at the splitter's offsets."""
    import statistics
    import threading

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.control import wire
    from akka_allreduce_tpu_torch.protocol import ScatterBlock

    n_payload = 3  # streams=4
    pace_mbps = 200.0  # per-stream drain ceiling
    read_chunk = 256 << 10
    value = torch.from_numpy(
        np.random.default_rng(7).standard_normal(6_000_000).astype(np.float32)
    ).to(device)  # ~24 MB one-chunk frame
    body = b"".join(
        bytes(p)
        for p in wire.encode_frame_parts("worker:1", ScatterBlock(value, 0, 1, 0, 1))
    )

    def leg(n_streams: int) -> float:
        frag = -(-len(body) // n_streams)
        slices = [body[i * frag : (i + 1) * frag] for i in range(n_streams)]
        pairs = [_loopback_pair() for _ in range(n_streams)]
        done = threading.Barrier(2 * n_streams + 1)

        def write(sock, blob) -> None:
            try:
                sock.sendall(blob)
            finally:
                done.wait()

        def drain(sock, want: int) -> None:
            sink = bytearray(read_chunk)
            got = 0
            budget = time.perf_counter()
            try:
                while got < want:
                    n = sock.recv_into(sink)
                    if not n:
                        break
                    got += n
                    # pace: sleep off any surplus over the per-stream ceiling
                    budget += n / (pace_mbps * 1e6)
                    now = time.perf_counter()
                    if budget > now:
                        time.sleep(budget - now)
            finally:
                done.wait()

        threads = []
        t0 = time.perf_counter()
        for (c, a), blob in zip(pairs, slices):
            threads.append(threading.Thread(target=write, args=(c, blob), daemon=True))
            threads.append(
                threading.Thread(target=drain, args=(a, len(blob)), daemon=True)
            )
        for t in threads:
            t.start()
        done.wait()
        dt = time.perf_counter() - t0
        for c, a in pairs:
            c.close()
            a.close()
        return dt

    single: list[float] = []
    striped: list[float] = []
    for _ in range(max(3, args.reps // 3)):
        single.append(leg(1))
        striped.append(leg(n_payload))
    s, m = statistics.median(single), statistics.median(striped)
    return {
        "bench": "wire",
        "lever": "intra_chunk",
        "model": f"per-stream drains paced at {pace_mbps:g} MB/s",
        "frame_mb": round(len(body) / 1e6, 1),
        "payload_streams": n_payload,
        "single_stream_s": round(s, 4),
        "striped_s": round(m, 4),
        "speedup": round(s / m, 2),
    }


def _bench_wire_congestion() -> dict:
    """The stripe scheduler's closed loop under a fake clock: a 3-stream
    endpoint where stream 2 drains at 15%, then heals. Deterministic (no
    wall clock, no RNG): the record carries a replay check."""
    from akka_allreduce_tpu_torch.control.stripes import StripeScheduler

    degraded = 2
    frame = 1 << 20

    def run() -> tuple[list[float], dict]:
        sched = StripeScheduler(3)
        fair = 1.0 / 3.0
        shares: list[float] = []
        backlog = [0, 0, 0]  # the simulated sockets' unsent bytes
        windows_to_half = None
        restored_at = None
        for w in range(40):
            now = w * sched.window_s
            for _ in range(12):
                idx = sched.pick(frame, now)
                backlog[idx] += frame
            healed = w >= 20
            for i in range(3):
                # healthy streams clear their queue; the degraded one moves
                # 15% of a fair window
                cap = (16 << 20) if (i != degraded or healed) else int(
                    0.15 * (4 << 20)
                )
                sent = min(backlog[i], cap)
                backlog[i] -= sent
                sched.note_sent(i, sent, now)
            share = sched.share(degraded)
            shares.append(round(share, 4))
            if windows_to_half is None and share <= fair / 2.0:
                windows_to_half = w + 1
            if (
                windows_to_half is not None
                and restored_at is None
                and healed
                and share >= fair * 0.9
            ):
                restored_at = w + 1
        return shares, {
            "windows_to_half_share": windows_to_half,
            "restored_by_window": restored_at,
            "final_weights": sched.snapshot()["weights"],
            "sheds": sched.sheds,
            "restores": sched.restores,
        }

    shares_a, rec = run()
    shares_b, _ = run()
    return {
        "bench": "wire",
        "lever": "congestion",
        "degraded_stream": degraded,
        "share_trajectory": shares_a[:12],
        "deterministic": shares_a == shares_b,
        **rec,
    }


# -- obs --------------------------------------------------------------------


def cmd_obs(argv: list[str]) -> int:
    """Observability toolbox: run the multi-process trace demo, inspect
    flight dumps, merge per-process Perfetto traces."""
    p = argparse.ArgumentParser(
        "obs",
        description="observability tools: trace demo, flight-dump inspect, "
        "trace merge",
    )
    sub = p.add_subparsers(dest="action", required=True)
    d = sub.add_parser(
        "demo",
        help="run a tiny local cluster (master + N node processes), emit a "
        "merged Perfetto trace + per-role metrics snapshots",
    )
    d.add_argument("--out-dir", default="trace_demo")
    d.add_argument("--nodes", type=int, default=2)
    d.add_argument("--rounds", type=int, default=3)
    d.add_argument("--size", type=int, default=65536)
    d.add_argument("--chunk", type=int, default=8192)
    d.add_argument(
        "--device", default=None,
        help="the nodes' --device: 'cpu', or the card by default",
    )
    i = sub.add_parser("inspect", help="summarize a flight-recorder JSONL dump")
    i.add_argument("file")
    m = sub.add_parser(
        "merge-trace", help="merge per-process Chrome/Perfetto trace files into one"
    )
    m.add_argument("--out", required=True)
    m.add_argument("inputs", nargs="+")
    args = p.parse_args(argv)
    import json

    if args.action == "merge-trace":
        from akka_allreduce_tpu_torch.obs import trace as obs_trace

        out = obs_trace.merge_chrome_traces(args.inputs, args.out)
        print(f"merged {len(args.inputs)} trace file(s) into {out}")
        return 0

    if args.action == "inspect":
        lines = []
        with open(args.file) as f:
            for ln in f:
                if ln.strip():
                    lines.append(json.loads(ln))
        header = next((r for r in lines if r.get("kind") == "flight_header"), {})
        state = next((r for r in lines if r.get("kind") == "state"), {})
        metrics = next((r for r in lines if r.get("kind") == "metrics"), {})
        spans = [r for r in lines if r.get("kind") == "span"]
        events = [r for r in lines if r.get("kind") == "event"]
        print(
            json.dumps(
                {
                    "reason": header.get("reason"),
                    "pid": header.get("pid"),
                    "round_in_flight": state.get("worker.round_in_flight"),
                    "last_transport_stage": state.get("transport.last_stage"),
                    "stalled_round": state.get("watchdog.stalled_round"),
                    "spans": len(spans),
                    "events": len(events),
                    "rounds_completed": metrics.get("worker.rounds_completed"),
                    "dropped": {
                        k.removeprefix("transport.dropped."): v
                        for k, v in metrics.items()
                        if k.startswith("transport.dropped.") and v
                    },
                },
                indent=2,
            )
        )
        return 0

    return _run_obs_demo(p, args)


def spawn_role(*cli: str, stderr=None):
    """Start one role of the cluster as a new interpreter
    (``python -m akka_allreduce_tpu_torch ...``) with its stdout piped; one
    parent owns every role's process."""
    import subprocess

    return subprocess.Popen(
        [sys.executable, "-m", "akka_allreduce_tpu_torch", *cli],
        stdout=subprocess.PIPE, stderr=stderr, text=True,
    )


def read_until(proc, prefix: str, timeout: float = 60.0) -> list[str]:
    """The lines of ``proc``'s stdout up to and including the first that
    starts with ``prefix``, read under a deadline: a process that has not
    printed it within ``timeout`` seconds is killed, and a process that
    ends or is killed before it raises ``RuntimeError``. The rest of the
    output stays in the pipe for the caller."""
    import threading

    lines: list[str] = []
    done = threading.Event()

    def pump() -> None:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(prefix):
                break
        done.set()

    threading.Thread(target=pump, name="read-until", daemon=True).start()
    if not done.wait(timeout):
        proc.kill()
        done.wait(10)
        raise RuntimeError(f"no '{prefix}' line within {timeout:g} s: {lines}")
    if not lines or not lines[-1].startswith(prefix):
        raise RuntimeError(f"the process ended before a '{prefix}' line: {lines}")
    return lines


def _run_obs_demo(p: argparse.ArgumentParser, args) -> int:
    import json
    import os

    from akka_allreduce_tpu_torch._device import resolve_device

    try:
        resolve_device(args.device)  # the nodes' device must exist here
    except (RuntimeError, ValueError) as e:
        p.error(str(e))
    os.makedirs(args.out_dir, exist_ok=True)
    traces = [os.path.join(args.out_dir, "trace-master.json")]
    metrics_path = os.path.join(args.out_dir, "metrics-master.jsonl")
    for f in (metrics_path, *traces):
        if os.path.exists(f):
            os.remove(f)
    master = spawn_role(
        "cluster-master", "--port", "0", "--nodes", str(args.nodes),
        "--rounds", str(args.rounds), "--size", str(args.size),
        "--chunk", str(args.chunk), "--heartbeat", "0.1",
        "--trace-out", traces[0], "--metrics-out", metrics_path,
    )
    nodes = []
    device_args = ["--device", args.device] if args.device else []
    try:
        seed = read_until(master, "master listening on ")[-1].split()[-1]
        for k in range(args.nodes):
            t = os.path.join(args.out_dir, f"trace-node{k}.json")
            node_metrics = os.path.join(args.out_dir, f"metrics-node{k}.jsonl")
            # MetricsLogger appends: a previous run's files would mix in
            for f in (t, node_metrics):
                if os.path.exists(f):
                    os.remove(f)
            traces.append(t)
            nodes.append(
                spawn_role(
                    "cluster-node", "--seed", seed, "--trace-out", t,
                    "--metrics-out", node_metrics, *device_args,
                )
            )
        master.communicate(timeout=120)
        for n in nodes:
            n.communicate(timeout=60)
    finally:
        for proc in [master, *nodes]:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

    from akka_allreduce_tpu_torch.obs import trace as obs_trace

    merged = obs_trace.merge_chrome_traces(
        traces, os.path.join(args.out_dir, "trace.json")
    )
    with open(merged) as f:
        events = json.load(f)["traceEvents"]
    by_trace: dict[str, set] = {}
    for e in events:
        tid = e.get("args", {}).get("trace_id")
        if tid:
            by_trace.setdefault(tid, set()).add(e["cat"])
    full = [
        t for t, cats in by_trace.items()
        if {"line_master", "worker", "transport"} <= cats
    ]
    print(
        f"demo: {len(events)} spans, {len(by_trace)} traces, "
        f"{len(full)} round trace(s) spanning line_master+worker+transport"
    )
    print(f"merged Perfetto trace: {merged} (open at https://ui.perfetto.dev)")
    print(f"metrics snapshots: {args.out_dir}/metrics-*.jsonl")
    return 0 if full else 1
