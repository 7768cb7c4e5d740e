"""The chaos drills: the port's copies of the JAX CLI's ``chaos``,
``chaos-recover``, ``chaos-gossip``, ``chaos-scale``, ``chaos-failover``,
``chaos-adapt``, ``chaos-train`` and ``chaos-train-node``, with the same
flags, phases, assertions and summary JSON.

Each drill is one parent process that spawns a real cluster over loopback
TCP (``cluster-master``, ``cluster-standby``, ``cluster-node`` or
``chaos-train-node`` processes, each a new ``python -m
akka_allreduce_tpu_torch`` interpreter), arms it with a seeded chaos spec
(``control/chaos.py``), drives its phases from the processes' own output
(metrics JSONL, marker lines, exit codes) and prints one summary JSON line;
exit 0 iff every assertion held. The nodes hold their round buffers (and,
for ``chaos-train``, their trainers) on the card unless the drill is given
``--device cpu``; the drill's own process and the masters open no CUDA
context. ``chaos-train``'s ``dp`` and ``zero1`` families average every f32
step's gradients through K1 on the card.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import sys
import time

def _drill_spawn(env, device: str | None = None):
    """Subprocess factory shared by the chaos drills: ONE parent python
    owns every role (separate shell jobs may land in isolated container
    network namespaces and never reach each other's loopback ports). Each
    role is a new interpreter (``python -m akka_allreduce_tpu_torch``),
    never a fork of a process that has started CUDA; the node roles get
    ``--device`` when the drill was given one (else they take the card).

    On the CPU every role computes on one intra-op thread
    (``OMP_NUM_THREADS=1``, which torch reads at start-up): a drill's
    roles share the host, and torch's spinning intra-op workers in several
    nodes would starve the other roles' event loops (late heartbeats read
    as deaths)."""
    import subprocess

    if device == "cpu":
        env = {**(env if env is not None else os.environ), "OMP_NUM_THREADS": "1"}

    def spawn(*cli):
        extra = ["--device", device] if device and cli[0] in _NODE_ROLES else []
        return subprocess.Popen(
            [sys.executable, "-m", "akka_allreduce_tpu_torch", *cli, *extra],
            env=env, stdout=subprocess.PIPE, text=True,
        )

    return spawn


#: the roles that hold payloads or a trainer, so run on the drill's device
_NODE_ROLES = ("cluster-node", "chaos-train-node")


def _add_drill_device_flag(p: argparse.ArgumentParser) -> None:
    """Every drill puts its nodes on the card unless told ``--device cpu``;
    the drill's own process and the masters open no CUDA context."""
    p.add_argument(
        "--device", default=None,
        help="the nodes' device: 'cpu' keeps their round buffers (and "
        "trainers) on the host; default: the CUDA card",
    )


def _drill_device(p: argparse.ArgumentParser, args) -> str | None:
    """The ``--device`` the drill passes to its nodes, checked here (no
    CUDA context is created) so that a drill asked for the card fails at
    once where there is none, rather than through its nodes."""
    from akka_allreduce_tpu_torch._device import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        p.error(str(e))
    return args.device


def _drill_pump(proc, into: list):
    """Drain a drill subprocess's stdout into ``into`` from a daemon
    thread (shared by the drills that watch for marker lines — TAKEOVER,
    RESTORE — while the process keeps running)."""
    import threading

    t = threading.Thread(target=lambda: into.extend(proc.stdout), daemon=True)
    t.start()
    return t


def _add_drill_gossip_flags(p: argparse.ArgumentParser) -> None:
    """Every chaos drill can run its cluster under SWIM gossip membership
    instead of hub heartbeats (the JAX package's Makefile pins --gossip on
    all of them, like --streams 2): the drills then prove their scenario
    survives the decentralized detector too."""
    p.add_argument(
        "--gossip", action="store_true",
        help="arm SWIM gossip membership on the drill's cluster "
        "(distributed via Welcome, RESILIENCE.md 'Tier 6')",
    )
    p.add_argument(
        "--gossip-interval", type=float, default=0.25, metavar="S",
        help="gossip probe period for the drill cluster",
    )


def _drill_gossip_args(args) -> list[str]:
    """Extra cluster-master CLI args for a drill's master spawn."""
    if not getattr(args, "gossip", False):
        return []
    return [
        "--gossip", "--gossip-interval",
        str(getattr(args, "gossip_interval", 0.25)),
    ]


def _add_drill_lever_flags(p: argparse.ArgumentParser) -> None:
    """Every chaos drill can arm the data plane v3 levers on its cluster
    (the JAX package's Makefile pins all three, like --streams 2 and
    --gossip): the drills then prove their scenario survives the levered plane too. With
    --streams 2 the intra-chunk split is inert by construction (one
    payload stream — nothing to split across), but the knob distribution,
    scheduler, and uring probe/fallback paths all run."""
    p.add_argument(
        "--uring", action="store_true",
        help="arm io_uring burst submission on the drill's cluster",
    )
    p.add_argument(
        "--intra-chunk", type=int, default=0, metavar="BYTES",
        dest="intra_chunk",
        help="arm intra-chunk striping at this byte bar (0 = off)",
    )
    p.add_argument(
        "--congestion", action="store_true",
        help="arm congestion-aware stripe scheduling",
    )


def _drill_lever_args(args) -> list[str]:
    """Extra cluster-master CLI args arming the v3 levers for a drill."""
    out: list[str] = []
    if getattr(args, "uring", False):
        out.append("--uring")
    bar = getattr(args, "intra_chunk", 0)
    if bar:
        out += ["--intra-chunk", str(bar)]
    if getattr(args, "congestion", False):
        out.append("--congestion")
    return out


def _drill_jsonl_records(path):
    """Records of a (possibly live) metrics JSONL — the ONE torn-tolerant
    reader every drill scan goes through: blank lines and the in-progress
    writer's torn last line are skipped, never a traceback."""
    import json
    import os

    if not os.path.exists(path):
        return
    with open(path) as f:
        for ln in f:
            if not ln.strip():
                continue
            try:
                yield json.loads(ln)
            except ValueError:
                continue  # the writer is mid-append


def _drill_full_rounds(path, workers: int) -> int:
    """Completed line-rounds with FULL membership recorded in a master's
    metrics JSONL — recovery progress only counts when every node is back
    in the line."""
    return sum(
        1
        for rec in _drill_jsonl_records(path)
        if rec.get("kind") == "round" and rec.get("workers") == workers
    )


def _drill_phase_waiter(timeout_s: float, failures: list):
    """``await_phase(pred, what)`` with one shared timeout/report shape."""

    def await_phase(pred, what: str) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.2)
        failures.append(f"timed out waiting for {what}")
        return False

    return await_phase




def cmd_chaos(argv: list[str]) -> int:
    """Chaos harness: a real master + N node OS processes over loopback,
    every transport armed with the SAME seeded fault schedule (the master
    distributes the spec via Welcome), invariants summarized at the end.
    With ``--duration`` it runs open-ended for that many seconds instead
    (RESILIENCE.md)."""
    p = argparse.ArgumentParser(
        "chaos",
        description="run a tiny cluster under seeded fault injection and "
        "report what happened (chaos events vs rounds completed)",
    )
    p.add_argument("--seed", type=int, default=1234, help="chaos seed")
    p.add_argument(
        "--spec",
        default="drop:p=0.05;delay:ms=10;corrupt:p=0.02",
        help="fault spec (see RESILIENCE.md for the grammar)",
    )
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument(
        "--rounds", type=int, default=50,
        help="line-round budget; ignored when --duration is set",
    )
    p.add_argument(
        "--duration", type=float, default=None,
        help="run open-ended for this many seconds instead of a round "
        "budget (a soak)",
    )
    p.add_argument("--size", type=int, default=65536)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--th", type=float, default=0.66)
    p.add_argument("--heartbeat", type=float, default=0.1)
    p.add_argument(
        "--streams", type=int, default=1,
        help="data-plane sockets per endpoint (distributed via Welcome); "
        "2 makes the drill exercise the multi-stream reassembly path "
        "under every injected fault",
    )
    p.add_argument("--out-dir", default="chaos_run")
    _add_drill_gossip_flags(p)
    _add_drill_lever_flags(p)
    _add_drill_device_flag(p)
    args = p.parse_args(argv)
    # fail fast on a malformed spec BEFORE spawning anything — a parse
    # error inside the master subprocess would surface as an opaque
    # "never reported its endpoint" failure here
    from akka_allreduce_tpu_torch.control.chaos import parse_spec

    try:
        parse_spec(args.spec)
    except ValueError as e:
        p.error(str(e))

    import json
    import os
    import signal as _signal
    import subprocess

    os.makedirs(args.out_dir, exist_ok=True)
    metrics_path = os.path.join(args.out_dir, "rounds.jsonl")
    master_log = os.path.join(args.out_dir, "chaos-master.jsonl")
    stale = [f for f in os.listdir(args.out_dir) if f.endswith(".jsonl")]
    for f in stale:  # MetricsLogger appends; never mix two runs' records
        os.remove(os.path.join(args.out_dir, f))
    env = dict(os.environ)
    spawn = _drill_spawn(env, _drill_device(p, args))
    rounds = -1 if args.duration else args.rounds
    wedged = False
    master = spawn(
        "cluster-master", "--port", "0", "--nodes", str(args.nodes),
        "--rounds", str(rounds), "--size", str(args.size),
        "--chunk", str(args.chunk), "--th", str(args.th),
        "--heartbeat", str(args.heartbeat),
        "--streams", str(args.streams),
        "--chaos-seed", str(args.seed), "--chaos-spec", args.spec,
        "--chaos-log", master_log, "--metrics-out", metrics_path,
        *_drill_gossip_args(args),
        *_drill_lever_args(args),
    )
    nodes = []
    t0 = time.perf_counter()
    master_done = False
    try:
        seed_ep = None
        for line in master.stdout:
            if line.startswith("master listening on "):
                seed_ep = line.split()[-1]
                break
        if seed_ep is None:
            raise RuntimeError("master never reported its endpoint")
        for k in range(args.nodes):
            nodes.append(
                spawn(
                    "cluster-node", "--seed", seed_ep, "--node-id", str(k),
                    "--chaos-log",
                    os.path.join(args.out_dir, f"chaos-node{k}.jsonl"),
                )
            )
        try:
            if args.duration:
                time.sleep(args.duration)
                master.send_signal(_signal.SIGTERM)
                master.wait(timeout=30)
                # the Shutdown broadcast is racing any mid-rejoin node:
                # give every node a grace window to exit (and flush its
                # chaos log) before the finally-kill
                for n in nodes:
                    try:
                        n.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        pass
            else:
                out, _ = master.communicate(timeout=600)
                master_done = "master done" in out
                for n in nodes:
                    try:
                        n.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        n.kill()
        except subprocess.TimeoutExpired:
            # a wedged cluster is a RESULT for this harness, not a crash:
            # fall through to the summary (which will report the wedge and
            # exit non-zero), never a bare traceback
            wedged = True
    finally:
        for proc in [master, *nodes]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    elapsed = time.perf_counter() - t0
    rounds_completed = 0
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            rounds_completed = sum(
                1
                for ln in f
                if ln.strip() and json.loads(ln).get("kind") == "round"
            )
    events: dict[str, int] = {}
    logs = sorted(
        f for f in os.listdir(args.out_dir) if f.startswith("chaos-")
    )
    for f in logs:
        with open(os.path.join(args.out_dir, f)) as fh:
            for ln in fh:
                if ln.strip():
                    fault = json.loads(ln)["fault"]
                    events[fault] = events.get(fault, 0) + 1
    from akka_allreduce_tpu_torch.control.chaos import CRASH_EXIT_CODE

    summary = {
        "seed": args.seed,
        "spec": args.spec,
        "elapsed_s": round(elapsed, 1),
        "rounds_completed": rounds_completed,
        "master_done": master_done or None,
        "wedged": wedged or None,
        "chaos_events": events,
        "chaos_logs": logs,
        "node_exits": [n.returncode for n in nodes],
        "injected_crashes": sum(
            1 for n in nodes if n.returncode == CRASH_EXIT_CODE
        ),
    }
    print(json.dumps(summary))
    # pass = the cluster made progress UNDER chaos without wedging; with a
    # round budget the budget must also have finished
    ok = (
        not wedged
        and rounds_completed > 0
        and (args.duration is not None or master_done)
    )
    return 0 if ok else 1


def _blobs_match_replicas(
    state_dirs, victim: int, restore: dict, n_nodes: int, failures: list
) -> bool | None:
    """Byte-identity for the chaos-recover drill, against the RESTORE
    record's own leaf->sha evidence (printed by the node at restore time —
    immune to the node's later saves/prunes racing this check): every
    restored blob must exist on some replica with bytes that hash back to
    its content-addressed name (the same verify gate the restore itself
    passed — hash equality IS byte equality here), and when the victim's
    copy is still on disk it is compared raw as well."""
    from akka_allreduce_tpu_torch.control.statetransfer import ChunkStore, npy_sha

    shas = set(restore.get("leaves", {}).values())
    if not shas:
        failures.append("restore record carries no leaf evidence")
        return None
    own = ChunkStore(state_dirs[victim])
    ok = True
    for sha in sorted(shas):
        replica_bytes = None
        for k in range(n_nodes):
            if k == victim:
                continue
            peer = ChunkStore(state_dirs[k])
            try:
                # the replicas are LIVE and pruning; a blob vanishing
                # between has() and read() is the next peer's problem,
                # not a harness crash
                if peer.has(sha):
                    replica_bytes = peer.read(sha)
                    break
            except FileNotFoundError:
                continue
        if replica_bytes is None:
            ok = False
            failures.append(f"blob {sha[:12]} held by no replica")
            continue
        if npy_sha(replica_bytes) != sha:
            ok = False
            failures.append(f"replica blob {sha[:12]} fails content hash")
        try:
            mine = own.read(sha) if own.has(sha) else None
        except FileNotFoundError:  # pruned between has() and read()
            mine = None
        if mine is not None and mine != replica_bytes:
            ok = False
            failures.append(f"blob {sha[:12]} differs from replica")
    return ok


def cmd_chaos_recover(argv: list[str]) -> int:
    """Crash + disk-loss recovery drill (RESILIENCE.md "Recovery"): a real
    master + N state-armed node processes run a round
    budget under a SEEDED chaos crash of one node; the harness then deletes
    the crashed node's checkpoint directory (disk loss) and respawns it.
    The node must rejoin, pull its state back from live peer replicas
    (``RESTORE {"source": "peer", ...}``), keep contributing, and the
    budget must finish — with the restored blobs byte-identical to the
    replica copies."""
    p = argparse.ArgumentParser(
        "chaos-recover",
        description="seeded crash + checkpoint-dir loss; assert the node "
        "recovers via peer restore and the round budget completes",
    )
    p.add_argument("--seed", type=int, default=1234, help="chaos seed")
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument(
        "--crash-round", type=int, default=25,
        help="round at which the victim's seeded crash fires (several "
        "save/replicate cycles must fit before it — see --state-every)",
    )
    p.add_argument(
        "--min-post-rounds", type=int, default=40,
        help="full-membership rounds that must complete AFTER the peer "
        "restore before the run is allowed to finish (the post-recovery "
        "half of the training budget)",
    )
    p.add_argument(
        "--phase-timeout", type=float, default=240.0,
        help="wall-clock bound on each recovery phase",
    )
    p.add_argument("--size", type=int, default=65536)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--th", type=float, default=0.66)
    p.add_argument("--heartbeat", type=float, default=0.1)
    p.add_argument(
        "--streams", type=int, default=1,
        help="data-plane sockets per endpoint (distributed via Welcome)",
    )
    p.add_argument("--state-every", type=int, default=5)
    p.add_argument("--out-dir", default="chaos_recover_run")
    _add_drill_gossip_flags(p)
    _add_drill_lever_flags(p)
    _add_drill_device_flag(p)
    args = p.parse_args(argv)
    if args.nodes < 3:
        p.error("need >= 3 nodes: the victim plus at least 2 replica holders")

    import json
    import os
    import shutil
    import signal as _signal
    import subprocess

    from akka_allreduce_tpu_torch.control.chaos import CRASH_EXIT_CODE

    victim = args.nodes - 1
    spec = f"crash:node={victim},at=round{args.crash_round}"
    os.makedirs(args.out_dir, exist_ok=True)
    metrics_path = os.path.join(args.out_dir, "rounds.jsonl")
    if os.path.exists(metrics_path):
        os.remove(metrics_path)  # MetricsLogger appends; one run per file
    state_dirs = [
        os.path.join(args.out_dir, f"state{k}") for k in range(args.nodes)
    ]
    for d in state_dirs:
        if os.path.isdir(d):
            shutil.rmtree(d)  # a fresh drill must not inherit old state
    env = dict(os.environ)
    spawn = _drill_spawn(env, _drill_device(p, args))

    def spawn_node(seed_ep, k):
        return spawn(
            "cluster-node", "--seed", seed_ep, "--node-id", str(k),
            "--state-dir", state_dirs[k],
            "--state-every", str(args.state_every),
        )

    failures: list[str] = []
    restore = None
    crash_exit = None
    master_done = False
    byte_identical = None
    reborn = None
    reborn_lines: list[str] = []
    rounds_at_crash = rounds_at_done = 0

    def full_rounds() -> int:
        return _drill_full_rounds(metrics_path, args.nodes)

    await_phase = _drill_phase_waiter(args.phase_timeout, failures)

    master = spawn(
        "cluster-master", "--port", "0", "--nodes", str(args.nodes),
        "--rounds", "-1", "--size", str(args.size),
        "--chunk", str(args.chunk), "--th", str(args.th),
        "--heartbeat", str(args.heartbeat),
        "--streams", str(args.streams),
        "--chaos-seed", str(args.seed), "--chaos-spec", spec,
        "--metrics-out", metrics_path,
        *_drill_gossip_args(args),
        *_drill_lever_args(args),
    )
    nodes = []
    try:
        seed_ep = None
        for line in master.stdout:
            if line.startswith("master listening on "):
                seed_ep = line.split()[-1]
                break
        if seed_ep is None:
            raise RuntimeError("master never reported its endpoint")
        nodes = [spawn_node(seed_ep, k) for k in range(args.nodes)]
        # phase 1: the seeded crash fires (deterministic round trigger; the
        # run is open-ended, so no machine is "too fast" for the drill)
        try:
            crash_exit = nodes[victim].wait(timeout=args.phase_timeout)
        except subprocess.TimeoutExpired:
            failures.append("victim never crashed (chaos round not reached)")
        if crash_exit is not None and crash_exit != CRASH_EXIT_CODE:
            failures.append(
                f"victim exited {crash_exit}, not the chaos crash "
                f"{CRASH_EXIT_CODE}"
            )
        rounds_at_crash = full_rounds()
        # phase 2: the disk dies with the process
        shutil.rmtree(state_dirs[victim], ignore_errors=True)
        # phase 2.5 (the deflake gate): wait for the MASTER to have
        # OBSERVED the death — a reduced-membership round record in its
        # metrics JSONL proves the victim was expelled and the grid
        # re-organized. Respawning before that races the detector: the
        # victim's id still reads as a LIVE member, so the reborn
        # process's preferred id is "taken" and it gets minted a fresh
        # id whose checkpoint history is empty — the restore then misses
        # through no fault of the recovery path (the historical flake).
        if not failures:
            await_phase(
                lambda: _drill_full_rounds(metrics_path, args.nodes - 1) >= 1,
                "the master's expulsion of the victim "
                "(reduced-membership rounds in the metrics log)",
            )
        # phase 3: same identity, empty disk — recovery must come from
        # peers; its stdout is pumped on a thread so RESTORE is observable
        # while the cluster keeps running
        if not failures:
            reborn = spawn_node(seed_ep, victim)
            pump = _drill_pump(reborn, reborn_lines)
            await_phase(
                lambda: any(
                    ln.startswith("RESTORE ") for ln in list(reborn_lines)
                ),
                "the respawned node's restore report",
            )
            for line in list(reborn_lines):
                if line.startswith("RESTORE "):
                    restore = json.loads(line[len("RESTORE "):])
            # byte-identity is checked NOW, against the RESTORED step's
            # manifest, while its blobs and the replicas' copies are all
            # still on disk — the node keeps saving (and pruning) after
            # this, and the FINAL save's replication is asynchronous, so a
            # shutdown-time check against `latest()` would race both
            if restore is not None and restore.get("complete"):
                byte_identical = _blobs_match_replicas(
                    state_dirs, victim, restore, args.nodes, failures
                )
            # phase 4: the post-recovery training budget — min_post_rounds
            # MORE full-membership rounds with the restored node in the line
            target = full_rounds() + args.min_post_rounds
            await_phase(
                lambda: full_rounds() >= target,
                f"{args.min_post_rounds} full-membership rounds post-restore",
            )
        rounds_at_done = full_rounds()
        # phase 5: end the open-ended run gracefully (Shutdown broadcast)
        master.send_signal(_signal.SIGTERM)
        try:
            out_master, _ = master.communicate(timeout=60)
            master_done = "master done" in out_master
        except subprocess.TimeoutExpired:
            failures.append("master did not shut down on SIGTERM")
        for n in (n for i, n in enumerate(nodes) if i != victim):
            try:
                n.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                n.kill()
        if reborn is not None:
            # its stdout is owned by the pump thread — wait, don't
            # communicate (two readers on one pipe)
            try:
                reborn.wait(timeout=30)
            except subprocess.TimeoutExpired:
                reborn.kill()
            pump.join(timeout=10)
    finally:
        for proc in [master, *nodes, *([reborn] if reborn else [])]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()

    post_rounds = 0
    for line in reborn_lines:
        if line.startswith("RESTORE ") and restore is None:
            restore = json.loads(line[len("RESTORE "):])
        m = re.search(r"shut down \([^)]*\): (\d+) rounds", line)
        if m:
            post_rounds = int(m.group(1))
    if restore is None:
        failures.append("respawned node never reported a restore")
    else:
        if restore.get("source") != "peer":
            failures.append(f"restore source {restore.get('source')!r} != 'peer'")
        if not restore.get("complete"):
            failures.append("peer restore incomplete")
        elif byte_identical is None:
            failures.append("byte-identity was never checked")
    if not master_done:
        failures.append("run did not finish cleanly")
    if reborn is not None and reborn.returncode not in (0, None):
        failures.append(f"respawned node exited {reborn.returncode}")
    if not post_rounds:
        failures.append("no post-restore round progress at the reborn node")

    # torn-tolerant via the shared reader: when the master had to be
    # killed (a failure path), its metrics writer may have died mid-append
    # — the summary must still come out instead of a JSON traceback
    rounds_completed = sum(
        1
        for rec in _drill_jsonl_records(metrics_path)
        if rec.get("kind") == "round"
    )
    summary = {
        "seed": args.seed,
        "spec": spec,
        "rounds_completed": rounds_completed,
        "full_rounds_at_crash": rounds_at_crash,
        "full_rounds_post_restore": rounds_at_done - rounds_at_crash,
        "master_done": master_done,
        "crash_exit": crash_exit,
        "restore": restore,
        "post_restore_rounds": post_rounds,
        "byte_identical": byte_identical,
        "failures": failures,
    }
    print(json.dumps(summary))
    return 0 if not failures else 1


def cmd_chaos_gossip(argv: list[str]) -> int:
    """Decentralized-membership drill (RESILIENCE.md "Tier 6"): a real
    master + N node processes run under
    SWIM gossip membership while a SEEDED ONE-DIRECTIONAL partition cuts
    one node's sends TO the master (``partition:from=K,to=m``) — the
    exact asymmetric loss that makes a hub detector read a healthy node
    as dead. Pass requires:

    - ZERO expulsions while the bad link is down (indirect probes through
      the other nodes keep vouching for the victim — full-membership
      rounds keep completing throughout);
    - after the window heals, a node SIGKILLed for real IS expelled by
      the gossip verdict and the grid reorganizes (the detector still
      detects — it just needs more than one vantage point to convict).
    """
    p = argparse.ArgumentParser(
        "chaos-gossip",
        description="seeded asymmetric partition of the master's inbound "
        "link under gossip membership; assert zero false expulsions, "
        "then a real kill is still detected",
    )
    p.add_argument("--seed", type=int, default=1234, help="chaos seed")
    p.add_argument("--nodes", type=int, default=5)
    p.add_argument(
        "--partition-at", type=float, default=6.0,
        help="seconds (per-process clock) until the one-way partition",
    )
    p.add_argument(
        "--partition-for", type=float, default=6.0,
        help="how long the bad link stays down",
    )
    p.add_argument(
        "--min-post-rounds", type=int, default=10,
        help="reduced-membership rounds required after the real kill",
    )
    p.add_argument("--phase-timeout", type=float, default=240.0)
    p.add_argument("--size", type=int, default=65536)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--th", type=float, default=0.66)
    p.add_argument("--heartbeat", type=float, default=0.1)
    p.add_argument("--gossip-interval", type=float, default=0.25)
    p.add_argument(
        "--streams", type=int, default=1,
        help="data-plane sockets per endpoint (distributed via Welcome)",
    )
    _add_drill_lever_flags(p)
    _add_drill_device_flag(p)
    p.add_argument("--out-dir", default="chaos_gossip_run")
    args = p.parse_args(argv)
    if args.nodes < 4:
        # th=0.66 must stay satisfiable by the reporters the master can
        # hear while ONE node's completions are cut: need
        # ceil(0.66*N) <= N-1, and >= 2 relays for indirect probes
        p.error("need >= 4 nodes (threshold headroom + indirect relays)")

    import json
    import os
    import signal as _signal
    import subprocess

    victim = args.nodes - 1  # the bad-link node (stays healthy)
    killed = args.nodes - 2  # the really-dead node of phase 2
    spec = (
        f"partition:from={victim},to=m,"
        f"at={args.partition_at:g}s,heal={args.partition_for:g}s"
    )
    os.makedirs(args.out_dir, exist_ok=True)
    metrics_path = os.path.join(args.out_dir, "rounds.jsonl")
    stale = [f for f in os.listdir(args.out_dir) if f.endswith(".jsonl")]
    for f in stale:
        os.remove(os.path.join(args.out_dir, f))
    env = dict(os.environ)
    spawn = _drill_spawn(env, _drill_device(p, args))
    failures: list[str] = []
    await_phase = _drill_phase_waiter(args.phase_timeout, failures)

    def full_rounds() -> int:
        return _drill_full_rounds(metrics_path, args.nodes)

    def reduced_rounds() -> int:
        return _drill_full_rounds(metrics_path, args.nodes - 1)

    master = spawn(
        "cluster-master", "--port", "0", "--nodes", str(args.nodes),
        "--rounds", "-1", "--size", str(args.size),
        "--chunk", str(args.chunk), "--th", str(args.th),
        "--heartbeat", str(args.heartbeat),
        "--streams", str(args.streams),
        *_drill_lever_args(args),
        "--gossip", "--gossip-interval", str(args.gossip_interval),
        "--chaos-seed", str(args.seed), "--chaos-spec", spec,
        "--chaos-log", os.path.join(args.out_dir, "chaos-master.jsonl"),
        "--metrics-out", metrics_path,
    )
    nodes = []
    master_done = False
    master_lines: list[str] = []
    rounds_before_partition = rounds_after_heal = 0
    false_expulsions = kill_detected = None
    detect_s = None
    try:
        seed_ep = None
        for line in master.stdout:
            if line.startswith("master listening on "):
                seed_ep = line.split()[-1]
                break
        if seed_ep is None:
            raise RuntimeError("master never reported its endpoint")
        t_spawn = time.monotonic()
        for k in range(args.nodes):
            nodes.append(
                spawn(
                    "cluster-node", "--seed", seed_ep, "--node-id", str(k),
                    "--chaos-log",
                    os.path.join(args.out_dir, f"chaos-node{k}.jsonl"),
                )
            )
        # phase 1: a healthy baseline before the bad link goes down
        await_phase(
            lambda: full_rounds() >= 5, "pre-partition full-membership rounds"
        )
        rounds_before_partition = full_rounds()
        # phase 2: full-membership rounds must KEEP accumulating through
        # the one-way partition — gated on observed round records, not a
        # wall anchor: the partition triggers are per-process clocks
        # (each injector's t0 is its process start), and on a loaded box
        # the imports alone can eat most of a wall-anchored window,
        # turning a progress comparison into a vacuous 6 -> 6
        await_phase(
            lambda: full_rounds() >= rounds_before_partition + 8,
            "full-membership rounds continuing through the one-way "
            "partition (a stall here means the bad link wedged the line)",
        )
        # ...and the kill phase must not overlap the partition window:
        # ride out whatever remains of it (per-process t0 >= t_spawn, so
        # this bounds every process's window from above) plus several
        # suspicion windows of post-heal slack
        window_end = (
            t_spawn + args.partition_at + args.partition_for
            + 8 * args.gossip_interval
        )
        while time.monotonic() < window_end:
            time.sleep(0.2)
        rounds_after_heal = full_rounds()
        false_expulsions = reduced_rounds()
        if false_expulsions:
            failures.append(
                f"{false_expulsions} reduced-membership round(s) during the "
                "one-way partition: a healthy node was expelled"
            )
        # phase 3: a REAL death must still be detected by the ring
        t_kill = time.monotonic()
        nodes[killed].kill()
        target = args.min_post_rounds
        kill_detected = await_phase(
            lambda: reduced_rounds() >= target,
            f"{target} reduced-membership rounds after the real kill",
        )
        detect_s = round(time.monotonic() - t_kill, 2)
        # phase 4: graceful end (Shutdown broadcast flushes every log)
        master.send_signal(_signal.SIGTERM)
        try:
            out_master, _ = master.communicate(timeout=60)
            master_lines = out_master.splitlines()
            master_done = any("master done" in ln for ln in master_lines)
        except subprocess.TimeoutExpired:
            failures.append("master did not shut down on SIGTERM")
        for i, n in enumerate(nodes):
            if i == killed:
                continue
            try:
                n.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                n.kill()
    finally:
        for proc in [master, *nodes]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()

    # the master's exit snapshot carries the gossip counters (expulsions
    # must be exactly 1: the killed node — never the bad-link victim)
    gossip_metrics = {}
    for rec in _drill_jsonl_records(metrics_path):
        if (
            rec.get("kind") == "metrics_snapshot"
            and rec.get("role") == "master"
        ):
            gossip_metrics = {
                k: v
                for k, v in rec.get("metrics", {}).items()
                if k.startswith("gossip.")
            }
    if gossip_metrics.get("gossip.expulsions") != 1:
        failures.append(
            "expected exactly 1 gossip expulsion (the killed node), got "
            f"{gossip_metrics.get('gossip.expulsions')!r}"
        )
    if not master_done:
        failures.append("run did not finish cleanly")
    summary = {
        "seed": args.seed,
        "spec": spec,
        "full_rounds_pre_partition": rounds_before_partition,
        "full_rounds_post_heal": rounds_after_heal,
        "false_expulsions": false_expulsions,
        "kill_detected": bool(kill_detected),
        "reduced_rounds_post_kill": reduced_rounds(),
        "detect_plus_rounds_s": detect_s,
        "gossip": gossip_metrics,
        "master_done": master_done,
        "failures": failures,
    }
    print(json.dumps(summary))
    return 0 if not failures else 1


def cmd_chaos_scale(argv: list[str]) -> int:
    """Pod-scale control-plane drill (RESILIENCE.md "Scale"): the largest real-process grid the box allows —
    a leader + warm standby + an RxC pod of nodes bootstrapped from GRID
    COORDINATES (``--grid``/``--process-index``, node id = coordinate)
    and sharded into ``--line-shards`` free-running LineMasters — runs a
    partition + leader kill + node kill sequence:

    - phase 1: EVERY shard completes rounds at its full membership
      (per-shard round records under distinct line ids);
    - phase 2: a seeded ONE-WAY partition cuts one node's master-bound
      sends; gossip's indirect path must keep it in — zero re-shards;
    - phase 3: the leader is SIGKILLed; the warm standby takes over
      (epoch >= 2) and — because shard assignment is a pure function of
      the view — rebuilds the SAME shard layout, every shard resuming
      its own sequence;
    - phase 4: a node is SIGKILLed; its coordinate-anchored shard
      shrinks by exactly one while every other shard keeps its size and
      rounds keep completing;
    - phase 5: graceful SIGTERM end; node exits clean.

    The summary JSON also records the deterministic Fabric's measured
    sim rate on this box (nodes/sec — the 256..1024-node sim arms'
    cost evidence).
    """
    p = argparse.ArgumentParser(
        "chaos-scale",
        description="grid-coordinate pod bootstrap + hierarchical shard "
        "drill: partition, leader kill, node kill — per-shard rounds "
        "must survive all three",
    )
    p.add_argument("--seed", type=int, default=1234, help="chaos seed")
    p.add_argument(
        "--grid", default="2x8", metavar="RxC",
        help="pod layout; every coordinate is spawned as a real process",
    )
    p.add_argument("--line-shards", type=int, default=4)
    p.add_argument(
        "--partition-at", type=float, default=6.0,
        help="seconds (per-process clock) until the one-way partition",
    )
    p.add_argument(
        "--partition-for", type=float, default=6.0,
        help="how long the bad link stays down",
    )
    p.add_argument(
        "--min-shard-rounds", type=int, default=5,
        help="full-membership rounds required per shard per phase",
    )
    p.add_argument(
        "--min-post-rounds", type=int, default=8,
        help="post-node-kill rounds required in the shrunken shard",
    )
    p.add_argument("--phase-timeout", type=float, default=240.0)
    p.add_argument("--size", type=int, default=32768)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--th", type=float, default=0.66)
    p.add_argument("--heartbeat", type=float, default=0.1)
    p.add_argument("--gossip-interval", type=float, default=0.25)
    p.add_argument(
        "--streams", type=int, default=1,
        help="data-plane sockets per endpoint (distributed via Welcome)",
    )
    _add_drill_lever_flags(p)
    _add_drill_device_flag(p)
    p.add_argument("--out-dir", default="chaos_scale_run")
    args = p.parse_args(argv)

    import json
    import os
    import signal as _signal
    import subprocess

    from akka_allreduce_tpu_torch.control import pod as _pod
    from akka_allreduce_tpu_torch.control.simfabric import sim_rate

    try:
        rows, cols = _pod.parse_grid(args.grid)
    except ValueError as e:
        p.error(str(e))
    n_nodes = rows * cols
    blocks = _pod.coordinate_shard_assignment(
        range(n_nodes), rows, cols, args.line_shards
    )
    sizes = {lid: len(b) for lid, b in enumerate(blocks)}
    if min(sizes.values()) < 3:
        # th=0.66 must stay satisfiable inside the partitioned node's
        # shard: ceil(0.66*size) <= size-1 needs size >= 3
        p.error(
            f"shard sizes {sorted(sizes.values())} too small for the "
            "partition phase: need >= 3 nodes per shard (use a larger "
            "--grid or fewer --line-shards)"
        )
    victim_link = blocks[0][-1]  # the bad-link node (stays healthy)
    killed = n_nodes - 1  # the really-dead node (last shard shrinks)
    killed_line = len(blocks) - 1
    sizes_post_kill = dict(sizes)
    sizes_post_kill[killed_line] -= 1
    spec = (
        f"partition:from={victim_link},to=m,"
        f"at={args.partition_at:g}s,heal={args.partition_for:g}s"
    )
    os.makedirs(args.out_dir, exist_ok=True)
    leader_metrics = os.path.join(args.out_dir, "rounds-leader.jsonl")
    standby_metrics = os.path.join(args.out_dir, "rounds-standby.jsonl")
    stale = [f for f in os.listdir(args.out_dir) if f.endswith(".jsonl")]
    for f in stale:
        os.remove(os.path.join(args.out_dir, f))
    env = dict(os.environ)
    spawn = _drill_spawn(env, _drill_device(p, args))
    failures: list[str] = []
    await_phase = _drill_phase_waiter(args.phase_timeout, failures)

    def shard_rounds(path, expected: dict[int, int]) -> dict[int, int]:
        """Per-line count of round records at the line's EXPECTED full
        size (shard assignment is pure in the view, so line id -> size
        is stable across reorganizations of the same membership)."""
        per = {lid: 0 for lid in expected}
        for rec in _drill_jsonl_records(path):
            if rec.get("kind") != "round":
                continue
            lid = rec.get("line")
            if lid in per and rec.get("workers") == expected[lid]:
                per[lid] += 1
        return per

    def reshard_anomalies(path) -> int:
        """Round records whose (line, size) does not match the full
        layout — a healthy-node expulsion would show here first."""
        return sum(
            1
            for rec in _drill_jsonl_records(path)
            if rec.get("kind") == "round"
            and rec.get("workers") != sizes.get(rec.get("line"))
        )

    leader = spawn(
        "cluster-master", "--port", "0", "--nodes", str(n_nodes),
        "--grid", args.grid, "--line-shards", str(args.line_shards),
        "--rounds", "-1", "--size", str(args.size),
        "--chunk", str(args.chunk), "--th", str(args.th),
        "--heartbeat", str(args.heartbeat),
        "--streams", str(args.streams),
        *_drill_lever_args(args),
        "--gossip", "--gossip-interval", str(args.gossip_interval),
        "--chaos-seed", str(args.seed), "--chaos-spec", spec,
        "--chaos-log", os.path.join(args.out_dir, "chaos-leader.jsonl"),
        "--metrics-out", leader_metrics,
    )
    standby = None
    nodes: list = []
    standby_lines: list[str] = []
    takeover = None
    standby_done = False
    rounds_before_partition: dict[int, int] = {}
    rounds_after_heal: dict[int, int] = {}
    anomalies_pre_kill = None
    node_exits: dict = {}
    try:
        seed_ep = None
        for line in leader.stdout:
            if line.startswith("master listening on "):
                seed_ep = line.split()[-1]
                break
        if seed_ep is None:
            raise RuntimeError("leader never reported its endpoint")
        standby = spawn(
            "cluster-standby", "--seed", seed_ep,
            "--heartbeat", str(args.heartbeat),
            "--metrics-out", standby_metrics,
        )
        standby_ep = None
        for line in standby.stdout:
            if line.startswith("standby listening on "):
                standby_ep = line.split()[3]
                break
        if standby_ep is None:
            raise RuntimeError("standby never reported its endpoint")
        standby_pump = _drill_pump(standby, standby_lines)
        t_spawn = time.monotonic()
        for k in range(n_nodes):
            nodes.append(
                spawn(
                    "cluster-node", "--seed", seed_ep,
                    "--grid", args.grid, "--process-index", str(k),
                    "--chaos-log",
                    os.path.join(args.out_dir, f"chaos-node{k}.jsonl"),
                )
            )
        # phase 1: EVERY shard completes rounds at full membership
        await_phase(
            lambda: min(
                shard_rounds(leader_metrics, sizes).values()
            )
            >= args.min_shard_rounds,
            "pre-partition full-membership rounds on every shard",
        )
        rounds_before_partition = shard_rounds(leader_metrics, sizes)
        # phase 2: rounds keep accumulating per shard THROUGH the one-way
        # partition (round-record gated, like chaos-gossip), and no
        # re-shard happens (the indirect path keeps the victim in)
        def _partition_progress() -> int:
            per = shard_rounds(leader_metrics, sizes)  # ONE parse per poll
            return min(
                per[lid] - rounds_before_partition.get(lid, 0)
                for lid in sizes
            )

        await_phase(
            lambda: _partition_progress() >= args.min_shard_rounds,
            "per-shard rounds continuing through the one-way partition",
        )
        window_end = (
            t_spawn + args.partition_at + args.partition_for
            + 8 * args.gossip_interval
        )
        while time.monotonic() < window_end:
            time.sleep(0.2)
        rounds_after_heal = shard_rounds(leader_metrics, sizes)
        anomalies_pre_kill = reshard_anomalies(leader_metrics)
        if anomalies_pre_kill:
            failures.append(
                f"{anomalies_pre_kill} off-layout round record(s) during "
                "the partition window: a healthy node was expelled or a "
                "shard re-split"
            )
        # phase 3: SIGKILL the LEADER; the warm standby must take over
        # and rebuild the SAME shard layout from the replicated view
        leader.send_signal(_signal.SIGKILL)
        leader.wait()
        await_phase(
            lambda: any(
                ln.startswith("TAKEOVER ") for ln in list(standby_lines)
            ),
            "the standby's TAKEOVER line",
        )
        for ln in list(standby_lines):
            if ln.startswith("TAKEOVER "):
                takeover = json.loads(ln[len("TAKEOVER "):])
        await_phase(
            lambda: min(
                shard_rounds(standby_metrics, sizes).values()
            )
            >= args.min_shard_rounds,
            "post-takeover rounds on every shard (same layout)",
        )
        # phase 4: SIGKILL a node — its coordinate-anchored shard shrinks
        # by one, the other shards keep their sizes, rounds continue
        nodes[killed].send_signal(_signal.SIGKILL)
        nodes[killed].wait()

        def _post_kill_progress() -> int:
            per = shard_rounds(standby_metrics, sizes_post_kill)
            return min(per[lid] for lid in sizes_post_kill)

        await_phase(
            lambda: _post_kill_progress() >= args.min_post_rounds,
            "post-node-kill rounds (shrunken shard included)",
        )
        # phase 5: graceful end at the promoted master
        standby.send_signal(_signal.SIGTERM)
        try:
            standby.wait(timeout=60)
        except subprocess.TimeoutExpired:
            failures.append("promoted standby did not shut down on SIGTERM")
        standby_pump.join(timeout=10)
        standby_done = any("master done" in ln for ln in standby_lines)
        for k, n in enumerate(nodes):
            if k == killed:
                node_exits[k] = n.returncode
                continue
            try:
                n.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                # a survivor that wedges in its shutdown path is exactly
                # the defect class this drill exists to catch — record
                # it, don't let the cleanup kill() read as a clean exit
                n.kill()
                n.wait()
                failures.append(
                    f"node {k} did not exit within 30s of the Shutdown "
                    "broadcast (killed)"
                )
            node_exits[k] = n.returncode
            if n.returncode not in (0, None):
                failures.append(f"node {k} exited {n.returncode}")
    finally:
        for proc in [leader, standby, *nodes]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()

    if takeover is None:
        failures.append("standby never took over")
    elif takeover.get("epoch", 0) < 2:
        failures.append(f"takeover did not bump the epoch: {takeover}")
    if not standby_done:
        failures.append("run did not finish cleanly")
    summary = {
        "seed": args.seed,
        "grid": args.grid,
        "line_shards": args.line_shards,
        "shard_sizes": {str(k): v for k, v in sorted(sizes.items())},
        "spec": spec,
        "shard_rounds_pre_partition": {
            str(k): v for k, v in sorted(rounds_before_partition.items())
        },
        "shard_rounds_post_heal": {
            str(k): v for k, v in sorted(rounds_after_heal.items())
        },
        "reshard_anomalies_pre_kill": anomalies_pre_kill,
        "takeover": takeover,
        "shard_rounds_under_standby": {
            str(k): v
            for k, v in sorted(shard_rounds(standby_metrics, sizes).items())
        },
        "shard_rounds_post_kill": {
            str(k): v
            for k, v in sorted(
                shard_rounds(standby_metrics, sizes_post_kill).items()
            )
        },
        "node_exits": {str(k): v for k, v in sorted(node_exits.items())},
        "standby_done": standby_done,
        "sim": sim_rate(256, 5.0),
        "failures": failures,
    }
    print(json.dumps(summary))
    return 0 if not failures else 1


def cmd_chaos_failover(argv: list[str]) -> int:
    """Master-kill failover drill (RESILIENCE.md "Tier 4"): a real leader + warm standby + N state-armed nodes run an
    open-ended round budget; a SEEDED chaos crash (``crash:node=m``) kills
    the leader mid-round. The standby must take over within one lease
    window (TAKEOVER line), rounds must resume under the bumped epoch with
    no round applied twice (every node's ``dup_flushes`` stays 0 — the
    cross-epoch dedup), and a node killed+disk-wiped AFTER the failover
    must still restore from peers via the REPLICATED holder registry. The
    run then ends gracefully via SIGTERM at the promoted master. ``make
    chaos-failover`` runs the fixed-seed variant; exit 0 iff every
    assertion holds."""
    p = argparse.ArgumentParser(
        "chaos-failover",
        description="seeded leader kill mid-round; assert warm-standby "
        "takeover, epoch fencing, cross-epoch round dedup, and a "
        "post-failover peer restore",
    )
    p.add_argument("--seed", type=int, default=1234, help="chaos seed")
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument(
        "--crash-round", type=int, default=25,
        help="round at which the leader's seeded crash fires",
    )
    p.add_argument(
        "--min-post-rounds", type=int, default=40,
        help="full-membership rounds that must complete under the standby "
        "AFTER the post-failover peer restore (the drill's round budget)",
    )
    p.add_argument(
        "--extra-spec", default="",
        help="additional chaos faults layered onto the leader kill "
        "(e.g. 'drop:p=0.02')",
    )
    p.add_argument(
        "--phase-timeout", type=float, default=240.0,
        help="wall-clock bound on each drill phase",
    )
    p.add_argument("--size", type=int, default=65536)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--th", type=float, default=0.66)
    p.add_argument("--heartbeat", type=float, default=0.1)
    p.add_argument(
        "--streams", type=int, default=1,
        help="data-plane sockets per endpoint (distributed via Welcome)",
    )
    p.add_argument("--state-every", type=int, default=5)
    p.add_argument("--out-dir", default="chaos_failover_run")
    _add_drill_gossip_flags(p)
    _add_drill_lever_flags(p)
    _add_drill_device_flag(p)
    args = p.parse_args(argv)
    if args.nodes < 3:
        p.error("need >= 3 nodes: a restore victim plus 2 replica holders")

    import json
    import os
    import re
    import shutil
    import signal as _signal
    import subprocess

    from akka_allreduce_tpu_torch.control.chaos import CRASH_EXIT_CODE, parse_spec

    spec = f"crash:node=m,at=round{args.crash_round}"
    if args.extra_spec:
        spec = f"{spec};{args.extra_spec}"
    try:
        parse_spec(spec)
    except ValueError as e:
        p.error(str(e))
    os.makedirs(args.out_dir, exist_ok=True)
    leader_metrics = os.path.join(args.out_dir, "rounds-leader.jsonl")
    standby_metrics = os.path.join(args.out_dir, "rounds-standby.jsonl")
    for f in (leader_metrics, standby_metrics):
        if os.path.exists(f):
            os.remove(f)  # MetricsLogger appends; one run per file
    state_dirs = [
        os.path.join(args.out_dir, f"state{k}") for k in range(args.nodes)
    ]
    for d in state_dirs:
        if os.path.isdir(d):
            shutil.rmtree(d)
    env = dict(os.environ)
    spawn = _drill_spawn(env, _drill_device(p, args))

    def spawn_node(seed_ep, k):
        return spawn(
            "cluster-node", "--seed", seed_ep, "--node-id", str(k),
            "--state-dir", state_dirs[k],
            "--state-every", str(args.state_every),
        )

    pump = _drill_pump

    def full_rounds(path) -> int:
        return _drill_full_rounds(path, args.nodes)

    failures: list[str] = []
    await_phase = _drill_phase_waiter(args.phase_timeout, failures)

    victim = args.nodes - 1
    crash_exit = None
    rounds_at_crash = 0
    takeover = None
    restore = None
    standby_done = False
    dup_flushes: dict[int, int] = {}
    node_exits: dict[int, int | None] = {}
    standby_lines: list[str] = []
    reborn_lines: list[str] = []
    reborn = None

    leader = spawn(
        "cluster-master", "--port", "0", "--nodes", str(args.nodes),
        "--rounds", "-1", "--size", str(args.size),
        "--chunk", str(args.chunk), "--th", str(args.th),
        "--heartbeat", str(args.heartbeat),
        "--streams", str(args.streams),
        "--chaos-seed", str(args.seed), "--chaos-spec", spec,
        "--chaos-log", os.path.join(args.out_dir, "chaos-leader.jsonl"),
        "--metrics-out", leader_metrics,
        *_drill_gossip_args(args),
        *_drill_lever_args(args),
    )
    standby = None
    nodes = []
    try:
        seed_ep = None
        for line in leader.stdout:
            if line.startswith("master listening on "):
                seed_ep = line.split()[-1]
                break
        if seed_ep is None:
            raise RuntimeError("leader never reported its endpoint")
        standby = spawn(
            "cluster-standby", "--seed", seed_ep,
            "--heartbeat", str(args.heartbeat),
            "--metrics-out", standby_metrics,
        )
        standby_ep = None
        for line in standby.stdout:
            if line.startswith("standby listening on "):
                standby_ep = line.split()[3]
                break
        if standby_ep is None:
            raise RuntimeError("standby never reported its endpoint")
        standby_pump = pump(standby, standby_lines)
        nodes = [spawn_node(seed_ep, k) for k in range(args.nodes)]
        # phase 1: the seeded master kill fires (round trigger mid-run)
        try:
            crash_exit = leader.wait(timeout=args.phase_timeout)
        except subprocess.TimeoutExpired:
            failures.append("leader never crashed (chaos round not reached)")
        if crash_exit is not None and crash_exit != CRASH_EXIT_CODE:
            failures.append(
                f"leader exited {crash_exit}, not the chaos crash "
                f"{CRASH_EXIT_CODE}"
            )
        rounds_at_crash = full_rounds(leader_metrics)
        # phase 2: the standby's lease expires and it takes over
        if not failures:
            await_phase(
                lambda: any(
                    ln.startswith("TAKEOVER ") for ln in list(standby_lines)
                ),
                "the standby's TAKEOVER line",
            )
            for ln in list(standby_lines):
                if ln.startswith("TAKEOVER "):
                    takeover = json.loads(ln[len("TAKEOVER "):])
        # phase 3: rounds resume under the new epoch with full membership
        if not failures:
            await_phase(
                lambda: full_rounds(standby_metrics) >= 5,
                "post-takeover full-membership rounds",
            )
        # phase 4: kill a NODE after the failover, wipe its disk, respawn
        # it at the promoted master — the restore must find peer holders
        # via the registry the digest replicated (plus re-adverts)
        if not failures:
            nodes[victim].send_signal(_signal.SIGKILL)
            nodes[victim].wait()
            node_exits[victim] = nodes[victim].returncode
            shutil.rmtree(state_dirs[victim], ignore_errors=True)
            # phase 4.5 — the chaos-recover deflake applied here too:
            # respawn only after the PROMOTED master demonstrably expelled
            # the victim (a reduced-membership round in its metrics). A
            # join that races the detector reads the victim's id as a
            # LIVE member and mints the reborn node a FRESH id with no
            # checkpoint history — its restore then honestly reports
            # 'none' while the replicas sit on live peers under the old
            # id.
            await_phase(
                lambda: _drill_full_rounds(standby_metrics, args.nodes - 1)
                >= 1,
                "the promoted master's observed expulsion of the victim",
            )
        if not failures:
            reborn = spawn_node(standby_ep, victim)
            reborn_pump = pump(reborn, reborn_lines)
            await_phase(
                lambda: any(
                    ln.startswith("RESTORE ") for ln in list(reborn_lines)
                ),
                "the respawned node's restore report",
            )
            for ln in list(reborn_lines):
                if ln.startswith("RESTORE "):
                    restore = json.loads(ln[len("RESTORE "):])
        # phase 5: the drill's round budget completes under the standby
        if not failures:
            target = full_rounds(standby_metrics) + args.min_post_rounds
            await_phase(
                lambda: full_rounds(standby_metrics) >= target,
                f"{args.min_post_rounds} full-membership rounds "
                "post-restore",
            )
        # phase 6: graceful end at the PROMOTED master
        standby.send_signal(_signal.SIGTERM)
        try:
            standby.wait(timeout=60)
        except subprocess.TimeoutExpired:
            failures.append("promoted standby did not shut down on SIGTERM")
        standby_pump.join(timeout=10)
        standby_done = any("master done" in ln for ln in standby_lines)
        for k, n in enumerate(nodes):
            if k == victim:
                continue
            try:
                out, _ = n.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                n.kill()
                out = ""
            node_exits[k] = n.returncode
            m = re.search(r"dup_flushes=(\d+)", out or "")
            if m:
                dup_flushes[k] = int(m.group(1))
        if reborn is not None:
            try:
                reborn.wait(timeout=30)
            except subprocess.TimeoutExpired:
                reborn.kill()
            reborn_pump.join(timeout=10)
            node_exits[f"{victim}-reborn"] = reborn.returncode
            for ln in reborn_lines:
                m = re.search(r"dup_flushes=(\d+)", ln)
                if m:
                    dup_flushes[victim] = int(m.group(1))
    finally:
        for proc in [leader, standby, *nodes, *([reborn] if reborn else [])]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()

    # assertions over the collected evidence
    if takeover is None:
        failures.append("standby never took over")
    elif takeover.get("epoch", 0) < 2:
        failures.append(f"takeover did not bump the epoch: {takeover}")
    if restore is None:
        failures.append("respawned node never reported a restore")
    else:
        if restore.get("source") != "peer":
            failures.append(
                f"post-failover restore source {restore.get('source')!r} "
                "!= 'peer' (replicated registry not consulted?)"
            )
        if not restore.get("complete"):
            failures.append("post-failover peer restore incomplete")
    if not standby_done:
        failures.append("promoted standby did not finish cleanly")
    for k, dups in sorted(dup_flushes.items()):
        if dups:
            failures.append(
                f"node {k} applied {dups} round(s) twice across the "
                "failover (cross-epoch dedup broken)"
            )
    if len(dup_flushes) < args.nodes:
        failures.append(
            f"dup-flush evidence from only {sorted(dup_flushes)} of "
            f"{args.nodes} node(s)"
        )
    for k, rc in sorted(node_exits.items(), key=str):
        if k == victim:  # SIGKILLed by the drill itself
            continue
        if rc not in (0, None):
            failures.append(f"node {k} exited {rc}")

    summary = {
        "seed": args.seed,
        "spec": spec,
        "crash_exit": crash_exit,
        "full_rounds_at_crash": rounds_at_crash,
        "takeover": takeover,
        "rounds_under_standby": full_rounds(standby_metrics),
        "restore": restore,
        "dup_flushes": dup_flushes,
        "node_exits": {str(k): v for k, v in sorted(node_exits.items(), key=lambda kv: str(kv[0]))},
        "standby_done": standby_done,
        "failures": failures,
    }
    print(json.dumps(summary))
    return 0 if not failures else 1


def cmd_chaos_adapt(argv: list[str]) -> int:
    """Adaptive-degradation drill (RESILIENCE.md "Tier 5"): a real master running the AdaptiveController + N nodes
    with IDENTICAL payloads run an open-ended budget; a SEEDED staged
    straggler (a windowed targeted ``delay`` + a ``stall`` burst inside
    it) slows one node's sends. The controller must DEGRADE (lower
    th_reduce, f16 -> int8 wire) within K rounds of the straggler's
    onset, HOLD without oscillation (total mode transitions bounded),
    RESTORE to full fidelity after the heal, and every node's reduced
    values must stay within the EF error budget (identical payloads =>
    the true average is the payload itself; ``--uniform-check`` measures
    the deviation). Exit 0 iff every assertion holds."""
    p = argparse.ArgumentParser(
        "chaos-adapt",
        description="seeded staged straggler; assert the adaptive "
        "controller degrades, holds, restores, and stays inside the EF "
        "error budget",
    )
    p.add_argument("--seed", type=int, default=1234, help="chaos seed")
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument(
        "--straggle-at", type=int, default=30,
        help="round at which the straggler's delay window opens",
    )
    p.add_argument(
        "--heal-at", type=int, default=150,
        help="round at which the straggler's delay window closes",
    )
    p.add_argument(
        "--delay-ms", type=float, default=400.0,
        help="the straggler's per-send hold inside the window",
    )
    p.add_argument(
        "--stall-for", type=float, default=0.25,
        help="layer a stall burst of this many seconds 20 rounds into the "
        "straggle window (0 = delay only). The default stays under the "
        "phi detector's expulsion point (~0.35s at heartbeat 0.1 with "
        "min_std 0.05) — a slow-but-alive burst, which is the "
        "controller's case; longer values exercise expulsion/rejoin "
        "churn instead",
    )
    p.add_argument(
        "--k-rounds", type=int, default=60,
        help="the controller must first degrade within this many rounds "
        "of the straggle round",
    )
    p.add_argument(
        "--max-transitions", type=int, default=6,
        help="total mode transitions allowed (no-oscillation bound: "
        "2 degrades + 2 restores + slack)",
    )
    p.add_argument(
        "--err-budget", type=float, default=0.15,
        help="max |reduced average - payload| any node may observe "
        "(int8 quantization step ~max|x|/127 with EF; see RESILIENCE.md)",
    )
    p.add_argument(
        "--post-rounds", type=int, default=40,
        help="full-membership rounds that must complete AFTER the restore",
    )
    p.add_argument("--phase-timeout", type=float, default=240.0)
    p.add_argument("--size", type=int, default=65536)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--th", type=float, default=0.66)
    p.add_argument("--heartbeat", type=float, default=0.1)
    p.add_argument(
        "--streams", type=int, default=1,
        help="data-plane sockets per endpoint (distributed via Welcome)",
    )
    p.add_argument("--adapt-window", type=int, default=6)
    p.add_argument("--adapt-dwell", type=int, default=12)
    p.add_argument("--adapt-lag", type=int, default=8)
    p.add_argument("--out-dir", default="chaos_adapt_run")
    _add_drill_gossip_flags(p)
    _add_drill_lever_flags(p)
    _add_drill_device_flag(p)
    args = p.parse_args(argv)

    import json
    import os
    import signal as _signal
    import re
    import subprocess

    from akka_allreduce_tpu_torch.control.chaos import parse_spec

    straggler = args.nodes - 1
    spec = (
        f"delay:node={straggler},ms={args.delay_ms:g},"
        f"at=round{args.straggle_at},for=round{args.heal_at}"
    )
    if args.stall_for > 0:
        spec += (
            f";stall:node={straggler},at=round{args.straggle_at + 20},"
            f"for={args.stall_for:g}s"
        )
    try:
        parse_spec(spec)
    except ValueError as e:
        p.error(str(e))
    os.makedirs(args.out_dir, exist_ok=True)
    metrics_path = os.path.join(args.out_dir, "rounds.jsonl")
    adapt_log = os.path.join(args.out_dir, "adapt-decisions.jsonl")
    for f in (metrics_path, adapt_log):
        if os.path.exists(f):
            os.remove(f)  # MetricsLogger appends; one run per file
    env = dict(os.environ)
    spawn = _drill_spawn(env, _drill_device(p, args))

    failures: list[str] = []
    await_phase = _drill_phase_waiter(args.phase_timeout, failures)

    def adapt_events() -> list[dict]:
        out = []
        if not os.path.exists(metrics_path):
            return out
        with open(metrics_path) as f:
            for ln in f:
                if not ln.strip():
                    continue
                try:
                    rec = json.loads(ln)
                except ValueError:
                    continue  # torn last line of a live writer
                if rec.get("kind") == "adapt":
                    out.append(rec)
        return out

    def full_rounds() -> int:
        return _drill_full_rounds(metrics_path, args.nodes)

    master = spawn(
        "cluster-master", "--port", "0", "--nodes", str(args.nodes),
        "--rounds", "-1", "--size", str(args.size),
        "--chunk", str(args.chunk), "--th", str(args.th),
        "--heartbeat", str(args.heartbeat),
        "--streams", str(args.streams),
        "--chaos-seed", str(args.seed), "--chaos-spec", spec,
        "--chaos-log", os.path.join(args.out_dir, "chaos-master.jsonl"),
        "--metrics-out", metrics_path,
        "--adapt", "--adapt-window", str(args.adapt_window),
        "--adapt-dwell", str(args.adapt_dwell),
        "--adapt-lag", str(args.adapt_lag),
        "--adapt-log", adapt_log,
        *_drill_gossip_args(args),
        *_drill_lever_args(args),
    )
    nodes = []
    node_out: dict[int, str] = {}
    master_done = False
    try:
        seed_ep = None
        for line in master.stdout:
            if line.startswith("master listening on "):
                seed_ep = line.split()[-1]
                break
        if seed_ep is None:
            raise RuntimeError("master never reported its endpoint")
        nodes = [
            spawn(
                "cluster-node", "--seed", seed_ep, "--node-id", str(k),
                # IDENTICAL payloads on every node: the reduced average
                # must equal the payload, so deviation == wire error
                "--data-seed", "7", "--uniform-check",
                "--chaos-log",
                os.path.join(args.out_dir, f"chaos-node{k}.jsonl"),
            )
            for k in range(args.nodes)
        ]
        # phase 1: the straggler window opens and the controller degrades
        await_phase(
            lambda: any(e["to"] > e["from"] for e in adapt_events()),
            "the controller's first degrade decision",
        )
        first_degrade = next(
            (e for e in adapt_events() if e["to"] > e["from"]), None
        )
        if first_degrade is not None:
            lateness = first_degrade["round"] - args.straggle_at
            if lateness > args.k_rounds:
                failures.append(
                    f"controller degraded {lateness} rounds after the "
                    f"straggle round (budget {args.k_rounds})"
                )
        # phase 2: after the heal the controller walks back to level 0
        if not failures:
            await_phase(
                lambda: any(
                    e["to"] == 0 and e["from"] == 1 for e in adapt_events()
                ),
                "the controller's restore to full fidelity",
            )
        # phase 3: the post-restore round budget completes at level 0
        if not failures:
            target = full_rounds() + args.post_rounds
            await_phase(
                lambda: full_rounds() >= target,
                f"{args.post_rounds} full-membership rounds post-restore",
            )
        master.send_signal(_signal.SIGTERM)
        try:
            out, _ = master.communicate(timeout=60)
            master_done = "master done" in out
        except subprocess.TimeoutExpired:
            failures.append("master did not shut down on SIGTERM")
        for k, n in enumerate(nodes):
            try:
                node_out[k], _ = n.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                n.kill()
                node_out[k] = ""
    finally:
        for proc in [master, *nodes]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    events = adapt_events()
    degrades = sum(1 for e in events if e["to"] > e["from"])
    restores = sum(1 for e in events if e["to"] < e["from"])
    max_errs: dict[int, float] = {}
    for k, out in node_out.items():
        m = re.search(r"max_err=([0-9.eE+-]+)", out or "")
        if m:
            max_errs[k] = float(m.group(1))
    # assertions over the collected evidence
    if not events:
        failures.append("controller never made a transition")
    if degrades + restores > args.max_transitions:
        failures.append(
            f"{degrades + restores} mode transitions > bound "
            f"{args.max_transitions} (oscillation)"
        )
    if events and events[-1]["to"] != 0:
        failures.append(
            f"controller ended at level {events[-1]['to']}, not restored"
        )
    if not any(e.get("policy", "").startswith("int8") for e in events):
        failures.append("controller never reached the int8 wire mode")
    if len(max_errs) < args.nodes:
        failures.append(
            f"max_err evidence from only {sorted(max_errs)} of "
            f"{args.nodes} node(s)"
        )
    for k, err in sorted(max_errs.items()):
        if err > args.err_budget:
            failures.append(
                f"node {k} reduced-value error {err:.4f} exceeds the EF "
                f"budget {args.err_budget}"
            )
    if not master_done:
        failures.append("master did not finish cleanly")
    decision_log = None
    if os.path.exists(adapt_log):
        with open(adapt_log) as f:
            decision_log = [json.loads(ln) for ln in f if ln.strip()]

    summary = {
        "seed": args.seed,
        "spec": spec,
        "rounds_completed": full_rounds(),
        "adapt_events": events,
        "decision_log": decision_log,
        "degrades": degrades,
        "restores": restores,
        "max_err": max_errs,
        "err_budget": args.err_budget,
        "master_done": master_done,
        "failures": failures,
    }
    print(json.dumps(summary))
    return 0 if not failures else 1


def cmd_chaos_train_node(argv: list[str]) -> int:
    """Tier-7 node role (RESILIENCE.md "Tier 7 — workload resilience"):
    one real trainer family, ElasticTrainer-wrapped, riding the TCP
    cluster, its ranks virtual ranks on ``--device`` (the card unless
    ``cpu``). The cluster's membership view drives the wrapper's
    snapshot -> rebuild -> restore re-mesh between steps, and the
    leader's RoundPolicy wire stamp drives the trainer's gradient compress
    mode through the same factory rebuild path; the ``chaos-train`` drill
    spawns one of these per cluster node. Its summary line ends with the
    device (and, on the card, its name and power limit)."""
    p = argparse.ArgumentParser(
        "chaos-train-node",
        description="training node driving an ElasticTrainer-wrapped real "
        "trainer; membership re-meshes and RoundPolicy compress changes "
        "follow the cluster",
    )
    p.add_argument("--seed", required=True, help="master host:port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument(
        "--node-id", type=int, required=True,
        help="this node's id AND its rank-group index (the drill "
        "assigns 0..nodes-1 so every process re-meshes identically)",
    )
    p.add_argument(
        "--nodes", type=int, required=True,
        help="planned cluster size: the local virtual-rank mesh is "
        "partitioned into this many node rank groups",
    )
    p.add_argument(
        "--family", choices=("dp", "zero1", "fsdp", "pipeline"),
        default="dp",
        help="which real trainer family rides the elastic cycle "
        "(train/zoo.py)",
    )
    p.add_argument("--model-seed", type=int, default=0)
    p.add_argument("--elastic-rate", type=float, default=0.5)
    p.add_argument(
        "--min-nodes", type=int, default=1,
        help="below this many live nodes the learner PAUSES (holds "
        "position) instead of stepping — recovery resumes it",
    )
    p.add_argument(
        "--max-steps", type=int, default=0,
        help="0 = train until the master broadcasts Shutdown",
    )
    p.add_argument(
        "--warmup-steps", type=int, default=8,
        help="local steps taken BEFORE joining the cluster (compile + a "
        "real loss trajectory first; rounds only start once every node "
        "joined, so a round-triggered kill lands mid-training)",
    )
    p.add_argument("--metrics-out", default=None, help="per-step JSONL path")
    p.add_argument("--chaos-log", default=None, metavar="FILE")
    p.add_argument(
        "--device", default=None,
        help="'cpu' keeps the trainer on the host; default: the CUDA card",
    )
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import asyncio

    from akka_allreduce_tpu_torch.cluster_cli import _card_note, node_device
    from akka_allreduce_tpu_torch.control.cluster import Endpoint
    from akka_allreduce_tpu_torch.ops import local_reduce
    from akka_allreduce_tpu_torch.train import ElasticClusterNode, zoo
    from akka_allreduce_tpu_torch.utils.metrics import MetricsLogger

    device = node_device(p, args.device)
    per = zoo.devices_per_node(args.family)
    # every process labels the same global rank set (node k owns rank
    # group k), so their re-meshes agree; the ranks are virtual ranks on
    # this process's device
    assignment = {
        n: list(range(n * per, (n + 1) * per)) for n in range(args.nodes)
    }
    try:
        elastic = zoo.make_elastic(
            args.family, assignment,
            seed=args.model_seed, min_nodes=args.min_nodes, device=device,
        )
    except NotImplementedError as e:
        p.error(str(e))
    ds = zoo.dataset_for(args.family)
    step_seq = {"i": 0}

    def batches(trainer):
        # this node's OWN data shard: the seed offset folds the node id,
        # the batch geometry follows the LIVE trainer (re-mesh aware)
        step_seq["i"] += 1
        return zoo.batch_for(
            args.family, ds, elastic,
            seed_offset=args.node_id * 100_003 + step_seq["i"],
        )

    logger = MetricsLogger(args.metrics_out) if args.metrics_out else None

    def on_step(m) -> None:
        if logger is None:
            return
        logger.log_event(
            kind="train_step",
            step=m.step,
            loss=round(float(m.loss), 6),
            contributors=float(m.contributors),
            generation=elastic.generation,
            members=list(elastic.member_nodes),
            n_devices=elastic.n_devices,
            compress=elastic.compress_mode or "full",
            # pipeline restage evidence (the drill pins the gcd rule)
            stages=getattr(elastic.trainer, "stages", None),
            device=str(device),
        )

    async def run() -> int:
        cnode = ElasticClusterNode(
            Endpoint.parse(args.seed),
            elastic,
            batches,
            elastic_rate=args.elastic_rate,
            host=args.host,
            port=args.port,
            preferred_node_id=args.node_id,
            on_step=on_step,
            # real OS process: the chaos `crash` fault may os._exit here
            # (the drill's seeded mid-step node kill)
            allow_crash=True,
            chaos_log=args.chaos_log,
        )
        t0 = time.perf_counter()
        steps = await cnode.run(
            args.max_steps or None, warmup_steps=args.warmup_steps
        )
        dt = time.perf_counter() - t0
        losses = cnode.losses
        trend = (
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}"
            if losses
            else "no steps taken"
        )
        print(
            f"trained {steps} steps in {dt:.1f}s "
            f"({cnode.rounds_applied} sync rounds applied) "
            f"remeshes={cnode.remeshes} "
            f"compress_changes={cnode.compress_changes} "
            f"generation={elastic.generation} "
            f"final_compress={elastic.compress_mode or 'full'}; {trend}; "
            f"k1_launches={local_reduce.LAUNCHES['masked_average']}; "
            f"{_card_note(device)}",
            flush=True,
        )
        return 0

    rc = asyncio.run(run())
    if logger is not None:
        logger.close()
    return rc


def cmd_chaos_train(argv: list[str]) -> int:
    """Workload-resilience drill (RESILIENCE.md "Tier 7"): a real master +
    N ``chaos-train-node`` processes — each driving an
    ElasticTrainer-wrapped REAL trainer of one family — run an
    open-ended round budget; a SEEDED ``crash:node=K,at=roundN`` kills
    one node mid-train-step. The drill asserts, from the processes' own
    evidence: the crash was the injected one (exit 23); every survivor
    re-meshed (snapshot -> rebuild over the survivors' devices ->
    restore) and its loss trajectory RESUMED within the pinned band (the
    restore lost no optimizer state); rounds kept completing at the
    reduced membership (zero wedged rounds); and the run finished
    gracefully. The default family, ``pipeline``, and ``fsdp`` are refused
    (exit 2) until their trainers are ported (ROADMAP.md Queue 1, item 11):
    run ``--family dp`` or ``--family zero1``."""
    p = argparse.ArgumentParser(
        "chaos-train",
        description="seeded mid-step node kill under a real trainer "
        "family; assert loss-curve continuity across the re-mesh, zero "
        "wedged rounds, graceful completion",
    )
    p.add_argument("--seed", type=int, default=1234, help="chaos seed")
    p.add_argument(
        "--family", choices=("dp", "zero1", "fsdp", "pipeline"),
        default="pipeline",
        help="the trainer family (train/zoo.py); the default, pipeline, "
        "and fsdp are not ported yet and are refused (ROADMAP.md Queue 1, "
        "item 11)",
    )
    p.add_argument(
        "--nodes", type=int, default=0,
        help="cluster size (0 = family default: 4 for pipeline — enough "
        "devices that a node loss RESTAGES the trunk — else 3)",
    )
    p.add_argument(
        "--kill-at-round", type=int, default=30,
        help="allreduce round at which the victim's seeded crash fires",
    )
    p.add_argument(
        "--post-rounds", type=int, default=25,
        help="survivor-membership rounds that must complete AFTER the "
        "kill (the zero-wedged-rounds evidence)",
    )
    p.add_argument(
        "--post-steps", type=int, default=6,
        help="post-re-mesh train steps each survivor must log (the "
        "loss-continuity sample)",
    )
    p.add_argument(
        "--warmup-steps", type=int, default=8,
        help="per-node local steps BEFORE joining (rounds, and so the "
        "round-triggered kill, start only once every node joined — the "
        "victim dies mid-training, not mid-compile)",
    )
    p.add_argument(
        "--loss-band", type=float, default=0.35,
        help="pinned continuity band: each survivor's median loss over "
        "its first steps at the survivor membership must stay within "
        "(1 + band) x its median over its last steps with the victim "
        "still a member (+0.05 absolute slack for "
        "near-converged curves) — a restore that lost optimizer state "
        "resets the curve and blows this bar",
    )
    p.add_argument("--phase-timeout", type=float, default=300.0)
    p.add_argument("--th", type=float, default=0.66)
    p.add_argument("--heartbeat", type=float, default=0.25)
    p.add_argument("--chunk", type=int, default=16384)
    p.add_argument(
        "--streams", type=int, default=1,
        help="data-plane sockets per endpoint (distributed via Welcome)",
    )
    p.add_argument(
        "--adapt", action="store_true",
        help="also run the leader's AdaptiveController (the trainer's "
        "compress-follows-policy plumbing is live either way; the "
        "policy is exercised by the zoo's tests)",
    )
    p.add_argument("--out-dir", default="chaos_train_run")
    _add_drill_gossip_flags(p)
    _add_drill_lever_flags(p)
    _add_drill_device_flag(p)
    args = p.parse_args(argv)

    import json
    import os
    import re
    import signal as _signal
    import statistics
    import subprocess

    from akka_allreduce_tpu_torch.control.chaos import parse_spec

    nodes = args.nodes or (4 if args.family == "pipeline" else 3)
    victim = nodes - 1
    spec = f"crash:node={victim},at=round{args.kill_at_round}"
    try:
        parse_spec(spec)
    except ValueError as e:
        p.error(str(e))
    os.makedirs(args.out_dir, exist_ok=True)
    metrics_path = os.path.join(args.out_dir, "rounds.jsonl")
    node_jsonl = {
        k: os.path.join(args.out_dir, f"train-node{k}.jsonl")
        for k in range(nodes)
    }
    for f in (metrics_path, *node_jsonl.values()):
        if os.path.exists(f):
            os.remove(f)  # MetricsLogger appends; one run per file

    # size the cluster's data plane to the family model (the elastic-
    # averaging payload IS the flat params): built over one virtual rank
    # on the CPU, so this process opens no CUDA context
    from akka_allreduce_tpu_torch.train import zoo

    try:
        size = zoo.family_param_count(args.family)
    except NotImplementedError as e:
        p.error(str(e))
    device = _drill_device(p, args)
    print(f"{args.family}: {size} params -> data_size {size}", flush=True)
    spawn = _drill_spawn(dict(os.environ), device)

    failures: list[str] = []
    await_phase = _drill_phase_waiter(args.phase_timeout, failures)

    def node_steps(k: int) -> list[dict]:
        return [
            r
            for r in _drill_jsonl_records(node_jsonl[k])
            if r.get("kind") == "train_step"
        ]

    def survivor_rounds() -> int:
        return _drill_full_rounds(metrics_path, nodes - 1)

    master = spawn(
        "cluster-master", "--port", "0", "--nodes", str(nodes),
        "--rounds", "-1", "--size", str(size),
        "--chunk", str(args.chunk), "--th", str(args.th),
        "--heartbeat", str(args.heartbeat),
        "--streams", str(args.streams),
        "--chaos-seed", str(args.seed), "--chaos-spec", spec,
        "--chaos-log", os.path.join(args.out_dir, "chaos-master.jsonl"),
        "--metrics-out", metrics_path,
        *(["--adapt"] if args.adapt else []),
        *_drill_gossip_args(args),
        *_drill_lever_args(args),
    )
    procs: list = []
    node_out: dict[int, str] = {}
    master_done = False
    victim_rc: int | None = None
    t_exit_seen = None
    master_cuda = None
    try:
        seed_ep = None
        for line in master.stdout:
            if line.startswith("master listening on "):
                seed_ep = line.split()[-1]
                break
        if seed_ep is None:
            raise RuntimeError("master never reported its endpoint")
        procs = [
            spawn(
                "chaos-train-node", "--seed", seed_ep,
                "--node-id", str(k), "--nodes", str(nodes),
                "--family", args.family,
                "--warmup-steps", str(args.warmup_steps),
                "--metrics-out", node_jsonl[k],
                "--chaos-log",
                os.path.join(args.out_dir, f"chaos-node{k}.jsonl"),
            )
            for k in range(nodes)
        ]
        # phase 1: every node trained its warm-up trajectory (these steps
        # run BEFORE the join, so the round-triggered kill cannot fire
        # until every node is genuinely training)
        warm = max(1, args.warmup_steps)
        await_phase(
            lambda: all(len(node_steps(k)) >= warm for k in range(nodes)),
            "every node's warm-up trajectory",
        )
        # phase 2: the seeded crash takes the victim down (exit 23)
        if not failures:
            await_phase(
                lambda: procs[victim].poll() is not None,
                f"the seeded crash of node {victim}",
            )
            victim_rc = procs[victim].poll()
            t_exit_seen = time.time()
        # phase 3: every survivor re-meshed to the surviving membership
        survivors = [k for k in range(nodes) if k != victim]
        want = sorted(survivors)

        def remeshed(k: int) -> bool:
            return any(
                r["generation"] >= 1 and r.get("members") == want
                for r in node_steps(k)
            )

        if not failures:
            await_phase(
                lambda: all(remeshed(k) for k in survivors),
                "every survivor's re-mesh to the surviving membership",
            )
        # phase 4: loss continuity sample + zero wedged rounds — the
        # reduced membership keeps completing rounds AND steps
        if not failures:

            def post_steps(k: int) -> int:
                return len(_kill_split(node_steps(k), victim, want)[1])

            target = survivor_rounds() + args.post_rounds
            await_phase(
                lambda: survivor_rounds() >= target
                and all(
                    post_steps(k) >= args.post_steps for k in survivors
                ),
                f"{args.post_rounds} survivor-membership rounds and "
                f"{args.post_steps} post-re-mesh steps per survivor",
            )
        master.send_signal(_signal.SIGTERM)
        try:
            out, _ = master.communicate(timeout=60)
            master_done = "master done" in out
            master_cuda = "master cuda_initialized=False" not in out
        except subprocess.TimeoutExpired:
            failures.append("master did not shut down on SIGTERM")
        for k, n in enumerate(procs):
            try:
                node_out[k], _ = n.communicate(timeout=90)
            except subprocess.TimeoutExpired:
                n.kill()
                node_out[k] = ""
    finally:
        for proc in [master, *procs]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # -- assertions over the collected evidence ------------------------------
    if victim_rc is None:
        victim_rc = procs[victim].poll() if procs else None
    if victim_rc != 23:
        failures.append(
            f"victim exited {victim_rc}, not the chaos crash exit 23"
        )
    survivors = [k for k in range(nodes) if k != victim]
    continuity: dict[int, dict] = {}
    for k in survivors:
        steps = node_steps(k)
        pre, post = (
            [r["loss"] for r in part]
            for part in _kill_split(steps, victim, sorted(survivors))
        )
        if not pre or len(post) < args.post_steps:
            failures.append(
                f"node {k}: not enough steps for the continuity check "
                f"(pre={len(pre)}, post={len(post)})"
            )
            continue
        pre_med = statistics.median(pre[-args.post_steps:])
        post_med = statistics.median(post[: args.post_steps])
        bar = pre_med * (1.0 + args.loss_band) + 0.05
        continuity[k] = {
            "pre_median": round(pre_med, 4),
            "post_median": round(post_med, 4),
            "bar": round(bar, 4),
        }
        if not (post_med <= bar):
            failures.append(
                f"node {k}: post-re-mesh median loss {post_med:.4f} "
                f"exceeds the continuity bar {bar:.4f} "
                f"(pre-kill median {pre_med:.4f}, band {args.loss_band})"
            )
        if any(not np_isfinite(loss) for loss in pre + post):
            failures.append(f"node {k}: non-finite loss in the trajectory")
        if args.family == "pipeline":
            # the restage rule, end to end: at the surviving membership
            # the trunk must run at S' = gcd(live devices, n_layers)
            # stages (train/zoo.py pins n_layers=4; a DP-only fallback
            # would show stages == 1 here and is equally legal only when
            # the gcd says so)
            import math as _math

            n_live = len(survivors) * 2  # zoo: 2 devices per node
            want_pp = _math.gcd(n_live, 4)
            at_survivors = [
                r for r in steps if r.get("members") == sorted(survivors)
            ]
            bad = [
                r["stages"] for r in at_survivors if r["stages"] != want_pp
            ]
            if not at_survivors:
                failures.append(
                    f"node {k}: no steps at the surviving membership"
                )
            elif bad:
                failures.append(
                    f"node {k}: restaged to {bad[0]} stages, expected "
                    f"{want_pp} (gcd of {n_live} devices and 4 layers)"
                )
    summaries: dict[int, dict] = {}
    for k in survivors:
        out = node_out.get(k, "")
        m = re.search(
            r"trained (\d+) steps .*remeshes=(\d+) compress_changes=(\d+) "
            r"generation=(\d+) final_compress=(\S+);.*; k1_launches=(\d+); "
            r"(device=.*)$",
            out or "", re.M,
        )
        if not m:
            failures.append(f"node {k} never reported its summary line")
            continue
        summaries[k] = {
            "steps": int(m.group(1)),
            "remeshes": int(m.group(2)),
            "compress_changes": int(m.group(3)),
            "generation": int(m.group(4)),
            "final_compress": m.group(5),
            "k1_launches": int(m.group(6)),
            "device": m.group(7),
        }
        on_card = m.group(7).startswith("device=cuda")
        if args.device != "cpu" and not on_card:
            failures.append(f"node {k} ran on {m.group(7)}, not the card")
        # every f32 step of dp or zero1 on the card averages through K1 once
        if (on_card and args.family in ("dp", "zero1") and int(m.group(3)) == 0
                and m.group(5) == "full" and int(m.group(6)) != int(m.group(1))):
            failures.append(
                f"node {k}: {m.group(6)} K1 launches for {m.group(1)} f32 steps")
        if int(m.group(2)) < 1:
            failures.append(f"node {k} reported zero re-meshes")
    if not master_done:
        failures.append("master did not finish cleanly")
    # the crash to each survivor's first post-re-mesh step, on the wall
    # clock of the one host: from the victim's last logged step (the crash
    # comes after it) and from the drill's observation of its exit
    victim_steps = node_steps(victim)
    t_last = victim_steps[-1]["t"] if victim_steps else None
    recovery: dict[int, dict] = {}
    for k in survivors:
        post = _kill_split(node_steps(k), victim, sorted(survivors))[1]
        first = post[0] if post else None
        if first is not None and t_last is not None:
            recovery[k] = {
                "from_victim_last_step_s": round(first["t"] - t_last, 4),
                "from_exit_seen_s": (
                    None if t_exit_seen is None
                    else round(first["t"] - t_exit_seen, 4)
                ),
            }
    import torch

    # the drill's process schedules processes: it must never start CUDA
    parent_cuda = torch.cuda.is_initialized()
    if parent_cuda:
        failures.append("the drill's own process started CUDA")
    if master_cuda:
        failures.append("the master started CUDA")

    summary = {
        "seed": args.seed,
        "family": args.family,
        "spec": spec,
        "nodes": nodes,
        "victim": victim,
        "victim_exit": victim_rc,
        "survivor_rounds": survivor_rounds(),
        "continuity": continuity,
        "loss_band": args.loss_band,
        "node_summaries": summaries,
        "crash_to_first_post_remesh_step": recovery,
        "parent_cuda_initialized": parent_cuda,
        "master_cuda_initialized": master_cuda,
        "master_done": master_done,
        "failures": failures,
    }
    print(json.dumps(summary))
    return 0 if not failures else 1


def _kill_split(steps: list[dict], victim: int, survivors: list[int]):
    """A survivor's step records split at the kill's re-mesh: the steps on
    which the victim was a member, and the steps at the survivor
    membership after the last of those. (A node that joins early re-meshes
    on partial views before the kill; those steps belong to neither side,
    where the JAX drill's split by ``generation`` counts them as
    post-kill.)"""
    last = max(
        (i for i, r in enumerate(steps) if victim in r.get("members", ())),
        default=-1,
    )
    post = [r for r in steps[last + 1:] if r.get("members") == survivors]
    pre = [r for r in steps[:last + 1] if victim in r.get("members", ())]
    return pre, post


def np_isfinite(x) -> bool:
    """math.isfinite over drill-JSON floats (no numpy import needed in
    the drill parent's assertion path)."""
    import math

    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return False

