"""The port's chaos tools (``control/chaos.py``, ``control/simfabric.py``, the
``LocalRouter`` hook, the node's arming from ``Welcome`` and the drills of
``chaos_cli.py``) against the JAX package's, on the CPU.

- ``parse_spec`` compiles and refuses the same specs (the grammar cases of
  ``tests/test_chaos.py`` and more), with the same fields and messages.
- Injectors of both packages, fed one seeded envelope stream that reaches
  every fault kind (drop, delay, the targeted windowed delay, duplicate,
  reorder, corrupt, both partition forms, stall, a suppressed crash) as the
  master and as nodes, plan the same action for every envelope and emit
  byte-identical ``event_log_jsonl``, equal ``counts`` and suppressed
  crashes; ``corrupt_frame_parts`` flips the same bit of the same frame.
- ``membership_schedule`` and ``leader_kill_step`` are equal over seeds.
- The seeded ``LocalAllreduceSystem`` under a spec that drops, duplicates,
  reorders and corrupts gives byte-identical logs and bit-equal flushes.
- ``Fabric`` at 16 nodes with one kill gives the same ``judgement()``.
- A JAX master with a chaos spec arms the port's nodes through ``Welcome``.
- ``chaos --device cpu`` runs once as a subprocess; every other drill
  parses (``--help``) here and runs in full on the CPU under ``slow``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import akka_allreduce_tpu.config as jconfig
import akka_allreduce_tpu.control.chaos as jchaos
import akka_allreduce_tpu.control.cluster as jcl
import akka_allreduce_tpu.control.wire as jwire
import akka_allreduce_tpu.protocol as jproto
from akka_allreduce_tpu.control.bootstrap import MasterProcess as JMaster
from akka_allreduce_tpu.control.envelope import Envelope as JEnvelope
from akka_allreduce_tpu.control.local import LocalAllreduceSystem as JSystem
from akka_allreduce_tpu.control.simfabric import Fabric as JFabric
import akka_allreduce_tpu_torch.config as tconfig
import akka_allreduce_tpu_torch.control.chaos as tchaos
import akka_allreduce_tpu_torch.control.cluster as tcl
import akka_allreduce_tpu_torch.control.wire as twire
import akka_allreduce_tpu_torch.protocol as tproto
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.cluster_cli import read_until
from akka_allreduce_tpu_torch.control.bootstrap import NodeProcess
from akka_allreduce_tpu_torch.control.envelope import Envelope as TEnvelope
from akka_allreduce_tpu_torch.control.local import local_engine
from akka_allreduce_tpu_torch.control.simfabric import Fabric, sim_rate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = jchaos.MASTER_ROLE

# -- the spec grammar ----------------------------------------------------------

GOOD_SPECS = [
    "drop:p=0.05;delay:ms=20,p=0.5,jitter_ms=5;duplicate:p=0.01;reorder:p=0.02;"
    "corrupt:p=0.01;partition:groups=m+0|1+2,at=round10,heal=5s;"
    "stall:node=1,at=3s,for=2s;crash:node=2,at=round8",
    "crash:node=m,at=round8",
    "partition:from=1+2,to=m,at=8s,heal=8s",
    "delay:node=2,ms=400,at=round30,for=round150;stall:node=2,at=round50,for=0.25s",
    " drop:p=0 ; ;corrupt:p=1 ",
    "",
]
BAD_SPECS = [
    "explode:p=1", "drop:p=1.5", "drop:p", "delay:p=0.5", "partition:at=round3",
    "partition:groups=m", "stall:node=1,at=1s", "crash:at=1s", "partition:groups=m+x|1",
    "drop:q=1", "crash:node=1,at=soon", "crash:node=1,at=round0",
    "partition:groups=m|1,from=1,to=m", "partition:from=1", "delay:ms=0",
    "partition:from=,to=m",
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_spec_compiles_like_jax(spec):
    ours, theirs = tchaos.parse_spec(spec), jchaos.parse_spec(spec)
    assert [dataclasses.asdict(f) for f in ours] == [dataclasses.asdict(f) for f in theirs]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_refuses_like_jax(spec):
    with pytest.raises(ValueError) as ours:
        tchaos.parse_spec(spec)
    with pytest.raises(ValueError) as theirs:
        jchaos.parse_spec(spec)
    assert str(ours.value) == str(theirs.value)


def test_constants_match_jax():
    assert (tchaos.MASTER_ROLE, tchaos.CRASH_EXIT_CODE) == (jchaos.MASTER_ROLE, 23)
    assert tchaos._FAULTS == jchaos._FAULTS
    for args in ((0, -1, 0, "drop"), (1234, 2, 7, "partition"), (99, -1, 1, "leader_kill")):
        assert tchaos._derive_seed(*args) == jchaos._derive_seed(*args)


# -- the injector --------------------------------------------------------------

SPEC = (
    "drop:p=0.08;delay:ms=5,p=0.3,jitter_ms=2;duplicate:p=0.05;reorder:p=0.05;"
    "corrupt:p=0.2;partition:groups=m|0+1+2,at=round20,heal=round30;"
    "partition:from=1,to=m,at=10s,heal=5s;stall:node=0,at=3s,for=2s;"
    "delay:node=2,ms=50,at=round5,for=round15;crash:node=1,at=round8;"
    "crash:node=m,at=round12"
)


def _traffic(pkg, n=480):
    """A seeded envelope stream in one package's types: round traffic to
    workers, payloads both ways, heartbeats, gossip and shutdowns."""
    proto, cl, env = pkg
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        r = i // 8
        kind = i % 6
        if kind == 0:
            out.append(env("worker:1", proto.StartAllreduce(r)))
        elif kind == 1:
            v = rng.standard_normal(16).astype(np.float32)
            out.append(env(f"worker:{i % 3}", proto.ScatterBlock(v, 0, 2, 0, r)))
        elif kind == 2:
            v = rng.standard_normal(16).astype(np.float32)
            out.append(env("worker:0", proto.ReduceBlock(v, 2, 0, 0, r, count=2)))
        elif kind == 3:
            out.append(env("master", cl.Heartbeat(i % 3, 1)))
        elif kind == 4:
            out.append(env(f"node:{i % 3}", proto.CompleteAllreduce(i % 3, r)))
        else:
            out.append(env("line_master:0", proto.CompleteAllreduce(1, r)))
    return out


JAX = (jproto, jcl, JEnvelope)
PORT = (tproto, tcl, TEnvelope)


def _run_injector(mod, pkg, seed, role):
    now = {"t": 0.0}
    inj = mod.ChaosInjector(seed, SPEC, role=role, clock=lambda: now["t"], t0=0.0)
    actions = []
    for env in _traffic(pkg):
        now["t"] += 0.05
        act = inj.plan_send(env)
        actions.append(None if act is None else dataclasses.asdict(act))
    return inj, actions


@pytest.mark.parametrize("seed", [1234, 7])
@pytest.mark.parametrize("role", [M, 0, 1, 2])
def test_injector_matches_jax_byte_for_byte(seed, role):
    ours, our_actions = _run_injector(tchaos, PORT, seed, role)
    theirs, their_actions = _run_injector(jchaos, JAX, seed, role)
    assert our_actions == their_actions
    assert ours.event_log_jsonl().encode() == theirs.event_log_jsonl().encode()
    assert ours.counts() == theirs.counts()
    assert ours.crashes_suppressed == theirs.crashes_suppressed
    assert ours.round == theirs.round


def test_injector_stream_reaches_every_fault_kind():
    fired = {}
    for role in (M, 0, 1, 2):
        inj, _ = _run_injector(tchaos, PORT, 1234, role)
        for k, v in inj.counts().items():
            fired[k] = fired.get(k, 0) + v
    assert set(fired) == set(tchaos._FAULTS), fired
    inj, _ = _run_injector(tchaos, PORT, 1234, 1)
    crash = [e for e in inj.events if e["fault"] == "crash"]
    assert len(crash) == 1 and crash[0]["suppressed"] is True
    assert any(e.get("oneway") for e in inj.events)


def test_event_log_file_matches_jax(tmp_path):
    ours, _ = _run_injector(tchaos, PORT, 3, 0)
    theirs, _ = _run_injector(jchaos, JAX, 3, 0)
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    assert ours.write_log(str(a)) == str(a) and theirs.write_log(str(b)) == str(b)
    assert a.read_bytes() == b.read_bytes() and a.read_bytes().endswith(b"\n")
    assert tchaos.ChaosInjector(1, "", role=0).write_log() is None


@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
def test_corrupt_frame_parts_flips_the_same_bit(mode):
    v = np.random.default_rng(5).standard_normal(257).astype(np.float32)
    act = tchaos.ChaosAction(corrupt=True, corrupt_at=0.37, corrupt_bit=5)
    jact = jchaos.ChaosAction(corrupt=True, corrupt_at=0.37, corrupt_bit=5)
    for make in (lambda p: p.ScatterBlock(v, 0, 2, 1, 9),
                 lambda p: p.ReduceBlock(v, 2, 0, 1, 9, count=3)):
        ours = twire.encode_frame_parts("worker:0", make(tproto), wire=mode)
        theirs = jwire.encode_frame_parts("worker:0", make(jproto), wire=mode)
        clean = b"".join(bytes(p) for p in ours)
        assert clean == b"".join(bytes(p) for p in theirs)
        a = b"".join(bytes(p) for p in tchaos.ChaosInjector(0, "", role=0)
                     .corrupt_frame_parts(ours, act))
        b = b"".join(bytes(p) for p in jchaos.ChaosInjector(0, "", role=0)
                     .corrupt_frame_parts(theirs, jact))
        assert a == b and a != clean
        assert sum(bin(x ^ y).count("1") for x, y in zip(a, clean)) == 1
        # the engine's payload is never touched, and the checksum rejects it
        assert b"".join(bytes(p) for p in ours) == clean
        with pytest.raises(Exception):
            twire.decode_frame_body(a[4:])


@pytest.mark.parametrize("seed", range(0, 40, 3))
def test_membership_schedule_and_leader_kill_match_jax(seed):
    for nodes, steps in ((4, 24), (4, 200), (8, 60)):
        assert tchaos.membership_schedule(seed, nodes, steps) == jchaos.membership_schedule(
            seed, nodes, steps)
        kw = dict(flap_p=0.2, flap_len=(1, 3))
        assert tchaos.membership_schedule(seed, nodes, steps, **kw) == (
            jchaos.membership_schedule(seed, nodes, steps, **kw))
        assert tchaos.leader_kill_step(seed, steps) == jchaos.leader_kill_step(seed, steps)
    assert tchaos.leader_kill_step(seed, 19) is None


# -- the in-process router -----------------------------------------------------

LOCAL_SPEC = "drop:p=0.02;duplicate:p=0.05;reorder:p=0.05;corrupt:p=0.05"


def _jax_local(size, nodes, chunk, rounds, th, dims, seed, spec):
    cfg = jconfig.AllreduceConfig(
        threshold=jconfig.ThresholdConfig(th, th, th),
        metadata=jconfig.MetaDataConfig(data_size=size, max_chunk_size=chunk),
        line_master=jconfig.LineMasterConfig(round_window=2, max_rounds=rounds),
        master=jconfig.MasterConfig(node_num=nodes, dimensions=dims),
        worker=jconfig.WorkerConfig(zero_copy_scatter=True),
        chaos=jconfig.ChaosConfig(seed=seed, spec=spec),
    )
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal(size).astype(np.float32) for _ in range(nodes)]
    outs = [[] for _ in range(nodes)]
    system = JSystem(nodes, [lambda req, i=i: jproto.AllReduceInput(inputs[i])
                             for i in range(nodes)],
                     [outs[i].append for i in range(nodes)], cfg)
    system.start()
    system.run_until_quiescent()
    return system, outs


@pytest.mark.parametrize("dims,seed", [(1, 0), (1, 3), (2, 3)])
def test_local_system_under_chaos_matches_jax(dims, seed):
    run = local_engine(1000, nodes=4, chunk=64, rounds=8, th=0.75, dims=dims, device="cpu",
                       keep_outputs=True,
                       chaos=tconfig.ChaosConfig(seed=seed, spec=LOCAL_SPEC)).run()
    jsys, jouts = _jax_local(1000, 4, 64, 8, 0.75, dims, seed, LOCAL_SPEC)
    router = run.system.router
    assert router.chaos.event_log_jsonl().encode() == jsys.router.chaos.event_log_jsonl().encode()
    assert set(router.chaos.counts()) == {"drop", "duplicate", "reorder", "corrupt"}
    assert (router.delivered, router.dropped) == (jsys.router.delivered, jsys.router.dropped)
    assert run.rounds >= 7
    for ours, theirs in zip(run.outputs, jouts):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.iteration == b.iteration
            np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))
            np.testing.assert_array_equal(a.count.numpy(), np.asarray(b.count))


def test_local_router_rejects_every_corrupted_frame_like_jax():
    from akka_allreduce_tpu_torch.control.local import LocalRouter

    router = LocalRouter()
    got: list = []
    router.register("worker:1", lambda m: got.append(m) or [])
    router.chaos = tchaos.ChaosInjector(21, "corrupt:p=1", role=M)
    payload = np.arange(32, dtype=np.float32)
    router.send_all([TEnvelope("worker:1", tproto.ScatterBlock(payload, 0, 1, 0, r),
                               wire=w) for r, w in enumerate(["f32", "f16", "int8", None])])
    router.run()
    assert got == [] and router.dropped == 4 and router.chaos.counts() == {"corrupt": 4}


# -- the pod-scale simulator ---------------------------------------------------


def test_fabric_judgement_matches_jax_at_16_nodes():
    spec = "partition:from=3,to=m,at=2s,heal=3s;drop:p=0.02"
    ours, theirs = Fabric(16, chaos_spec=spec), JFabric(16, chaos_spec=spec)
    for fab in (ours, theirs):
        fab.run(6.0)
        fab.kill(7)
        assert fab.run_until(lambda f: f.dead_count_at_master() >= 1, 30.0) is not None
    assert ours.judgement() == theirs.judgement()
    assert ours.ticks == theirs.ticks and ours.dead_count_at_master() == 1
    assert ours.injectors[3].event_log_jsonl() == theirs.injectors[3].event_log_jsonl()
    rate = sim_rate(16, 1.0)
    assert rate["nodes"] == 16 and rate["node_ticks"] == 170 and rate["node_ticks_per_s"] > 0


# -- the TCP nodes arm the master's spec ---------------------------------------


def test_port_nodes_arm_a_jax_masters_spec_from_welcome():
    # duplicates only: a held or lost AddressBook leaves a route unknown, and
    # at threshold 1.0 a round then never completes (in either package)
    spec = "duplicate:p=0.2"

    async def run():
        cfg = jconfig.AllreduceConfig(
            threshold=jconfig.ThresholdConfig(1.0, 1.0, 1.0),
            metadata=jconfig.MetaDataConfig(data_size=1000, max_chunk_size=128),
            line_master=jconfig.LineMasterConfig(round_window=2, max_rounds=4),
            master=jconfig.MasterConfig(node_num=3, heartbeat_interval_s=0.2),
            chaos=jconfig.ChaosConfig(seed=77, spec=spec),
        )
        master = JMaster(cfg, port=0)
        seed = await master.start()
        inputs = [np.random.default_rng(i).standard_normal(1000).astype(np.float32)
                  for i in range(3)]
        outs: dict[int, list] = {i: [] for i in range(3)}
        nodes = []
        try:
            for i in range(3):
                node = NodeProcess(seed, lambda req, i=i: tproto.AllReduceInput(inputs[i]),
                                   outs[i].append, port=0, preferred_node_id=i, device="cpu")
                await node.start()
                await node.wait_welcomed()
                nodes.append(node)
            await master.run_until_done(timeout=20.0)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 20.0
            while min(len(o) for o in outs.values()) < 4:
                assert loop.time() < deadline, "rounds did not complete"
                await asyncio.sleep(0.02)
        finally:
            for node in nodes:
                await node.stop()
            await master.stop()
        for i, node in enumerate(nodes):
            inj = node.transport.chaos
            assert isinstance(inj, tchaos.ChaosInjector)
            assert (inj.seed, inj.spec, inj.role, inj.allow_crash) == (77, spec, i, False)
        assert sum(len(n.transport.chaos.events) for n in nodes) > 0
        assert master.transport.chaos is not None and master.transport.chaos.role == M
        want = np.mean(inputs, axis=0)
        for i in range(3):
            np.testing.assert_allclose(outs[i][-1].average().numpy(), want, atol=1e-6)

    asyncio.run(asyncio.wait_for(run(), 30.0))


# -- the drills ----------------------------------------------------------------

DRILLS = ["chaos", "chaos-recover", "chaos-gossip", "chaos-scale", "chaos-failover",
          "chaos-adapt", "chaos-train", "chaos-train-node"]


@pytest.mark.parametrize("drill", DRILLS)
def test_drill_parses_its_help(drill, capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli_main([drill, "--help"])
    assert exit_info.value.code == 0
    text = capsys.readouterr().out
    assert "--device" in text and f"usage: {drill}" in text


def test_chaos_train_default_family_is_refused(capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli_main(["chaos-train", "--device", "cpu"])
    assert exit_info.value.code == 2
    assert "item 11" in capsys.readouterr().err


def test_drill_refuses_a_bad_spec_before_spawning(capsys, tmp_path):
    with pytest.raises(SystemExit) as exit_info:
        cli_main(["chaos", "--device", "cpu", "--spec", "explode:p=1",
                  "--out-dir", str(tmp_path)])
    assert exit_info.value.code == 2
    assert "unknown chaos fault" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def _drill(*argv, timeout):
    proc = subprocess.run(
        [sys.executable, "-m", "akka_allreduce_tpu_torch", *argv, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    return proc, summary


def test_chaos_drill_runs_on_the_cpu(tmp_path):
    proc, s = _drill("chaos", "--rounds", "6", "--out-dir", str(tmp_path), timeout=90)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert s["rounds_completed"] == 6 and s["master_done"] is True and not s["wedged"]
    assert sum(s["chaos_events"].values()) > 0 and "chaos-master.jsonl" in s["chaos_logs"]
    master_log = (tmp_path / "chaos-master.jsonl").read_text().splitlines()
    assert master_log and all(json.loads(ln)["role"] == M for ln in master_log)


@pytest.mark.slow
@pytest.mark.parametrize("argv", [
    ["chaos-recover"],
    ["chaos-failover", "--gossip", "--streams", "2"],
    ["chaos-adapt", "--streams", "2"],
    ["chaos-gossip", "--streams", "2"],
    ["chaos-scale", "--streams", "2"],
    ["chaos-train", "--family", "dp"],
    ["chaos-train", "--family", "zero1"],
], ids=lambda a: "_".join(a))
def test_drill_runs_in_full_on_the_cpu(argv, tmp_path):
    proc, s = _drill(*argv, "--out-dir", str(tmp_path), timeout=900)
    assert proc.returncode == 0, (s.get("failures"), proc.stderr[-2000:])
    assert s["failures"] == []
    if argv[0] == "chaos-train":
        assert s["victim_exit"] == tchaos.CRASH_EXIT_CODE
        assert all(v["remeshes"] >= 1 and v["device"] == "device=cpu"
                   for v in s["node_summaries"].values())
        assert s["parent_cuda_initialized"] is False


def test_cluster_master_arms_chaos_and_writes_its_log(tmp_path):
    """``cluster-master`` with a spec and a log path and two ``cluster-node
    --device cpu`` processes with theirs: every process writes its event
    log, each record's role its own."""
    logs = {r: tmp_path / f"chaos-{r}.jsonl" for r in ("m", 0, 1)}
    master = subprocess.Popen(
        [sys.executable, "-m", "akka_allreduce_tpu_torch", "cluster-master", "--port", "0",
         "--nodes", "2", "--rounds", "4", "--size", "4096", "--chunk", "1024",
         "--heartbeat", "0.2", "--chaos-seed", "5", "--chaos-spec",
         "delay:ms=2,p=0.5;duplicate:p=0.2", "--chaos-log", str(logs["m"])],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
    )
    nodes = []
    try:
        seed = read_until(master, "master listening on ")[-1].split()[-1]
        nodes = [subprocess.Popen(
            [sys.executable, "-m", "akka_allreduce_tpu_torch", "cluster-node", "--seed", seed,
             "--node-id", str(k), "--device", "cpu", "--chaos-log", str(logs[k])],
            cwd=ROOT, stdout=subprocess.PIPE, text=True) for k in (0, 1)]
        out = master.communicate(timeout=60)[0]
        for n in nodes:
            n.communicate(timeout=30)
    finally:
        for proc in (master, *nodes):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert master.returncode == 0 and all(n.returncode == 0 for n in nodes)
    assert "chaos event log:" in out
    for role, path in logs.items():
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert recs and {r["role"] for r in recs} == {M if role == "m" else role}
