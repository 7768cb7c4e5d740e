"""The port's TCP control plane against the JAX package's, over loopback on
the CPU: the port's versions of ``tests/test_remote.py``'s cluster tests
(a real master and N node processes in one event loop, every chunk through
the wire codec, the nodes' buffers at ``device="cpu"``), the two mixed
clusters (a JAX master with port nodes, a port master with JAX nodes),
chunk pulls between port nodes and between port and JAX nodes, a standby
takeover, a master arming chaos and the adaptive controller, and the CLI as
real processes.

Every asyncio test runs under its own deadline, so a hang fails the test.
Heartbeats are 0.2 s with a 1 s timeout, except in the tests about failure
detection, which use the JAX harness's 0.05 s and 0.25 s.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import akka_allreduce_tpu.config as j_config
from akka_allreduce_tpu.control.bootstrap import MasterProcess as JMaster
from akka_allreduce_tpu.control.bootstrap import NodeProcess as JNode
from akka_allreduce_tpu.protocol import AllReduceInput as JInput

import akka_allreduce_tpu_torch.config as t_config
from akka_allreduce_tpu_torch.cluster_cli import read_until
from akka_allreduce_tpu_torch.control.bootstrap import MasterProcess, NodeProcess
from akka_allreduce_tpu_torch.protocol import (
    AllReduceInput,
    ReduceBlock,
    ScatterBlock,
)

DEADLINE_S = 30.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(
    n_nodes, *, dims=1, max_rounds=4, size=1000, th=1.0, hb=0.2, timeout=1.0,
    wire="f32", cfg=t_config,
):
    return cfg.AllreduceConfig(
        threshold=cfg.ThresholdConfig(th, th, th),
        metadata=cfg.MetaDataConfig(data_size=size, max_chunk_size=128, wire_dtype=wire),
        line_master=cfg.LineMasterConfig(round_window=2, max_rounds=max_rounds),
        master=cfg.MasterConfig(
            node_num=n_nodes,
            dimensions=dims,
            heartbeat_interval_s=hb,
            heartbeat_timeout_s=timeout,
        ),
    )


def _fast(n_nodes, **kw):
    """The JAX harness's heartbeat timing, for failure-detection tests."""
    return _config(n_nodes, hb=0.05, timeout=0.25, **kw)


async def wait_until(pred, timeout: float = 20.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise TimeoutError("condition not reached")
        await asyncio.sleep(0.02)


def _run(coro) -> None:
    asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


class _Harness:
    """A master and N in-process nodes over real loopback TCP; ``jax_nodes``
    names the nodes that run the JAX package's ``NodeProcess`` (the rest run
    the port's, on the CPU), ``jax_master`` the master's package."""

    def __init__(self, config, n_nodes, *, jax_master=False, jax_nodes=(),
                 state_root=None, replicas=2):
        self.config = config
        self.jax_nodes = set(jax_nodes)
        self.state_root = state_root
        self.replicas = replicas
        self.inputs = [
            np.random.default_rng(i).standard_normal(config.metadata.data_size).astype(np.float32)
            for i in range(n_nodes + 2)  # room for late joiners
        ]
        self.outputs: dict[int, list] = {}
        if jax_master:
            jcfg = j_config.AllreduceConfig.from_json(config.to_json())
            self.master = JMaster(jcfg, port=0)
        else:
            self.master = MasterProcess(config, port=0)
        self.nodes: dict[int, object] = {}
        self.seed = None

    def _source(self, i):
        if i in self.jax_nodes:
            return lambda req: JInput(self.inputs[i])
        return lambda req: AllReduceInput(self.inputs[i])

    def _sink(self, i):
        return lambda out: self.outputs.setdefault(i, []).append(out)

    async def start(self, n_nodes: int) -> None:
        self.seed = await self.master.start()
        for i in range(n_nodes):
            await self.add_node(i)

    async def add_node(self, i: int, port: int = 0):
        kw = {}
        if self.state_root is not None:
            kw = dict(state_dir=str(self.state_root / f"state{i}"), replicas=self.replicas)
        if i in self.jax_nodes:
            node = JNode(self.seed, self._source(i), self._sink(i), port=port,
                         preferred_node_id=i, **kw)
        else:
            node = NodeProcess(self.seed, self._source(i), self._sink(i), port=port,
                               preferred_node_id=i, device="cpu", **kw)
        await node.start()
        await node.wait_welcomed()
        self.nodes[i] = node
        return node

    async def stop(self) -> None:
        for node in self.nodes.values():
            await node.stop()
        await self.master.stop()

    def flushes(self, i: int) -> int:
        return len(self.outputs.get(i, []))

    def average(self, i: int) -> np.ndarray:
        out = self.outputs[i][-1]
        avg = out.average()
        return avg.numpy() if isinstance(avg, torch.Tensor) else np.asarray(avg)

    def count(self, i: int) -> np.ndarray:
        c = self.outputs[i][-1].count
        return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _check_mean(h: _Harness, nodes, contributors, *, rtol=1e-5, atol=1e-6):
    expected = np.mean([h.inputs[k] for k in contributors], axis=0)
    for i in nodes:
        assert h.count(i).min() == len(contributors)
        np.testing.assert_allclose(h.average(i), expected, rtol=rtol, atol=atol)


def test_cluster_rounds_complete_and_average():
    async def run():
        h = _Harness(_config(3, max_rounds=4), 3)
        try:
            await h.start(3)
            await h.master.run_until_done(timeout=20.0)
            await wait_until(lambda: all(h.flushes(i) >= 4 for i in range(3)))
        finally:
            await h.stop()
        _check_mean(h, range(3), range(3))
        out = h.outputs[0][-1]
        assert isinstance(out.data, torch.Tensor) and out.data.device.type == "cpu"

    _run(run())


def test_cluster_butterfly_2d_over_tcp():
    async def run():
        h = _Harness(_config(4, dims=2, max_rounds=3, size=600), 4)
        try:
            await h.start(4)
            await h.master.run_until_done(timeout=20.0)
            await wait_until(lambda: all(h.flushes(i) >= 3 for i in range(4)))
        finally:
            await h.stop()
        _check_mean(h, range(4), range(4))

    _run(run())


def test_cluster_dropout_detection_and_remesh():
    async def run():
        h = _Harness(_fast(3, max_rounds=-1), 3)
        try:
            await h.start(3)
            await wait_until(lambda: min(h.flushes(i) for i in range(3)) >= 2)
            await h.nodes.pop(2).stop()  # crash: no leave, heartbeats stop
            await wait_until(lambda: 2 not in h.master.grid.nodes, timeout=15.0)
            assert sorted(h.master.grid.nodes) == [0, 1]
            f0 = h.flushes(0)
            await wait_until(lambda: h.flushes(0) >= f0 + 3)
        finally:
            await h.stop()
        _check_mean(h, [0], [0, 1])

    _run(run())


def test_cluster_late_joiner_participates():
    async def run():
        h = _Harness(_config(2, max_rounds=-1), 2)
        try:
            await h.start(2)
            await wait_until(lambda: min(h.flushes(i) for i in range(2)) >= 2)
            await h.add_node(2)
            await wait_until(lambda: sorted(h.master.grid.nodes) == [0, 1, 2], 5.0)
            await wait_until(lambda: h.flushes(2) >= 2)
        finally:
            await h.stop()
        _check_mean(h, [2], [0, 1, 2])

    _run(run())


def test_threshold_completion_under_tcp_message_loss():
    """th = 0.75: node 3's payload frames are dropped at its transport, and
    rounds still complete at reduced counts with no membership change."""

    async def run():
        h = _Harness(_config(4, max_rounds=-1, th=0.75), 4)
        try:
            await h.start(4)
            await wait_until(lambda: min(h.flushes(i) for i in range(4)) >= 2)
            h.nodes[3].transport.drop_filter = lambda env: isinstance(
                env.msg, (ScatterBlock, ReduceBlock)
            )
            f0 = h.flushes(0)
            await wait_until(lambda: h.flushes(0) >= f0 + 4)
            assert sorted(h.master.grid.nodes) == [0, 1, 2, 3]
        finally:
            await h.stop()
        count = h.count(0)
        assert count.min() == 0 and count.max() == 3
        full = count == 3
        np.testing.assert_allclose(
            h.average(0)[full], np.mean(h.inputs[:3], axis=0)[full], rtol=1e-5, atol=1e-6
        )

    _run(run())


def test_cluster_rounds_with_f16_wire():
    async def run():
        h = _Harness(_config(3, max_rounds=4, wire="f16"), 3)
        try:
            await h.start(3)
            await h.master.run_until_done(timeout=20.0)
            await wait_until(lambda: all(h.flushes(i) >= 4 for i in range(3)))
            assert all(n.transport.wire_f16 for n in h.nodes.values())
        finally:
            await h.stop()
        assert h.count(0).min() == 3
        exact = np.mean(h.inputs[:3], axis=0)
        err = np.abs(h.average(0) - exact).max() / np.abs(exact).max()
        assert 0 < err < 2e-3, err  # lossy, so f16 really rode the wire
        for n in h.nodes.values():
            st = n.transport.stage_seconds
            assert st["encode"] > 0 and st["handler"] > 0, st
            assert st["decode"] > 0 and st["socket_write"] > 0, st
            assert st["d2h"] == 0.0 and st["h2d"] == 0.0  # nothing on a card

    _run(run())


def test_cluster_round_metrics_jsonl():
    from akka_allreduce_tpu_torch.utils.metrics import MetricsLogger

    async def run():
        h = _Harness(_config(2, max_rounds=5), 2)
        metrics = MetricsLogger()
        h.master = MasterProcess(h.config, port=0, metrics=metrics)
        try:
            await h.start(2)
            await h.master.run_until_done(timeout=20.0)
        finally:
            await h.stop()
        recs = [json.loads(ln) for ln in metrics.dump().splitlines()]
        rounds = [r for r in recs if r.get("kind") == "round"]
        assert len(rounds) >= 5
        assert all(r["completions"] == 2 and r["latency_s"] > 0 for r in rounds)
        assert all(r["data_bytes"] == 4000 for r in rounds)

    _run(run())


def test_restart_same_identity_is_reprepared():
    """A node that crashes and restarts on the same port and id before the
    detector notices is re-prepared and makes progress again."""

    async def run():
        h = _Harness(_fast(2, max_rounds=-1), 2)
        try:
            await h.start(2)
            await wait_until(lambda: min(h.flushes(i) for i in range(2)) >= 2)
            old = h.nodes.pop(1)
            port = old.transport.endpoint.port
            await old.stop()
            await h.add_node(1, port=port)
            f1 = h.flushes(1)
            await wait_until(lambda: h.flushes(1) >= f1 + 3, timeout=15.0)
        finally:
            await h.stop()
        _check_mean(h, [1], [0, 1])

    _run(run())


@pytest.mark.parametrize(
    "jax_master, jax_nodes",
    [(True, (0, 2)), (False, (1,))],
    ids=["jax_master_port_nodes", "port_master_jax_node"],
)
def test_mixed_cluster_with_the_jax_package(jax_master, jax_nodes):
    """A JAX master with port nodes (and one JAX node), and a port master
    with a JAX node among port nodes: every flush equals the numpy mean."""

    async def run():
        h = _Harness(_config(3, max_rounds=4), 3, jax_master=jax_master, jax_nodes=jax_nodes)
        try:
            await h.start(3)
            await h.master.run_until_done(timeout=20.0)
            await wait_until(lambda: all(h.flushes(i) >= 4 for i in range(3)))
        finally:
            await h.stop()
        for i in range(3):
            assert isinstance(h.outputs[i][-1].data, torch.Tensor) == (i not in jax_nodes)
        _check_mean(h, range(3), range(3), rtol=0, atol=1e-6)

    _run(run())


def test_chunk_service_pulls_between_port_and_jax_nodes(tmp_path):
    """Node 0 runs the JAX package, nodes 1 and 2 the port's, with one
    replica each on the id ring: 2 -> 0 (a port node's state held by a JAX
    node), 0 -> 1 (JAX held by port), 1 -> 2 (port held by port). Each
    node loses its own blobs and manifests and pulls them back from its
    holder, byte for byte."""

    async def run():
        h = _Harness(_config(3, max_rounds=-1), 3, jax_master=True, jax_nodes=(0,),
                     state_root=tmp_path, replicas=1)
        try:
            await h.start(3)
            states = {
                i: {
                    "payload": np.arange(32, dtype=np.float32) + i,
                    "reduced": np.linspace(0, 1, 32).astype(np.float32) * (i + 1),
                }
                for i in range(3)
            }
            for i, node in h.nodes.items():
                await node.save_state(10 + i, states[i])
            holders = {2: 0, 0: 1, 1: 2}
            await wait_until(
                lambda: all(
                    len(h.master._ckpt.get(i, {"holders": {}})["holders"]) >= 2
                    for i in range(3)
                )
            )
            originals = {}
            for i, holder in holders.items():
                own = h.nodes[i]._chunk_store
                manifest = own.latest()[1]
                shas = set(json.loads(manifest)["leaves"].values())
                peer = h.nodes[holder]._chunk_store
                assert peer.latest(origin=i)[0] == 10 + i
                originals[i] = {sha: own.read(sha) for sha in shas}
                for sha in shas:
                    assert peer.read(sha) == originals[i][sha]
            for i in range(3):
                # lose node i's own state, keep the replicas it holds
                own = h.nodes[i]._chunk_store
                for sha in originals[i]:
                    own.blob_path(sha).unlink()
                for path in own.manifests().values():
                    path.unlink()
                rest = await h.nodes[i].restore_state()
                assert rest is not None and rest["complete"], rest
                assert rest["source"] == "peer" and rest["step"] == 10 + i
                for sha, data in originals[i].items():
                    assert own.read(sha) == data
                step, back = own.load_state()
                assert step == 10 + i
                for key, arr in states[i].items():
                    np.testing.assert_array_equal(back[key], arr)
        finally:
            await h.stop()

    _run(run())


def test_standby_takeover_resumes_rounds_under_the_new_epoch():
    """The leader stops mid-run; the standby's lease expires, it takes over
    under epoch 2, the nodes walk to it, and rounds go on with strictly
    increasing flushes."""

    async def run():
        h = _Harness(_fast(2, max_rounds=-1), 2)
        standby = None
        try:
            await h.start(2)
            for node in h.nodes.values():
                node.join_retry_s = 0.05
            standby = MasterProcess(_fast(2), port=0, standby_of=h.seed, phi_threshold=3.0)
            sb_ep = await standby.start()
            await wait_until(lambda: min(h.flushes(i) for i in range(2)) >= 2)
            await wait_until(lambda: standby._last_digest is not None)
            await wait_until(lambda: h.nodes[0].standbys == [sb_ep], 10.0)
            assert h.nodes[0].master_epoch == 1
            await h.master.stop()
            await wait_until(lambda: standby.active, timeout=20.0)
            assert standby.epoch == 2
            await wait_until(lambda: sorted(standby.grid.nodes) == [0, 1], timeout=20.0)
            f0, f1 = h.flushes(0), h.flushes(1)
            await wait_until(lambda: h.flushes(0) >= f0 + 3 and h.flushes(1) >= f1 + 3)
            for i in (0, 1):
                assert h.nodes[i].master_epoch == 2
                assert h.nodes[i].seed == sb_ep
                seq = [out.iteration for out in h.outputs[i]]
                assert all(b > a for a, b in zip(seq, seq[1:])), seq
        finally:
            for node in h.nodes.values():
                await node.stop()
            if standby is not None:
                await standby.stop()
            await h.master.stop()
        _check_mean(h, [0, 1], [0, 1])

    _run(run())


def test_master_arms_chaos_and_the_adaptive_controller():
    """A configuration that arms chaos gives the master's transport an
    injector in the master's role; one that enables the adaptive controller
    builds it, its policy stamped on the grid."""
    from akka_allreduce_tpu_torch.control.adapt import AdaptiveController
    from akka_allreduce_tpu_torch.control.chaos import MASTER_ROLE, ChaosInjector

    cfg = _config(2)
    chaos = t_config.AllreduceConfig.from_json(
        cfg.to_json().replace('"spec": ""', '"spec": "drop:p=0.1"')
    )
    assert chaos.chaos.enabled
    inj = MasterProcess(chaos, port=0).transport.chaos
    assert isinstance(inj, ChaosInjector) and inj.role == MASTER_ROLE
    assert inj.spec == "drop:p=0.1" and not inj.allow_crash
    adapt = t_config.AllreduceConfig.from_json(
        json.dumps({**json.loads(cfg.to_json()), "adapt": {"enabled": True}})
    )
    master = MasterProcess(adapt, port=0)
    assert isinstance(master.adapt, AdaptiveController)
    assert master.grid.policy == master.adapt.policy() and master.transport.chaos is None


def _spawn(*argv):
    return subprocess.Popen(
        [sys.executable, "-m", "akka_allreduce_tpu_torch", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
    )


def test_cluster_cli_multiprocess_smoke(tmp_path):
    """``cluster-master`` and two ``cluster-node --device cpu`` processes:
    the nodes' last flushes equal the numpy mean of their seeded payloads,
    and the master never started CUDA."""
    master = _spawn(
        "cluster-master", "--port", "0", "--nodes", "2", "--rounds", "5",
        "--size", "8192", "--chunk", "2048", "--heartbeat", "0.2",
    )
    nodes = []
    try:
        seed = read_until(master, "master listening on ")[-1].split()[-1]
        nodes = [
            _spawn("cluster-node", "--seed", seed, "--device", "cpu",
                   "--flush-out", str(tmp_path / f"flush{k}.npz"))
            for k in range(2)
        ]
        out_master, _ = master.communicate(timeout=60)
        assert "master done: 5 line-rounds" in out_master, out_master
        assert "master cuda_initialized=False" in out_master
        outs = []
        for n in nodes:
            out, _ = n.communicate(timeout=30)
            assert n.returncode == 0, out
            assert "5 rounds" in out and "device=cpu" in out, out
            assert "wire=" in out
            outs.append(out)
    finally:
        for proc in [master, *nodes]:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    expected = np.mean(
        [np.random.default_rng(k).standard_normal(8192).astype(np.float32) for k in range(2)],
        axis=0,
    )
    for k in range(2):
        got = np.load(tmp_path / f"flush{k}.npz")
        assert got["count"].min() == 2 and int(got["iteration"]) == 4
        np.testing.assert_allclose(got["data"] / got["count"], expected, rtol=1e-5, atol=1e-6)
