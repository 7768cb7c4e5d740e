"""The port's distributed elastic-averaging training (``train/cluster.py``)
over loopback TCP on the CPU, the port's versions of
``tests/test_cluster_train.py``: a ``MasterProcess`` with two
``ElasticClusterNode`` learners at ``device="cpu"`` in one event loop
(losses fall, sync rounds are applied, the replicas end closer than they
started); a node whose model does not match the cluster's ``data_size`` is
refused; when the other member departs, a node wrapping an
``ElasticDPTrainer`` re-meshes through ``apply_membership`` and keeps
training; the chaos arguments reach its ``NodeProcess``; and ``train-cluster-master``
with two ``train-cluster-node --device cpu`` processes.

Every asyncio test runs under its own deadline, so a hang fails the test.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.cluster_cli import read_until
from akka_allreduce_tpu_torch.config import (
    AllreduceConfig,
    LineMasterConfig,
    MasterConfig,
    MetaDataConfig,
    ThresholdConfig,
)
from akka_allreduce_tpu_torch.control.bootstrap import MasterProcess, NodeProcess
from akka_allreduce_tpu_torch.control.cluster import Endpoint
from akka_allreduce_tpu_torch.models import MLP, mnist_like
from akka_allreduce_tpu_torch.parallel import line_mesh
from akka_allreduce_tpu_torch.protocol import AllReduceInput
from akka_allreduce_tpu_torch.train import DPTrainer, ElasticClusterNode, ElasticDPTrainer

DEADLINE_S = 40.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trainer(seed: int) -> DPTrainer:
    return DPTrainer(MLP(hidden=(8,), classes=10, seed=seed, device="cpu"),
                     line_mesh(1, device="cpu"), learning_rate=0.05)


def _config(size: int, *, nodes: int = 2, rounds: int = 60, chunk: int = 2048):
    return AllreduceConfig(
        threshold=ThresholdConfig(1.0, 1.0, 1.0),
        metadata=MetaDataConfig(data_size=size, max_chunk_size=chunk),
        line_master=LineMasterConfig(round_window=2, max_rounds=rounds),
        master=MasterConfig(node_num=nodes, dimensions=1, heartbeat_interval_s=0.05),
    )


async def wait_until(pred, timeout: float = 20.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise TimeoutError("condition not reached")
        await asyncio.sleep(0.02)


def _run(coro) -> None:
    asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def test_elastic_cluster_training_two_nodes():
    async def run():
        t0, t1 = _trainer(1), _trainer(2)
        gap_before = float(np.linalg.norm(t0.get_flat_params() - t1.get_flat_params()))
        master = MasterProcess(_config(t0.param_count), port=0)
        seed_ep = await master.start()
        nodes = [
            ElasticClusterNode(seed_ep, t, iter(mnist_like(seed=i).batches(16, 20)),
                               elastic_rate=0.5, preferred_node_id=i)
            for i, t in enumerate([t0, t1])
        ]
        assert all(n.node.device.type == "cpu" for n in nodes)
        try:
            steps = await asyncio.gather(*(n.run(20) for n in nodes))
        finally:
            await master.stop()
        assert steps == [20, 20]
        for n in nodes:
            assert n.rounds_applied >= 3, n.rounds_applied
            assert len(n.losses) == 20
            assert np.mean(n.losses[-5:]) < n.losses[0]
        gap_after = float(np.linalg.norm(t0.get_flat_params() - t1.get_flat_params()))
        assert gap_after < gap_before, (gap_before, gap_after)

    _run(run())


def test_elastic_cluster_node_rejects_size_mismatch():
    async def run():
        trainer = _trainer(1)
        master = MasterProcess(_config(trainer.param_count + 1, nodes=1, rounds=5), port=0)
        seed_ep = await master.start()
        node = ElasticClusterNode(seed_ep, trainer, iter(mnist_like().batches(8, 2)))
        try:
            with pytest.raises(ValueError, match="param count"):
                await node.run(2)
        finally:
            await node.node.stop()
            await master.stop()

    _run(run())


def test_survivor_remeshes_its_elastic_trainer_when_a_member_departs():
    """Node 0 is a plain member; node 1 trains an ``ElasticDPTrainer`` whose
    ranks follow the cluster's nodes ({0: [0], 1: [1]}). Node 0 leaves once
    sync is established: the survivor's learner re-meshes 2 -> 1 ranks
    through ``apply_membership`` and keeps stepping and syncing solo."""

    async def run():
        elastic = ElasticDPTrainer(MLP(hidden=(8,), classes=10, seed=2, device="cpu"),
                                   {0: [0], 1: [1]}, learning_rate=0.05, device="cpu")
        size = elastic.param_count
        master = MasterProcess(_config(size, rounds=-1, chunk=4096), port=0)
        seed_ep = await master.start()
        zeros = torch.zeros(size)
        plain = NodeProcess(seed_ep, lambda req: AllReduceInput(zeros), lambda out: None,
                            preferred_node_id=0, device="cpu")
        await plain.start()
        await plain.wait_welcomed()
        data = iter(mnist_like(seed=1).batches(8, 10_000))

        def batches(t):
            x, y = next(data)
            return np.concatenate([x] * t.n_devices), np.concatenate([y] * t.n_devices)

        node = ElasticClusterNode(seed_ep, elastic, batches, preferred_node_id=1)
        try:
            task = asyncio.ensure_future(node.run(10_000))
            await wait_until(lambda: node.rounds_applied >= 3 and len(node.losses) >= 3, 20.0)
            assert elastic.n_devices == 2 and node.remeshes == 0
            await plain.leave()
            await plain.stop()
            await wait_until(lambda: node.remeshes >= 1, 20.0)
            assert elastic.member_nodes == (1,) and elastic.n_devices == 1
            marks = (node.rounds_applied, len(node.losses))
            await wait_until(lambda: node.rounds_applied > marks[0] + 2
                             and len(node.losses) > marks[1] + 2, 20.0)
        finally:
            await master.stop()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await node.node.stop()
        assert elastic.generation == 1 and all(np.isfinite(node.losses))
        assert np.mean(node.losses[-3:]) < node.losses[0]

    _run(run())


def test_chaos_arguments_pass_through_to_the_node():
    ep = Endpoint("127.0.0.1", 1)
    for kw in (dict(allow_crash=True), dict(chaos_log="x.jsonl")):
        node = ElasticClusterNode(ep, _trainer(0), iter(()), **kw).node
        assert node.allow_crash is kw.get("allow_crash", False)
        assert node.chaos_log == kw.get("chaos_log")


def test_snapshot_cell_hands_over_new_tensors():
    """The learner publishes a new tensor a step; the binder's round reads
    it and deposits a new one, which the learner folds in."""
    trainer = _trainer(3)
    node = ElasticClusterNode(Endpoint("127.0.0.1", 1), trainer,
                              iter(mnist_like().batches(8, 1)))
    first = node._read_snapshot()
    np.testing.assert_array_equal(first.numpy(), trainer.get_flat_params())
    assert node._train_one() == "stepped"
    second = node._read_snapshot()
    assert second is not first and not torch.equal(second, first)
    node._deposit(torch.zeros_like(second))
    node._fold_incoming()
    assert not trainer.get_flat_params().any() and node._incoming is None
    assert node._train_one() == "end"


def _spawn(*argv):
    return subprocess.Popen([sys.executable, "-m", "akka_allreduce_tpu_torch", *argv],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)


def test_train_cluster_cli_on_the_cpu():
    """``train-cluster-master`` and two ``train-cluster-node --device cpu``
    processes: every node trains its steps with a falling loss and applies
    sync rounds, and the master never started CUDA."""
    master = _spawn("train-cluster-master", "--nodes", "2", "--rounds", "5",
                    "--heartbeat", "0.2", "--hidden", "16")
    nodes = []
    try:
        lines = read_until(master, "master listening on ")
        assert lines[0].startswith("model: 12730 params -> data_size 12730"), lines
        seed = lines[-1].split()[3]
        nodes = [_spawn("train-cluster-node", "--seed", seed, "--device", "cpu",
                        "--hidden", "16", "--steps", "100", "--batch", "16",
                        "--data-seed", str(k)) for k in range(2)]
        for n in nodes:
            out, _ = n.communicate(timeout=60)
            assert n.returncode == 0, out
            line = next(ln for ln in out.splitlines() if ln.startswith("trained 100 steps"))
            rounds = int(line.split("(")[1].split()[0])
            first, last = (float(v) for v in line.split("loss ")[1].split(";")[0].split(" -> "))
            assert rounds >= 1 and last < first and line.endswith("device=cpu"), line
        out_master, _ = master.communicate(timeout=60)
        assert "master done: 5 line-rounds" in out_master, out_master
        assert "master cuda_initialized=False" in out_master
    finally:
        for proc in [master, *nodes]:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
