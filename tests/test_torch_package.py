"""Guards on the PyTorch/CUDA port as a package.

- It imports neither ``jax`` nor anything of ``akka_allreduce_tpu`` (checked
  in a fresh interpreter, and in the source text).
- Its entry points run on the card unless asked for the CPU: with no CUDA
  they raise instead of running on the CPU.
- The CPU path launches no kernel (the threshold reduce, the ring, and a
  gated attention forward and backward alike).
- The ``bench-suite`` (config 1, the host engine, first; config 5 last), ``bench`` and
  ``local-demo`` commands print parseable records at a tiny size, and
  ``local-demo --chaos-spec`` arms the host engine's dev-mode chaos.
- Its copies of the configs and of the per-round metrics behave as the JAX
  package's.
- The TCP control plane's commands and the elastic ones (``elastic-demo``,
  ``train-cluster-master``, ``train-cluster-node``) are listed, as in the JAX
  CLI, with the eight chaos drills (26 of the JAX CLI's 30 commands); the
  cluster commands parse the chaos and adapt flags as the JAX CLI does and
  put a node on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import json
import math
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import akka_allreduce_tpu_torch
from akka_allreduce_tpu import config as jconfig
from akka_allreduce_tpu.utils import metrics as jmetrics
from akka_allreduce_tpu_torch import bench, bench_suite, config, state
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch._device import resolve_device, use_kernel
from akka_allreduce_tpu_torch.comm import measure_allreduce, threshold_allreduce
from akka_allreduce_tpu_torch.config import AllreduceConfig
from akka_allreduce_tpu_torch.control import LocalAllreduceSystem
from akka_allreduce_tpu_torch.models import MLP, TransformerLM
from akka_allreduce_tpu_torch.ops import flash_attention as tflash
from akka_allreduce_tpu_torch.ops import local_reduce as tlr
from akka_allreduce_tpu_torch.ops import ring as tring
from akka_allreduce_tpu_torch.parallel import data_seq_mesh, grid_mesh, line_mesh
from akka_allreduce_tpu_torch.train import LongContextTrainer, Zero1DPTrainer
from akka_allreduce_tpu_torch.utils import metrics

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "akka_allreduce_tpu_torch"


def _module_names() -> list[str]:
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PKG)], prefix="akka_allreduce_tpu_torch.")
    )


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'akka_allreduce_tpu' or m.startswith('akka_allreduce_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_source_names_no_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax)|akka_allreduce_tpu\.", re.M)
    offenders = [
        str(p.relative_to(REPO))
        for p in PKG.rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert offenders == []
    names = _module_names()
    for mod in ("ops.local_reduce", "ops.ring", "comm.allreduce",
                "comm.bandwidth", "parallel.mesh", "utils.metrics",
                "ops.ring_attention", "ops.local_attention", "ops.flash_attention",
                "models.transformer", "models.generate", "models.convert",
                "models.data", "train", "train.trainer", "train.long_context",
                "binder", "binder.api", "bench_mfu", "models.resnet", "utils.verify",
                "graft_entry", "protocol", "buffers", "tensor_reduce", "control",
                "control.envelope", "control.pod", "control.wire", "control.worker",
                "control.line_master", "control.grid_master", "control.node",
                "control.local", "obs", "obs.metrics", "obs.flight", "obs.trace",
                "obs.watchdog", "binder.grad_sync", "binder.elastic",
                "control.statetransfer", "train.checkpoint", "train.zero1",
                "control.cluster", "control.failure", "control.stripes",
                "control.gossip", "control.remote", "control.bootstrap",
                "native", "cluster_cli", "train.elastic", "train.cluster",
                "control.chaos", "control.adapt", "control.simfabric", "train.zoo",
                "chaos_cli", "ops.moe", "train.moe"):
        assert f"akka_allreduce_tpu_torch.{mod}" in names


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert not use_kernel(torch.zeros(2))


def test_entry_points_raise_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state.state_from_numpy(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_suite.config2_butterfly(1024)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_suite.run_suite(floats=1024)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["bench-suite", "--quick", "--floats", "1024"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        line_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grid_mesh(2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["bench", "--floats", "1024", "--devices", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["bench", "--mesh", "grid", "--schedule", "butterfly"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(vocab=16, d_model=32, n_heads=4, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["lm-generate", "--vocab", "16", "--d-model", "32", "--layers", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data_seq_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LongContextTrainer(vocab=16, d_model=32, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["train-lm", "--vocab", "16", "--d-model", "32", "--layers", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["lm-generate", "--train-steps", "2", "--layers", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["bench-mfu", "--d-model", "32", "--layers", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalAllreduceSystem(1, [None], [None], AllreduceConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_suite.config1_local_engine(1024, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["local-demo", "--size", "1024", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Zero1DPTrainer(MLP(hidden=(8,), device="cpu"), line_mesh(4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["train-zero1", "--hidden", "8", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["bench-checkpoint", "--trainer", "zero1", "--d-model", "32", "--layers", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["bench-checkpoint", "--d-model", "32", "--layers", "1", "--seq-len", "16"])
    from akka_allreduce_tpu_torch.control.bootstrap import NodeProcess
    from akka_allreduce_tpu_torch.control.cluster import Endpoint

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NodeProcess(Endpoint("127.0.0.1", 1), None, None)
    assert capsys.readouterr().out == ""  # nothing was measured or printed
    # the CLI roles refuse through argparse (exit 2, the reason on stderr)
    for argv in (
        ["cluster-node", "--seed", "127.0.0.1:1"],
        ["bench-wire", "--reps", "1"],
        ["obs", "demo", "--nodes", "1"],
    ):
        with pytest.raises(SystemExit) as exit_info:
            cli_main(argv)
        assert exit_info.value.code == 2
        assert "CUDA is not available" in capsys.readouterr().err


def test_elastic_entry_points_raise_without_cuda(monkeypatch, capsys):
    from akka_allreduce_tpu_torch.train import ElasticDPTrainer, ElasticLongContextTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasticDPTrainer(MLP(hidden=(8,), device="cpu"), {0: [0, 1], 1: []})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasticLongContextTrainer({0: [0], 1: []}, vocab=16, d_model=32, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_suite.config5_dropout_recovery(1024)
    assert capsys.readouterr().out == ""
    for argv in (
        ["elastic-demo", "--steps", "1"],
        ["elastic-demo", "--family", "lc", "--steps", "1"],
        ["train-cluster-node", "--seed", "127.0.0.1:1"],
    ):
        with pytest.raises(SystemExit) as exit_info:
            cli_main(argv)
        assert exit_info.value.code == 2
        assert "CUDA is not available" in capsys.readouterr().err


def test_cpu_path_counts_no_launches():
    before = dict(tlr.LAUNCHES)
    x = torch.randn(4, 300, generator=torch.Generator().manual_seed(0))
    tlr.masked_average(x, torch.ones(4))
    tlr.elastic_average_step(x, torch.ones(4), 0.5)
    tlr.elastic_average_step(tlr.pack_tiles(x), torch.ones(4), 0.5)
    assert tlr.LAUNCHES == before
    assert set(before) == {"masked_average", "elastic_average_step"}


def test_cpu_ring_path_counts_no_launches():
    before = dict(tring.LAUNCHES)
    mesh = line_mesh(4, device="cpu")
    xs = torch.randn(4, 3000, generator=torch.Generator().manual_seed(1))
    for compress in (None, "bf16", "int8"):
        threshold_allreduce(mesh, xs, schedule="pallas_ring", bucket_size=1024,
                            compress=compress)
    measure_allreduce(mesh, 2048, iters=1, warmup=0, schedule="pallas_ring")
    assert tring.LAUNCHES == before == {"ring_allreduce": before["ring_allreduce"]}


def test_cpu_attention_path_counts_no_launches():
    """A gated forward and backward on the CPU take K4's plain versions: no
    launch of either kernel."""
    before = dict(tflash.LAUNCHES)
    model = TransformerLM(vocab=16, d_model=64, n_heads=2, n_layers=1, device="cpu")
    model(torch.zeros((1, 1024), dtype=torch.int64)).sum().backward()
    assert model.blocks[0].attn.q_kernel.grad.abs().sum() > 0
    assert tflash.LAUNCHES == before
    assert set(before) == {"flash_attention", "flash_attention_wgmma",
                           "flash_attention_3xtf32", "flash_attention_bwd",
                           "flash_attention_bwd_wgmma", "flash_attention_bwd_3xtf32"}


@pytest.fixture
def one_torch_thread():
    """The CPU bench loop on one intra-op thread: beside other test workers,
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_suite_cli_prints_records(capsys, tmp_path, one_torch_thread):
    out = tmp_path / "records.jsonl"
    rc = cli_main([
        "bench-suite", "--quick", "--device", "cpu", "--floats", "4096",
        "--out", str(out),
    ])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    records = [json.loads(line) for line in lines]
    assert [r["config"] for r in records] == [1, 2, 3, 4, 5]
    assert out.read_text().strip().splitlines() == lines
    dropout = records.pop()  # config 5: both tiers, the re-mesh on the CPU
    assert dropout["name"] == "threshold_dropout_recovery" and dropout["remeshed"] is True
    assert dropout["rounds_completed"] == 10 and dropout["device"] == "cpu"
    engine = records.pop(0)  # config 1: the host engine, 4 workers
    assert engine["name"] == "local_engine_allreduce" and engine["workers"] == 4
    assert engine["floats"] == 4096 and engine["rounds"] == 30
    assert engine["engine"] == engine["device"] == "cpu"
    assert engine["path"] == "host_engine" and engine["power_limit"] is None
    assert engine["seconds"] > 0 and engine["throughput_mbs"] > 0
    mlp = records.pop(1)  # config 3: the MLP's DP step, at its own size
    assert mlp["name"] == "mlp_mnist_dp_sgd" and mlp["virtual_workers"] == 8
    assert mlp["device"] == "cpu" and mlp["path"] == "plain_masked_average"
    assert mlp["step_ms"] > 0 and math.isfinite(mlp["device_step_ms"])
    for rec in records:
        assert rec["name"].startswith(
            ("butterfly_allreduce", "resnet_grad_sync_25M")
        )
        assert rec["floats"] == 4096 and rec["virtual_workers"] == 8
        assert rec["device"] == "cpu" and rec["power_limit"] is None
        assert rec["path"] == "single_chip_fused_reduce"
        # timings on a shared CPU are noise: check their form, not their size
        assert math.isfinite(rec["seconds_per_iter"]) and rec["reduce_gbps"] >= 0
        # the packed working set: 8 workers x one 512 x 128 tile each
        assert rec["working_set_mb"] == round(8 * 512 * 128 * 4 / 1e6, 1)


@pytest.mark.parametrize(
    "extra,schedule,n",
    [
        ([], "psum", 4),
        (["--schedule", "ring", "--compress", "int8", "--bucket", "512"], "ring", 4),
        (["--mesh", "grid", "--schedule", "butterfly", "--compress", "bf16"],
         "butterfly", 4),
    ],
)
def test_bench_cli_prints_one_record(capsys, one_torch_thread, extra, schedule, n):
    rc = cli_main(["bench", "--device", "cpu", "--devices", "4", "--floats",
                   "4096", "--iters", "2", *extra])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["num_floats"] == 4096 and rec["n_devices"] == n
    assert rec["schedule"] == schedule and rec["iters"] == 2
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["path"] == "virtual_ranks_one_card"
    assert math.isfinite(rec["bus_gbps_median"]) and rec["bus_gbps_best"] > 0


def test_local_demo_cli_prints_one_line(capsys):
    rc = cli_main(["local-demo", "--device", "cpu", "--size", "1000", "--chunk", "64",
                   "--rounds", "3", "--dims", "2"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    fields = dict(f.split("=", 1) for f in line.split() if "=" in f)
    assert fields["nodes"] == "4" and fields["size"] == "1000"
    assert fields["rounds_completed"] == "3" and fields["engine"] == "cpu"
    assert float(fields["elapsed"].rstrip("s")) > 0
    assert "per-node flushes: [3, 3, 3, 3]" in line


def test_local_demo_arms_chaos(capsys):
    rc = cli_main(["local-demo", "--device", "cpu", "--size", "1000", "--chunk", "64",
                   "--rounds", "3", "--chaos-seed", "1", "--chaos-spec", "duplicate:p=0.1"])
    assert rc == 0
    assert "rounds_completed=3" in capsys.readouterr().out.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as exit_info:
        cli_main(["local-demo", "--device", "cpu", "--chaos-spec", "explode:p=1"])
    assert exit_info.value.code == 2
    assert "unknown chaos fault" in capsys.readouterr().err
    chaos = AllreduceConfig(chaos=config.ChaosConfig(seed=1, spec="drop:p=0.1"))
    assert chaos.chaos.enabled
    system = LocalAllreduceSystem(1, [None], [None], chaos, device="cpu")
    inj = system.router.chaos
    assert (inj.seed, inj.spec, inj.role, inj.dims) == (1, "drop:p=0.1", -1, 1)


@pytest.mark.parametrize(
    "argv",
    [
        ["cluster-master", "--chaos-spec", "drop:p=0.1"],
        ["cluster-master", "--chaos-seed", "3"],
        ["cluster-master", "--chaos-log", "x.jsonl"],
        ["cluster-master", "--adapt"],
        ["cluster-master", "--adapt-floor", "0.6"],
        ["cluster-master", "--adapt-log", "a.jsonl"],
        ["cluster-node", "--seed", "127.0.0.1:1", "--device", "cpu", "--chaos-log", "x"],
    ],
)
def test_cluster_cli_parses_chaos_and_adapt_like_jax(argv):
    """Each argv parses into the flag values, ``ChaosConfig`` and
    ``AdaptConfig`` that the JAX CLI builds from it."""
    import argparse
    import dataclasses

    import akka_allreduce_tpu.__main__ as jmain
    from akka_allreduce_tpu_torch import cluster_cli

    if argv[0] == "cluster-node":
        ours = cluster_cli._cluster_node_parser().parse_args(argv[1:])
        assert ours.chaos_log == "x"
        return
    ours = cluster_cli._cluster_master_parser().parse_args(argv[1:])
    p = argparse.ArgumentParser()
    jmain._add_chaos_flags(p)
    jmain._add_adapt_flags(p)
    theirs, _ = p.parse_known_args(argv[1:])
    for name in ("chaos_seed", "chaos_spec", "chaos_log", "adapt", "adapt_floor",
                 "adapt_window", "adapt_dwell", "adapt_lag", "adapt_log", "send_retries",
                 "send_backoff_base", "send_backoff_max"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert dataclasses.asdict(cluster_cli.adapt_config_from(ours)) == dataclasses.asdict(
        jmain._adapt_config_from(theirs))
    chaos = cluster_cli.chaos_config_from(ours)
    assert (chaos.seed, chaos.spec, chaos.enabled) == (
        theirs.chaos_seed, theirs.chaos_spec, bool(theirs.chaos_spec))


DRILLS = ("chaos", "chaos-recover", "chaos-gossip", "chaos-scale", "chaos-failover",
          "chaos-adapt", "chaos-train", "chaos-train-node")


def test_cluster_commands_are_listed(capsys):
    from akka_allreduce_tpu.__main__ import COMMANDS as JAX_COMMANDS
    from akka_allreduce_tpu_torch.__main__ import COMMANDS

    new = ("cluster-master", "cluster-node", "cluster-standby", "obs", "bench-wire",
           "elastic-demo", "train-cluster-master", "train-cluster-node", *DRILLS)
    assert set(new) <= set(COMMANDS) and set(new) <= set(JAX_COMMANDS)
    # the three that wait for ROADMAP item 11
    assert set(JAX_COMMANDS) - set(COMMANDS) == {"soak", "train-fsdp", "train-pp"}
    assert len(COMMANDS) == 27 and set(COMMANDS) <= set(JAX_COMMANDS)
    assert cli_main([]) == 2
    usage = capsys.readouterr().err
    assert all(name in usage for name in new)


def test_bench_wire_cli_prints_records_on_the_cpu(capsys):
    rc = cli_main(["bench-wire", "--device", "cpu", "--size", "256", "--frames", "8",
                   "--reps", "1", "--congestion"])
    assert rc == 0
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(records) == 2 and records[0]["device"] == "cpu"
    assert records[0]["encode_mbps"] > 0 and records[1]["deterministic"] is True


def test_bench_cli_keeps_the_jax_schedule_choices():
    with pytest.raises(SystemExit):
        cli_main(["bench", "--device", "cpu", "--schedule", "pallas_ring"])


def test_cli_rejects_unknown_command(capsys):
    assert cli_main(["no-such-command"]) == 2
    assert "bench-suite" in capsys.readouterr().err


def test_multi_rank_raises_not_implemented(monkeypatch):
    monkeypatch.setattr(bench_suite, "_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="next slice"):
        bench_suite.config4_grad_sync(1024, device="cpu")


@pytest.mark.parametrize("fraction,peers", [(0.75, 16), (1.0, 4), (0.5, 3), (0.01, 7)])
def test_threshold_config_copy_matches_jax(fraction, peers):
    ours = config.ThresholdConfig(fraction, fraction, fraction)
    theirs = jconfig.ThresholdConfig(fraction, fraction, fraction)
    for method in ("reduce_count", "complete_count", "allreduce_count"):
        assert getattr(ours, method)(peers) == getattr(theirs, method)(peers)
    assert config.ThresholdConfig(th_reduce=0.75).reduce_count(16) == 12


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(data_size=1_000_000, max_chunk_size=262_144),
        dict(data_size=17, max_chunk_size=5, wire_dtype="f16"),
        dict(data_size=0),
        dict(data_size=10, max_chunk_size=0),
        dict(data_size=10, wire_dtype="bf16"),
    ],
)
def test_metadata_config_copy_matches_jax(kwargs):
    try:
        theirs = jconfig.MetaDataConfig(**kwargs)
    except ValueError:
        with pytest.raises(ValueError):
            config.MetaDataConfig(**kwargs)
        return
    ours = config.MetaDataConfig(**kwargs)
    for peers in (1, 3, 4):
        assert ours.block_size(peers) == theirs.block_size(peers)
        n = ours.chunks_per_block(peers)
        assert n == theirs.chunks_per_block(peers)
        for chunk in range(n):
            assert ours.chunk_size(peers, chunk) == theirs.chunk_size(peers, chunk)
    with pytest.raises(IndexError):
        ours.chunk_size(1, ours.chunks_per_block(1))


def test_metrics_copy_matches_jax(tmp_path):
    kw = dict(round_num=3, latency_s=0.002, data_bytes=1 << 20, n_devices=8,
              contributors=6.0, schedule="ring", extra={"num_floats": 262144})
    ours, theirs = metrics.RoundMetrics(**kw), jmetrics.RoundMetrics(**kw)
    assert ours.bus_gbps == theirs.bus_gbps
    assert ours.to_json() == theirs.to_json()
    assert metrics.RoundMetrics(0, 0.0, 10, 2, 1.0).bus_gbps == 0.0
    for mod in (metrics, jmetrics):
        mem = mod.MetricsLogger()
        mem.log_round(mod.RoundMetrics(**kw))
        mem.close()
        assert mem.dump() == ours.to_json() + "\n"
    path = tmp_path / "rounds.jsonl"
    log = metrics.MetricsLogger(str(path))
    log.log_round(ours)
    log.log_event(kind="note", t=1.0)
    log.close()
    assert path.read_text().splitlines() == [ours.to_json(), '{"kind": "note", "t": 1.0}']


def test_threshold_config_rejects_bad_fraction():
    for bad in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError):
            config.ThresholdConfig(th_reduce=bad)
    assert akka_allreduce_tpu_torch.__version__
