"""The port's ResNet-50 (BASELINE config 4) against the JAX package's, on the
CPU, with its data, its entry points and its training through ``DPTrainer``.

- A narrow ``ResNet(stage_sizes=(1, 1, 1, 1), width=8, classes=10)`` with the
  flax weights carried over: logits in f32 within 1e-4 of max|logit| and in
  bf16 compute within 2e-2, at 64 px (every ``"SAME"`` split even: 0 before,
  1 after) and at 50 px (the max-pool's and the first two strided convs'
  inputs odd: 1 and 1). Smaller images leave GroupNorm groups of one or two
  values in the last stages (at 16 px some hold two values 3e-7 apart,
  mean^2 / var up to 1e5), where f32 rounding alone moves the logits: JAX's
  own eager and jitted forwards differ by 1.4e-4 of max|logit| there.
- Two ``DPTrainer`` steps of it against JAX's with ``bucket_size=262,144``
  at lr 0.1, the second with rank 7 masked: losses within rtol 1e-5,
  contributors exact. The first step's update within 5e-3 of max|update|
  of JAX's: at this initialisation every f32 gradient, JAX's and the
  port's, lies 2.4e-3 of max|grad| from the f64 gradient, because one ReLU
  input in the third block is -2.3e-6 in f64 and +3.3e-6 in f32
  (``resnet_numerics.py gradient``), so no f32 pair can be held closer.
  The second step starts from JAX's parameters after its first, where the
  f32 gradients agree, and lands within rtol 2e-4, atol 2e-5 of JAX's
  parameters: it moves a parameter by up to 0.11, and the weight gradients
  of the 64-channel convs scaled by 1.01 fail this check and the next. The overlapped step from the same point
  against JAX ``DPTrainer(overlap=True)`` and against the port's fused
  step, in the same band.
- ``ResNet50(1000)`` and ``ResNet50(10)`` without running them: leaf paths
  and shapes from ``jax.eval_shape`` of the JAX ``init`` against the port's
  ``flax_path`` / ``flatten_params`` order, 161 leaves, 25,557,032 and
  23,528,522 parameters; ``resnet_fwd_flops`` at 64 and 224 px.
- ``imagenet_like`` batches bit-equal to JAX's; ``FileDataset`` on ``.npz``
  shards (batches equal to JAX's, its errors eager); the device sampler.
- ``train-resnet`` and ``bench-mfu --workload resnet`` (its wiring), both
  with the narrow model in place of ``ResNet50`` and at a cut image size,
  ``graft_entry.dryrun_multichip(4)`` and ``entry()`` on the CPU; without
  ``--device cpu`` each raises when CUDA is absent.

Two JAX trainers are built (the first one's weights feed the logit checks too).
"""

from __future__ import annotations

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from akka_allreduce_tpu.models import ResNet50 as JResNet50
from akka_allreduce_tpu.models import data as jdata
from akka_allreduce_tpu.models.resnet import ResNet as JResNet
from akka_allreduce_tpu.models.resnet import resnet_fwd_flops as j_resnet_fwd_flops
from akka_allreduce_tpu.parallel import line_mesh as j_line_mesh
from akka_allreduce_tpu.train import DPTrainer as JDPTrainer
from akka_allreduce_tpu_torch import bench_mfu, graft_entry, models
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.binder import flatten_params
from akka_allreduce_tpu_torch.binder.api import leaf_order
from akka_allreduce_tpu_torch.models import (
    FileDataset,
    ResNet,
    ResNet50,
    imagenet_like,
    resnet_fwd_flops,
    resnet_state_dict_from_flax,
)
from akka_allreduce_tpu_torch.models.convert import flax_path
from akka_allreduce_tpu_torch.models.resnet import same_pads
from akka_allreduce_tpu_torch.parallel import line_mesh
from akka_allreduce_tpu_torch.train import DPTrainer

N = 8
NARROW = dict(stage_sizes=(1, 1, 1, 1), width=8, classes=10)
SIZE = 64
STEP_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_train.py's
LR = 0.1
MASK7 = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)


def _jax_trainer(model, **kw):
    # the trainer calls ``init`` as given: jitted, it builds in a third of
    # the eager op-by-op time
    return JDPTrainer(types.SimpleNamespace(init=jax.jit(model.init), apply=model.apply),
                      j_line_mesh(N), example_input=np.zeros((1, 8, 8, 3), np.float32),
                      optimizer=optax.sgd(LR), **kw)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX DP trainer on the narrow model (its weights drawn on 8 px
    inputs: the parameters do not depend on the image size) and two steps
    at 64 px, the second with rank 7 masked; then JAX's overlapped trainer
    takes that second step from the same parameters."""
    model = JResNet(**NARROW)
    jt = _jax_trainer(model, bucket_size=262_144)
    init = jt.get_flat_params()
    tree = jax.device_get(jt.params)
    batches = list(jdata.imagenet_like(SIZE, 10).batches(2 * N, 2))
    hist = [jt.train_step(*batches[0])]
    after1 = jt.get_flat_params()
    hist.append(jt.train_step(*batches[1], MASK7))
    jo = _jax_trainer(model, overlap=True)
    jo.set_flat_params(after1)
    overlap = jo.train_step(*batches[1], MASK7)
    return {"init": init, "tree": tree, "batches": batches, "hist": hist, "after1": after1,
            "params": jt.get_flat_params(), "overlap": overlap,
            "overlap_params": jo.get_flat_params()}


def _port_trainer(params, **kw):
    tt = DPTrainer(ResNet(**NARROW, device="cpu"), line_mesh(N, device="cpu"),
                   learning_rate=LR, **kw)
    tt.set_flat_params(params)
    return tt


def test_same_pads_split_like_xla():
    assert same_pads(16, 3, 2) == (0, 1) and same_pads(15, 3, 2) == (1, 1)
    assert same_pads(8, 3, 1) == (1, 1) and same_pads(16, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [64, 50])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_match_flax(jax_run, size, dtype):
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-4) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    x = np.random.default_rng(size).standard_normal((4, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JResNet(**NARROW, compute_dtype=jdt).apply)(jax_run["tree"], x))
    tm = ResNet(**NARROW, compute_dtype=tdt, device="cpu")
    tm.load_state_dict(resnet_state_dict_from_flax(jax_run["tree"]))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (4, 10)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_flax_tree_round_trip_and_errors(jax_run):
    tm = ResNet(**NARROW, device="cpu")
    tm.load_state_dict(resnet_state_dict_from_flax(jax_run["tree"]))
    np.testing.assert_array_equal(flatten_params(tm)[0], jax_run["init"])
    inner = dict(jax_run["tree"]["params"])
    with pytest.raises(ValueError, match="no counterpart"):
        resnet_state_dict_from_flax({**inner, "Attention_0": {"kernel": np.zeros(3)}})
    block = dict(inner["Bottleneck_0"])
    del block["GroupNorm_3"]
    with pytest.raises(ValueError, match="Bottleneck_0/GroupNorm_3/scale"):
        resnet_state_dict_from_flax({**inner, "Bottleneck_0": block})
    del inner["Bottleneck_2"]
    with pytest.raises(ValueError, match="lacks leaves"):
        resnet_state_dict_from_flax(inner)


def test_dp_steps_match_jax(jax_run):
    (x0, y0), (x1, y1) = jax_run["batches"]
    init, after1 = jax_run["init"], jax_run["after1"]
    tt = _port_trainer(init, bucket_size=262_144)
    hist = [tt.train_step(x0, y0)]
    update, want = tt.get_flat_params() - init, after1 - init
    assert np.abs(update - want).max() <= 5e-3 * np.abs(want).max()
    tt.set_flat_params(after1)
    hist.append(tt.train_step(x1, y1, MASK7))
    for a, b in zip(hist, jax_run["hist"]):
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
        assert a.contributors == b.contributors
    assert [h.contributors for h in hist] == [8.0, 7.0]
    assert np.abs(jax_run["params"] - after1).max() > 5e-2  # the step moved them
    np.testing.assert_allclose(tt.get_flat_params(), jax_run["params"], **STEP_TOL)


def test_overlapped_step_matches_jax_and_the_fused_step(jax_run):
    """Per-rank weights through the vmapped convs and GroupNorm, each leaf
    synced inside the backward (K1's plain version once a leaf)."""
    x1, y1 = jax_run["batches"][1]
    tt = _port_trainer(jax_run["after1"], overlap=True)
    m = tt.train_step(x1, y1, MASK7)
    np.testing.assert_allclose(m.loss, jax_run["overlap"].loss, rtol=1e-5)
    assert m.contributors == jax_run["overlap"].contributors == 7.0
    np.testing.assert_allclose(tt.get_flat_params(), jax_run["overlap_params"], **STEP_TOL)
    fused = _port_trainer(jax_run["after1"], bucket_size=262_144)
    fused.train_step(x1, y1, MASK7)
    np.testing.assert_allclose(tt.get_flat_params(), fused.get_flat_params(), **STEP_TOL)


@pytest.mark.parametrize("classes,count", [(1000, 25_557_032), (10, 23_528_522)])
def test_resnet50_leaves_match_jax_without_running(classes, count):
    shapes = jax.eval_shape(lambda: JResNet50(classes).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    tm = ResNet50(classes, device="cpu")
    names = leaf_order(tm)
    named = dict(tm.named_parameters())
    assert len(leaves) == len(names) == 161
    assert sum(p.numel() for p in tm.parameters()) == count
    for (path, leaf), name in zip(leaves, names):
        assert tuple(k.key for k in path) == flax_path(name)
        assert tuple(leaf.shape) == tuple(named[name].shape), name
    for size in (64, 224):
        assert resnet_fwd_flops(tm, size, 8) == j_resnet_fwd_flops(JResNet50(classes), size, 8)


def test_bad_compute_dtype_and_flax_paths():
    with pytest.raises(ValueError, match="compute_dtype"):
        ResNet(**NARROW, compute_dtype=torch.float16, device="cpu")
    assert flax_path("blocks.10.norm.3.scale") == ("Bottleneck_10", "GroupNorm_3", "scale")
    assert flax_path("conv.kernel") == ("Conv_0", "kernel")
    assert flax_path("head.bias") == ("Dense_0", "bias")


# -- data ----------------------------------------------------------------------------


def test_imagenet_like_batches_bit_equal():
    ours, theirs = imagenet_like(16, 7, seed=3), jdata.imagenet_like(16, 7, seed=3)
    np.testing.assert_array_equal(ours.templates, theirs.templates)
    for (xa, ya), (xb, yb) in zip(ours.batches(6, 2, seed_offset=4),
                                  theirs.batches(6, 2, seed_offset=4)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    assert xa.shape == (6, 16, 16, 3)


def test_file_dataset_round_trips_npz_shards(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 5, 30)
    shards = tmp_path / "shards"
    shards.mkdir()
    np.savez(shards / "a.npz", x=x[:12], y=y[:12])
    np.savez(shards / "b.npz", x=x[12:], y=y[12:])
    ours, theirs = FileDataset(shards, seed=2), jdata.FileDataset(shards, seed=2)
    np.testing.assert_array_equal(ours.x, x)
    assert ours.y.dtype == np.int32 and ours.n == 30
    for (xa, ya), (xb, yb) in zip(ours.batches(8, 6), theirs.batches(8, 6)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    xs, ys = ours.device_sampler()(torch.Generator().manual_seed(1), 64)
    assert xs.shape == (64, 4, 4, 3) and ys.dtype == torch.int64
    rows = {tuple(r) for r in x.reshape(30, -1).round(6)}
    assert all(tuple(r) in rows for r in xs.reshape(64, -1).numpy().round(6))
    single = tmp_path / "one.npz"
    np.savez(single, x=x, y=y)
    assert FileDataset(single).n == 30


def test_file_dataset_errors_are_eager(tmp_path):
    with pytest.raises(FileNotFoundError):
        FileDataset(tmp_path)
    np.savez(tmp_path / "bad.npz", x=np.zeros((3, 2)), labels=np.zeros(3))
    with pytest.raises(KeyError, match="lacks"):
        FileDataset(tmp_path / "bad.npz")
    np.savez(tmp_path / "rows.npz", x=np.zeros((3, 2)), y=np.zeros(4))
    with pytest.raises(ValueError, match="rows"):
        FileDataset(tmp_path / "rows.npz")
    np.savez(tmp_path / "ok.npz", x=np.zeros((3, 2)), y=np.zeros(3))
    with pytest.raises(ValueError, match="exceeds"):
        FileDataset(tmp_path / "ok.npz").batches(4, 0)


# -- entry points ----------------------------------------------------------------------


@pytest.fixture
def narrow_resnet50(monkeypatch):
    """The entry points build ``ResNet50``; here they get the narrow model."""
    def narrow(classes=1000, compute_dtype=torch.float32, *, seed=0, device=None):
        return ResNet(**{**NARROW, "classes": classes}, compute_dtype=compute_dtype,
                      seed=seed, device=device)

    monkeypatch.setattr(models, "ResNet50", narrow)


@pytest.mark.parametrize("flags", [[], ["--overlap", "--compress", "int8", "--error-feedback"],
                                   ["--accum", "2", "--bf16"], ["--device-data"]])
def test_train_resnet_on_the_cpu(capsys, narrow_resnet50, flags):
    assert cli_main(["train-resnet", "--device", "cpu", "--image-size", "16",
                     "--batch", "16", "--steps", "2", *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    params = sum(p.numel() for p in ResNet(**NARROW, device="cpu").parameters())
    assert lines[0].startswith(f"ResNet params: {params / 1e6:.1f}M")
    assert lines[-1].startswith("resnet50: 2 ") and "virtual ranks" in lines[-1]


def test_bench_mfu_resnet_record(capsys, monkeypatch, narrow_resnet50):
    """The workload's wiring at a cut size: one 1-step chain stands in for
    the slope timing (seconds a step on the CPU)."""
    seen = {}

    def one_chain(name, timed, flops, **kw):
        seen.update(name=name, flops=flops, s=timed(1))
        return {"metric": f"{name}_mfu", "ms_per_step": seen["s"] * 1e3, **kw["extra"]}

    monkeypatch.setattr(bench_mfu, "_chain_mfu_record", one_chain)
    assert cli_main(["bench-mfu", "--workload", "resnet", "--device", "cpu",
                     "--image-size", "16", "--classes", "10"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "resnet_mfu" and rec["batch"] == 8 and rec["image_size"] == 16
    assert rec["compute_dtype"] == "bf16" and rec["virtual_ranks"] == 8
    model = ResNet(**NARROW, device="cpu")
    assert seen["flops"] == 3 * resnet_fwd_flops(model, 16, 8) and seen["s"] > 0


def test_graft_entry_on_the_cpu(capsys):
    graft_entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh={'rows': 2, 'cols': 2}" in out
    assert "dryrun train_chain ok" in out and "int8 ring/pallas_ring" in out
    fn, args = graft_entry.entry(device="cpu")
    logits = fn(*args)
    assert logits.shape == (4, 1000) and bool(torch.isfinite(logits).all())


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet(**NARROW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["train-resnet", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["bench-mfu", "--workload", "resnet"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(4)
