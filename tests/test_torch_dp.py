"""The port's data-parallel trainer against the JAX package's, on the CPU.

The JAX ``DPTrainer`` runs on the 8-device virtual CPU mesh
(``tests/conftest.py``), the port's over 8 virtual ranks on the CPU, where
its f32 gradient average takes K1's plain version. The port carries the
JAX trainer's initial weights (``set_flat_params(get_flat_params())``) and
both see the same numpy batches (``mnist_like``), ``MLP(hidden=(32,))``:

- the MLP's logits with flax weights carried over: f32 within rtol 1e-5,
  bf16 compute within 2e-2 of max|logit|; the flax tree's leaves and the
  flat-vector order (11 layers, so ``Dense_10`` sorts before ``Dense_2``);
- ``SyntheticClassification`` batches bit-equal;
- the default f32 step, a bucketed one (``bucket_size=4096``) and one on a
  4 x 2 grid: per-step losses within rtol 1e-5, ``contributors`` exact and
  the flat parameters within rtol 2e-4, atol 2e-5 (``tests/test_train.py``'s
  tolerance), a masked rank included (``__graft_entry__.py``'s second step);
- bf16 and int8 wires, with and without error feedback, within the JAX
  package's own bands of the f32 run (``tests/test_train.py``: bf16 5e-2,
  bf16 with EF 1e-2, int8 5e-2 of max|param|) and of the JAX trainer in the
  same mode; a masked rank carries its whole contribution in its EF row;
- ``train_chain`` against the port's own steps on the same generator's
  batches; the guards and the refusals (overlap and accumulation are held
  in ``tests/test_torch_overlap.py``); ``dense_train_flops``;
  ``train-mlp`` (and its ``--profile-dir`` trace), ``bench-suite`` config 3
  and ``bench-mfu --workload mlp`` on the CPU at a tiny size.

Each JAX trainer is built once (eight builds in all).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from akka_allreduce_tpu.binder.api import flatten_pytree
from akka_allreduce_tpu.models import MLP as JMLP
from akka_allreduce_tpu.models import data as jdata
from akka_allreduce_tpu.parallel import grid_mesh as j_grid_mesh
from akka_allreduce_tpu.parallel import line_mesh as j_line_mesh
from akka_allreduce_tpu.train import DPTrainer as JDPTrainer
from akka_allreduce_tpu.utils import benchmarking as jbench
from akka_allreduce_tpu_torch import bench_mfu, bench_suite
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.binder import flatten_params
from akka_allreduce_tpu_torch.comm.allreduce import ring_allreduce_sum, ring_ef_residual
from akka_allreduce_tpu_torch.models import (
    MLP,
    SyntheticClassification,
    mlp_state_dict_from_flax,
    mnist_like,
)
from akka_allreduce_tpu_torch.ops import local_reduce as lr
from akka_allreduce_tpu_torch.parallel import grid_mesh, line_mesh
from akka_allreduce_tpu_torch.train import DPTrainer, ef_fold, ef_residual
from akka_allreduce_tpu_torch.utils import benchmarking as tbench

HIDDEN = (32,)
N = 8
STEP_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_train.py's
LOSS_RTOL = 1e-5
X0 = np.zeros((1, 28, 28, 1), np.float32)
MASK = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)  # the graft entry's step 2


def _jax(mesh, **kw):
    return JDPTrainer(JMLP(hidden=HIDDEN, classes=10), mesh, example_input=X0,
                      optimizer=optax.sgd(0.1), **kw)


def _port(init, mesh=None, **kw):
    """The port's trainer on the CPU, carrying the flat weights ``init``."""
    tt = DPTrainer(MLP(hidden=HIDDEN, device="cpu"), mesh or line_mesh(N, device="cpu"), **kw)
    tt.set_flat_params(init)
    return tt


def _batches(steps, batch=64, seed_offset=1):
    return list(jdata.mnist_like().batches(batch, steps, seed_offset=seed_offset))


def _run(trainer, batches, masks=()):
    masks = list(masks) + [None] * (len(batches) - len(masks))
    return [trainer.train_step(x, y, v) for (x, y), v in zip(batches, masks)]


def _rel_drift(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- JAX runs, each built once -------------------------------------------------


@pytest.fixture(scope="module")
def f32_run():
    """Three default f32 steps on line 8, the last with rank 7 masked."""
    jt = _jax(j_line_mesh(N))
    init = jt.get_flat_params()
    batches = _batches(3)
    hist = _run(jt, batches, [None, None, MASK])
    return {"init": init, "batches": batches, "hist": hist,
            "params": jt.get_flat_params(), "trainer": jt}


@pytest.fixture(scope="module")
def compressed_runs():
    """Three steps of each compressed mode (bf16, int8, with and without
    EF), the same batches, the same initial weights, rank 3 masked in the
    last step."""
    batches = _batches(3, seed_offset=7)
    mask = np.ones(N, np.float32)
    mask[3] = 0.0
    out = {"batches": batches, "masks": [None, None, mask]}
    for compress, ef in (("bf16", False), ("bf16", True), ("int8", False), ("int8", True)):
        jt = _jax(j_line_mesh(N), compress=compress, error_feedback=ef)
        if "init" not in out:
            out["init"] = jt.get_flat_params()
        jt.set_flat_params(out["init"])
        _run(jt, batches, out["masks"])
        out[(compress, ef)] = jt.get_flat_params()
    return out


# -- the model and its data ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_logits_match_flax(dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jm = JMLP(hidden=(48, 24), classes=10, compute_dtype=jdt)
    params = jm.init(jax.random.PRNGKey(3), X0)
    x = next(jdata.mnist_like(seed=2).batches(16, 1))[0]
    want = np.asarray(jm.apply(params, x))
    tm = MLP(hidden=(48, 24), compute_dtype=tdt, device="cpu")
    tm.load_state_dict(mlp_state_dict_from_flax(jax.device_get(params)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (16, 10)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_flat_order_and_flax_leaves():
    """Eleven layers: ``Dense_10`` sorts before ``Dense_2`` in both packages."""
    jm = JMLP(hidden=(4,) * 10, classes=3)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), X0))
    tm = MLP(hidden=(4,) * 10, classes=3, device="cpu")
    tm.load_state_dict(mlp_state_dict_from_flax(params))
    np.testing.assert_array_equal(flatten_params(tm)[0], flatten_pytree(params)[0])
    inner = dict(params["params"])
    with pytest.raises(ValueError, match="no counterpart"):
        mlp_state_dict_from_flax({**inner, "Conv_0": {"kernel": np.zeros(3)}})
    del inner["Dense_4"]
    with pytest.raises(ValueError, match="lacks leaves"):
        mlp_state_dict_from_flax(inner)


@pytest.mark.parametrize("shape,classes,seed", [((28, 28, 1), 10, 0), ((5, 3), 4, 9)])
def test_synthetic_classification_batches_bit_equal(shape, classes, seed):
    ours = SyntheticClassification(shape, classes, seed=seed)
    theirs = jdata.SyntheticClassification(shape, classes, seed=seed)
    np.testing.assert_array_equal(ours.templates, theirs.templates)
    for (xa, ya), (xb, yb) in zip(ours.batches(12, 3, seed_offset=5),
                                  theirs.batches(12, 3, seed_offset=5)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert xa.dtype == np.float32 and ya.dtype == np.int32


def test_device_sampler_draws_the_same_task():
    ds = mnist_like()
    sample = ds.device_sampler()
    x, y = sample(torch.Generator().manual_seed(4), 256)
    x2, y2 = sample(torch.Generator().manual_seed(4), 256)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert x.shape == (256, 28, 28, 1) and x.dtype == torch.float32 and y.dtype == torch.int64
    noise = (x - torch.from_numpy(ds.templates)[y]) / ds.noise
    assert abs(float(noise.std()) - 1.0) < 0.02 and abs(float(noise.mean())) < 0.02


# -- f32 parity ------------------------------------------------------------------------


def test_default_f32_steps_match_jax(f32_run):
    tt = _port(f32_run["init"])
    hist = _run(tt, f32_run["batches"], [None, None, MASK])
    for a, b in zip(hist, f32_run["hist"]):
        np.testing.assert_allclose(a.loss, b.loss, rtol=LOSS_RTOL)
        assert a.contributors == b.contributors
    assert [h.contributors for h in hist] == [8.0, 8.0, 7.0]
    np.testing.assert_allclose(tt.get_flat_params(), f32_run["params"], **STEP_TOL)


@pytest.mark.parametrize("layout", ["bucket4096", "grid4x2"])
def test_other_f32_layouts_match_jax(layout):
    if layout == "bucket4096":
        jt = _jax(j_line_mesh(N), bucket_size=4096)
        tt = _port(jt.get_flat_params(), bucket_size=4096)
    else:
        jt = _jax(j_grid_mesh(4, 2))
        tt = _port(jt.get_flat_params(), grid_mesh(4, 2, device="cpu"))
    batches = _batches(2, batch=16, seed_offset=2)
    for a, b in zip(_run(tt, batches, [None, MASK]), _run(jt, batches, [None, MASK])):
        np.testing.assert_allclose(a.loss, b.loss, rtol=LOSS_RTOL)
        assert a.contributors == b.contributors
    np.testing.assert_allclose(tt.get_flat_params(), jt.get_flat_params(), **STEP_TOL)


def test_f32_sync_is_k1s_function(f32_run):
    """The f32 sync is ``masked_average`` of the rank stack, so the update is
    the parameters minus lr times K1's plain version on that stack."""
    tt = _port(f32_run["init"])
    x, y = f32_run["batches"][0]
    xd, yd = tt._place_batch(x, y)
    stack, losses = tt.rank_gradients(xd, yd)
    assert stack.shape == (N, tt.param_count) and losses.shape == (N,)
    v = torch.from_numpy(MASK)
    avg, count = lr.masked_average_reference(stack, v)
    got, got_count = tt.sync(stack, v)
    assert torch.equal(got, avg) and float(got_count) == float(count) == 7.0
    before = torch.from_numpy(tt.get_flat_params())
    tt.apply_gradients(avg)
    # SGD's update may fuse the multiply-add: one rounding apart at most
    np.testing.assert_allclose(tt.get_flat_params(), (before - 0.1 * avg).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_flat_params_round_trip_across_packages(f32_run):
    tt = _port(f32_run["init"])
    _run(tt, f32_run["batches"][:1])
    jt = f32_run["trainer"]  # no other test reads its parameters
    jt.set_flat_params(tt.get_flat_params())
    np.testing.assert_array_equal(jt.get_flat_params(), tt.get_flat_params())
    tt.set_flat_params(f32_run["params"])
    jt.set_flat_params(f32_run["params"])
    np.testing.assert_array_equal(tt.get_flat_params(), f32_run["params"])
    x, y = next(jdata.mnist_like().batches(256, 1, seed_offset=99))
    assert tt.accuracy(x, y) == jt.accuracy(x, y)


# -- compressed syncs ---------------------------------------------------------------


@pytest.mark.parametrize("compress,ef,band", [("bf16", False, 5e-2), ("bf16", True, 1e-2),
                                              ("int8", False, 5e-2), ("int8", True, 5e-2)])
def test_compressed_steps_within_the_jax_bands(compressed_runs, compress, ef, band):
    r = compressed_runs
    tt = _port(r["init"], compress=compress, error_feedback=ef)
    hist = _run(tt, r["batches"], r["masks"])
    assert [h.contributors for h in hist] == [8.0, 8.0, 7.0]
    assert all(np.isfinite(h.loss) for h in hist)
    f32 = _port(r["init"])
    _run(f32, r["batches"], r["masks"])
    got = tt.get_flat_params()
    assert _rel_drift(got, f32.get_flat_params()) < band
    assert _rel_drift(got, r[(compress, ef)]) < band
    if ef:
        assert float(tt._ef.abs().max()) > 0  # the residual is live


@pytest.mark.parametrize("compress,ratio", [("bf16", 50), ("int8", 10)])  # test_train.py's
def test_masked_rank_carries_its_whole_contribution(compress, ratio):
    tt = DPTrainer(MLP(hidden=HIDDEN, device="cpu"), line_mesh(N, device="cpu"),
                   compress=compress, error_feedback=True)
    x, y = next(mnist_like().batches(64, 1))
    valid = np.ones(N, np.float32)
    valid[3] = 0.0
    assert tt.train_step(x, y, valid).contributors == 7.0
    norms = tt._ef.norm(dim=1)
    assert float(norms[3]) > ratio * float(torch.cat([norms[:3], norms[4:]]).max())
    if compress == "int8":  # the band narrows with the width; the formula does not
        stack, _ = tt.rank_gradients(*tt._place_batch(x, y))
        v = torch.from_numpy(valid)
        c = ef_fold(stack, tt._ef)
        tt.sync(stack, v)
        _, hop = ring_allreduce_sum(c * v[:, None], compress="int8", return_residual=True)
        assert torch.equal(tt._ef, ring_ef_residual(c, v, hop))


def test_int8_ef_residual_matches_jax_at_width():
    """At hidden (256, 128) the masked rank's int8 residual row is under 10x
    any other's in both packages (the per-hop errors grow with the
    segments' max-abs scales); the port's residual is the JAX trainer's."""
    hidden = (256, 128)
    jt = JDPTrainer(JMLP(hidden=hidden, classes=10), j_line_mesh(N), example_input=X0,
                    optimizer=optax.sgd(0.1), compress="int8", error_feedback=True)
    tt = DPTrainer(MLP(hidden=hidden, device="cpu"), line_mesh(N, device="cpu"),
                   compress="int8", error_feedback=True)
    tt.set_flat_params(jt.get_flat_params())
    x, y = next(mnist_like().batches(64, 1))
    valid = np.ones(N, np.float32)
    valid[3] = 0.0
    jt.train_step(x, y, valid)
    tt.train_step(x, y, valid)
    want, got = np.asarray(jt._ef), tt._ef.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    ratios = []
    for ef in (want, got):
        norms = np.linalg.norm(ef, axis=1)
        ratios.append(norms[3] / np.delete(norms, 3).max())
    np.testing.assert_allclose(ratios[1], ratios[0], rtol=1e-4)
    assert ratios[0] < 10


def test_ef_helpers_mirror_the_jax_formulas():
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    v = torch.tensor([1.0, 0.0, 1.0, 1.0])
    e = ef_residual(c, v)
    sent = (c * v[:, None]).to(torch.bfloat16).float()
    assert torch.equal(e, c - sent) and torch.equal(e[1], c[1])
    assert torch.equal(ef_fold(c, e), c + e) and ef_fold(c, None) is c
    with pytest.raises(ValueError, match="per-hop"):
        ef_residual(c, v, compress="int8")
    total, hop = ring_allreduce_sum(c * v[:, None], compress="int8", return_residual=True)
    assert all(torch.equal(total[r], total[0]) for r in range(4))
    res = ring_ef_residual(c, v, hop)
    assert torch.equal(res, c * (1 - v)[:, None] + hop)


# -- chains, guards, refusals ---------------------------------------------------------


def test_train_chain_equals_stepwise_on_the_same_batches():
    a = DPTrainer(MLP(hidden=HIDDEN, seed=5, device="cpu"), line_mesh(N, device="cpu"))
    b = DPTrainer(MLP(hidden=HIDDEN, seed=5, device="cpu"), line_mesh(N, device="cpu"))
    sampler = mnist_like().device_sampler()
    chain = a.train_chain(sampler, 3, 4, valid=MASK, seed=2)
    gen = torch.Generator().manual_seed(2 * 2**32)
    steps = [b.train_step(*sampler(gen, N * 4), MASK) for _ in range(3)]
    assert [m.loss for m in chain] == [m.loss for m in steps]
    assert [m.contributors for m in chain] == [7.0] * 3 and a.step_num == 3
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())
    losses, counts = a.train_chain(sampler, 2, 4, fetch_metrics=False)
    assert losses.shape == counts.shape == (2,) and a.step_num == 5


def test_guards_and_refusals():
    mesh = line_mesh(N, device="cpu")

    def make(m=mesh, **kw):
        return DPTrainer(MLP(hidden=(4,), device="cpu"), m, **kw)

    with pytest.raises(ValueError, match="compress"):
        make(compress="fp4")
    with pytest.raises(ValueError, match="ONE mesh axis"):
        make(grid_mesh(2, 4, device="cpu"), compress="int8")
    with pytest.raises(ValueError, match="error_feedback"):
        make(error_feedback=True)
    with pytest.raises(ValueError, match="bucket_size"):
        make(overlap=True, bucket_size=100)
    with pytest.raises(NotImplementedError, match="overlap"):
        make(overlap=True).train_step_accum(np.zeros((16, 784), np.float32), np.zeros(16), 2)
    t = make()
    with pytest.raises(ValueError, match="divisible"):
        t.train_step_accum(np.zeros((8, 784), np.float32), np.zeros(8), 2)
    x, y = next(mnist_like().batches(60, 1))
    with pytest.raises(ValueError, match="divisible"):
        t.train_step(x, y)
    x, y = next(mnist_like().batches(64, 1))
    with pytest.raises(ValueError, match="valid"):
        t.train_step(x, y, valid=[1.0, 0.0])


def test_no_cuda_and_no_cpu_asked_for_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = MLP(hidden=(4,), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MLP(hidden=(4,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DPTrainer(model, line_mesh(N))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DPTrainer(model, line_mesh(N, device="cpu"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_suite.config3_mlp_step()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["train-mlp", "--steps", "1"])


# -- entry points on the CPU --------------------------------------------------------------


def test_dense_train_flops_matches_jax():
    for args in ((101_770, 128), (5_824_522, 64)):
        assert tbench.dense_train_flops(*args) == jbench.dense_train_flops(*args)
        assert (tbench.dense_train_flops(*args, remat=True)
                == jbench.dense_train_flops(*args, remat=True))


@pytest.mark.parametrize("extra", [[], ["--device-data", "--compress", "int8",
                                        "--error-feedback"],
                                   ["--mesh", "grid", "--compress", "bf16", "--bucket",
                                    "1000", "--bf16"]])
def test_train_mlp_on_the_cpu(capsys, tmp_path, extra):
    out = tmp_path / "m.jsonl"
    assert cli_main(["train-mlp", "--device", "cpu", "--hidden", "16", "--steps", "4",
                     "--batch", "16", "--metrics-out", str(out), *extra]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("MLP params: ") and "virtual ranks" in lines[-1]
    events = [json.loads(line) for line in out.read_text().splitlines()]
    steps = [e for e in events if e["kind"] == "train_step"]
    assert len(steps) == 4 and all(e["contributors"] == 8.0 for e in steps)


def test_train_mlp_profile_dir_writes_a_trace(capsys, tmp_path):
    """``--profile-dir`` runs the step loop under ``torch.profiler`` and
    writes its Chrome trace there, with the steps' ops in it."""
    prof = tmp_path / "prof"
    assert cli_main(["train-mlp", "--device", "cpu", "--hidden", "16", "--steps", "2",
                     "--batch", "16", "--profile-dir", str(prof)]) == 0
    (trace,) = prof.glob("*.json")
    assert f"profile trace written to {trace}" in capsys.readouterr().out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_config3_record_on_the_cpu():
    rec = bench_suite.config3_mlp_step(steps=2, device="cpu", target_signal_s=None,
                                       chain_trips=(1, 3), outer=1)
    assert rec["config"] == 3 and rec["name"] == "mlp_mnist_dp_sgd"
    assert rec["params"] == 101_770 and rec["global_batch"] == 128
    assert rec["virtual_workers"] == 8 and rec["path"] == "plain_masked_average"
    assert rec["device"] == "cpu" and rec["power_limit"] is None and rec["mfu"] is None
    # host steps: one warm-up and steps + 2 timed; chains: 1 + 3 warm-up, 1 + 3 timed
    assert rec["steps_taken"] == 5 + 8
    assert rec["step_ms"] > 0 and np.isfinite(rec["device_step_ms"])


def test_bench_mfu_mlp_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(bench_mfu, "SIGNAL_S", 0.05)  # 3 s of signal is for the card
    assert cli_main(["bench-mfu", "--workload", "mlp", "--device", "cpu", "--hidden",
                     "16", "--batch", "16"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"].startswith("mlp_mfu") and rec["value"] is None
    assert rec["hidden"] == [16] and rec["batch"] == 16 and rec["virtual_ranks"] == 8
    assert rec["device"] == "cpu" and rec["ms_per_step"] > 0


def test_cpu_dp_steps_count_no_launches():
    """Every sync on the CPU takes a plain version: no kernel launch."""
    before = dict(lr.LAUNCHES)
    x, y = next(mnist_like().batches(16, 1))
    for compress in (None, "bf16", "int8"):
        t = DPTrainer(MLP(hidden=(4,), device="cpu"), line_mesh(N, device="cpu"),
                      compress=compress)
        t.train_step(x, y, MASK)
    assert lr.LAUNCHES == before
