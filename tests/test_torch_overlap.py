"""The rest of the port's ``DPTrainer`` against the JAX package's, on the CPU:
``overlap`` (a sync per parameter leaf inside the backward),
``train_step_accum`` and the replica checks of ``utils/verify.py``.

The JAX trainers run on the 8-device virtual CPU mesh (``tests/conftest.py``),
the port's over 8 virtual ranks on the CPU (K1's plain version in f32), with
the JAX trainer's initial weights carried over and the same ``mnist_like``
batches, ``MLP(hidden=(32,))``:

- overlap in f32 against JAX ``DPTrainer(overlap=True)`` over six steps, rank
  7 masked in the third: losses within rtol 1e-5, contributors exact, the
  flat parameters within rtol 2e-4, atol 2e-5; the port's own fused and
  overlapped steps within ``tests/test_overlap.py``'s 1e-6 (losses) and
  rtol 1e-5, atol 1e-7 (parameters); bf16, int8 and bf16 with EF overlapped
  within that file's bands of the f32 run (1e-2, 5e-2, 2e-2 of max|param|);
  a masked rank's EF row more than 10x any other's in bf16 and int8, and
  the int8 residual of every leaf equal to ``ring_ef_residual`` of its
  cotangent stack, bit for bit; ``train_chain`` under overlap; the guards;
- accumulation against JAX ``train_step_accum`` (two steps of 2
  microbatches, the second with rank 7 masked) in the same band, and
  ``tests/test_train.py``'s accumulation checks on the port alone, each in
  the band it uses there; one sync an accumulated step;
- every configuration ``tests/test_vma_replication.py`` sweeps: the rows a
  bf16 or int8 sync hands the ranks compared bit for bit (more than zero
  pairs), none for K1's shared buffer; a planted divergence caught;
- ``train-mlp --overlap`` and ``--accum`` on the CPU.

Two JAX trainers are built in all.
"""

from __future__ import annotations

import numpy as np
import optax
import pytest
import torch

from akka_allreduce_tpu.models import MLP as JMLP
from akka_allreduce_tpu.models import data as jdata
from akka_allreduce_tpu.parallel import line_mesh as j_line_mesh
from akka_allreduce_tpu.train import DPTrainer as JDPTrainer
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from chip_smoke import check_overlap_ef, watch_leaf_syncs
from akka_allreduce_tpu_torch.comm.allreduce import (
    backward_psum_sync,
    backward_ring_sync,
    backward_sync_ef,
    ring_allreduce_sum,
    ring_ef_residual,
)
from akka_allreduce_tpu_torch.models import MLP, mnist_like
from akka_allreduce_tpu_torch.ops import local_reduce as lr
from akka_allreduce_tpu_torch.parallel import grid_mesh, line_mesh
from akka_allreduce_tpu_torch.train import DPTrainer
from akka_allreduce_tpu_torch.train import trainer as trainer_mod
from akka_allreduce_tpu_torch.utils import (
    assert_replica_consistent,
    assert_trainer_replicas,
    record_replicas,
)

N = 8
HIDDEN = (32,)
X0 = np.zeros((1, 28, 28, 1), np.float32)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_train.py's
MASK7 = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
MASK3 = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
STEPS = 6


def _jax(**kw):
    return JDPTrainer(JMLP(hidden=HIDDEN, classes=10), j_line_mesh(N), example_input=X0,
                      optimizer=optax.sgd(0.1), **kw)


def _port(init=None, **kw):
    tt = DPTrainer(MLP(hidden=HIDDEN, device="cpu"), line_mesh(N, device="cpu"), **kw)
    if init is not None:
        tt.set_flat_params(init)
    return tt


def _masks(steps, at=2, mask=MASK7):
    return [mask if i == at else None for i in range(steps)]


def _run(trainer, batches, masks):
    return [trainer.train_step(x, y, v) for (x, y), v in zip(batches, masks)]


def _rel_drift(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def overlap_run():
    """Six JAX overlapped f32 steps, rank 7 masked in the third."""
    jt = _jax(overlap=True)
    init = jt.get_flat_params()
    batches = list(jdata.mnist_like().batches(64, STEPS))
    hist = _run(jt, batches, _masks(STEPS))
    return {"init": init, "batches": batches, "hist": hist, "params": jt.get_flat_params()}


@pytest.fixture(scope="module")
def port_fused(overlap_run):
    """The port's fused f32 trainer over the same steps."""
    tt = _port(overlap_run["init"])
    hist = _run(tt, overlap_run["batches"], _masks(STEPS))
    return hist, tt.get_flat_params()


# -- overlap ----------------------------------------------------------------------


def test_overlap_f32_matches_jax(overlap_run):
    tt = _port(overlap_run["init"], overlap=True)
    hist = _run(tt, overlap_run["batches"], _masks(STEPS))
    for a, b in zip(hist, overlap_run["hist"]):
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
        assert a.contributors == b.contributors
    assert [h.contributors for h in hist] == [8.0, 8.0, 7.0, 8.0, 8.0, 8.0]
    np.testing.assert_allclose(tt.get_flat_params(), overlap_run["params"], **STEP_TOL)


def test_overlap_matches_the_fused_step(overlap_run, port_fused):
    """tests/test_overlap.py::test_matches_default_step on the port."""
    tt = _port(overlap_run["init"], overlap=True)
    hist = _run(tt, overlap_run["batches"], _masks(STEPS))
    for a, b in zip(hist, port_fused[0]):
        assert a.contributors == b.contributors
        assert abs(a.loss - b.loss) < 1e-6
    np.testing.assert_allclose(tt.get_flat_params(), port_fused[1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("compress,ef,band", [("bf16", False, 1e-2), ("int8", False, 5e-2),
                                              ("bf16", True, 2e-2)])
def test_overlap_compressed_within_the_jax_bands(overlap_run, compress, ef, band):
    """tests/test_overlap.py's bands of the f32 run: bf16 (1e-2), int8 (5e-2,
    a masked rank), bf16 with EF (2e-2)."""
    tt = _port(overlap_run["init"], overlap=True, compress=compress, error_feedback=ef)
    hist = _run(tt, overlap_run["batches"], _masks(STEPS))
    assert [h.contributors for h in hist] == [h.contributors for h in overlap_run["hist"]]
    assert all(np.isfinite(h.loss) for h in hist)
    assert _rel_drift(tt.get_flat_params(), overlap_run["params"]) < band


@pytest.mark.parametrize("compress", ["bf16", "int8"])
def test_overlap_ef_masked_rank_carries_its_contribution(compress):
    """tests/test_overlap.py:139-162; for int8 every leaf's new residual is
    ``ring_ef_residual(c, v, hop errors)`` of its folded cotangent stack."""
    tt = _port(overlap=True, compress=compress, error_feedback=True)
    x, y = next(mnist_like().batches(64, 1))
    with watch_leaf_syncs(tt) as seen:
        assert tt.train_step(x, y, MASK3).contributors == 7.0
    norms = tt._ef.norm(dim=1)
    assert float(norms[3]) > 10 * float(torch.cat([norms[:3], norms[4:]]).max())
    assert len(seen["ct"]) == len(tt._params)
    check_overlap_ef(seen, torch.from_numpy(MASK3), compress, f"{compress} EF overlap")
    hist = tt.train(mnist_like().batches(64, 3, seed_offset=2))
    assert np.isfinite(hist[-1].loss) and float(tt._ef.abs().max()) > 0


def test_overlap_train_chain_works():
    tt = _port(overlap=True)
    hist = tt.train_chain(mnist_like().device_sampler(), 4, 4)
    assert len(hist) == 4 and hist[-1].loss < hist[0].loss


def test_overlap_guards():
    with pytest.raises(ValueError, match="overlap"):
        _port(overlap=True, bucket_size=1000)
    tt = _port(overlap=True)
    x, y = next(mnist_like().batches(64, 1))
    with pytest.raises(NotImplementedError, match="overlap"):
        tt.train_step_accum(x, y, accum_steps=2)
    with pytest.raises(ValueError, match="ONE mesh axis"):
        backward_ring_sync(grid_mesh(2, 4, device="cpu"))
    with pytest.raises(ValueError, match="compress mode"):
        backward_ring_sync(line_mesh(N, device="cpu"), compress=None)


@pytest.mark.parametrize("kind", ["psum", "psum_bf16", "ef_bf16", "ring_int8", "ring_int8_ef"])
def test_leaf_sync_returns_the_masked_average(kind):
    """Each per-leaf sync on a known ``(n, 3, 5)`` cotangent stack: the
    broadcast forward and the masked average (and residual) of the stack in
    its backward."""
    mesh = line_mesh(N, device="cpu")
    rng = np.random.default_rng(1)
    ct = torch.from_numpy(rng.standard_normal((N, 3, 5)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((N, 3, 5)).astype(np.float32) * 1e-2)
    e0 = e.clone()
    v = torch.from_numpy(MASK3)
    p = torch.zeros(3, 5, requires_grad=True)
    sync = {"psum": backward_psum_sync(mesh), "psum_bf16": backward_psum_sync(mesh, None,
                                                                              torch.bfloat16),
            "ef_bf16": backward_sync_ef(mesh, None, torch.bfloat16),
            "ring_int8": backward_ring_sync(mesh),
            "ring_int8_ef": backward_ring_sync(mesh, error_feedback=True)}[kind]
    out = sync(p, e, v) if "ef" in kind else sync(p, v)
    assert out.shape == (N, 3, 5) and torch.equal(out[5], p.detach())
    out.backward(ct)
    c = (ct + e0 if "ef" in kind else ct).reshape(N, -1)
    m = c * v[:, None]
    if kind == "psum":
        want = lr.masked_average_reference(c, v)[0]
    elif "bf16" in kind:
        want = m.to(torch.bfloat16).float().sum(0).to(torch.bfloat16).float() / 7.0
    else:
        total, hop = ring_allreduce_sum(m, compress="int8", return_residual=True)
        want = total[0] / 7.0
    np.testing.assert_allclose(p.grad.reshape(-1).numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    if kind == "ef_bf16":
        assert torch.equal(e.reshape(N, -1), c - m.to(torch.bfloat16).float())
    if kind == "ring_int8_ef":
        assert torch.equal(e.reshape(N, -1), ring_ef_residual(c, v, hop))


# -- gradient accumulation ---------------------------------------------------------


def test_accum_matches_jax():
    jt = _jax()
    init = jt.get_flat_params()
    tt = _port(init)
    batches = list(jdata.mnist_like().batches(64, 2, seed_offset=3))
    for (x, y), v in zip(batches, [None, MASK7]):
        a = tt.train_step_accum(x, y, 2, v)
        b = jt.train_step_accum(x, y, 2, v)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
        assert a.contributors == b.contributors
    assert a.contributors == 7.0
    np.testing.assert_allclose(tt.get_flat_params(), jt.get_flat_params(), **STEP_TOL)


@pytest.mark.parametrize("accum,bucket", [(4, None), (2, 4096)])
def test_accum_matches_the_full_batch_step(accum, bucket):
    """tests/test_train.py:111 and :122: the mean of equal microbatch means
    is the full-batch mean."""
    a, b = _port(bucket_size=bucket), _port(bucket_size=bucket)
    x, y = next(mnist_like().batches(64, 1))
    m_full, m_acc = a.train_step(x, y), b.train_step_accum(x, y, accum_steps=accum)
    assert abs(m_full.loss - m_acc.loss) < 1e-5
    np.testing.assert_allclose(a.get_flat_params(), b.get_flat_params(), atol=2e-5)


def test_accum_runs_one_sync_a_step(monkeypatch):
    """K1 (here its plain version) once an accumulated f32 step."""
    calls = []
    monkeypatch.setattr(trainer_mod, "masked_average",
                        lambda s, v: calls.append(s.shape) or lr.masked_average(s, v))
    tt = _port()
    x, y = next(mnist_like().batches(64, 1))
    tt.train_step_accum(x, y, 4)
    assert calls == [(N, tt.param_count)]


@pytest.mark.parametrize("compress,bucket", [(None, None), ("bf16", None), ("bf16", 1000)])
def test_accum_masked_and_compressed_paths(compress, bucket):
    """tests/test_train.py:135, :262 and :274: contributors and a finite loss
    under a masked rank, the bf16 wire and bf16 with buckets."""
    tt = _port(compress=compress, bucket_size=bucket)
    x, y = next(mnist_like().batches(32, 1))
    valid = np.ones(N, np.float32)
    valid[0 if compress is None else 5] = 0.0
    m = tt.train_step_accum(x, y, accum_steps=2, valid=valid)
    assert m.contributors == 7.0 and np.isfinite(m.loss)


def test_accum_guards():
    """tests/test_train.py:144, plus accum_steps < 1 and accum_steps 1."""
    tt = _port()
    x, y = next(mnist_like().batches(40, 1))
    with pytest.raises(ValueError, match="divisible"):
        tt.train_step_accum(x, y, accum_steps=3)
    with pytest.raises(ValueError, match=">= 1"):
        tt.train_step_accum(x, y, accum_steps=0)
    a, b = _port(), _port()
    x, y = next(mnist_like().batches(64, 1))
    assert a.train_step_accum(x, y, 1) == b.train_step(x, y)
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())


def test_accum_ef_matches_the_plain_ef_step():
    """tests/test_train.py:348-372: EF over the accumulated mean gradient
    against EF over the full-batch gradient, rank 5 masked in one step."""
    t_step, t_accum = _port(compress="bf16", error_feedback=True), _port(
        compress="bf16", error_feedback=True)
    valid = np.ones(N, np.float32)
    valid[5] = 0.0
    for i, (x, y) in enumerate(mnist_like().batches(64, 4)):
        v = valid if i == 2 else None
        assert (t_step.train_step(x, y, v).contributors
                == t_accum.train_step_accum(x, y, accum_steps=2, valid=v).contributors)
    np.testing.assert_allclose(t_accum.get_flat_params(), t_step.get_flat_params(),
                               rtol=1e-4, atol=1e-5)
    assert float((t_accum._ef - t_step._ef).abs().max()) < 1e-3


def test_int8_accum_close_to_f32_accum():
    """tests/test_train.py:479-497: the int8 ring (per-hop EF off) on the
    accumulated gradient within 0.1 of max|param| of the f32 run."""
    t8, tf = _port(compress="int8"), _port()
    for i, (x, y) in enumerate(mnist_like().batches(64, 6)):
        v = MASK3 if i == 2 else None
        m8, mf = t8.train_step_accum(x, y, 2, v), tf.train_step_accum(x, y, 2, v)
        assert m8.contributors == mf.contributors and np.isfinite(m8.loss)
    assert _rel_drift(t8.get_flat_params(), tf.get_flat_params()) < 0.1


def test_int8_ef_accum_residual_is_the_rings():
    """Under accumulation the int8 residual is ``ring_ef_residual`` of the
    accumulated mean gradient (the microbatches of each rank's contiguous
    rows), bit for bit."""
    tt = _port(compress="int8", error_feedback=True)
    x, y = next(mnist_like().batches(64, 1))
    xd, yd = tt._place_batch(x, y)
    xs, ys = xd.reshape(N, 2, 4, *xd.shape[1:]), yd.reshape(N, 2, 4)
    c = tt._rank_stack(xs[:, 0], ys[:, 0])[0].add_(tt._rank_stack(xs[:, 1], ys[:, 1])[0]).div_(2)
    v = torch.from_numpy(MASK3)
    _, hop = ring_allreduce_sum(c * v[:, None], compress="int8", return_residual=True)
    assert tt.train_step_accum(x, y, 2, MASK3).contributors == 7.0
    assert torch.equal(tt._ef, ring_ef_residual(c, v, hop))


# -- replica checks ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(compress="int8"),
    dict(compress="int8", error_feedback=True),
    dict(compress="bf16", bucket_size=1000),
    dict(overlap=True),
    dict(overlap=True, compress="bf16"),
    dict(overlap=True, compress="bf16", error_feedback=True),
    dict(overlap=True, compress="int8"),
    dict(overlap=True, compress="int8", error_feedback=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_sync_rows_stay_replicated(kw):
    """tests/test_vma_replication.py:53-66's configurations: every row a
    sync hands the ranks equals rank 0's; K1's f32 syncs hand out none."""
    tt = _port(**kw)
    record_replicas(tt)
    for i, (x, y) in enumerate(mnist_like().batches(32, 2)):
        tt.train_step(x, y, MASK3 if i == 1 else None)
    pairs = assert_trainer_replicas(tt)
    if kw.get("compress") is None:
        assert pairs == 0 and tt._replica_log == {}
    else:
        per_sync = N - 1
        syncs = len(tt._params) if kw.get("overlap") else 1
        syncs += kw.get("compress") == "bf16" and not kw.get("overlap")  # the counts
        assert pairs == per_sync * syncs > 0


def test_divergence_is_caught():
    """tests/test_vma_replication.py:79: a planted divergence must fail."""
    rows = torch.zeros(N, 4, 3)
    assert assert_replica_consistent({"w": rows}) == N - 1
    rows[3, 1, 2] = 1.0
    with pytest.raises(AssertionError, match=r"replica divergence in tree/w: rank 3"):
        assert_replica_consistent({"w": rows})
    tt = _port(compress="bf16")
    with pytest.raises(ValueError, match="record_replicas"):
        assert_trainer_replicas(tt)
    record_replicas(tt)
    tt.train_step(*next(mnist_like().batches(16, 1)))
    tt._replica_log["grad_sum"][5, 0] += 1.0
    with pytest.raises(AssertionError, match="rank 5"):
        assert_trainer_replicas(tt)


# -- the CLI ------------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [["--overlap"], ["--accum", "2"],
                                   ["--overlap", "--compress", "int8", "--error-feedback"]])
def test_train_mlp_overlap_and_accum(capsys, flags):
    assert cli_main(["train-mlp", "--device", "cpu", "--hidden", "16", "--steps", "3",
                     "--batch", "16", *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("MLP params: ") and "3 steps over 8 virtual ranks" in lines[-1]


def test_train_mlp_refuses_accum_with_device_data(capsys):
    with pytest.raises(SystemExit):
        cli_main(["train-mlp", "--device", "cpu", "--accum", "2", "--device-data"])
    assert "--device-data" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli_main(["train-mlp", "--device", "cpu", "--accum", "0"])
