"""The port's ZeRO-1 trainer against the JAX package's, on the CPU.

The JAX ``Zero1DPTrainer`` runs on the 8-device virtual CPU mesh
(``tests/conftest.py``), the port's over 8 virtual ranks on the CPU (its f32
reduce-scatter through K1's plain version). The port carries the JAX
trainer's initial weights (``set_flat_params(get_flat_params())``, the
``ravel_pytree`` order) and both see the same ``mnist_like`` batches,
``MLP(hidden=(32,))``:

- f32 SGD and Adam, three steps, the third with ranks 3 and 6 masked:
  losses within 1e-5 and the flat weights within atol 3e-5
  (``tests/test_zero1.py``'s tolerance) after every step, contributors
  exact;
- bf16 with error feedback (Adam), three steps, rank 3 masked in the last:
  within ``tests/test_zero1.py``'s bf16 band (losses 5e-2, weights 5e-2 of
  max|w|), and the port's residual equal, bit for bit, to its formula
  ``e' = c - bf16(c·v)``; a masked rank banks its whole gradient;
- the port's Zero1 equal to the port's ``DPTrainer`` (f32 SGD), bit for bit;
- the v2 checkpoint form restored over 8 -> 4 ranks (weights and optimizer
  state equal, the residual's sum kept), and the JAX trainer's delta store
  restored into the port's trainer and the port's into the JAX trainer;
- the guards: one mesh axis, bf16 only, EF needs bf16, a newer format
  refused, a nonzero residual into a trainer without EF warned about, a
  missing one zeroed.

Each JAX trainer is built once (three builds for the runs, one restore
target).
"""

from __future__ import annotations

import logging

import numpy as np
import optax
import pytest
import torch

from akka_allreduce_tpu.models import MLP as JMLP
from akka_allreduce_tpu.models import data as jdata
from akka_allreduce_tpu.parallel import line_mesh as j_line_mesh
from akka_allreduce_tpu.train import DeltaCheckpointer as JDeltaCheckpointer
from akka_allreduce_tpu.train import Zero1DPTrainer as JZero1DPTrainer
from akka_allreduce_tpu_torch.binder import flatten_params
from akka_allreduce_tpu_torch.models import MLP
from akka_allreduce_tpu_torch.parallel import grid_mesh, line_mesh
from akka_allreduce_tpu_torch.train import (
    DeltaCheckpointer,
    DPTrainer,
    Snapshot,
    TrainerCheckpointer,
    Zero1DPTrainer,
    ef_residual,
)
from akka_allreduce_tpu_torch.train.checkpoint import tree_items

HIDDEN = (32,)
N = 8
ATOL = 3e-5  # tests/test_zero1.py's
LOSS_TOL = 1e-5
BF16_BAND = 5e-2  # tests/test_zero1.py::test_zero1_bf16_wire_close_to_f32
X0 = np.zeros((1, 28, 28, 1), np.float32)
MASK36 = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)
MASK3 = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
OPTS = {"sgd": (optax.sgd(0.1), lambda ps: torch.optim.SGD(ps, lr=0.1)),
        "adam": (optax.adam(1e-3), lambda ps: torch.optim.Adam(ps, lr=1e-3))}


def _batches(steps, seed_offset=1):
    return list(jdata.mnist_like().batches(32, steps, seed_offset=seed_offset))


def _jax(opt, **kw):
    return JZero1DPTrainer(JMLP(hidden=HIDDEN, classes=10), j_line_mesh(N), example_input=X0,
                           optimizer=OPTS[opt][0], seed=0, **kw)


def _port(opt, init, n=N, **kw):
    kw.setdefault("optimizer", OPTS[opt][1])
    t = Zero1DPTrainer(MLP(hidden=HIDDEN, device="cpu"), line_mesh(n, device="cpu"), **kw)
    t.set_flat_params(init)
    return t


def _run(trainer, batches, masks):
    out = []
    for (x, y), v in zip(batches, masks):
        m = trainer.train_step(x, y, v)
        out.append((m.loss, m.contributors, trainer.get_flat_params()))
    return out


@pytest.fixture(scope="module")
def f32_runs():
    """Three steps of each optimizer, the last with ranks 3 and 6 masked."""
    batches = _batches(3)
    masks = [None, None, MASK36]
    out = {"batches": batches, "masks": masks}
    for opt in OPTS:
        jt = _jax(opt)
        init = jt.get_flat_params()
        out[opt] = {"init": init, "hist": _run(jt, batches, masks), "trainer": jt}
    return out


@pytest.fixture(scope="module")
def bf16_ef_run():
    batches = _batches(3, seed_offset=5)
    masks = [None, None, MASK3]
    jt = _jax("adam", compress="bf16", error_feedback=True)
    init = jt.get_flat_params()
    return {"batches": batches, "masks": masks, "init": init,
            "hist": _run(jt, batches, masks), "ef": np.asarray(jt._ef)}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_f32_steps_match_jax(f32_runs, opt):
    run = f32_runs[opt]
    tt = _port(opt, run["init"])
    got = _run(tt, f32_runs["batches"], f32_runs["masks"])
    for i, ((jl, jc, jp), (tl, tc, tp)) in enumerate(zip(run["hist"], got)):
        assert abs(jl - tl) < LOSS_TOL, (i, jl, tl)
        assert jc == tc == (6.0 if i == 2 else 8.0)
        np.testing.assert_allclose(tp, jp, atol=ATOL, err_msg=f"step {i}")


def test_bf16_ef_matches_jax_within_its_band(bf16_ef_run):
    run = bf16_ef_run
    tt = _port("adam", run["init"], compress="bf16", error_feedback=True)
    got = _run(tt, run["batches"], run["masks"])
    scale = np.abs(run["hist"][-1][2]).max()
    for (jl, jc, jp), (tl, tc, tp) in zip(run["hist"], got):
        assert abs(jl - tl) < BF16_BAND and jc == tc
        assert np.abs(tp - jp).max() / scale < BF16_BAND
    ef = tt._ef.numpy()
    assert ef.shape == run["ef"].shape == (N, tt._padded)
    # a masked rank banks its whole gradient, on both sides
    for e in (ef, run["ef"]):
        norms = np.linalg.norm(e, axis=1)
        assert norms[3] > 50 * np.delete(norms, 3).max()


def test_bf16_ef_residual_is_its_formula(bf16_ef_run):
    """One step in its stages: the new residual is ``c - bf16(c·v)`` of
    ``c = g + e``, bit for bit, and the reduce-scatter's average is the
    masked bf16 sum over max(count, 1)."""
    run = bf16_ef_run
    tt = _port("adam", run["init"], compress="bf16", error_feedback=True)
    x, y = run["batches"][0]
    tt.train_step(x, y)  # a nonzero residual to fold in
    e0 = tt._ef.clone()
    v = torch.from_numpy(MASK3)
    stack, _ = tt.rank_gradients(*tt._place_batch(*run["batches"][1]))
    average, count = tt.reduce_scatter(stack, v)
    c = stack + e0
    assert torch.equal(tt._ef, ef_residual(c, v))
    assert torch.equal(tt._ef, c - (c * v[:, None]).to(torch.bfloat16).float())
    sent = (c * v[:, None]).to(torch.bfloat16).float()
    total = sent[0]
    for r in range(1, N):
        total = total + sent[r]
    assert float(count) == 7.0
    assert torch.equal(average, total.to(torch.bfloat16).float() / 7.0)


def test_bf16_reduce_scatter_rounds_as_xla():
    """The bf16 reduce-scatter against XLA's ``psum_scatter`` on the CPU on
    the same masked stack: each rank's payload cast to bf16, the sum in f32
    in rank order, rounded once; every shard bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(0)
    shard = 4096
    stack = (rng.standard_normal((N, N * shard))
             * np.exp(3 * rng.standard_normal((N, 1)))).astype(np.float32)
    mesh = j_line_mesh(N)
    axis = mesh.axis_names[0]

    def rs(c, v):
        v = v.reshape(())
        wire = (c.reshape(-1) * v).astype(jnp.bfloat16)
        total = lax.psum_scatter(wire, axis, tiled=True).astype(jnp.float32)
        return total / jnp.maximum(lax.psum(v, axis), 1.0)

    want = np.asarray(jax.jit(jax.shard_map(
        rs, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(axis), check_vma=False,
    ))(stack, MASK3))
    tt = Zero1DPTrainer(MLP(hidden=HIDDEN, device="cpu"), line_mesh(N, device="cpu"),
                        compress="bf16")
    got, count = tt.reduce_scatter(torch.from_numpy(stack), torch.from_numpy(MASK3))
    assert float(count) == 7.0
    np.testing.assert_array_equal(got.numpy(), want)


def test_zero1_equals_the_ports_dp_trainer():
    """f32 SGD: the sharded optimizer over the reduce-scattered shards gives
    the replicated trainer's weights, bit for bit."""
    batches = _batches(3, seed_offset=9)
    dp = DPTrainer(MLP(hidden=HIDDEN, device="cpu"), line_mesh(N, device="cpu"),
                   optimizer=OPTS["sgd"][1])
    z = _port("sgd", dp.get_flat_params())
    for (x, y), v in zip(batches, [None, MASK36, None]):
        md, mz = dp.train_step(x, y, v), z.train_step(x, y, v)
        assert md.loss == mz.loss and md.contributors == mz.contributors
    np.testing.assert_array_equal(z.get_flat_params(), dp.get_flat_params())
    assert z.accuracy(*batches[0]) == dp.accuracy(*batches[0])


def _opt_leaves(t: Zero1DPTrainer) -> dict:
    return {k: np.asarray(v) for k, v in tree_items(t.checkpoint_state())}


@pytest.mark.parametrize("store", [TrainerCheckpointer, DeltaCheckpointer, Snapshot])
def test_v2_restores_over_fewer_ranks(tmp_path, store):
    """8 -> 4 ranks: the unpadded form restores over another count. Adam
    with bf16 EF: the weights and Adam's state equal, the residual's sum
    kept. SGD with momentum in f32 (the JAX re-mesh test's case): the two
    trainers then continue within its tolerance."""
    batches = _batches(5, seed_offset=3)
    init = flatten_params(MLP(hidden=HIDDEN, device="cpu"))[0]
    momentum = lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9)  # noqa: E731
    for case, kw in (("adam_ef", dict(compress="bf16", error_feedback=True)),
                     ("sgd_momentum", dict(optimizer=momentum))):
        t8 = _port("adam", init, **kw)
        for (x, y), v in zip(batches[:2], [MASK3, None]):
            t8.train_step(x, y, v)
        t4 = _port("adam", np.zeros(t8.param_count, np.float32), n=4, **kw)
        if store is Snapshot:
            Snapshot.capture(t8).restore_into(t4)
        else:
            ck = store(tmp_path / case)
            ck.save(t8)
            assert ck.restore(t4) == 2
        assert t4.step_num == 2
        a, b = _opt_leaves(t8), _opt_leaves(t4)
        ef8, ef4 = a.pop("['ef_sum']"), b.pop("['ef_sum']")
        assert a.keys() == b.keys() and len(a) == (5 if case == "adam_ef" else 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if case == "adam_ef":
            assert np.abs(ef8).max() > 0
            np.testing.assert_allclose(ef4, ef8, rtol=1e-6, atol=1e-12)
            continue
        for x, y in batches[2:]:
            assert abs(t8.train_step(x, y).loss - t4.train_step(x, y).loss) < 1e-5
        np.testing.assert_allclose(t4.get_flat_params(), t8.get_flat_params(),
                                   rtol=1e-5, atol=1e-7)


def test_jax_delta_store_restores_into_the_port(tmp_path, f32_runs):
    """The JAX trainer's delta store (Adam, after its three steps) restores
    into the port's trainer: the same keys, the weights and Adam's state bit
    for bit, and a save of the port's writes a manifest and blobs identical
    to the JAX store's."""
    jt = f32_runs["adam"]["trainer"]
    JDeltaCheckpointer(tmp_path / "jax").save(jt)
    tt = _port("adam", np.zeros(jt.param_count, np.float32))
    assert DeltaCheckpointer(tmp_path / "jax").restore(tt) == 3
    np.testing.assert_array_equal(tt.get_flat_params(), jt.get_flat_params())
    assert int(tt.optimizers[0].state[tt._shards[0]]["step"]) == 3
    DeltaCheckpointer(tmp_path / "port").save(tt)
    for name in ("manifest_3.json",):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    blobs = sorted(p.name for p in (tmp_path / "jax" / "blobs").iterdir())
    assert blobs == sorted(p.name for p in (tmp_path / "port" / "blobs").iterdir())
    for name in blobs:
        assert ((tmp_path / "port" / "blobs" / name).read_bytes()
                == (tmp_path / "jax" / "blobs" / name).read_bytes())


def test_port_delta_store_restores_into_jax(tmp_path, f32_runs):
    run = f32_runs["adam"]
    tt = _port("adam", run["init"])
    _run(tt, f32_runs["batches"], f32_runs["masks"])
    DeltaCheckpointer(tmp_path / "port").save(tt)
    jt = _jax("adam")
    assert JDeltaCheckpointer(tmp_path / "port").restore(jt) == 3
    np.testing.assert_array_equal(jt.get_flat_params(), tt.get_flat_params())
    mu = np.asarray(jt.opt_state[0].mu)[: jt.param_count]
    want = np.concatenate([o.state[s]["exp_avg"].numpy()
                           for o, s in zip(tt.optimizers, tt._shards)])[: tt.param_count]
    np.testing.assert_array_equal(mu, want)
    assert int(jt.opt_state[0].count) == 3


def test_v2_keys_are_the_jax_trainers(f32_runs):
    for opt in OPTS:
        jt = f32_runs[opt]["trainer"]
        tt = _port(opt, jt.get_flat_params())
        assert ([k for k, _ in tree_items(tt.checkpoint_template())]
                == list(JDeltaCheckpointer._flatten(jt.checkpoint_state())))
    momentum = _port("sgd", f32_runs["sgd"]["init"])
    momentum.optimizers = [torch.optim.SGD([s], lr=0.1, momentum=0.9) for s in momentum._shards]
    assert "['opt_state'][0].trace" in dict(tree_items(momentum.checkpoint_state()))


def test_guards(caplog, f32_runs):
    init = f32_runs["sgd"]["init"]
    with pytest.raises(ValueError, match="ONE mesh axis"):
        Zero1DPTrainer(MLP(hidden=HIDDEN, device="cpu"), grid_mesh(2, 4, device="cpu"))
    with pytest.raises(ValueError, match="compress"):
        _port("sgd", init, compress="int8")
    with pytest.raises(ValueError, match="error_feedback"):
        _port("sgd", init, error_feedback=True)
    t = _port("sgd", init)
    with pytest.raises(ValueError, match="flat params"):
        t.set_flat_params(init[:-1])
    state = t.checkpoint_state()
    state["format_version"] = np.asarray(3, np.int32)
    with pytest.raises(ValueError, match="newer"):
        t.restore_checkpoint_state(state)
    # a nonzero residual into a trainer without EF: dropped, with a warning
    ef = _port("sgd", init, compress="bf16", error_feedback=True)
    x, y = _batches(1)[0]
    ef.train_step(x, y, MASK3)
    with caplog.at_level(logging.WARNING, logger="akka_allreduce_tpu_torch.train.zero1"):
        t.restore_checkpoint_state(ef.checkpoint_state())
    assert "error-feedback residual" in caplog.text
    np.testing.assert_array_equal(t.get_flat_params(), ef.get_flat_params())
    # a checkpoint without a residual zeroes a stale live one
    state = t.checkpoint_state()
    del state["ef_sum"]
    ef.restore_checkpoint_state(state)
    assert float(ef._ef.abs().max()) == 0.0
    with pytest.raises(NotImplementedError, match="checkpoint form"):
        _port("sgd", init, optimizer=lambda ps: torch.optim.RMSprop(ps)).checkpoint_state()
