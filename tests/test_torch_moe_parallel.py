"""The port's MoE over virtual ranks against the JAX package's, on the CPU.

Same seeded batches through ``akka_allreduce_tpu.train.MoETrainer`` on a
(data, expert) or (data, seq, expert) mesh (JAX on the 8-device virtual CPU
mesh of ``tests/conftest.py``) and the port's ``MoETrainer`` over the same
mesh of virtual ranks, the JAX trainer's initial weights loaded into the
port (``set_flat_params(get_flat_params())``), as ``tests/test_moe.py``'s
``TestExpertParallel``, ``TestSeqParallelMoE`` and the scatter EP cases
exercise them:

- two steps by SGD, replica row 1 masked at the second where dp is 2: f32
  with ring attention over (2, 2, 2); Ulysses with an int8 wire and the
  scatter dispatch over (1, 2, 4); ``overlap`` on a bf16 wire over (2, 4):
  contributors equal, losses, aux and dropped within 1e-5 relative, the
  parameters within rtol = atol = 1e-5 (top-2 routing and Adam against
  JAX's are ``tests/test_torch_moe.py``'s);
- each rank's view of an expert leaf its ``n_experts / ep`` shard; the
  (data, seq, expert) chain in lockstep with the (data, expert) chain at an
  ample capacity factor, nothing dropped (``test_sp_ep_chain_matches_dp_ep_chain``);
- top-2 over (2, 4) against the dense (data,) mesh of 8
  (``test_top2_ep_matches_dense``); the refusal of indivisible experts,
  with the JAX message;
- ``ElasticMoETrainer`` over 4 nodes of 2 ranks through a drop and a rejoin
  beside JAX's (``tests/test_elastic.py:330``): (dp, ep) 2 x 4 -> 3 x 2 ->
  2 x 4 on both sides, the parameters carried exactly and each phase in
  lockstep with a trainer restored from its snapshot;
- ``train-moe --dp 2 --ep 2 --sp 2`` on the CPU.

Each JAX trainer is built once, its flax ``init`` jitted, and the three
that the same-mesh cases hold the port against are built and stepped in one
module fixture, side by side on threads (XLA compiles outside the GIL).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch

from akka_allreduce_tpu.models import data as jdata
from akka_allreduce_tpu.models.transformer import MoETransformerLM as JMoELM
from akka_allreduce_tpu.train import ElasticMoETrainer as JElasticMoETrainer
from akka_allreduce_tpu.train import MoETrainer as JMoETrainer
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.models import lm_copy_task
from akka_allreduce_tpu_torch.parallel import RankMesh
from akka_allreduce_tpu_torch.train import ElasticMoETrainer, MoETrainer, Snapshot

TOL = 1e-5
KW = dict(vocab=16, d_model=32, n_heads=4, n_layers=1, n_experts=4, seq_len=32,
          learning_rate=1e-3, seed=0)
BATCHES = [next(jdata.lm_copy_task(32, vocab=16).batches(8, 1, seed_offset=i))
           for i in range(2)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny products: torch's intra-op workers only add their wake-ups."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def jitted_init():
    """flax's ``init`` of the JAX MoE LM jitted, once a configuration (eager,
    it takes seconds a trainer)."""
    real = JMoELM.init
    jitted = {}

    def init(self, *args):
        if self not in jitted:
            jitted[self] = jax.jit(lambda *a: real(self, *a))
        return jitted[self](*args)

    JMoELM.init = init
    yield
    JMoELM.init = real


def _jmesh(shape, axes):
    return jax.make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])


def _mesh(shape, axes) -> RankMesh:
    return RankMesh(tuple(axes), tuple(shape), torch.device("cpu"))


def _close(got, want):
    for name in ("loss", "aux_loss", "dropped"):
        g, w = getattr(got, name), getattr(want, name)
        assert abs(g - w) <= TOL * max(abs(w), 1e-6), (name, got, want)
    assert got.step == want.step and got.contributors == want.contributors


# (mesh shape, axes, trainer options): three JAX trainers (each compiles its
# step, 2-3 s on the CPU) cover both meshes, both dispatches, ring and
# Ulysses, and every gradient path: f32, int8, and overlap on a bf16 wire
CASES = {
    "sp_ep_ring_f32": ((2, 2, 2), ("data", "seq", "expert"), {}),
    "sp_ep_ulysses_int8_scatter": ((1, 2, 4), ("data", "seq", "expert"),
                                   dict(seq_impl="ulysses", compress="int8",
                                        dispatch_impl="scatter")),
    "ep_overlap_bf16": ((2, 4), ("data", "expert"), dict(overlap=True, compress="bf16")),
}


def _valid(i: int, dp: int):
    return [1.0, 0.0] if i == 1 and dp == 2 else None


def _jax_run(case):
    """``case``'s JAX trainer by SGD (as tests/test_moe.py's
    TestSeqParallelMoE: a first Adam step is nearly a sign step, which float
    dust in a tiny gradient can flip): its initial weights, the metrics of
    its two steps (replica row 1 masked at the second where dp is 2) and its
    final weights."""
    shape, axes, kw = CASES[case]
    jt = JMoETrainer(_jmesh(shape, axes), optimizer=optax.sgd(0.05), **KW, **kw)
    init = jt.get_flat_params()
    steps = [jt.train_step(x, y, _valid(i, jt.dp)) for i, (x, y) in enumerate(BATCHES)]
    return jt, init, steps, jt.get_flat_params()


@pytest.fixture(scope="module")
def jax_runs(jitted_init):
    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(zip(CASES, pool.map(_jax_run, CASES)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_matches_jax_on_the_same_mesh(case, jax_runs):
    shape, axes, kw = CASES[case]
    jt, init, want_steps, want = jax_runs[case]
    tt = MoETrainer(_mesh(shape, axes), optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05),
                    **KW, **kw)
    assert (tt.dp, tt.sp, tt.ep, tt.n_devices) == (jt.dp, jt.sp, jt.ep, jt.n_devices)
    tt.set_flat_params(init)
    for i, ((x, y), w) in enumerate(zip(BATCHES, want_steps)):
        _close(tt.train_step(x, y, _valid(i, tt.dp)), w)
    np.testing.assert_allclose(tt.get_flat_params(), want, rtol=TOL, atol=TOL)


def test_expert_views_and_the_sp_chain_lockstep():
    """``tests/test_moe.py``'s sharded-weights check, then
    ``test_sp_ep_chain_matches_dp_ep_chain``: the (2, 2, 2) chain's seq
    ranks slice the columns of their (data, expert) coordinate's rows, so at
    capacity factor 4.0 it runs in lockstep with the (2, 2) chain."""
    t = MoETrainer(_mesh((2, 4), ("data", "expert")), **KW)
    views = t.model.rank_views(t.mesh)
    w1 = t.model.blocks[0].moe_w1
    assert w1.shape == (4, 32, 128) and views["blocks.0.moe_w1"].shape == (2, 4, 1, 32, 128)
    assert torch.equal(views["blocks.0.moe_w1"][1, 2, 0], w1[2])
    assert views["blocks.0.router"].stride()[:2] == (0, 0)  # replicated: one copy
    kw = dict(KW, capacity_factor=4.0, n_layers=1,
              optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05))
    t3 = MoETrainer(_mesh((2, 2, 2), ("data", "seq", "expert")), **kw)
    t2 = MoETrainer(_mesh((2, 2), ("data", "expert")), **kw)
    sampler = lm_copy_task(32, vocab=16).device_sampler()
    h3, h2 = t3.train_chain(sampler, 3, 2), t2.train_chain(sampler, 3, 2)
    for a, b in zip(h3, h2):
        assert abs(a.loss - b.loss) < 1e-5 and a.dropped == b.dropped == 0.0
    np.testing.assert_allclose(t3.get_flat_params(), t2.get_flat_params(),
                               rtol=0, atol=1e-5)


def test_top2_ep_matches_dense():
    """``tests/test_moe.py::test_top2_ep_matches_dense`` on the port: rows
    over data x expert give every rank the tokens a dense (data,) rank of 8
    gets, so the routing is the same and the all_to_all pair only moves
    slots; top-2 under capacity pressure (something drops)."""
    kw = dict(KW, router_topk=2, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05))
    ep = MoETrainer(_mesh((2, 4), ("data", "expert")), **kw)
    dense = MoETrainer(_mesh((8,), ("data",)), **kw)
    dense.set_flat_params(ep.get_flat_params())
    for x, y in BATCHES:
        a, b = ep.train_step(x, y), dense.train_step(x, y)
        for name in ("loss", "aux_loss", "dropped"):
            assert abs(getattr(a, name) - getattr(b, name)) <= TOL * abs(getattr(b, name))
        assert a.dropped > 0 and (a.contributors, b.contributors) == (2.0, 8.0)
    np.testing.assert_allclose(ep.get_flat_params(), dense.get_flat_params(), rtol=TOL,
                               atol=TOL)


def test_rejects_indivisible_experts():
    opts = dict(vocab=16, d_model=32, n_heads=4, n_layers=1, n_experts=6, seq_len=16)
    for make, mesh in ((JMoETrainer, _jmesh((2, 4), ("data", "expert"))),
                       (MoETrainer, _mesh((2, 4), ("data", "expert")))):
        with pytest.raises(ValueError, match="divisible"):
            make(mesh, **opts)


def test_elastic_moe_cycle_matches_jax():
    """``tests/test_elastic.py:330`` on the port: node 3 of 4 drops (8 -> 6
    ranks), then rejoins; at each phase the mesh is JAX's ElasticMoETrainer's
    on the same membership, (dp, ep) 2 x 4 -> 3 x 2 -> 2 x 4, the parameters
    cross every re-mesh exactly, and two steps run in lockstep with a fresh
    trainer of the phase's mesh restored from the same snapshot."""
    opts = {k: v for k, v in KW.items() if k != "n_experts"}
    now = {"t": 0.0}
    devices = jax.devices()
    je = JElasticMoETrainer({k: devices[2 * k:2 * k + 2] for k in range(4)}, n_experts=4,
                            clock=lambda: now["t"], **opts)
    te = ElasticMoETrainer({k: [2 * k, 2 * k + 1] for k in range(4)}, n_experts=4,
                           clock=lambda: now["t"], device="cpu", **opts)
    ds = jdata.lm_copy_task(32, vocab=16)
    seed, before = 0, None
    for alive, shape in (([0, 1, 2, 3], (2, 4)), ([0, 1, 2], (3, 2)), ([0, 1, 2, 3], (2, 4))):
        for _ in range(8):  # enough silence for phi to trip, or heal
            for e in (je, te):
                for k in alive:
                    e.heartbeat(k)
            now["t"] += 1.0
            if je.poll() | te.poll() and before is not None:
                np.testing.assert_array_equal(te.get_flat_params(), before)
        for e in (je, te):
            assert (e.trainer.dp, e.trainer.ep) == shape
        snap = Snapshot.capture(te.trainer)
        mirror = te.trainer_factory(te.mesh_factory(len(te._live_devices()), device="cpu"))
        snap.restore_into(mirror)
        for _ in range(2):
            x, y = next(ds.batches(shape[0] * shape[1], 1, seed_offset=seed))
            seed += 1
            assert te.train_step(x, y) == mirror.train_step(x, y)
        before = te.get_flat_params().copy()
    assert je.generation == te.generation == 2


def test_train_moe_dp_ep_sp_on_the_cpu(capsys):
    assert cli_main(["train-moe", "--device", "cpu", "--vocab", "16", "--d-model", "32",
                     "--heads", "2", "--layers", "1", "--seq-len", "16", "--batch", "8",
                     "--steps", "12", "--lr", "3e-2", "--dp", "2", "--ep", "2", "--sp",
                     "2", "--impl", "ulysses", "--compress", "bf16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "mesh dp=2 x sp=2 x ep=2" in lines[0]
    assert lines[-1].startswith("moe: 12 steps on 8 devices")
    first, last = (float(v) for v in lines[-1].split("loss ")[1].split(" (aux")[0].split(" -> "))
    assert last < first
