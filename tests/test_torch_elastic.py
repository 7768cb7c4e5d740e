"""The port's elastic re-mesh (``train/elastic.py``) against the JAX
package's, on the CPU.

JAX's ``ElasticDPTrainer`` runs 4 nodes x 2 devices of the 8-device virtual
CPU mesh (``tests/conftest.py``) on ``MLP(hidden=(16,))``, as
``tests/test_elastic.py`` does; the port's runs 4 nodes x 2 virtual ranks on
the CPU, where K1 takes its plain version, carrying the JAX trainer's
initial weights (``set_flat_params(get_flat_params())``); both see the same
``mnist_like`` batches. The cycle: 2 steps, node 3 silent (``poll`` shrinks
the mesh to 6 ranks), 1 step, node 3 back (the mesh grows to 8), 1 step.
At every point ``generation``, ``n_devices``, ``n_nodes`` and
``contributors`` are equal, the losses within rtol 1e-5 and the flat
parameters within rtol 2e-4, atol 2e-5 (``tests/test_torch_dp.py``'s
``STEP_TOL``). The cycle runs again with ``compress="bf16"``,
``error_feedback=True`` and ``overlap=True`` against JAX's in the same mode
(the same exact counts and losses, the parameters within 1.5e-4 of
max|param|): the rebuilt trainer keeps all three, and the residual's sum is
kept across 8 -> 6 and 6 -> 8 ranks within rtol 1e-6. ``elastic_numerics.py``
reads that band's margins: the sound run drifts at most 8.5e-5 of max|param|
from JAX's, while an f32 wire, a bf16 wire without the residual, or a last
update left out drift further than the band at every point after the first
step, which the test also checks.

Port only: after a re-mesh the trainer equals a fresh ``DPTrainer`` over the
new rank count restored from the same ``Snapshot`` and given the same batch,
bit for bit (and ZeRO-1 with Adam across 8 -> 6 -> 8); the pure functions
against JAX's; the policy-wire ladder and ZeRO-1's clamp; ``min_nodes``;
back-to-back views; the refusals; a rebuild that raises leaves the old
trainer and members untouched, and every build owns its module; the
long-context wrapper on ``{0: [0], 1: []}`` and on two ranks; config 5's record and
``elastic-demo`` on the CPU.

The JAX trainers are built once, in the two module fixtures.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import MLP as JMLP
from akka_allreduce_tpu.models import data as jdata
from akka_allreduce_tpu.train import ElasticDPTrainer as JElasticDPTrainer
from akka_allreduce_tpu.train import elastic as jelastic
from akka_allreduce_tpu_torch import bench_suite
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.models import MLP, lm_copy_task, mnist_like
from akka_allreduce_tpu_torch.obs import metrics as tmetrics
from akka_allreduce_tpu_torch.parallel import line_mesh
from akka_allreduce_tpu_torch.train import (
    DPTrainer,
    ElasticDPTrainer,
    ElasticLongContextTrainer,
    ElasticTrainer,
    LongContextTrainer,
    Snapshot,
    Zero1DPTrainer,
    adaptive_parallel_factor,
)
from akka_allreduce_tpu_torch.train import elastic as telastic

HIDDEN = (16,)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_dp.py's
LOSS_RTOL = 1e-5
BF16_EF_BAND = 1.5e-4  # of max|param|, bf16 + EF + overlap against JAX's
ROWS = 4  # rows a rank
X0 = np.zeros((1, 28, 28, 1), np.float32)


def _assignment_jax(n_nodes=4, per=2):
    import jax

    devices = jax.devices()
    return {n: devices[n * per:(n + 1) * per] for n in range(n_nodes)}


def _assignment(n_nodes=4, per=2):
    return {n: list(range(n * per, (n + 1) * per)) for n in range(n_nodes)}


def _batch(n_ranks, offset):
    return next(iter(jdata.mnist_like().batches(ROWS * n_ranks, 1, seed_offset=offset)))


def _cycle(e, now):
    """2 steps, node 3 silent until ``poll`` shrinks the mesh, 1 step, node
    3 back, 1 step. Returns what is compared at every point."""
    record = []

    def point(m=None):
        record.append({"generation": e.generation, "n_devices": e.n_devices,
                       "n_nodes": e.n_nodes,
                       "contributors": None if m is None else m.contributors,
                       "loss": None if m is None else m.loss,
                       "params": e.get_flat_params().copy()})

    def beat(alive):
        for n in alive:
            e.heartbeat(n)
        now["t"] += 1.0

    for s in range(2):
        beat(range(4))
        point(e.train_step(*_batch(e.n_devices, s)))
    for _ in range(10):
        beat(range(3))
    assert e.poll()
    point()
    point(e.train_step(*_batch(e.n_devices, 2)))
    e.heartbeat(3)
    assert e.poll()
    point()
    point(e.train_step(*_batch(e.n_devices, 3)))
    return record


def _jax_cycle(**kw):
    now = {"t": 0.0}
    e = JElasticDPTrainer(JMLP(hidden=HIDDEN, classes=10), _assignment_jax(),
                          example_input=X0, clock=lambda: now["t"], **kw)
    init = e.get_flat_params().copy()
    return init, _cycle(e, now), e


def _port(init=None, **kw):
    now = {"t": 0.0}
    e = ElasticDPTrainer(MLP(hidden=HIDDEN, device="cpu"), _assignment(),
                         clock=lambda: now["t"], device="cpu", **kw)
    if init is not None:
        e.set_flat_params(init)
    return e, now


@pytest.fixture(scope="module")
def f32_cycle():
    init, record, _ = _jax_cycle()
    return init, record


@pytest.fixture(scope="module")
def compressed_cycle():
    init, record, e = _jax_cycle(compress="bf16", error_feedback=True, overlap=True)
    return init, record, e


def _compare(port, jax_record, band=None):
    """Every point equal in generation, ranks, nodes and contributors, the
    losses within rtol 1e-5; the parameters within ``STEP_TOL``, or, for a
    lossy wire, within ``band`` of max|param| (a bf16 wire value one ulp
    apart moves a weight by more than ``STEP_TOL``)."""
    assert len(port) == len(jax_record)
    for i, (a, b) in enumerate(zip(port, jax_record)):
        for key in ("generation", "n_devices", "n_nodes", "contributors"):
            assert a[key] == b[key], (i, key, a[key], b[key])
        if b["loss"] is not None:
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        if band is None:
            np.testing.assert_allclose(a["params"], b["params"], **STEP_TOL)
        else:
            drift = param_drift(a["params"], b["params"])
            assert drift < band, (i, drift)


def param_drift(got, want):
    """max|got - want| as a share of max|want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_drop_rejoin_cycle_matches_jax(f32_cycle):
    init, jax_record = f32_cycle
    e, now = _port(init)
    record = _cycle(e, now)
    _compare(record, jax_record)
    assert [r["n_devices"] for r in record] == [8, 8, 6, 6, 8, 8]
    assert e.generation == 2 and e.trainer.step_num == 4
    # the re-meshes themselves change no weight
    np.testing.assert_array_equal(record[2]["params"], record[1]["params"])
    np.testing.assert_array_equal(record[4]["params"], record[3]["params"])


def test_compressed_overlapped_cycle_keeps_its_options_and_the_residual_sum(compressed_cycle):
    init, jax_record, je = compressed_cycle
    assert je.trainer.compress == "bf16" and je.trainer.overlap
    e, now = _port(init, compress="bf16", error_feedback=True, overlap=True)
    sums = []
    real_rebuild = e._rebuild

    def watched(kind, old):
        sums.append(e.trainer._ef.sum(dim=0).clone())
        real_rebuild(kind, old)
        sums.append(e.trainer._ef.sum(dim=0).clone())

    e._rebuild = watched
    record = _cycle(e, now)
    _compare(record, jax_record, band=BF16_EF_BAND)
    t = e.trainer
    assert (t.compress, t.error_feedback, t.overlap) == ("bf16", True, True)
    assert t._ef.shape == (8, t.param_count)
    # 8 -> 6 and 6 -> 8: what the sync still owes crosses each re-mesh
    for before, after in (sums[0:2], sums[2:4]):
        assert float(before.abs().max()) > 0
        np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-6, atol=1e-9)
    # the band holds the last update: the parameters before it lie far outside
    assert param_drift(record[-2]["params"], jax_record[-1]["params"]) > 10 * BF16_EF_BAND


@pytest.mark.parametrize("kw", [dict(overlap=True), dict(compress="bf16", overlap=True)],
                         ids=["f32-wire", "bf16-without-ef"])
def test_the_bf16_ef_band_refuses_another_wire(compressed_cycle, kw):
    """The same cycle over another wire drifts from JAX's bf16 + EF run by
    more than the band at every point after the first step."""
    init, jax_record, _ = compressed_cycle
    e, now = _port(init, **kw)
    record = _cycle(e, now)
    drifts = [param_drift(a["params"], b["params"]) for a, b in zip(record, jax_record)]
    assert min(drifts[1:]) > BF16_EF_BAND, drifts


def test_remesh_continues_like_a_fresh_trainer_from_the_snapshot():
    e, now = _port(None)
    for s in range(2):
        for n in range(4):
            e.heartbeat(n)
        now["t"] += 1.0
        e.train_step(*_batch(8, s))
    for _ in range(10):
        e.heartbeat(0), e.heartbeat(1), e.heartbeat(2)
        now["t"] += 1.0
    assert e.poll() and e.n_devices == 6
    oracle = DPTrainer(MLP(hidden=HIDDEN, device="cpu"), line_mesh(6, device="cpu"))
    Snapshot.capture(e.trainer).restore_into(oracle)
    batch = _batch(6, 42)
    a, b = e.train_step(*batch), oracle.train_step(*batch)
    assert a.loss == b.loss and a.contributors == b.contributors == 6.0
    np.testing.assert_array_equal(e.get_flat_params(), oracle.get_flat_params())


def test_zero1_adam_continues_like_a_fresh_trainer_across_8_6_8():
    now = {"t": 0.0}

    def factory(mesh):
        return Zero1DPTrainer(MLP(hidden=(32,), device=mesh.device), mesh,
                              optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2))

    e = ElasticTrainer(factory, _assignment(), clock=lambda: now["t"], device="cpu")
    seed = 0
    for alive, want in (([0, 1, 2, 3], 8), ([0, 1, 2], 6), ([0, 1, 2, 3], 8)):
        before = e.get_flat_params().copy()
        for _ in range(8):
            for n in alive:
                e.heartbeat(n)
            now["t"] += 1.0
            e.poll()
        assert e.n_devices == want
        np.testing.assert_array_equal(e.get_flat_params(), before)
        mirror = factory(line_mesh(want, device="cpu"))
        Snapshot.capture(e.trainer).restore_into(mirror)
        for _ in range(2):
            batch = _batch(want, seed)
            seed += 1
            a, b = e.train_step(*batch), mirror.train_step(*batch)
            assert a.loss == b.loss
            np.testing.assert_array_equal(e.get_flat_params(), mirror.get_flat_params())
    assert e.generation == 2


@pytest.mark.parametrize("cap", [None, 1, 2, 3, 4])
def test_pure_functions_match_jax(cap):
    for n in range(1, 17):
        for divides in range(1, 17):
            assert adaptive_parallel_factor(n, divides) == jelastic.adaptive_parallel_factor(
                n, divides)
            assert telastic._capped_factor(n, divides, cap) == jelastic._capped_factor(
                n, divides, cap)


def test_tables_match_jax_and_bad_counts_raise():
    from akka_allreduce_tpu.control.adapt import WIRE_TO_COMPRESS

    assert telastic.WIRE_TO_COMPRESS == WIRE_TO_COMPRESS
    assert telastic.COMPRESS_LEVELS == jelastic.COMPRESS_LEVELS
    for mod in (telastic, jelastic):
        with pytest.raises(ValueError, match="positive"):
            mod.adaptive_parallel_factor(0, 4)
        with pytest.raises(ValueError, match="cap"):
            mod._capped_factor(8, 8, 0)


def test_policy_wire_ladder_and_zero1_clamp():
    e, _ = _port(None)
    gen = e.generation
    assert e.apply_policy_wire("f16") is True and e.compress_mode == "bf16"
    assert e.apply_policy_wire("int8") is True and e.compress_mode == "int8"
    assert tmetrics.REGISTRY.gauge("elastic.compress_level").value == 2
    assert e.apply_policy_wire("bogus") is False and e.compress_mode == "int8"
    assert e.apply_policy_wire("") is True and e.compress_mode is None
    assert e.generation == gen + 3
    m = e.train_step(*_batch(8, 0))
    assert np.isfinite(m.loss) and m.contributors == 8.0

    def z1_factory(mesh, compress=None):
        return Zero1DPTrainer(MLP(hidden=HIDDEN, device=mesh.device), mesh,
                              compress=compress, error_feedback=compress is not None)

    z = ElasticTrainer(z1_factory, _assignment(2), device="cpu")
    z.clamp_compress = lambda mode: "bf16" if mode else None
    assert z.apply_policy_wire("f16") is True and z.compress_mode == "bf16"
    g = z.generation
    assert z.apply_policy_wire("int8") is False  # clamped onto bf16
    assert z.compress_mode == "bf16" and z.generation == g
    assert z.apply_policy_wire("") is True and z.compress_mode is None


def test_policy_wire_without_a_compress_factory_raises():
    e = ElasticTrainer(lambda mesh: DPTrainer(MLP(hidden=HIDDEN, device="cpu"), mesh),
                       _assignment(2), device="cpu")
    with pytest.raises(RuntimeError, match="compress"):
        e.apply_policy_wire("f16")
    assert e.compress_mode is None and e.generation == 0


def test_min_nodes_refuses_then_recovers_on_rejoin():
    now = {"t": 0.0}
    e = ElasticDPTrainer(MLP(hidden=HIDDEN, device="cpu"), _assignment(3), min_nodes=2,
                         clock=lambda: now["t"], device="cpu")
    e.train_step(*_batch(6, 0))
    ref = e.get_flat_params().copy()
    assert e.apply_membership([0]) is True and e.n_nodes == 1
    with pytest.raises(RuntimeError, match="min_nodes"):
        e.train_step(*_batch(2, 1))
    np.testing.assert_array_equal(e.get_flat_params(), ref)
    assert e.apply_membership([0, 1, 2]) is True
    np.testing.assert_array_equal(e.get_flat_params(), ref)
    m = e.train_step(*_batch(6, 2))
    assert np.isfinite(m.loss) and m.contributors == 6.0


def test_back_to_back_views_and_unknown_ids():
    e, _ = _port(None)
    e.train_step(*_batch(8, 0))
    ref = e.get_flat_params().copy()
    assert e.apply_membership([0, 1, 2]) is True
    assert e.apply_membership([0, 2]) is True  # no step between
    assert e.n_devices == 4
    np.testing.assert_array_equal(e.get_flat_params(), ref)
    assert e.apply_membership([0, 1, 2, 3, 9]) is True  # 9 has no ranks: ignored
    assert e.apply_membership([0, 1, 2, 3]) is False
    np.testing.assert_array_equal(e.get_flat_params(), ref)
    assert e.generation == 3
    m = e.train_step(*_batch(8, 1))
    assert m.contributors == 8.0
    with pytest.raises(RuntimeError, match="device assignment"):
        e.apply_membership([7])


def test_unknown_heartbeat_and_losing_every_node_raise():
    e, now = _port(None)
    with pytest.raises(KeyError, match="device assignment"):
        e.heartbeat(7)
    for _ in range(3):
        for n in range(4):
            e.heartbeat(n)
        now["t"] += 1.0
    now["t"] += 1000.0
    with pytest.raises(RuntimeError, match="all nodes"):
        e.poll()
    assert not ElasticDPTrainer(MLP(hidden=HIDDEN, device="cpu"), _assignment(2),
                                device="cpu").poll()


class _Refusing:
    """A DP factory that refuses some rank counts, and can poison restores."""

    def __init__(self, refuse=(), bad_restore=False):
        self.refuse = set(refuse)
        self.bad_restore = bad_restore
        self.built = []

    def __call__(self, mesh):
        if mesh.size in self.refuse:
            raise ValueError(f"this factory does not build {mesh.size} ranks")
        t = DPTrainer(MLP(hidden=HIDDEN, device="cpu"), mesh)
        if self.bad_restore and self.built:
            def bad(*a, **k):
                raise RuntimeError("restore failed")
            t.optimizer.load_state_dict = bad
        self.built.append(t)
        return t


@pytest.mark.parametrize("fault", ["factory", "restore"])
def test_a_failed_rebuild_leaves_the_old_trainer_untouched(fault):
    factory = _Refusing(refuse={6} if fault == "factory" else (),
                        bad_restore=fault == "restore")
    e = ElasticTrainer(factory, _assignment(), device="cpu")
    e.train_step(*_batch(8, 0))
    old, ref = e.trainer, e.get_flat_params().copy()
    with pytest.raises(ValueError if fault == "factory" else RuntimeError):
        e.apply_membership([0, 1, 2])
    assert e.trainer is old and e.member_nodes == (0, 1, 2, 3) and e.generation == 0
    np.testing.assert_array_equal(e.get_flat_params(), ref)
    np.testing.assert_array_equal(old.get_flat_params(), ref)
    assert e.train_step(*_batch(8, 1)).contributors == 8.0


def test_the_fallback_mesh_takes_a_refused_rank_count():
    def fallback(n, *, device=None):
        return line_mesh(n - 1, device=device)  # degrade: one rank fewer

    e = ElasticTrainer(_Refusing(refuse={6}), _assignment(), fallback_mesh_factory=fallback,
                       device="cpu")
    ref = e.get_flat_params().copy()
    assert e.apply_membership([0, 1, 2]) is True
    assert e.n_devices == 5 and e.generation == 1
    np.testing.assert_array_equal(e.get_flat_params(), ref)


def test_every_build_owns_its_module():
    template = MLP(hidden=HIDDEN, device="cpu")
    before = {k: v.clone() for k, v in template.state_dict().items()}
    e = ElasticDPTrainer(template, _assignment(), device="cpu")
    first = e.trainer
    e.train_step(*_batch(8, 0))
    assert e.apply_membership([0, 1, 2]) is True
    second = e.trainer
    assert second.model is not first.model and first.model is not template
    ptrs = {p.data_ptr() for p in first.model.parameters()}
    assert not ptrs & {p.data_ptr() for p in second.model.parameters()}
    second.train_step(*_batch(6, 1))
    # the old trainer's weights are its own: the new step did not move them
    assert not np.array_equal(first.get_flat_params(), second.get_flat_params())
    for k, v in template.state_dict().items():
        assert torch.equal(v, before[k])
    # the wrapper keeps no module of its own beside its trainer's
    assert not [v for v in vars(e).values() if isinstance(v, torch.nn.Module)]


@pytest.mark.parametrize("kind", ["dp", "zero1", "lc"])
def test_tensor_flat_params_equal_the_host_vector(kind):
    if kind == "dp":
        t = DPTrainer(MLP(hidden=HIDDEN, device="cpu"), line_mesh(2, device="cpu"))
    elif kind == "zero1":
        t = Zero1DPTrainer(MLP(hidden=HIDDEN, device="cpu"), line_mesh(3, device="cpu"))
    else:
        t = LongContextTrainer(vocab=16, d_model=32, n_heads=2, n_layers=1, seq_len=16,
                               device="cpu")
    flat = t.flat_params_tensor()
    np.testing.assert_array_equal(flat.numpy(), t.get_flat_params())
    new = torch.from_numpy(np.random.default_rng(0).standard_normal(t.param_count)
                           .astype(np.float32))
    t.set_flat_params(new)
    np.testing.assert_array_equal(t.get_flat_params(), new.numpy())
    with pytest.raises(ValueError):
        t.set_flat_params(new[:-1])


def test_long_context_wrapper_on_one_rank_and_a_control_node():
    now = {"t": 0.0}
    e = ElasticLongContextTrainer({0: [0], 1: []}, seq_len=32, max_sp=4, vocab=16,
                                  d_model=32, n_heads=2, n_layers=1, learning_rate=1e-2,
                                  seed=0, clock=lambda: now["t"], device="cpu")
    ds = lm_copy_task(32, vocab=16)
    e.train_step(*next(ds.batches(1, 1, seed_offset=0)))
    ref = e.get_flat_params().copy()
    for _ in range(10):
        e.heartbeat(0)
        now["t"] += 1.0
    assert e.poll() and e.member_nodes == (0,) and (e.trainer.dp, e.trainer.sp) == (1, 1)
    np.testing.assert_array_equal(e.get_flat_params(), ref)
    e.heartbeat(1)
    assert e.poll() and e.member_nodes == (0, 1)
    np.testing.assert_array_equal(e.get_flat_params(), ref)
    assert np.isfinite(e.train_step(*next(ds.batches(1, 1, seed_offset=1))).loss)
    # two ranks: the (data, seq) mesh of the live ranks, sp 2 (the numerics
    # of a cycle against JAX's in tests/test_torch_seq_parallel.py)
    two = ElasticLongContextTrainer({0: [0], 1: [1]}, seq_len=32, vocab=16, d_model=32,
                                    n_heads=2, n_layers=1, device="cpu")
    assert (two.trainer.dp, two.trainer.sp, two.n_devices) == (1, 2, 2)
    assert np.isfinite(two.train_step(*next(ds.batches(1, 1, seed_offset=2))).loss)


def test_remesh_observability():
    from akka_allreduce_tpu_torch.obs import flight

    hist = tmetrics.REGISTRY.histogram("elastic.remesh.seconds")
    shrink = tmetrics.REGISTRY.counter("elastic.remeshes.shrink")
    n0, s0 = hist.count, shrink.value
    flight.clear()
    e, _ = _port(None)
    assert e.apply_membership([0, 1]) is True
    assert hist.count == n0 + 1 and shrink.value == s0 + 1
    ev = [x for x in flight.events() if x.get("event") == "remesh"][-1]
    assert ev["members_from"] == [0, 1, 2, 3] and ev["members_to"] == [0, 1]
    assert ev["n_devices"] == 4 and ev["generation"] == 1


def test_config5_record_on_the_cpu():
    rec = bench_suite.config5_dropout_recovery(size=20_000, device="cpu")
    assert rec["config"] == 5
    assert rec["rounds_completed"] == 10
    assert 2.0 <= rec["mean_contributors"] <= 3.0
    assert rec["dropped_remeshed"] is True
    assert rec["rejoin_remeshed"] is True
    assert rec["remeshed"] is True
    assert rec["remesh_nodes"] >= 1
    assert rec["drop_remesh_and_first_step_s"] > 0
    assert rec["rejoin_remesh_and_first_step_s"] > 0
    assert rec["zero1_remeshed"] is True and rec["long_context_remeshed"] is True
    assert rec["zero_device_control_node"] is True and rec["compile_cache"] is None
    assert rec["moe_remeshed"] is True and rec["pipeline_post_rejoin_loss"] is None
    assert rec["moe_drop_remesh_and_first_step_s"] > 0 and rec["moe_post_rejoin_loss"] > 0
    assert rec["families_not_ported"] == ["pipeline"]
    assert rec["device"] == "cpu" and rec["device_platform"] == "cpu"
    json.dumps(rec)


def test_elastic_demo_cli_on_the_cpu(capsys):
    assert cli_main(["elastic-demo", "--device", "cpu", "--steps", "12", "--drop-at", "4",
                     "--rejoin-at", "8"]) == 0
    out = capsys.readouterr().out
    assert "re-meshed to 3 nodes / 6 ranks (generation 1)" in out
    assert "re-meshed to 4 nodes / 8 ranks (generation 2)" in out
    assert "contributors=6" in out and "final generation 2" in out
    assert cli_main(["elastic-demo", "--device", "cpu", "--family", "lc", "--steps", "10",
                     "--drop-at", "3", "--rejoin-at", "7", "--batch-per-device", "2"]) == 0
    out = capsys.readouterr().out
    # 8 virtual ranks over 4 nodes, as the JAX demo splits its 8 CPU devices:
    # the drop changes sp as well as dp
    assert "elastic-demo: lc, 4 nodes, 8 ranks on cpu" in out
    assert "re-meshed to 3 nodes / dp3 x sp2 (generation 1)" in out
    assert "re-meshed to 4 nodes / dp2 x sp4 (generation 2)" in out
    assert "final generation 2" in out


def test_elastic_demo_moe_on_the_cpu(capsys):
    assert cli_main(["elastic-demo", "--device", "cpu", "--family", "moe", "--steps", "10",
                     "--drop-at", "3", "--rejoin-at", "7", "--batch-per-device", "2"]) == 0
    out = capsys.readouterr().out
    # 8 virtual ranks over 4 nodes, as the JAX demo splits its 8 CPU devices:
    # the expert axis is gcd(ranks, 4 experts), 4 then 2 then 4
    assert "elastic-demo: moe, 4 nodes, 8 ranks on cpu" in out
    assert "re-meshed to 3 nodes / dp3 x ep2 (generation 1)" in out
    assert "re-meshed to 4 nodes / dp2 x ep4 (generation 2)" in out
    assert "final generation 2" in out


@pytest.mark.parametrize("family", ["pp"])
def test_elastic_demo_refuses_unported_families(family, capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli_main(["elastic-demo", "--device", "cpu", "--family", family])
    assert exit_info.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


def test_mnist_batches_are_the_jax_ones():
    a = next(iter(mnist_like().batches(24, 1, seed_offset=5)))
    b = _batch(6, 5)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
