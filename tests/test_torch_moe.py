"""The port's mixture-of-experts path against the JAX package's, on the CPU.

Same seeded numpy inputs through ``akka_allreduce_tpu.ops.moe`` /
``models.MoETransformerLM`` / ``train.MoETrainer`` (JAX on the CPU, a
one-device ``(data,)`` mesh) and their counterparts in
``akka_allreduce_tpu_torch``, flax weights carried into the port
(``moe_state_dict_from_flax``, or ``set_flat_params(get_flat_params())``):

- ``route_indices`` and ``topk_route`` on the same logits array (so no
  near-tie can decide the test): experts, slots and keeps equal, gates, aux
  and dropped within 1e-6, top-1 and top-2, with and without drops, and a
  tie broken toward the lower expert as ``lax.top_k`` breaks it;
- ``moe_dispatch_compute``, scatter and einsum, top-1 and top-2, with
  (cf 0.5) and without (cf 2.0) drops: within 1e-5 of JAX's
  (``tests/test_moe.py:297``), and scatter against einsum; the gradients
  through both dispatches within rtol 1e-4, atol 1e-5 (``:310``), a
  dropped token's gradient exactly 0 (top-1 at cf 0.5); bf16 scatter
  against einsum within
  3e-2; the refusals;
- the MoE LM's logits, aux and dropped against flax's apply within 1e-5,
  and the flat-vector order against ``flatten_pytree``'s;
- three ``MoETrainer`` steps (1 layer, 2 KV heads of 4) in f32 with Adam at
  lr 1e-3 (the Adam hazard of
  ``tests/test_torch_train.py``), then one step with the first moment in
  bf16: losses, aux and dropped within 1e-5 relative, the parameters within
  1e-5 of max|param| (the first moment's dtype checked on both sides);
- ``moe_active_params`` equal; a step at dp 2, on a (data, expert) mesh,
  with ``compress`` and with ``overlap``, and the JAX trainer's refusals;
- ``ElasticMoETrainer`` over ``{0: [0], 1: []}``: a drop/rejoin cycle, then
  the trainer equal bit for bit to a fresh one restored from the same
  ``Snapshot`` over two more steps; a checkpoint round trip with a bf16 first
  moment;
- ``train-moe`` on the CPU.

The two JAX trainers are built once, in a module fixture, their flax
``init`` jitted (eager, it takes seconds); the JAX routing and dispatch
functions are jitted too.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.binder.api import flatten_pytree
from akka_allreduce_tpu.models import data as jdata
from akka_allreduce_tpu.models.transformer import MoETransformerLM as JMoELM
from akka_allreduce_tpu.ops import moe as jmoe
from akka_allreduce_tpu.train import MoETrainer as JMoETrainer
from akka_allreduce_tpu.utils import benchmarking as jbench
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.models import (
    MoETransformerLM,
    lm_copy_task,
    moe_state_dict_from_flax,
)
from akka_allreduce_tpu_torch.ops import moe as tmoe
from akka_allreduce_tpu_torch.parallel import RankMesh, grid_mesh, line_mesh
from akka_allreduce_tpu_torch.train import (
    ElasticMoETrainer,
    MoETrainer,
    Snapshot,
    TrainerCheckpointer,
)
from akka_allreduce_tpu_torch.utils.benchmarking import moe_active_params

TOL = 1e-5
KW = dict(vocab=16, d_model=32, n_heads=4, n_kv_heads=2, n_layers=1, n_experts=4,
          seq_len=32, learning_rate=1e-3, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny products: torch's intra-op workers only add their wake-ups."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_trainer(**kw) -> JMoETrainer:
    """JAX's trainer on a one-device (data,) mesh, its flax ``init`` jitted."""
    real = JMoELM.init
    jitted = {}

    def init(self, *args):
        if self not in jitted:
            jitted[self] = jax.jit(lambda *a: real(self, *a))
        return jitted[self](*args)

    mesh = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    JMoELM.init = init
    try:
        return JMoETrainer(mesh, **kw)
    finally:
        JMoELM.init = real


@pytest.fixture(scope="module")
def trainers():
    """(JAX f32-moment trainer, JAX bf16-moment trainer), untouched until a
    test steps them."""
    return _jax_trainer(**KW), _jax_trainer(mu_dtype=jnp.bfloat16, **KW)


def _logits(t=24, e=4, seed=0):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- routing -------------------------------------------------------------------


_j_route_indices = jax.jit(jmoe.route_indices, static_argnums=(1, 2))
_j_topk_route = jax.jit(jmoe.topk_route, static_argnums=(1, 2))
_j_dispatch = jax.jit(jmoe.moe_dispatch_compute, static_argnames=(
    "n_experts", "capacity_factor", "router_topk", "dispatch_impl"))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [3, 24])
def test_route_indices_equal_jax_on_the_same_logits(k, capacity):
    logits = _logits()
    want = _j_route_indices(jnp.asarray(logits), capacity, k)
    got = tmoe.route_indices(_t(logits), capacity, k=k)
    for name in ("idx", "slot", "keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.gates.numpy(), np.asarray(want.gates), rtol=1e-6)
    for name in ("aux_loss", "dropped"):
        assert float(getattr(got, name)) == pytest.approx(float(getattr(want, name)),
                                                          rel=1e-6, abs=1e-7)
    assert (float(got.dropped) > 0) == (capacity == 3)


def test_topk_route_and_ties_equal_jax():
    logits = _logits(t=10, seed=1)
    logits[3] = 0.5  # a four-way tie: the lower experts win, as lax.top_k
    logits[4, :2] = 2.0
    for k in (1, 2):
        want = _j_topk_route(jnp.asarray(logits), 4, k)
        got = tmoe.topk_route(_t(logits), 4, k=k)
        np.testing.assert_array_equal(got.dispatch.numpy(), np.asarray(want.dispatch))
        np.testing.assert_allclose(got.combine.numpy(), np.asarray(want.combine), rtol=1e-6)
    assert tmoe.route_indices(_t(logits), 4, k=2).idx[3].tolist() == [0, 1]
    assert tmoe.route_indices(_t(logits), 4, k=2).idx[4].tolist() == [0, 1]


def test_switch_route_units():
    """``tests/test_moe.py``'s routing units, on the port."""
    r = tmoe.switch_route(torch.tensor([[2.0, 0.0], [0.0, 2.0], [2.0, 0.0]]), capacity=2)
    assert r.dispatch.shape == (3, 2, 2) and float(r.dropped) == 0.0
    assert r.dispatch[0, 0, 0] == r.dispatch[2, 0, 1] == r.dispatch[1, 1, 0] == 1.0
    r = tmoe.switch_route(torch.tensor([[5.0, 0.0]]).repeat(4, 1), capacity=2)
    assert float(r.dispatch.sum()) == 2.0 and float(r.dropped) == pytest.approx(0.5)
    r = tmoe.switch_route(torch.tensor([[3.0, 0.0]]), capacity=1)
    assert float(r.combine[0, 0, 0]) == pytest.approx(float(torch.softmax(
        torch.tensor([3.0, 0.0]), 0)[0]))
    assert tmoe.expert_capacity(24, 4, 0.5, 2) == 6 == max(1, -(-int(24 * 0.5) * 2 // 4))
    with pytest.raises(ValueError, match="1 <= k"):
        tmoe.route_indices(torch.zeros(3, 2), 2, k=3)


# -- dispatch ------------------------------------------------------------------


def _dispatch_inputs(t=24, d=16, e=4, seed=3):
    rng = np.random.default_rng(seed)
    h = 2 * d
    return (rng.standard_normal((t, d)).astype(np.float32),
            rng.standard_normal((d, e)).astype(np.float32),
            (rng.standard_normal((e, d, h)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, h)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, h, d)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_dispatch_matches_jax_and_scatter_matches_einsum(k, cf):
    arrs = _dispatch_inputs()
    kw = dict(n_experts=4, capacity_factor=cf, router_topk=k)
    got = {}
    for impl in ("einsum", "scatter"):
        y, aux, dropped = tmoe.moe_dispatch_compute(*map(_t, arrs), dispatch_impl=impl, **kw)
        jy, jaux, jdropped = _j_dispatch(*map(jnp.asarray, arrs), dispatch_impl=impl, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
        assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
        assert float(dropped) == pytest.approx(float(jdropped), abs=1e-6)
        got[impl] = y.numpy()
        assert (float(dropped) > 0) == (cf == 0.5)
    np.testing.assert_allclose(got["scatter"], got["einsum"], rtol=TOL, atol=TOL)


def test_dispatch_gradients_match_jax():
    arrs = _dispatch_inputs()
    kw = dict(n_experts=4, capacity_factor=0.75, router_topk=2)

    def jloss(impl):
        def f(x, w1):
            y = jmoe.moe_dispatch_compute(x, jnp.asarray(arrs[1]), w1, jnp.asarray(arrs[3]),
                                          jnp.asarray(arrs[4]), dispatch_impl=impl, **kw)[0]
            return (y ** 2).sum()
        return jax.jit(jax.grad(f, argnums=(0, 1)))

    for impl in ("einsum", "scatter"):
        x, w1 = _t(arrs[0]).requires_grad_(), _t(arrs[2]).requires_grad_()
        y = tmoe.moe_dispatch_compute(x, _t(arrs[1]), w1, _t(arrs[3]), _t(arrs[4]),
                                      dispatch_impl=impl, **kw)[0]
        (y ** 2).sum().backward()
        want = jloss(impl)(jnp.asarray(arrs[0]), jnp.asarray(arrs[2]))
        for a, b in zip((x.grad, w1.grad), want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    # under top-1 at cf 0.5 a dropped token gets exactly no gradient
    x = _t(arrs[0]).requires_grad_()
    y, _, dropped = tmoe.moe_dispatch_compute(x, *map(_t, arrs[1:]), n_experts=4,
                                              capacity_factor=0.5, dispatch_impl="scatter")
    (y ** 2).sum().backward()
    lost = (y.detach().abs().sum(dim=1) == 0).nonzero().flatten()
    assert len(lost) == round(float(dropped) * 24) > 0 and bool((x.grad[lost] == 0).all())


def test_bf16_scatter_matches_einsum_and_refusals():
    arrs = _dispatch_inputs()
    x = _t(arrs[0]).to(torch.bfloat16)
    rest = list(map(_t, arrs[1:]))
    ye = tmoe.moe_dispatch_compute(x, *rest, n_experts=4, dispatch_impl="einsum")[0]
    ys = tmoe.moe_dispatch_compute(x, *rest, n_experts=4, dispatch_impl="scatter")[0]
    assert ys.dtype == torch.bfloat16
    np.testing.assert_allclose(ys.float().numpy(), ye.float().numpy(), rtol=3e-2, atol=3e-2)
    with pytest.raises(ValueError, match="dispatch_impl"):
        tmoe.moe_dispatch_compute(x, *rest, n_experts=4, dispatch_impl="typo")
    # over a (data, expert) = (1, 2) mesh: each rank routes its own half of
    # the tokens over all 4 experts, 2 of them its own; the all_to_all pair
    # moves slots, so each rank's output is its half's one-device dispatch
    mesh = grid_mesh(1, 2, axes=("data", "expert"), device="cpu")
    router, w1, b1, w2 = rest
    stack = x.reshape(2, 12, -1)
    for impl in ("einsum", "scatter"):
        y, aux, dropped = tmoe.moe_dispatch_compute(
            stack, router.expand(2, *router.shape), *(w.reshape(2, 2, *w.shape[1:])
                                                       for w in (w1, b1, w2)),
            n_experts=4, expert_axis="expert", dispatch_impl=impl, mesh=mesh)
        assert y.dtype == torch.bfloat16 and aux.shape == dropped.shape == (2,)
        for r in range(2):
            want = tmoe.moe_dispatch_compute(stack[r], *rest, n_experts=4, dispatch_impl=impl)
            np.testing.assert_allclose(y[r].float().numpy(), want[0].float().numpy(),
                                       rtol=3e-2, atol=3e-2)
            assert float(aux[r]) == pytest.approx(float(want[1]), rel=1e-6)
            assert float(dropped[r]) == float(want[2])
    for kw in ({"expert_axis": "expert"}, {"seq_axis": "seq"}):
        with pytest.raises(ValueError, match="mesh"):
            tmoe.moe_dispatch_compute(x, *rest, n_experts=4, **kw)


# -- the model -------------------------------------------------------------------


def test_moe_lm_matches_flax(trainers):
    jt, _ = trainers
    tokens = np.random.default_rng(4).integers(0, 16, (2, 16)).astype(np.int32)
    jm = jt.model.clone(capacity_factor=1.0)  # drops at this batch
    want = jax.jit(jm.apply)(jt.params, jnp.asarray(tokens))
    model = MoETransformerLM(vocab=16, d_model=32, n_heads=4, n_kv_heads=2, n_layers=1,
                             n_experts=4, capacity_factor=1.0, device="cpu")
    tree = jax.tree.map(np.asarray, jt.params)
    model.load_state_dict(moe_state_dict_from_flax(tree))
    with torch.no_grad():
        logits, aux, dropped = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    assert float(aux) == pytest.approx(float(want[1]), rel=TOL)
    assert float(dropped) == pytest.approx(float(want[2]), abs=1e-7) and float(dropped) > 0
    with pytest.raises(ValueError, match="not divisible"):
        MoETransformerLM(n_experts=4, ep_size=3, device="cpu")
    tree = tree["params"]
    tree["MoEBlock_0"] = {k: v for k, v in tree["MoEBlock_0"].items() if k != "router"}
    with pytest.raises(ValueError, match="MoEBlock_0/router"):
        moe_state_dict_from_flax(tree)


def test_flat_order_and_active_params_equal_jax(trainers):
    jt, _ = trainers
    tt = MoETrainer(device="cpu", **KW)
    tt.set_flat_params(jt.get_flat_params())
    np.testing.assert_array_equal(tt.get_flat_params(), flatten_pytree(jt.params)[0])
    want = moe_state_dict_from_flax(jax.tree.map(np.asarray, jt.params))
    for name, p in tt.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)
    for k in (1, 2):
        assert moe_active_params(tt.model, k, 4) == jbench.moe_active_params(jt.params, k, 4)
    assert tt.param_count == jt.param_count


# -- the trainer -----------------------------------------------------------------


def _close(got, want):
    for name in ("loss", "aux_loss", "dropped"):
        g, w = getattr(got, name), getattr(want, name)
        assert abs(g - w) <= TOL * max(abs(w), 1e-6), (name, got, want)
    assert got.step == want.step and got.contributors == want.contributors


def _params_close(tt, jt):
    want = jt.get_flat_params()
    np.testing.assert_allclose(tt.get_flat_params(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_trainer_matches_jax_over_three_steps_then_a_bf16_moment_step(trainers):
    jt, jt16 = trainers
    batches = list(jdata.lm_copy_task(32, vocab=16).batches(4, 3))
    tt = MoETrainer(device="cpu", **KW)
    tt.set_flat_params(jt.get_flat_params())
    for x, y in batches:
        _close(tt.train_step(x, y), jt.train_step(x, y))
    _params_close(tt, jt)

    tt16 = MoETrainer(device="cpu", mu_dtype=torch.bfloat16, **KW)
    tt16.set_flat_params(jt16.get_flat_params())
    _close(tt16.train_step(*batches[0]), jt16.train_step(*batches[0]))
    _params_close(tt16, jt16)
    mu = [tt16.optimizer.state[p]["exp_avg"] for p in tt16.model.parameters()]
    nu = [tt16.optimizer.state[p]["exp_avg_sq"] for p in tt16.model.parameters()]
    assert {m.dtype for m in mu} == {torch.bfloat16} and {v.dtype for v in nu} == {
        torch.float32}
    assert {l.dtype for l in jax.tree.leaves(jt16.opt_state[0].mu)} == {jnp.dtype("bfloat16")}
    # the stored moment is the f32 one rounded to bf16, as optax stores it
    want_mu = flatten_pytree(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                          jt16.opt_state[0].mu))[0]
    got_mu = torch.cat([mu[i].float().reshape(-1) for i in _leaf_index(tt16)]).numpy()
    np.testing.assert_allclose(got_mu, want_mu, rtol=1e-2, atol=1e-7)


def _leaf_index(t: MoETrainer) -> list[int]:
    """Parameter positions in the JAX flat-vector order."""
    from akka_allreduce_tpu_torch.binder import leaf_order

    names = [n for n, _ in t.model.named_parameters()]
    return [names.index(n) for n in leaf_order(t.model)]


def test_masked_step_and_chain_and_refusals():
    t = MoETrainer(device="cpu", **KW)
    x, y = next(lm_copy_task(32, vocab=16).batches(4, 1))
    before = t.get_flat_params()
    m = t.train_step(x, y, valid=[0.0])
    assert (m.loss, m.aux_loss, m.dropped, m.contributors) == (0.0, 0.0, 0.0, 0.0)
    np.testing.assert_array_equal(t.get_flat_params(), before)  # zero grads, zero moments
    hist = t.train_chain(lm_copy_task(32, vocab=16).device_sampler(), 3, 2)
    assert [h.step for h in hist] == [2, 3, 4] and all(np.isfinite(h.loss) for h in hist)
    expert_axis = grid_mesh(1, 1, device="cpu", axes=("data", "expert"))
    for kw in (dict(mesh=line_mesh(2, axis="data", device="cpu")), dict(mesh=expert_axis),
               dict(compress="bf16"), dict(overlap=True)):
        u = MoETrainer(**{**KW, **dict(device="cpu"), **kw})
        m = u.train_step(x, y)
        assert np.isfinite(m.loss) and m.contributors == u.dp
    with pytest.raises(ValueError, match="batch"):
        t.train_step(x[:, :16], y[:, :16])
    # the JAX trainer's refusals
    with pytest.raises(ValueError, match="overlap excludes"):
        MoETrainer(device="cpu", compress="int8", overlap=True)
    with pytest.raises(ValueError, match="not divisible by ep=2"):
        MoETrainer(grid_mesh(1, 2, axes=("data", "expert"), device="cpu"), n_experts=3)
    with pytest.raises(ValueError, match="need a"):
        MoETrainer(RankMesh(("a", "b", "c", "d"), (1, 1, 1, 1), torch.device("cpu")))


def test_elastic_cycle_continues_like_a_fresh_trainer_from_the_snapshot():
    now = {"t": 0.0}
    e = ElasticMoETrainer({0: [0], 1: []}, n_experts=4, n_layers=1, seq_len=32,
                          capacity_factor=4.0, vocab=16, d_model=32, n_heads=2,
                          learning_rate=1e-2, seed=0, mu_dtype=torch.bfloat16,
                          clock=lambda: now["t"], device="cpu")
    ds = lm_copy_task(32, vocab=16)
    e.train_step(*next(ds.batches(1, 1, seed_offset=0)))
    for _ in range(10):  # node 1 silent: the mesh is rebuilt without it
        e.heartbeat(0)
        now["t"] += 1.0
    assert e.poll() and e.member_nodes == (0,) and (e.trainer.dp, e.trainer.ep) == (1, 1)
    e.train_step(*next(ds.batches(1, 1, seed_offset=1)))
    e.heartbeat(1)
    assert e.poll() and e.member_nodes == (0, 1) and e.generation == 2
    snap = Snapshot.capture(e.trainer)
    fresh = MoETrainer(line_mesh(1, axis="data", device="cpu"), n_experts=4, n_layers=1,
                       seq_len=32, capacity_factor=4.0, vocab=16, d_model=32, n_heads=2,
                       learning_rate=1e-2, seed=7, mu_dtype=torch.bfloat16)
    snap.restore_into(fresh)
    assert fresh.step_num == e.trainer.step_num == 2
    for s in (2, 3):
        x, y = next(ds.batches(1, 1, seed_offset=s))
        assert e.train_step(x, y) == fresh.train_step(x, y)
    np.testing.assert_array_equal(e.get_flat_params(), fresh.get_flat_params())
    two = ElasticMoETrainer({0: [0], 1: [1]}, n_experts=4, vocab=16, d_model=32, n_heads=2,
                            n_layers=1, seq_len=32, device="cpu")
    assert (two.trainer.dp, two.trainer.ep) == (1, 2)  # gcd(2 ranks, 4 experts)


def test_checkpoint_round_trip_keeps_the_bf16_moment(tmp_path):
    ds = list(lm_copy_task(32, vocab=16).batches(2, 3))
    a = MoETrainer(device="cpu", mu_dtype=torch.bfloat16, **KW)
    a.train_step(*ds[0])
    with TrainerCheckpointer(tmp_path) as ck:
        ck.save(a, force=True)
        b = MoETrainer(device="cpu", mu_dtype=torch.bfloat16, **{**KW, "seed": 3})
        assert ck.restore(b) == 1
    for x, y in ds[1:]:
        assert a.train_step(x, y) == b.train_step(x, y)
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sb["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(
            sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_train_moe_cli_on_the_cpu(capsys):
    assert cli_main(["train-moe", "--device", "cpu", "--vocab", "16", "--d-model", "32",
                     "--heads", "2", "--layers", "1", "--seq-len", "16", "--batch", "4",
                     "--steps", "12", "--lr", "3e-2", "--topk", "2", "--mu-bf16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("MoE params: ") and "mesh dp=1 x sp=1 x ep=1" in lines[0]
    trend = lines[-1].split("loss ")[1].split(" (aux")[0]
    first, last = (float(v) for v in trend.split(" -> "))
    assert lines[-1].startswith("moe: 12 steps on 1 devices") and last < first
    small = ["train-moe", "--device", "cpu", "--vocab", "16", "--d-model", "32", "--heads",
             "2", "--layers", "1", "--seq-len", "16", "--batch", "4", "--steps", "2"]
    for flag, mesh in ((["--dp", "2"], "dp=2 x sp=1 x ep=1"), (["--ep", "2"], "dp=1 x sp=1 x ep=2"),
                       (["--sp", "2"], "dp=1 x sp=2 x ep=1"),
                       (["--compress", "bf16"], "dp=1 x sp=1 x ep=1"),
                       (["--overlap"], "dp=1 x sp=1 x ep=1")):
        assert cli_main([*small, *flag]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert mesh in lines[0] and lines[-1].startswith("moe: 2 steps on ")
    with pytest.raises(ValueError, match="overlap excludes"):  # the JAX trainer's refusal
        cli_main([*small, "--compress", "int8", "--overlap"])
