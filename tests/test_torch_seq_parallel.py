"""The port's sequence parallelism against the JAX package's, on the CPU.

Same seeded numpy inputs through ``akka_allreduce_tpu`` (JAX on the
8-device virtual CPU mesh of ``tests/conftest.py``, inside ``shard_map``)
and ``akka_allreduce_tpu_torch`` (virtual ranks, the rank stack in rank
order):

- ``ring_attention`` and ``ulysses_attention`` at n 2 and 4, causal and
  not, within 2e-5 of JAX's (``tests/test_ring_attention.py``'s
  tolerance), grouped-query K/V with 1 and 2 KV heads (Ulysses with 1 KV
  head of 2 ranks expands K/V before the exchange, with 2 it moves the
  compact form), and both schedules' gradients within 2e-4; Ulysses'
  refusal of indivisible heads with the JAX message;
- the sequence-sharded ``TransformerLM`` forward at sp 4, ring and Ulysses,
  flax weights carried in by ``models/convert.py``: within 3e-5 of JAX's
  sharded forward;
- three ``LongContextTrainer`` steps on ``data_seq_mesh(2, 2)``, ring and
  Ulysses, the second step with replica row 1 masked, and ``overlap`` with
  bf16 compression on ``data_seq_mesh(2, 4)`` (Ulysses, as
  ``tests/test_compress_sharded.py`` runs it): contributors equal, losses
  within 1e-5 relative, the flat parameters within rtol 1e-5, atol 1e-5
  after the three steps (Adam at lr 1e-3: a first Adam step is nearly a
  sign step, so a gradient entry at noise level moves its parameter by a
  share of the learning rate on either side; atol 1e-5 holds it);
- ``train_chain`` on ``data_seq_mesh(2, 2)``: each replica row draws its
  own stream, a masked row counts no contributor;
- ``ElasticLongContextTrainer`` over 4 nodes of one rank against JAX's over
  4 devices, through a drop (sp 4 -> 1, dp 1 -> 3) and a rejoin: the same
  shapes and contributors, losses and parameters within the trainer
  tolerance above.

The JAX trainers are built once each, in module fixtures.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.models import TransformerLM as JTransformerLM
from akka_allreduce_tpu.models import data as jdata
from akka_allreduce_tpu.parallel import data_seq_mesh as j_data_seq_mesh
from akka_allreduce_tpu.parallel import line_mesh as j_line_mesh
from akka_allreduce_tpu.train import ElasticLongContextTrainer as JElasticLC
from akka_allreduce_tpu.train import LongContextTrainer as JTrainer
from akka_allreduce_tpu_torch.models import SyntheticCopyLM, TransformerLM
from akka_allreduce_tpu_torch.models.convert import transformer_state_dict_from_flax
from akka_allreduce_tpu_torch.parallel import data_seq_mesh, line_mesh
from akka_allreduce_tpu_torch.train import ElasticLongContextTrainer, LongContextTrainer

# the modules (each package's ``ops`` exports a function of that name)
jra = importlib.import_module("akka_allreduce_tpu.ops.ring_attention")
tra = importlib.import_module("akka_allreduce_tpu_torch.ops.ring_attention")

ATTN_TOL = 2e-5
GRAD_TOL = 2e-4
LOGIT_TOL = 3e-5
TOL = 1e-5
KW = dict(vocab=16, d_model=32, n_heads=4, n_layers=1, seq_len=32, learning_rate=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny products: torch's intra-op workers only add their wake-ups."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b=2, t=32, h=4, d=16, h_kv=None, seed=0):
    rng = np.random.default_rng(seed)
    kv = (b, t, h if h_kv is None else h_kv, d)
    return (rng.standard_normal((b, t, h, d), np.float32),
            rng.standard_normal(kv, np.float32), rng.standard_normal(kv, np.float32))


def _jax_sharded(impl, n, causal, qkv):
    mesh = j_line_mesh(n, axis="seq")
    spec = P(None, "seq")
    fn = jax.jit(jax.shard_map(lambda q, k, v: impl(q, k, v, "seq", causal=causal),
                               mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    return np.asarray(fn(*(jax.device_put(x, NamedSharding(mesh, spec)) for x in qkv)))


def _stack(x: torch.Tensor, n: int) -> torch.Tensor:
    """A global (B, T, ...) tensor as the rank stack (n, B, T/n, ...)."""
    b, t = x.shape[:2]
    return x.reshape(b, n, t // n, *x.shape[2:]).transpose(0, 1).contiguous()


def _unstack(y: torch.Tensor) -> torch.Tensor:
    n, b, t = y.shape[:3]
    return y.transpose(0, 1).reshape(b, n * t, *y.shape[3:])


def _port_sharded(impl, n, causal, qkv):
    mesh = line_mesh(n, device="cpu", axis="seq")
    q, k, v = (_stack(torch.from_numpy(a), n) for a in qkv)
    return _unstack(impl(q, k, v, mesh, "seq", causal=causal)).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_schedules_match_jax(impl, n, causal):
    qkv = _qkv()
    want = _jax_sharded(getattr(jra, f"{impl}_attention"), n, causal, qkv)
    got = _port_sharded(getattr(tra, f"{impl}_attention"), n, causal, qkv)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("impl,n,h_kv", [("ring", 4, 1), ("ring", 2, 2),
                                          ("ulysses", 2, 1), ("ulysses", 2, 2)])
def test_grouped_query_schedules_match_jax(impl, n, h_kv):
    qkv = _qkv(h_kv=h_kv, seed=1)
    want = _jax_sharded(getattr(jra, f"{impl}_attention"), n, True, qkv)
    got = _port_sharded(getattr(tra, f"{impl}_attention"), n, True, qkv)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_schedule_gradients_match_jax(impl):
    n = 4
    qkv = _qkv(b=1, t=16, h=4, d=8, seed=2)
    mesh = j_line_mesh(n, axis="seq")
    spec = P(None, "seq")
    jfn = getattr(jra, f"{impl}_attention")

    def jloss(q, k, v):
        out = jax.shard_map(lambda q, k, v: jfn(q, k, v, "seq", causal=True), mesh=mesh,
                            in_specs=(spec,) * 3, out_specs=spec)(q, k, v)
        return jnp.sum(out ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*qkv)
    tmesh = line_mesh(n, device="cpu", axis="seq")
    q, k, v = (_stack(torch.from_numpy(a), n).requires_grad_() for a in qkv)
    out = getattr(tra, f"{impl}_attention")(q, k, v, tmesh, "seq", causal=True)
    (out ** 2).sum().backward()
    for g, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(_unstack(g).numpy(), np.asarray(w), rtol=0, atol=GRAD_TOL)


def test_ulysses_refuses_indivisible_heads():
    q, k, v = (_stack(torch.from_numpy(a), 8) for a in _qkv(h=4))
    with pytest.raises(ValueError) as got:
        tra.ulysses_attention(q, k, v, line_mesh(8, device="cpu", axis="seq"), "seq")
    with pytest.raises(ValueError) as want:
        _jax_sharded(jra.ulysses_attention, 8, False, _qkv(h=4))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seq_impl", ["ring", "ulysses"])
def test_sharded_transformer_forward_matches_jax(seq_impl):
    sp, t = 4, 32
    tokens = np.random.default_rng(0).integers(0, 64, (2, t)).astype(np.int32)
    cfg = dict(vocab=64, d_model=32, n_heads=4, n_layers=2)
    params = jax.jit(JTransformerLM(**cfg).init)(jax.random.PRNGKey(1), jnp.asarray(tokens))
    mesh = j_line_mesh(sp, axis="seq")
    spec = P(None, "seq")
    sharded = JTransformerLM(**cfg, seq_axis="seq", seq_impl=seq_impl)
    fn = jax.jit(jax.shard_map(lambda p, x: sharded.apply(p, x), mesh=mesh,
                               in_specs=(P(), spec), out_specs=spec))
    want = np.asarray(fn(params, jax.device_put(tokens, NamedSharding(mesh, spec))))
    model = TransformerLM(**cfg, seq_axis="seq", seq_impl=seq_impl, device="cpu")
    model.load_state_dict(transformer_state_dict_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = model(_stack(torch.from_numpy(tokens).long(), sp),
                    mesh=line_mesh(sp, device="cpu", axis="seq"))
    np.testing.assert_allclose(_unstack(got).numpy(), want, rtol=0, atol=LOGIT_TOL)


# -- the trainer --------------------------------------------------------------

BATCHES = [next(jdata.lm_copy_task(32, vocab=16).batches(4, 1, seed_offset=i))
           for i in range(3)]
CASES = {
    "ring": ((2, 2), dict(seq_impl="ring")),
    "ulysses": ((2, 2), dict(seq_impl="ulysses")),
    "ulysses_overlap_bf16": ((2, 4), dict(seq_impl="ulysses", overlap=True,
                                          compress="bf16")),
}


def _steps(trainer):
    """Three steps of BATCHES, replica row 1 masked at the second."""
    out = []
    for i, (x, y) in enumerate(BATCHES):
        m = trainer.train_step(x, y, [1.0, 0.0] if i == 1 else None)
        out.append((m.loss, m.contributors))
    return out, trainer.get_flat_params()


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_run(request):
    (dp, sp), kw = CASES[request.param]
    jt = JTrainer(j_data_seq_mesh(dp, sp), **KW, **kw)
    init = jt.get_flat_params().copy()
    return request.param, init, _steps(jt)


def test_trainer_matches_jax_three_steps(jax_run):
    name, init, (want, want_params) = jax_run
    (dp, sp), kw = CASES[name]
    tt = LongContextTrainer(data_seq_mesh(dp, sp, device="cpu"), device="cpu", **KW, **kw)
    assert (tt.n_devices, tt.data_shards) == (dp * sp, dp)
    tt.set_flat_params(init)
    got, params = _steps(tt)
    for (gl, gc), (wl, wc) in zip(got, want):
        assert gc == wc and abs(gl - wl) <= TOL * abs(wl), (got, want)
    assert [c for _, c in got] == [2.0, 1.0, 2.0]
    np.testing.assert_allclose(params, want_params, rtol=TOL, atol=TOL)


def test_train_chain_draws_a_stream_a_replica_row():
    trainer = LongContextTrainer(data_seq_mesh(2, 2, device="cpu"), device="cpu", **KW)
    seen = []
    sampler = SyntheticCopyLM(32, vocab=16).device_sampler()

    def spy(gen, rows):
        x, y = sampler(gen, rows)
        seen.append(x)
        return x, y

    hist = trainer.train_chain(spy, 2, 2)
    assert [m.contributors for m in hist] == [2.0, 2.0] and len(seen) == 4
    assert seen[0].shape == (2, 32) and not torch.equal(seen[0], seen[1])
    masked = trainer.train_chain(sampler, 1, 2, valid=[0.0, 1.0])
    assert masked[0].contributors == 1.0 and np.isfinite(masked[0].loss)


# -- elastic -----------------------------------------------------------------

ELASTIC = dict(seq_len=32, vocab=16, d_model=32, n_heads=2, n_layers=1,
               learning_rate=1e-3, seed=0)


def _elastic_cycle(e, now):
    """2 steps on 4 ranks, node 3 silent until the re-mesh, 1 step, node 3
    back, 1 step; 2 rows a replica row."""
    ds = jdata.lm_copy_task(32, vocab=16)
    record = []

    def step(i):
        x, y = next(ds.batches(2 * e.trainer.dp, 1, seed_offset=i))
        m = e.train_step(x, y)
        record.append(((e.trainer.dp, e.trainer.sp), m.contributors, m.loss,
                       e.get_flat_params().copy()))

    def beat(alive):
        for n in alive:
            e.heartbeat(n)
        now["t"] += 1.0

    for i in range(2):
        beat(range(4))
        step(i)
    for _ in range(10):
        beat(range(3))
    assert e.poll()
    step(2)
    e.heartbeat(3)
    assert e.poll()
    step(3)
    return record


@pytest.fixture(scope="module")
def jax_elastic():
    now = {"t": 0.0}
    devices = jax.devices()
    e = JElasticLC({n: devices[n:n + 1] for n in range(4)}, clock=lambda: now["t"], **ELASTIC)
    return e.get_flat_params().copy(), _elastic_cycle(e, now)


def test_elastic_cycle_matches_jax(jax_elastic):
    init, want = jax_elastic
    now = {"t": 0.0}
    e = ElasticLongContextTrainer({n: [n] for n in range(4)}, clock=lambda: now["t"],
                                  device="cpu", **ELASTIC)
    e.set_flat_params(init)
    got = _elastic_cycle(e, now)
    assert [g[0] for g in got] == [(1, 4), (1, 4), (3, 1), (1, 4)]
    for (gs, gc, gl, gp), (ws, wc, wl, wp) in zip(got, want):
        assert gs == ws and gc == wc and abs(gl - wl) <= TOL * abs(wl)
        np.testing.assert_allclose(gp, wp, rtol=TOL, atol=TOL)
