"""The port's tensor parallelism and sharded-tree gradient sums against the
JAX package's, on the CPU.

Same seeded numpy inputs through ``akka_allreduce_tpu`` (JAX on the
8-device virtual CPU mesh of ``tests/conftest.py``) and
``akka_allreduce_tpu_torch`` (8 virtual ranks):

- ``data_seq_model_mesh``'s shape and axes; ``tp_param_specs`` on the
  port's leaf names equal to JAX's on the same leaves' flax paths; each
  rank's view of a TP leaf its model shard (``tests/test_tensor_parallel.py``'s
  shard shapes);
- ``grouped_tree_psum`` over a tree of a replicated class (every axis) and
  a TP class (data and seq), f32, bf16 and int8, against JAX's inside
  ``shard_map``: f32 and bf16 bit for bit, int8 within 1e-6 of max|sum|
  (XLA contracts the ring's ``cur + q * scale`` into an FMA on the CPU);
- three ``LongContextTrainer`` steps on ``data_seq_model_mesh(2, 2, 2)``
  against JAX's, the second with replica row 1 masked: f32 ring, Ulysses
  with bf16 compression, int8 compression and ``overlap``: contributors
  equal, losses within 1e-5 relative, the parameters within rtol 1e-5,
  atol 1e-5 (``tests/test_torch_seq_parallel.py``'s Adam hazard); int8
  also within the JAX test's band of the port's f32 run
  (``tests/test_compress_sharded.py``: loss 5e-2 relative, drift 0.1 of
  max|param|);
- the refusals: indivisible heads and overlap with int8, with the JAX
  messages.

The JAX trainers are built once each, in a module fixture.
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
from akka_allreduce_tpu.models.transformer import tp_param_specs as j_tp_param_specs
from akka_allreduce_tpu.parallel import data_seq_model_mesh as j_dsmm
from akka_allreduce_tpu.train import LongContextTrainer as JTrainer
from akka_allreduce_tpu_torch.models import TransformerLM, tp_param_specs
from akka_allreduce_tpu_torch.models.convert import flax_path
from akka_allreduce_tpu_torch.parallel import data_seq_model_mesh, rank_view
from akka_allreduce_tpu_torch.train import LongContextTrainer

jar = importlib.import_module("akka_allreduce_tpu.comm.allreduce")
tar = importlib.import_module("akka_allreduce_tpu_torch.comm.allreduce")
TOL = 1e-5
KW = dict(vocab=16, d_model=32, n_heads=4, n_layers=1, seq_len=32, learning_rate=1e-3)
INT8_LOSS_TOL, INT8_DRIFT_TOL = 5e-2, 0.1  # tests/test_compress_sharded.py's band
BATCHES = [next(jdata.lm_copy_task(32, vocab=16).batches(4, 1, seed_offset=i))
           for i in range(3)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny products: torch's intra-op workers only add their wake-ups."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_data_seq_model_mesh_matches_jax():
    for dp, sp, tp in ((2, 2, 2), (1, 2, 4)):
        want = j_dsmm(dp, sp, tp)
        got = data_seq_model_mesh(dp, sp, tp, device="cpu")
        assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)


def test_tp_param_specs_match_jax():
    cfg = dict(vocab=16, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2)
    params = jax.eval_shape(JTransformerLM(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    want = j_tp_param_specs(params, "model")["params"]
    got = tp_param_specs(TransformerLM(**cfg, device="cpu"), "model")
    assert len(got) == len(jax.tree.leaves(params))
    for name, spec in got.items():
        node = want
        for key in flax_path(name):
            node = node[key]
        assert spec == tuple(node), name
    assert got["blocks.0.attn.q_kernel"] == (None, "model", None)
    assert got["embedding"] == ()


def test_rank_views_hold_model_shards():
    """As ``tests/test_tensor_parallel.py`` reads JAX's shards: at tp 4 each
    rank sees one of 4 heads of ``q`` and a quarter of ``mlp_up``."""
    model = TransformerLM(vocab=16, d_model=32, n_heads=4, n_layers=1, device="cpu",
                          seq_axis="seq", model_axis="model", tp_size=4)
    mesh = data_seq_model_mesh(1, 2, 4, device="cpu")
    views = model.rank_views(mesh)
    q = model.blocks[0].attn.q_kernel
    assert q.shape == (32, 4, 8) and views["blocks.0.attn.q_kernel"].shape[3:] == (32, 1, 8)
    assert views["blocks.0.mlp_up_kernel"].shape[3:] == (32, 32)
    assert torch.equal(views["blocks.0.attn.q_kernel"][0, 1, 2], q[:, 2:3])
    emb = views["embedding"]  # replicated: a view of the one copy
    assert emb.data_ptr() == model.embedding.data_ptr() and emb.stride()[1:3] == (0, 0)


# -- grouped_tree_psum ------------------------------------------------------

SHAPES = {"a": (3, 40), "b": (40, 8), "c": (5,)}  # a, c replicated; b TP
SPECS = {"a": (), "b": (None, "model"), "c": ()}


def _local_shape(name):
    shape = list(SHAPES[name])
    if name == "b":
        shape[1] //= 2
    return tuple(shape)


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_grouped_tree_psum_matches_jax(wire):
    rng = np.random.default_rng(3)
    per_rank = {n: rng.standard_normal((2, 2, 2, *_local_shape(n))).astype(np.float32)
                for n in SHAPES}
    mesh = j_dsmm(2, 2, 2)
    axes = ("data", "seq", "model")
    rank_spec = P("data", "seq", "model")
    jspecs = {n: P(*s) for n, s in SPECS.items()}

    def body(tree):
        local = {n: t.reshape(t.shape[3:]) for n, t in tree.items()}
        out = jar.grouped_tree_psum(local, jspecs, axes, wire)
        return {n: t.reshape(1, 1, 1, *t.shape) for n, t in out.items()}

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=({n: rank_spec for n in SHAPES},),
                               out_specs={n: rank_spec for n in SHAPES}, check_vma=False))
    want = jax.device_get(fn({n: jax.device_put(a, NamedSharding(mesh, rank_spec))
                              for n, a in per_rank.items()}))
    tmesh = data_seq_model_mesh(2, 2, 2, device="cpu")
    got = tar.grouped_tree_psum(tmesh, {n: torch.from_numpy(a) for n, a in per_rank.items()},
                                SPECS, wire_dtype=wire)
    for name, full in got.items():
        assert tuple(full.shape) == SHAPES[name]
        for d, s, m in np.ndindex(2, 2, 2):
            mine = full.numpy() if name != "b" else full.numpy()[:, m * 4:(m + 1) * 4]
            theirs = want[name][d, s, m]
            if wire == "int8":
                np.testing.assert_allclose(mine, theirs, rtol=0,
                                           atol=1e-6 * np.abs(theirs).max())
            else:
                np.testing.assert_array_equal(mine, theirs)


def test_grouped_tree_psum_on_a_view_tree_counts_once():
    """A tree of replicated rank views (every rank the same leaf) sums to
    the rank count times the leaf, each TP shard to the data x seq count."""
    mesh = data_seq_model_mesh(2, 2, 2, device="cpu")
    leaf = torch.arange(40 * 8, dtype=torch.float32).reshape(40, 8)
    views = {n: rank_view(leaf, SPECS[n], mesh).contiguous() for n in ("a", "b")}
    got = tar.grouped_tree_psum(mesh, views, {"a": (), "b": (None, "model")})
    torch.testing.assert_close(got["a"], 8 * leaf, rtol=0, atol=0)
    torch.testing.assert_close(got["b"], 4 * leaf, rtol=0, atol=0)


# -- the trainer --------------------------------------------------------------

CASES = {
    "ring": dict(seq_impl="ring"),
    "ulysses_bf16": dict(seq_impl="ulysses", compress="bf16"),
    "int8": dict(seq_impl="ring", compress="int8"),
    "overlap": dict(seq_impl="ring", overlap=True),
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
    jt = JTrainer(j_dsmm(2, 2, 2), **KW, **CASES[request.param])
    assert jt.tp == 2
    init = jt.get_flat_params().copy()
    return request.param, init, _steps(jt)


def _port(init, **kw):
    tt = LongContextTrainer(data_seq_model_mesh(2, 2, 2, device="cpu"), device="cpu",
                            **KW, **kw)
    tt.set_flat_params(init)
    return tt


def test_tp_trainer_matches_jax_three_steps(jax_run):
    name, init, (want, want_params) = jax_run
    tt = _port(init, **CASES[name])
    assert (tt.dp, tt.sp, tt.tp, tt.n_devices) == (2, 2, 2, 8)
    got, params = _steps(tt)
    for (gl, gc), (wl, wc) in zip(got, want):
        assert gc == wc and abs(gl - wl) <= TOL * abs(wl), (got, want)
    assert [c for _, c in got] == [2.0, 1.0, 2.0]
    np.testing.assert_allclose(params, want_params, rtol=TOL, atol=TOL)
    if name == "int8":  # and the JAX test's band against the f32 wire
        f32, f32_params = _steps(_port(init, seq_impl="ring"))
        for (gl, gc), (fl, fc) in zip(got, f32):
            assert gc == fc and abs(gl - fl) < INT8_LOSS_TOL * max(1.0, abs(fl))
        drift = np.abs(params - f32_params).max() / np.abs(f32_params).max()
        assert drift < INT8_DRIFT_TOL


def test_tp_refusals_carry_the_jax_messages():
    with pytest.raises(ValueError, match="divi"):
        LongContextTrainer(data_seq_model_mesh(2, 1, 4, device="cpu"), vocab=16,
                           d_model=36, n_heads=6, n_layers=1, seq_len=16)
    with pytest.raises(ValueError) as want:
        JTrainer(j_dsmm(2, 2, 2), compress="int8", overlap=True, **KW)
    with pytest.raises(ValueError) as got:
        _port(None, compress="int8", overlap=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="shards over every mesh axis"):
        tar.backward_tree_sync({"x": (("data", "seq", "model"),)},
                               data_seq_model_mesh(2, 2, 2, device="cpu"))(
            {"x": torch.zeros(8)}, torch.ones(8))
