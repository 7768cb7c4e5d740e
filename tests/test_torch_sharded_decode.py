"""The port's sharded decode against the JAX package's, on the CPU.

Same flax weights (``transformer_state_dict_from_flax``) and seeded numpy
tokens through ``akka_allreduce_tpu.models.LMGenerator`` with a mesh (JAX on
the 8-device virtual CPU mesh of ``tests/conftest.py``) and the port's
``LMGenerator`` over a ``RankMesh`` of virtual ranks, as
``tests/test_generate.py``'s ``TestTensorParallelDecode`` and
``TestSeqShardedDecode`` hold JAX's sharded decode against its one-device
decode:

- teacher-forced logits over ``(model,)``, ``(data, model)``, ``(seq,)``
  and ``(data, seq, model)`` meshes, MHA and GQA, within
  the JAX tests' 2e-5 of JAX's sharded decode, equal on every rank; a
  prefill chunk of 4 over 2-slot seq shards (it spans ranks); the int8
  cache within the JAX tests' 5e-3 of JAX's, inside its quantization band
  of the float forward;
- the blockwise local partials of ``seq_decode_attention`` (``_DENSE_MAX_T``
  set to 1 in both packages), with and without the int8 scales, against
  JAX's within 2e-5;
- the cache sharded over heads and slots: each rank's shape, and its global
  form equal to the one-device generator's cache; greedy tokens equal to
  the one-device generator's;
- the refusals, with the JAX messages; ``lm-generate --sp 2 --tp 2``.

The flax model and its weights are built once, in a module fixture; each
JAX generator's zero cache is made from ``init``'s shapes.
"""

from __future__ import annotations

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.models import LMGenerator as JGenerator
from akka_allreduce_tpu.models import TransformerLM as JTransformerLM
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.models import (
    LMGenerator,
    RankKVCache,
    TransformerLM,
    transformer_state_dict_from_flax,
)
from akka_allreduce_tpu_torch.parallel import RankMesh

# the ops packages re-export the functions under the modules' names
jla = importlib.import_module("akka_allreduce_tpu.ops.local_attention")
tla = importlib.import_module("akka_allreduce_tpu_torch.ops.local_attention")

TOL = 2e-5  # tests/test_generate.py's sharded-vs-one-device tolerance
INT8_TOL = 5e-3  # its int8 sharded-vs-fused tolerance
MAX_LEN = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny products: torch's intra-op workers only add their wake-ups."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lms():
    """n_kv -> (flax model, params, the port's model carrying them), and the
    tokens (2, 12): vocab 16, d 32, 4 heads, 2 layers (tests/test_generate.py's
    ``mk``)."""
    tokens = np.random.default_rng(1).integers(0, 16, (2, 12)).astype(np.int32)
    out = {}
    for n_kv in (None, 2):
        jmodel = JTransformerLM(vocab=16, d_model=32, n_heads=4, n_kv_heads=n_kv, n_layers=2)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
        model = TransformerLM(vocab=16, d_model=32, n_heads=4, n_kv_heads=n_kv, n_layers=2,
                              device="cpu")
        model.load_state_dict(transformer_state_dict_from_flax(
            jax.tree.map(np.asarray, params)))
        out[n_kv] = (jmodel, params, model)
    return out, tokens


def _jax_logits(jmodel, params, tokens, shape, names, quant, chunk) -> np.ndarray:
    """JAX's sharded ``decode_logits`` on a mesh of the first devices, its
    zero cache template (the zeros of ``init``'s cache shapes, which
    ``init_cache`` returns) placed as ``init_cache`` places it."""
    mesh = jax.make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])
    g = JGenerator(jmodel, max_len=MAX_LEN, cache_quant=quant, mesh=mesh)
    shapes = jax.eval_shape(g._global_decoder.init, jax.random.PRNGKey(0),
                            jnp.zeros((tokens.shape[0], 1), jnp.int32))["cache"]
    tmpl = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    g._cache_tmpl[tokens.shape[0]] = jax.device_put(tmpl, jax.tree.map(
        lambda s: NamedSharding(mesh, s), g._cache_specs(tmpl),
        is_leaf=lambda x: isinstance(x, P)))
    return np.asarray(g.decode_logits(g.place_params(params), jnp.asarray(tokens),
                                      chunk=chunk))


def _mesh(shape, names) -> RankMesh:
    return RankMesh(tuple(names), tuple(shape), torch.device("cpu"))


# (mesh shape, axes, n_kv, cache_quant, chunk)
CASES = {
    "tp2_mha": ((2,), ("model",), None, None, 1),
    "data_tp_int8": ((2, 2), ("data", "model"), 2, "int8", 1),
    "sp8_chunk_spans_ranks": ((8,), ("seq",), 2, None, 4),
    "sp8_mha_int8": ((8,), ("seq",), None, "int8", 1),
    "data_sp_tp": ((2, 2, 2), ("data", "seq", "model"), 2, None, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_logits_match_jax(lms, case):
    models, tokens = lms
    shape, names, n_kv, quant, chunk = CASES[case]
    jmodel, params, model = models[n_kv]
    want = _jax_logits(jmodel, params, tokens, shape, names, quant, chunk)
    gen = LMGenerator(model, MAX_LEN, cache_quant=quant, mesh=_mesh(shape, names))
    every = gen.decode_logits(torch.from_numpy(tokens), chunk=chunk, every_rank=True)
    assert every.shape == (int(np.prod(shape)), 2, 12, 16)
    assert all(torch.equal(every[0], every[r]) for r in range(every.shape[0]))
    got = every[0].numpy()
    one = LMGenerator(model, MAX_LEN, cache_quant=quant).decode_logits(
        torch.from_numpy(tokens), chunk=chunk).numpy()
    if quant is None:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, one, rtol=TOL, atol=TOL)
    else:
        # tests/test_generate.py:284 and :366: the next layer's round()
        # amplifies reassociation dust to an int8 step, so sharded and fused
        # agree loosely, both inside the quantization band of the forward
        np.testing.assert_allclose(got, want, rtol=INT8_TOL, atol=INT8_TOL)
        with torch.no_grad():
            exact = model(torch.from_numpy(tokens)).numpy()
        band_one, band = np.abs(one - exact).max(), np.abs(got - exact).max()
        assert band < 1.5 * band_one + 1e-3, (band_one, band)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_blockwise_prefill_partials_match_jax(lms, quant, monkeypatch):
    """Every seq rank's local partial through ``_blockwise_olm`` (the dense
    gate shrunk to 1 in both packages), merged by the rescaled psums, over
    seq x model (4 x 2) for the float cache and seq 8 for the int8 one."""
    models, tokens = lms
    jmodel, params, model = models[2]
    shape, names = ((4, 2), ("seq", "model")) if quant is None else ((8,), ("seq",))
    monkeypatch.setattr(jla, "_DENSE_MAX_T", 1)
    monkeypatch.setattr(tla, "_DENSE_MAX_T", 1)
    calls = []
    real = tla._blockwise_olm

    def counted(*a, **k):
        calls.append(k["k_scale"] is not None)
        return real(*a, **k)

    monkeypatch.setattr(tla, "_blockwise_olm", counted)
    want = _jax_logits(jmodel, params, tokens, shape, names, quant, 4)
    gen = LMGenerator(model, MAX_LEN, cache_quant=quant, mesh=_mesh(shape, names))
    got = gen.decode_logits(torch.from_numpy(tokens), chunk=4).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert calls == [quant == "int8"] * 6  # 3 chunks x 2 layers, scales iff int8


def test_caches_are_sharded_and_tokens_match_one_device(lms):
    models, tokens = lms
    model = models[2][2]
    x = torch.from_numpy(tokens)
    one = LMGenerator(model, MAX_LEN)
    cache1 = one.init_cache(2)
    one.step(cache1, x)
    for shape, names, local in (((2,), ("model",), (2, 16, 1, 8)),
                                ((8,), ("seq",), (2, 2, 2, 8)),
                                ((4, 2), ("seq", "model"), (2, 4, 1, 8))):
        gen = LMGenerator(model, MAX_LEN, mesh=_mesh(shape, names))
        cache = gen.init_cache(2)
        assert isinstance(cache, RankKVCache) and cache.max_len == MAX_LEN
        assert cache.k[0].shape == (int(np.prod(shape)), *local)
        filled = gen.init_cache(2)
        gen.step(filled, x)
        whole = gen.global_cache(filled)
        assert whole.index == cache1.index == 12
        for a, b in zip(whole.k + whole.v, cache1.k + cache1.v):
            assert a.shape == (2, MAX_LEN, 2, 8)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
        assert torch.equal(gen.generate(x[:, :4], 8), one.generate(x[:, :4], 8))
    q = LMGenerator(model, MAX_LEN, cache_quant="int8", mesh=_mesh((4, 2), ("seq", "model")))
    c = q.init_cache(2)
    assert c.k[0].dtype == torch.int8 and c.k_scale[0].shape == (8, 2, 4, 1)
    with pytest.raises(ValueError, match="unknown cache variable"):
        q._cache_spec("cached_x")


def test_refusals_match_jax(lms):
    models, _ = lms
    jmodel, _, model = models[None]
    for names, shape, match in ((("data",), (2,), "'seq' and/or 'model' axis"),
                                (("seq",), (8,), "max_len=15 must divide"),
                                (("model",), (8,), "must both divide")):
        jmesh = jax.make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])
        for make, mesh in ((JGenerator, jmesh), (LMGenerator, _mesh(shape, names))):
            with pytest.raises(ValueError, match=match):
                make(jmodel if make is JGenerator else model, 15, mesh=mesh)
    with pytest.raises(TypeError, match="RankKVCache"):
        model.decode_ranks(torch.zeros((2, 1, 1), dtype=torch.int64),
                           LMGenerator(model, 16).init_cache(1), _mesh((2,), ("model",)))


def test_lm_generate_sp_tp_on_the_cpu(capsys):
    assert cli_main(["lm-generate", "--device", "cpu", "--vocab", "16", "--d-model", "32",
                     "--heads", "4", "--kv-heads", "2", "--layers", "1", "--batch", "2",
                     "--prompt-len", "5", "--gen", "4", "--sp", "2", "--tp", "2",
                     "--cache-quant", "int8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert (rec["sp"], rec["tp"], rec["cache_quant"]) == (2, 2, "int8")
    assert "cache (B,10,2,8) int8-quantized" in lines[2]
