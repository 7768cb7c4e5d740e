"""The port's int8 KV cache against the JAX package's, on the CPU.

- ``quantize``: the payloads and scales the JAX ``Attention`` writes into its
  int8 cache, bit for bit, in f32 and bf16. Both modules quantize the same
  K: a one-token chunk at position 0 (rope is the identity there) through a
  K projection set to the identity, in the JAX module's jitted apply;
- ``quantized_cache_attention`` against JAX's on the same int8 payloads and
  scales, within 1e-5 (MHA and GQA, a nonzero ``q_offset``);
- ``LMGenerator(cache_quant="int8").decode_logits`` against JAX's (its
  per-chunk apply jitted) within 1e-4 of max|logit|: at ``chunk=1`` (the
  fused branch every step) and at ``chunk=12`` with ``_DENSE_MAX_T`` set to
  4 in both packages, where the 12-token chunk takes the dequantize branch
  (``local_attention`` over one dequantized copy) on both sides and the
  port's fused calls drop from 2 a token to none;
- a gated int8 prefill (T 1024, D 32) reaches K4 (its plain version on the
  CPU) once a layer and agrees with the fused branch within 1e-4 of
  max|logit|;
- the cache's layout and bytes, and the refusal of another ``cache_quant``
  with the JAX message on both sides.

The JAX model and its weights are built once, in a module fixture.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import LMGenerator as JGenerator
from akka_allreduce_tpu.models import TransformerLM as JTransformerLM
from akka_allreduce_tpu.models.transformer import Attention as JAttention
from akka_allreduce_tpu_torch.models import (
    LMGenerator,
    TransformerLM,
    transformer_state_dict_from_flax,
)
from akka_allreduce_tpu_torch.models.transformer import quantize
from akka_allreduce_tpu_torch.ops import flash_attention as fa
from akka_allreduce_tpu_torch.ops import local_attention as la

# the JAX ops package re-exports the function under the module's name
jla = importlib.import_module("akka_allreduce_tpu.ops.local_attention")

LOGIT_TOL = 1e-4  # relative to max|logit|


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny products: torch's intra-op workers only add their wake-ups."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """(flax model, params, the port's model carrying them, tokens (2, 12)):
    vocab 16, d 32, 4 heads over 2 KV heads, 2 layers."""
    jmodel = JTransformerLM(vocab=16, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2)
    tokens = np.random.default_rng(1).integers(0, 16, (2, 12)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
    model = TransformerLM(vocab=16, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
                          device="cpu")
    model.load_state_dict(transformer_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model, tokens


def _jax_decode_logits(jmodel, params, tokens, chunk: int) -> np.ndarray:
    """JAX's int8 ``decode_logits``, its per-chunk apply jitted and its zero
    cache made by a jitted ``init``."""
    jgen = JGenerator(jmodel, max_len=16, cache_quant="int8")
    variables = jax.jit(jgen._global_decoder.init)(
        jax.random.PRNGKey(0), jnp.zeros((tokens.shape[0], 1), jnp.int32))
    jgen._cache_tmpl[tokens.shape[0]] = variables["cache"]
    apply = jax.jit(jgen._apply)
    cache = jgen.init_cache(tokens.shape[0])
    outs = []
    for i in range(0, tokens.shape[1], chunk):
        logits, cache = apply(params, cache, jnp.asarray(tokens[:, i:i + chunk]))
        outs.append(np.asarray(logits))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_bit_equal_to_the_jax_cache(dtype):
    heads, d = 4, 16
    x = (np.random.default_rng(2).standard_normal((64, 1, heads * d)) * 3).astype(np.float32)
    x[5] = 0.0  # an all-zero row: the 1e-8 floor on the scale
    jdt = getattr(jnp, dtype)
    attn = JAttention(heads, decode=True, max_decode_len=2, cache_quant="int8",
                      compute_dtype=jdt)
    variables = jax.jit(attn.init)(jax.random.PRNGKey(0), jnp.zeros((64, 1, heads * d)))
    params = dict(variables["params"])
    params["k"] = {"kernel": jnp.eye(heads * d).reshape(heads * d, heads, d),
                   "bias": jnp.zeros((heads, d))}
    cache = jax.tree.map(jnp.zeros_like, variables["cache"])
    _, out = jax.jit(lambda p, c, x: attn.apply({"params": p, "cache": c}, x,
                                                mutable=["cache"]))(
        params, cache, jnp.asarray(x).astype(jdt))
    want_q = np.asarray(out["cache"]["cached_k"])[:, 0]
    want_s = np.asarray(out["cache"]["k_scale"])[:, 0]
    got_q, got_s = quantize(torch.from_numpy(x).to(getattr(torch, dtype)).reshape(
        64, heads, d))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert bool((got_q[5] == 0).all()) and bool((got_s[5] > 0).all())


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_quantized_cache_attention_matches_jax(kv_heads):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (2, 10, kv_heads, 8)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.05, (2, 10, kv_heads)).astype(np.float32) for _ in range(2))
    want = jla.quantized_cache_attention(*map(jnp.asarray, (q, kq, ks, vq, vs)), q_offset=7)
    got = la.quantized_cache_attention(*map(torch.from_numpy, (q, kq, ks, vq, vs)),
                                       q_offset=7)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_decode_logits_match_jax_on_both_branches(lm, monkeypatch):
    jmodel, params, model, tokens = lm
    calls = {"fused": 0}
    real = la.quantized_cache_attention

    def spy(*a, **kw):
        calls["fused"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(la, "quantized_cache_attention", spy)
    gen = LMGenerator(model, max_len=16, cache_quant="int8")
    tt = torch.from_numpy(tokens)
    got = gen.decode_logits(tt, chunk=1).numpy()
    want = _jax_decode_logits(jmodel, params, tokens, 1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale)
    assert calls["fused"] == 2 * 12  # every layer, every token
    monkeypatch.setattr(la, "_DENSE_MAX_T", 4)
    monkeypatch.setattr(jla, "_DENSE_MAX_T", 4)
    calls["fused"] = 0
    got12 = gen.decode_logits(tt, chunk=12).numpy()
    assert calls["fused"] == 0  # the 12-token chunk dequantizes in both layers
    want12 = _jax_decode_logits(jmodel, params, tokens, 12)
    np.testing.assert_allclose(got12, want12, rtol=0, atol=LOGIT_TOL * scale)
    # the two branches: different reductions, the same function
    np.testing.assert_allclose(got12, got, rtol=0, atol=2e-2)


def test_gated_int8_prefill_reaches_k4_and_matches_the_fused_branch(monkeypatch):
    shapes = []
    real = la.flash_attention
    monkeypatch.setattr(la, "flash_attention",
                        lambda *a, **kw: shapes.append(a[0].shape) or real(*a, **kw))
    model = TransformerLM(vocab=16, d_model=64, n_heads=2, n_layers=1, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 16, (1, 1024)))
    gen = LMGenerator(model, max_len=1024 + 8, cache_quant="int8")
    before = dict(fa.LAUNCHES)
    with torch.no_grad():
        got = model(tokens, gen.init_cache(1))
    assert shapes == [(1, 1024, 2, 32)] and fa.LAUNCHES == before  # plain K4 on the CPU
    monkeypatch.setattr(la, "_DENSE_MAX_T", 1 << 20)  # every chunk fused
    with torch.no_grad():
        want = model(tokens, gen.init_cache(1))
    assert len(shapes) == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=LOGIT_TOL * float(want.abs().max()))


def test_cache_layout_bytes_and_refusal(lm):
    jmodel, params, model, tokens = lm
    q8 = LMGenerator(model, max_len=16, cache_quant="int8").init_cache(2)
    f32 = LMGenerator(model, max_len=16).init_cache(2)
    assert q8.quantized and not f32.quantized and q8.max_len == 16
    assert q8.k[0].dtype == torch.int8 and q8.k[0].shape == (2, 16, 2, 8)
    assert q8.k_scale[0].dtype == torch.float32 and q8.k_scale[0].shape == (2, 16, 2)

    def nbytes(c):
        return sum(t.numel() * t.element_size()
                   for t in c.k + c.v + (c.k_scale or []) + (c.v_scale or []))

    assert nbytes(q8) / nbytes(f32) == (8 + 4) / (8 * 4)  # D + 4 bytes a row vs 4 D
    with pytest.raises(ValueError, match="cache_quant must be None or 'int8'"):
        LMGenerator(model, max_len=16, cache_quant="fp4").decode_logits(
            torch.from_numpy(tokens[:, :2]))
    with pytest.raises(ValueError, match="cache_quant must be None or 'int8'"):
        JGenerator(jmodel, max_len=16, cache_quant="fp4").decode_logits(
            params, tokens[:, :2], chunk=1)
