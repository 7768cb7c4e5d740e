"""The port's Transformer LM and its decoder against the JAX package's, on
the CPU.

Flax weights are carried into the port (``transformer_state_dict_from_flax``)
and the same seeded tokens go through both:

- ``rope`` in f32 and bf16;
- ``TransformerLM`` logits against ``flax apply`` (vocab 16, d 32, 4 heads,
  ``n_kv`` in {None, 2, 1}, T 12) at rtol = atol = 1e-5, plus one gated run
  (d 64, 2 heads, 1 layer, T 1024: K4's plain version on the port's side,
  the blockwise path on JAX's), and a bf16 run within 2e-2 of max|logit|
  (the two sides round bf16 products in other places);
- ``LMGenerator``: ``decode_logits`` against flax's forward and the port's
  (and, for the GQA model, against JAX's own decode path, its per-chunk
  apply jitted), greedy tokens equal to a naive re-forward's (and, for the
  GQA model, to JAX's), the guards, the GQA-compact cache, and temperature
  sampling deterministic per seed (the port's generator cannot reproduce
  JAX's PRNG);
- ``SyntheticCopyLM`` batches bit for bit, the weight converter's checks,
  the FLOP accounting, and the ``lm-generate`` command at a tiny width.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import LMGenerator as JGenerator
from akka_allreduce_tpu.models import TransformerLM as JTransformerLM
from akka_allreduce_tpu.models.data import lm_copy_task as j_lm_copy_task
from akka_allreduce_tpu.models.transformer import rope as j_rope
from akka_allreduce_tpu.utils import benchmarking as jbench
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.models import (
    LMGenerator,
    SyntheticCopyLM,
    TransformerLM,
    lm_copy_task,
    rope,
    transformer_state_dict_from_flax,
)
from akka_allreduce_tpu_torch.ops import flash_attention as fa
from akka_allreduce_tpu_torch.ops import local_attention as la
from akka_allreduce_tpu_torch.parallel import line_mesh
from akka_allreduce_tpu_torch.utils import benchmarking as tbench

TOL = 1e-5


def _carry(jmodel, params, **kw) -> TransformerLM:
    """The port's model with the flax params loaded (strict)."""
    model = TransformerLM(
        vocab=jmodel.vocab, d_model=jmodel.d_model, n_heads=jmodel.n_heads,
        n_kv_heads=jmodel.n_kv_heads, n_layers=jmodel.n_layers,
        device="cpu", **kw,
    )
    model.load_state_dict(transformer_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return model


def _jax_generator(jmodel, max_len: int, batch: int) -> JGenerator:
    """JAX's generator, its zero-cache template for ``batch`` rows made by a
    jitted ``init`` (what ``init_cache`` makes eagerly, only faster)."""
    jgen = JGenerator(jmodel, max_len=max_len)
    variables = jax.jit(jgen._global_decoder.init)(
        jax.random.PRNGKey(0), jnp.zeros((batch, 1), jnp.int32))
    jgen._cache_tmpl[batch] = variables["cache"]
    return jgen


def _jax_decode_logits(jgen: JGenerator, params, tokens, chunk: int) -> np.ndarray:
    """``jgen.decode_logits`` with its per-chunk apply jitted."""
    apply = jax.jit(jgen._apply)
    cache = jgen.init_cache(tokens.shape[0])
    outs = []
    for i in range(0, tokens.shape[1], chunk):
        logits, cache = apply(params, cache, jnp.asarray(tokens[:, i:i + chunk]))
        outs.append(np.asarray(logits))
    return np.concatenate(outs, axis=1)


@pytest.fixture(scope="module", params=[None, 2, 1], ids=["mha", "gqa2", "mqa"])
def small(request):
    """(flax model, params, port model, tokens, flax logits) at vocab 16,
    d 32, 4 heads."""
    jmodel = JTransformerLM(vocab=16, d_model=32, n_heads=4, n_kv_heads=request.param,
                            n_layers=2)
    tokens = np.random.default_rng(1).integers(0, 16, (2, 12)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(tokens)))
    return jmodel, params, _carry(jmodel, params), tokens, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 7])
def test_rope_matches_jax(dtype, offset):
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 8)).astype(np.float32)
    want = j_rope(jnp.asarray(x).astype(getattr(jnp, dtype)), offset)
    got = rope(torch.from_numpy(x).to(getattr(torch, dtype)), offset)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 0.0  # bf16: the same roundings
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="even head dim"):
        rope(torch.zeros(1, 2, 1, 3), 0)


def test_logits_match_flax(small):
    _, _, model, tokens, want = small
    got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)


def test_gated_forward_takes_the_flash_path_and_matches_flax(monkeypatch):
    calls = []
    real = la.flash_attention
    monkeypatch.setattr(la, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    jmodel = JTransformerLM(vocab=16, d_model=64, n_heads=2, n_layers=1)
    tokens = np.random.default_rng(2).integers(0, 16, (1, 1024)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.asarray(tokens[:, :8]))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = _carry(jmodel, params)(torch.from_numpy(tokens))
    assert calls == [(1, 1024, 2, 32)]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_bf16_logits_close_to_flax():
    jmodel = JTransformerLM(vocab=16, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
                            compute_dtype=jnp.bfloat16)
    tokens = np.random.default_rng(5).integers(0, 16, (2, 12)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = _carry(jmodel, params, compute_dtype=torch.bfloat16)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 * scale)


def test_decode_logits_match_jax_and_the_forward(small):
    jmodel, params, model, tokens, want = small
    if jmodel.n_kv_heads == 2:  # JAX's decode path, for one model (a compile)
        want = _jax_decode_logits(_jax_generator(jmodel, 16, 2), params, tokens, chunk=4)
    gen = LMGenerator(model, max_len=16)
    t = torch.from_numpy(tokens)
    for chunk in (1, 4):
        got = gen.decode_logits(t, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with torch.no_grad():
        forward = model(t)
    np.testing.assert_allclose(gen.decode_logits(t, chunk=3).numpy(), forward.numpy(),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        gen.decode_logits(t, chunk=5)


def test_greedy_tokens_match_jax_and_a_naive_reforward(small):
    jmodel, params, model, tokens, _ = small
    got = LMGenerator(model, max_len=16).generate(torch.from_numpy(tokens[:, :4]), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    seq = torch.from_numpy(tokens[:, :4]).long()
    with torch.no_grad():
        for _ in range(6):
            nxt = torch.argmax(model(seq)[:, -1], dim=-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), seq[:, 4:].numpy())
    if jmodel.n_kv_heads == 2:  # JAX's generation loop, for one model
        want = _jax_generator(jmodel, 16, 2).generate(params, tokens[:, :4], 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_at_a_gated_length_takes_the_flash_path(monkeypatch):
    calls = []
    real = la.flash_attention
    monkeypatch.setattr(la, "flash_attention",
                        lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    model = TransformerLM(vocab=16, d_model=64, n_heads=2, n_kv_heads=1, n_layers=2,
                          device="cpu")
    prompt = torch.randint(0, 16, (1, 1024), generator=torch.Generator().manual_seed(0))
    out = LMGenerator(model, max_len=1030).generate(prompt, 3)
    # one call a layer, at prefill only, over the compact live cache slots
    assert calls == [(1, 1024, 1, 32)] * 2
    with torch.no_grad():
        first = torch.argmax(model(prompt)[:, -1], dim=-1)
    assert int(out[0, 0]) == int(first[0])


def test_guards_and_the_gqa_compact_cache():
    model = TransformerLM(vocab=16, d_model=32, n_heads=4, n_kv_heads=1, n_layers=2,
                          device="cpu")
    gen = LMGenerator(model, max_len=8)
    with pytest.raises(ValueError, match="exceeds"):
        gen.generate(torch.zeros((1, 6), dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="steps"):
        gen.generate(torch.zeros((1, 2), dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="prompt must be"):
        gen.generate(torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="'seq' and/or 'model' axis"):
        LMGenerator(model, max_len=8, mesh=line_mesh(2, axis="data", device="cpu"))
    cache = LMGenerator(model, max_len=16).init_cache(batch=2)
    assert len(cache.k) == len(cache.v) == 2 and cache.index == 0
    assert cache.k[0].shape == (2, 16, 1, 8)  # H_kv = 1, head_dim = 8
    assert cache.k[0].dtype == torch.float32
    bf = TransformerLM(vocab=16, d_model=32, n_heads=4, n_layers=1,
                       compute_dtype=torch.bfloat16, device="cpu")
    assert LMGenerator(bf, max_len=4).init_cache(1).v[0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="exceeds max_len"):
        model(torch.zeros((2, 17), dtype=torch.int64), cache)


def test_temperature_sampling_deterministic_per_seed():
    model = TransformerLM(vocab=16, d_model=32, n_heads=4, n_layers=2, device="cpu")
    gen = LMGenerator(model, max_len=16)
    prompt = torch.randint(0, 16, (2, 4), generator=torch.Generator().manual_seed(1))
    a = gen.generate(prompt, 5, temperature=1.0, seed=3)
    b = gen.generate(prompt, 5, temperature=1.0, seed=3)
    c = gen.generate(prompt, 5, temperature=1.0, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 16


def test_seeded_init_is_deterministic_and_flax_scaled():
    a = TransformerLM(vocab=16, d_model=32, n_heads=4, n_layers=1, seed=5, device="cpu")
    b = TransformerLM(vocab=16, d_model=32, n_heads=4, n_layers=1, seed=5, device="cpu")
    c = TransformerLM(vocab=16, d_model=32, n_heads=4, n_layers=1, seed=6, device="cpu")
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y) and x.dtype == torch.float32, name
        if "kernel" in name:
            assert not torch.equal(x, z)
    assert abs(float(a.blocks[0].mlp_up_kernel.detach().std()) - 32 ** -0.5) < 0.02
    with pytest.raises(ValueError, match="compute_dtype"):
        TransformerLM(compute_dtype=torch.float16, device="cpu")


def test_converter_rejects_unknown_and_missing_leaves(small):
    _, params, _, _, _ = small
    tree = jax.tree.map(np.asarray, params)
    sd = transformer_state_dict_from_flax(tree)
    assert sd.keys() == transformer_state_dict_from_flax(tree["params"]).keys()
    extra = {"params": {**tree["params"], "Mystery_0": {"kernel": np.zeros(3)}}}
    with pytest.raises(ValueError, match="no counterpart"):
        transformer_state_dict_from_flax(extra)
    blocks = dict(tree["params"])
    blocks["Block_1"] = {k: v for k, v in blocks["Block_1"].items() if k != "mlp_bias"}
    with pytest.raises(ValueError, match="Block_1/mlp_bias"):
        transformer_state_dict_from_flax(blocks)
    no_head = {k: v for k, v in tree["params"].items() if k != "Dense_0"}
    with pytest.raises(ValueError, match="Dense_0/kernel"):
        transformer_state_dict_from_flax(no_head)


@pytest.mark.parametrize("seq_len,vocab,seed", [(128, 64, 0), (32, 16, 3)])
def test_copy_task_batches_bit_equal(seq_len, vocab, seed):
    ours = list(lm_copy_task(seq_len, vocab, seed).batches(4, 3, seed_offset=123))
    theirs = list(j_lm_copy_task(seq_len, vocab, seed).batches(4, 3, seed_offset=123))
    for (x, y), (jx, jy) in zip(ours, theirs):
        assert x.dtype == jx.dtype == np.int32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    with pytest.raises(ValueError, match="even"):
        SyntheticCopyLM(7)


@pytest.mark.parametrize("causal,remat", [(True, False), (False, True)])
def test_flop_accounting(causal, remat):
    kw = dict(n_params=404e6, batch=8, seq=2048, d_model=2048, n_layers=8, causal=causal)
    assert tbench.transformer_train_flops(**kw, remat=remat) == \
        jbench.transformer_train_flops(**kw, remat=remat)
    attn = 4.0 * 8 * 2048 ** 2 * 2048 * 8 * (0.5 if causal else 1.0)
    assert tbench.transformer_forward_flops(**kw) == 2.0 * 404e6 * 8 * 2048 + attn
    assert tbench.device_peak_flops(torch.device("cpu")) is None
    assert tbench.PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"] == 989.4e12


def test_lm_generate_cli_on_the_cpu(capsys):
    before = dict(fa.LAUNCHES)
    rc = cli_main(["lm-generate", "--device", "cpu", "--vocab", "16", "--d-model", "32",
                   "--heads", "4", "--kv-heads", "2", "--layers", "1", "--batch", "2",
                   "--prompt-len", "5", "--gen", "4"])
    assert rc == 0 and fa.LAUNCHES == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1].startswith("decoded: ") and len(json.loads(lines[1][9:])) == 4
    assert lines[2].startswith("decode: ") and "ms/token" in lines[2]
    rec = json.loads(lines[-1])
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["prefill_ms"] > 0 and rec["ms_per_token"] > 0
    assert rec["prefill_tflops_per_s"] > 0 and rec["prefill_mfu"] is None  # no peak
    assert (rec["batch"], rec["prompt_len"], rec["gen"], rec["kv_heads"]) == (2, 5, 4, 2)


def test_lm_generate_cli_with_the_int8_cache_on_the_cpu(capsys):
    before = dict(fa.LAUNCHES)
    rc = cli_main(["lm-generate", "--device", "cpu", "--vocab", "16", "--d-model", "32",
                   "--heads", "4", "--kv-heads", "2", "--layers", "1", "--batch", "2",
                   "--prompt-len", "5", "--gen", "4", "--cache-quant", "int8"])
    assert rc == 0 and fa.LAUNCHES == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(json.loads(lines[1][9:])) == 4
    assert lines[2].startswith("decode: ") and lines[2].endswith("int8-quantized)")
    rec = json.loads(lines[-1])
    assert rec["cache_quant"] == "int8" and rec["device"] == "cpu"
    assert rec["prefill_ms"] > 0 and rec["ms_per_token"] > 0
    with pytest.raises(SystemExit):
        cli_main(["lm-generate", "--device", "cpu", "--cache-quant", "fp4"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--sp", "2"], ["--tp", "2"]])
def test_lm_generate_refuses_what_is_not_ported(capsys, flag):
    """``--sp``/``--tp`` decode over virtual ranks; the JAX command's own
    refusal (a size below 1) stays."""
    rc = cli_main(["lm-generate", "--device", "cpu", "--vocab", "16", "--d-model", "32",
                   "--heads", "4", "--kv-heads", "2", "--layers", "1", "--batch", "2",
                   "--prompt-len", "5", "--gen", "4", *flag])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(json.loads(lines[1][9:])) == 4
    rec = json.loads(lines[-1])
    assert (rec["sp"], rec["tp"]) == ((2, 1) if flag[0] == "--sp" else (1, 2))
    assert rec["prefill_ms"] > 0 and rec["ms_per_token"] > 0
    # max_len rounded up to whole slots a seq rank: 5 + 4 -> 10 at sp 2
    assert "cache (B,10,2,8)" in lines[2] if flag[0] == "--sp" else "cache (B,9,2,8)" in lines[2]
    with pytest.raises(SystemExit):
        cli_main(["lm-generate", "--device", "cpu", flag[0], "0"])
    assert "--sp and --tp must be >= 1" in capsys.readouterr().err
