"""The port's training path against the JAX package's, on the CPU.

Same seeded numpy batches through ``akka_allreduce_tpu.train`` (JAX on the
CPU, a ``data_seq_mesh(1, 1)``) and ``akka_allreduce_tpu_torch.train``, the
port's trainer carrying the JAX trainer's initial weights
(``set_flat_params(get_flat_params())``):

- ``LongContextTrainer`` (vocab 16, d 32, 4 heads, ``n_kv`` in {None, 2},
  2 layers, T 16, lr 1e-3): per-step losses within 1e-5 relative and the
  flat parameters within 1e-5 after 3 steps, contributors equal; then a
  ``valid=[0]`` step (loss 0, contributors 0, the Adam moments still
  moving the parameters on both sides); and one gated run (d 64, 2 heads,
  1 layer, T 1024: K4's plain forward and backward on the port's side, the
  blockwise path on JAX's, whose step is written out there because JAX's
  trainer cannot take that length on the CPU): losses within 1e-5 relative
  and the first gradient within 1e-5 of max|grad|;
- ``remat`` gives the same gradients as no remat;
- ``flatten_params`` lays the parameters out in the JAX flat-vector order
  (11 layers, so ``Block_10`` sorts before ``Block_2``), and round-trips;
- ``normalize_valid``, ``data_seq_mesh`` and ``mfu`` against the JAX
  copies; the device sampler's determinism and copy structure;
- ``train-lm``, ``bench-mfu`` and ``lm-generate --train-steps`` at a tiny
  width with ``--device cpu``, ``train-lm``'s mesh, ``--compress`` and
  ``--overlap`` flags and ``bench-mfu --dp 2 --sp 2`` (the record's
  ``virtual_ranks``), and the refusal of what stays refused.

The Adam hazard: a first Adam step is nearly a sign step, so a gradient
entry near 0 with opposite signs on the two sides would move a parameter
by a whole learning rate; lr 1e-3 keeps that visible rather than hidden.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from akka_allreduce_tpu.binder.api import flatten_pytree
from akka_allreduce_tpu.models import TransformerLM as JTransformerLM
from akka_allreduce_tpu.models.data import lm_copy_task as j_lm_copy_task
from akka_allreduce_tpu.parallel import data_seq_mesh as j_data_seq_mesh
from akka_allreduce_tpu.train import LongContextTrainer as JTrainer
from akka_allreduce_tpu.train.trainer import normalize_valid as j_normalize_valid
from akka_allreduce_tpu.utils import benchmarking as jbench
from akka_allreduce_tpu_torch import bench_mfu
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.binder import flatten_params, leaf_order
from akka_allreduce_tpu_torch.models import SyntheticCopyLM, TransformerLM
from akka_allreduce_tpu_torch.models.convert import transformer_state_dict_from_flax
from akka_allreduce_tpu_torch.ops import flash_attention as fa
from akka_allreduce_tpu_torch.parallel import RankMesh, data_seq_mesh
from akka_allreduce_tpu_torch.train import LongContextTrainer, normalize_valid
from akka_allreduce_tpu_torch.utils import benchmarking as tbench

TOL = 1e-5
SMALL = dict(vocab=16, d_model=32, n_heads=4, n_layers=2, seq_len=16)
GATED = dict(vocab=16, d_model=64, n_heads=2, n_layers=1, seq_len=1024)


def _pair(n_kv_heads=None, **cfg):
    """A JAX trainer and the port's, carrying the JAX initial weights."""
    jt = JTrainer(j_data_seq_mesh(1, 1), n_kv_heads=n_kv_heads, learning_rate=1e-3, **cfg)
    tt = LongContextTrainer(n_kv_heads=n_kv_heads, learning_rate=1e-3, device="cpu", **cfg)
    tt.set_flat_params(jt.get_flat_params())
    return jt, tt


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa2"])
def small_pair(request):
    return _pair(request.param, **SMALL)


def test_trainer_matches_jax_step_by_step(small_pair):
    jt, tt = small_pair
    np.testing.assert_array_equal(tt.get_flat_params(), jt.get_flat_params())
    batches = list(j_lm_copy_task(SMALL["seq_len"], vocab=16).batches(4, 3))
    for x, y in batches:
        want, got = jt.train_step(x, y), tt.train_step(x, y)
        assert got.step == want.step and got.contributors == want.contributors == 1.0
        assert abs(got.loss - want.loss) <= TOL * abs(want.loss), (got, want)
    np.testing.assert_allclose(tt.get_flat_params(), jt.get_flat_params(), rtol=0, atol=TOL)
    # a step whose only replica row drops out: no loss, no contributors, but
    # Adam's moments still move the parameters on both sides
    x, y = batches[0]
    before = tt.get_flat_params()
    want, got = jt.train_step(x, y, valid=[0.0]), tt.train_step(x, y, valid=[0.0])
    assert got.loss == want.loss == 0.0 and got.contributors == want.contributors == 0.0
    assert not np.array_equal(tt.get_flat_params(), before)
    np.testing.assert_allclose(tt.get_flat_params(), jt.get_flat_params(), rtol=0, atol=TOL)
    assert tt.step_num == jt.step_num == 4


def test_gated_trainer_matches_jax():
    """At T 1024 every layer takes K4's plain forward and backward on the
    port's side (no launch on the CPU) and the blockwise path on JAX's: each
    step's loss within 1e-5 relative, and the first step's gradient within
    1e-5 of max|grad|.

    JAX's ``LongContextTrainer`` cannot take this length on the CPU: its
    shard_map keeps the vma check on off the TPU, and the check rejects the
    blockwise path's scan carry. So the JAX side is the trainer's step at
    dp = sp = 1 written out: the flax model's apply, the masked per-token
    cross-entropy, ``jax.value_and_grad`` and ``optax.adam``. The parameters
    are compared in the small runs above, not here: this model has gradient
    entries of about 1e-8, the size of Adam's eps, where a 1e-9 difference
    in the gradient moves the first update by 2e-5 (the Adam hazard).
    """
    jmodel = JTransformerLM(vocab=16, d_model=64, n_heads=2, n_layers=1)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1024), jnp.int32))
    tx = optax.adam(1e-3)

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_fn(p):
            ce = optax.softmax_cross_entropy_with_integer_labels(jmodel.apply(p, x), y)
            return ce.sum() * 1.0 / max(1.0 * x.size, 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    tt = LongContextTrainer(learning_rate=1e-3, device="cpu", **GATED)
    tt.set_flat_params(flatten_pytree(params)[0])
    opt_state = tx.init(params)
    before = dict(fa.LAUNCHES)
    for i, (x, y) in enumerate(j_lm_copy_task(GATED["seq_len"], vocab=16).batches(1, 2)):
        params, opt_state, want, grads = step(params, opt_state, jnp.asarray(x),
                                              jnp.asarray(y))
        got = tt.train_step(x, y)
        assert abs(got.loss - float(want)) <= TOL * abs(float(want)), (got, want)
        if i == 0:
            named = dict(tt.model.named_parameters())
            g = np.concatenate([named[n].grad.numpy().ravel() for n in leaf_order(tt.model)])
            jg = flatten_pytree(grads)[0]
            np.testing.assert_allclose(g, jg, rtol=0, atol=TOL * np.abs(jg).max())
    assert fa.LAUNCHES == before


def test_remat_gives_the_same_gradients():
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 16, (1, 1024)))
    grads = []
    for remat in (False, True):
        model = TransformerLM(vocab=16, d_model=64, n_heads=2, n_layers=2, seed=3,
                              device="cpu", remat=remat)
        model(x).square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=1e-6, atol=1e-7)


def test_flatten_params_in_jax_order_and_round_trip():
    """The flax tree's structure from ``jax.eval_shape`` (nothing compiled),
    its leaves seeded numpy."""
    jmodel = JTransformerLM(vocab=8, d_model=8, n_heads=2, n_kv_heads=1, n_layers=11)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(1)
    host = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = TransformerLM(vocab=8, d_model=8, n_heads=2, n_kv_heads=1, n_layers=11,
                          device="cpu")
    model.load_state_dict(transformer_state_dict_from_flax(host))
    want, _ = flatten_pytree(host)
    got, unflatten = flatten_params(model)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    order = leaf_order(model)
    assert order.index("blocks.10.attn.k_bias") < order.index("blocks.2.attn.k_bias")
    state = unflatten(got + 1.0)
    fresh = TransformerLM(vocab=8, d_model=8, n_heads=2, n_kv_heads=1, n_layers=11,
                          device="cpu")
    fresh.load_state_dict(state)
    np.testing.assert_array_equal(flatten_params(fresh)[0], got + 1.0)
    with pytest.raises(ValueError, match="vector"):
        unflatten(got[:-1])


@pytest.mark.parametrize("valid,n", [(None, 1), ([1.0], 1), ([0.0, 1.0], 2),
                                     ([1.0, 1.0], 1), ([[1.0]], 1)])
def test_normalize_valid_matches_jax(valid, n):
    try:
        want = j_normalize_valid(valid, n)
    except ValueError as e:
        with pytest.raises(ValueError, match="valid must have shape") as got:
            normalize_valid(valid, n)
        assert str(got.value) == str(e)
        return
    np.testing.assert_array_equal(normalize_valid(valid, n), want)


def test_data_seq_mesh_matches_jax_shape_logic():
    """With a side missing, the rank count n plays the JAX device count (8
    virtual CPU devices here); with both sides given, the mesh has their
    product, as JAX's takes that many devices."""
    for dp, sp in ((1, 1), (2, 4), (None, None), (2, None), (None, 2)):
        want = j_data_seq_mesh(dp, sp)
        n = 8 if None in (dp, sp) else None
        got = data_seq_mesh(dp, sp, n=n, device="cpu")
        assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    with pytest.raises(ValueError, match="divide"):
        j_data_seq_mesh(3, None)
    with pytest.raises(ValueError, match="divide"):
        data_seq_mesh(3, None, n=8, device="cpu")
    with pytest.raises(ValueError):
        data_seq_mesh(device="cpu")  # a virtual mesh needs a shape or n


def test_mfu_copy_matches_jax():
    for args in ((4.3e13, 0.0434, 989.4e12), (1e12, 0.5, 1e12), (1e12, 0.0, 1e12)):
        assert tbench.mfu(*args) == jbench.mfu(*args)
        assert tbench.mfu(*args, n_devices=4) == jbench.mfu(*args, n_devices=4)
    assert tbench.mfu(1e12, 1.0, None) is None  # no card here: no peak


def test_device_sampler_is_deterministic_copy_data():
    sample = SyntheticCopyLM(32, vocab=16).device_sampler()
    x1, y1 = sample(torch.Generator().manual_seed(5), 3)
    x2, y2 = sample(torch.Generator().manual_seed(5), 3)
    x3, _ = sample(torch.Generator().manual_seed(6), 3)
    assert torch.equal(x1, x2) and torch.equal(y1, y2) and not torch.equal(x1, x3)
    assert x1.shape == y1.shape == (3, 32) and x1.dtype == torch.int64
    assert int(x1.min()) >= 0 and int(x1.max()) < 16
    assert torch.equal(y1[:, :-1], x1[:, 1:])  # next-token labels
    assert torch.equal(x1[:, 17:], x1[:, 1:16])  # the back half copies the front


def test_trainer_refuses_what_is_not_ported():
    """Compression, overlap and meshes above 1 x 1 are ported now: each
    builds and steps on the CPU (their numerics against JAX's are in
    ``tests/test_torch_seq_parallel.py`` and
    ``tests/test_torch_tensor_parallel.py``); what stays refused is what the
    JAX trainer refuses too."""
    x = np.zeros((2, 16), np.int32)
    for kw in (dict(compress="bf16"), dict(overlap=True), dict(compress="int8")):
        trainer = LongContextTrainer(device="cpu", **SMALL, **kw)
        assert np.isfinite(trainer.train_step(x, x).loss)
    cpu = torch.device("cpu")
    for mesh in (data_seq_mesh(2, 1, device="cpu"), data_seq_mesh(1, 2, device="cpu"),
                 RankMesh(("data", "seq", "model"), (1, 1, 2), cpu)):
        trainer = LongContextTrainer(mesh, **SMALL)
        assert trainer.n_devices == mesh.size and trainer.data_shards == mesh.sizes[0]
        m = trainer.train_step(x, x)
        assert np.isfinite(m.loss) and m.contributors == mesh.sizes[0]
    with pytest.raises(ValueError, match="overlap excludes compress='int8'"):
        LongContextTrainer(device="cpu", compress="int8", overlap=True)
    with pytest.raises(ValueError, match="compress must be"):
        LongContextTrainer(device="cpu", compress="f16")
    with pytest.raises(ValueError, match="not divisible by seq shards"):
        LongContextTrainer(data_seq_mesh(1, 3, device="cpu"), **SMALL)
    with pytest.raises(ValueError, match="seq_impl"):
        LongContextTrainer(device="cpu", seq_impl="flash")
    with pytest.raises(ValueError, match=r"\(data, seq"):
        LongContextTrainer(RankMesh(("line",), (1,), cpu))
    trainer = LongContextTrainer(data_seq_mesh(1, 1, device="cpu"), seq_impl="ulysses",
                                 **SMALL)
    with pytest.raises(ValueError, match="must be"):
        trainer.train_step(np.zeros((2, 8), np.int32), np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="valid must have shape"):
        trainer.train_step(np.zeros((2, 16), np.int32), np.zeros((2, 16), np.int32),
                           valid=[1.0, 1.0])


def test_train_chain_draws_on_the_device_and_continues_the_stream():
    trainer = LongContextTrainer(seq_impl="ulysses", learning_rate=3e-3, device="cpu",
                                 **SMALL)
    sampler = SyntheticCopyLM(16, vocab=16).device_sampler()
    first = trainer.train_chain(sampler, 3, 4)
    second = trainer.train_chain(sampler, 2, 4, valid=[0.0])
    assert [m.step for m in first + second] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(m.loss) and m.contributors == 1.0 for m in first)
    assert all(m.loss == 0.0 and m.contributors == 0.0 for m in second)


TINY = ["--device", "cpu", "--vocab", "16", "--d-model", "32", "--heads", "4",
        "--layers", "1", "--seq-len", "16", "--batch", "2"]


def test_train_lm_cli_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "m.jsonl"
    assert cli_main(["train-lm", *TINY, "--steps", "3", "--kv-heads", "2",
                     "--metrics-out", str(out)]) == 0
    assert cli_main(["train-lm", *TINY, "--steps", "2", "--device-data", "--remat",
                     "--bf16", "--impl", "ulysses"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("LM params:") and "dp=1 x sp=1 x tp=1" in lines[0]
    assert lines[1].startswith("lm_ring: 3 steps") and "loss" in lines[1]
    assert lines[3].startswith("lm_ulysses: 2 on-device steps")
    events = [json.loads(line) for line in out.read_text().splitlines()]
    assert [e["kind"] for e in events] == ["train_step"] * 3 + ["train_summary"]
    assert [e["step"] for e in events[:3]] == [1, 2, 3]
    assert all(e["contributors"] == 1.0 and np.isfinite(e["loss"]) for e in events[:3])


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--sp", "2"], ["--tp", "2"],
                                  ["--compress", "bf16"], ["--overlap"]])
def test_train_lm_refuses_what_is_not_ported(capsys, flag):
    """Each flag the port refused before runs on the CPU now; ``--tp`` needs
    ``--dp`` and ``--sp``, with the JAX command's error."""
    if flag[0] == "--tp":
        with pytest.raises(SystemExit):
            cli_main(["train-lm", "--device", "cpu", *flag])
        assert "--tp requires explicit --dp and --sp" in capsys.readouterr().err
        flag = [*flag, "--dp", "1", "--sp", "2"]
    assert cli_main(["train-lm", *TINY, "--steps", "2", *flag]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    dp, sp, tp = (int(dict(zip(flag[::2], flag[1::2])).get(f, 1)) for f in ("--dp", "--sp", "--tp"))
    assert f"dp={dp} x sp={sp} x tp={tp}" in lines[0]
    assert lines[1].startswith(f"lm_ring: 2 steps over {dp * sp * tp} virtual ranks")


def test_bench_mfu_cli_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(bench_mfu, "SIGNAL_S", 0.05)  # 3 s of signal is for the card
    assert cli_main(["bench-mfu", *TINY]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"].startswith("lm_mfu") and rec["value"] is None  # no peak
    assert rec["platform"] == "cpu" and rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["ms_per_step"] > 0 and rec["batch"] == 2 and rec["seq_len"] == 16
    assert (rec["dp"], rec["sp"], rec["virtual_ranks"]) == (1, 1, 1)
    assert cli_main(["bench-mfu", *TINY, "--dp", "2", "--sp", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["dp"], rec["sp"], rec["virtual_ranks"], rec["seq_impl"]) == (2, 2, 4, "ring")
    assert rec["ms_per_step"] > 0 and rec["batch"] == 2 and rec["value"] is None
    for flag, said in ((["--workload", "fsdp"], "not ported yet"),
                       (["--workload", "mlp", "--dp", "2"], "the lm workload's mesh")):
        with pytest.raises(SystemExit):
            cli_main(["bench-mfu", "--device", "cpu", *flag])
        assert said in capsys.readouterr().err


def test_bench_mfu_moe_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(bench_mfu, "SIGNAL_S", 0.05)  # 3 s of signal is for the card
    assert cli_main(["bench-mfu", *TINY, "--workload", "moe", "--experts", "4",
                     "--topk", "2", "--mu-bf16", "--capacity-factor", "1.0"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"].startswith("moe_mfu") and rec["value"] is None  # no peak
    assert rec["device"] == "cpu" and rec["ms_per_step"] > 0 and rec["batch"] == 2
    assert (rec["experts"], rec["topk"], rec["mu_bf16"], rec["capacity_factor"]) == (
        4, 2, True, 1.0)
    assert rec["active_params_m"] <= rec["params_m"] and 0 <= rec["dropped_frac"] < 1
    for flag in (["--mu-bf16"], ["--capacity-factor", "2"]):
        with pytest.raises(SystemExit):
            cli_main(["bench-mfu", "--device", "cpu", *flag])
        assert "moe workload only" in capsys.readouterr().err


def test_lm_generate_trains_first_on_the_cpu(capsys):
    assert cli_main(["lm-generate", *TINY, "--train-steps", "8", "--prompt-len", "9",
                     "--gen", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("trained 8 steps: loss ")
    assert any(line.startswith("copy accuracy vs source: ") for line in lines)
    rec = json.loads(lines[-1])
    assert rec["device"] == "cpu" and rec["gen"] == 4
