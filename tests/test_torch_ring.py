"""The port's ring kernel K3 (``akka_allreduce_tpu_torch.ops.ring``) on the
CPU: its plain version against the JAX package's Pallas ring in interpret
mode, and against numpy and the port's XLA-style ring.

On the CPU the wrapper takes the plain version, which emulates
``_ring_kernel`` step by step; the CUDA kernel itself is held against that
plain version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The Pallas interpreter is slow, so the JAX side runs four calls, once per
module, on ``line_mesh(4)`` with ``seg_rows`` 2 and one bucket each (no race
detector): f32 on a ragged payload, bf16, int8, and the host-facing
``threshold_allreduce(schedule="pallas_ring")`` with a per-bucket mask.
The plain version's ``valid`` mask and ragged tail are held to masking the
stack first, bit for bit, and so is the ``pallas_ring`` round with a
whole-payload mask, which passes the mask into K3.
Tolerances: f32 rtol = atol = 1e-6; bf16 and int8 within 1e-6 relative to
``max|oracle|`` (the same order, round-to-nearest-even casts and true
division are used, so equality is expected). Replication across ranks is
exact for f32 and bf16 and within rtol 2e-6 / atol 1e-6 for int8, where
every gather hop requantizes (the TPU kernel's own tolerance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.comm.allreduce import threshold_allreduce as jthreshold
from akka_allreduce_tpu.ops.ring import int8_quantize as jint8_quantize
from akka_allreduce_tpu.ops.ring import pallas_ring_allreduce_sum
from akka_allreduce_tpu.parallel import line_mesh as jline_mesh
from akka_allreduce_tpu_torch.comm import allreduce as tar
from akka_allreduce_tpu_torch.comm import threshold_allreduce
from akka_allreduce_tpu_torch.ops import ring
from akka_allreduce_tpu_torch.parallel import line_mesh

N = 4
SEG_ROWS = 2
F32 = dict(rtol=1e-6, atol=1e-6)
REL = 1e-6
RAGGED = N * SEG_ROWS * ring.LANE - 37  # one bucket, zero-padded tail


def _xs(data, seed, n=N, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, data)) * scale).astype(np.float32)


def _pallas(xs, compress):
    fn = jax.jit(
        jax.shard_map(
            lambda x: pallas_ring_allreduce_sum(
                x.reshape(-1), "line", N, seg_rows=SEG_ROWS, compress=compress
            )[None],
            mesh=jline_mesh(N),
            in_specs=P("line"),
            out_specs=P("line"),
            check_vma=False,
        )
    )
    return np.asarray(fn(xs))


CASES = {  # compress -> (data, seed)
    None: (RAGGED, 0),
    "bf16": (N * SEG_ROWS * ring.LANE, 1),
    "int8": (N * SEG_ROWS * ring.LANE, 2),
}
MASKED = dict(data=2000, seed=3, bucket_size=1024, compress="int8")
BUCKET_MASK = np.array([[1, 1], [0, 1], [1, 1], [1, 0]], np.float32)


@pytest.fixture(scope="module")
def interpret_results():
    """The JAX Pallas ring in interpret mode: four calls, made once."""
    out = {}
    for compress, (data, seed) in CASES.items():
        xs = _xs(data, seed)
        out[compress] = (xs, _pallas(xs, compress))
    xs = _xs(MASKED["data"], MASKED["seed"])
    res = jthreshold(
        jline_mesh(N), xs, BUCKET_MASK, schedule="pallas_ring",
        bucket_size=MASKED["bucket_size"], compress=MASKED["compress"],
    )
    out["masked"] = (xs, np.asarray(res.sum), np.asarray(res.count))
    return out


def _assert_replicated(rows: np.ndarray, compress):
    for d in range(rows.shape[0]):
        if compress == "int8":
            np.testing.assert_allclose(rows[d], rows[0], rtol=2e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(rows[d], rows[0])


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
def test_plain_k3_matches_pallas_interpret(interpret_results, compress):
    xs, want = interpret_results[compress]
    got = ring.ring_kernel_allreduce_sum_reference(
        torch.from_numpy(xs), seg_rows=SEG_ROWS, compress=compress
    ).numpy()
    assert got.shape == want.shape == xs.shape
    oracle = xs.sum(0)
    if compress is None:
        np.testing.assert_allclose(got, want, **F32)
    else:
        scale = np.abs(oracle).max()
        assert np.abs(got - want).max() / scale <= REL
        assert np.abs(got[0] - oracle).max() > 0  # compression really happened
    _assert_replicated(got, compress)
    _assert_replicated(want, compress)
    # the wrapper takes the plain version for a CPU tensor, launching nothing
    before = dict(ring.LAUNCHES)
    via = ring.ring_kernel_allreduce_sum(
        torch.from_numpy(xs), seg_rows=SEG_ROWS, compress=compress
    )
    assert torch.equal(via, torch.from_numpy(got)) and ring.LAUNCHES == before


def test_pallas_ring_threshold_allreduce_matches_jax(interpret_results):
    xs, jsum, jcount = interpret_results["masked"]
    res = threshold_allreduce(
        line_mesh(N, device="cpu"), xs, BUCKET_MASK, schedule="pallas_ring",
        bucket_size=MASKED["bucket_size"], compress=MASKED["compress"],
    )
    mask = np.repeat(BUCKET_MASK, MASKED["bucket_size"], axis=1)[:, : xs.shape[1]]
    oracle = (xs * mask).sum(0)
    assert np.abs(res.sum.numpy() - jsum).max() / np.abs(oracle).max() <= REL
    np.testing.assert_array_equal(res.count.numpy(), jcount)
    np.testing.assert_array_equal(res.count.numpy(), mask.sum(0))
    assert np.abs(res.sum.numpy() - oracle).max() / np.abs(oracle).max() < 8e-2


@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("seg_rows", [1, 3])
def test_plain_k3_f32_is_the_sum(n, seg_rows):
    data = n * seg_rows * ring.LANE * 2 + 77  # three buckets, ragged
    xs = _xs(data, seed=10 + n, n=n)
    out = ring.ring_kernel_allreduce_sum(
        torch.from_numpy(xs), seg_rows=seg_rows
    ).numpy()
    for d in range(n):
        np.testing.assert_allclose(out[d], xs.sum(0), rtol=1e-5, atol=1e-5)
    _assert_replicated(out, None)


@pytest.mark.parametrize("compress,tol", [("bf16", 2e-2), ("int8", 8e-2)])
def test_plain_k3_compressed_matches_xla_ring_class(compress, tol):
    """Against the port's XLA-style ring: segment boundaries differ, so the
    per-hop quantization differs per element; the tolerance is the
    compression class (the JAX test's own), not bit equality."""
    xs = _xs(8 * 2 * ring.LANE, seed=20, n=8, scale=1.0)
    out = ring.ring_kernel_allreduce_sum(
        torch.from_numpy(xs), seg_rows=2, compress=compress
    ).numpy()
    xla = tar.ring_allreduce_sum(torch.from_numpy(xs), compress=compress).numpy()
    exact = xs.sum(0)
    scale = np.abs(exact).max()
    _assert_replicated(out, compress)
    assert np.abs(out[0] - exact).max() / scale < tol
    assert np.abs(out[0] - xla[0]).max() / scale < tol
    assert np.abs(out[0] - exact).max() > 0


def test_plain_k3_int8_all_zero_and_single_rank():
    zeros = torch.zeros((4, 1000))
    out = ring.ring_kernel_allreduce_sum(zeros, seg_rows=1, compress="int8")
    assert torch.equal(out, zeros)
    one = torch.from_numpy(_xs(300, seed=4, n=1))
    same = ring.ring_kernel_allreduce_sum(one, compress="int8")
    assert torch.equal(same, one) and same.data_ptr() != one.data_ptr()


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
@pytest.mark.parametrize("n,data", [(3, 3 * 2 * ring.LANE * 2 + 37), (5, 1000), (1, 300)])
def test_plain_k3_valid_equals_masking_first(compress, n, data):
    """The per-rank ``valid`` mask and the ragged tail: the plain version with
    ``valid`` equals ``xs * valid[:, None]`` through the unmasked plain
    version, bit for bit, and the wrapper on a CPU tensor takes that path."""
    xs = torch.from_numpy(_xs(data, seed=30 + n, n=n))
    valid = torch.tensor([float(r % 3 != 1) for r in range(n)])
    keep = xs.clone()
    got = ring.ring_kernel_allreduce_sum_reference(
        xs, seg_rows=2, compress=compress, valid=valid
    )
    want = ring.ring_kernel_allreduce_sum_reference(
        xs * valid[:, None], seg_rows=2, compress=compress
    )
    assert got.shape == (n, data) and torch.equal(got, want)
    assert torch.equal(xs, keep)
    before = dict(ring.LAUNCHES)
    via = ring.ring_kernel_allreduce_sum(xs, seg_rows=2, compress=compress, valid=valid)
    assert torch.equal(via, want) and ring.LAUNCHES == before


def test_ring_rejects_a_bad_valid_mask():
    xs = torch.zeros((4, 512))
    with pytest.raises(ValueError, match="valid must be"):
        ring.ring_kernel_allreduce_sum(xs, valid=torch.ones(3))
    with pytest.raises(ValueError, match="valid must be"):
        ring.ring_kernel_allreduce_sum(xs, valid=torch.ones(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="valid"):
        ring.ring_kernel_allreduce_sum(xs, valid=[1.0, 1.0, 1.0, 1.0])


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
@pytest.mark.parametrize("valid", [[1, 0, 1, 1], 1.0])
def test_pallas_ring_round_with_a_rank_mask_equals_masking_first(compress, valid):
    """A whole-payload mask rides into K3; the round's sum and count equal,
    bit for bit, masking the stack first and running the plain K3 on it (the
    round as it ran before the mask moved into the kernel)."""
    xs = _xs(3000, seed=40)
    res = threshold_allreduce(
        line_mesh(N, device="cpu"), xs, valid, schedule="pallas_ring",
        compress=compress,
    )
    v = torch.as_tensor(valid, dtype=torch.float32).expand(N)
    masked = torch.from_numpy(xs) * v[:, None]
    want = ring.ring_kernel_allreduce_sum_reference(masked, compress=compress)[0]
    assert torch.equal(res.sum, want)
    assert torch.equal(res.count, torch.full((3000,), float(v.sum())))


def test_ring_rejects_bad_arguments():
    xs = torch.zeros((4, 512))
    with pytest.raises(ValueError, match="compress"):
        ring.ring_kernel_allreduce_sum(xs, compress="fp4")
    with pytest.raises(ValueError, match="seg_rows"):
        ring.ring_kernel_allreduce_sum(xs, seg_rows=0)
    with pytest.raises(ValueError, match="n, data"):
        ring.ring_kernel_allreduce_sum(torch.zeros(512))


@pytest.mark.parametrize(
    "seg",
    [
        np.zeros(128, np.float32),  # all zero: scale 1, q 0
        np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5], np.float32),
        np.array([-127.0, 63.5, -63.5, 0.5, 1e-9, -1e-9], np.float32),
        (np.random.default_rng(5).standard_normal(1000) * 40).astype(np.float32),
    ],
    ids=["all_zero", "ties_pos_amax", "ties_neg_amax", "random"],
)
def test_int8_quantize_matches_jax(seg):
    jq, js = jax.jit(jint8_quantize)(jnp.asarray(seg))
    q, s = ring.int8_quantize(torch.from_numpy(seg))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_int8_quantize_stays_in_range_at_the_maximum():
    """The element at max|seg| maps to +-127 and nothing leaves [-127, 127],
    whichever way ``amax * f32(1/127)`` rounds."""
    rng = np.random.default_rng(6)
    amax = (rng.uniform(1e-3, 1e3, 512)).astype(np.float32)
    seg = np.stack([amax, -amax, amax * 0.999], axis=1)
    for row in seg:
        q, _ = ring.int8_quantize(torch.from_numpy(row))
        jq, _ = jax.jit(jint8_quantize)(jnp.asarray(row))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q[0] == 127 and q[1] == -127
