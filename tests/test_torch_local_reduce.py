"""The port's single-card threshold reduce against the JAX package's.

The same seeded numpy inputs go through ``akka_allreduce_tpu.ops`` (the
Pallas kernels in interpret mode on the CPU backend, as
tests/test_local_reduce.py runs them) and through
``akka_allreduce_tpu_torch.ops`` on the CPU, where each op takes its plain
PyTorch version. State crosses over with ``state_from_numpy``. Tolerance is
the JAX package's own: rtol = atol = 1e-6.

Cases follow the eight behaviours tests/test_local_reduce.py pins: full,
partial and zero masks; ragged and tile-aligned widths; the elastic step;
the zero mask keeping state bit-exact; tiled equal to flat; a bad tiled
shape raising ValueError; the fixed point at consensus. A slice-level test
runs a few rounds of the bench suite's loop through both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from akka_allreduce_tpu import ops as jops
from akka_allreduce_tpu_torch import bench_suite
from akka_allreduce_tpu_torch import ops as tops
from akka_allreduce_tpu_torch.ops import local_reduce as tlr
from akka_allreduce_tpu_torch.state import state_from_numpy, state_to_numpy

TOL = dict(rtol=1e-6, atol=1e-6)
K = 8
MASKS = {
    "full": np.ones(K, np.float32),
    "partial": np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32),
    "zero": np.zeros(K, np.float32),
}
WIDTHS = [17, 1000, 128 * 512, 128 * 512 + 1]


def _payloads(k=K, data=1000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, data)).astype(np.float32)


def _port(arr):
    return state_from_numpy(arr, device="cpu")


def _mask(bits):
    return torch.from_numpy(np.array(bits, np.float32))


@pytest.mark.parametrize("data", WIDTHS)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_masked_average_matches_jax(mask, data):
    x, valid = _payloads(data=data), MASKS[mask]
    j_avg, j_count = jops.masked_average(x, valid)
    avg, count = tops.masked_average(_port(x), _mask(valid))
    assert count.shape == () and float(count) == float(j_count) == valid.sum()
    assert avg.shape == (data,)
    np.testing.assert_allclose(avg.numpy(), np.asarray(j_avg), **TOL)
    if mask == "zero":
        np.testing.assert_array_equal(avg.numpy(), np.zeros(data, np.float32))


@pytest.mark.parametrize("data", WIDTHS)
@pytest.mark.parametrize("mask", ["full", "partial"])
def test_elastic_average_step_matches_jax(mask, data):
    x, valid = _payloads(data=data, seed=1), MASKS[mask]
    want = np.asarray(jops.elastic_average_step(x, valid, 0.25))
    state = _port(x)
    out = tops.elastic_average_step(state, _mask(valid), 0.25)
    assert out is state  # updated in place, the caller's tensor returned
    np.testing.assert_allclose(state_to_numpy(state), want, **TOL)


@pytest.mark.parametrize("tiled", [False, True])
def test_elastic_average_step_zero_mask_keeps_state(tiled):
    x = _payloads(data=1000, seed=2)
    if tiled:
        x = np.asarray(jops.pack_tiles(x))
    want = np.asarray(jops.elastic_average_step(x, MASKS["zero"], 0.5))
    state = _port(x)
    tops.elastic_average_step(state, _mask(MASKS["zero"]), 0.5)
    got = state_to_numpy(state)
    np.testing.assert_array_equal(got.view(np.int32), x.view(np.int32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [1000, 128 * 512])
def test_elastic_average_step_tiled_matches_flat(data):
    x, valid = _payloads(k=4, data=data, seed=3), np.array([1, 0, 1, 1], np.float32)
    j_tiled = jops.pack_tiles(x)
    xt = tops.pack_tiles(_port(x))
    np.testing.assert_array_equal(state_to_numpy(xt), np.asarray(j_tiled))
    tops.elastic_average_step(xt, _mask(valid), 0.3)
    flat = tops.elastic_average_step(_port(x), _mask(valid), 0.3)
    tiled_out = tops.unpack_tiles(xt, data)
    np.testing.assert_allclose(tiled_out.numpy(), flat.numpy(), **TOL)
    j_out = jops.unpack_tiles(jops.elastic_average_step(j_tiled, valid, 0.3), data)
    np.testing.assert_allclose(tiled_out.numpy(), np.asarray(j_out), **TOL)


@pytest.mark.parametrize(
    "shape", [(2, 100, 128), (2, 512, 64), (2, 512, 128, 1)]
)
def test_elastic_average_step_rejects_bad_shape(shape):
    bad = np.zeros(shape, np.float32)
    if len(shape) == 3:  # the JAX package raises on the same tiled shapes
        with pytest.raises(ValueError):
            jops.elastic_average_step(bad, np.ones(2, np.float32), 0.5)
    with pytest.raises(ValueError):
        tops.elastic_average_step(torch.from_numpy(bad), torch.ones(2), 0.5)


def test_elastic_average_step_is_fixed_point_at_consensus():
    x = np.tile(_payloads(k=1)[0], (4, 1))
    valid = np.ones(4, np.float32)
    want = np.asarray(jops.elastic_average_step(x, valid, 0.9))
    state = _port(x)
    tops.elastic_average_step(state, _mask(valid), 0.9)
    np.testing.assert_allclose(state_to_numpy(state), x, **TOL)
    np.testing.assert_allclose(state_to_numpy(state), want, **TOL)


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_state_round_trip(layout):
    x = _payloads(k=3, data=300, seed=4)
    if layout == "packed":
        x = np.asarray(jops.pack_tiles(x))
    t = state_from_numpy(x, device="cpu")
    assert t.shape == x.shape and t.dtype == torch.float32
    tops.elastic_average_step(t, torch.ones(3), 0.5)  # must not write into x
    np.testing.assert_array_equal(state_to_numpy(state_from_numpy(x, "cpu")), x)
    with pytest.raises(ValueError):
        state_from_numpy(np.zeros((3, 4, 5), np.float32), device="cpu")


def test_bench_suite_rounds_match_jax():
    """The slice as a whole: rounds of the bench suite's loop (packed stack,
    all-ones mask, alpha 0.125) on the port equal the same rounds through the
    JAX functions, and each round's masked average agrees too."""
    rounds, per = 3, 1000
    launches = dict(tlr.LAUNCHES)
    x = _payloads(data=per, seed=5)
    valid = np.ones(K, np.float32)
    alpha = bench_suite.ALPHA
    j_state = jops.pack_tiles(x)
    xt = tops.pack_tiles(_port(x))
    for _ in range(rounds):
        j_avg, _ = jops.masked_average(jops.unpack_tiles(j_state, per), valid)
        avg, _ = tops.masked_average(tops.unpack_tiles(xt, per), _mask(valid))
        np.testing.assert_allclose(avg.numpy(), np.asarray(j_avg), **TOL)
        j_state = jops.elastic_average_step(j_state, valid, alpha)
        bench_suite.elastic_rounds(xt, _mask(valid), alpha, 1)
    np.testing.assert_allclose(
        state_to_numpy(xt), np.asarray(j_state), **TOL
    )
    assert np.isfinite(state_to_numpy(xt)).all()
    assert tlr.LAUNCHES == launches  # the CPU path launches no kernel
