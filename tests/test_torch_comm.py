"""The port's threshold allreduce (``akka_allreduce_tpu_torch.comm``) against
the JAX package's on the same inputs.

Mirrors ``tests/test_comm.py`` class by class: every case runs the JAX
function on the virtual CPU mesh (``line_mesh(8)``, ``grid_mesh(2, 4)``) and
its port on a mesh of virtual ranks with ``device="cpu"``, on inputs made
from a seed with numpy.

Tolerances: float32 results agree within rtol = atol = 1e-6. Compressed
results (bf16, int8) agree within 1e-6 relative to ``max|oracle|``: the port
adds ranks in the same order, casts to bf16 with the same round-to-nearest-
even, computes the int8 scale as XLA folds it (``amax * f32(1/127)``) and
quantizes with a true division, so equality is expected. The oracle checks
of the JAX tests (numpy masked sums) are kept beside, at their own
tolerances.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu import comm as jcomm
from akka_allreduce_tpu.comm import allreduce as jar
from akka_allreduce_tpu.comm import bandwidth as jbw
from akka_allreduce_tpu.parallel import grid_factors as jgrid_factors
from akka_allreduce_tpu.parallel import grid_mesh as jgrid_mesh
from akka_allreduce_tpu.parallel import line_mesh as jline_mesh
from akka_allreduce_tpu_torch import comm as tcomm
from akka_allreduce_tpu_torch.comm import allreduce as tar
from akka_allreduce_tpu_torch.comm import bandwidth as tbw
from akka_allreduce_tpu_torch.parallel import (
    RankMesh,
    grid_factors,
    grid_mesh,
    line_mesh,
)
from akka_allreduce_tpu_torch.utils import MetricsLogger

F32 = dict(rtol=1e-6, atol=1e-6)
REL = 1e-6  # compressed results: max |port - jax| / max |oracle|


@pytest.fixture(scope="module")
def jline8():
    return jline_mesh(8)


@pytest.fixture(scope="module")
def jgrid24():
    return jgrid_mesh(2, 4)


@pytest.fixture(scope="module")
def line8() -> RankMesh:
    return line_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def grid24() -> RankMesh:
    return grid_mesh(2, 4, device="cpu")


def rand(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def both(jmesh, mesh, xs, valid=None, **kw):
    """(JAX result, port result), each as numpy (sum, count, average)."""
    j = jcomm.threshold_allreduce(jmesh, xs, valid, **kw)
    t = tcomm.threshold_allreduce(mesh, xs, valid, **kw)
    return (
        tuple(np.asarray(a) for a in (j.sum, j.count, j.average())),
        tuple(a.numpy() for a in (t.sum, t.count, t.average())),
    )


def assert_f32_equal(j, t):
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, **F32)


def assert_rel(got, want, oracle, tol=REL):
    scale = np.abs(oracle).max() + 1e-6
    assert np.abs(np.asarray(got) - np.asarray(want)).max() / scale <= tol


def shard_rows(fn, n=8, n_out=1):
    """``fn`` on each device's flat row inside shard_map over line_mesh(n);
    returns the (n, ...) stacks of its ``n_out`` outputs as numpy."""
    spec = P("line")

    def body(x):
        out = fn(x.reshape(-1))
        out = out if isinstance(out, tuple) else (out,)
        return tuple(a[None] for a in out)

    f = jax.jit(
        jax.shard_map(
            body, mesh=jline_mesh(n), in_specs=spec,
            out_specs=(spec,) * n_out, check_vma=False,
        )
    )
    return f


class TestThresholdAllreduce:
    def test_full_participation_equals_sum(self, jline8, line8):
        xs = rand(8, 1000)
        j, t = both(jline8, line8, xs)
        assert_f32_equal(j, t)
        np.testing.assert_allclose(t[0], xs.sum(0), rtol=1e-5)
        assert (t[1] == 8).all()
        np.testing.assert_allclose(t[2], xs.mean(0), rtol=1e-5)

    def test_masked_devices_excluded(self, jline8, line8):
        xs = rand(8, 257)  # odd size
        valid = np.array([1, 1, 0, 1, 0, 1, 1, 1], dtype=np.float32)
        j, t = both(jline8, line8, xs, valid)
        assert_f32_equal(j, t)
        oracle = (xs * valid[:, None]).sum(0)
        np.testing.assert_allclose(t[0], oracle, rtol=1e-5)
        assert (t[1] == 6).all()

    def test_per_bucket_masks(self, jline8, line8):
        # data 100, bucket 30 -> 4 buckets (30/30/30/10); device d drops bucket d%4
        xs = rand(8, 100)
        valid = np.ones((8, 4), dtype=np.float32)
        for d in range(8):
            valid[d, d % 4] = 0.0
        j, t = both(jline8, line8, xs, valid, bucket_size=30)
        assert_f32_equal(j, t)
        assert (t[1] == 6).all()

    def test_all_dropped_bucket_reads_zero(self, jline8, line8):
        xs = rand(8, 64)
        valid = np.ones((8, 2), dtype=np.float32)
        valid[:, 1] = 0.0  # nobody contributes bucket 1
        j, t = both(jline8, line8, xs, valid, bucket_size=32)
        assert_f32_equal(j, t)
        assert (t[1][32:] == 0).all()
        np.testing.assert_allclose(t[2][32:], 0.0)

    def test_rejects_wrong_shapes(self, jline8, line8):
        with pytest.raises(ValueError):
            jcomm.threshold_allreduce(jline8, rand(4, 10))
        with pytest.raises(ValueError, match="n_devices=8"):
            tcomm.threshold_allreduce(line8, rand(4, 10))

    def test_caller_tensor_not_written(self, jline8, line8):
        # the JAX API never donates the caller's array; the port never
        # writes the caller's tensor, on any schedule
        xs = torch.from_numpy(rand(8, 64))
        keep = xs.clone()
        r1 = tcomm.threshold_allreduce(line8, xs)
        r2 = tcomm.threshold_allreduce(line8, xs, schedule="pallas_ring")
        r3 = tcomm.threshold_allreduce(line8, xs, schedule="ring", compress="int8")
        assert torch.equal(xs, keep)
        np.testing.assert_allclose(r1.sum.numpy(), r2.sum.numpy(), **F32)
        assert r3.sum.data_ptr() != xs.data_ptr()
        j = jcomm.threshold_allreduce(
            jline8, jax.device_put(keep.numpy(), NamedSharding(jline8, P("line")))
        )
        np.testing.assert_allclose(r1.sum.numpy(), np.asarray(j.sum), **F32)

    def test_ring_schedule_matches_psum(self, jline8, line8):
        xs = rand(8, 1003)  # not divisible by 8: exercises padding
        valid = np.array([1, 0, 1, 1, 1, 1, 0, 1], dtype=np.float32)
        j, t = both(jline8, line8, xs, valid, schedule="ring")
        assert_f32_equal(j, t)
        oracle = (xs * valid[:, None]).sum(0)
        np.testing.assert_allclose(t[0], oracle, rtol=1e-4, atol=1e-4)
        assert (t[1] == 6).all()

    def test_butterfly_on_grid_matches_sum(self, jgrid24, grid24):
        xs = rand(8, 500)
        valid = np.array([1, 1, 1, 0, 1, 1, 1, 1], dtype=np.float32)
        j, t = both(jgrid24, grid24, xs, valid, schedule="butterfly")
        assert_f32_equal(j, t)
        oracle = (xs * valid[:, None]).sum(0)
        np.testing.assert_allclose(t[0], oracle, rtol=1e-5, atol=1e-6)
        assert (t[1] == 7).all()

    def test_butterfly_axes_in_given_order(self, jgrid24, grid24):
        """``axes=("cols", "rows")``: the stack is laid over the mesh
        cols-major and the stages run cols then rows, as in JAX."""
        xs = rand(8, 300, seed=8)
        valid = np.array([1, 0, 1, 1, 1, 1, 0, 1], dtype=np.float32)
        for compress in (None, "bf16"):
            j, t = both(jgrid24, grid24, xs, valid, schedule="butterfly",
                        axes=("cols", "rows"), compress=compress)
            assert_f32_equal(j, t)

    def test_butterfly_requires_grid(self, jline8, line8):
        with pytest.raises(ValueError):
            jcomm.threshold_allreduce(jline8, rand(8, 16), schedule="butterfly")
        with pytest.raises(ValueError, match="2D grid"):
            tcomm.threshold_allreduce(line8, rand(8, 16), schedule="butterfly")

    def test_partial_axis_reduce_rejected_at_host_api(self, jgrid24, grid24):
        with pytest.raises(ValueError, match="full mesh"):
            jcomm.threshold_allreduce(jgrid24, rand(8, 20), axes="rows")
        with pytest.raises(ValueError, match="full mesh"):
            tcomm.threshold_allreduce(grid24, rand(8, 20), axes="rows")

    def test_masked_psum_partial_axis(self, jgrid24, grid24):
        import jax.numpy as jnp

        xs = rand(8, 20)

        def kernel(x):
            s, c = jcomm.masked_psum(x.reshape(-1), jnp.float32(1.0), "rows")
            return s[None], c[None]

        f = jax.shard_map(
            kernel, mesh=jgrid24, in_specs=P(("rows", "cols")),
            out_specs=(P("cols"), P("cols")),
        )
        with jax.set_mesh(jgrid24):
            jsums, jcounts = (np.asarray(a) for a in f(xs))
        sums, counts = tcomm.masked_psum(grid24, torch.from_numpy(xs), 1.0, "rows")
        assert sums.shape == (8, 20) and counts.shape == (8,)
        # grid (2, 4): rank (r, c) holds the row-sum of column c
        for r in range(2):
            for c in range(4):
                np.testing.assert_allclose(sums[4 * r + c].numpy(), jsums[c], **F32)
                np.testing.assert_allclose(sums[4 * r + c].numpy(), xs[c] + xs[4 + c],
                                           rtol=1e-5)
        assert (counts.numpy() == 2).all() and (jcounts == 2).all()

    @pytest.mark.parametrize(
        "mesh_name,kw",
        [
            ("line", dict(axes="nope")),
            ("grid", dict(axes="rows", schedule="bogus")),
            ("line", dict(schedule="bogus", compress="fp4")),
            ("line", dict(schedule="butterfly", compress="fp4")),
            ("grid", dict(schedule="ring", compress="fp4")),
            ("grid", dict(schedule="pallas_ring")),
            ("line", dict(compress="fp4")),
            ("line", dict(compress="int8")),
            ("grid", dict(schedule="butterfly", compress="int8")),
        ],
    )
    def test_validation_errors_match(self, jline8, jgrid24, line8, grid24,
                                     mesh_name, kw):
        """The same checks in the same order: where several options are
        wrong, both build functions name the same one first."""
        jmesh, mesh = (jline8, line8) if mesh_name == "line" else (jgrid24, grid24)
        with pytest.raises(ValueError) as jerr:
            jar.build_threshold_allreduce(jmesh, **kw)
        with pytest.raises(ValueError) as terr:
            tar.build_threshold_allreduce(mesh, **kw)
        # the first sentence; the JAX text then names shard_map
        assert str(terr.value).split(". ")[0] == str(jerr.value).split(". ")[0]

    def test_per_bucket_mask_needs_bucket_size(self, jline8, line8):
        valid = np.ones((8, 2), np.float32)
        with pytest.raises(ValueError, match="requires bucket_size") as jerr:
            jcomm.threshold_allreduce(jline8, rand(8, 16), valid)
        with pytest.raises(ValueError, match="requires bucket_size") as terr:
            tcomm.threshold_allreduce(line8, rand(8, 16), valid)
        assert str(terr.value) == str(jerr.value)


class TestBandwidthHarness:
    def test_measure_reports_and_logs(self, jline8, line8):
        logger = MetricsLogger()
        rep = tcomm.measure_allreduce(line8, 4096, iters=3, warmup=1, logger=logger)
        jrep = jcomm.measure_allreduce(jline8, 4096, iters=1, warmup=1)
        assert rep.n_devices == jrep.n_devices == 8
        assert rep.bus_gbps_best > 0
        # every field of the JAX record, plus where it was measured
        assert set(jrep.to_dict()) < set(rep.to_dict())
        d = rep.to_dict()
        assert d["device"] == "cpu" and d["power_limit"] is None
        assert d["path"] == "virtual_ranks_one_card"
        lines = logger.dump().strip().splitlines()
        assert len(lines) == 3
        rec = json.loads(lines[0])
        assert rec["n_devices"] == 8 and rec["bus_gbps"] > 0

    @pytest.mark.parametrize(
        "schedule,compress", [("psum", "bf16"), ("ring", "int8")]
    )
    def test_measure_with_compression(self, line8, schedule, compress):
        rep = tcomm.measure_allreduce(
            line8, 4096, iters=2, warmup=1, schedule=schedule, compress=compress,
        )
        assert rep.bus_gbps_best > 0 and rep.compress == compress

    @pytest.mark.parametrize("n,nbytes,s", [(8, 4096, 1e-3), (1, 10, 1.0),
                                            (4, 10, 0.0), (16, 1 << 28, 0.25)])
    def test_bus_bandwidth_formula(self, n, nbytes, s):
        assert tbw.bus_bandwidth_gbps(n, nbytes, s) == jbw.bus_bandwidth_gbps(
            n, nbytes, s
        )


class TestMeshHelpers:
    def test_grid_factors(self):
        for n in range(1, 33):
            assert grid_factors(n) == jgrid_factors(n)
        assert grid_factors(16) == (4, 4)
        with pytest.raises(ValueError):
            grid_factors(0)

    def test_line_mesh_subset(self):
        assert line_mesh(4, device="cpu").shape == jline_mesh(4).shape == {"line": 4}

    def test_grid_mesh_auto(self):
        m = grid_mesh(n=8, device="cpu")
        assert m.shape == jgrid_mesh(devices=jax.devices()[:8]).shape
        assert m.shape == {"rows": 2, "cols": 4}
        assert grid_mesh(rows=2, n=8, device="cpu").shape == {"rows": 2, "cols": 4}
        assert grid_mesh(cols=2, n=8, device="cpu").shape == {"rows": 4, "cols": 2}

    def test_grid_mesh_errors_match(self):
        devs = jax.devices()[:8]
        with pytest.raises(ValueError) as jerr:
            jgrid_mesh(3, devices=devs)
        with pytest.raises(ValueError) as terr:
            grid_mesh(3, n=8, device="cpu")
        assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError, match="grid 2x4 != 6"):
            grid_mesh(2, 4, n=6, device="cpu")
        with pytest.raises(ValueError):
            line_mesh(0, device="cpu")

    def test_rank_order_is_row_major_like_make_mesh(self):
        """Rank r of a 2 x 4 grid sits at (r // 4, r % 4), where
        ``jax.make_mesh`` puts device r: a sum over ``cols`` groups ranks
        4r .. 4r + 3."""
        ids = np.vectorize(lambda d: d.id)(jgrid_mesh(2, 4).devices)
        np.testing.assert_array_equal(ids, np.arange(8).reshape(2, 4))
        xs = torch.arange(8, dtype=torch.float32)[:, None]
        sums, _ = tcomm.masked_psum(grid_mesh(2, 4, device="cpu"), xs, 1.0, "cols")
        np.testing.assert_array_equal(sums[:, 0].numpy(), [6] * 4 + [22] * 4)


class TestCompressedSchedules:
    """bf16 halves / int8 quarters the bytes per hop while counts stay exact
    float32; the port's results equal the JAX package's."""

    def _oracle(self, xs, valid):
        return (xs * valid[:, None]).sum(0), valid.sum()

    def test_bf16_psum_close_and_counts_exact(self, jline8, line8):
        xs = rand(8, 513)
        valid = np.array([1, 1, 0, 1, 1, 1, 0, 1], dtype=np.float32)
        j, t = both(jline8, line8, xs, valid, compress="bf16")
        want, n = self._oracle(xs, valid)
        assert_rel(t[0], j[0], want)
        assert np.abs(t[0] - want).max() / (np.abs(want).max() + 1e-6) < 2e-2
        assert (t[1] == n).all()  # counts never compressed

    def test_bf16_butterfly_close(self, jgrid24, grid24):
        xs = rand(8, 200)
        j, t = both(jgrid24, grid24, xs, schedule="butterfly", compress="bf16")
        assert_rel(t[0], j[0], xs.sum(0))

    @pytest.mark.parametrize("mode,tol", [("bf16", 2e-2), ("int8", 8e-2)])
    def test_compressed_ring_close_and_replicated(self, jline8, line8, mode, tol):
        xs = rand(8, 300, seed=3)
        valid = np.array([1, 0, 1, 1, 1, 1, 1, 1], dtype=np.float32)
        j, t = both(jline8, line8, xs, valid, schedule="ring", compress=mode)
        want, n = self._oracle(xs, valid)
        assert_rel(t[0], j[0], want)
        assert np.abs(t[0] - want).max() / (np.abs(want).max() + 1e-6) < tol
        assert (t[1] == n).all()
        # every rank's row is bit-identical: the gather forwards the pair
        rows = tar.ring_allreduce_sum(
            torch.from_numpy(xs * valid[:, None]), compress=mode
        )
        assert all(torch.equal(rows[d], rows[0]) for d in range(8))

    def test_compressed_ring_bucketed_masks(self, jline8, line8):
        xs = rand(8, 96, seed=5)
        valid = np.ones((8, 3), dtype=np.float32)
        valid[2, :] = 0.0  # device 2 contributes nothing
        valid[4, 1] = 0.0  # device 4 misses bucket 1
        j, t = both(jline8, line8, xs, valid, bucket_size=32, schedule="ring",
                    compress="bf16")
        mask = np.repeat(valid, 32, axis=1)
        assert_rel(t[0], j[0], (xs * mask).sum(0))
        np.testing.assert_array_equal(t[1], mask.sum(0))

    def test_int8_all_zero_segment_is_safe(self, jline8, line8):
        xs = np.zeros((8, 64), np.float32)
        j, t = both(jline8, line8, xs, schedule="ring", compress="int8")
        assert np.isfinite(t[0]).all()
        np.testing.assert_array_equal(t[0], 0.0)
        np.testing.assert_array_equal(t[0], j[0])

    def test_int8_requires_ring(self, jline8, line8):
        with pytest.raises(ValueError, match="int8"):
            jcomm.threshold_allreduce(jline8, rand(8, 16), compress="int8")
        with pytest.raises(ValueError, match="int8"):
            tcomm.threshold_allreduce(line8, rand(8, 16), compress="int8")

    def test_unknown_mode_rejected(self, jline8, line8):
        with pytest.raises(ValueError, match="compress"):
            jcomm.threshold_allreduce(jline8, rand(8, 16), compress="fp4")
        with pytest.raises(ValueError, match="compress"):
            tcomm.threshold_allreduce(line8, rand(8, 16), compress="fp4")


class TestRingReduceScatter:
    """ring_reduce_scatter_sum: rank i holds fully-reduced segment i."""

    @pytest.mark.parametrize("compress", [None, "bf16", "int8"])
    @pytest.mark.parametrize("data", [4096, 4100])  # exact + padded tail
    def test_matches_jax_segments(self, compress, data):
        n = 8
        xs = np.random.default_rng(0).standard_normal((n, data)).astype(np.float32)
        (jout,) = shard_rows(
            lambda x: jar.ring_reduce_scatter_sum(x, "line", n, compress=compress)
        )(xs)
        out = tar.ring_reduce_scatter_sum(torch.from_numpy(xs), compress=compress)
        seg = -(-data // n)
        want = np.pad(xs.sum(0), (0, n * seg - data)).reshape(n, seg)
        assert out.shape == (n, seg)
        if compress is None:
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
        else:
            assert_rel(out.numpy(), jout, want)
        tol = {None: 1e-5, "bf16": 2e-2, "int8": 0.3}[compress]
        np.testing.assert_allclose(out.numpy(), want,
                                   atol=tol * np.abs(want).max(), rtol=0)


class TestRingPerHopResidual:
    """The compressed rings return each rank's injected quantization error,
    and summing every rank's residual recovers the f32 result; the port's
    outputs and residuals equal the JAX package's."""

    N = 8

    def _both(self, xs, compress):
        n = self.N
        jout, jres = shard_rows(
            lambda x: jar.ring_allreduce_sum(
                x, "line", n, compress=compress, return_residual=True
            ),
            n_out=2,
        )(xs)
        out, res = tar.ring_allreduce_sum(
            torch.from_numpy(xs), compress=compress, return_residual=True
        )
        return np.asarray(jout), np.asarray(jres), out.numpy(), res.numpy()

    @pytest.mark.parametrize("compress", ["bf16", "int8"])
    @pytest.mark.parametrize("data", [4096, 4100])  # exact + padded tail
    def test_allreduce_residual_accounting_identity(self, compress, data):
        xs = np.random.default_rng(11).standard_normal((self.N, data)).astype(np.float32)
        jout, jres, out, res = self._both(xs, compress)
        want = xs.sum(0, dtype=np.float64).astype(np.float32)
        scale = np.abs(want).max()
        assert_rel(out, jout, want)
        assert_rel(res, jres, want)
        assert np.abs(out[0] - want).max() > 1e-4 * scale
        np.testing.assert_allclose(out[0] + res.sum(0), want, atol=5e-5 * scale, rtol=0)

    def test_residual_is_per_device_local(self):
        xs = np.random.default_rng(12).standard_normal((self.N, 2048)).astype(np.float32)
        xs[3] = 0.0
        jout, jres, out, res = self._both(xs, "int8")
        assert np.abs(res[3]).max() > 0.0
        want = xs.sum(0, dtype=np.float64).astype(np.float32)
        assert_rel(res, jres, want)
        np.testing.assert_allclose(out[0] + res.sum(0), want,
                                   atol=5e-5 * np.abs(want).max(), rtol=0)

    @pytest.mark.parametrize("data", [4096, 4100])
    def test_reduce_scatter_residual_identity(self, data):
        n = self.N
        xs = np.random.default_rng(13).standard_normal((n, data)).astype(np.float32)
        jout, jres = shard_rows(
            lambda x: jar.ring_reduce_scatter_sum(
                x, "line", n, compress="int8", return_residual=True
            ),
            n_out=2,
        )(xs)
        out, res = tar.ring_reduce_scatter_sum(
            torch.from_numpy(xs), compress="int8", return_residual=True
        )
        seg = -(-data // n)
        want = np.pad(xs.sum(0, dtype=np.float64).astype(np.float32),
                      (0, n * seg - data)).reshape(n, seg)
        assert_rel(out.numpy(), jout, want)
        assert_rel(res.numpy(), jres, want)
        np.testing.assert_allclose(
            out.numpy() + res.numpy().sum(0).reshape(n, seg), want,
            atol=5e-5 * np.abs(want).max(), rtol=0,
        )

    def test_residual_requires_compress(self):
        with pytest.raises(ValueError, match="compress"):
            tar.ring_allreduce_sum(torch.from_numpy(rand(8, 64)), return_residual=True)
        with pytest.raises(ValueError, match="compress"):
            tar.ring_reduce_scatter_sum(torch.from_numpy(rand(8, 64)),
                                        return_residual=True)
