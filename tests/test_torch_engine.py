"""The port's host engine against the JAX package's, on the CPU.

The JAX engine is numpy on the host (no XLA), so every comparison here is
cheap. The port runs with ``device="cpu"``, its payloads CPU tensors; with
the same seeded inputs and the same order of delivery, every f32 sum is the
same IEEE operation in the same order, so the results must be equal bit for
bit (``assert_array_equal``), not within a tolerance:

- ``LocalAllreduceSystem`` at 4 nodes, 1,000 floats in chunks of 64 (not a
  multiple), 5 rounds, in 1-D and 2-D (the butterfly chain), thresholds 1.0
  and 0.75 (1-D: every message of worker 3 dropped, ``tests/test_control.py``'s
  filter), zero-copy scatter on and off: each node's flush rounds, sums and
  counts, the router's ``delivered``/``dropped`` and ``master.is_done``, and
  the obs counters the run moved;
- one scripted sequence of stores through both packages' buffers
  (duplicates, a deferred reduce, a trigger lowered under counts past it, a
  tail chunk, an out-of-window round, every error): the same return values,
  exception types and messages;
- an ``AllreduceWorker`` under ``RoundPolicy(wire="int8")``: the same
  ScatterBlocks and error-feedback residuals round after round, a
  non-finite input saturated the same way, and the wire quantizer itself;
- the four reductions of ``native/`` against ``tensor_reduce`` (the elastic
  update within rtol 1e-6: the JAX package's numpy fallback computes it in
  float64, its C++ loop in float32);
- both binders over 5 rounds (sums and averages exact, weights within rtol
  1e-6); the configs' JSON round trip and validation errors; ``pod``'s
  assignment functions; the obs modules' copies.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from akka_allreduce_tpu import buffers as jbuffers
from akka_allreduce_tpu import config as jconfig
from akka_allreduce_tpu import native as jnative
from akka_allreduce_tpu import protocol as jprotocol
from akka_allreduce_tpu.binder import ElasticAverageBinder as JElastic
from akka_allreduce_tpu.binder import GradSyncBinder as JGradSync
from akka_allreduce_tpu.control import AllreduceWorker as JWorker
from akka_allreduce_tpu.control import LocalAllreduceSystem as JSystem
from akka_allreduce_tpu.control import pod as jpod
from akka_allreduce_tpu.control import wire as jwire
from akka_allreduce_tpu.obs import metrics as jmetrics
from akka_allreduce_tpu.obs import trace as jtrace
from akka_allreduce_tpu.obs import watchdog as jwatchdog
from akka_allreduce_tpu_torch import buffers as tbuffers
from akka_allreduce_tpu_torch import config as tconfig
from akka_allreduce_tpu_torch import protocol as tprotocol
from akka_allreduce_tpu_torch import tensor_reduce
from akka_allreduce_tpu_torch.binder import ElasticAverageBinder, GradSyncBinder
from akka_allreduce_tpu_torch.control import AllreduceWorker, LocalAllreduceSystem
from akka_allreduce_tpu_torch.control import pod as tpod
from akka_allreduce_tpu_torch.control import wire as twire
from akka_allreduce_tpu_torch.obs import metrics as tmetrics
from akka_allreduce_tpu_torch.obs import trace as ttrace
from akka_allreduce_tpu_torch.obs import watchdog as twatchdog

NODES, SIZE, CHUNK, ROUNDS = 4, 1000, 64, 5
# the obs names both engines count under
OBS_PREFIXES = ("worker.", "master.", "adapt.")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _config(mod, *, th=1.0, dims=1, zero_copy=False, rounds=ROUNDS, size=SIZE):
    return mod.AllreduceConfig(
        threshold=mod.ThresholdConfig(th, th, th),
        metadata=mod.MetaDataConfig(data_size=size, max_chunk_size=CHUNK),
        line_master=mod.LineMasterConfig(round_window=2, max_rounds=rounds),
        master=mod.MasterConfig(node_num=NODES, dimensions=dims),
        worker=mod.WorkerConfig(zero_copy_scatter=zero_copy),
    )


def _drop_worker_3(complete_cls):
    """``tests/test_control.py``'s filter: every payload message from worker
    3 vanishes (its completions still reach the master)."""

    def drop(env):
        return (
            hasattr(env.msg, "src_id")
            and getattr(env.msg, "src_id", None) == 3
            and not isinstance(env.msg, complete_cls)
        )

    return drop


def _obs_values(registry) -> dict:
    """``{name: (kind, value)}`` of the engine's metrics: a histogram by its
    count of observations."""
    out = {}
    for name, value in registry.snapshot().items():
        if name.startswith(OBS_PREFIXES):
            kind = type(registry._metrics[name]).__name__
            out[name] = (kind, value["count"] if isinstance(value, dict) else value)
    return out


#: the value every engine gauge is parked at for the length of a run
_UNSET = -123456789


def _park_gauges(registry) -> dict:
    """Set every engine-prefixed gauge of ``registry`` to ``_UNSET`` and
    return the values it held: after the run, a gauge still at ``_UNSET``
    is one the run did not set (either registry may hold gauges of modules
    the engine does not run, such as the TCP master's epoch, left anywhere
    by other tests)."""
    held = {}
    for name, metric in list(registry._metrics.items()):
        if name.startswith(OBS_PREFIXES) and type(metric).__name__ == "Gauge":
            held[name] = metric.value
            metric.set(_UNSET)
    return held


def _restore_gauges(registry, held: dict) -> None:
    for name, value in held.items():
        if registry._metrics[name].value == _UNSET:
            registry._metrics[name].set(value)


def _obs_moved(before: dict, after: dict) -> dict:
    """What a run moved: each counter's and histogram's increase, and the
    last value of each gauge the run set."""
    moved = {}
    for name, (kind, value) in after.items():
        if name.endswith("round_in_flight"):
            continue  # -1 between rounds, whichever round ran last
        if kind == "Gauge":
            if value != _UNSET:
                moved[name] = value
        elif value != before.get(name, (kind, 0))[1]:
            moved[name] = value - before.get(name, (kind, 0))[1]
    return moved


def _run_both(*, th, dims, zero_copy, drop):
    """Run the JAX system and the port's (CPU) on the same seeded inputs;
    returns ``(jax_sinks, port_sinks, jax_system, port_system, obs deltas)``."""
    rng = np.random.default_rng(7)
    inputs = [rng.standard_normal(SIZE).astype(np.float32) for _ in range(NODES)]
    results = []
    for pkg, system_cls, proto, registry, extra in (
        (jconfig, JSystem, jprotocol, jmetrics.REGISTRY, {}),
        (tconfig, LocalAllreduceSystem, tprotocol, tmetrics.REGISTRY,
         {"device": "cpu"}),
    ):
        outs = {i: [] for i in range(NODES)}
        srcs = [
            (lambda req, x=x, proto=proto: proto.AllReduceInput(
                x if proto is jprotocol else torch.from_numpy(x)))
            for x in inputs
        ]
        held = _park_gauges(registry)
        try:
            before = _obs_values(registry)
            system = system_cls(
                NODES, srcs, [outs[i].append for i in range(NODES)],
                _config(pkg, th=th, dims=dims, zero_copy=zero_copy),
                drop_filter=_drop_worker_3(proto.CompleteAllreduce) if drop else None,
                **extra,
            )
            system.start()
            system.run_until_quiescent()
            results.append((outs, system, _obs_values(registry), before))
        finally:
            _restore_gauges(registry, held)
    (jouts, jsys, jafter, jbefore), (touts, tsys, tafter, tbefore) = results
    return (jouts, touts, jsys, tsys, _obs_moved(jbefore, jafter),
            _obs_moved(tbefore, tafter))


@pytest.mark.parametrize("zero_copy", [False, True])
@pytest.mark.parametrize(
    "dims,th,drop",
    [(1, 1.0, False), (2, 1.0, False), (1, 0.75, True), (2, 0.75, False)],
)
def test_local_system_matches_jax_bit_for_bit(dims, th, drop, zero_copy):
    jouts, touts, jsys, tsys, jdelta, tdelta = _run_both(
        th=th, dims=dims, zero_copy=zero_copy, drop=drop)
    for i in range(NODES):
        assert [o.iteration for o in touts[i]] == [o.iteration for o in jouts[i]]
        assert len(jouts[i]) == ROUNDS
        for t, j in zip(touts[i], jouts[i]):
            assert t.data.dtype == torch.float32 and t.count.dtype == torch.int32
            np.testing.assert_array_equal(t.data.numpy(), j.data)
            np.testing.assert_array_equal(t.count.numpy(), j.count)
    assert (tsys.router.delivered, tsys.router.dropped) == (
        jsys.router.delivered, jsys.router.dropped)
    assert tsys.master.is_done == jsys.master.is_done
    assert tsys.master.total_completed == jsys.master.total_completed
    if drop:
        assert tsys.router.dropped > 0
        assert set(np.unique(touts[0][-1].count.numpy())) <= {0, 3}
    # the obs counters both engines moved in this run, and their gauges
    assert tdelta == jdelta
    assert tdelta["worker.rounds_completed"] == NODES * dims * ROUNDS


# -- the buffers, one scripted sequence ------------------------------------------


def _outcome(fn, *args):
    try:
        result = fn(*args)
    except Exception as e:  # the sequence records each error as a result
        return ("error", type(e).__name__, str(e))
    if isinstance(result, tuple):
        return tuple(_np(r) if hasattr(r, "shape") else r for r in result)
    return _np(result) if hasattr(result, "shape") else result


def _same(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _replay(steps, jobj, tobj):
    """Apply each ``(method, *args)`` to both objects; every outcome (value
    or error) must agree. Returns the port's outcomes."""
    outcomes = []
    for method, *args in steps:
        j = _outcome(getattr(jobj, method), *args)
        t = _outcome(getattr(tobj, method),
                     *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                       for a in args])
        assert _same(j, t), (method, args, j, t)
        outcomes.append(t)
    return outcomes


def test_scattered_buffer_sequence_matches_jax():
    meta = (1000, 64)  # block 250 over 4 peers: chunks 64, 64, 64, 58
    rng = np.random.default_rng(3)
    v = [rng.standard_normal(64).astype(np.float32) for _ in range(8)]
    tail = rng.standard_normal(58).astype(np.float32)
    jbuf = jbuffers.ScatteredDataBuffer(
        jconfig.MetaDataConfig(*meta), jconfig.ThresholdConfig(th_reduce=0.75), 4)
    tbuf = tbuffers.ScatteredDataBuffer(
        tconfig.MetaDataConfig(*meta), tconfig.ThresholdConfig(th_reduce=0.75), 4,
        device="cpu")
    steps = [
        ("store", v[0], 0, 0), ("store", v[1], 1, 0),
        ("store", v[2], 1, 0),  # duplicate: ignored, not accumulated
        ("store", v[2], 2, 0),  # crosses the trigger (3 of 4)
        ("reach_reducing_threshold", 0),
        ("store", v[3], 3, 0),  # late, before reduce: still accumulates
        ("count", 0), ("reduce", 0),  # deferred reduce: all four in the sum
        ("reach_reducing_threshold", 0),
        ("store", v[4], 0, 1), ("store", v[5], 1, 1),
        ("set_reduce_trigger", 2),  # lowered under counts already past it
        ("set_reduce_trigger", 2),
        ("store", v[6], 2, 1),  # edge already fired
        ("reduce", 1),
        ("store", v[7], 3, 1),  # after reduce: counted, not added
        ("count", 1), ("reduce", 1),
        ("store", tail, 0, 3), ("chunk_size", 3), ("reduce", 3),
        ("store", v[0], 1, 3),  # wrong shape for the tail chunk
        ("store", v[0], 4, 2), ("store", v[0], 0, 4), ("store", v[0], 0, -1),
        ("count", 7), ("reach_reducing_threshold", -1),
        ("reduce", 2),  # no contributions: zeros, count 0
        ("set_reduce_trigger", 9), ("set_reduce_trigger", 0),
    ]
    out = _replay(steps, jbuf, tbuf)
    np.testing.assert_array_equal(out[7][0], ((v[0] + v[1]) + v[2]) + v[3])
    assert out[14][1] == 3 and out[17][1] == 4
    np.testing.assert_array_equal(out[17][0], out[14][0])  # late store not added


def test_reduce_view_stays_as_broadcast():
    """No read-only flag in torch: the view ``reduce`` hands out keeps its
    values because ``store`` never adds into a reduced chunk."""
    buf = tbuffers.ScatteredDataBuffer(
        tconfig.MetaDataConfig(12, 4), tconfig.ThresholdConfig(th_reduce=0.5), 3,
        device="cpu")
    assert not buf.store(torch.ones(4), 0, 0)
    assert buf.store(torch.ones(4), 1, 0)
    view, count = buf.reduce(0)
    before = view.clone()
    assert not buf.store(torch.full((4,), 5.0), 2, 0)  # late: counted only
    assert count == 2 and buf.count(0) == 3 and torch.equal(view, before)


def test_reduced_buffer_and_window_sequence_matches_jax():
    meta_args = (1000, 64)
    rng = np.random.default_rng(4)
    vals = [rng.standard_normal(64).astype(np.float32) for _ in range(4)]
    tail = rng.standard_normal(58).astype(np.float32)
    th = dict(th_complete=0.5)
    jbuf = jbuffers.ReducedDataBuffer(
        jconfig.MetaDataConfig(*meta_args), jconfig.ThresholdConfig(**th), 4)
    tbuf = tbuffers.ReducedDataBuffer(
        tconfig.MetaDataConfig(*meta_args), tconfig.ThresholdConfig(**th), 4,
        device="cpu")
    steps = [
        ("store", vals[0], 0, 0, 4), ("store", vals[1], 0, 0, 2),  # duplicate
        ("store", tail, 3, 3, 3), ("store", vals[2], 2, 1, 1),
        ("reach_completion_threshold",),
        ("store", vals[3], 3, 3, 1),  # wrong shape for the tail chunk
        ("store", vals[3], 4, 0, 1), ("store", vals[3], 0, 4, 1),
        ("get_with_counts",), ("get_with_counts", False),
    ]
    for c in range(4):
        steps.append(("store", vals[c] if c < 3 else tail, 1, c, 3))
    steps += [("reach_completion_threshold",), ("get_with_counts",)]
    out = _replay(steps, jbuf, tbuf)
    assert jbuf.filled_chunks == tbuf.filled_chunks == 7
    assert set(np.unique(out[-1][1])) == {0, 1, 3, 4}

    jr = jbuffers.RoundBuffers(
        jconfig.MetaDataConfig(*meta_args), jconfig.ThresholdConfig(), 4, window=2)
    tr = tbuffers.RoundBuffers(
        tconfig.MetaDataConfig(*meta_args), tconfig.ThresholdConfig(), 4, window=2,
        device="cpu")
    for method, *args in [
        ("in_window", 0), ("in_window", 2), ("scattered", 2), ("reduced", -1),
        ("complete", 0), ("in_window", 2), ("fast_forward", 6), ("in_window", 4),
        ("in_window", 5), ("in_window", 6), ("in_window", 7), ("scattered", 3),
    ]:
        _replay([(method, *args)], jr, tr)
    assert tr.completed_up_to == jr.completed_up_to == 4
    assert tr.scattered(5) is tr.scattered(5) and tr.reduced(6) is tr.reduced(6)
    assert tr.scattered(5).device == torch.device("cpu")
    with pytest.raises(ValueError, match="window must be positive"):
        tbuffers.RoundBuffers(tconfig.MetaDataConfig(8), tconfig.ThresholdConfig(), 2,
                              window=0, device="cpu")


# -- the worker's int8 error feedback and the wire quantizer ---------------------


def _int8_worker(mod, proto, worker_cls, inputs, **extra):
    w = worker_cls(lambda req: proto.AllReduceInput(inputs[req.iteration]),
                   lambda out: None, mod.WorkerConfig(round_window=8), **extra)
    w.configure(mod.MetaDataConfig(data_size=SIZE, max_chunk_size=CHUNK),
                mod.ThresholdConfig())
    w.handle(proto.PrepareAllreduce(1, (0, 1, 2, 3), worker_id=1, round_num=0))
    return w


def test_int8_worker_sends_and_keeps_what_jax_does():
    rng = np.random.default_rng(5)
    inputs = [rng.standard_normal(SIZE).astype(np.float32) * 10 ** (r - 2)
              for r in range(6)]
    inputs[3][17] = np.inf  # saturated by the quantizer, counted
    jw = _int8_worker(jconfig, jprotocol, JWorker, inputs)
    tw = _int8_worker(tconfig, tprotocol, AllreduceWorker,
                      [torch.from_numpy(x) for x in inputs], device="cpu")
    pol_j, pol_t = jprotocol.RoundPolicy(wire="int8"), tprotocol.RoundPolicy(wire="int8")
    for r in range(5):
        jout = jw.handle(jprotocol.StartAllreduce(r, policy=pol_j))
        tout = tw.handle(tprotocol.StartAllreduce(r, policy=pol_t))
        assert len(tout) == len(jout) == 3 * 4  # 3 peers x 4 chunks, self kept
        for te, je in zip(tout, jout):
            assert (te.dest, te.wire) == (je.dest, je.wire) == (te.dest, "int8")
            tm, jm = te.msg, je.msg
            assert (tm.src_id, tm.dest_id, tm.chunk_id, tm.round_num) == (
                jm.src_id, jm.dest_id, jm.chunk_id, jm.round_num)
            np.testing.assert_array_equal(tm.value.numpy(), jm.value)
        assert tw._ef_residual.keys() == jw._ef_residual.keys()
        for key, res in jw._ef_residual.items():
            np.testing.assert_array_equal(tw._ef_residual[key].numpy(), res)
    # a default-policy round drops the pending corrections in both
    jw.handle(jprotocol.StartAllreduce(5))
    tw.handle(tprotocol.StartAllreduce(5))
    assert tw._ef_residual == {} == jw._ef_residual
    assert tw.last_policy == tprotocol.DEFAULT_POLICY and tw.last_policy_round == 5


@pytest.mark.parametrize("case", ["normal", "zeros", "tiny", "nonfinite", "empty"])
def test_wire_int8_quantizer_matches_jax(case):
    rng = np.random.default_rng(6)
    x = {
        "normal": rng.standard_normal(1000).astype(np.float32) * 3,
        "zeros": np.zeros(17, np.float32),
        "tiny": rng.standard_normal(100).astype(np.float32) * 1e-30,
        "nonfinite": np.array([1.0, np.nan, -np.inf, 2.5, np.inf], np.float32),
        "empty": np.zeros(0, np.float32),
    }[case]
    js, jq, jarr = jwire.quantize_int8(x)
    ts, tq, tarr = twire.quantize_int8(torch.from_numpy(x.copy()))
    assert ts == js
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(tarr.numpy(), jarr)
    np.testing.assert_array_equal(
        twire.int8_roundtrip(torch.from_numpy(x.copy())).numpy(), jwire.int8_roundtrip(x))


# -- the four reductions ------------------------------------------------------------


def test_tensor_reduce_matches_native():
    rng = np.random.default_rng(8)
    for n in (17, 20_000):  # numpy's path and the C++ loop's (when built)
        dst = rng.standard_normal(n).astype(np.float32)
        src = rng.standard_normal(n).astype(np.float32)
        counts = rng.integers(0, 5, n).astype(np.int32)
        t = torch.from_numpy(dst.copy())
        tensor_reduce.accumulate(t, torch.from_numpy(src))
        j = dst.copy()
        jnative.accumulate(j, src)
        np.testing.assert_array_equal(t.numpy(), j)
        np.testing.assert_array_equal(
            tensor_reduce.average(torch.from_numpy(dst), torch.from_numpy(counts)).numpy(),
            jnative.average(dst, counts))
        for alpha in (0.5, 0.3, 1.0):
            w = rng.standard_normal(n).astype(np.float32)
            tw = torch.from_numpy(w.copy())
            tensor_reduce.elastic_update(tw, torch.from_numpy(dst),
                                         torch.from_numpy(counts), alpha)
            jw = w.copy()
            jnative.elastic_update(jw, dst, counts, alpha)
            np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-6, atol=0)
            # the C++ loop's f32 arithmetic, written out: bit for bit
            a = np.float32(alpha)
            keep = np.float32(1.0) - a
            avg = dst / np.maximum(counts, 1).astype(np.float32)
            loop = np.where(counts > 0, keep * w + a * avg, w).astype(np.float32)
            np.testing.assert_array_equal(tw.numpy(), loop)
            assert np.array_equal(tw.numpy()[counts == 0], w[counts == 0])
    with pytest.raises(ValueError, match="shape mismatch"):
        tensor_reduce.accumulate(torch.zeros(3), torch.zeros(4))
    chunk_counts = np.array([4, 4, 3, 0, 3, 3], np.int32)
    lengths = np.array([5, 5, 5, 5, 5, 2], np.int64)
    for n_out in (27, 24, 30, 3):  # exact, cut inside a chunk, zero pad, short
        np.testing.assert_array_equal(
            tensor_reduce.expand_counts(chunk_counts, lengths, n_out).numpy(),
            jnative.expand_counts(chunk_counts, lengths, n_out))
    with pytest.raises(ValueError, match="align"):
        tensor_reduce.expand_counts(chunk_counts, lengths[:2], 4)


def test_protocol_copies_behave_as_jax():
    data = np.array([3.0, -1.0, 2.0, 0.0], np.float32)
    count = np.array([3, 0, 2, 0], np.int32)
    out = tprotocol.AllReduceOutput(data, count, 4)
    assert out.data.dtype == torch.float32 and out.count.dtype == torch.int32
    np.testing.assert_array_equal(
        out.average().numpy(), jprotocol.AllReduceOutput(data, count, 4).average())
    on_cpu = torch.arange(4, dtype=torch.float32)
    assert tprotocol.AllReduceInput(on_cpu).data is on_cpu  # a tensor keeps its place
    ro = np.ones(3, np.float32)
    ro.flags.writeable = False
    assert tprotocol.ScatterBlock(ro, 0, 1, 0, 0).value.tolist() == [1.0, 1.0, 1.0]
    for kw in (dict(th_reduce=0.75, wire="int8"), dict(), dict(th_reduce=0.3)):
        tp, jp = tprotocol.RoundPolicy(**kw), jprotocol.RoundPolicy(**kw)
        assert (tp.is_default, tp.describe(), tp.reduce_count(7)) == (
            jp.is_default, jp.describe(), jp.reduce_count(7))
    for bad in (dict(th_reduce=1.5), dict(wire="bf16")):
        with pytest.raises(ValueError):
            jprotocol.RoundPolicy(**bad)
        with pytest.raises(ValueError):
            tprotocol.RoundPolicy(**bad)
    assert tprotocol.PrepareAllreduce(1, [0, 1], 0, 0).peer_ids == (0, 1)
    assert tprotocol.StartAllreduce(3) == tprotocol.StartAllreduce(3)


# -- the binders ----------------------------------------------------------------------


def _binder_run(pkg, system_cls, make_binder, extra):
    binders = [make_binder(i) for i in range(NODES)]
    system = system_cls(
        NODES, [b.data_source for b in binders], [b.data_sink for b in binders],
        _config(pkg, rounds=5), **extra)
    system.start()
    system.run_until_quiescent()
    return binders


def test_binders_match_jax():
    rng = np.random.default_rng(9)
    w0 = [rng.standard_normal(SIZE).astype(np.float32) for _ in range(NODES)]
    grads = rng.standard_normal((5, NODES, SIZE)).astype(np.float32)

    def elastic(pkg_is_jax):
        def make(i):
            state = {"w": w0[i].copy() if pkg_is_jax else torch.from_numpy(w0[i].copy())}
            cls = JElastic if pkg_is_jax else ElasticAverageBinder
            b = cls(lambda: state["w"], lambda w: state.update(w=w), elastic_rate=0.5)
            b.state = state
            return b
        return make

    def grad_sync(pkg_is_jax):
        def make(i):
            seen = []
            cls = JGradSync if pkg_is_jax else GradSyncBinder
            g = (lambda r: grads[r, i]) if pkg_is_jax else (
                lambda r: torch.from_numpy(grads[r, i]))
            b = cls(g, lambda avg, counts: seen.append((_np(avg), _np(counts))))
            b.seen = seen
            return b
        return make

    for make in (elastic, grad_sync):
        jb = _binder_run(jconfig, JSystem, make(True), {})
        tb = _binder_run(tconfig, LocalAllreduceSystem, make(False),
                         {"device": "cpu"})
        for j, t in zip(jb, tb):
            assert t.rounds_applied == j.rounds_applied == 5
            if make is elastic:
                assert isinstance(t.state["w"], torch.Tensor)
                np.testing.assert_allclose(t.state["w"].numpy(), j.state["w"],
                                           rtol=1e-6, atol=1e-7)
            else:
                for (ta, tc), (ja, jc) in zip(t.seen, j.seen):
                    np.testing.assert_array_equal(ta, ja)  # sum / 4, exact
                    np.testing.assert_array_equal(tc, jc)
    assert GradSyncBinder(lambda r: torch.zeros(12), lambda a, c: None).data_size == 12
    with pytest.raises(ValueError, match="elastic_rate"):
        ElasticAverageBinder(lambda: torch.zeros(2), lambda w: None, elastic_rate=0)


# -- configs, pod, obs ------------------------------------------------------------------


CONFIG_JSONS = [
    {},
    {"threshold": {"th_reduce": 0.75}, "metadata": {"data_size": 4096,
                                                    "max_chunk_size": 512}},
    {"master": {"node_num": 6, "dimensions": 1, "line_shards": 2,
                "retry": {"max_retries": 3}},
     "worker": {"round_window": 2, "zero_copy_scatter": True},
     "line_master": {"max_rounds": 7}, "node": {"dimensions": 2},
     "chaos": {"seed": 3, "spec": "drop:p=0.1"}, "adapt": {"enabled": True},
     "data_plane": {"streams": 3, "intra_chunk_min_bytes": 65536},
     "gossip": {"enabled": True}},
    # every one of these is refused by its section's validation
    {"threshold": {"th_reduce": 0.0}},
    {"metadata": {"data_size": 0}},
    {"master": {"line_shards": 2, "dimensions": 2}},
    {"master": {"grid_rows": 2}},
    {"master": {"node_num": 9, "grid_rows": 2, "grid_cols": 4}},
    {"master": {"retry": {"max_retries": -1}}},
    {"data_plane": {"streams": 17}},
    {"data_plane": {"intra_chunk_min_bytes": 1024}},
    {"gossip": {"probe_timeout_s": 0.6}},
    {"adapt": {"lag_restore": 12}},
    {"adapt": {"bw_degrade_ratio": 0.6}},
    {"no_such_section": {}},
]


@pytest.mark.parametrize("raw", CONFIG_JSONS, ids=range(len(CONFIG_JSONS)))
def test_config_json_round_trip_and_errors_match_jax(raw):
    text = json.dumps(raw)
    try:
        theirs = jconfig.AllreduceConfig.from_json(text)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            tconfig.AllreduceConfig.from_json(text)
        assert str(ours.value) == str(e)
        return
    ours = tconfig.AllreduceConfig.from_json(text)
    assert ours.to_json() == theirs.to_json()
    assert tconfig.AllreduceConfig.from_json(ours.to_json()) == ours
    assert ours.chaos.enabled == theirs.chaos.enabled
    assert ours.master.retry.backoff_s(2, 0.5) == theirs.master.retry.backoff_s(2, 0.5)
    assert ours.gossip.suspicion_window_s == theirs.gossip.suspicion_window_s


def test_chaos_config_arms_the_local_system():
    cfg = tconfig.AllreduceConfig(chaos=tconfig.ChaosConfig(seed=1, spec="drop:p=0.1"))
    inj = LocalAllreduceSystem(1, [None], [None], cfg, device="cpu").router.chaos
    assert (inj.seed, inj.spec, inj.role) == (1, "drop:p=0.1", -1)
    plain = LocalAllreduceSystem(1, [None], [None], tconfig.AllreduceConfig(), device="cpu")
    assert plain.router.chaos is None


def test_pod_functions_match_jax(monkeypatch):
    for nodes, shards in [([], 2), ([3, 1, 2], 1), (list(range(10)), 3),
                          ([0, 2, 5, 7, 9], 4), (list(range(5)), 9)]:
        assert tpod.shard_assignment(nodes, shards) == jpod.shard_assignment(nodes, shards)
        for rows, cols in [(2, 5), (3, 4)]:
            assert tpod.coordinate_shard_assignment(nodes, rows, cols, shards) == (
                jpod.coordinate_shard_assignment(nodes, rows, cols, shards))
    for spec in ("2x8", "1X1", "3x", "0x4", "ax2"):
        try:
            expected = jpod.parse_grid(spec)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(",")[0]):
                tpod.parse_grid(spec)
        else:
            assert tpod.parse_grid(spec) == expected
    assert tpod.grid_coords(7, 2, 5) == jpod.grid_coords(7, 2, 5) == (1, 2)
    assert tpod.grid_node_id(1, 2, 5) == jpod.grid_node_id(1, 2, 5) == 7
    with pytest.raises(ValueError):
        tpod.grid_coords(10, 2, 5)
    for var in tpod.PROCESS_INDEX_ENV:
        monkeypatch.delenv(var, raising=False)
    assert tpod.PROCESS_INDEX_ENV == jpod.PROCESS_INDEX_ENV
    monkeypatch.setenv("SLURM_PROCID", "5")
    assert tpod.resolve_process_index() == jpod.resolve_process_index() == 5
    assert tpod.resolve_process_index(2) == 2
    monkeypatch.setenv("AKKA_PROCESS_INDEX", "x")
    with pytest.raises(ValueError, match="not an integer"):
        tpod.resolve_process_index()
    monkeypatch.delenv("AKKA_PROCESS_INDEX")
    monkeypatch.delenv("SLURM_PROCID")
    with pytest.raises(ValueError, match="cannot resolve a process index"):
        tpod.resolve_process_index()


def test_obs_copies_match_jax():
    bounds = (0.1, 1.0, 10.0)
    th = tmetrics.Registry().histogram("h", bounds)
    jh = jmetrics.Registry().histogram("h", bounds)
    for v in (0.05, 0.1, 0.5, 3.0, 50.0):
        th.observe(v)
        jh.observe(v)
    assert th.as_dict() == jh.as_dict()
    reg = tmetrics.Registry()
    reg.counter("a.b").inc(3)
    reg.series("s", maxlen=1).append(1)
    reg.series("s").append(2)
    snap = reg.snapshot()
    assert (snap["a.b"], snap["s"], reg.series("s").dropped) == (3, [1], 1)
    with pytest.raises(TypeError):
        reg.gauge("a.b")
    rec = {"name": "worker.flush", "ts": 1.5, "dur": 0.25, "trace_id": 7,
           "span_id": 8, "parent_id": 1, "attrs": {"round": 2}}
    assert ttrace.chrome_events([rec], pid=4) == jtrace.chrome_events([rec], pid=4)
    with ttrace.span("worker.round_start", round=1) as s:
        assert ttrace.current() == s.context
    assert ttrace.current() is None
    clock = {"t": 0.0}
    stalls = []
    for mod in (twatchdog, jwatchdog):
        dog = mod.RoundWatchdog(1.0, clock=lambda: clock["t"], dump=False)
        clock["t"] = 0.0
        dog.round_started(0, 3)
        dog.round_started(0, 4)
        dog.round_completed(0, 3)
        clock["t"] = 2.0
        stalls.append((dog.check(), dog.check()))
    assert stalls[0] == stalls[1] == (([(0, 4, 2.0)]), [])
    assert math.isclose(twatchdog.RoundWatchdog(2.0).poll_interval_s, 0.5)
