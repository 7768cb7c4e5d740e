"""The port's wire codec, transport receive path and control-plane state
machines against the JAX package's, on seeded inputs.

- every message type and wire mode (f32, f16, int8; trace trailer) encodes
  to the same bytes in both packages, payloads as CPU tensors in the port
  and numpy in the JAX package, and each package decodes the other's frames;
- the native codec and the python codec give the same bytes;
- the checksum rejects corruption and garbage is refused without a crash;
- the f16 saturation and int8 counters count;
- a decoded payload tensor keeps its pooled receive buffer out of the pool,
  and a frame whose encode is deferred to a sender thread holds the sums of
  the round it was sent in while the next round's adds go on;
- ``PhiAccrualFailureDetector``, ``StripeScheduler`` and ``GossipState``
  give the JAX package's numbers and messages for the same inputs.
"""

from __future__ import annotations

import asyncio
import struct

import numpy as np
import pytest
import torch

from akka_allreduce_tpu.control import cluster as j_cl
from akka_allreduce_tpu.control import failure as j_failure
from akka_allreduce_tpu.control import gossip as j_gp
from akka_allreduce_tpu.control import statetransfer as j_st
from akka_allreduce_tpu.control import stripes as j_stripes
from akka_allreduce_tpu.control import wire as j_wire
from akka_allreduce_tpu import config as j_config
from akka_allreduce_tpu import protocol as j_proto
from akka_allreduce_tpu.obs.trace import TraceContext as JTrace

from akka_allreduce_tpu_torch import config as t_config
from akka_allreduce_tpu_torch import native as t_native
from akka_allreduce_tpu_torch import protocol as t_proto
from akka_allreduce_tpu_torch.buffers import ScatteredDataBuffer
from akka_allreduce_tpu_torch.control import cluster as t_cl
from akka_allreduce_tpu_torch.control import failure as t_failure
from akka_allreduce_tpu_torch.control import gossip as t_gp
from akka_allreduce_tpu_torch.control import statetransfer as t_st
from akka_allreduce_tpu_torch.control import stripes as t_stripes
from akka_allreduce_tpu_torch.control import wire as t_wire
from akka_allreduce_tpu_torch.control.envelope import Envelope
from akka_allreduce_tpu_torch.control.remote import RemoteTransport
from akka_allreduce_tpu_torch.obs.trace import TraceContext as TTrace

DEADLINE_S = 20.0

_RNG = np.random.default_rng(14)
_SMALL = _RNG.standard_normal(7).astype(np.float32)
# above the native codec's 16 KB bar, so both codec paths are exercised
_LARGE = _RNG.standard_normal(6000).astype(np.float32)
_CHUNK_ARR = np.arange(11, dtype=np.float32) * 0.5
_CHUNK_BYTES = j_st.npy_bytes(_CHUNK_ARR)
_CHUNK_SHA = j_st.leaf_sha(_CHUNK_ARR)
_MANIFEST = '{"step": 5, "custom": false, "leaves": {"[\'a\']": "%s"}}' % _CHUNK_SHA
_STANDBYS = (("10.0.0.3", 9001), ("10.0.0.4", 9002))
_DIGEST_STATE = '{"book": [[0, "10.0.0.1", 7070]], "round": {"next": 12}}'


def _samples(cl, gp, st, proto, payload):
    """One instance of every wire message type, every field non-default, in
    one package's classes (``payload`` is numpy or a tensor)."""
    policy = proto.RoundPolicy(th_reduce=0.75, wire="int8")
    digest = ((1, 0x5000012345, gp.ALIVE), (-1, 7, gp.SUSPECT), (9, 0x7FFF_FFFF_FFFF, gp.DEAD))
    return {
        "StartAllreduce": proto.StartAllreduce(41, 6, policy),
        "ScatterBlock": proto.ScatterBlock(payload, 2, 1, 3, 17),
        "ReduceBlock": proto.ReduceBlock(payload * 2.0, 1, 0, 2, 18, 5),
        "CompleteAllreduce": proto.CompleteAllreduce(4, 19),
        "PrepareAllreduce": proto.PrepareAllreduce(7, (0, 1, 5), 5, 20, 2, 6, policy),
        "ConfirmPreparation": proto.ConfirmPreparation(7, 3),
        "JoinCluster": cl.JoinCluster("10.0.0.9", 7171, 2, 12345),
        "Welcome": cl.Welcome(3, '{"nodes": 4}', 6, _STANDBYS),
        "Heartbeat": cl.Heartbeat(2, 99, "10.0.0.9", 7171),
        "LeaveCluster": cl.LeaveCluster(6),
        "AddressBook": cl.AddressBook(
            ((0, "10.0.0.1", 7070), (1, "10.0.0.2", 7071)), 6, _STANDBYS
        ),
        "Shutdown": cl.Shutdown("max-rounds", 6),
        "Rejoin": cl.Rejoin("unknown-node", 6),
        "CheckpointAdvert": st.CheckpointAdvert(1, 2, 40, _MANIFEST),
        "ManifestRequest": st.ManifestRequest(3),
        "ManifestReply": st.ManifestReply(40, _MANIFEST, (0, 1, 4)),
        "ChunkFetch": st.ChunkFetch(_CHUNK_SHA, 2),
        "ChunkData": st.ChunkData(_CHUNK_SHA, _CHUNK_BYTES, 1, 40, True),
        "ChunkMissing": st.ChunkMissing(_CHUNK_SHA, 4),
        "ReplicaManifest": st.ReplicaManifest(40, _MANIFEST, 1),
        "StandbyRegister": cl.StandbyRegister("10.0.0.3", 9001),
        "StateDigest": cl.StateDigest(6, 1234, "10.0.0.1", 7070, _DIGEST_STATE),
        "AdvertSolicit": st.AdvertSolicit("manifest-miss"),
        "Ping": gp.Ping(3, 0x5000012345, 41, "10.0.0.9", 7171, digest),
        "PingReq": gp.PingReq(2, 5, 42, digest),
        "Ack": gp.Ack(5, 0x5000054321, 43, digest),
    }


def _jax_samples(payload=_SMALL):
    return _samples(j_cl, j_gp, j_st, j_proto, payload)


def _port_samples(payload=_SMALL):
    return _samples(t_cl, t_gp, t_st, t_proto, torch.from_numpy(payload.copy()))


_NAMES = list(_jax_samples())
_PAYLOAD_NAMES = ("ScatterBlock", "ReduceBlock")
_TRACE = (0x1234_5678_9ABC_DEF0, 0x0FED_CBA9_8765_4321, True)


def _fields(msg) -> dict:
    """A message's fields as plain python / numpy, whichever package made it."""
    out = {}
    for name in vars(msg):
        v = getattr(msg, name)
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        if name == "payload":
            v = bytes(memoryview(np.ascontiguousarray(v)))
        elif isinstance(v, np.ndarray):
            v = v.astype(np.float32).tobytes()
        elif name in ("peer_ids", "holders", "standbys", "entries", "digest"):
            v = tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in v)
        elif hasattr(v, "th_reduce"):  # RoundPolicy
            v = (v.th_reduce, v.wire)
        out[name] = v
    return out


def test_every_jax_wire_tag_has_a_sample():
    names = {t.__name__ for t in j_wire._TAGS}
    assert names == set(_NAMES)
    assert {t.__name__: tag for t, tag in t_wire._TAGS.items()} == {
        t.__name__: tag for t, tag in j_wire._TAGS.items()
    }


@pytest.mark.parametrize("name", _NAMES)
def test_encode_is_byte_equal_to_jax(name):
    modes = ("f32", "f16", "int8") if name in _PAYLOAD_NAMES else ("f32",)
    for payload in (_SMALL, _LARGE):
        jm, tm = _jax_samples(payload)[name], _port_samples(payload)[name]
        for mode in modes:
            assert t_wire.encode(tm, wire=mode) == j_wire.encode(jm, wire=mode)
            for trace in (None, _TRACE):
                assert t_wire.encode_frame(
                    "worker:12", tm, wire=mode, trace=trace
                ) == j_wire.encode_frame("worker:12", jm, wire=mode, trace=trace)
        assert t_wire.encode(tm, f16=True) == j_wire.encode(jm, f16=True)


@pytest.mark.parametrize("name", _NAMES)
def test_each_package_decodes_the_others_frames(name):
    modes = ("f32", "f16", "int8") if name in _PAYLOAD_NAMES else ("f32",)
    jm, tm = _jax_samples()[name], _port_samples()[name]
    for mode in modes:
        jframe = j_wire.encode_frame("worker:3", jm, wire=mode, trace=_TRACE)
        tframe = t_wire.encode_frame("worker:3", tm, wire=mode, trace=_TRACE)
        dest_t, from_jax, trace_t = t_wire.decode_frame_body_ex(memoryview(jframe)[4:])
        dest_j, from_port, trace_j = j_wire.decode_frame_body_ex(memoryview(tframe)[4:])
        assert dest_t == dest_j == "worker:3"
        assert tuple(trace_t) == tuple(trace_j) == _TRACE
        assert type(from_jax).__name__ == type(from_port).__name__ == name
        assert _fields(from_jax) == _fields(from_port)
        if name in _PAYLOAD_NAMES:
            assert isinstance(from_jax.value, torch.Tensor)
            assert from_jax.value.dtype == torch.float32
        if mode == "f32":
            assert _fields(from_jax) == _fields(tm)


def test_trace_preamble_and_fragment_codecs_match_jax():
    assert t_wire.encode_trace(_TRACE) == j_wire.encode_trace(_TRACE)
    assert t_wire.encode_trace(TTrace(*_TRACE)) == j_wire.encode_trace(JTrace(*_TRACE))
    pre = j_wire.encode_stream_preamble(2, 4, "10.1.2.3", 7070)
    assert t_wire.encode_stream_preamble(2, 4, "10.1.2.3", 7070) == pre
    assert t_wire.parse_stream_preamble(memoryview(pre)) == j_wire.parse_stream_preamble(
        memoryview(pre)
    ) == (2, 4, "10.1.2.3", 7070, len(pre))
    assert t_wire.parse_stream_preamble(memoryview(pre)[:10]) is None
    with pytest.raises(ValueError):
        t_wire.parse_stream_preamble(memoryview(b"\xff\xff\xff\xffXXXX" + pre[8:]))
    hdr = t_wire.encode_frag_header(0x1_0000_0005, 4096, 1024)
    assert hdr == j_wire.encode_frag_header(0x1_0000_0005, 4096, 1024)
    assert t_wire.parse_frag_header(hdr) == (5, 4096, 1024)
    with pytest.raises(ValueError):
        t_wire.parse_frag_header(t_wire.encode_frag_header(1, 100, 100))
    msg = _port_samples(_LARGE)["ScatterBlock"]
    for mode in ("f32", "f16", "int8"):
        n = t_wire.payload_frame_nbytes("worker:1", msg, mode, True)
        frame = t_wire.encode_frame("worker:1", msg, wire=mode, trace=_TRACE)
        assert n == len(frame) == j_wire.payload_frame_nbytes(
            "worker:1", _jax_samples(_LARGE)["ScatterBlock"], mode, True
        )
    parts = t_wire.encode_frame_parts("worker:1", msg)[1:]
    body = b"".join(bytes(p) for p in parts)
    pieces = [t_wire.slice_parts(parts, a, a + 777) for a in range(0, len(body), 777)]
    assert b"".join(bytes(v) for piece in pieces for v in piece) == body


def test_native_and_python_codecs_give_the_same_bytes(monkeypatch):
    assert t_native.available()
    payload = torch.from_numpy(_LARGE.copy())
    msgs = [
        t_proto.ScatterBlock(payload, 1, 2, 3, 4),
        t_proto.ReduceBlock(payload, 1, 2, 3, 4, 7),
        t_st.ChunkData("ab" * 32, bytes(np.arange(70000, dtype=np.uint8)), 1, 2, True),
    ]
    native_frames = [t_wire.encode(m, wire=mode) for m in msgs for mode in ("f32", "f16")]
    native_decoded = [_fields(t_wire.decode(f)) for f in native_frames]
    native_sum = t_native.wire_checksum(_LARGE.tobytes())
    monkeypatch.setattr(t_native, "_load", lambda **kw: None)
    python_frames = [t_wire.encode(m, wire=mode) for m in msgs for mode in ("f32", "f16")]
    assert python_frames == native_frames
    assert [_fields(t_wire.decode(f)) for f in python_frames] == native_decoded
    assert t_native.wire_checksum(_LARGE.tobytes()) == native_sum
    # odd lengths: the zero-padded tail word
    for n in (1, 3, 5, 16387):
        raw = bytes(range(256)) * (n // 256 + 1)
        assert t_native.wire_checksum(raw[:n]) == j_wire.native.wire_checksum(raw[:n])


@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
def test_checksum_rejects_corruption_and_truncation(mode):
    for payload in (_SMALL, _LARGE):
        for name in _PAYLOAD_NAMES:
            frame = bytearray(t_wire.encode(_port_samples(payload)[name], wire=mode))
            frame[-3] ^= 0x10  # one flipped payload bit
            with pytest.raises(ValueError):
                t_wire.decode(bytes(frame))
            with pytest.raises(ValueError):
                t_wire.decode(t_wire.encode(_port_samples(payload)[name], wire=mode)[:-5])
    data = bytearray(t_wire.encode(_port_samples()["ChunkData"]))
    data[-1] ^= 0x01
    with pytest.raises(ValueError):
        t_wire.decode(bytes(data))


def test_garbage_is_refused_without_a_crash():
    rng = np.random.default_rng(3)
    refused = 0
    for i in range(300):
        raw = rng.integers(0, 256, size=int(rng.integers(1, 80)), dtype=np.uint8)
        raw[0] = 1 + i % 26  # a real tag, garbage body
        try:
            t_wire.decode(raw.tobytes())
        except (ValueError, struct.error, UnicodeDecodeError, IndexError, TypeError):
            refused += 1
    assert refused > 200
    with pytest.raises(ValueError):
        t_wire.decode(b"\xff")
    with pytest.raises(TypeError):
        t_wire.encode(object())

    async def run():
        # a garbage frame on a live connection is dropped; the next good
        # frame on a fresh connection is still delivered
        rx = RemoteTransport()
        got: list = []
        rx.register("sink", lambda m: got.append(m) or [])
        ep = await rx.start()
        try:
            reader, writer = await asyncio.open_connection(ep.host, ep.port)
            body = b"\x00\x04sink" + b"\x02" + b"\x07" * 40
            writer.write(struct.pack("<I", len(body)) + body)
            await writer.drain()
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 5.0
            while rx.dropped == 0 and loop.time() < deadline:
                await asyncio.sleep(0.01)
            assert rx.dropped >= 1 and not got
            writer.close()
            tx = RemoteTransport()
            await tx.start()
            tx.set_route("sink", ep)
            await tx.send(Envelope("sink", t_proto.StartAllreduce(3)))
            while not got and loop.time() < deadline:
                await asyncio.sleep(0.01)
            await tx.stop()
            assert got == [t_proto.StartAllreduce(3)]
        finally:
            await rx.stop()

    asyncio.run(asyncio.wait_for(run(), DEADLINE_S))


def test_f16_saturation_and_nonfinite_bytes_match_jax():
    big = np.array([1e6, -1e6, 3.0, np.inf, -np.inf, np.nan, 65504.0, 65520.0], np.float32)
    before = t_wire.f16_clip_count()
    tm = t_proto.ScatterBlock(torch.from_numpy(big.copy()), 0, 1, 0, 0)
    frame = t_wire.encode(tm, f16=True)
    assert frame == j_wire.encode(j_proto.ScatterBlock(big, 0, 1, 0, 0), f16=True)
    # 1e6, -1e6, inf, -inf and 65520 saturate; NaN is not counted
    assert t_wire.f16_clip_count() == before + 5
    back = t_wire.decode(frame).value.numpy()
    np.testing.assert_array_equal(back[[0, 1, 3, 4]], [65504.0, -65504.0, 65504.0, -65504.0])
    assert np.isnan(back[5])
    t_wire.encode(t_proto.ScatterBlock(torch.ones(4), 0, 1, 0, 0), f16=True)
    assert t_wire.f16_clip_count() == before + 5


def test_int8_counters_and_quantizer_match_jax():
    from akka_allreduce_tpu_torch.obs import metrics as t_metrics

    resid0 = t_wire.int8_residual_l1()
    payloads0 = t_metrics.REGISTRY.snapshot().get("wire.int8_payloads", 0)
    sat0 = t_metrics.REGISTRY.snapshot().get("wire.int8_saturated", 0)
    x = _LARGE.copy()
    x[5], x[9] = np.inf, np.nan
    for value in (_LARGE, x, np.zeros(9, np.float32)):
        tm = t_proto.ReduceBlock(torch.from_numpy(value.copy()), 0, 1, 0, 0, 3)
        assert t_wire.encode(tm, wire="int8") == j_wire.encode(
            j_proto.ReduceBlock(value, 0, 1, 0, 0, 3), wire="int8"
        )
        scale, q, arr = t_wire.quantize_int8(torch.from_numpy(value.copy()))
        j_scale, j_q, j_arr = j_wire.quantize_int8(value)
        assert scale == j_scale
        np.testing.assert_array_equal(q.numpy(), j_q)
        np.testing.assert_array_equal(arr.numpy(), j_arr)
        np.testing.assert_array_equal(
            t_wire.int8_roundtrip(torch.from_numpy(value.copy())).numpy(),
            j_wire.int8_roundtrip(value),
        )
    snap = t_metrics.REGISTRY.snapshot()
    assert t_wire.int8_residual_l1() > resid0
    assert snap["wire.int8_payloads"] == payloads0 + 3
    # the encode and the quantize call above each saw the two non-finite
    # elements once
    assert snap["wire.int8_saturated"] >= sat0 + 4


def test_recv_buffer_aliasing_and_safe_pool_reuse_with_tensor_payloads():
    """A delivered payload tensor aliases the pooled receive buffer (no
    private copy); while a handler holds it, a second frame cannot recycle
    that buffer under it, and once released the buffers return to the
    pool."""

    async def run():
        rx, tx = RemoteTransport(device="cpu"), RemoteTransport(device="cpu")
        got: list = []
        rx.register("sink", lambda m: got.append(m) or [])
        ep = await rx.start()
        await tx.start()
        tx.set_route("sink", ep)
        loop = asyncio.get_running_loop()

        async def until(pred):
            deadline = loop.time() + 10.0
            while not pred():
                assert loop.time() < deadline, "condition not reached"
                await asyncio.sleep(0.01)

        try:
            v1 = torch.arange(65536, dtype=torch.float32)
            v2 = v1 * 2.0
            await tx.send(Envelope("sink", t_proto.ScatterBlock(v1, 0, 1, 0, 1)))
            await until(lambda: len(got) == 1)
            held = got[0].value
            assert isinstance(held, torch.Tensor)
            # the tensor's memory lies inside a bytearray the transport made
            owners = [
                b for b in list(rx._recv_pool) + [None]
                if b is not None
            ]
            assert not owners or all(
                not (
                    np.frombuffer(b, np.uint8).ctypes.data
                    <= held.data_ptr()
                    < np.frombuffer(b, np.uint8).ctypes.data + len(b)
                )
                for b in owners
            ), "buffer with a live payload tensor was pooled"
            await tx.send(Envelope("sink", t_proto.ScatterBlock(v2, 0, 1, 0, 2)))
            await until(lambda: len(got) == 2)
            assert torch.equal(got[0].value, v1) and torch.equal(got[1].value, v2)
            for b in rx._recv_pool:
                base = np.frombuffer(b, np.uint8).ctypes.data
                assert not base <= held.data_ptr() < base + len(b)
            # a non-retaining handler releases its buffer after each message
            rounds: list[int] = []
            rx.register("counter", lambda m: rounds.append(m.round_num) or [])
            tx.set_route("counter", ep)
            for r in range(3, 6):
                await tx.send(Envelope("counter", t_proto.ScatterBlock(v1, 0, 1, 0, r)))
            await until(lambda: rounds == [3, 4, 5])
            assert rx._recv_pool, "released buffers should return to the pool"
            # torch.frombuffer would drop the export at once and let the pool
            # recycle a live payload: the codec's tensors keep it
            buf = bytearray(16)
            t = t_proto.ScatterBlock(
                np.frombuffer(memoryview(buf), dtype=np.float32), 0, 1, 0, 0
            ).value
            with pytest.raises(BufferError):
                buf.pop()
            del t
        finally:
            await tx.stop()
            await rx.stop()

    asyncio.run(asyncio.wait_for(run(), DEADLINE_S))


def test_deferred_frame_holds_the_round_it_was_sent_in():
    """With payload streams the encode runs later on a sender thread; the
    ReduceBlock of round r must carry the sum at reduce time although round
    r + 1's adds, and a late arrival for round r, are applied before the
    thread runs."""
    md = t_config.MetaDataConfig(data_size=8192, max_chunk_size=8192)
    th = t_config.ThresholdConfig(1.0, 0.5, 1.0)
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.standard_normal(8192).astype(np.float32)) for _ in range(4)]

    async def run():
        rx, tx = RemoteTransport(device="cpu"), RemoteTransport(device="cpu")
        tx.configure_data_plane(t_config.DataPlaneConfig(streams=3))
        got: list = []
        rx.register("sink", lambda m: got.append(m) or [])
        ep = await rx.start()
        await tx.start()
        tx.set_route("sink", ep)
        try:
            r0 = ScatteredDataBuffer(md, th, 4, block_size=8192, device="cpu")
            r1 = ScatteredDataBuffer(md, th, 4, block_size=8192, device="cpu")
            r0.store(parts[0], 0, 0)
            assert r0.store(parts[1], 1, 0)
            value, count = r0.reduce(0)
            expected = (parts[0] + parts[1]).numpy().copy()
            await tx.send(Envelope("sink", t_proto.ReduceBlock(value, 0, 1, 0, 0, count)))
            # the next round's adds and a late arrival, before the encode
            for src in range(4):
                r1.store(parts[src] * 3.0, src, 0)
            r0.store(parts[2], 2, 0)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 10.0
            while not got:
                assert loop.time() < deadline
                await asyncio.sleep(0.01)
            np.testing.assert_array_equal(got[0].value.numpy(), expected)
            assert got[0].count == 2
        finally:
            await tx.stop()
            await rx.stop()

    asyncio.run(asyncio.wait_for(run(), DEADLINE_S))


def test_to_host_leaves_cpu_messages_alone():
    msg = t_proto.ScatterBlock(torch.ones(5), 0, 1, 0, 0)
    assert t_wire.to_host(msg) is msg
    ctl = t_proto.StartAllreduce(2)
    assert t_wire.to_host(ctl) is ctl
    # a CPU tensor's f32 frame views its memory: no copy
    arr = t_wire.host_f32(msg.value)
    assert arr.ctypes.data == msg.value.data_ptr()


# -- state machines: the same numbers and messages as the JAX package --------


def test_phi_accrual_detector_matches_jax():
    rng = np.random.default_rng(11)
    gaps = np.abs(rng.normal(1.0, 0.2, size=(60, 2))) + 0.05
    dets = [
        mod.PhiAccrualFailureDetector(threshold=8.0, first_heartbeat_estimate=1.0)
        for mod in (j_failure, t_failure)
    ]
    monitors = [
        mod.HeartbeatMonitor(
            mod.PhiAccrualFailureDetector(threshold=3.0, first_heartbeat_estimate=1.0)
        )
        for mod in (j_failure, t_failure)
    ]
    clock = np.zeros(2)
    for row in gaps:
        for node in (0, 1):
            clock[node] += float(row[node])
            for det in dets:
                det.heartbeat(node, float(clock[node]))
            if node == 0 or clock[node] < 30.0:  # node 1 falls silent
                for mon in monitors:
                    mon.heartbeat(node, float(clock[node]))
        probe = float(clock.max()) + 0.7
        for node in (0, 1):
            assert dets[0].phi(node, probe) == dets[1].phi(node, probe)
            assert dets[0].is_available(node, probe) == dets[1].is_available(node, probe)
        events = [
            [(e.node_id, type(e).__name__, str(getattr(e, "state", ""))) for e in mon.poll(probe)]
            for mon in monitors
        ]
        assert events[0] == events[1]
        assert monitors[0].members_up == monitors[1].members_up
    assert monitors[1].members_up == [0]
    leases = [
        mod.LeaderLease(threshold=3.0, first_heartbeat_estimate=0.5)
        for mod in (j_failure, t_failure)
    ]
    for k in range(10):
        for lease in leases:
            lease.renew(0.5 * k)
    for t in (5.0, 6.0, 9.0):
        assert leases[0].phi(t) == leases[1].phi(t)
        assert leases[0].expired(t) == leases[1].expired(t)


def test_stripe_scheduler_assignments_and_congestion_replay_match_jax():
    from akka_allreduce_tpu_torch import cluster_cli

    scheds = [mod.StripeScheduler(3) for mod in (j_stripes, t_stripes)]
    rng = np.random.default_rng(2)
    picks: list[list[int]] = [[], []]
    for w in range(30):
        now = w * scheds[0].window_s
        sizes = rng.integers(1 << 16, 1 << 20, size=10)
        for k, sched in enumerate(scheds):
            for n in sizes:
                picks[k].append(sched.pick(int(n), now))
            for i in range(3):
                sched.note_sent(i, int(sizes.sum()) // (4 if i == 1 and w < 15 else 1), now)
    assert picks[0] == picks[1]
    assert scheds[0].snapshot() == scheds[1].snapshot()
    import akka_allreduce_tpu.__main__ as jax_cli

    assert cluster_cli._bench_wire_congestion() == jax_cli._bench_wire_congestion()


def _gossip_run(gp, wire, cfg):
    """Five members probing each other on a logical clock, member 3 dead:
    every frame sent (as wire bytes) and every event, in order."""
    members = {i: gp.GossipState(i, 100 + i, cfg, seed=cfg.seed) for i in range(5)}
    for st in members.values():
        st.set_members(set(members))
    frames: list[bytes] = []
    events: list[tuple] = []
    inflight: list = []
    for step in range(120):
        now = step * 0.05
        for nid, st in members.items():
            if nid == 3:
                continue
            inflight.extend(st.tick(now))
        while inflight:
            env = inflight.pop(0)
            frames.append(wire.encode_frame(env.dest, env.msg))
            dest = int(env.dest.rpartition(":")[2])
            if dest == 3 or dest not in members:
                continue
            inflight.extend(members[dest].handle(env.msg, now))
        for nid, st in members.items():
            events.extend((nid, e.node_id, e.status, e.incarnation) for e in st.poll_events())
    return frames, events


def test_gossip_state_messages_and_events_match_jax():
    kw = dict(enabled=True, probe_interval_s=0.5, probe_timeout_s=0.15, indirect=2,
              suspicion_periods=2, seed=7)
    j_frames, j_events = _gossip_run(j_gp, j_wire, j_config.GossipConfig(**kw))
    t_frames, t_events = _gossip_run(t_gp, t_wire, t_config.GossipConfig(**kw))
    assert j_frames and j_events
    assert t_frames == j_frames
    assert t_events == j_events
    # the dead member was suspected, then confirmed, by someone
    assert any(e[1] == 3 and e[2] == t_gp.DEAD for e in t_events)
