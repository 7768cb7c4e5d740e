"""Binary wire codec for the control-plane protocol: the port's own copy of
the JAX package's ``control/wire.py``, byte for byte the same frames.

The reference configures Akka serializers for its ``Array[Float]``-carrying
actor messages (SURVEY.md §2 L0 "serializer config for Array[Float] messages").
This is the same layer, purpose-built: each message encodes to
``[u8 tag][fixed struct fields][u32 count][u32 checksum][raw little-endian
float payload]`` and a framed envelope is ``[u32 frame_len][u16 dest_len]
[dest utf8][encoded msg]``. No pickle — the format is versioned by tag,
language-neutral, and float payloads are zero-copy BOTH ways:
``encode_frame_parts`` returns scatter-gather segments whose payload segment
is a ``memoryview`` of the caller's array (the transport hands the segments
to ``sendmsg`` — no concatenation copy ever happens), and decode yields
``np.frombuffer`` views into the receive buffer. Payload frames carry an
additive byte checksum, computed/verified in the native wire hot loop
(``native/wire.cpp``) when built, with an exact struct/numpy fallback.

The port's payloads are tensors. A CPU tensor is framed through a numpy
view of its memory, with no copy; a tensor on the card is copied to the
host once, on the calling thread's current stream (the stream that wrote
it), and framed from that copy, so its frame is byte-identical to its CPU
copy's in every wire mode. Decode still yields numpy views into the receive
buffer; the payload messages take them as CPU tensors over the same memory
(``protocol.as_tensor``), which keeps the buffer exported, so a pooled
receive buffer is never recycled under a live payload.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import struct
import threading
from typing import Any

import numpy as np
import torch

_log = logging.getLogger(__name__)

from akka_allreduce_tpu_torch import native
from akka_allreduce_tpu_torch.control import cluster as cl
from akka_allreduce_tpu_torch.control import gossip as gp
from akka_allreduce_tpu_torch.control import statetransfer as st
from akka_allreduce_tpu_torch.obs import metrics as _obs_metrics
from akka_allreduce_tpu_torch.protocol import (
    DEFAULT_POLICY,
    CompleteAllreduce,
    ConfirmPreparation,
    PrepareAllreduce,
    ReduceBlock,
    RoundPolicy,
    ScatterBlock,
    StartAllreduce,
)

# one tag per message type; payload-carrying tags end the body with raw f32
# (tags 2/3) or raw checksummed bytes (tag 18 — peer chunk transfer)
_TAGS: dict[type, int] = {
    StartAllreduce: 1,
    ScatterBlock: 2,
    ReduceBlock: 3,
    CompleteAllreduce: 4,
    PrepareAllreduce: 5,
    ConfirmPreparation: 6,
    cl.JoinCluster: 7,
    cl.Welcome: 8,
    cl.Heartbeat: 9,
    cl.LeaveCluster: 10,
    cl.AddressBook: 11,
    cl.Shutdown: 12,
    cl.Rejoin: 13,
    # peer state transfer (control/statetransfer.py, RESILIENCE.md "Recovery")
    st.CheckpointAdvert: 14,
    st.ManifestRequest: 15,
    st.ManifestReply: 16,
    st.ChunkFetch: 17,
    st.ChunkData: 18,
    st.ChunkMissing: 19,
    st.ReplicaManifest: 20,
    # master high availability (RESILIENCE.md "Tier 4 — control-plane
    # failover"): standby registration, the leader's replicated state
    # digest (doubles as its lease heartbeat), and the replacement
    # master's checkpoint-advert solicitation
    cl.StandbyRegister: 21,
    cl.StateDigest: 22,
    st.AdvertSolicit: 23,
    # SWIM gossip membership (control/gossip.py, RESILIENCE.md "Tier 6"):
    # direct probe, indirect-probe request, and the (possibly relayed)
    # acknowledgement — each piggybacking a bounded membership digest
    gp.Ping: 24,
    gp.PingReq: 25,
    gp.Ack: 26,
}

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")


def _pack_str(text: str) -> bytes:
    raw = text.encode("utf-8")
    return _U16.pack(len(raw)) + raw


def _unpack_str(buf: memoryview, off: int) -> tuple[str, int]:
    (n,) = _U16.unpack_from(buf, off)
    off += 2
    return bytes(buf[off : off + n]).decode("utf-8"), off + n


def _pack_str32(text: str) -> bytes:
    """u32-length string — manifest JSON routinely exceeds the u16 bound
    (one entry per checkpoint leaf)."""
    raw = text.encode("utf-8")
    return _U32.pack(len(raw)) + raw


def _unpack_str32(buf: memoryview, off: int) -> tuple[str, int]:
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    return bytes(buf[off : off + n]).decode("utf-8"), off + n


_DIGEST_ENTRY = struct.Struct("<iqB")


def _pack_gossip_digest(digest) -> bytes:
    """``[u16 n]`` + per entry ``[i32 node_id][i64 incarnation][u8 status]``
    — the bounded membership digest on tags 24-26."""
    parts = [_U16.pack(len(digest))]
    for nid, inc, status in digest:
        parts.append(_DIGEST_ENTRY.pack(nid, inc, status))
    return b"".join(parts)


def _unpack_gossip_digest(
    buf: memoryview, off: int
) -> tuple[tuple[tuple[int, int, int], ...], int]:
    (n,) = _U16.unpack_from(buf, off)
    off += 2
    out = []
    for _ in range(n):
        out.append(_DIGEST_ENTRY.unpack_from(buf, off))
        off += _DIGEST_ENTRY.size
    return tuple(out), off


def _unpack_endpoints(
    buf: memoryview, off: int, n: int
) -> tuple[tuple[tuple[str, int], ...], int]:
    """``n`` consecutive ``[str host][u16 port]`` pairs (standby lists)."""
    out = []
    for _ in range(n):
        host, off = _unpack_str(buf, off)
        (port,) = _U16.unpack_from(buf, off)
        off += 2
        out.append((host, port))
    return tuple(out), off


def _chunk_payload_view(payload) -> memoryview:
    """Raw byte view of a ChunkData payload (bytes / bytearray / memoryview
    / u8 ndarray) — stays a view, so the transport's vectored send moves
    the chunk bytes zero-copy exactly like a float payload segment."""
    if isinstance(payload, np.ndarray):
        return memoryview(np.ascontiguousarray(payload)).cast("B")
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    return mv if mv.format == "B" and mv.contiguous else mv.cast("B")


# Top bit of the u32 element count flags a float16 payload (the wire-
# compression mode, MetaDataConfig.wire_dtype): the f32 format is unchanged
# byte for byte, and the flag costs nothing. Bit 30 flags an int8 payload
# (``[f32 scale][i8 x n]`` — the adaptive controller's deepest degrade
# mode, control/adapt.py); the two flags are mutually exclusive. Decode
# always hands the engine float32 — compression lives entirely on the wire.
_F16_FLAG = 0x8000_0000
_I8_FLAG = 0x4000_0000


_F16_MAX = np.float32(65504.0)  # float16's finite range

#: total payload elements saturated at ±65504 by f16 wire casts in this
#: process — saturation silently alters out-of-range values, so operators
#: need a signal; read it via ``f16_clip_count()``. Mirrored
#: into the obs registry (``wire.f16_clipped``) so clipping shows up in
#: metrics_snapshot JSONL, not only this module global + a one-shot warn.
_f16_clipped = 0
_f16_clip_warned = False
_F16_CLIPPED = _obs_metrics.counter("wire.f16_clipped")

#: encode runs on the event loop (control frames) AND on payload sender
#: threads (deferred stream encode), so the module-global accounting above
#: is cross-context shared state: every read-modify-write holds this lock
#: (the arlint THRD001 contract; the obs-registry counters beside them are
#: GIL-atomic ``.inc()`` and need none)
_telemetry_lock = threading.Lock()

#: int8 wire-mode error accounting, mirroring the f16 counter pair: the
#: accumulated L1 magnitude of quantization residuals this process put on
#: the wire (``wire.int8_residual_l1`` — what the send-side EF carries
#: forward, see ``int8_roundtrip``), payload count, and non-finite inputs
#: saturated to finite values before scaling
_int8_residual_l1 = 0.0
_INT8_RESIDUAL = _obs_metrics.counter("wire.int8_residual_l1")
_INT8_PAYLOADS = _obs_metrics.counter("wire.int8_payloads")
_INT8_SATURATED = _obs_metrics.counter("wire.int8_saturated")


def f16_clip_count() -> int:
    """Elements the f16 wire mode has saturated since process start."""
    return _f16_clipped


def int8_residual_l1() -> float:
    """Accumulated |residual| the int8 wire mode has injected since
    process start (the error the worker-side EF loop feeds back)."""
    return _int8_residual_l1


def _note_clipped(n: int) -> None:
    global _f16_clipped, _f16_clip_warned
    with _telemetry_lock:
        _f16_clipped += n
        first = not _f16_clip_warned
        _f16_clip_warned = True
    _F16_CLIPPED.inc(n)
    if first:
        _log.warning(
            "f16 wire mode saturated %d out-of-range payload element(s) at "
            "+-65504; values were altered on the wire (further saturation "
            "is counted, not logged — wire.f16_clip_count())",
            n,
        )


#: non-finite int8 inputs saturate here: far past any sane payload, yet
#: ``127 * (_I8_SAT_MAX / 127)`` stays comfortably inside float32, so a
#: saturated chunk dequantizes FINITE (saturating at f32 max would round
#: the corner value back to inf)
_I8_SAT_MAX = 1e30


def quantize_int8(value: torch.Tensor) -> tuple[float, torch.Tensor, torch.Tensor]:
    """``(scale, int8 tensor, sanitized f32 tensor)`` with a shared
    per-chunk scale (``max|x| / 127``, computed in float64 on the host; 1.0
    for an all-zero chunk) — ONE definition used by the encode path and by
    the worker's error-feedback loop, so the residual the worker carries
    forward is exactly the error the wire injected. Non-finite inputs are
    saturated first (counted, ``wire.int8_saturated``) and the sanitized
    tensor is what residuals must be computed against. The division is by
    the scale rounded to float32, rounded half to even; it runs on the
    tensor's device and reads ``max|x|`` back from it."""
    arr = value.detach().to(torch.float32).contiguous()
    m = float(arr.abs().max()) if arr.numel() else 0.0
    if not math.isfinite(m):
        bad = int((~torch.isfinite(arr)).sum())
        _INT8_SATURATED.inc(bad)
        arr = torch.nan_to_num(arr, nan=0.0, posinf=_I8_SAT_MAX, neginf=-_I8_SAT_MAX)
        m = float(arr.abs().max())
    scale = m / 127.0 if m > 0.0 else 1.0
    q = torch.round(arr / float(np.float32(scale))).to(torch.int8)
    return scale, q, arr


def int8_roundtrip(value: torch.Tensor) -> torch.Tensor:
    """What the receiver will see after an int8 wire round trip — the
    worker's EF loop computes ``residual = value - int8_roundtrip(value)``
    and adds it into the next round's chunk."""
    scale, q, _ = quantize_int8(value)
    return q.to(torch.float32) * float(np.float32(scale))


def host_f32(value) -> np.ndarray:
    """A payload as a C-contiguous little-endian float32 numpy array on the
    host: a CPU tensor's own memory where it can be (no copy), a tensor on
    another device copied once on the current stream, anything else through
    ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.device.type != "cpu":
            value = value.to("cpu")
        value = value.numpy()
    return np.ascontiguousarray(value, dtype="<f4")


def to_host(msg: Any) -> Any:
    """``msg`` with its payload on the host: a Scatter/ReduceBlock whose
    value lies on the card becomes the same message over a CPU copy, taken
    now on the current stream, so an encode that runs later on another
    thread frames the values this message held when it was sent. Every
    other message is returned as it is."""
    value = getattr(msg, "value", None)
    if (
        isinstance(msg, (ScatterBlock, ReduceBlock))
        and isinstance(value, torch.Tensor)
        and value.device.type != "cpu"
    ):
        return dataclasses.replace(msg, value=value.detach().to("cpu"))
    return msg


def _pack_floats(value: np.ndarray, mode: str = "f32") -> tuple[memoryview, int]:
    """(payload byte view, count word) — the view aliases the caller's array
    (or the one cast copy), so the send path never copies the payload; the
    transport's vectored write is the only consumer.

    ``mode`` selects the wire precision: ``"f16"`` casts to float16,
    SATURATING at ±65504 (a silent cast would turn out-of-range elements
    into inf and poison every downstream f32 accumulation — unlike bf16,
    float16 trades range for mantissa; saturation is counted and warned
    once, ``f16_clip_count``). ``"int8"`` quantizes with a shared
    per-chunk scale (``[f32 scale][i8 x n]``, quantize_int8) and accounts
    the injected residual (``wire.int8_residual_l1``) — senders that want
    the error back must run the worker's EF loop."""
    if mode == "f16":
        arr32 = host_f32(value)
        clipped = int(np.count_nonzero(np.abs(arr32) > _F16_MAX))
        if clipped:
            _note_clipped(clipped)
        arr = np.clip(arr32, -_F16_MAX, _F16_MAX).astype("<f2")
        return memoryview(arr).cast("B"), arr.size | _F16_FLAG
    if mode == "int8":
        global _int8_residual_l1
        scale, q, arr32 = quantize_int8(torch.from_numpy(host_f32(value)))
        resid = float(
            (arr32 - q.to(torch.float32) * float(np.float32(scale))).abs().sum()
        )
        with _telemetry_lock:
            _int8_residual_l1 += resid
        _INT8_RESIDUAL.inc(resid)
        _INT8_PAYLOADS.inc()
        payload = struct.pack("<f", scale) + q.numpy().tobytes()
        return memoryview(payload), q.numel() | _I8_FLAG
    arr = host_f32(value)
    return memoryview(arr).cast("B"), arr.size


def _decode_block(buf: memoryview):
    """Payload-frame body -> (value view, src, dest, chunk, round, count).

    One native call parses the header AND verifies the payload checksum
    (``native.unpack_block``); the returned array is a zero-copy
    ``np.frombuffer`` view into ``buf`` (f16 payloads decompress — the
    astype is the one necessary copy). int8 frames (count-word bit 30)
    predate the native parser's vocabulary, so they take an exact Python
    path here: header struct reads + the generic native checksum — int8
    is the DEGRADED wire mode, so the hot path stays the native call."""
    tag = buf[0]
    cw_off = 21 if tag == 2 else 25 if tag == 3 else None
    if cw_off is not None and len(buf) >= cw_off + 8:
        (count_word,) = _U32.unpack_from(buf, cw_off)
        if count_word & _I8_FLAG:
            return _decode_block_i8(buf, tag, cw_off, count_word)
    src, dest, chunk, rnd, count, n, is_f16, off = native.unpack_block(buf)
    if is_f16:
        value = np.frombuffer(buf, dtype="<f2", count=n, offset=off).astype(
            np.float32
        )
    else:
        value = np.frombuffer(buf, dtype="<f4", count=n, offset=off)
    return value, src, dest, chunk, rnd, count


def _decode_block_i8(buf: memoryview, tag: int, cw_off: int, count_word: int):
    """The int8 arm of the payload decode: ``[f32 scale][i8 x n]`` behind
    the ordinary ``[count_word][checksum]`` header, checksum over the whole
    scale+data payload. Same contracts as the native path: ValueError on
    truncation/corruption, trailing bytes tolerated (``<=`` bound)."""
    if tag == 2:
        src, dest, chunk, rnd = struct.unpack_from("<iiiq", buf, 1)
        count = 0
    else:
        src, dest, chunk, rnd, count = struct.unpack_from("<iiiqi", buf, 1)
    (ck,) = _U32.unpack_from(buf, cw_off + 4)
    off = cw_off + 8
    n = count_word & ~_I8_FLAG
    nbytes = 4 + n  # f32 scale + n int8 elements
    if off + nbytes > len(buf):
        raise ValueError("truncated payload")
    payload = buf[off : off + nbytes]
    if native.wire_checksum(payload) != ck:
        raise ValueError("payload checksum mismatch")
    (scale,) = struct.unpack_from("<f", buf, off)
    q = np.frombuffer(buf, dtype=np.int8, count=n, offset=off + 4)
    value = q.astype(np.float32) * np.float32(scale)
    return value, src, dest, chunk, rnd, count


def _wire_mode(f16: bool, wire: str | None) -> str:
    """Normalize the two wire-precision spellings: an explicit per-frame
    ``wire`` mode (the RoundPolicy path) wins over the transport-default
    ``f16`` bool."""
    if wire:
        return wire
    return "f16" if f16 else "f32"


def encode(msg: Any, *, f16: bool = False, wire: str | None = None) -> bytes:
    """Message -> ``[tag][body]`` bytes."""
    return b"".join(_encode_parts(msg, _wire_mode(f16, wire)))


def _encode_policy(policy: RoundPolicy) -> bytes:
    """``[f32 th_reduce][u8 wire_mode]`` — the RoundPolicy trailing field
    on tags 1/5. Appended AFTER every previously-last field, so an old
    decoder (which reads exactly the bytes it knows) ignores it — the same
    version-skew contract as the trace trailer, ratcheted per tag in
    tests/test_wire_roundtrip.py."""
    return struct.pack(
        "<fB", policy.th_reduce, RoundPolicy.WIRE_MODES.index(policy.wire)
    )


_POLICY_LEN = 5


def _decode_policy(buf: memoryview, off: int) -> RoundPolicy:
    """Inverse of ``_encode_policy`` — a frame too short to carry the
    field is an old encoder's: default policy. Unknown future wire-mode
    bytes degrade to "inherit" rather than refusing the frame."""
    if len(buf) < off + _POLICY_LEN:
        return DEFAULT_POLICY
    th, mode = struct.unpack_from("<fB", buf, off)
    wire_mode = (
        RoundPolicy.WIRE_MODES[mode]
        if mode < len(RoundPolicy.WIRE_MODES)
        else ""
    )
    if not th and not wire_mode:
        return DEFAULT_POLICY
    return RoundPolicy(float(th), wire_mode)


def _encode_parts(msg: Any, mode: str = "f32") -> list:
    """Message -> list of buffer segments (bytes / memoryviews).

    Payload-carrying messages keep the float array as a zero-copy view so the
    caller's single ``join`` is the only copy on the send path. ``mode`` is
    the wire precision for float payloads ("f32"/"f16"/"int8").
    """
    tag = _TAGS.get(type(msg))
    if tag is None:
        raise TypeError(f"no wire tag for {type(msg).__name__}")
    head = bytes([tag])
    if tag == 1:
        return [
            head,
            struct.pack("<qq", msg.round_num, msg.epoch),
            _encode_policy(msg.policy),
        ]
    if tag == 2:
        payload, count_word = _pack_floats(msg.value, mode)
        head = native.pack_block_header(
            2, msg.src_id, msg.dest_id, msg.chunk_id, msg.round_num, 0,
            payload, count_word,
        )
        return [head, payload]
    if tag == 3:
        payload, count_word = _pack_floats(msg.value, mode)
        head = native.pack_block_header(
            3, msg.src_id, msg.dest_id, msg.chunk_id, msg.round_num,
            msg.count, payload, count_word,
        )
        return [head, payload]
    if tag == 4:
        return [head, struct.pack("<iq", msg.src_id, msg.round_num)]
    if tag == 5:
        peers = msg.peer_ids
        # epoch rides AFTER the peer list so the variable-length tail stays
        # where every decoder expects it; the policy stamp is the trailing
        # field after THAT (old decoders stop at the epoch)
        return [
            head,
            struct.pack(
                f"<qiqiH{len(peers)}iq",
                msg.config_id,
                msg.worker_id,
                msg.round_num,
                msg.line_id,
                len(peers),
                *peers,
                msg.epoch,
            ),
            _encode_policy(msg.policy),
        ]
    if tag == 6:
        return [head, struct.pack("<qi", msg.config_id, msg.worker_id)]
    if tag == 7:
        return [
            head,
            _pack_str(msg.host),
            struct.pack("<Hiq", msg.port, msg.preferred_node_id, msg.incarnation),
        ]
    if tag == 8:
        parts = [
            head,
            struct.pack("<i", msg.node_id),
            _pack_str(msg.config_json),
            struct.pack("<qH", msg.epoch, len(msg.standbys)),
        ]
        for h, p in msg.standbys:
            parts.append(_pack_str(h) + _U16.pack(p))
        return parts
    if tag == 9:
        return [
            head,
            struct.pack("<iq", msg.node_id, msg.incarnation),
            _pack_str(msg.host),
            _U16.pack(msg.port),
        ]
    if tag == 10:
        return [head, struct.pack("<i", msg.node_id)]
    if tag == 11:
        parts = [head, _U16.pack(len(msg.entries))]
        for nid, host, port in msg.entries:
            parts.append(struct.pack("<i", nid) + _pack_str(host) + _U16.pack(port))
        parts.append(struct.pack("<qH", msg.epoch, len(msg.standbys)))
        for h, p in msg.standbys:
            parts.append(_pack_str(h) + _U16.pack(p))
        return parts
    if tag == 12:
        return [head, _pack_str(msg.reason), struct.pack("<q", msg.epoch)]
    if tag == 13:
        return [head, _pack_str(msg.reason), struct.pack("<q", msg.epoch)]
    if tag == 14:
        return [
            head,
            struct.pack("<iiq", msg.node_id, msg.origin, msg.step),
            _pack_str32(msg.manifest_json),
        ]
    if tag == 15:
        return [head, struct.pack("<i", msg.node_id)]
    if tag == 16:
        holders = msg.holders
        return [
            head,
            struct.pack("<q", msg.step),
            _pack_str32(msg.manifest_json),
            struct.pack(f"<H{len(holders)}i", len(holders), *holders),
        ]
    if tag == 17:
        return [head, _pack_str(msg.sha), struct.pack("<i", msg.requester)]
    if tag == 18:
        # chunk payload: raw checksummed bytes, zero-copy like tags 2/3 —
        # the payload segment is a memoryview the vectored send gathers
        payload = _chunk_payload_view(msg.payload)
        return [
            head,
            struct.pack("<Biq", 1 if msg.push else 0, msg.origin, msg.step),
            _pack_str(msg.sha),
            struct.pack(
                "<II", payload.nbytes, native.wire_checksum(payload)
            ),
            payload,
        ]
    if tag == 19:
        return [head, _pack_str(msg.sha), struct.pack("<i", msg.holder)]
    if tag == 20:
        return [
            head,
            struct.pack("<qi", msg.step, msg.origin),
            _pack_str32(msg.manifest_json),
        ]
    if tag == 21:
        return [head, _pack_str(msg.host), _U16.pack(msg.port)]
    if tag == 22:
        return [
            head,
            struct.pack("<qq", msg.epoch, msg.seq),
            _pack_str(msg.host),
            _U16.pack(msg.port),
            # the digest body routinely exceeds the u16 string bound (it
            # embeds the full config plus the ckpt manifest registry)
            _pack_str32(msg.state_json),
        ]
    if tag == 23:
        return [head, _pack_str(msg.reason)]
    if tag == 24:
        return [
            head,
            struct.pack("<iqI", msg.sender, msg.incarnation, msg.seq),
            _pack_str(msg.host),
            _U16.pack(msg.port),
            _pack_gossip_digest(msg.digest),
        ]
    if tag == 25:
        return [
            head,
            struct.pack("<iiI", msg.sender, msg.target, msg.seq),
            _pack_gossip_digest(msg.digest),
        ]
    if tag == 26:
        return [
            head,
            struct.pack("<iqI", msg.sender, msg.incarnation, msg.seq),
            _pack_gossip_digest(msg.digest),
        ]
    raise AssertionError(f"unhandled tag {tag}")


def decode(data: bytes | memoryview) -> Any:
    """``[tag][body]`` bytes -> message (float payloads are zero-copy views)."""
    buf = memoryview(data)
    tag = buf[0]
    off = 1
    if tag == 1:
        rnd, epoch = struct.unpack_from("<qq", buf, off)
        return StartAllreduce(rnd, epoch, _decode_policy(buf, off + 16))
    if tag == 2:
        value, src, dest, chunk, rnd, _ = _decode_block(buf)
        return ScatterBlock(value, src, dest, chunk, rnd)
    if tag == 3:
        value, src, dest, chunk, rnd, count = _decode_block(buf)
        return ReduceBlock(value, src, dest, chunk, rnd, count)
    if tag == 4:
        return CompleteAllreduce(*struct.unpack_from("<iq", buf, off))
    if tag == 5:
        config_id, worker_id, round_num, line_id, n = struct.unpack_from(
            "<qiqiH", buf, off
        )
        peers = struct.unpack_from(f"<{n}i", buf, off + 26)
        (epoch,) = struct.unpack_from("<q", buf, off + 26 + 4 * n)
        policy = _decode_policy(buf, off + 34 + 4 * n)
        return PrepareAllreduce(
            config_id, peers, worker_id, round_num, line_id, epoch, policy
        )
    if tag == 6:
        return ConfirmPreparation(*struct.unpack_from("<qi", buf, off))
    if tag == 7:
        host, off = _unpack_str(buf, off)
        port, preferred, incarnation = struct.unpack_from("<Hiq", buf, off)
        return cl.JoinCluster(host, port, preferred, incarnation)
    if tag == 8:
        (node_id,) = struct.unpack_from("<i", buf, off)
        config_json, off = _unpack_str(buf, off + 4)
        epoch, n = struct.unpack_from("<qH", buf, off)
        standbys, off = _unpack_endpoints(buf, off + 10, n)
        return cl.Welcome(node_id, config_json, epoch, standbys)
    if tag == 9:
        node_id, incarnation = struct.unpack_from("<iq", buf, off)
        host, off = _unpack_str(buf, off + 12)
        (port,) = _U16.unpack_from(buf, off)
        return cl.Heartbeat(node_id, incarnation, host, port)
    if tag == 10:
        return cl.LeaveCluster(*struct.unpack_from("<i", buf, off))
    if tag == 11:
        (n,) = _U16.unpack_from(buf, off)
        off += 2
        entries = []
        for _ in range(n):
            (nid,) = struct.unpack_from("<i", buf, off)
            host, off = _unpack_str(buf, off + 4)
            (port,) = _U16.unpack_from(buf, off)
            off += 2
            entries.append((nid, host, port))
        epoch, n_standby = struct.unpack_from("<qH", buf, off)
        standbys, off = _unpack_endpoints(buf, off + 10, n_standby)
        return cl.AddressBook(tuple(entries), epoch, standbys)
    if tag == 12:
        reason, off = _unpack_str(buf, off)
        return cl.Shutdown(reason, *struct.unpack_from("<q", buf, off))
    if tag == 13:
        reason, off = _unpack_str(buf, off)
        return cl.Rejoin(reason, *struct.unpack_from("<q", buf, off))
    if tag == 14:
        node_id, origin, step = struct.unpack_from("<iiq", buf, off)
        manifest, _ = _unpack_str32(buf, off + 16)
        return st.CheckpointAdvert(node_id, origin, step, manifest)
    if tag == 15:
        return st.ManifestRequest(*struct.unpack_from("<i", buf, off))
    if tag == 16:
        (step,) = struct.unpack_from("<q", buf, off)
        manifest, off = _unpack_str32(buf, off + 8)
        (n,) = _U16.unpack_from(buf, off)
        holders = struct.unpack_from(f"<{n}i", buf, off + 2)
        return st.ManifestReply(step, manifest, holders)
    if tag == 17:
        sha, off = _unpack_str(buf, off)
        return st.ChunkFetch(sha, *struct.unpack_from("<i", buf, off))
    if tag == 18:
        push, origin, step = struct.unpack_from("<Biq", buf, off)
        sha, off = _unpack_str(buf, off + 13)
        nbytes, ck = struct.unpack_from("<II", buf, off)
        off += 8
        # bound with <=, never ==: trailing bytes (e.g. the trace trailer)
        # must be tolerated, exactly like the tag-2/3 payload decode
        if off + nbytes > len(buf):
            raise ValueError("truncated chunk payload")
        payload = buf[off : off + nbytes]
        if native.wire_checksum(payload) != ck:
            raise ValueError("chunk payload checksum mismatch")
        # zero-copy u8 view into the receive buffer, like the float tags —
        # the recv-pool export check keeps recycling safe
        value = np.frombuffer(payload, dtype=np.uint8)
        return st.ChunkData(sha, value, origin, step, bool(push))
    if tag == 19:
        sha, off = _unpack_str(buf, off)
        return st.ChunkMissing(sha, *struct.unpack_from("<i", buf, off))
    if tag == 20:
        step, origin = struct.unpack_from("<qi", buf, off)
        manifest, _ = _unpack_str32(buf, off + 12)
        return st.ReplicaManifest(step, manifest, origin)
    if tag == 21:
        host, off = _unpack_str(buf, off)
        return cl.StandbyRegister(host, *_U16.unpack_from(buf, off))
    if tag == 22:
        epoch, seq = struct.unpack_from("<qq", buf, off)
        host, off = _unpack_str(buf, off + 16)
        (port,) = _U16.unpack_from(buf, off)
        state_json, _ = _unpack_str32(buf, off + 2)
        return cl.StateDigest(epoch, seq, host, port, state_json)
    if tag == 23:
        reason, _ = _unpack_str(buf, off)
        return st.AdvertSolicit(reason)
    if tag == 24:
        sender, incarnation, seq = struct.unpack_from("<iqI", buf, off)
        host, off = _unpack_str(buf, off + 16)
        (port,) = _U16.unpack_from(buf, off)
        digest, _ = _unpack_gossip_digest(buf, off + 2)
        return gp.Ping(sender, incarnation, seq, host, port, digest)
    if tag == 25:
        sender, target, seq = struct.unpack_from("<iiI", buf, off)
        digest, _ = _unpack_gossip_digest(buf, off + 12)
        return gp.PingReq(sender, target, seq, digest)
    if tag == 26:
        sender, incarnation, seq = struct.unpack_from("<iqI", buf, off)
        digest, _ = _unpack_gossip_digest(buf, off + 16)
        return gp.Ack(sender, incarnation, seq, digest)
    raise ValueError(f"unknown wire tag {tag}")


# -- trace-context trailer -----------------------------------------------------
#
# Version-skew-compatible by construction (reserved-BYTES encoding, not a new
# tag): a frame carrying trace context appends
#   [u64 trace_id][u64 span_id][u8 flags][8-byte magic]
# AFTER the message body. Every per-tag decode arm reads exactly the bytes it
# needs and ignores anything after them (the payload tags bound-check
# `offset + payload <= len`, never `==` — native and fallback paths alike),
# so a decoder built BEFORE this trailer existed accepts trailered frames
# unchanged, and this decoder accepts trailer-less frames (no magic -> no
# context). tests/test_wire_roundtrip.py ratchets both directions over every
# tag. The magic ends the frame (constant offset from the end — no length
# field to trust) and an accidental 8-byte collision in payload data is a
# 2^-64 event whose worst case is one dropped frame (at-most-once absorbs it).

_TRACE_STRUCT = struct.Struct("<QQB")
_TRACE_MAGIC = b"\x00\xf7aRtC\x9e\x01"
_TRACE_LEN = _TRACE_STRUCT.size + len(_TRACE_MAGIC)
_TRACE_SAMPLED = 0x01


def encode_trace(trace) -> bytes:
    """Trace context (``obs.trace.TraceContext`` or (trace_id, span_id,
    sampled) triple) -> wire trailer bytes."""
    trace_id, span_id, sampled = trace
    return (
        _TRACE_STRUCT.pack(
            trace_id & 0xFFFF_FFFF_FFFF_FFFF,
            span_id & 0xFFFF_FFFF_FFFF_FFFF,
            _TRACE_SAMPLED if sampled else 0,
        )
        + _TRACE_MAGIC
    )


def split_trace(buf: memoryview):
    """``(message bytes view, trace context | None)`` for a frame body whose
    dest prefix is already consumed."""
    n = len(buf)
    if n >= _TRACE_LEN + 1 and bytes(buf[n - 8 : n]) == _TRACE_MAGIC:
        trace_id, span_id, flags = _TRACE_STRUCT.unpack_from(
            buf, n - _TRACE_LEN
        )
        from akka_allreduce_tpu_torch.obs.trace import TraceContext

        return buf[: n - _TRACE_LEN], TraceContext(
            trace_id, span_id, bool(flags & _TRACE_SAMPLED)
        )
    return buf, None


def encode_frame_parts(
    dest: str, msg: Any, *, f16: bool = False, wire: str | None = None,
    trace=None,
) -> list[bytes | memoryview]:
    """Framed envelope as scatter-gather segments:
    ``[u32 len][u16 dest_len][dest][tag][body...][trace trailer?]``.

    The float payload stays a ``memoryview`` of the caller's array — NO
    payload-sized copy happens here or anywhere on the send path: the
    transport passes the segments straight to ``socket.sendmsg`` (writev),
    so the kernel gathers them. The payload memory must stay unmodified
    until the send completes (the engine's frozen-after-reduce buffers and
    snapshot-publishing sources guarantee this). ``f16`` sends float
    payloads at half width; ``wire`` overrides it per frame with an
    explicit mode ("f32"/"f16"/"int8" — the RoundPolicy path; decode is
    stateless, the mode travels in the count-word flags). ``trace``
    appends the 25-byte trace-context trailer (see above — old decoders
    ignore it)."""
    parts: list[Any] = [
        b"", _pack_str(dest), *_encode_parts(msg, _wire_mode(f16, wire))
    ]
    if trace is not None:
        parts.append(encode_trace(trace))
    body_len = sum(len(p) for p in parts)
    parts[0] = _U32.pack(body_len)
    return parts


def encode_frame(
    dest: str, msg: Any, *, f16: bool = False, wire: str | None = None,
    trace=None,
) -> bytes:
    """``encode_frame_parts`` joined to one buffer (compat / tests — the
    transport itself sends the segments unjoined)."""
    return b"".join(
        encode_frame_parts(dest, msg, f16=f16, wire=wire, trace=trace)
    )


# -- multi-stream preamble and frame sizing ------------------------------------
#
# With DataPlaneConfig.streams > 1 a transport opens N sockets per peer
# endpoint. Every such connection opens with a PREAMBLE so the receive side
# knows (a) this is a stream connection, (b) which stream it is, and (c) the
# sender's canonical endpoint (for per-endpoint rx telemetry — the TCP
# peername carries an ephemeral port). The magic's first four bytes are
# 0xFFFFFFFF — as a legacy length prefix that is ~16x over
# ``RemoteTransport.max_frame_bytes``, so no valid legacy frame can ever
# start with it: one 4-byte peek disambiguates the two framings, and a
# legacy (streams=1 / pre-streams) connection is byte-identical to the one-stream wire.
#
# Frames on payload streams (stream_id >= 1) are framed
# ``[u32 body_len][u32 seq][body]`` — the per-stream sequence number is
# framing, not message bytes, so the message wire format (tags, checksums,
# trace trailer) is untouched. Stream 0 keeps legacy ``[u32 len][body]``
# framing after its preamble: control ordering rides one FIFO socket.

STREAM_MAGIC = b"\xff\xff\xff\xffAWS1"
_PREAMBLE_FIXED = struct.Struct("<HHHH")  # stream_id, total, port, host_len


def encode_stream_preamble(
    stream_id: int, total_streams: int, host: str, port: int
) -> bytes:
    """``[magic 8][u16 stream_id][u16 total][u16 port][u16 host_len][host]``."""
    raw = host.encode("utf-8")
    return (
        STREAM_MAGIC
        + _PREAMBLE_FIXED.pack(stream_id, total_streams, port, len(raw))
        + raw
    )


def parse_stream_preamble(buf: memoryview):
    """``(stream_id, total, host, port, consumed) | None`` (need more bytes).

    The caller has already matched :data:`STREAM_MAGIC`'s first 4 bytes;
    a full-magic mismatch raises ``ValueError`` (protocol error — close)."""
    if len(buf) < 8:
        return None
    if bytes(buf[:8]) != STREAM_MAGIC:
        raise ValueError("bad stream preamble magic")
    if len(buf) < 16:
        return None
    stream_id, total, port, host_len = _PREAMBLE_FIXED.unpack_from(buf, 8)
    if host_len > 1024:
        # no real hostname; also keeps the preamble well under the receive
        # ring so an incomplete one can always finish buffering
        raise ValueError(f"stream preamble host_len {host_len} implausible")
    if len(buf) < 16 + host_len:
        return None
    host = bytes(buf[16 : 16 + host_len]).decode("utf-8")
    return stream_id, total, host, port, 16 + host_len


def payload_frame_nbytes(
    dest: str, msg: Any, mode: str, has_trace: bool
) -> int:
    """Exact byte size of ``encode_frame_parts(dest, msg, ...)`` for a
    payload message (ScatterBlock / ReduceBlock) WITHOUT encoding it — the
    deferred-encode senders charge backpressure accounting at enqueue time,
    before the sender thread runs the actual encode + checksum pass.

    NB this is the size of the ENCODED PARTS (length prefix + body); the
    4-byte per-stream seq header is connection framing stamped by the
    sender thread, and the caller accounts for it (+4 per frame)."""
    tag = _TAGS[type(msg)]
    if tag == 2:
        header = 1 + 20 + 8  # tag + <iiiq> + count word + checksum
    elif tag == 3:
        header = 1 + 24 + 8  # tag + <iiiqi> + count word + checksum
    else:  # non-payload messages never take the deferred path
        raise ValueError(f"not a payload frame tag: {tag}")
    n = msg.value.numel()
    if mode == "f16":
        payload = 2 * n
    elif mode == "int8":
        payload = 4 + n  # f32 scale + i8 elements
    else:
        payload = 4 * n
    return (
        4  # u32 length prefix
        + 2 + len(dest.encode("utf-8"))
        + header
        + payload
        + (_TRACE_LEN if has_trace else 0)
    )


# -- sub-chunk continuation frames (intra-chunk striping) ----------------------
#
# With DataPlaneConfig.intra_chunk_min_bytes set, a payload frame whose
# encoded body reaches the bar is SPLIT across the endpoint's payload
# streams: each stripe carries ``[u32 len][u32 seq]`` framing (the ordinary
# payload-stream framing) around a CONTINUATION body
#   [u16 0xFFFF][u32 frag_id][u32 total_len][u32 offset][fragment bytes]
# where 0xFFFF occupies the position of a normal body's dest-length prefix —
# no real destination string is 65535 bytes (max_frame_bytes caps frames far
# below the implied size), so one 2-byte peek disambiguates continuation
# frames from whole-frame bodies on a payload stream. The receive side
# lands every fragment DIRECTLY at its offset in one pooled frame-sized
# buffer (no join copy — the zero-copy contract holds: decode hands
# out views into that buffer) and delivers the reassembled body when
# ``total_len`` bytes have arrived, whatever order the stripes landed in.
#
# Version skew: continuation frames exist only on payload streams, whose
# existence (and this lever's bar) a cluster negotiates via Welcome — a
# legacy peer never opens a payload stream, so it can never meet one.

FRAG_MARKER = 0xFFFF
_FRAG_HDR = struct.Struct("<HIII")
FRAG_HDR_LEN = _FRAG_HDR.size


def encode_frag_header(frag_id: int, total_len: int, offset: int) -> bytes:
    """Continuation header for one stripe of a split payload frame."""
    return _FRAG_HDR.pack(
        FRAG_MARKER, frag_id & 0xFFFF_FFFF, total_len, offset
    )


def parse_frag_header(
    buf: bytes | memoryview,
) -> tuple[int, int, int] | None:
    """``(frag_id, total_len, offset)`` for a continuation body, or None
    when ``buf`` holds fewer than :data:`FRAG_HDR_LEN` bytes (wait for
    more). Raises ``ValueError`` when the marker does not match (the
    caller peeked wrong) or the offset lies outside the total — a
    malformed header must never become an out-of-bounds buffer write."""
    if len(buf) < FRAG_HDR_LEN:
        return None
    marker, frag_id, total_len, offset = _FRAG_HDR.unpack_from(buf, 0)
    if marker != FRAG_MARKER:
        raise ValueError("not a continuation frame")
    if offset >= total_len:
        raise ValueError(
            f"fragment offset {offset} outside body of {total_len} bytes"
        )
    return frag_id, total_len, offset


def slice_parts(parts: list, start: int, end: int) -> list[memoryview]:
    """Byte range ``[start, end)`` of a scatter-gather segment list as
    views — no copy, so a stripe of a deferred-encoded frame reuses the
    one shared encode's payload memory. ``parts`` are the BODY segments
    (``encode_frame_parts(...)[1:]`` — the u32 length prefix is per-stripe
    framing, not body bytes)."""
    out: list[memoryview] = []
    pos = 0
    for p in parts:
        mv = p if isinstance(p, memoryview) else memoryview(p)
        n = len(mv)
        if pos + n <= start or pos >= end:
            pos += n
            continue
        lo = max(0, start - pos)
        hi = min(n, end - pos)
        out.append(mv[lo:hi])
        pos += n
    return out


def decode_frame_body(body: bytes | memoryview) -> tuple[str, Any]:
    """Inverse of ``encode_frame`` minus the length prefix."""
    dest, msg, _ = decode_frame_body_ex(body)
    return dest, msg


def decode_frame_body_ex(body: bytes | memoryview):
    """``(dest, message, trace context | None)`` — the transport's decode."""
    buf = memoryview(body)
    dest, off = _unpack_str(buf, 0)
    rest, trace = split_trace(buf[off:])
    return dest, decode(rest), trace
