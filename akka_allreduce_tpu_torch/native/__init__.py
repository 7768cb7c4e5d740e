"""The wire codec's C++ hot loop, bound with ctypes: the port's own copy of
the wire half of the JAX package's ``native/__init__.py``.

``wire.cpp`` (payload-frame header pack/unpack, the additive checksum,
``sendmmsg``/``recvmmsg`` bursts and io_uring submission) is host code that
moves frame bytes; it touches no tensor. ``g++`` builds it at first use into
``build/native/`` at the root of the checkout, under a file name that
carries a hash of the source and the flags, so a stale library is never
loaded. The build runs in a background thread: hot-path callers use the
struct/numpy path, which gives the same bytes, until it lands. ``available()``
waits for the build; ``loaded()`` says, without building, whether the
library is in use (the ``wire=native|python`` provenance a node reports).
The reduction half of the JAX ``native/`` is ``tensor_reduce.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "wire.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CXXFLAGS = ["-O3", "-fPIC", "-shared", "-Wall", "-std=c++17"]

_lib = None
_lock = threading.Lock()
_build_thread: threading.Thread | None = None
_load_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)

# wire codec routes payloads smaller than this (bytes) to struct/numpy — a
# ctypes call costs ~1us of marshalling, so tiny frames are faster in Python.
_WIRE_NATIVE_MIN = 16384


def library_path() -> Path:
    """Where ``wire.cpp`` builds to (named by a hash of the source and the
    flags)."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXXFLAGS).encode())
    return BUILD_DIR / f"_wire-{h.hexdigest()[:16]}.so"


def _try_build() -> bool:
    """Compile to a per-process-per-thread temp path, then rename into
    place: several node processes may compile at once, and ``os.replace`` is
    atomic, so nobody loads a half-written file."""
    path = library_path()
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, str(_SRC), "-o", str(tmp)]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.info("native wire build unavailable (%s); using the python codec", e)
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _ensure_build(wait: bool) -> None:
    """Start (or join) the one background build of the library."""
    global _build_thread
    with _lock:
        if library_path().exists():
            return
        if _build_thread is None:
            _build_thread = threading.Thread(
                target=_try_build, name="native-wire-build", daemon=True
            )
            _build_thread.start()
        thread = _build_thread
    if wait:
        thread.join(timeout=150)


def _bind(lib) -> None:
    """Declare argtypes; raises AttributeError on a library missing symbols."""
    lib.aw_checksum.argtypes = [_u8p, ctypes.c_int64]
    lib.aw_checksum.restype = ctypes.c_uint32
    lib.aw_pack_block.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32, _u8p, ctypes.c_int64, ctypes.c_uint32,
    ]
    lib.aw_pack_block.restype = ctypes.c_int
    lib.aw_unpack_block.argtypes = [_u8p, ctypes.c_int64, _i64p]
    lib.aw_unpack_block.restype = ctypes.c_int64
    lib.aw_have_sendmmsg.argtypes = []
    lib.aw_have_sendmmsg.restype = ctypes.c_int
    _u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.aw_sendmmsg.argtypes = [
        ctypes.c_int, _u64p, _i64p, _i32p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.aw_sendmmsg.restype = ctypes.c_int64
    lib.aw_recvmmsg.argtypes = [
        ctypes.c_int, _u64p, _i64p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.aw_recvmmsg.restype = ctypes.c_int64
    lib.aw_have_uring.argtypes = []
    lib.aw_have_uring.restype = ctypes.c_int
    lib.aw_uring_probe_errno.argtypes = []
    lib.aw_uring_probe_errno.restype = ctypes.c_int
    lib.aw_uring_create.argtypes = [ctypes.c_int]
    lib.aw_uring_create.restype = ctypes.c_void_p
    lib.aw_uring_close.argtypes = [ctypes.c_void_p]
    lib.aw_uring_close.restype = None
    lib.aw_uring_sendmsg.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _u64p, _i64p, ctypes.c_int32,
    ]
    lib.aw_uring_sendmsg.restype = ctypes.c_int64


def _load(*, build_wait: bool = False):
    """The bound library, or None (the python codec).

    Hot-path callers pass ``build_wait=False``: a missing library starts
    one background compile and the caller uses the python codec until it
    lands. A build or load that fails latches, so hot paths stop asking.
    """
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    path = library_path()
    if not path.exists():
        _ensure_build(wait=build_wait)
        if not path.exists():
            with _lock:
                if _build_thread is not None and not _build_thread.is_alive():
                    _load_failed = True
            return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(path))
            _bind(lib)
        except (OSError, AttributeError) as e:
            log.warning("unloadable %s (%s); using the python codec", path, e)
            _load_failed = True
            return None
        _lib = lib
        return lib


def available() -> bool:
    """True iff the library builds and loads (waits for the build)."""
    return _load(build_wait=True) is not None


def loaded() -> bool:
    """True iff the library is loaded right now: never builds, never
    blocks. This is the provenance query: ``available()`` may compile and
    then truthfully answer about a library a finished run never used."""
    return _lib is not None


# -- wire codec hot loop (control/wire.py payload frames) ----------------------
#
# Frame body layout (tag 2 = ScatterBlock <iiiq>, tag 3 = ReduceBlock <iiiqi>):
#   [tag u8][fields][count_word u32][checksum u32][payload bytes]
# The count word's top bit flags float16 payloads (wire._F16_FLAG); the
# checksum is the additive sum of the payload's LE u32 words mod 2^32 (tail
# zero-padded). These wrappers
# collapse the per-frame work to ONE native call each way when the payload is
# large enough to amortize the ctypes marshalling, with an exact struct/numpy
# fallback otherwise — same bytes either path.

_F16_FLAG = 0x8000_0000  # keep in sync with control/wire.py and wire.cpp
_PACK_SCATTER = struct.Struct("<BiiiqII")
_PACK_REDUCE = struct.Struct("<BiiiqiII")


def _u8(mv: memoryview) -> np.ndarray:
    return np.frombuffer(mv, dtype=np.uint8)


def _byte_view(buf) -> memoryview:
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    return mv if mv.format == "B" and mv.contiguous else mv.cast("B")


def wire_checksum(buf) -> int:
    """Additive sum of little-endian u32 words mod 2^32 (tail zero-padded)
    of ``buf`` — native when it pays off, numpy otherwise, same value."""
    mv = _byte_view(buf)
    n = mv.nbytes
    if n == 0:
        return 0
    if n >= _WIRE_NATIVE_MIN and (lib := _load()) is not None:
        return int(lib.aw_checksum(_u8(mv).ctypes.data_as(_u8p), n))
    n4 = n & ~3
    s = (
        int(np.add.reduce(np.frombuffer(mv[:n4], "<u4"), dtype=np.uint32))
        if n4
        else 0
    )
    if n4 < n:
        s = (s + int.from_bytes(bytes(mv[n4:n]), "little")) & 0xFFFF_FFFF
    return s


def pack_block_header(
    tag: int,
    src_id: int,
    dest_id: int,
    chunk_id: int,
    round_num: int,
    count: int,
    payload,
    count_word: int,
) -> bytes:
    """``[tag][fields][count_word][checksum]`` for a payload frame — the
    checksum pass over ``payload`` and the header pack are one native call."""
    mv = _byte_view(payload)
    n = mv.nbytes
    if n >= _WIRE_NATIVE_MIN and (lib := _load()) is not None:
        out = (ctypes.c_uint8 * 40)()
        ln = lib.aw_pack_block(
            out, tag, src_id, dest_id, chunk_id, round_num, count,
            _u8(mv).ctypes.data_as(_u8p), n, count_word,
        )
        if ln > 0:
            return bytes(out[:ln])
    ck = wire_checksum(mv)
    if tag == 2:
        return _PACK_SCATTER.pack(
            2, src_id, dest_id, chunk_id, round_num, count_word, ck
        )
    if tag == 3:
        return _PACK_REDUCE.pack(
            3, src_id, dest_id, chunk_id, round_num, count, count_word, ck
        )
    raise ValueError(f"not a payload frame tag: {tag}")


def unpack_block(body) -> tuple[int, int, int, int, int, int, bool, int]:
    """Parse + checksum-verify a payload frame body (starting at the tag).

    Returns ``(src_id, dest_id, chunk_id, round_num, count, n_elems, is_f16,
    payload_offset)``; raises ``ValueError`` on truncation / checksum
    mismatch / non-payload tag. The caller slices the payload out of ``body``
    at the returned offset — no copy happens here.
    """
    mv = _byte_view(body)
    n = mv.nbytes
    if n >= _WIRE_NATIVE_MIN and (lib := _load()) is not None:
        out = (ctypes.c_int64 * 7)()
        off = int(
            lib.aw_unpack_block(_u8(mv).ctypes.data_as(_u8p), n, out)
        )
        if off == -2:
            raise ValueError("payload checksum mismatch")
        if off < 0:
            raise ValueError(f"malformed payload frame (code {off})")
        return (
            int(out[0]), int(out[1]), int(out[2]), int(out[3]), int(out[4]),
            int(out[5]), bool(out[6]), off,
        )
    if n < 1:
        raise ValueError("empty payload frame")
    tag = mv[0]
    try:
        if tag == 2:
            src, dest, chunk, rnd = struct.unpack_from("<iiiq", mv, 1)
            count, off = 0, 21
        elif tag == 3:
            src, dest, chunk, rnd, count = struct.unpack_from("<iiiqi", mv, 1)
            off = 25
        else:
            raise ValueError(f"not a payload frame tag: {tag}")
        count_word, ck = struct.unpack_from("<II", mv, off)
    except struct.error as exc:  # same contract as the native path: ValueError
        raise ValueError(f"truncated payload frame header ({exc})") from exc
    off += 8
    n_elems = count_word & ~_F16_FLAG
    is_f16 = bool(count_word & _F16_FLAG)
    nbytes = n_elems * (2 if is_f16 else 4)
    if off + nbytes > n:
        raise ValueError("truncated payload")
    if wire_checksum(mv[off : off + nbytes]) != ck:
        raise ValueError("payload checksum mismatch")
    return (src, dest, chunk, rnd, count, n_elems, is_f16, off)


# -- batch syscalls (wire.cpp aw_sendmmsg/aw_recvmmsg) -------------------------
#
# The multi-stream senders drain a burst of frames in one syscall per stream.
# Wire bytes are IDENTICAL either path (batching is pure syscall coalescing);
# the plain sendmsg loop is compiled in unconditionally and selected at
# runtime — by the kernel's ENOSYS answer, or by force_fallback for the
# byte-identity pin in tests.


def batch_send_available() -> bool:
    """True iff the native batch-send entry point is loadable (the Python
    caller keeps its own socket.sendmsg loop for when it is not)."""
    return _load() is not None


def sendmmsg_available() -> bool:
    """True iff the RUNNING kernel implements sendmmsg (runtime probe);
    False also when the native library itself is unavailable."""
    lib = _load()
    return bool(lib is not None and lib.aw_have_sendmmsg())


def _iovec_arrays(views: list) -> tuple[np.ndarray, np.ndarray, list]:
    """(bases u64, lens i64, keepalive) for a flat list of buffer views.

    The keepalive list pins the np.frombuffer wrappers (and thus the
    addresses) for the duration of the syscall."""
    keep = []
    bases = np.empty(len(views), dtype=np.uint64)
    lens = np.empty(len(views), dtype=np.int64)
    for i, v in enumerate(views):
        arr = np.frombuffer(v, dtype=np.uint8)
        keep.append(arr)
        bases[i] = arr.ctypes.data
        lens[i] = arr.nbytes
    return bases, lens, keep


def batch_send(fd: int, frames: list[list], *, force_fallback: bool = False) -> int:
    """Send ``frames`` (each a list of buffer segments) on connected stream
    socket ``fd`` in one ``sendmmsg`` (or the runtime-selected ``sendmsg``
    loop). Returns bytes sent — short counts and partial trailing frames
    are normal; the caller advances its views and re-enters. Raises
    ``BlockingIOError`` when nothing could be sent (EAGAIN) and ``OSError``
    for other errnos; ``RuntimeError`` when the native library is absent
    (query :func:`batch_send_available` first)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native wire library unavailable")
    flat: list = []
    counts = np.empty(len(frames), dtype=np.int32)
    for i, parts in enumerate(frames):
        parts = [p for p in parts if len(p)]
        counts[i] = len(parts)
        flat.extend(parts)
    bases, lens, _keep = _iovec_arrays(flat)
    n = int(
        lib.aw_sendmmsg(
            fd,
            bases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lens.ctypes.data_as(_i64p),
            counts.ctypes.data_as(_i32p),
            len(frames),
            1 if force_fallback else 0,
        )
    )
    if n < 0:
        import errno as _errno

        if -n in (_errno.EAGAIN, _errno.EWOULDBLOCK):
            raise BlockingIOError(-n, os.strerror(-n))
        raise OSError(-n, os.strerror(-n))
    return n


# -- io_uring submission (wire.cpp aw_uring_*) ---------------------------------
#
# The next syscall step past sendmmsg: one ring submission drains a whole
# burst (a single SENDMSG op gathering every frame segment — the byte stream
# cannot interleave). Runtime-probed like the batch syscalls; the probe's
# REASON is exported so bench-wire records why a box fell back instead of
# silently benching the wrong lever.


def uring_available() -> bool:
    """True iff the native library is loaded AND the running kernel's
    io_uring probe passed (setup accepted + SENDMSG supported)."""
    lib = _load()
    return bool(lib is not None and lib.aw_have_uring())


def uring_probe_reason() -> str:
    """Why io_uring is (un)usable here: ``"ok"`` when the probe passed,
    else a stable reason code — ``"no-native"`` (library not built),
    ``"enosys"`` (pre-5.1 kernel), ``"eperm"`` (seccomp/gVisor policy),
    ``"op-unsupported"`` (ring exists, SENDMSG does not), or
    ``"errno:<n>"`` for anything else the setup syscall answered."""
    import errno as _errno

    lib = _load()
    if lib is None:
        return "no-native"
    code = int(lib.aw_uring_probe_errno())
    if code == 0:
        return "ok"
    if code == _errno.ENOSYS:
        return "enosys"
    if code == _errno.EPERM:
        return "eperm"
    if code == _errno.EOPNOTSUPP:
        return "op-unsupported"
    return f"errno:{code}"


class UringRing:
    """One sender thread's submission ring (never shared across threads).

    ``send`` takes a FLAT list of buffer segments and moves them through
    one ring submission; short counts are normal (the caller advances its
    views and re-enters, exactly the ``batch_send`` contract). Raises
    ``RuntimeError`` at construction when io_uring is unusable here —
    callers probe :func:`uring_available` first and keep the
    sendmmsg/sendmsg path as the fallback."""

    __slots__ = ("_handle", "_lib")

    def __init__(self, entries: int = 8) -> None:
        lib = _load()
        if lib is None or not lib.aw_have_uring():
            raise RuntimeError(
                f"io_uring unavailable ({uring_probe_reason()})"
            )
        handle = lib.aw_uring_create(entries)
        if not handle:
            raise RuntimeError("io_uring ring creation failed")
        self._lib = lib
        self._handle = handle

    def send(self, fd: int, views: list) -> int:
        """Send ``views`` (flat buffer segments) on connected stream
        socket ``fd``; returns bytes moved, raises ``BlockingIOError`` /
        ``OSError`` like :func:`batch_send`."""
        import errno as _errno

        bases, lens, _keep = _iovec_arrays(views)
        n = int(
            self._lib.aw_uring_sendmsg(
                self._handle,
                fd,
                bases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                lens.ctypes.data_as(_i64p),
                len(views),
            )
        )
        if n < 0:
            if -n in (_errno.EAGAIN, _errno.EWOULDBLOCK):
                raise BlockingIOError(-n, os.strerror(-n))
            raise OSError(-n, os.strerror(-n))
        return n

    def close(self) -> None:
        handle, self._handle = self._handle, None
        if handle:
            self._lib.aw_uring_close(handle)

    def __del__(self) -> None:  # best-effort: rings also close with the fd
        try:
            self.close()
        except Exception:  # pragma: no cover - interpreter teardown
            pass


def batch_recv(fd: int, bufs: list, *, force_fallback: bool = False) -> int:
    """Receive into ``bufs`` (writable buffers, filled in order) from
    stream socket ``fd`` via ``recvmmsg`` (or the recvmsg loop). Returns
    total bytes read (0 = orderly EOF); raises like :func:`batch_send`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native wire library unavailable")
    bases, lens, _keep = _iovec_arrays(bufs)
    n = int(
        lib.aw_recvmmsg(
            fd,
            bases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lens.ctypes.data_as(_i64p),
            len(bufs),
            1 if force_fallback else 0,
        )
    )
    if n < 0:
        import errno as _errno

        if -n in (_errno.EAGAIN, _errno.EWOULDBLOCK):
            raise BlockingIOError(-n, os.strerror(-n))
        raise OSError(-n, os.strerror(-n))
    return n
