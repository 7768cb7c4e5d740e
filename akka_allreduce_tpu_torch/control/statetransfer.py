"""Peer state transfer: the content-addressed checkpoint store, and the
chunk service that serves its blobs between nodes over the TCP transport.

The port's copy of ``akka_allreduce_tpu/control/statetransfer.py``.

The store half: :func:`leaf_sha`, :func:`npy_bytes`, :func:`npy_sha`, the
durable writes (:func:`fsync_write`, :func:`publish_file`),
:class:`ChunkStore` (owner and replica manifests, ``missing``,
``save_state``/``load_state``, ``prune``'s dead-pid temp sweep),
:func:`copy_delta` and :func:`note_disk_restore`. A blob is the ``.npy``
file of one leaf, named by :func:`leaf_sha` of its array; a manifest maps
leaf paths to blob names. Blob bytes, blob names and manifest JSON are
byte-identical to the JAX store's for the same arrays: a peer restore
verifies fetched bytes against these names, so either package's store reads
the other's.

The transfer half: the wire messages (``control/wire.py`` tags 14-20 and
23) and :class:`ChunkService`. A service on every node serves the blobs a
manifest names, absorbs replication pushes (verify before publish), pushes
the owner's newest manifest to ``replicas`` peers after each save, and on a
rejoin pulls the missing chunks in parallel from live holders, with
per-chunk retry and failover, checking each chunk's content hash before it
is written. Chunk bytes ride the transport's zero-copy send path with the
payload tags' additive checksum.

Everything here is numpy, asyncio and the standard library.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import io
import json
import logging
import os
import random
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

from akka_allreduce_tpu_torch.config import RetryPolicy
from akka_allreduce_tpu_torch.control.envelope import Envelope
from akka_allreduce_tpu_torch.obs import flight as _flight
from akka_allreduce_tpu_torch.obs import metrics as _metrics
from akka_allreduce_tpu_torch.obs import trace as _trace

log = logging.getLogger(__name__)

__all__ = [
    "AdvertSolicit",
    "CheckpointAdvert",
    "ChunkData",
    "ChunkFetch",
    "ChunkMissing",
    "ChunkService",
    "ManifestReply",
    "ManifestRequest",
    "ReplicaManifest",
    "ChunkStore",
    "copy_delta",
    "fsync_dir",
    "fsync_write",
    "leaf_sha",
    "note_disk_restore",
    "npy_bytes",
    "npy_sha",
    "publish_file",
]

# the JAX package's restore.* metric names (OBSERVABILITY.md)
_R_FROM_DISK = _metrics.counter("restore.from_disk")
_R_SECONDS = _metrics.gauge("restore.seconds")

# -- metrics (OBSERVABILITY.md "restore.* / replicate.*") ----------------------
# module-level objects, like remote.py's drop counters: hot-path increments
# are one attribute add, never a registry lookup
_R_CHUNKS_FETCHED = _metrics.counter("restore.chunks_fetched")
_R_BYTES_FETCHED = _metrics.counter("restore.bytes_fetched")
_R_CHUNKS_SERVED = _metrics.counter("restore.chunks_served")
_R_BYTES_SERVED = _metrics.counter("restore.bytes_served")
_R_RETRIES = _metrics.counter("restore.chunk_retries")
_R_FAILOVERS = _metrics.counter("restore.failovers")
_R_REJECTED = _metrics.counter("restore.chunks_rejected")
_R_FROM_PEER = _metrics.counter("restore.from_peer")
_P_CHUNKS_SENT = _metrics.counter("replicate.chunks_sent")
_P_BYTES_SENT = _metrics.counter("replicate.bytes_sent")
_P_CHUNKS_STORED = _metrics.counter("replicate.chunks_stored")
_P_BYTES_STORED = _metrics.counter("replicate.bytes_stored")
_P_MANIFESTS = _metrics.counter("replicate.manifests_stored")
_P_REJECTED = _metrics.counter("replicate.chunks_rejected")
_P_SKIPPED_BUSY = _metrics.counter("replicate.skipped_busy")
_P_ROUNDS = _metrics.counter("replicate.rounds")


# -- wire messages (tags 14-20 in control/wire.py) -----------------------------


@dataclasses.dataclass(frozen=True)
class CheckpointAdvert:
    """Holder -> master: "I hold ``origin``'s delta checkpoint at ``step``".

    Sent by the owner after every delta save (``origin == node_id``) and by
    each replica once a pushed manifest's chunks are all stored locally.
    The master folds adverts into its holder map — the "peer map" half of
    :class:`ManifestReply`. Carries the manifest itself so the newest state
    survives the loss of BOTH the owner's process and its disk (the master
    can hand the manifest to the rejoiner; replicas hold the bytes)."""

    node_id: int
    origin: int
    step: int
    manifest_json: str


@dataclasses.dataclass(frozen=True)
class ManifestRequest:
    """Rejoining node -> master: what is my newest checkpoint, who holds it?"""

    node_id: int


@dataclasses.dataclass(frozen=True)
class ManifestReply:
    """Master -> node: newest known manifest for the requester + peer map.

    ``step < 0`` means the master knows of no checkpoint for this node
    (fresh cluster, or every holder is gone) — the node starts from
    scratch. ``holders`` excludes the requester and unreachable members."""

    step: int
    manifest_json: str
    holders: tuple[int, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "holders", tuple(self.holders))


@dataclasses.dataclass(frozen=True)
class ChunkFetch:
    """Node -> peer chunk service (``ckpt:<holder>``): pull one blob."""

    sha: str
    requester: int


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkData:
    """One blob's bytes on the wire (fetch reply, or replication push).

    ``payload`` is the raw ``.npy`` file bytes; on the wire it travels as a
    length-prefixed byte segment with the additive u32 checksum the payload
    tags use (decode rejects flips), encoded as a zero-copy memoryview
    segment through ``encode_frame_parts``. ``push`` distinguishes a
    replication push (store it; ``step``/``origin`` say what it belongs to)
    from a fetch reply (resolve the requester's pending pull)."""

    sha: str
    payload: Any  # bytes | memoryview | np.ndarray(u8) view into recv buffer
    origin: int = -1
    step: int = -1
    push: bool = False


@dataclasses.dataclass(frozen=True)
class ChunkMissing:
    """Peer -> node: the requested blob is not here (failover signal —
    the requester tries the next holder immediately, no timeout burned)."""

    sha: str
    holder: int


@dataclasses.dataclass(frozen=True)
class ReplicaManifest:
    """Owner -> replica: every chunk of ``step`` has been pushed; store the
    manifest durably and advertise yourself to the master as a holder."""

    step: int
    manifest_json: str
    origin: int


@dataclasses.dataclass(frozen=True)
class AdvertSolicit:
    """Master -> node: re-send your :class:`CheckpointAdvert`\\ s now.

    A replacement master binds the seed endpoint with an EMPTY holder
    registry; until nodes happen to re-advertise (which normally rides the
    rejoin Welcome) it would answer ``ManifestRequest`` with a dead end.
    The master therefore solicits adverts on first contact with an unknown
    node and whenever a manifest request finds no live holder — so a
    restore issued immediately after a master restart still converges on
    the surviving replicas (RESILIENCE.md "Tier 4")."""

    reason: str = ""


def leaf_sha(arr: np.ndarray) -> str:
    """Content hash of one checkpoint leaf: sha256 over ``(dtype, shape)``
    then the raw buffer. It is the blob name in a delta manifest: keep it
    byte-compatible with every manifest ever written."""
    arr = np.asarray(arr)
    # hash the raw buffer through a memoryview (no copy); ascontiguousarray
    # turns a 0-d array into 1-d, so it is only the hashing view
    buf = arr if arr.flags["C_CONTIGUOUS"] else np.ascontiguousarray(arr)
    h = hashlib.sha256(str((arr.dtype, arr.shape)).encode())
    h.update(buf.data)
    return h.hexdigest()


def npy_bytes(arr: np.ndarray) -> bytes:
    """The ``.npy`` file bytes of ``arr`` (what a blob file holds)."""
    bio = io.BytesIO()
    np.save(bio, np.asarray(arr), allow_pickle=False)
    return bio.getvalue()


def npy_sha(data: bytes | bytearray | memoryview) -> str:
    """Content hash of ``.npy`` bytes: a blob whose bytes do not hash back
    to its manifest name is corrupt or wrong and must not be published.
    Raises ``ValueError`` on bytes that are not a loadable ``.npy``."""
    return leaf_sha(np.load(io.BytesIO(bytes(data)), allow_pickle=False))


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists, not ours
        return True
    return True


def note_disk_restore(seconds: float) -> None:
    """Record a restore from the local disk in the ``restore.*`` metrics."""
    _R_FROM_DISK.inc()
    _R_SECONDS.set(seconds)


def fsync_write(path: Path, data: bytes) -> None:
    """Write ``data`` to ``path`` and fsync it before returning, so that a
    later atomic rename never publishes a name whose bytes are still only in
    the page cache when the machine dies."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def fsync_dir(directory: Path) -> None:
    """fsync a directory, so the names created or renamed in it survive a
    crash too."""
    try:
        dirfd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(dirfd)
    except OSError:  # pragma: no cover - directory fsync unsupported
        pass
    finally:
        os.close(dirfd)


def publish_file(tmp: Path, final: Path) -> None:
    """Durable atomic publish: rename the fsynced temp file into place and
    fsync the directory."""
    os.replace(tmp, final)
    fsync_dir(final.parent)


class ChunkStore:
    """Content-addressed blob and manifest store in the delta layout:
    ``blobs/<sha>.npy`` holds each distinct leaf once and
    ``manifest_<step>.json`` maps leaf paths to blob names. The store also
    holds replica manifests of other nodes (``manifest_<origin>_<step>.json``)
    without colliding with its own. Blob and manifest writes are durable
    (fsync before the atomic rename)."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = Path(directory).absolute()
        self.blobs = self.directory / "blobs"
        self.blobs.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    # -- blobs ----------------------------------------------------------------

    def blob_path(self, sha: str) -> Path:
        if not sha or any(c in sha for c in "/\\."):
            # blob names come from outside: a hostile one must never become
            # a path traversal
            raise ValueError(f"malformed blob sha {sha!r}")
        return self.blobs / f"{sha}.npy"

    def has(self, sha: str) -> bool:
        return self.blob_path(sha).exists()

    def read(self, sha: str) -> bytes:
        return self.blob_path(sha).read_bytes()

    def write(self, sha: str, data: bytes | memoryview, *, verify: bool = True) -> bool:
        """Store one blob; False when it was already present. ``verify``
        re-derives the content hash from ``data`` and refuses a mismatch
        (``ValueError``)."""
        blob = self.blob_path(sha)
        if blob.exists():
            return False
        raw = bytes(data)
        if verify and npy_sha(raw) != sha:
            raise ValueError(f"chunk bytes do not hash to {sha[:12]}…")
        tmp = blob.with_suffix(f".tmp{os.getpid()}")
        fsync_write(tmp, raw)
        publish_file(tmp, blob)
        return True

    # -- manifests ------------------------------------------------------------

    @staticmethod
    def _manifest_steps(names, origin: int | None) -> dict[int, Path]:
        out = {}
        for f in names:
            parts = f.stem.split("_")
            try:
                if origin is None and len(parts) == 2:
                    out[int(parts[1])] = f
                elif origin is not None and len(parts) == 3 and int(parts[1]) == origin:
                    out[int(parts[2])] = f
            except ValueError:
                continue
        return out

    def manifests(self, origin: int | None = None) -> dict[int, Path]:
        return self._manifest_steps(self.directory.glob("manifest_*.json"), origin)

    def replica_origins(self) -> set[int]:
        """Every origin id this store holds replica manifests for."""
        out: set[int] = set()
        for f in self.directory.glob("manifest_*.json"):
            parts = f.stem.split("_")
            if len(parts) == 3:
                try:
                    out.add(int(parts[1]))
                except ValueError:
                    continue
        return out

    def latest(self, origin: int | None = None) -> tuple[int, str] | None:
        """The newest ``(step, manifest_json)``, or None."""
        steps = self.manifests(origin)
        if not steps:
            return None
        step = max(steps)
        return step, steps[step].read_text()

    def write_manifest(self, step: int, manifest_json: str, origin: int | None = None) -> Path:
        name = f"manifest_{step}.json" if origin is None else f"manifest_{origin}_{step}.json"
        final = self.directory / name
        tmp = self.directory / f".{name}.tmp{os.getpid()}"
        fsync_write(tmp, manifest_json.encode())
        publish_file(tmp, final)
        return final

    def missing(self, manifest_json: str) -> list[str]:
        """The blob names the manifest references that are absent here."""
        out: list[str] = []
        for sha in dict.fromkeys(json.loads(manifest_json)["leaves"].values()):
            if not self.has(sha):
                out.append(sha)
        return out

    # -- flat state -------------------------------------------------------------

    def save_state(self, step: int, state: dict[str, np.ndarray]) -> dict:
        """Delta-save a flat ``{name: array}`` dict as the owner's manifest
        ``manifest_<step>.json``; returns ``{written_bytes, reused_bytes,
        written_leaves, reused_leaves}``."""
        manifest = {"step": step, "custom": False, "leaves": {}}
        stats = dict(written_bytes=0, reused_bytes=0, written_leaves=0, reused_leaves=0)
        for key, arr in state.items():
            arr = np.asarray(arr)
            sha = leaf_sha(arr)
            if self.write(sha, npy_bytes(arr), verify=False):
                stats["written_bytes"] += arr.nbytes
                stats["written_leaves"] += 1
            else:
                stats["reused_bytes"] += arr.nbytes
                stats["reused_leaves"] += 1
            manifest["leaves"][key] = sha
        self.write_manifest(step, json.dumps(manifest))
        self.prune()
        return stats

    def load_state(self, step: int | None = None) -> tuple[int, dict[str, np.ndarray]]:
        """Inverse of :meth:`save_state`: ``(step, {name: array})``."""
        steps = self.manifests()
        step = max(steps) if step is None and steps else step
        if step is None or step not in steps:
            raise FileNotFoundError(f"no manifest for step {step} under {self.directory}")
        manifest = json.loads(steps[step].read_text())
        return step, {
            key: np.load(self.blob_path(sha), allow_pickle=False)
            for key, sha in manifest["leaves"].items()
        }

    def prune(self) -> None:
        """Keep ``max_to_keep`` manifests per owner and origin, then drop
        every blob no kept manifest references, and the temp files of dead
        writers. Tolerates files vanishing underneath it."""
        kept: list[Path] = []
        for origin in (None, *sorted(self.replica_origins())):
            steps = self.manifests(origin)
            for step in sorted(steps)[: -self.max_to_keep]:
                steps.pop(step).unlink(missing_ok=True)
            kept.extend(steps.values())
        live: set[str] = set()
        for f in kept:
            try:
                live.update(json.loads(f.read_text())["leaves"].values())
            except FileNotFoundError:
                continue
        for blob in self.blobs.glob("*.npy"):
            if blob.stem not in live:
                blob.unlink(missing_ok=True)
        for stale in self.blobs.glob("*.tmp*"):
            # a shared root may hold another live writer's in-flight temp:
            # sweep only temps whose pid is dead or ours, never bare ".tmp"
            # files (the delta checkpointer's own prune owns those)
            suffix = stale.name.rpartition(".tmp")[2]
            if not suffix.isdigit():
                continue
            if int(suffix) != os.getpid() and _pid_alive(int(suffix)):
                continue
            stale.unlink(missing_ok=True)


def copy_delta(
    src: ChunkStore,
    dst: ChunkStore,
    *,
    step: int | None = None,
    origin: int | None = None,
    dst_origin: int | None = None,
    verify: bool = True,
) -> dict:
    """Copy one manifest's chunks between two local stores, through the same
    verify-before-publish gate as a transfer between nodes. Returns
    ``{step, chunks_copied, bytes_copied, chunks_skipped}``."""
    if step is None:
        latest = src.latest(origin)
        if latest is None:
            raise FileNotFoundError(f"no manifest under {src.directory}")
        step, manifest_json = latest
    else:
        steps = src.manifests(origin)
        if step not in steps:
            raise FileNotFoundError(f"no manifest for step {step}")
        manifest_json = steps[step].read_text()
    stats = {"step": step, "chunks_copied": 0, "bytes_copied": 0, "chunks_skipped": 0}
    for sha in dict.fromkeys(json.loads(manifest_json)["leaves"].values()):
        data = src.read(sha)
        if dst.write(sha, data, verify=verify):
            stats["chunks_copied"] += 1
            stats["bytes_copied"] += len(data)
        else:
            stats["chunks_skipped"] += 1
    dst.write_manifest(step, manifest_json, dst_origin)
    dst.prune()
    return stats


_TIMEOUT = object()  # sentinel a timed-out pending future resolves to


class ChunkService:
    """One node's chunk endpoint: serves fetches, absorbs pushes, pulls
    restores, replicates saves. Registered on the transport at
    ``ckpt:<node_id>``; peers resolve that address through the ordinary
    address book (``set_prefix_route("ckpt", ...)``), so chunk traffic
    rides the same zero-copy data plane — and the same chaos layer — as
    round payloads.

    All async entry points are driven by the owner through
    ``observed_task`` (arlint ASYNC003); the handler itself is sync and
    returns reply envelopes, like every other handler in the package.
    """

    #: seconds one fetch attempt waits before burning a retry
    chunk_timeout_s = 5.0
    #: chunks pulled concurrently during a peer restore
    fetch_parallel = 8

    def __init__(
        self,
        transport,
        node_id: int,
        store: ChunkStore,
        *,
        replicas: int = 2,
        retry: RetryPolicy | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.transport = transport
        self.node_id = node_id
        self.store = store
        self.replicas = replicas
        self.retry = retry if retry is not None else RetryPolicy(max_retries=3)
        self.clock = clock
        self._pending: dict[str, asyncio.Future] = {}
        self._manifest_fut: asyncio.Future | None = None
        # per-peer shas already pushed this process lifetime: the delta
        # semantics of replication — an unchanged leaf costs zero bytes on
        # the wire after its first push
        self._pushed: dict[int, set[str]] = {}
        # newest manifest step each peer has been handed (lap-skip check)
        self._sent_manifest: dict[int, int] = {}
        self._replicating = False
        #: stats of the most recent completed peer restore (diagnostics)
        self.last_restore: dict | None = None

    # -- addressing ------------------------------------------------------------

    @staticmethod
    def addr(node_id: int) -> str:
        return f"ckpt:{node_id}"

    def replica_peers(self, known: list[int]) -> list[int]:
        """The next ``replicas`` node ids after us on the id ring — a
        stable choice every member computes identically from the address
        book, so holder sets stay predictable across the cluster."""
        ring = sorted(n for n in known if n != self.node_id)
        if not ring:
            return []
        start = 0
        for i, nid in enumerate(ring):
            if nid > self.node_id:
                start = i
                break
        return [ring[(start + k) % len(ring)] for k in range(min(self.replicas, len(ring)))]

    # -- the sync handler (registered at ckpt:<id>) ----------------------------

    def handle(self, msg: Any) -> list[Envelope]:
        if isinstance(msg, ChunkFetch):
            return self._on_fetch(msg)
        if isinstance(msg, ChunkData):
            return self._on_chunk(msg)
        if isinstance(msg, ChunkMissing):
            fut = self._pending.pop(msg.sha, None)
            if fut is not None and not fut.done():
                _R_FAILOVERS.inc()
                fut.set_result(None)  # failover: try the next holder now
            else:
                # unsolicited: replica feedback that a chunk we dedup-
                # skipped is NOT there (its process — maybe its disk —
                # restarted). Drop it from the per-peer pushed set so the
                # next replication round re-pushes it; without this a
                # reborn replica would never be made whole and silently
                # fall out of the replication factor.
                pushed = self._pushed.get(msg.holder)
                if pushed is not None and msg.sha in pushed:
                    pushed.discard(msg.sha)
            return []
        if isinstance(msg, ReplicaManifest):
            return self._on_replica_manifest(msg)
        if isinstance(msg, ManifestReply):
            fut = self._manifest_fut
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return []
        raise TypeError(f"chunk service cannot handle {type(msg).__name__}")

    def _on_fetch(self, msg: ChunkFetch) -> list[Envelope]:
        reply_to = self.addr(msg.requester)
        if not self.store.has(msg.sha):
            _flight.note("chunk_miss", sha=msg.sha[:12], requester=msg.requester)
            return [Envelope(reply_to, ChunkMissing(msg.sha, self.node_id))]
        data = self.store.read(msg.sha)
        _R_CHUNKS_SERVED.inc()
        _R_BYTES_SERVED.inc(len(data))
        return [Envelope(reply_to, ChunkData(msg.sha, data))]

    def _on_chunk(self, msg: ChunkData) -> list[Envelope]:
        if not msg.push:  # fetch reply: hand the bytes to the waiting pull
            fut = self._pending.pop(msg.sha, None)
            if fut is not None and not fut.done():
                # copy out of the recv buffer NOW: the pump recycles it the
                # moment this handler returns, and the future's consumer
                # runs later
                fut.set_result(bytes(msg.payload))
            return []
        # replication push: verify-before-publish, count a rejection
        # instead of storing poison (the origin's next push retries).
        # Materialize the recv-buffer view ONCE — it is the per-push copy.
        raw = bytes(msg.payload)
        try:
            self.store.write(msg.sha, raw, verify=True)
        except ValueError:
            log.warning(
                "rejected pushed chunk %s from node %d (content hash "
                "mismatch)", msg.sha[:12], msg.origin,
            )
            _P_REJECTED.inc()
            return []
        _P_CHUNKS_STORED.inc()
        _P_BYTES_STORED.inc(len(raw))
        return []

    def _on_replica_manifest(self, msg: ReplicaManifest) -> list[Envelope]:
        missing = self.store.missing(msg.manifest_json)
        if missing:
            # pushes are at-most-once: an incomplete replica must NOT
            # advertise itself as a holder. Report what is missing back to
            # the origin so its per-peer push dedup forgets those chunks —
            # a replica reborn without its disk gets re-pushed on the
            # origin's next replication round instead of never (bounded:
            # the next rounds re-report anything beyond the cap)
            log.info(
                "replica of node %d step %d incomplete here (%d chunks "
                "missing); not advertising", msg.origin, msg.step, len(missing),
            )
            return [
                Envelope(self.addr(msg.origin), ChunkMissing(sha, self.node_id))
                for sha in missing[:256]
            ]
        self.store.write_manifest(msg.step, msg.manifest_json, msg.origin)
        self.store.prune()
        _P_MANIFESTS.inc()
        _flight.note(
            "replica_stored", origin=msg.origin, step=msg.step,
        )
        return [
            Envelope(
                "master",
                CheckpointAdvert(
                    self.node_id, msg.origin, msg.step, msg.manifest_json
                ),
            )
        ]

    # -- replication (owner side) ----------------------------------------------

    def replicate_busy(self) -> bool:
        return self._replicating

    #: catch-up laps one replicate_latest call may run when saves keep
    #: landing while a lap is in flight (bounds the loop, not correctness:
    #: the next save kicks another call)
    replicate_max_laps = 4

    async def replicate_latest(self, peers: list[int]) -> dict | None:
        """Push the newest local manifest's chunks to ``peers`` then hand
        them the manifest; skipped (counted) when a previous replication is
        still in flight — replication must bound bandwidth, not queue
        behind itself.

        Saves can outpace a lap (a push of MBs through a busy data plane
        sits behind backpressure), so this loops: each lap re-reads the
        CURRENT latest manifest, and a lap that discovers a needed blob
        was pruned mid-flight ABORTS without sending the manifest — a
        knowingly-incomplete step is never advertised — and the next lap
        chases the newer step whose blobs exist. Returns the last lap's
        stats or None when skipped/empty."""
        if self._replicating:
            _P_SKIPPED_BUSY.inc()
            return None
        if not peers:
            return None
        self._replicating = True
        stats = None
        try:
            for _ in range(self.replicate_max_laps):
                latest = self.store.latest()
                if latest is None:
                    break
                step, manifest_json = latest
                if all(
                    self._sent_manifest.get(p, -1) >= step for p in peers
                ):
                    break  # every peer already has the current latest
                stats = await self._replicate(step, manifest_json, peers)
                if not stats.pop("stale", False):
                    break
        finally:
            self._replicating = False
        return stats

    async def _replicate(
        self, step: int, manifest_json: str, peers: list[int]
    ) -> dict:
        stats = {"step": step, "peers": list(peers), "chunks_sent": 0, "bytes_sent": 0}
        shas = list(dict.fromkeys(json.loads(manifest_json)["leaves"].values()))
        for peer in peers:
            pushed = self._pushed.setdefault(peer, set())
            for sha in shas:
                if sha in pushed:
                    continue
                try:
                    data = self.store.read(sha)
                except FileNotFoundError:
                    # pruned while this lap slept in backpressure: this
                    # step can no longer be made whole anywhere — abort
                    # WITHOUT the manifest send (never advertise a step we
                    # know is incomplete) and let the caller's next lap
                    # push the newer step that superseded it
                    stats["stale"] = True
                    return stats
                # transport.send applies high-water backpressure: a slow
                # replica throttles this loop instead of ballooning memory
                await self.transport.send(
                    Envelope(
                        self.addr(peer),
                        ChunkData(
                            sha, data, origin=self.node_id, step=step, push=True
                        ),
                    )
                )
                pushed.add(sha)
                stats["chunks_sent"] += 1
                stats["bytes_sent"] += len(data)
                _P_CHUNKS_SENT.inc()
                _P_BYTES_SENT.inc(len(data))
            await self.transport.send(
                Envelope(
                    self.addr(peer),
                    ReplicaManifest(step, manifest_json, self.node_id),
                )
            )
            self._sent_manifest[peer] = max(
                self._sent_manifest.get(peer, -1), step
            )
        _P_ROUNDS.inc()
        _flight.note("replicate", step=step, peers=stats["peers"])
        return stats

    def note_send_failure(self, env: Envelope) -> None:
        """Transport ``on_send_error`` hook: a replication push that never
        reached the wire (backpressure drop, dead connection, partition)
        must be un-marked in the per-peer dedup set, or the chunk would be
        skipped on every later round while the replica stays incomplete —
        the send-time optimism of the dedup is only sound because every
        OBSERVABLE loss is repaired here (silent chaos drops are repaired
        by the replica's ChunkMissing feedback instead)."""
        msg = env.msg
        _, _, suffix = env.dest.rpartition(":")
        if not suffix.lstrip("-").isdigit():
            return
        peer = int(suffix)
        if isinstance(msg, ChunkData) and msg.push:
            self._pushed.get(peer, set()).discard(msg.sha)
        elif isinstance(msg, ReplicaManifest):
            if self._sent_manifest.get(peer, -1) <= msg.step:
                self._sent_manifest.pop(peer, None)  # re-send next lap

    # -- manifest discovery (rejoiner side) ------------------------------------

    async def request_manifest(
        self, *, attempts: int = 3, timeout_s: float | None = None
    ) -> ManifestReply | None:
        """Ask the master for our newest manifest + holders; None when the
        master never answered (it may itself be restarting — the caller
        decides whether to retry later or start fresh)."""
        timeout = self.chunk_timeout_s if timeout_s is None else timeout_s
        for attempt in range(max(1, attempts)):
            loop = asyncio.get_running_loop()
            fut: asyncio.Future = loop.create_future()
            self._manifest_fut = fut
            try:
                await self.transport.send(
                    Envelope("master", ManifestRequest(self.node_id))
                )
                reply = await _wait_result(fut, timeout)
            finally:
                self._manifest_fut = None
            if reply is not _TIMEOUT and reply is not None:
                return reply
            if attempt + 1 < attempts:
                await asyncio.sleep(
                    self.retry.backoff_s(attempt, random.random())
                )
        return None

    # -- peer restore (rejoiner side) ------------------------------------------

    async def _fetch_chunk(self, sha: str, holders: list[int]) -> bool:
        """Pull one blob: per-chunk retry budget over the holder list (a
        missing/unreachable holder fails over to the next), content-verify,
        publish. True on success."""
        if not holders:
            return self.store.has(sha)
        budget = self.retry.max_retries + 1
        # stagger the starting holder per chunk (derived from the sha):
        # without this every concurrent pull hammers holders[0] while the
        # other replicas sit idle — spreading costs nothing and halves the
        # busiest peer's serve load at K=2
        start = sum(sha.encode()) % len(holders)
        for attempt in range(budget * len(holders)):
            if self.store.has(sha):
                return True  # a concurrent pull (or a push) beat us to it
            holder = holders[(start + attempt) % len(holders)]
            loop = asyncio.get_running_loop()
            fut: asyncio.Future = loop.create_future()
            self._pending[sha] = fut
            try:
                await self.transport.send(
                    Envelope(self.addr(holder), ChunkFetch(sha, self.node_id))
                )
                data = await _wait_result(fut, self.chunk_timeout_s)
            finally:
                self._pending.pop(sha, None)
            if isinstance(data, (bytes, bytearray)):
                try:
                    self.store.write(sha, data, verify=True)
                except ValueError:
                    _R_REJECTED.inc()
                    log.warning(
                        "chunk %s from node %d failed content verification; "
                        "re-fetching", sha[:12], holder,
                    )
                    continue
                _R_CHUNKS_FETCHED.inc()
                _R_BYTES_FETCHED.inc(len(data))
                return True
            if data is _TIMEOUT:
                _R_RETRIES.inc()
                await asyncio.sleep(
                    self.retry.backoff_s(attempt % budget, random.random())
                )
            # None = ChunkMissing failover — loop to the next holder at once
        return False

    async def restore_from_peers(
        self, step: int, manifest_json: str, holders: list[int]
    ) -> dict:
        """Pull every chunk of ``manifest_json`` this store is missing from
        ``holders`` (parallel, bounded), verify, publish the manifest, and
        advertise ourselves to the master. Resumable by construction:
        already-present chunks (a partial earlier attempt, or replication
        pushes that landed here) are skipped, so a partition mid-restore
        costs only the chunks not yet fetched. Returns stats; ``complete``
        False when some chunks stayed unfetchable (caller retries with a
        fresh holder map)."""
        t0 = time.perf_counter()
        need = self.store.missing(manifest_json)
        sem = asyncio.Semaphore(self.fetch_parallel)
        results: dict[str, bool] = {}

        async def pull(sha: str) -> None:
            async with sem:
                results[sha] = await self._fetch_chunk(sha, list(holders))

        with _trace.span(
            "restore.peer", step=step, chunks=len(need), node=self.node_id
        ):
            if need and holders:
                await asyncio.gather(*(pull(sha) for sha in need))
        fetched = sum(1 for ok in results.values() if ok)
        complete = not need or (holders and all(results.values()))
        stats = {
            "source": "peer",
            "step": step,
            "seconds": round(time.perf_counter() - t0, 3),
            "chunks_needed": len(need),
            "chunks_fetched": fetched,
            "complete": bool(complete),
        }
        if complete:
            self.store.write_manifest(step, manifest_json)
            self.store.prune()
            _R_FROM_PEER.inc()
            _R_SECONDS.set(stats["seconds"])
        self.last_restore = stats
        _flight.note("restore_peer", **{k: stats[k] for k in ("step", "seconds", "chunks_fetched", "complete")})
        return stats


async def _wait_result(fut: asyncio.Future, timeout: float):
    """Await ``fut`` with a deadline, resolving to the ``_TIMEOUT``
    sentinel instead of raising. Deliberately NOT ``asyncio.wait_for``: on
    Python < 3.12 it can swallow an external task cancellation that races
    the future's completion (a transport deadlock class) — a plain
    ``await`` with a manual timer propagates cancellation verbatim."""
    loop = asyncio.get_running_loop()
    timer = loop.call_later(
        timeout, lambda: None if fut.done() else fut.set_result(_TIMEOUT)
    )
    try:
        return await fut
    finally:
        timer.cancel()
