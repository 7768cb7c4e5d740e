"""The content-addressed checkpoint store: blobs, manifests and their hashes.

The port's copy of the store half of ``akka_allreduce_tpu/control/
statetransfer.py``: :func:`leaf_sha`, :func:`npy_bytes`, :func:`npy_sha`,
the durable writes (:func:`fsync_write`, :func:`publish_file`),
:class:`ChunkStore` (owner and replica manifests, ``missing``,
``save_state``/``load_state``, ``prune``'s dead-pid temp sweep),
:func:`copy_delta` and :func:`note_disk_restore`. The wire messages and the
``ChunkService`` that serves chunks between nodes ride the TCP transport,
which is not ported yet.

A blob is the ``.npy`` file of one leaf, named by :func:`leaf_sha` of its
array; a manifest maps leaf paths to blob names. Blob bytes, blob names and
manifest JSON are byte-identical to the JAX store's for the same arrays: a
peer restore verifies fetched bytes against these names, so either
package's store reads the other's. Everything here is numpy and the
standard library.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from pathlib import Path

import numpy as np

from akka_allreduce_tpu_torch.obs import metrics as _metrics

__all__ = [
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
