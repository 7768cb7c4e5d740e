"""Checkpoints and resume for the port's trainers.

Counterpart of ``akka_allreduce_tpu/train/checkpoint.py``. A trainer's state
is captured under one of two protocols (:func:`capture_state`):

- **the trainer-defined protocol** (``checkpoint_state`` /
  ``restore_checkpoint_state``, ``Zero1DPTrainer``): the trainer hands over
  its own host (numpy) tree, independent of the rank count;
- **the pytree form** (``DPTrainer``, ``LongContextTrainer``):
  ``{"params", "opt_state"[, "ef"]}`` where ``params`` are the model's
  parameters by name, ``opt_state`` is ``optimizer.state_dict()["state"]``
  (per parameter index, its tensors: Adam's ``step``, ``exp_avg``,
  ``exp_avg_sq``) and ``ef`` is the ``(n, P)`` error-feedback residual. The
  param groups' hyper-parameters are kept alongside, from the live
  optimizer, as optax keeps them in its transform and not in its state.
  Restore places each leaf on the trainer's device in its dtype (torch's
  ``load_state_dict`` policy for the optimizer: Adam's ``step`` stays a CPU
  tensor unless the optimizer is capturable); virtual ranks have no
  shardings.

A leaf is addressed by its key path in ``jax.tree_util.keystr``'s spelling
(``['params']['dense.0.kernel']``, ``['opt_state'][0].mu``), so a delta
manifest of the trainer-defined protocol carries the JAX trainer's keys.

Stores:

- :class:`TrainerCheckpointer`: one directory a step (``<dir>/<step>/``,
  an ``index.json`` naming one ``.npy`` file a leaf), every file fsynced,
  then the step published by an atomic rename of its temp directory: a
  writer killed mid-save leaves the previous step as ``latest_step``. The
  JAX package writes Orbax checkpoints here; the port cannot read them.
- :class:`DeltaCheckpointer`: the content-addressed layout of
  ``control/statetransfer.py`` (``blobs/<sha>.npy``, ``manifest_<step>.json``),
  byte-compatible with the JAX store.
- :class:`AsyncTrainerCheckpointer`, :class:`AsyncDeltaCheckpointer`: the
  same stores with the save off the step loop (:func:`async_capture`).
- :class:`Snapshot`: a host copy that survives the trainer and restores
  into a new one over another rank count.

On the card the optimizers update the parameters in place, so a copy read
straight from a live tensor would race the next ``optimizer.step()``. The
async capture therefore clones every leaf on the current stream (device to
device, ordered after the step that produced it), and the writer thread
copies the clones on a side stream, which waits for the clones' event, into
pinned host buffers that are reused from one save to the next, then joins
that copy's event, not the device. The clones live until the event fires.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from akka_allreduce_tpu_torch.control.statetransfer import (
    _pid_alive,
    fsync_dir,
    fsync_write,
    leaf_sha,
    publish_file,
)

# -- key paths ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a leaf: a restore template's leaf."""

    shape: tuple[int, ...]
    dtype: Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_keys(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """Apply ``fn(key, leaf)`` to every leaf of ``tree`` (dicts, lists,
    tuples and named tuples; None is an empty subtree), keeping its
    structure. ``key`` is the leaf's path as ``jax.tree_util.keystr``
    spells it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_keys(fn, getattr(tree, f), f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_keys(fn, v, f"{prefix}[{i}]") for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def tree_items(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` of every leaf, in ``jax.tree_util``'s order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_items(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in tree_items(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_items(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


_KEY_PART = re.compile(r"\[('(?:[^'\\]|\\.)*'|-?\d+)\]|\.(\w+)")


def parse_key(key: str) -> tuple:
    """The parts of a key path: ``"['a'][0].mu"`` -> ``('a', 0, 'mu')``."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            break
        parts.append(ast.literal_eval(m.group(1)) if m.group(1) is not None else m.group(2))
        pos = m.end()
    if pos != len(key):
        raise ValueError(f"malformed leaf key {key!r}")
    return tuple(parts)


# -- capture ---------------------------------------------------------------------


def _numpy_dtype(t: torch.Tensor) -> None:
    """Refuse a tensor numpy cannot hold (bf16, ...) rather than cast it."""
    try:
        torch.empty(0, dtype=t.dtype).numpy()
    except TypeError as e:
        raise TypeError(
            f"a checkpoint leaf has dtype {t.dtype}, which numpy cannot hold; "
            "the capture refuses to cast it") from e


def host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own (a copy: the live tensor goes
    on changing in place; from the card the copy is synchronous)."""
    if isinstance(leaf, torch.Tensor):
        _numpy_dtype(leaf)
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def host_tree(tree):
    """Every leaf of ``tree`` as a host numpy array of its own."""
    return tree_map_with_keys(lambda _, x: host_array(x), tree)


def optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()["state"]``: per parameter index, its state
    tensors (the live tensors, not copies)."""
    out = {}
    for idx, entry in optimizer.state_dict()["state"].items():
        leaves = {}
        for name, value in entry.items():
            if value is None:
                continue
            if not isinstance(value, torch.Tensor):
                raise TypeError(
                    f"optimizer state {name!r} of parameter {idx} is a "
                    f"{type(value).__name__}, not a tensor; it has no checkpoint form")
            leaves[name] = value
        out[idx] = leaves
    return out


def capture_state(trainer) -> tuple[dict, bool]:
    """``(state, custom)``: the state tree of ``trainer`` under either
    protocol, the one place that knows what a trainer's state is.
    ``custom=True``: the trainer's own ``checkpoint_state()`` (host numpy);
    otherwise ``{params, opt_state[, ef]}`` of live tensors."""
    if hasattr(trainer, "checkpoint_state"):
        return dict(trainer.checkpoint_state()), True
    state = {
        "params": {name: p.detach() for name, p in trainer.model.named_parameters()},
        "opt_state": optimizer_state(trainer.optimizer),
    }
    if getattr(trainer, "_ef", None) is not None:
        # the residual is training state: dropping it on restart would lose
        # every withheld gradient
        state["ef"] = trainer._ef
    return state, False


class HostBuffers:
    """Pinned host buffers a leaf, kept from one save to the next, and the
    side stream the copies into them run on."""

    def __init__(self) -> None:
        self.buffers: dict[str, torch.Tensor] = {}
        self._streams: dict[torch.device, torch.cuda.Stream] = {}

    def buffer(self, key: str, like: torch.Tensor) -> torch.Tensor:
        buf = self.buffers.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self.buffers[key] = buf
        return buf

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]


class DeviceCopy:
    """A capture-time copy of a state tree, drained to the host later.

    Each tensor leaf is cloned where it lives, on the current stream: on the
    card that is a device-to-device copy ordered after the work that wrote
    the leaf, so later in-place optimizer steps cannot reach it. An event on
    that stream marks the clones ready. :meth:`to_host` (the writer thread)
    copies the card's clones into pinned buffers on a side stream that waits
    for that event, joins the copies' own event, and hands back numpy views
    of the buffers; CPU clones are handed back as they are."""

    def __init__(self, tree) -> None:
        devices: set[torch.device] = set()

        def clone(_, leaf):
            if not isinstance(leaf, torch.Tensor):
                return np.asarray(leaf)
            _numpy_dtype(leaf)
            out = leaf.detach().clone()
            if out.is_cuda:
                devices.add(out.device)
            return out

        self._clones = tree_map_with_keys(clone, tree)
        self._ready = {}
        for dev in devices:
            self._ready[dev] = torch.cuda.Event()
            self._ready[dev].record(torch.cuda.current_stream(dev))

    def to_host(self, buffers: HostBuffers):
        """The copy as host numpy arrays; CUDA leaves land in ``buffers``'
        pinned memory, whose arrays are valid until the next save."""
        clones, self._clones = self._clones, None
        out, done = clones, []
        for dev, ready in self._ready.items():
            side = buffers.stream(dev)

            def drain(key, x, dev=dev):
                if isinstance(x, torch.Tensor) and x.device == dev:
                    buf = buffers.buffer(key, x)
                    buf.copy_(x, non_blocking=True)
                    return buf
                return x

            with torch.cuda.stream(side):
                side.wait_event(ready)
                out = tree_map_with_keys(drain, out)
                done.append(torch.cuda.Event())
                done[-1].record(side)
        for ev in done:
            ev.synchronize()
        # only now may the caching allocator hand the clones' memory out again
        del clones
        return tree_map_with_keys(
            lambda _, x: x.numpy() if isinstance(x, torch.Tensor) else x, out)


def async_capture(trainer) -> tuple[DeviceCopy, Callable | None, bool]:
    """``(copy, assemble, custom)`` for the saves that do not stall the step
    loop. Trainers with the shard-local protocol (``checkpoint_capture`` /
    ``checkpoint_assemble``, ``Zero1DPTrainer``) capture their own device
    state, and ``assemble`` turns its host form into the serialized one on
    the writer thread; pytree-state trainers capture ``{params,
    opt_state[, ef]}`` with ``assemble=None``. ``custom`` is
    :func:`capture_state`'s flag."""
    if hasattr(trainer, "checkpoint_capture"):
        return DeviceCopy(dict(trainer.checkpoint_capture())), trainer.checkpoint_assemble, True
    state, custom = capture_state(trainer)
    return DeviceCopy(state), None, custom


# -- restore ---------------------------------------------------------------------


def _restore_ef(trainer, ef) -> None:
    """Place a restored residual, keeping its sum across a change of rank
    count: it is per-rank withheld gradient mass, so over another count its
    sum (what the sync still owes) is split evenly over the new ranks."""
    ef = np.asarray(ef, np.float32)
    n = trainer.n_devices
    if ef.shape[0] != n:
        ef = np.tile(ef.sum(axis=0, keepdims=True) / n, (n, 1))
    trainer._ef = torch.from_numpy(np.ascontiguousarray(ef)).to(trainer.device, copy=True)


def place_state(trainer, params: Mapping, opt_state: Mapping, ef=None) -> None:
    """Place a pytree-form state into ``trainer``: each parameter copied in
    place (its device and dtype kept), the optimizer's state through
    ``load_state_dict`` with the live param groups, and the residual (zeros
    when the state carries none, so a stale live one cannot leak in)."""
    named = dict(trainer.model.named_parameters())
    if set(params) != set(named):
        raise KeyError(
            f"checkpoint parameters {sorted(set(params) ^ set(named))} do not match "
            "the trainer's (trainer structure mismatch)")
    with torch.no_grad():
        for name, p in named.items():
            arr = np.asarray(params[name])
            if arr.shape != tuple(p.shape):
                raise ValueError(f"parameter {name!r}: checkpoint shape {arr.shape} "
                                 f"!= the trainer's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    opt = trainer.optimizer
    opt.load_state_dict({
        "state": {int(idx): {k: torch.from_numpy(np.array(v)) for k, v in entry.items()}
                  for idx, entry in opt_state.items()},
        "param_groups": opt.state_dict()["param_groups"],
    })
    if getattr(trainer, "_ef", None) is not None:
        _restore_ef(trainer, ef if ef is not None else np.zeros(tuple(trainer._ef.shape),
                                                                np.float32))


def _restore_leaves(trainer, leaves: Mapping[str, Callable[[], np.ndarray]], custom: bool,
                    step: int, where: str) -> int:
    """Restore ``trainer`` from a checkpoint's leaves (key -> loader) and set
    its step; the one restore path of every store."""
    def missing(key):
        return KeyError(f"checkpoint at step {step} under {where} has no leaf {key!r} "
                        "(trainer structure mismatch)")

    if custom:
        if not hasattr(trainer, "restore_checkpoint_state"):
            raise TypeError("checkpoint was captured through a trainer-defined "
                            "checkpoint protocol; the restore target has none")
        template = dict(getattr(trainer, "checkpoint_template", trainer.checkpoint_state)())
        optional = getattr(trainer, "checkpoint_optional_keys", frozenset())
        saved_top = {parse_key(key)[0] for key in leaves}
        for k in optional:
            # keys newer builds always write may be absent from older saves
            if k in template and k not in saved_top:
                template.pop(k)

        def load(key, _spec):
            if key not in leaves:
                if "format_version" in optional and "format_version" not in saved_top:
                    raise ValueError(
                        f"checkpoint step {step} under {where} predates this trainer's "
                        "serialized format (no format_version key) and cannot be loaded")
                raise missing(key)
            return leaves[key]()

        trainer.restore_checkpoint_state(tree_map_with_keys(load, template))
    else:
        params, opt_state, ef = {}, {}, None
        for key, fetch in leaves.items():
            parts = parse_key(key)
            if parts[0] == "params" and len(parts) == 2:
                params[parts[1]] = fetch()
            elif parts[0] == "opt_state" and len(parts) == 3:
                opt_state.setdefault(parts[1], {})[parts[2]] = fetch()
            elif parts == ("ef",):
                ef = fetch() if getattr(trainer, "_ef", None) is not None else None
            else:
                raise missing(key)
        for name, _ in trainer.model.named_parameters():
            if name not in params:
                raise missing(f"['params'][{name!r}]")
        place_state(trainer, params, opt_state, ef)
    trainer.step_num = int(step)
    return trainer.step_num


@dataclasses.dataclass
class Snapshot:
    """Host (numpy) snapshot of a trainer's state: it survives the trainer,
    and restores into a new one over another rank count (the residual's sum
    kept; the trainer-defined protocol's form is independent of the count)."""

    params: Any  # {name: np.ndarray} (pytree-state trainers)
    opt_state: Any  # {index: {name: np.ndarray}}
    step: int
    ef: Any = None  # the (n, P) residual, or None
    custom: dict | None = None  # checkpoint_state() of the trainer-defined protocol

    @classmethod
    def capture(cls, trainer) -> "Snapshot":
        state, custom = capture_state(trainer)
        host = host_tree(state)
        if custom:
            return cls(params=None, opt_state=None, step=trainer.step_num, custom=host)
        return cls(params=host["params"], opt_state=host["opt_state"],
                   step=trainer.step_num, ef=host.get("ef"))

    def restore_into(self, trainer) -> None:
        if self.custom is not None:
            if not hasattr(trainer, "restore_checkpoint_state"):
                raise TypeError("snapshot was captured through a trainer-defined "
                                "checkpoint protocol; the restore target has none")
            # restore may pop keys, and a snapshot may be restored twice
            trainer.restore_checkpoint_state(dict(self.custom))
        else:
            place_state(trainer, self.params, self.opt_state, self.ef)
        trainer.step_num = self.step


# -- the full store ----------------------------------------------------------------

_INDEX = "index.json"


def _write_npy(path: Path, arr: np.ndarray) -> None:
    """One leaf's ``.npy`` file, fsynced before it returns."""
    with open(path, "wb") as f:  # np.save(path) would append .npy
        np.save(f, np.asarray(arr), allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())


class TrainerCheckpointer:
    """Durable checkpoints of a trainer's state, one directory a step.

    ``<dir>/<step>/`` holds ``index.json`` (``step``, ``custom``, and each
    leaf's key -> file) and one ``.npy`` file a leaf. A save writes into
    ``<dir>/.<step>.tmp<pid>/``, fsyncs every file and the directory, then
    renames it into place and fsyncs ``<dir>``: a writer killed mid-save
    leaves the previous step as :meth:`latest_step`, and the next save
    sweeps its temp directory. Keeps ``max_to_keep`` steps.

    Usage::

        ckpt = TrainerCheckpointer(dir)
        ckpt.save(trainer)                  # every k steps
        step = ckpt.restore(trainer)        # after a restart
    """

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(d.name) for d in self.directory.iterdir()
                      if d.name.isdigit() and (d / _INDEX).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, trainer, *, force: bool = False, block: bool = True) -> bool:
        """Save the trainer's state at its step; False when that step is
        already saved. ``force`` and ``block`` exist for signature parity
        with the async subclass (this save is synchronous)."""
        if trainer.step_num in self.all_steps():
            return False
        state, custom = capture_state(trainer)
        self._write(host_tree(state), custom, int(trainer.step_num))
        return True

    def _write(self, host, custom: bool, step: int) -> None:
        """Write the host tree as step ``step`` and publish it atomically,
        then prune: the half a background writer runs."""
        tmp = self.directory / f".{step}.tmp{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        leaves = {}
        for i, (key, arr) in enumerate(tree_items(host)):
            name = f"{i:05d}.npy"
            _write_npy(tmp / name, arr)
            leaves[key] = name
        fsync_write(tmp / _INDEX, json.dumps(
            {"step": step, "custom": custom, "leaves": leaves}).encode())
        fsync_dir(tmp)
        os.rename(tmp, self.directory / str(step))
        fsync_dir(self.directory)
        self._prune()

    def _prune(self) -> None:
        for step in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.directory / str(step), ignore_errors=True)
        for stale in self.directory.glob(".*.tmp*"):
            # a crashed writer's temp directory (ours is published by now)
            suffix = stale.name.rpartition(".tmp")[2]
            if suffix.isdigit() and (int(suffix) == os.getpid() or not _pid_alive(int(suffix))):
                shutil.rmtree(stale, ignore_errors=True)

    def restore(self, trainer, step: int | None = None) -> int:
        """Restore the trainer's state in place; returns the restored step."""
        step = self.latest_step() if step is None else step
        if step is None or step not in self.all_steps():
            raise FileNotFoundError(f"no checkpoint for step {step} under {self.directory}")
        where = self.directory / str(step)
        index = json.loads((where / _INDEX).read_text())
        leaves = {key: (lambda name=name: np.load(where / name, allow_pickle=False))
                  for key, name in index["leaves"].items()}
        return _restore_leaves(trainer, leaves, index["custom"], index["step"], str(self.directory))

    def close(self) -> None:
        """Nothing to flush (saves are synchronous)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the delta store ---------------------------------------------------------------


class DeltaCheckpointer:
    """Per-leaf, content-addressed checkpoints: a save writes only the
    leaves whose bytes changed since any kept checkpoint.

    Layout: ``blobs/<sha256>.npy`` holds each distinct leaf once;
    ``manifest_<step>.json`` (``step``, ``custom``, ``leaves``: key -> blob)
    maps leaf paths to blobs. The blob names, bytes and manifests are those
    of ``control.statetransfer.ChunkStore`` and of the JAX package's store.
    Pruning keeps ``max_to_keep`` manifests and drops every blob no kept
    manifest references."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            # sorted(manifests)[:-0] would keep nothing pruned, for ever
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = Path(directory).absolute()
        self.blobs = self.directory / "blobs"
        self.blobs.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _manifests(self) -> dict[int, Path]:
        out = {}
        for f in self.directory.glob("manifest_*.json"):
            try:
                out[int(f.stem.split("_", 1)[1])] = f
            except ValueError:
                continue
        return out

    def latest_step(self) -> int | None:
        steps = self._manifests()
        return max(steps) if steps else None

    def save(self, trainer, *, force: bool = False, block: bool = True) -> dict:
        """Write a delta checkpoint; returns ``{written_bytes, reused_bytes,
        written_leaves, reused_leaves}``. ``force``/``block`` exist for
        signature parity (this save is synchronous and never deduplicated by
        step: an identical re-save reuses every blob)."""
        state, custom = capture_state(trainer)
        return self._write_delta(host_tree(state), custom, int(trainer.step_num))

    def _write_delta(self, host, custom: bool, step: int) -> dict:
        """Hash every leaf, write the new blobs and the manifest, prune: pure
        host work on a host tree, the half a background writer runs.

        Every blob is fsynced before its atomic rename and the manifest
        before its own: a crash mid-save leaves the old manifests intact and
        never publishes one that names a torn or unsynced blob."""
        manifest = {"step": step, "custom": custom, "leaves": {}}
        stats = dict(written_bytes=0, reused_bytes=0, written_leaves=0, reused_leaves=0)
        for key, leaf in tree_items(host):
            arr = np.asarray(leaf)
            sha = leaf_sha(arr)
            blob = self.blobs / f"{sha}.npy"
            if blob.exists():
                stats["reused_bytes"] += arr.nbytes
                stats["reused_leaves"] += 1
            else:
                tmp = blob.with_suffix(".tmp")
                _write_npy(tmp, arr)
                publish_file(tmp, blob)
                stats["written_bytes"] += arr.nbytes
                stats["written_leaves"] += 1
            manifest["leaves"][key] = sha
        tmp = self.directory / f".manifest_{step}.tmp"
        fsync_write(tmp, json.dumps(manifest).encode())
        publish_file(tmp, self.directory / f"manifest_{step}.json")
        self._prune()
        return stats

    def _prune(self) -> None:
        manifests = self._manifests()
        for step in sorted(manifests)[: -self.max_to_keep]:
            manifests.pop(step).unlink()
        live = set()
        for f in manifests.values():
            live.update(json.loads(f.read_text())["leaves"].values())
        for blob in self.blobs.glob("*.npy"):
            if blob.stem not in live:
                blob.unlink()
        # a crash between a temp write and its publish leaves orphans that
        # no manifest names; this save has published its own by now
        for stale in self.blobs.glob("*.tmp"):
            stale.unlink()
        for stale in self.directory.glob(".manifest_*.tmp"):
            stale.unlink()

    def restore(self, trainer, step: int | None = None) -> int:
        manifests = self._manifests()
        step = max(manifests) if step is None and manifests else step
        if step is None or step not in manifests:
            raise FileNotFoundError(f"no delta checkpoint for step {step} under {self.directory}")
        manifest = json.loads(manifests[step].read_text())
        leaves = {key: (lambda sha=sha: np.load(self.blobs / f"{sha}.npy", allow_pickle=False))
                  for key, sha in manifest["leaves"].items()}
        return _restore_leaves(trainer, leaves, manifest["custom"], manifest["step"],
                               str(self.directory))

    def close(self) -> None:
        """Nothing to flush (saves are synchronous)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the async stores ----------------------------------------------------------------


class _BackgroundWriter:
    """One save in flight at a time, on a thread; a background failure is
    raised on the next ``busy``/``save``/``restore``/``close``."""

    def _writer_init(self) -> None:
        self._lock = threading.Lock()  # serializes access to the store
        self._inflight: threading.Thread | None = None
        self._errors: list[BaseException] = []
        #: pinned host buffers of the capture, reused from save to save
        self.host_buffers = HostBuffers()

    def _launch(self, write: Callable[[], None], name: str) -> None:
        def guarded():
            try:
                write()
            except Exception as e:  # surfaced on the next call
                self._errors.append(e)

        t = threading.Thread(target=guarded, name=name, daemon=True)
        self._inflight = t
        t.start()

    def _drain(self) -> None:
        t = self._inflight
        if t is not None:
            t.join()
            self._inflight = None
        if self._errors:
            err = self._errors[:]
            self._errors.clear()
            raise RuntimeError(f"background checkpoint save failed: {err[0]}") from err[0]

    def busy(self) -> bool:
        t = self._inflight
        if t is not None and not t.is_alive():
            self._drain()  # reap, and surface a background error
        return self._inflight is not None

    def wait_until_finished(self) -> None:
        """Block until the save in flight is durable; re-raise its failure."""
        self._drain()

    def _start_save(self, trainer, block: bool, dedup: Callable[[int], bool] | None,
                    write: Callable[[Any, bool, int], None], name: str) -> bool:
        if self.busy():
            if not block:
                return False  # skipped, not queued: the caller saves next interval
            self._drain()
        step = int(trainer.step_num)
        if dedup is not None:
            with self._lock:
                if dedup(step):
                    return False
        copy, assemble, custom = async_capture(trainer)

        def run():
            host = copy.to_host(self.host_buffers)
            state = assemble(host) if assemble is not None else host
            with self._lock:
                write(state, custom, step)

        self._launch(run, f"{name}-{step}")
        if block:
            self._drain()
        return True


class AsyncTrainerCheckpointer(_BackgroundWriter, TrainerCheckpointer):
    """:class:`TrainerCheckpointer` whose saves do not stall the step loop:
    ``save`` captures (:func:`async_capture`: a clone a leaf on the card,
    shard-local for the trainer-defined protocol) and returns; a thread
    drains the clones into pinned host buffers, assembles, writes and
    publishes the step. A ``save`` while one is in flight returns False
    unless ``block=True``; restores and ``close`` drain first."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3) -> None:
        super().__init__(directory, max_to_keep=max_to_keep)
        self._writer_init()

    def save(self, trainer, *, force: bool = False, block: bool = False) -> bool:
        return self._start_save(trainer, block, lambda step: step in self.all_steps(),
                                self._write, "ckpt-save")

    def latest_step(self) -> int | None:
        with self._lock:
            return super().latest_step()

    def restore(self, trainer, step: int | None = None) -> int:
        self._drain()  # a restore must see the newest durable step
        return super().restore(trainer, step)

    def close(self) -> None:
        try:
            self._drain()
        finally:
            self.host_buffers.buffers.clear()  # hand the pinned memory back
            super().close()


class AsyncDeltaCheckpointer(_BackgroundWriter, DeltaCheckpointer):
    """:class:`DeltaCheckpointer` whose hashing and blob writes run off the
    step loop, with the capture of :class:`AsyncTrainerCheckpointer`.
    ``save`` returns True when a background save was launched (False while
    one is in flight); the save's stats land in :attr:`last_stats` once it
    completes."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3) -> None:
        super().__init__(directory, max_to_keep=max_to_keep)
        self._writer_init()
        #: stats dict of the most recently completed save (None before any)
        self.last_stats: dict | None = None

    def save(self, trainer, *, force: bool = False, block: bool = False) -> bool:
        def write(state, custom, step):
            self.last_stats = self._write_delta(state, custom, step)

        return self._start_save(trainer, block, None, write, "delta-save")

    def latest_step(self) -> int | None:
        with self._lock:
            return super().latest_step()

    def restore(self, trainer, step: int | None = None) -> int:
        self._drain()  # a restore must see the newest durable step
        return super().restore(trainer, step)

    def close(self) -> None:
        try:
            self._drain()
        finally:
            self.host_buffers.buffers.clear()  # hand the pinned memory back
            super().close()
