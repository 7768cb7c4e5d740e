"""The port's checkpoints on the CPU: its store against the JAX package's,
and its four checkpointers round-tripping its trainers.

- ``control/statetransfer.py``: ``leaf_sha``, ``npy_bytes`` and ``npy_sha``
  against the JAX copies on the same arrays; ``ChunkStore.save_state`` of the
  same flat states writes identical manifests and blobs (names and bytes),
  with the same stats, and each package's ``load_state`` reads the other's
  store; ``missing``, replica manifests, ``copy_delta`` across the two
  packages' stores, ``prune``'s temp sweep (dead and own writers only), the
  refusals, and ``note_disk_restore``'s metric names.
- ``train/checkpoint.py`` on ``DPTrainer`` (``MLP(hidden=(32,))`` over
  ``line_mesh(8)``, Adam, int8 with error feedback) and a 2-layer
  ``LongContextTrainer``: for each of the four checkpointers, save at step
  2, go on 2 steps; a fresh trainer (another seed, already stepped) restores
  and takes the same 2 steps: every parameter, optimizer tensor and
  residual equal, bit for bit. The step dedup and ``max_to_keep``; a delta
  save writing only a changed leaf; a crash between blobs (or files)
  publishing nothing; a restore zeroing a stale residual; an async capture
  holding capture-time values; a busy skip; a background failure surfacing;
  ``Snapshot`` over 8 -> 4 ranks keeping the residual's sum; the capture's
  refusal of a bf16 leaf; key paths as ``jax.tree_util.keystr`` spells them.
- The CLI: ``train-mlp``, ``train-zero1``, ``train-lm`` (its on-device
  chain) and ``train-resnet`` (the narrow model) run twice with
  ``--checkpoint-dir``; the second run prints ``resumed from step 4``.
  ``bench-checkpoint`` prints one record with the JAX record's keys.
"""

from __future__ import annotations

import ast
import inspect
import json
import os
import subprocess
import sys
import threading

import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from akka_allreduce_tpu import __main__ as jmain
from akka_allreduce_tpu.control import statetransfer as jst
from akka_allreduce_tpu_torch import models
from akka_allreduce_tpu_torch.__main__ import main as cli_main
from akka_allreduce_tpu_torch.control import statetransfer as tst
from akka_allreduce_tpu_torch.models import MLP, ResNet, lm_copy_task, mnist_like
from akka_allreduce_tpu_torch.obs import metrics as tmetrics
from akka_allreduce_tpu_torch.parallel import line_mesh
from akka_allreduce_tpu_torch.train import (
    AsyncDeltaCheckpointer,
    AsyncTrainerCheckpointer,
    DeltaCheckpointer,
    DPTrainer,
    LongContextTrainer,
    Snapshot,
    TrainerCheckpointer,
)
from akka_allreduce_tpu_torch.train import checkpoint as ckpt

MASK = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
STORES = [TrainerCheckpointer, DeltaCheckpointer, AsyncTrainerCheckpointer,
          AsyncDeltaCheckpointer]
ARRAYS = {
    "f32": np.arange(10, dtype=np.float32) / 3,
    "int32_scalar": np.asarray(7, np.int32),
    "f64_2d": np.linspace(-1, 1, 12).reshape(3, 4),
    "strided_view": np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2],
    "empty_f16": np.zeros((0, 3), np.float16),
    "bool": np.array([True, False, True]),
}


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


# -- the store against the JAX package's ------------------------------------------


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_hashes_and_blob_bytes_match_jax(name):
    arr = ARRAYS[name]
    assert tst.leaf_sha(arr) == jst.leaf_sha(arr)
    assert tst.npy_bytes(arr) == jst.npy_bytes(arr)
    assert tst.npy_sha(tst.npy_bytes(arr)) == jst.npy_sha(jst.npy_bytes(arr)) == tst.leaf_sha(arr)


def _states():
    base = {"w": np.arange(64, dtype=np.float32), "count": np.asarray(3, np.int32),
            "ef": np.zeros((2, 8), np.float32)}
    yield 1, base
    yield 2, {**base, "w": base["w"] + 1}  # one leaf changed
    yield 3, {**base, "w": base["w"] + 1}  # nothing changed
    yield 4, {**base, "count": np.asarray(4, np.int32), "ef": np.ones((2, 8), np.float32)}


def _files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_chunk_store_matches_jax(tmp_path):
    ours = tst.ChunkStore(tmp_path / "port", max_to_keep=2)
    theirs = jst.ChunkStore(tmp_path / "jax", max_to_keep=2)
    for step, state in _states():
        assert ours.save_state(step, state) == theirs.save_state(step, state)
    assert _files(ours.directory) == _files(theirs.directory)
    assert sorted(ours.manifests()) == [3, 4]
    # each package reads the other's store
    for reader, root in ((tst.ChunkStore, theirs.directory), (jst.ChunkStore, ours.directory)):
        step, state = reader(root).load_state()
        assert step == 4
        want = dict(_states())[4]
        assert state.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(state[k], want[k])
            assert state[k].dtype == want[k].dtype
        assert reader(root).load_state(3)[0] == 3
        with pytest.raises(FileNotFoundError):
            reader(root).load_state(1)
    _, manifest = ours.latest()
    assert ours.missing(manifest) == theirs.missing(manifest) == []
    sha = json.loads(manifest)["leaves"]["w"]
    (ours.blobs / f"{sha}.npy").unlink()
    (theirs.blobs / f"{sha}.npy").unlink()
    assert ours.missing(manifest) == theirs.missing(manifest) == [sha]


def test_copy_delta_and_replica_manifests_match_jax(tmp_path):
    src = tst.ChunkStore(tmp_path / "src")
    for step, state in _states():
        src.save_state(step, state)
    # the port's copy into a JAX store, and the JAX copy into a port store
    got = tst.copy_delta(src, jst.ChunkStore(tmp_path / "a"), step=2, dst_origin=5)
    want = jst.copy_delta(jst.ChunkStore(tmp_path / "src"), tst.ChunkStore(tmp_path / "b"),
                          step=2, dst_origin=5)
    assert got == want and got["chunks_copied"] == 3
    assert _files(tmp_path / "a") == _files(tmp_path / "b")
    for store in (tst.ChunkStore(tmp_path / "a"), jst.ChunkStore(tmp_path / "b")):
        assert store.manifests() == {} and list(store.manifests(origin=5)) == [2]
        assert store.replica_origins() == {5} and store.latest(origin=5)[0] == 2
    again = tst.copy_delta(src, tst.ChunkStore(tmp_path / "a"), dst_origin=5)
    assert again["step"] == 4 and again["chunks_skipped"] + again["chunks_copied"] == 3
    with pytest.raises(FileNotFoundError):
        tst.copy_delta(src, tst.ChunkStore(tmp_path / "c"), step=99)
    with pytest.raises(FileNotFoundError):
        tst.copy_delta(tst.ChunkStore(tmp_path / "empty"), tst.ChunkStore(tmp_path / "c"))


def test_prune_sweeps_only_dead_or_own_temps(tmp_path):
    """A shared store may hold another live writer's temp: prune sweeps the
    temps of dead writers and its own, never a live one's or a bare
    ``.tmp`` (the delta checkpointer's), as the JAX store does."""
    names = {"dead": f"a.tmp{_dead_pid()}", "own": f"b.tmp{os.getpid()}",
             "live": f"c.tmp{os.getppid()}", "bare": "d.tmp"}
    for mod in (tst, jst):
        store = mod.ChunkStore(tmp_path / mod.__name__)
        for name in names.values():
            (store.blobs / name).write_bytes(b"x")
        store.prune()
        assert sorted(p.name for p in store.blobs.iterdir()) == sorted(
            [names["live"], names["bare"]])


def test_store_refuses_bad_names_and_bytes(tmp_path):
    store = tst.ChunkStore(tmp_path / "s")
    for bad in ("", "../x", "a.b", "a/b"):
        with pytest.raises(ValueError, match="malformed"):
            store.blob_path(bad)
    data = tst.npy_bytes(ARRAYS["f32"])
    with pytest.raises(ValueError, match="do not hash"):
        store.write("0" * 64, data)
    assert store.write(tst.leaf_sha(ARRAYS["f32"]), data)
    assert not store.write(tst.leaf_sha(ARRAYS["f32"]), data)
    with pytest.raises(ValueError, match="max_to_keep"):
        tst.ChunkStore(tmp_path / "t", max_to_keep=0)


def test_note_disk_restore_keeps_the_metric_names():
    assert (tst._R_FROM_DISK.name, tst._R_SECONDS.name) == (
        jst._R_FROM_DISK.name, jst._R_SECONDS.name) == ("restore.from_disk", "restore.seconds")
    before = tmetrics.counter("restore.from_disk").value
    tst.note_disk_restore(0.25)
    assert tmetrics.counter("restore.from_disk").value == before + 1
    assert tmetrics.gauge("restore.seconds").value == 0.25


# -- the checkpointers on the port's trainers --------------------------------------------


def _dp(seed=0, n=8):
    return DPTrainer(MLP(hidden=(32,), seed=seed, device="cpu"), line_mesh(n, device="cpu"),
                     optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3), compress="int8",
                     error_feedback=True)


def _lm(seed=0):
    return LongContextTrainer(vocab=16, d_model=32, n_heads=4, n_layers=2, seq_len=16,
                              learning_rate=1e-3, seed=seed, device="cpu")


def _steps(kind, t, batches, mask_first=False):
    for i, (x, y) in enumerate(batches):
        t.train_step(x, y, MASK if kind == "dp" and mask_first and i == 0 else None)


TRAINERS = {
    "dp": (_dp, lambda k, off=1: list(mnist_like().batches(32, k, seed_offset=off))),
    "lm": (_lm, lambda k, off=1: list(lm_copy_task(16, vocab=16).batches(4, k, seed_offset=off))),
}


def _state(t) -> dict:
    state, _ = ckpt.capture_state(t)
    return {k: np.array(ckpt.host_array(v)) for k, v in ckpt.tree_items(state)}


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), k


@pytest.mark.parametrize("kind", sorted(TRAINERS))
@pytest.mark.parametrize("store", STORES, ids=lambda c: c.__name__)
def test_resume_is_bit_equal(tmp_path, store, kind):
    make, batches = TRAINERS[kind]
    bs = batches(4)
    a = make()
    _steps(kind, a, bs[1:2])
    _steps(kind, a, bs[:1], mask_first=True)  # the residual banks rank 3's gradient
    with store(tmp_path / "c") as ck:
        assert ck.save(a, block=True) is not False
        _steps(kind, a, bs[2:])
        b = make(seed=3)
        _steps(kind, b, bs[:1])  # live optimizer state and residual to overwrite
        assert ck.restore(b) == 2
    _steps(kind, b, bs[2:])
    assert b.step_num == a.step_num == 4
    _assert_same_state(a, b)
    assert "['ef']" in _state(a) if kind == "dp" else "['opt_state'][0]['exp_avg']" in _state(a)


@pytest.mark.parametrize("store", [TrainerCheckpointer, AsyncTrainerCheckpointer],
                         ids=lambda c: c.__name__)
def test_full_store_dedups_and_keeps_max_to_keep(tmp_path, store):
    t = _dp()
    bs = TRAINERS["dp"][1](4)
    with store(tmp_path / "c", max_to_keep=2) as ck:
        _steps("dp", t, bs[:1])
        assert ck.save(t, block=True)
        assert not ck.save(t, block=True)  # this step is saved already
        for x, y in bs[1:]:
            t.train_step(x, y)
            assert ck.save(t, block=True)
        assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == ["3", "4"]
    with pytest.raises(FileNotFoundError):
        TrainerCheckpointer(tmp_path / "c").restore(t, 1)
    with pytest.raises(ValueError, match="max_to_keep"):
        TrainerCheckpointer(tmp_path / "d", max_to_keep=0)


def test_delta_dedups_and_prunes_unreferenced_blobs(tmp_path):
    t = _dp()
    bs = TRAINERS["dp"][1](4)
    store = DeltaCheckpointer(tmp_path / "d", max_to_keep=2)
    _steps("dp", t, bs[:1])
    s1 = store.save(t)
    # Adam's four equal step counters share one blob
    assert s1["written_leaves"] > 0 and s1["reused_leaves"] == 3 and s1["reused_bytes"] == 12
    s2 = store.save(t)  # an identical re-save reuses every blob
    assert s2["written_bytes"] == 0
    assert s2["reused_leaves"] == s1["written_leaves"] + s1["reused_leaves"]
    for x, y in bs[1:]:
        t.train_step(x, y)
        store.save(t)
    assert sorted(store._manifests()) == [3, 4]
    live = set()
    for f in store._manifests().values():
        live.update(json.loads(f.read_text())["leaves"].values())
    assert {b.stem for b in store.blobs.glob("*.npy")} == live
    with pytest.raises(ValueError, match="max_to_keep"):
        DeltaCheckpointer(tmp_path / "bad", max_to_keep=0)
    with pytest.raises(FileNotFoundError):
        DeltaCheckpointer(tmp_path / "none").restore(t)


def test_delta_writes_only_the_changed_leaf(tmp_path):
    t = _dp()
    _steps("dp", t, TRAINERS["dp"][1](1))
    store = DeltaCheckpointer(tmp_path / "p")
    store.save(t)
    with torch.no_grad():
        next(t.model.parameters()).add_(1.0)
    t.step_num += 1
    s = store.save(t)
    assert s["written_leaves"] == 1 and s["reused_leaves"] > 0, s


def _dying_np_save(monkeypatch, at: int):
    calls = {"n": 0}
    real = np.save

    def dying(f, arr, **kw):
        calls["n"] += 1
        if calls["n"] == at:
            raise OSError("simulated crash mid-save")
        return real(f, arr, **kw)

    monkeypatch.setattr(np, "save", dying)


def test_delta_crash_between_blobs_publishes_no_manifest(tmp_path, monkeypatch):
    d = DeltaCheckpointer(tmp_path / "ckpt")
    d._write_delta({"a": np.zeros(4, np.float32)}, False, 1)
    _dying_np_save(monkeypatch, 2)
    with pytest.raises(OSError, match="simulated"):
        d._write_delta({"a": np.ones(4, np.float32), "b": np.full(4, 2.0, np.float32)}, False, 2)
    monkeypatch.undo()
    assert d.latest_step() == 1 and not (d.directory / "manifest_2.json").exists()
    d._write_delta({"a": np.zeros(4, np.float32)}, False, 3)  # sweeps the orphans
    assert not list(d.blobs.glob("*.tmp")) and not list(d.directory.glob(".manifest_*.tmp"))


def test_full_crash_mid_save_keeps_the_previous_step(tmp_path, monkeypatch):
    t = _dp()
    bs = TRAINERS["dp"][1](2)
    ck = TrainerCheckpointer(tmp_path / "c")
    _steps("dp", t, bs[:1])
    ck.save(t)
    ref = _state(t)
    t.train_step(*bs[1])
    _dying_np_save(monkeypatch, 2)
    with pytest.raises(OSError, match="simulated"):
        ck.save(t)
    monkeypatch.undo()
    assert ck.latest_step() == 1 and list((tmp_path / "c").glob(".2.tmp*"))
    fresh = _dp(seed=4)
    assert ck.restore(fresh) == 1
    got = _state(fresh)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    t.step_num += 1
    assert ck.save(t)  # the next save sweeps the crashed writer's temp
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == ["1", "3"]


@pytest.mark.parametrize("store", [TrainerCheckpointer, DeltaCheckpointer],
                         ids=lambda c: c.__name__)
def test_restore_zeroes_a_stale_residual(tmp_path, store):
    """A checkpoint without a residual restored into a trainer whose live
    residual is nonzero: the residual comes back zero, so the restored state
    is purely the saved one."""
    t = _dp()
    t.train_step(*TRAINERS["dp"][1](1)[0], MASK)
    assert float(t._ef.abs().sum()) > 0
    plain = _dp(seed=5)
    state, _ = ckpt.capture_state(plain)
    state.pop("ef")
    host = ckpt.host_tree(state)
    ck = store(tmp_path / "s")
    (ck._write_delta if store is DeltaCheckpointer else ck._write)(host, False, 7)
    assert ck.restore(t) == 7
    assert float(t._ef.abs().max()) == 0.0


def _gated(ck, monkeypatch):
    """Hold the background write at a gate, so busy() is deterministic."""
    gate = threading.Event()
    name = "_write_delta" if isinstance(ck, DeltaCheckpointer) else "_write"
    real = getattr(ck, name)

    def slow(*a, **kw):
        assert gate.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(ck, name, slow)
    return gate


@pytest.mark.parametrize("store", [AsyncTrainerCheckpointer, AsyncDeltaCheckpointer],
                         ids=lambda c: c.__name__)
def test_async_capture_holds_capture_time_values(tmp_path, monkeypatch, store):
    t = _lm()
    bs = TRAINERS["lm"][1](4)
    _steps("lm", t, bs[:2])
    ref = _state(t)
    with store(tmp_path / "a") as ck:
        gate = _gated(ck, monkeypatch)
        assert ck.save(t)
        assert ck.busy()
        _steps("lm", t, bs[2:])  # in-place optimizer steps while the save is in flight
        assert not np.array_equal(_state(t)["['params']['embedding']"],
                                  ref["['params']['embedding']"])
        gate.set()
        ck.wait_until_finished()
        fresh = _lm(seed=3)
        assert ck.restore(fresh) == 2
    got = _state(fresh)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("store", [AsyncTrainerCheckpointer, AsyncDeltaCheckpointer],
                         ids=lambda c: c.__name__)
def test_async_save_is_skipped_while_busy(tmp_path, monkeypatch, store):
    t = _dp()
    bs = TRAINERS["dp"][1](2)
    _steps("dp", t, bs[:1])
    with store(tmp_path / "b") as ck:
        gate = _gated(ck, monkeypatch)
        assert ck.save(t)
        t.train_step(*bs[1])
        assert not ck.save(t)  # busy: skipped, not queued
        gate.set()
        ck.wait_until_finished()
        assert ck.latest_step() == 1
        assert ck.save(t, block=True)
        assert ck.latest_step() == 2
        if store is AsyncDeltaCheckpointer:
            assert ck.last_stats["written_leaves"] > 0


@pytest.mark.parametrize("store", [AsyncTrainerCheckpointer, AsyncDeltaCheckpointer],
                         ids=lambda c: c.__name__)
def test_async_background_failure_surfaces(tmp_path, monkeypatch, store):
    t = _dp()
    _steps("dp", t, TRAINERS["dp"][1](1))
    ck = store(tmp_path / "f")
    name = "_write_delta" if store is AsyncDeltaCheckpointer else "_write"

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ck, name, boom)
    assert ck.save(t)
    with pytest.raises(RuntimeError, match="background checkpoint save failed: disk full"):
        ck.wait_until_finished()
    monkeypatch.undo()
    assert ck.save(t, block=True) and ck.latest_step() == 1
    ck.close()


def test_snapshot_across_rank_counts_keeps_the_residual_sum():
    t8 = _dp()
    bs = TRAINERS["dp"][1](2)
    _steps("dp", t8, bs, mask_first=True)
    snap = Snapshot.capture(t8)
    ref = _state(t8)
    t8.train_step(*bs[0])  # the snapshot does not move with the trainer
    for _ in range(2):  # a snapshot restores more than once
        t4 = _dp(seed=6, n=4)
        snap.restore_into(t4)
        got = _state(t4)
        assert t4.step_num == 2 and got.keys() == ref.keys()
        for k in ref:
            if k != "['ef']":
                assert np.array_equal(got[k], ref[k]), k
        assert got["['ef']"].shape == (4, t4.param_count)
        assert np.abs(ref["['ef']"]).max() > 0
        np.testing.assert_allclose(got["['ef']"].sum(0), ref["['ef']"].sum(0), rtol=1e-5,
                                   atol=1e-6)
        t4.train_step(*bs[0])


def test_capture_refuses_leaves_numpy_cannot_hold():
    bf16 = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.DeviceCopy(bf16)
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.host_tree(bf16)


def test_device_copy_is_of_capture_time_on_the_cpu():
    w = torch.arange(4.0)
    copy = ckpt.DeviceCopy({"w": w, "n": np.asarray(2)})
    w.add_(1.0)
    host = copy.to_host(ckpt.HostBuffers())
    np.testing.assert_array_equal(host["w"], np.arange(4.0, dtype=np.float32))
    assert host["n"] == 2


def test_key_paths_are_jax_keystr():
    from typing import NamedTuple

    class State(NamedTuple):
        count: object
        mu: object

    tree = {"b": [np.ones(2), (State(np.int32(1), np.zeros(3)), ())], "a": {2: 1.0, 10: 2.0},
            "c": None, "d": {"x.y": np.ones(1)}}
    got = [k for k, _ in ckpt.tree_items(tree)]
    assert got == [jtu.keystr(p) for p, _ in jtu.tree_leaves_with_path(tree)]
    for key in got:
        assert ckpt.parse_key(key)[0] in tree
    assert ckpt.parse_key("['opt_state'][0].mu") == ("opt_state", 0, "mu")
    with pytest.raises(ValueError, match="malformed"):
        ckpt.parse_key("['a']junk")
    mapped = ckpt.tree_map_with_keys(lambda k, x: k, tree)
    assert mapped["b"][1][0].mu == "['b'][1][0].mu" and mapped["c"] is None


# -- the CLI -------------------------------------------------------------------------


def _twice(argv, capsys):
    assert cli_main(argv) == 0
    first = capsys.readouterr().out
    assert cli_main(argv) == 0
    return first, capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["train-mlp", "train-zero1"])
@pytest.mark.parametrize("flags", [[], ["--delta-checkpoint"], ["--async-checkpoint"],
                                   ["--delta-checkpoint", "--async-checkpoint"]],
                         ids=["full", "delta", "async", "async_delta"])
def test_cli_resumes_from_its_checkpoints(tmp_path, capsys, cmd, flags):
    first, second = _twice([cmd, "--device", "cpu", "--hidden", "16", "--batch", "16",
                            "--steps", "4", "--checkpoint-dir", str(tmp_path / "ck"),
                            "--checkpoint-every", "2", *flags], capsys)
    assert "resumed" not in first
    lines = second.strip().splitlines()
    assert "resumed from step 4" in lines and "4 steps over 8 virtual ranks" in lines[-1]
    store = (DeltaCheckpointer if "--delta-checkpoint" in flags else TrainerCheckpointer)
    assert store(tmp_path / "ck").latest_step() == 8


def test_train_lm_resumes_between_its_chains(tmp_path, capsys):
    first, second = _twice(["train-lm", "--device", "cpu", "--vocab", "16", "--d-model", "32",
                            "--heads", "4", "--layers", "1", "--seq-len", "16", "--batch", "2",
                            "--steps", "4", "--device-data", "--checkpoint-dir",
                            str(tmp_path / "ck"), "--checkpoint-every", "2"], capsys)
    assert "resumed" not in first and "resumed from step 4" in second
    assert TrainerCheckpointer(tmp_path / "ck").all_steps() == [4, 6, 8]


def test_train_resnet_resumes(tmp_path, capsys, monkeypatch):
    def narrow(classes=1000, compute_dtype=torch.float32, *, seed=0, device=None):
        return ResNet(stage_sizes=(1, 1, 1, 1), width=8, classes=classes,
                      compute_dtype=compute_dtype, seed=seed, device=device)

    monkeypatch.setattr(models, "ResNet50", narrow)
    first, second = _twice(["train-resnet", "--device", "cpu", "--image-size", "16",
                            "--batch", "16", "--steps", "2", "--checkpoint-dir",
                            str(tmp_path / "ck"), "--delta-checkpoint"], capsys)
    assert "resumed" not in first and "resumed from step 2" in second


def _jax_record_keys() -> list[str]:
    """The keys of the JAX ``bench-checkpoint`` record, from its source."""
    tree = ast.parse(inspect.getsource(jmain._cmd_bench_checkpoint).lstrip())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "rec":
            return [k.value for k in node.value.keys]
    raise AssertionError("no rec = {...} in the JAX bench-checkpoint")


@pytest.mark.parametrize("trainer,store", [("zero1", "orbax"), ("lm", "delta")])
def test_bench_checkpoint_prints_the_jax_record(capsys, tmp_path, trainer, store):
    assert cli_main(["bench-checkpoint", "--trainer", trainer, "--store", store,
                     "--d-model", "32", "--layers", "2", "--seq-len", "16", "--vocab", "16",
                     "--baseline-steps", "2", "--dir", str(tmp_path), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    keys = _jax_record_keys()
    assert len(keys) == 14 and set(keys) <= set(rec)
    assert rec["metric"] == "checkpoint_stall" and rec["trainer"] == trainer
    assert rec["platform"] == rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["sync_save_stall_s"] > 0 and rec["async_save_wall_s"] >= rec["async_capture_stall_s"]
    assert rec["saved_step"] == 3  # a warm-up step and two baseline steps
    assert (rec["delta_stats"] is None) == (store == "orbax")
    assert list(tmp_path.iterdir()) == []  # the scratch store is gone


def test_bench_checkpoint_refuses_what_is_not_ported(capsys):
    for flags in (["--trainer", "fsdp"], ["--trainer", "pipeline"], ["--remat", "full"]):
        with pytest.raises(SystemExit):
            cli_main(["bench-checkpoint", "--device", "cpu", *flags])
        assert "not ported yet" in capsys.readouterr().err
