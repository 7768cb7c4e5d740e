"""Elastic training: the cross-round tier of BASELINE config 5's fault model.

Counterpart of ``akka_allreduce_tpu/train/elastic.py`` (``ElasticTrainer``,
``ElasticDPTrainer``, ``ElasticLongContextTrainer``, ``ElasticMoETrainer``,
``adaptive_parallel_factor``). Within a round, stragglers are absorbed by
the threshold mask; across rounds, a node that stays silent trips the
phi-accrual detector and its ranks leave the mesh through the cycle

    snapshot (host RAM) -> rebuild the trainer over the live ranks -> restore

and a late joiner's heartbeat grows the mesh back the same way.

The port has no device list: a mesh is ``n`` virtual ranks on one device
(``parallel.mesh``). So ``devices_by_node`` maps each node id to a sequence
of virtual-rank labels of which only the length counts (a zero-rank control
node is ``[]``), and the mesh over the live nodes is
``mesh_factory(total_live_ranks, device=device)``, the live nodes taken in
node order as the JAX wrapper concatenates their devices. ``device`` is the
card unless ``"cpu"`` is asked for; every trainer the factory builds runs
there. Nothing is compiled at a re-mesh: the new trainer is new Python
objects over tensors the caching allocator hands out again.

The rebuild is transactional: the snapshot is a host copy, the new trainer
is built and restored before it replaces the old one, and a factory or a
restore that raises leaves the old trainer and the old members in place. A
factory must therefore give every build its own weights (``ElasticDPTrainer``
deep-copies its model for each build): a module shared between the old
trainer and the new one would take the restore's in-place writes.

The pipeline subclass waits for its trainer.
"""

from __future__ import annotations

import copy
import inspect
import logging
import math
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.control.adapt import WIRE_TO_COMPRESS
from akka_allreduce_tpu_torch.control.failure import (
    HeartbeatMonitor,
    MembershipEvent,
    PhiAccrualFailureDetector,
)
from akka_allreduce_tpu_torch.obs import flight as _flight
from akka_allreduce_tpu_torch.obs import metrics as _metrics
from akka_allreduce_tpu_torch.parallel.mesh import RankMesh, data_seq_mesh, grid_mesh, line_mesh
from akka_allreduce_tpu_torch.train.checkpoint import Snapshot
from akka_allreduce_tpu_torch.train.trainer import DPTrainer, TrainStepMetrics

log = logging.getLogger(__name__)

# elastic.* observability: every snapshot -> rebuild -> restore cycle lands
# one histogram observation, one per-kind counter and one `remesh` flight
# event; the gauge tracks the compress ladder's level
_REMESH_SECONDS = _metrics.histogram("elastic.remesh.seconds")
_COMPRESS_LEVEL = _metrics.gauge("elastic.compress_level")

#: trainer ``compress`` mode -> degrade-ladder level (the gauge's unit)
COMPRESS_LEVELS = {None: 0, "bf16": 1, "int8": 2}

#: sentinel: no compress override in force; rebuilds run the factory at
#: its construction-time mode (``apply_policy_wire("")`` restores this)
_INHERIT = object()

MeshFactory = Callable[..., RankMesh]  # (n_ranks, *, device) -> RankMesh


class ElasticTrainer:
    """Any trainer, re-meshed over the virtual ranks of the live nodes.

    Args:
      trainer_factory: ``mesh -> trainer`` (optionally ``compress=``),
        called at construction and on every re-mesh with the live ranks'
        mesh; each call must build its own weights.
      devices_by_node: node id -> that node's virtual-rank labels; only
        the length counts. The mesh at any moment has the live nodes'
        ranks, in node order.
      mesh_factory: ``(n_ranks, *, device) -> RankMesh`` (default: a line).
      detector: phi-accrual detector (default: threshold 8).
      min_nodes: below this many live nodes, ``train_step`` refuses.
      clock: the detector's time source.
      fallback_mesh_factory: tried when ``trainer_factory`` refuses the
        primary mesh on a re-mesh (degrade, not wedge).
      device: the ranks' device: the card unless ``"cpu"``.
    """

    def __init__(
        self,
        trainer_factory: Callable[..., object],
        devices_by_node: Mapping[int, Sequence],
        *,
        mesh_factory: MeshFactory = line_mesh,
        detector: PhiAccrualFailureDetector | None = None,
        min_nodes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        fallback_mesh_factory: MeshFactory | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        if not devices_by_node:
            raise ValueError("need at least one node")
        self.device = resolve_device(device)
        self.trainer_factory = trainer_factory
        self.devices_by_node = {int(k): list(v) for k, v in devices_by_node.items()}
        self.mesh_factory = mesh_factory
        self.fallback_mesh_factory = fallback_mesh_factory
        self.min_nodes = min_nodes
        self.clock = clock
        self.monitor = HeartbeatMonitor(detector)
        self.generation = 0  # bumps on every re-mesh
        self.remesh_events: list[MembershipEvent] = []
        # compress override: _INHERIT = the factory's construction mode;
        # set_compress / apply_policy_wire rebuild through the same path a
        # membership re-mesh takes
        self._compress = _INHERIT
        self._factory_takes_compress = (
            "compress" in inspect.signature(trainer_factory).parameters)
        # optional mode -> mode map for families whose factory clamps the
        # request (ZeRO-1 has no int8 ring: int8 -> bf16), applied before
        # the changed-mode check so a stamp clamped onto the current mode
        # rebuilds nothing
        self.clamp_compress: Callable[[str | None], str | None] | None = None

        now = self.clock()
        for node_id in self.devices_by_node:
            self.monitor.heartbeat(node_id, now)
        self.member_nodes: tuple[int, ...] = tuple(self.monitor.members_up)
        self.trainer = self._build_trainer()
        # the construction-time mode "" (inherit) restores to
        self._base_compress = getattr(self.trainer, "compress", None)
        _COMPRESS_LEVEL.set(COMPRESS_LEVELS.get(self.compress_mode, 0))

    # -- membership ----------------------------------------------------------

    def _live_devices(self) -> list:
        """The live nodes' rank labels, in node order."""
        devs: list = []
        for node_id in self.member_nodes:
            devs.extend(self.devices_by_node[node_id])
        return devs

    def _build_trainer(self, mesh_factory: MeshFactory | None = None):
        mesh = (mesh_factory or self.mesh_factory)(len(self._live_devices()),
                                                   device=self.device)
        if self._factory_takes_compress and self._compress is not _INHERIT:
            return self.trainer_factory(mesh, compress=self._compress)
        return self.trainer_factory(mesh)

    def _rebuild(self, kind: str, old_members: tuple[int, ...]) -> None:
        """Snapshot -> rebuild over the current ``member_nodes`` -> restore,
        transactionally: on a factory refusal the fallback mesh is tried,
        and if everything fails ``member_nodes`` reverts and the old trainer,
        never written, stays in place."""
        t0 = time.perf_counter()
        snap = Snapshot.capture(self.trainer)
        try:
            trainer = self._build_trainer()
        except Exception:
            if self.fallback_mesh_factory is None:
                self.member_nodes = old_members
                raise
            log.warning("re-mesh (%s): factory refused the %d-rank mesh; degrading "
                        "to the fallback mesh", kind, len(self._live_devices()),
                        exc_info=True)
            try:
                trainer = self._build_trainer(self.fallback_mesh_factory)
            except Exception:
                self.member_nodes = old_members
                raise
        try:
            snap.restore_into(trainer)
        except Exception:
            self.member_nodes = old_members
            raise
        self.trainer = trainer
        self.generation += 1
        dt = time.perf_counter() - t0
        _REMESH_SECONDS.observe(dt)
        _metrics.counter(f"elastic.remeshes.{kind}").inc()
        _COMPRESS_LEVEL.set(COMPRESS_LEVELS.get(self.compress_mode, 0))
        _flight.note(
            "remesh",
            cause=kind,
            members_from=list(old_members),
            members_to=list(self.member_nodes),
            generation=self.generation,
            n_devices=self.trainer.n_devices,
            seconds=round(dt, 4),
        )

    def heartbeat(self, node_id: int, now: float | None = None) -> None:
        """Record a node's heartbeat; a node that was down rejoins."""
        if node_id not in self.devices_by_node:
            raise KeyError(f"node {node_id} has no device assignment; register it in "
                           "devices_by_node before it can join")
        ev = self.monitor.heartbeat(node_id, self.clock() if now is None else now)
        if ev is not None:
            self.remesh_events.append(ev)

    def leave(self, node_id: int, now: float | None = None) -> None:
        ev = self.monitor.leave(node_id, self.clock() if now is None else now)
        if ev is not None:
            self.remesh_events.append(ev)

    def poll(self, now: float | None = None) -> bool:
        """Run failure detection and re-mesh if membership changed; True
        when a re-mesh happened. Fires only on sustained silence, never on
        within-round lag."""
        now = self.clock() if now is None else now
        self.remesh_events.extend(self.monitor.poll(now))
        live = tuple(self.monitor.members_up)
        if live == self.member_nodes:
            return False
        if not live:
            raise RuntimeError("all nodes unreachable; cannot re-mesh")
        log.info("re-mesh: members %s -> %s (generation %d -> %d)",
                 self.member_nodes, live, self.generation, self.generation + 1)
        old = self.member_nodes
        self.member_nodes = live
        self._rebuild("grow" if len(live) > len(old) else "shrink", old)
        return True

    def apply_membership(self, live: Sequence[int], now: float | None = None) -> bool:
        """Re-mesh to a membership view decided outside (the TCP cluster's
        phi hub or gossip): the in-process monitor is kept coherent with
        the view, not consulted. Node ids without an assignment are
        ignored. True when a re-mesh happened."""
        now = self.clock() if now is None else now
        known = sorted({int(n) for n in live} & set(self.devices_by_node))
        if not known:
            raise RuntimeError(f"no live node in {sorted(set(map(int, live)))} has a "
                               "device assignment; cannot re-mesh")
        for nid in known:
            ev = self.monitor.heartbeat(nid, now)
            if ev is not None:
                self.remesh_events.append(ev)
        for nid in set(self.member_nodes) - set(known):
            ev = self.monitor.force_unreachable(nid, now)
            if ev is not None:
                self.remesh_events.append(ev)
        target = tuple(known)
        if target == self.member_nodes:
            return False
        old = self.member_nodes
        log.info("re-mesh (membership): members %s -> %s (generation %d -> %d)",
                 old, target, self.generation, self.generation + 1)
        self.member_nodes = target
        self._rebuild("grow" if len(target) > len(old) else "shrink", old)
        return True

    def remesh(self, reason: str = "forced") -> bool:
        """Snapshot -> rebuild -> restore with membership unchanged (every
        node re-joining a promoted standby master)."""
        log.info("re-mesh (%s): members %s unchanged (generation %d -> %d)",
                 reason, self.member_nodes, self.generation, self.generation + 1)
        self._rebuild(reason, self.member_nodes)
        return True

    # -- compress follows the RoundPolicy ------------------------------------

    @property
    def compress_mode(self) -> str | None:
        """The live trainer's gradient wire (None / "bf16" / "int8")."""
        return getattr(self.trainer, "compress", None)

    def set_compress(self, mode: str | None) -> bool:
        """Switch the gradient compression by rebuilding through the
        factory (snapshot -> factory(mesh, compress=mode) -> restore). The
        EF residual crosses inside the snapshot; a rebuild without EF drops
        it. True when a rebuild happened."""
        return self._set_compress_override(mode)

    def apply_policy_wire(self, wire: str) -> bool:
        """Drive :meth:`set_compress` from a ``RoundPolicy`` wire stamp;
        ``""`` clears the override (the construction-time mode)."""
        wire = wire or ""
        if wire == "":
            return self._set_compress_override(_INHERIT)
        if wire not in WIRE_TO_COMPRESS:
            log.warning("unknown policy wire %r: keeping compress mode", wire)
            return False
        return self._set_compress_override(WIRE_TO_COMPRESS[wire])

    def _set_compress_override(self, value) -> bool:
        mode = self._base_compress if value is _INHERIT else value
        if mode not in COMPRESS_LEVELS:
            raise ValueError(f"compress must be one of {sorted(COMPRESS_LEVELS, key=str)}, "
                             f"got {mode!r}")
        if value is not _INHERIT and self.clamp_compress is not None:
            clamped = self.clamp_compress(mode)
            if clamped != mode:
                log.info("compress %s clamped to %s", mode, clamped)
                mode = value = clamped
        if mode == self.compress_mode:
            self._compress = value  # record intent; nothing to rebuild
            return False
        if not self._factory_takes_compress:
            raise RuntimeError("this trainer_factory does not accept a `compress` kwarg; "
                               "a policy-driven mode change has no rebuild path")
        old = self._compress
        self._compress = value
        try:
            self._rebuild("compress", self.member_nodes)
        except Exception:
            self._compress = old
            raise
        log.info("compress level -> %s (generation %d)", mode or "full", self.generation)
        return True

    # -- training ------------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return self.trainer.n_devices

    @property
    def n_nodes(self) -> int:
        return len(self.member_nodes)

    @property
    def param_count(self) -> int:
        """Logical model size, the same across re-meshes (the cluster's
        ``data_size`` is derived from it)."""
        return self.trainer.param_count

    def train_step(self, x, y, valid: Sequence[float] | None = None) -> TrainStepMetrics:
        if self.n_nodes < self.min_nodes:
            raise RuntimeError(f"only {self.n_nodes} live nodes < min_nodes={self.min_nodes}")
        return self.trainer.train_step(x, y, valid)

    def get_flat_params(self) -> np.ndarray:
        return self.trainer.get_flat_params()

    def flat_params_tensor(self) -> torch.Tensor:
        return self.trainer.flat_params_tensor()

    def set_flat_params(self, vec: np.ndarray | torch.Tensor) -> None:
        """The binder's deposit seam: the flat layout does not depend on
        the rank count, so a deposit is valid across re-meshes."""
        self.trainer.set_flat_params(vec)


def adaptive_parallel_factor(n_devices: int, divides: int) -> int:
    """Largest axis size that divides both the live rank count and a
    model-structure count (experts, layers, sequence length)."""
    if n_devices < 1 or divides < 1:
        raise ValueError(f"need positive counts, got {n_devices=}, {divides=}")
    return math.gcd(n_devices, divides)


def _capped_factor(n_devices: int, divides: int, cap: int | None) -> int:
    """:func:`adaptive_parallel_factor`, optionally capped at ``cap``."""
    g = adaptive_parallel_factor(n_devices, divides)
    if cap is None or g <= cap:
        return g
    if cap < 1:
        raise ValueError(f"axis cap must be >= 1, got {cap}")
    return max(f for f in range(1, cap + 1) if g % f == 0)


class ElasticLongContextTrainer(ElasticTrainer):
    """Elastic long-context LM training over a (data, seq) mesh of the live
    ranks: on a re-mesh the seq axis becomes the largest size dividing
    ``seq_len`` and the live rank count, capped at ``max_sp``, and the rest
    of the ranks form the data axis; the snapshot (full-shape parameters and
    Adam moments) crosses any change of sp. Each build draws its own model
    from ``seed`` and the snapshot overwrites it."""

    def __init__(
        self,
        devices_by_node: Mapping[int, Sequence],
        *,
        seq_len: int = 128,
        max_sp: int | None = None,
        detector: PhiAccrualFailureDetector | None = None,
        min_nodes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        device: str | torch.device | None = None,
        **trainer_kwargs,
    ) -> None:
        from akka_allreduce_tpu_torch.train.long_context import LongContextTrainer

        def mesh_factory(n: int, *, device=None) -> RankMesh:
            sp = _capped_factor(n, seq_len, max_sp)
            return data_seq_mesh(n // sp, sp, device=device)

        def factory(mesh, compress=_INHERIT):
            kw = dict(trainer_kwargs)
            if compress is not _INHERIT:
                kw["compress"] = compress
            return LongContextTrainer(mesh, seq_len=seq_len, **kw)

        super().__init__(factory, devices_by_node, mesh_factory=mesh_factory,
                         detector=detector, min_nodes=min_nodes, clock=clock,
                         device=device)


class ElasticMoETrainer(ElasticTrainer):
    """Elastic expert-parallel training: the (data, expert) mesh re-shapes
    with membership. On every re-mesh the expert axis becomes the largest
    size dividing both ``n_experts`` and the live rank count
    (:func:`adaptive_parallel_factor`), so the same experts redistribute
    over fewer or more ranks: the trainer keeps full-shape parameters, the
    snapshot carries them, and the rebuilt trainer's ranks see their new
    shards of them. Each build draws its own model from ``seed`` and the
    snapshot overwrites it."""

    def __init__(
        self,
        devices_by_node: Mapping[int, Sequence],
        *,
        n_experts: int = 4,
        detector: PhiAccrualFailureDetector | None = None,
        min_nodes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        device: str | torch.device | None = None,
        **trainer_kwargs,
    ) -> None:
        from akka_allreduce_tpu_torch.train.moe import MoETrainer

        def mesh_factory(n: int, *, device=None) -> RankMesh:
            ep = adaptive_parallel_factor(n, n_experts)
            return grid_mesh(n // ep, ep, axes=("data", "expert"), device=device)

        def factory(mesh, compress=_INHERIT):
            kw = dict(trainer_kwargs)
            if compress is not _INHERIT:
                kw["compress"] = compress
            return MoETrainer(mesh, n_experts=n_experts, **kw)

        super().__init__(factory, devices_by_node, mesh_factory=mesh_factory,
                         detector=detector, min_nodes=min_nodes, clock=clock,
                         device=device)


class ElasticDPTrainer(ElasticTrainer):
    """The DP form (config 5's workhorse): a ``DPTrainer`` over the live
    ranks on every re-mesh, each over a module of its own. The first build
    takes a deep copy of ``model`` (``model`` itself is never written); a
    later one takes ``model``'s structure with new, unwritten weights on the
    card, which the snapshot then overwrites. So no copy of the weights is
    kept beside the live trainer's, and none is made at a re-mesh.
    ``trainer_kwargs`` go to every build; a rebuild that drops ``compress``
    drops ``error_feedback`` too. ZeRO-1 and the other families go through
    :class:`ElasticTrainer` with their own factory."""

    def __init__(
        self,
        model: nn.Module,
        devices_by_node: Mapping[int, Sequence],
        *,
        mesh_factory: MeshFactory = line_mesh,
        detector: PhiAccrualFailureDetector | None = None,
        min_nodes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        device: str | torch.device | None = None,
        **trainer_kwargs,
    ) -> None:
        skeleton = _unwritten_copy(model, "meta")
        initial = [model]  # emptied once the first trainer holds the weights

        def factory(mesh, compress=_INHERIT):
            kw = dict(trainer_kwargs)
            if compress is not _INHERIT:
                kw["compress"] = compress
                if not compress:
                    # EF needs a lossy wire: a policy restore to full
                    # fidelity rebuilds without the residual
                    kw.pop("error_feedback", None)
            built = (copy.deepcopy(initial[0]) if initial
                     else _unwritten_copy(skeleton, mesh.device).to(mesh.device))
            return DPTrainer(built, mesh, **kw)

        super().__init__(factory, devices_by_node, mesh_factory=mesh_factory,
                         detector=detector, min_nodes=min_nodes, clock=clock,
                         device=device)
        initial.clear()


def _unwritten_copy(model: nn.Module, device) -> nn.Module:
    """A deep copy of ``model`` whose parameters are new, unwritten tensors
    on ``device`` (ties kept, buffers copied as they are): its structure,
    with no weight copied."""
    memo = {id(p): nn.Parameter(torch.empty_like(p, device=device), p.requires_grad)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)
