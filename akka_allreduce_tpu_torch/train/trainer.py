"""Data-parallel trainer over n virtual ranks on one device.

Counterpart of ``akka_allreduce_tpu/train/trainer.py``: ``DPTrainer`` and
the helpers every trainer shares (``TrainStepMetrics``, ``normalize_valid``,
``ef_fold``, ``ef_residual``, ``default_classification_loss``).

The JAX trainer shards the batch over a device mesh, computes each device's
gradient and masked-sums the gradients in one collective. Here the mesh is
n virtual ranks on one device (``parallel.mesh.RankMesh``), so a step is:

- the global batch of ``n·b`` rows is viewed as ``(n, b, ...)``: rank ``r``
  takes rows ``[r·b, (r+1)·b)``, as ``NamedSharding`` lays them out;
- every rank's gradient of its own mean loss comes from one batched pass
  (``torch.func.vmap`` of ``grad_and_value`` over ``functional_call``),
  flattened in the JAX package's ``ravel_pytree`` order
  (``binder.flatten_params``) into an ``(n, P)`` f32 stack;
- the stack goes through the threshold-masked sync, which divides the
  masked sum by ``count = sum(valid)``:

  - f32 (bucketed or not): ``ops.local_reduce.masked_average``, which is
    K1 on the card and its plain version on the CPU. The mask is per rank,
    so every bucket's count is the scalar count and one K1 call computes
    the bucketed average too;
  - ``compress="bf16"``: ``comm.allreduce.masked_psum`` with a bf16 wire,
    mask then cast;
  - ``compress="int8"``: the plain ring ``comm.allreduce.ring_allreduce_sum``
    on a one-axis mesh (the JAX trainer's XLA ring, not K3);
- ``loss = sum_r v_r·loss_r / max(count, 1)``, ``contributors = count``,
  then the optimizer (SGD at ``learning_rate`` by default) updates the one
  replicated parameter set.

With ``error_feedback`` each rank keeps an f32 residual row (the ``(n, P)``
state ``_ef``): ``c = g + e`` goes on the wire and what the compression
withheld, or the whole of ``c`` for a masked rank, is re-sent next step.

``overlap=True`` syncs each parameter leaf inside the backward instead
(``overlapped_step``, ``akka_allreduce_tpu/train/trainer.py:473``): every
leaf reaches the model through its sync (``comm.allreduce.backward_*_sync``),
which hands it to the n ranks as an ``(n, *leaf)`` broadcast, the loss is
the unmasked sum of the ranks' mean losses, and in ``backward()`` each
leaf's ``(n, *leaf)`` cotangent stack is masked and synced as soon as it is
ready: K1 once a leaf in f32, a bf16 ``masked_psum`` or the int8 ring per
leaf, with the leaf's EF residual (a view into ``_ef``) rewritten in place.

``train_step_accum`` splits each rank's rows into ``accum_steps``
consecutive microbatches, sums their gradient stacks, divides by
``accum_steps`` and runs the sum through the one sync of the plain step.

``train_chain`` draws its batches on the device with a ``torch.Generator``
and keeps the losses there until the chain ends: one host read a chain.

Each step's forward and backward run under ``_device.ieee_f32``, so a
model's f32 convolutions (ResNet's) train in f32, not in cuDNN's default
TF32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, grad_and_value, vmap

from akka_allreduce_tpu_torch._device import ieee_f32, resolve_device
from akka_allreduce_tpu_torch.binder.api import (
    flat_tensor,
    leaf_order,
    load_flat_tensor,
)
from akka_allreduce_tpu_torch.comm.allreduce import (
    _num_buckets,
    backward_psum_sync,
    backward_ring_sync,
    backward_sync_ef,
    expand_counts,
    masked_psum,
    ring_allreduce_sum,
    ring_ef_residual,
)
from akka_allreduce_tpu_torch.ops.local_reduce import masked_average
from akka_allreduce_tpu_torch.parallel.mesh import RankMesh


@dataclasses.dataclass
class TrainStepMetrics:
    step: int
    loss: float
    contributors: float


def normalize_valid(valid: Sequence[float] | None, n: int) -> np.ndarray:
    """Contributor mask -> validated (n,) float32 array (shared by trainers)."""
    if valid is None:
        return np.ones((n,), np.float32)
    arr = np.asarray(valid, np.float32)
    if arr.shape != (n,):
        raise ValueError(f"valid must have shape ({n},), got {arr.shape}")
    return arr


def ef_fold(stack: torch.Tensor, ef: torch.Tensor | None) -> torch.Tensor:
    """Fold the EF residual into this step's contribution: ``c = g + e``."""
    return stack if ef is None else stack + ef


def ef_residual(c: torch.Tensor, v: torch.Tensor, *, compress: str = "bf16") -> torch.Tensor:
    """``e' = c - sent`` for the rank stack ``c`` (n, P) under the mask ``v``
    (n,); all of a masked rank's ``c`` carries forward.

    ``sent`` mirrors ``masked_psum``'s mask-then-cast exactly, so the bf16
    cast error, which is local to each rank, is compensated in full. The
    int8 ring's residual comes from the ring itself (``ring_ef_residual``).
    """
    if compress != "bf16":
        raise ValueError(
            f"ef_residual is the bf16 mask-then-cast mirror; int8 uses the "
            f"ring's per-hop residual (got compress={compress!r})")
    m = c * v.to(c.dtype)[:, None]
    return c - m.to(torch.bfloat16).to(torch.float32)


def default_classification_loss() -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Mean softmax cross-entropy over integer labels (the trainers' default)."""
    return lambda logits, y: F.cross_entropy(logits, y.long())


def rank_loss_fn(model: nn.Module, loss: Callable) -> Callable:
    """``(params, x, y) -> loss`` of one rank's rows under the parameters
    ``params`` (by name), for ``torch.func`` to differentiate and batch."""

    def rank_loss(params, x, y):
        return loss(functional_call(model, params, (x,)), y)

    return rank_loss


class DPTrainer:
    """Data-parallel trainer over every axis of ``mesh``.

    Args:
      model: an ``nn.Module`` whose parameters map to flax paths
        (``models.convert.flax_path``), e.g. ``models.MLP``; it is moved to
        the mesh's device and its parameters are the replicated set.
      mesh: the virtual ranks; the batch is split across all its axes
        jointly, in rank order.
      optimizer: a factory ``parameters -> torch.optim.Optimizer``; default
        ``torch.optim.SGD(parameters, lr=learning_rate)`` (optax's ``sgd``).
      bucket_size: gradient bucket size in elements (None = one bucket).
      loss_fn: ``(logits, labels) -> scalar`` for one rank's rows; default
        the mean cross-entropy.
      compress: None | "bf16" | "int8", the gradient wire compression (int8:
        one mesh axis only). Counts stay f32.
      error_feedback: carry each rank's compression residual into its next
        contribution; requires ``compress``.
      overlap: sync each parameter leaf inside the backward, one sync a leaf
        (no ``bucket_size``: the leaf is the bucket).
      device: the mesh's device unless given; a different one raises.

    The JAX trainer's ``example_input`` and ``seed`` have no counterpart:
    the model arrives built, with its weights drawn from its own seed.
    """

    def __init__(
        self,
        model: nn.Module,
        mesh: RankMesh,
        *,
        optimizer: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer] | None = None,
        learning_rate: float = 0.1,
        bucket_size: int | None = None,
        loss_fn: Callable | None = None,
        compress: str | None = None,
        error_feedback: bool = False,
        overlap: bool = False,
        device: str | torch.device | None = None,
    ) -> None:
        if overlap and bucket_size is not None:
            raise ValueError(
                "overlap issues ONE collective per param leaf inside the "
                "backward pass; bucket_size does not compose with it")
        if compress not in (None, "bf16", "int8"):
            raise ValueError(f"compress must be None, 'bf16' or 'int8', got {compress!r}")
        if compress == "int8" and len(mesh.axis_names) != 1:
            raise ValueError(
                "int8 grad sync rides the explicit ring schedule, which "
                f"reduces over ONE mesh axis; got axes {mesh.axis_names}")
        if error_feedback and compress not in ("bf16", "int8"):
            raise ValueError(
                "error_feedback requires compress='bf16' or 'int8' (lossless "
                "sync has no residual to carry)")
        if bucket_size is not None and bucket_size <= 0:
            raise ValueError(f"bucket_size must be positive, got {bucket_size}")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.n_devices = mesh.size
        self.data_shards = self.n_devices  # train_chain streams: one per rank
        self.device = mesh.device
        self.model = model.to(self.device)
        self.bucket_size = bucket_size
        self.compress = compress
        self.error_feedback = error_feedback
        self.overlap = overlap
        self._loss = loss_fn or default_classification_loss()
        named = dict(self.model.named_parameters())
        self._names = leaf_order(self.model)
        self._params = [named[n] for n in self._names]
        self._sizes = [p.numel() for p in self._params]
        self.param_count = sum(self._sizes)
        make = optimizer or (lambda ps: torch.optim.SGD(ps, lr=learning_rate))
        self.optimizer = make(self._params)
        self._ef = (torch.zeros((self.n_devices, self.param_count), device=self.device)
                    if error_feedback else None)
        self.step_num = 0
        # name -> the per-rank rows of the latest sync (utils.verify), or None
        self._replica_log: dict[str, torch.Tensor] | None = None

        rank_loss = rank_loss_fn(self.model, self._loss)
        self._rank_grads = vmap(grad_and_value(rank_loss), in_dims=(None, 0, 0))
        # overlap: every rank's loss on its own (n, *leaf) broadcast of each leaf
        self._rank_losses = vmap(rank_loss, in_dims=(0, 0, 0))
        if not overlap:
            self._leaf_sync = None
        elif compress == "int8":
            self._leaf_sync = backward_ring_sync(mesh, compress="int8",
                                                 error_feedback=error_feedback)
        else:
            make = backward_sync_ef if error_feedback else backward_psum_sync
            self._leaf_sync = make(mesh, self.axis_names,
                                   torch.bfloat16 if compress == "bf16" else None)

    # -- the three stages of a step ------------------------------------------

    def rank_gradients(self, x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Every rank's gradient of its mean loss on its rows of the global
        batch ``x``/``y`` (device tensors, ``n·b`` rows): the ``(n, P)`` f32
        stack in flat-vector order and the ``(n,)`` losses."""
        return self._rank_stack(*self._split(x, y))

    def _split(self, x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The global batch as ``(n, b, ...)``: rank r's rows ``[r·b, (r+1)·b)``."""
        n = self.n_devices
        return (x.reshape(n, x.shape[0] // n, *x.shape[1:]),
                y.reshape(n, y.shape[0] // n, *y.shape[1:]))

    def _rank_stack(self, xs: torch.Tensor, ys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        n = self.n_devices
        params = {name: p.detach() for name, p in zip(self._names, self._params)}
        with ieee_f32():  # the backward's convs too
            grads, losses = self._rank_grads(params, xs, ys)
        stack = torch.cat([grads[name].reshape(n, -1).float() for name in self._names], dim=1)
        return stack, losses.float()

    def _hand_out(self, name: str, rows: torch.Tensor) -> torch.Tensor:
        """What a sync hands the ranks: the ``(n, ...)`` per-rank rows, of
        which every rank takes rank 0's. Kept for ``utils.verify`` while
        it watches the trainer."""
        if self._replica_log is not None:
            self._replica_log[name] = rows
        return rows[0]

    def sync(self, stack: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The threshold-masked average of the rank stack under the ``(n,)``
        f32 mask ``v``: ``(average (P,), count)``. Advances the EF state."""
        if self.compress is None:
            return masked_average(stack, v)
        count = v.sum()
        c = ef_fold(stack, self._ef)
        if self.compress == "int8":
            masked = c * v[:, None]
            if self._ef is None:
                total = ring_allreduce_sum(masked, compress="int8")
            else:
                total, hop_err = ring_allreduce_sum(masked, compress="int8",
                                                    return_residual=True)
                self._ef = ring_ef_residual(c, v, hop_err)
            return self._hand_out("grad_sum", total) / torch.clamp_min(count, 1.0), count
        p = stack.shape[1]
        b = self.bucket_size or p
        per_bucket = v[:, None].expand(self.n_devices, _num_buckets(p, b))
        total, cnt = masked_psum(self.mesh, c, per_bucket, self.axis_names,
                                 bucket_size=b, wire_dtype=torch.bfloat16)
        if self._ef is not None:
            self._ef = ef_residual(c, v)
        cnt0 = self._hand_out("grad_count", cnt)
        return (self._hand_out("grad_sum", total)
                / torch.clamp_min(expand_counts(cnt0, p, b), 1.0)), count

    def apply_gradients(self, average: torch.Tensor) -> None:
        """One optimizer step from the averaged flat gradient ``(P,)``."""
        for p, g in zip(self._params, torch.split(average, self._sizes)):
            p.grad = g.view(p.shape)
        self._optimizer_step()

    def _optimizer_step(self) -> None:
        """The optimizer's step from the leaves' ``.grad``, which it drops."""
        self.optimizer.step()
        for p in self._params:
            p.grad = None

    # -- stepping ------------------------------------------------------------

    def _step(self, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor):
        """One step on device tensors; returns the (loss, contributors)
        device scalars (no host read)."""
        if self.overlap:
            losses, count = self._overlapped_step(*self._split(x, y), v), v.sum()
        else:
            stack, losses = self.rank_gradients(x, y)
            average, count = self.sync(stack, v)
            del stack
            self.apply_gradients(average)
        return (losses * v).sum() / torch.clamp_min(count, 1.0), count

    def _ef_leaves(self) -> list[torch.Tensor | None]:
        """Each leaf's ``(n, *leaf)`` view into the ``(n, P)`` EF residual,
        cut in flat order (None without EF)."""
        if self._ef is None:
            return [None] * len(self._params)
        views, start = [], 0
        for p, size in zip(self._params, self._sizes):
            views.append(self._ef[:, start:start + size].view(self.n_devices, *p.shape))
            start += size
        return views

    def _overlapped_step(self, xs: torch.Tensor, ys: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Per-leaf syncs inside the backward: each leaf reaches the ranks
        through its sync, ``backward()`` of the unmasked sum of the ranks'
        mean losses runs each leaf's sync once its cotangent stack is ready
        (the sync masks it: a mask in the loss too would square it) and
        leaves the synced average in the leaf's ``.grad``; then the
        optimizer steps. Returns the ``(n,)`` rank losses."""
        handed = {}
        for name, p, e in zip(self._names, self._params, self._ef_leaves()):
            hand_out = functools.partial(self._hand_out, name)
            args = (p, v) if e is None else (p, e, v)
            handed[name] = self._leaf_sync(*args, hand_out=hand_out)
        with ieee_f32():  # the backward's convs too
            losses = self._rank_losses(handed, xs, ys)
            losses.sum().backward()
        self._optimizer_step()
        return losses.detach().float()

    def _valid(self, valid: Sequence[float] | None) -> torch.Tensor:
        return torch.from_numpy(normalize_valid(valid, self.n_devices)).to(self.device)

    def _place_batch(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        if x.shape[0] % self.n_devices:
            raise ValueError(f"global batch {x.shape[0]} not divisible by {self.n_devices}")
        return (torch.as_tensor(x).to(self.device, torch.float32),
                torch.as_tensor(y).to(self.device, torch.int64))

    def train_step(self, x, y, valid: Sequence[float] | None = None) -> TrainStepMetrics:
        """One DP step on the global batch ``x``/``y`` (numpy or tensors;
        the row count divisible by the rank count). ``valid`` is the (n,)
        contributor mask; None = every rank contributes."""
        v = self._valid(valid)
        xd, yd = self._place_batch(x, y)
        return self._finish_step(*self._step(xd, yd, v))

    def _finish_step(self, loss: torch.Tensor, count: torch.Tensor) -> TrainStepMetrics:
        """Count the step and read its (loss, contributors) device scalars."""
        self.step_num += 1
        loss, cnt = torch.stack([loss, count]).tolist()
        return TrainStepMetrics(step=self.step_num, loss=loss, contributors=cnt)

    def train(
        self,
        batches: Iterable,
        valid_schedule: Callable[[int], Sequence[float]] | None = None,
    ) -> list[TrainStepMetrics]:
        history = []
        for x, y in batches:
            valid = valid_schedule(self.step_num) if valid_schedule else None
            history.append(self.train_step(x, y, valid))
        return history

    def train_step_accum(self, x, y, accum_steps: int,
                         valid: Sequence[float] | None = None) -> TrainStepMetrics:
        """One optimizer step over the global batch ``x``/``y`` split into
        ``accum_steps`` microbatches a rank (the row count divisible by
        ``n · accum_steps``): rank r's rows ``[r·b, (r+1)·b)`` in
        ``accum_steps`` consecutive microbatches, their gradient stacks
        summed and divided by ``accum_steps``, then the ONE sync of the plain
        step (K1 in f32, bucketed or not; the bf16 ``masked_psum``; the int8
        ring with its per-hop EF). The loss is ``sum_r v_r (lsum_r /
        accum_steps) / max(count, 1)``."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps == 1:  # the same arithmetic: the plain step
            return self.train_step(x, y, valid)
        if self.overlap:
            raise NotImplementedError(
                "overlap is pointless under gradient accumulation: every leaf's "
                "gradient depends on the whole accumulation, so per-leaf syncs "
                "could never run behind the backward; use accumulation without overlap")
        n = self.n_devices * accum_steps
        if x.shape[0] % n:
            raise ValueError(f"global batch {x.shape[0]} not divisible by {self.n_devices} "
                             f"ranks x {accum_steps} accumulation steps")
        v = self._valid(valid)
        xd, yd = self._place_batch(x, y)
        micro = x.shape[0] // n
        xs = xd.reshape(self.n_devices, accum_steps, micro, *xd.shape[1:])
        ys = yd.reshape(self.n_devices, accum_steps, micro, *yd.shape[1:])
        gsum = lsum = None
        for a in range(accum_steps):
            stack, losses = self._rank_stack(xs[:, a], ys[:, a])
            gsum = stack if gsum is None else gsum.add_(stack)
            lsum = losses if lsum is None else lsum + losses
        del stack
        average, count = self.sync(gsum.div_(accum_steps), v)
        del gsum
        self.apply_gradients(average)
        return self._finish_step((lsum * v / accum_steps).sum() / torch.clamp_min(count, 1.0),
                                 count)

    def accuracy(self, x, y) -> float:
        xd, yd = self._place_batch(x, y)
        with torch.no_grad():
            hits = (self.model(xd).argmax(-1) == yd).sum()
        return float(hits) / xd.shape[0]

    def train_chain(
        self,
        sampler,
        steps: int,
        batch_per_device: int,
        *,
        valid: Sequence[float] | None = None,
        seed: int = 0,
        fetch_metrics: bool = True,
    ) -> list[TrainStepMetrics] | tuple[torch.Tensor, torch.Tensor]:
        """Run ``steps`` DP steps with batches drawn on the device.

        ``sampler`` is ``(generator, rows) -> (x, y)``
        (``SyntheticClassification.device_sampler``); each step draws the
        ``n·batch_per_device`` rows of all ranks at once and rank ``r`` takes
        its block, as ``train_step`` splits a global batch. The generator is
        seeded from ``seed`` and ``step_num``, so consecutive chains continue
        the data stream. Losses and counts stay on the device until the
        chain ends: one host read, or none with ``fetch_metrics=False``,
        which returns the ``(losses, counts)`` device tensors.
        """
        if steps < 1:
            raise ValueError(f"need steps >= 1, got {steps}")
        v = self._valid(valid)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((seed * 2**32 + self.step_num) % 2**63)
        losses, counts = [], []
        for _ in range(steps):
            x, y = sampler(gen, self.n_devices * batch_per_device)
            loss, cnt = self._step(x, y, v)
            losses.append(loss)
            counts.append(cnt)
        losses, counts = torch.stack(losses), torch.stack(counts)
        if not fetch_metrics:
            self.step_num += steps
            return losses, counts
        out = []
        for loss, cnt in zip(*torch.stack([losses, counts]).tolist()):
            self.step_num += 1
            out.append(TrainStepMetrics(step=self.step_num, loss=loss, contributors=cnt))
        return out

    # -- the binder seam -----------------------------------------------------

    def get_flat_params(self) -> np.ndarray:
        """The parameters as one host f32 vector in the JAX trainer's leaf
        order (``binder.leaf_order``)."""
        return self.flat_params_tensor().cpu().numpy()

    def flat_params_tensor(self) -> torch.Tensor:
        """The same vector as a new f32 tensor on the trainer's device."""
        return flat_tensor(self.model)

    def set_flat_params(self, vec: np.ndarray | torch.Tensor) -> None:
        """Replace the parameters from a flat f32 vector in that order (a
        JAX trainer's ``get_flat_params`` loads here unchanged); a tensor is
        copied on its device, with no trip through the host."""
        load_flat_tensor(self.model, vec)
