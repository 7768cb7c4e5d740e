"""ZeRO-1 data-parallel trainer over n virtual ranks: the optimizer state in
shards, one a rank.

Counterpart of ``akka_allreduce_tpu/train/zero1.py`` (``Zero1DPTrainer``)
on a one-axis ``RankMesh``. The weights are one flat f32 vector in the JAX
package's leaf order (``binder.leaf_order``), padded to ``shard · n``; rank
r owns columns ``[r·shard, (r+1)·shard)`` of it. A step is:

- every rank's gradient of its mean loss on its rows, as ``DPTrainer``
  computes them (``vmap`` of ``grad_and_value`` over ``functional_call``),
  laid out as the ``(n, padded)`` stack;
- the masked reduce-scatter: in f32, K1 (``ops.local_reduce.masked_average``,
  once a step) averages the stack under the ``(n,)`` mask, and rank r's
  gradient shard is columns ``[r·shard, (r+1)·shard)`` of the average; with
  ``compress="bf16"`` the wire is bf16, mask then cast, through
  ``comm.allreduce.masked_psum``'s arithmetic (each rank's payload cast to
  bf16, the sum in f32 in rank order and rounded to bf16 once), divided by
  ``max(count, 1)``, and with ``error_feedback`` each rank keeps the
  ``(n, padded)`` residual ``e' = c - bf16(c·v)`` of ``c = g + e``;
- each rank's optimizer (one a rank, from the optimizer factory) updates
  its own shard of the weights from its gradient shard and its own state,
  as ``tx.update(gshard, opt_state, pshard)`` does;
- the all-gather: each shard is a view of the one flat vector, so the
  update writes it back in place.

The checkpoint protocol (v2) serializes the state unpadded, independent of
the rank count, under the JAX trainer's key names for SGD and Adam
(``['opt_state'][0].mu`` and so on), so the two packages' delta stores
restore into each other.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad_and_value, vmap

from akka_allreduce_tpu_torch._device import ieee_f32, resolve_device
from akka_allreduce_tpu_torch.binder.api import leaf_order
from akka_allreduce_tpu_torch.comm.allreduce import masked_psum
from akka_allreduce_tpu_torch.ops.local_reduce import masked_average
from akka_allreduce_tpu_torch.parallel.mesh import RankMesh
from akka_allreduce_tpu_torch.train.checkpoint import ShapeDtype, host_tree
from akka_allreduce_tpu_torch.train.trainer import (
    TrainStepMetrics,
    default_classification_loss,
    ef_fold,
    ef_residual,
    normalize_valid,
    rank_loss_fn,
)

_log = logging.getLogger(__name__)


# optax's state types, for the JAX trainer's key names in the v2 form
class ScaleByAdamState(NamedTuple):
    count: object
    mu: object
    nu: object


class TraceState(NamedTuple):
    trace: object


class EmptyState(NamedTuple):
    pass


class Zero1DPTrainer:
    """DP trainer with the optimizer state sharded over the ranks.

    Args:
      model: an ``nn.Module`` whose parameters map to flax paths (the MLP);
        its weights, as built, seed the flat vector.
      mesh: the virtual ranks, ONE axis (the shard axis).
      optimizer: a factory ``parameters -> torch.optim.Optimizer``, called
        once a rank with that rank's shard; default
        ``torch.optim.Adam(parameters, lr=learning_rate)`` (optax's adam).
      loss_fn: ``(logits, labels) -> scalar``; default the mean cross-entropy.
      compress: None or "bf16", the gradient reduce-scatter's wire.
      error_feedback: carry each rank's bf16 residual (requires bf16).
      device: the mesh's device unless given; a different one raises.
    """

    def __init__(
        self,
        model: nn.Module,
        mesh: RankMesh,
        *,
        optimizer: Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer] | None = None,
        learning_rate: float = 0.1,
        loss_fn: Callable | None = None,
        compress: str | None = None,
        error_feedback: bool = False,
        device: str | torch.device | None = None,
    ) -> None:
        if len(mesh.axis_names) != 1:
            raise ValueError(f"zero-1 shards over ONE mesh axis, got {mesh.axis_names}")
        if compress not in (None, "bf16"):
            raise ValueError(f"compress must be None or 'bf16', got {compress!r}")
        if error_feedback and compress != "bf16":
            raise ValueError(
                "error_feedback requires compress='bf16' (same contract as "
                "DPTrainer: lossless sync has no residual to carry)")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        self.compress = compress
        self.error_feedback = error_feedback
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_devices = mesh.size
        self.data_shards = self.n_devices
        self.device = mesh.device
        self.model = model.to(self.device)
        self._loss = loss_fn or default_classification_loss()
        named = dict(self.model.named_parameters())
        self._names = leaf_order(self.model)
        self.param_count = sum(named[n].numel() for n in self._names)
        n = self.n_devices
        self._shard_size = -(-self.param_count // n)
        self._padded = self._shard_size * n
        with torch.no_grad():
            self.flat_params = torch.zeros(self._padded, device=self.device)
            self.flat_params[: self.param_count] = torch.cat(
                [named[name].detach().float().reshape(-1) for name in self._names])
        # the model reads its weights as views of the flat vector
        self._views, start = {}, 0
        for name in self._names:
            p = named[name]
            self._views[name] = self.flat_params[start:start + p.numel()].view(p.shape)
            start += p.numel()
        s = self._shard_size
        self._shards = [self.flat_params[r * s:(r + 1) * s] for r in range(n)]
        make = optimizer or (lambda ps: torch.optim.Adam(ps, lr=learning_rate))
        self.optimizers = [make([shard]) for shard in self._shards]
        # per-rank residual of the compressed reduce-scatter, in the wire's layout
        self._ef = (torch.zeros((n, self._padded), device=self.device)
                    if error_feedback else None)
        self.step_num = 0
        self._rank_grads = vmap(grad_and_value(rank_loss_fn(self.model, self._loss)),
                                in_dims=(None, 0, 0))

    # -- params as views / flat vector ---------------------------------------------

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The parameters by name: views of the flat vector."""
        return dict(self._views)

    def get_flat_params(self) -> np.ndarray:
        """The unpadded flat f32 vector in the JAX trainer's leaf order."""
        return self.flat_params[: self.param_count].to("cpu", copy=True).numpy()

    def flat_params_tensor(self) -> torch.Tensor:
        """The same vector as a new f32 tensor on the trainer's device."""
        return self.flat_params[: self.param_count].clone()

    def set_flat_params(self, vec: np.ndarray | torch.Tensor) -> None:
        """Replace the weights from a flat f32 vector (numpy, or a tensor
        copied on its device)."""
        if isinstance(vec, torch.Tensor):
            src = vec.detach()
        else:
            src = torch.from_numpy(np.array(vec, np.float32))
        if tuple(src.shape) != (self.param_count,):
            raise ValueError(
                f"expected flat params of shape ({self.param_count},), got {tuple(src.shape)}")
        with torch.no_grad():
            self.flat_params[: self.param_count].copy_(src)
            self.flat_params[self.param_count:].zero_()

    @property
    def optimizer_shard_elems(self) -> int:
        """Elements of each rank's shard of every sharded optimizer leaf."""
        return self._shard_size

    # -- the checkpoint protocol (v2) ---------------------------------------------

    #: v2: unpadded, independent of the rank count, with an ef_sum always
    _CKPT_FORMAT_VERSION = 2
    #: template keys a store may drop when an older checkpoint lacks them
    checkpoint_optional_keys = frozenset({"format_version", "ef_sum"})

    def _opt_kind(self) -> str:
        """Which optax state the optimizers' state maps to."""
        opt = self.optimizers[0]
        group = opt.param_groups[0]
        if type(opt) is torch.optim.Adam and not group["amsgrad"] \
                and not group.get("decoupled_weight_decay", False):
            return "adam"
        if type(opt) is torch.optim.SGD:
            return "trace" if group["momentum"] else "empty"
        raise NotImplementedError(
            f"{type(opt).__name__} has no checkpoint form here (SGD and Adam have: "
            "the JAX trainer's optax sgd and adam states)")

    def _rank_state(self, r: int) -> dict:
        return self.optimizers[r].state.get(self._shards[r], {})

    def checkpoint_capture(self) -> dict:
        """The device state, shard-local: the padded flat weights, each
        rank's optimizer tensors (zeros before the first step, as optax's
        init) and the residual. :meth:`checkpoint_assemble` turns its host
        form into the v2 form."""
        kind = self._opt_kind()
        n = self.n_devices

        def per_rank(key: str) -> list[torch.Tensor]:
            return [self._rank_state(r).get(key, torch.zeros_like(self._shards[r]))
                    for r in range(n)]

        if kind == "adam":
            opt = {"count": self._rank_state(0).get("step", torch.zeros(())),
                   "mu": per_rank("exp_avg"), "nu": per_rank("exp_avg_sq")}
        elif kind == "trace":
            opt = {"trace": per_rank("momentum_buffer")}
        else:
            opt = {}
        cap = {"flat_params": self.flat_params, "opt_state": opt}
        if self.error_feedback:
            cap["ef"] = self._ef
        return cap

    def checkpoint_assemble(self, host: dict) -> dict:
        """The v2 form of a captured host tree: pure numpy work (the async
        stores run it on their writer thread). Padding is stripped and the
        residual collapsed to its sum over the ranks."""
        count = self.param_count
        opt = host["opt_state"]

        def unpad(shards) -> np.ndarray:
            return np.concatenate([np.asarray(s, np.float32) for s in shards])[:count]

        if "mu" in opt:
            first = ScaleByAdamState(count=np.asarray(int(np.asarray(opt["count"])), np.int32),
                                     mu=unpad(opt["mu"]), nu=unpad(opt["nu"]))
        elif "trace" in opt:
            first = TraceState(trace=unpad(opt["trace"]))
        else:
            first = EmptyState()
        state = {
            "format_version": np.asarray(self._CKPT_FORMAT_VERSION, np.int32),
            "flat_params": np.asarray(host["flat_params"], np.float32).reshape(-1)[:count],
            "opt_state": (first, EmptyState()),
        }
        if "ef" in host:
            # the sum over the ranks is what the sync still owes; a restore
            # splits it evenly over its own ranks
            state["ef_sum"] = np.asarray(host["ef"], np.float32).sum(axis=0)[:count]
        else:
            # always present, so EF and non-EF checkpoints restore into each
            # other; zero is "nothing withheld"
            state["ef_sum"] = np.zeros(count, np.float32)
        return state

    def checkpoint_state(self) -> dict:
        """The v2 form, synchronously (through the host)."""
        return self.checkpoint_assemble(host_tree(self.checkpoint_capture()))

    def checkpoint_template(self) -> dict:
        """Shapes and dtypes of :meth:`checkpoint_state`, the restore target."""
        count = self.param_count
        vec = ShapeDtype((count,), np.float32)
        first = {"adam": ScaleByAdamState(ShapeDtype((), np.int32), vec, vec),
                 "trace": TraceState(vec), "empty": EmptyState()}[self._opt_kind()]
        return {
            "format_version": ShapeDtype((), np.int32),
            "flat_params": vec,
            "opt_state": (first, EmptyState()),
            "ef_sum": vec,
        }

    def restore_checkpoint_state(self, state: dict) -> None:
        """Place a v2 form on these ranks: the weights re-padded, each
        rank's optimizer state its re-padded shard, the residual's sum split
        evenly over the ranks; the rank count at save time does not matter."""
        version = int(np.asarray(state.pop("format_version", 2)))
        if version > self._CKPT_FORMAT_VERSION:
            raise ValueError(
                f"ZeRO-1 checkpoint format v{version} is newer than this build's "
                f"v{self._CKPT_FORMAT_VERSION}; upgrade the package to restore it")
        count, n, s = self.param_count, self.n_devices, self._shard_size
        pad = self._padded - count
        self.set_flat_params(np.asarray(state["flat_params"]))

        def shards(leaf) -> list[torch.Tensor]:
            arr = np.asarray(leaf, np.float32)
            if arr.shape != (count,):
                raise ValueError(f"optimizer leaf shape {arr.shape} != ({count},): "
                                 "restore into a trainer with the same model")
            arr = np.pad(arr, (0, pad))
            return [torch.from_numpy(arr[r * s:(r + 1) * s].copy()) for r in range(n)]

        first = state["opt_state"][0]
        if isinstance(first, ScaleByAdamState):
            step = torch.tensor(float(np.asarray(first.count)), dtype=torch.float32)
            mu, nu = shards(first.mu), shards(first.nu)
            per = [{"step": step.clone(), "exp_avg": mu[r], "exp_avg_sq": nu[r]}
                   for r in range(n)]
        elif isinstance(first, TraceState):
            per = [{"momentum_buffer": t} for t in shards(first.trace)]
        else:
            per = [{} for _ in range(n)]
        for opt, entry in zip(self.optimizers, per):
            opt.load_state_dict({"state": {0: entry} if entry else {},
                                 "param_groups": opt.state_dict()["param_groups"]})
        if self.error_feedback:
            if "ef_sum" in state:
                ef_sum = np.asarray(state["ef_sum"], np.float32)
                per_rank = np.pad(np.tile(ef_sum / n, (n, 1)), ((0, 0), (0, pad)))
                self._ef = torch.from_numpy(per_rank).to(self.device, copy=True)
            else:
                # an old checkpoint without a residual: a stale live one would
                # inject the previous run's withheld gradients
                self._ef = torch.zeros_like(self._ef)
        elif "ef_sum" in state and np.any(np.asarray(state["ef_sum"])):
            _log.warning(
                "checkpoint carries a NONZERO error-feedback residual but this "
                "trainer has error_feedback off: the withheld gradient mass is "
                "dropped (enable error_feedback to apply it)")

    # -- stepping --------------------------------------------------------------------

    def _valid(self, valid: Sequence[float] | None) -> torch.Tensor:
        return torch.from_numpy(normalize_valid(valid, self.n_devices)).to(self.device)

    def _place_batch(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        if x.shape[0] % self.n_devices:
            raise ValueError(f"global batch {x.shape[0]} not divisible by {self.n_devices}")
        return (torch.as_tensor(x).to(self.device, torch.float32),
                torch.as_tensor(y).to(self.device, torch.int64))

    def rank_gradients(self, x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Every rank's gradient on its rows of the global batch: the
        ``(n, padded)`` f32 stack (zeros past the parameters) and the
        ``(n,)`` losses."""
        n = self.n_devices
        xs = x.reshape(n, x.shape[0] // n, *x.shape[1:])
        ys = y.reshape(n, y.shape[0] // n, *y.shape[1:])
        with ieee_f32():
            grads, losses = self._rank_grads(self._views, xs, ys)
        parts = [grads[name].reshape(n, -1).float() for name in self._names]
        if self._padded > self.param_count:
            parts.append(torch.zeros((n, self._padded - self.param_count), device=self.device))
        return torch.cat(parts, dim=1), losses.float()

    def reduce_scatter(self, stack: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The masked average of the ``(n, padded)`` stack under the ``(n,)``
        mask, ``(average, count)``: rank r's shard is its columns ``[r·shard,
        (r+1)·shard)``. Advances the EF state."""
        if self.compress is None:
            return masked_average(stack, v)
        c = ef_fold(stack, self._ef)
        total, cnt = masked_psum(self.mesh, c, v, self.axis, wire_dtype=torch.bfloat16)
        if self._ef is not None:
            self._ef = ef_residual(c, v)
        return total[0] / torch.clamp_min(cnt[0], 1.0), cnt[0]

    def apply_shards(self, average: torch.Tensor) -> None:
        """Each rank's optimizer step on its shard, from its columns of the
        average; the update lands in the flat vector (the all-gather)."""
        s = self._shard_size
        for r, (opt, shard) in enumerate(zip(self.optimizers, self._shards)):
            shard.grad = average[r * s:(r + 1) * s]
            opt.step()
            shard.grad = None

    def train_step(self, x, y, valid: Sequence[float] | None = None) -> TrainStepMetrics:
        """One step on the global batch ``x``/``y`` (numpy or tensors, the
        row count divisible by the rank count); ``valid`` is the (n,)
        contributor mask, None = every rank contributes."""
        v = self._valid(valid)
        stack, losses = self.rank_gradients(*self._place_batch(x, y))
        average, count = self.reduce_scatter(stack, v)
        del stack
        self.apply_shards(average)
        loss = (losses * v).sum() / torch.clamp_min(count, 1.0)
        self.step_num += 1
        loss, cnt = torch.stack([loss, count]).tolist()
        return TrainStepMetrics(step=self.step_num, loss=loss, contributors=cnt)

    def accuracy(self, x, y) -> float:
        """Hits over the rows of the global batch."""
        xd, yd = self._place_batch(x, y)
        with torch.no_grad():
            hits = (functional_call(self.model, self._views, (xd,)).argmax(-1) == yd).sum()
        return float(hits) / xd.shape[0]
