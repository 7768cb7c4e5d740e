"""Long-context trainer of the Transformer LM: DP x SP (x TP) over virtual ranks.

Counterpart of ``akka_allreduce_tpu/train/long_context.py``
(``LongContextTrainer``) on a (data, seq) mesh (``data_seq_mesh``) or a
(data, seq, model) mesh (``data_seq_model_mesh``) of virtual ranks on one
device (``parallel.mesh``). Every rank computes on its own shard, the ranks
folded into the batch of each call (``models.transformer``'s rank mode):
its rows of the batch, its ``seq_len / sp`` columns, and under TP its
``H / tp`` heads and ``hidden / tp`` MLP units. The trainer keeps one
full-shape f32 copy of each parameter (the model's); a rank sees its view
(``parallel.mesh.rank_view`` under ``models.transformer.tp_param_specs``).

A step is the JAX step:

- the global (batch, seq_len) tokens split as ``P(data, seq)`` lays them
  out: rank (d, s, m) takes rows ``[d·B_l, (d+1)·B_l)`` and columns
  ``[s·T_l, (s+1)·T_l)``, every model rank of a group the same;
- each rank's loss term is ``sum(ce) * v / denom``, ``v`` its replica
  row's contributor bit and ``denom = max(sum over ranks of v·B_l·T_l,
  1)`` (``psum(v * tokens_local)`` over every axis); under TP every model
  rank computes the same term, so the tp-fold factor is in both the sums
  and the denominator;
- the gradient takes one of three paths: ``overlap`` syncs each leaf inside
  the backward (``comm.allreduce.overlap_value_and_grad``, the loss
  unmasked, ``v`` folded back into the metric); ``compress`` "bf16" or
  "int8" one grouped collective a sharding class
  (``compressed_value_and_grad``); otherwise the same grouped sum in f32,
  in which the class over every axis is K1 (once a step on the card;
  under ``overlap`` once a leaf);
- ``loss`` is the sum of the ranks' terms, ``contributors`` the sum of
  ``valid`` over the replica rows; then Adam with optax's defaults (b1
  0.9, b2 0.999, eps 1e-8, bias-corrected), which ``torch.optim.Adam``
  computes, steps the full-shape parameters.

At one seq shard both ``seq_impl`` values are ``local_attention``, as in
the JAX model. ``train_chain`` draws each replica row's batches with its own
``torch.Generator`` on the device (each seq rank of the row slices its
columns from them) and keeps the per-step losses there until the chain
ends: one host read a chain, the JAX chain's "no host I/O inside the loop".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.binder.api import flat_tensor, leaf_order, load_flat_tensor
from akka_allreduce_tpu_torch.comm.allreduce import (
    compressed_value_and_grad,
    overlap_value_and_grad,
    validate_trainer_compress,
)
from akka_allreduce_tpu_torch.models.transformer import SEQ_IMPLS, TransformerLM
from akka_allreduce_tpu_torch.parallel.mesh import RankMesh, data_seq_mesh
from akka_allreduce_tpu_torch.train.trainer import normalize_valid

# a replica row's data stream: seeds of rows d and d + 1 this far apart
_ROW_SEED_STRIDE = 0x9E3779B97F4A7C15


@dataclasses.dataclass
class LongContextStepMetrics:
    step: int
    loss: float  # masked per-token average cross-entropy
    contributors: float  # contributing DP replica rows


class LongContextTrainer:
    """DP x SP (x TP) trainer of a :class:`~..models.TransformerLM` over a
    mesh of virtual ranks.

    Args:
      mesh: a (data, seq) ``RankMesh`` (``data_seq_mesh``) or a (data, seq,
        model) one (``data_seq_model_mesh``): the third axis adds
        Megatron-style tensor parallelism. None: a 1 x 1 ``data_seq_mesh``
        on ``device``.
      seq_len: the GLOBAL sequence length (divisible by the seq axis size).
      seq_impl: "ring" or "ulysses".
      optimizer: a factory ``parameters -> torch.optim.Optimizer``; default
        ``torch.optim.Adam(parameters, lr=learning_rate)``.
      compute_dtype: ``torch.float32`` or ``torch.bfloat16`` (parameters and
        Adam moments stay f32).
      remat: recompute each block in the backward (``TransformerLM``).
      compress: None, "bf16" or "int8": the gradient sums' wire.
      overlap: one sync a leaf inside the backward (not with "int8").
      device: the card unless ``"cpu"``; taken from ``mesh`` when one is
        given.
    """

    def __init__(
        self,
        mesh: RankMesh | None = None,
        *,
        vocab: int = 64,
        d_model: int = 64,
        n_heads: int = 4,
        n_kv_heads: int | None = None,
        n_layers: int = 2,
        seq_len: int = 128,
        seq_impl: str = "ring",
        optimizer: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]
        | None = None,
        learning_rate: float = 0.1,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        remat: bool = False,
        compress: str | None = None,
        overlap: bool = False,
        device: str | torch.device | None = None,
    ) -> None:
        self.compress = validate_trainer_compress(compress, overlap=overlap)
        self.overlap = overlap
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(f"seq_impl must be one of {SEQ_IMPLS}, got {seq_impl!r}")
        if mesh is None:
            mesh = data_seq_mesh(1, 1, device=device)
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        if len(mesh.axis_names) not in (2, 3):
            raise ValueError(
                f"need a (data, seq[, model]) mesh, got axes {mesh.axis_names}")
        self.mesh = mesh
        self.data_axis, self.seq_axis = mesh.axis_names[:2]
        self.model_axis = mesh.axis_names[2] if len(mesh.axis_names) == 3 else None
        self.dp, self.sp = mesh.sizes[:2]
        self.tp = mesh.sizes[2] if self.model_axis else 1
        self.n_devices = self.dp * self.sp * self.tp
        self.data_shards = self.dp  # train_chain streams: one per replica row
        if seq_len % self.sp:
            raise ValueError(f"seq_len={seq_len} not divisible by seq shards {self.sp}")
        self.seq_len = seq_len
        self.seq_impl = seq_impl
        self.vocab = vocab
        self.device = mesh.device
        self.model = TransformerLM(
            vocab=vocab, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            n_layers=n_layers, compute_dtype=compute_dtype, seed=seed,
            device=self.device, remat=remat, seq_axis=self.seq_axis, seq_impl=seq_impl,
            model_axis=self.model_axis if self.tp > 1 else None, tp_size=self.tp,
        )
        self.n_layers = n_layers
        named = dict(self.model.named_parameters())
        self._params = {name: named[name] for name in leaf_order(self.model)}
        self._specs = self.model.param_specs()
        make = optimizer or (lambda ps: torch.optim.Adam(ps, lr=learning_rate))
        self.optimizer = make(self.model.parameters())
        self.param_count = sum(p.numel() for p in self.model.parameters())
        self.step_num = 0

    # -- stepping ------------------------------------------------------------

    def rank_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The global (batch, seq_len) tokens as the rank stack (n_devices,
        B_l, T_l): rank (d, s, m) holds rows ``[d·B_l, (d+1)·B_l)`` and
        columns ``[s·T_l, (s+1)·T_l)``."""
        dp, sp, tp = self.dp, self.sp, self.tp
        bl, tl = x.shape[0] // dp, self.seq_len // sp
        g = x.reshape(dp, bl, sp, tl).permute(0, 2, 1, 3)[:, :, None]
        return g.expand(dp, sp, tp, bl, tl).reshape(self.n_devices, bl, tl)

    def _step(self, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor):
        """One step on the global device tensors ``x``/``y`` under the (dp,)
        mask ``v``; returns the (loss, contributors) device scalars."""
        self.optimizer.zero_grad(set_to_none=True)
        xs, ys = self.rank_tokens(x), self.rank_tokens(y)
        v_rank = v.repeat_interleave(self.sp * self.tp)  # (n_devices,)
        denom = torch.clamp_min((v_rank * float(xs[0].numel())).sum(), 1.0)
        mesh, model = self.mesh, self.model

        def loss_terms(views, masked: bool):
            logits = model(xs, mesh=mesh, params=views)  # (R, B_l, T_l, vocab) f32
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 ys.reshape(-1).long(), reduction="none")
            ce = ce.reshape(self.n_devices, -1).sum(1)
            return (ce * v_rank if masked else ce) / denom

        if self.overlap:
            lval, grads = overlap_value_and_grad(
                lambda views: loss_terms(views, False), self._params, self._specs, mesh,
                v_rank, wire_dtype=self.compress)
            lval = lval * v_rank
        else:
            lval, grads = compressed_value_and_grad(
                lambda views: loss_terms(views, True), self._params, self._specs, mesh,
                wire_dtype=self.compress)
        for name, p in self._params.items():
            p.grad = grads[name]
        del grads
        self.optimizer.step()
        return lval.sum(), v.sum()

    def _tokens(self, a, what: str) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        if t.ndim != 2 or t.shape[1] != self.seq_len or t.shape[0] % self.dp:
            raise ValueError(
                f"{what} must be (batch, {self.seq_len}) with batch divisible by "
                f"dp={self.dp}, got {tuple(t.shape)}")
        return t.to(self.device, torch.int64)

    def _valid(self, valid: Sequence[float] | None) -> torch.Tensor:
        return torch.from_numpy(normalize_valid(valid, self.dp)).to(self.device)

    def train_step(
        self,
        tokens,
        labels,
        valid: Sequence[float] | None = None,
    ) -> LongContextStepMetrics:
        """One step on a GLOBAL (batch, seq_len) token array (numpy or
        tensor).

        ``valid``: the per-replica-row contributor mask of shape (dp,);
        None = all rows contribute.
        """
        v = self._valid(valid)
        x, y = self._tokens(tokens, "tokens"), self._tokens(labels, "labels")
        loss, cnt = self._step(x, y, v)
        self.step_num += 1
        loss, cnt = torch.stack([loss, cnt]).tolist()
        return LongContextStepMetrics(step=self.step_num, loss=loss, contributors=cnt)

    def train(self, batches: Iterable) -> list[LongContextStepMetrics]:
        return [self.train_step(x, y) for x, y in batches]

    def train_chain(
        self,
        sampler,
        steps: int,
        rows_per_replica: int,
        *,
        valid: Sequence[float] | None = None,
        seed: int = 0,
    ) -> list[LongContextStepMetrics]:
        """Run ``steps`` steps with batches drawn on the device.

        ``sampler`` is ``(generator, rows) -> (tokens, labels)`` of GLOBAL
        (rows, seq_len) sequences (``SyntheticCopyLM.device_sampler``). Each
        replica row draws its own stream from a generator on the trainer's
        device, seeded from ``seed``, ``step_num`` and the row, so that
        consecutive chains continue the streams instead of replaying them;
        the row's seq ranks slice their columns from it. Losses and
        contributor counts stay on the device until the chain ends: one
        host read a chain.
        """
        if steps < 1:
            raise ValueError(f"need steps >= 1, got {steps}")
        v = self._valid(valid)
        base = seed * 2**32 + self.step_num
        gens = [torch.Generator(device=self.device).manual_seed(
            (base + d * _ROW_SEED_STRIDE) % 2**63) for d in range(self.dp)]
        losses, counts = [], []
        for _ in range(steps):
            rows = [sampler(gen, rows_per_replica) for gen in gens]
            x = torch.cat([r[0] for r in rows])
            y = torch.cat([r[1] for r in rows])
            loss, cnt = self._step(x, y, v)
            losses.append(loss)
            counts.append(cnt)
        host = torch.stack([torch.stack(losses), torch.stack(counts)]).cpu().tolist()
        out = []
        for loss, cnt in zip(*host):
            self.step_num += 1
            out.append(LongContextStepMetrics(step=self.step_num, loss=loss,
                                              contributors=cnt))
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
