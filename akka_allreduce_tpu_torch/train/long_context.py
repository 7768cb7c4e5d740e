"""Long-context trainer of the Transformer LM, on one card.

Counterpart of ``akka_allreduce_tpu/train/long_context.py``
(``LongContextTrainer``) on a ``data_seq_mesh(1, 1)``: one data-parallel
replica row and one sequence shard, which is how the JAX package trains its
flagship LM on one chip (``bench_mfu.py``'s ``run_lm``, ``train-lm``,
``lm-generate --train-steps``).

A step is the JAX step with every collective of size one:

- the loss is the masked per-token average cross-entropy
  ``sum(ce) * v / max(v * B * T, 1)``, with ``v`` the replica row's
  contributor bit (``valid``) and ``contributors = v``;
- ``loss.backward()`` gives the gradient (through K4's forward and backward
  on gated shapes, ``ops.flash_attention.FlashAttention``);
- the optimizer steps: by default Adam with optax's defaults (b1 0.9,
  b2 0.999, eps 1e-8, bias-corrected), which ``torch.optim.Adam`` computes.

At sp = 1 both ``seq_impl`` values reduce to ``local_attention``, as the JAX
model's ``ring_attention`` call does, so both are accepted. Data, sequence
and tensor parallelism (dp, sp or tp above 1), gradient ``compress`` and
``overlap`` need several ranks and are refused as not ported yet.

``train_chain`` draws its batches on the card with a ``torch.Generator``
(``SyntheticCopyLM.device_sampler``) and keeps the per-step losses there
until the chain ends: one host read a chain, the JAX chain's "no host I/O
inside the loop".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.binder.api import flat_tensor, load_flat_tensor
from akka_allreduce_tpu_torch.models.transformer import TransformerLM
from akka_allreduce_tpu_torch.parallel.mesh import RankMesh, data_seq_mesh
from akka_allreduce_tpu_torch.train.trainer import normalize_valid

SEQ_IMPLS = ("ring", "ulysses")


@dataclasses.dataclass
class LongContextStepMetrics:
    step: int
    loss: float  # masked per-token average cross-entropy
    contributors: float  # contributing DP replica rows


class LongContextTrainer:
    """The LM trainer on a (data, seq) mesh of one replica row and one
    sequence shard.

    Args:
      mesh: None (a 1 x 1 ``data_seq_mesh`` on ``device``) or a
        ``RankMesh`` with axes (data, seq[, model]) of size 1 each.
      seq_len: the sequence length every batch must have.
      seq_impl: "ring" or "ulysses" (the same attention at sp = 1).
      optimizer: a factory ``parameters -> torch.optim.Optimizer``; default
        ``torch.optim.Adam(parameters, lr=learning_rate)``.
      compute_dtype: ``torch.float32`` or ``torch.bfloat16`` (parameters and
        Adam moments stay f32).
      remat: recompute each block in the backward (``TransformerLM``).
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
        if compress is not None:
            raise NotImplementedError(
                f"compress={compress!r} is not ported yet (gradient wire "
                "compression needs several ranks)")
        if overlap:
            raise NotImplementedError(
                "overlap is not ported yet (per-leaf collectives need several ranks)")
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
        self.dp, self.sp = mesh.sizes[:2]
        self.tp = mesh.sizes[2] if len(mesh.sizes) == 3 else 1
        if (self.dp, self.sp, self.tp) != (1, 1, 1):
            raise NotImplementedError(
                f"dp={self.dp}, sp={self.sp}, tp={self.tp}: data, sequence and "
                "tensor parallelism are not ported yet (only a 1 x 1 mesh)")
        self.n_devices = 1
        self.data_shards = self.dp  # train_chain streams: one per replica row
        self.seq_len = seq_len
        self.seq_impl = seq_impl
        self.vocab = vocab
        self.device = mesh.device
        self.model = TransformerLM(
            vocab=vocab, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            n_layers=n_layers, compute_dtype=compute_dtype, seed=seed,
            device=self.device, remat=remat,
        )
        self.n_layers = n_layers
        make = optimizer or (lambda ps: torch.optim.Adam(ps, lr=learning_rate))
        self.optimizer = make(self.model.parameters())
        self.param_count = sum(p.numel() for p in self.model.parameters())
        self.step_num = 0

    # -- stepping ------------------------------------------------------------

    def _step(self, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor):
        """One step on device tensors; returns the (loss, contributors)
        device scalars (no host read)."""
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(x)  # (B, T, vocab) f32
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             y.reshape(-1).long(), reduction="none")
        denom = torch.clamp_min(v * float(x.numel()), 1.0)
        loss = ce.sum() * v / denom
        loss.backward()
        self.optimizer.step()
        return loss.detach(), v

    def _tokens(self, a, what: str) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        if t.ndim != 2 or t.shape[1] != self.seq_len or t.shape[0] % self.dp:
            raise ValueError(
                f"{what} must be (batch, {self.seq_len}) with batch divisible by "
                f"dp={self.dp}, got {tuple(t.shape)}")
        return t.to(self.device, torch.int64)

    def _valid(self, valid: Sequence[float] | None) -> torch.Tensor:
        arr = normalize_valid(valid, self.dp)
        return torch.from_numpy(arr).to(self.device)[0]

    def train_step(
        self,
        tokens,
        labels,
        valid: Sequence[float] | None = None,
    ) -> LongContextStepMetrics:
        """One step on a (batch, seq_len) token array (numpy or tensor).

        ``valid``: the per-replica-row contributor mask of shape (dp,);
        None = all rows contribute.
        """
        v = self._valid(valid)
        x, y = self._tokens(tokens, "tokens"), self._tokens(labels, "labels")
        loss, cnt = self._step(x, y, v)
        self.step_num += 1
        return LongContextStepMetrics(
            step=self.step_num, loss=float(loss), contributors=float(cnt))

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

        ``sampler`` is ``(generator, rows) -> (tokens, labels)``
        (``SyntheticCopyLM.device_sampler``). The generator lives on the
        trainer's device, seeded from ``seed`` and ``step_num``, so
        consecutive chains continue the data stream instead of replaying it.
        Losses and contributor counts stay on the device until the chain
        ends: one host read a chain.
        """
        if steps < 1:
            raise ValueError(f"need steps >= 1, got {steps}")
        v = self._valid(valid)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((seed * 2**32 + self.step_num) % 2**63)
        losses, counts = [], []
        for _ in range(steps):
            x, y = sampler(gen, rows_per_replica)
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
