"""The mixture-of-experts LM trainer: DP (x EP) (x SP) over virtual ranks.

Counterpart of ``akka_allreduce_tpu/train/moe.py`` (``MoEStepMetrics``,
``MoETrainer``) on a ``(data,)``, ``(data, expert)`` or ``(data, seq,
expert)`` mesh of virtual ranks on one device (``parallel.mesh``). Every
rank computes on its own shard, the ranks folded into the batch of each
call (``MoETransformerLM``'s rank mode): the global batch's rows split over
data x expert jointly (data major), its columns over ``seq``, and each MoE
layer's all_to_all pair rides ``expert``, whose leaves each rank sees as
its ``n_experts / ep`` shard (``ep_param_specs``). Routing is per rank, so
the expert capacity counts a rank's own tokens; the aux statistics are
summed over ``seq``. With an ample capacity factor nothing drops and a step
is partition-independent (the JAX tests' oracle).

A step is the JAX step: with ``v`` a rank's replica-row contributor bit,
``n`` its tokens and ``denom = max(sum over ranks of v·n, 1)``,

- each rank's loss term is ``(sum(ce) + aux_coef · aux · n) · v / denom``;
  the gradient takes one of three paths: ``overlap`` syncs each leaf inside
  the backward (``comm.allreduce.overlap_value_and_grad``, the loss
  unmasked), ``compress`` "bf16" or "int8" one grouped collective a
  sharding class (``compressed_value_and_grad``), otherwise the same sum in
  f32, in which the replicated class (over every axis) is K1, once a step
  on the card; expert leaves reduce over data and seq only;
- the metrics are the sums over ranks of ``sum(ce) · v / denom``, ``aux ·
  n · v / denom`` and ``dropped · n · v / denom``, ``contributors`` the sum
  of ``valid`` over the replica rows; then the optimizer steps the
  full-shape parameters.

The default optimizer is :class:`Adam`, ``optax.adam``'s arithmetic with
its ``mu_dtype``: the first moment is updated in f32 from the stored one,
used in f32, and only then stored in ``mu_dtype`` (bf16 halves its bytes,
the largest stream of the all-expert update). ``torch.optim.Adam`` keeps
its moments in the parameters' dtype and cannot do this.

``train_chain`` draws its batches on the card, one ``torch.Generator``
stream a (data, expert) coordinate (``SyntheticCopyLM.device_sampler``),
each seq rank slicing its columns of the coordinate's rows, and reads the
metrics back once a chain. Checkpoints take the trainer-defined protocol in
the pytree form ``{"params": {name}, "opt_state": {index: {"step",
"exp_avg", "exp_avg_sq"}}}`` (the form ``train.checkpoint`` captures from
``LongContextTrainer``) of the full-shape state, with a bf16 first moment
widened to f32, which is exact, so ``Snapshot`` and the elastic trainer
work unchanged at any mesh.
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
from akka_allreduce_tpu_torch.models.transformer import SEQ_IMPLS, MoETransformerLM
from akka_allreduce_tpu_torch.parallel.mesh import RankMesh, line_mesh
from akka_allreduce_tpu_torch.train.checkpoint import ShapeDtype, host_tree
from akka_allreduce_tpu_torch.train.long_context import _ROW_SEED_STRIDE
from akka_allreduce_tpu_torch.train.trainer import normalize_valid

# parameters an Adam step updates with one set of foreach calls (bounds the
# f32 temporaries of a step to this many elements a set)
_ADAM_CHUNK = 1 << 28


class Adam(torch.optim.Optimizer):
    """``optax.adam(lr, b1, b2, eps, mu_dtype=mu_dtype)``.

    Per parameter: ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g² + b2 v``
    (both in f32), ``p += -lr · (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) +
    eps)``, then ``m`` is stored in ``mu_dtype`` (None: the parameter's
    dtype). The state (``step``, ``exp_avg``, ``exp_avg_sq``, the names
    ``torch.optim.Adam`` uses) is made at construction, zeros as optax's
    ``init``, so its structure never depends on whether a step was taken.
    """

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: torch.dtype | None = None) -> None:
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.mu_dtype = mu_dtype
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32),
                    "exp_avg": torch.zeros_like(p, dtype=mu_dtype or p.dtype),
                    "exp_avg_sq": torch.zeros_like(p),
                }

    @torch.no_grad()
    def step(self, closure: Callable | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            live = [p for p in group["params"] if p.grad is not None]
            chunks, chunk, size = [], [], 0
            for p in live:
                if chunk and size + p.numel() > _ADAM_CHUNK:
                    chunks.append(chunk)
                    chunk, size = [], 0
                chunk.append(p)
                size += p.numel()
            if chunk:
                chunks.append(chunk)
            for ps in chunks:
                self._update(group, ps)
        return loss

    def _update(self, group: dict, ps: list[torch.Tensor]) -> None:
        lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
        states = [self.state[p] for p in ps]
        grads = [p.grad for p in ps]
        for st in states:
            st["step"] += 1.0
        t = float(states[0]["step"])
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        stored = [st["exp_avg"] for st in states]
        widen = stored[0].dtype != ps[0].dtype
        mu = [m.float() for m in stored] if widen else stored
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        nu = [st["exp_avg_sq"] for st in states]
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_addcdiv_(ps, mu, denom, value=-lr / bc1)
        if widen:
            torch._foreach_copy_(stored, mu)


@dataclasses.dataclass
class MoEStepMetrics:
    step: int
    loss: float  # masked per-token cross-entropy (aux not included)
    aux_loss: float  # Switch load-balancing loss (masked token-weighted mean)
    dropped: float  # fraction of routing assignments past expert capacity
    contributors: float  # contributing DP replica rows


class MoETrainer:
    """DP (x EP) (x SP) trainer of a :class:`~..models.MoETransformerLM`
    over a mesh of virtual ranks.

    Args:
      mesh: a ``(data,)`` ``RankMesh`` (the dense MoE), ``(data, expert)``
        (expert parallelism) or ``(data, seq, expert)`` (sequence
        parallelism composed with it: ring or Ulysses attention over
        ``seq``); the axes are taken by position, as the JAX trainer takes
        them. None: a one-rank ``(data,)`` mesh on ``device``.
      seq_len: the GLOBAL sequence length (divisible by the seq axis size).
      optimizer: a factory ``parameters -> torch.optim.Optimizer``; default
        ``Adam(parameters, lr=learning_rate, mu_dtype=mu_dtype)``.
      mu_dtype: Adam's first-moment dtype (None: f32; ``torch.bfloat16``).
      compute_dtype: ``torch.float32`` or ``torch.bfloat16`` (parameters and
        the second moment stay f32).
      compress: None, "bf16" or "int8": the gradient sums' wire.
      overlap: one sync a leaf inside the backward (not with "int8").
      dispatch_impl: "auto", "einsum" or "scatter" (``ops.moe``).
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
        n_experts: int = 4,
        seq_len: int = 64,
        capacity_factor: float = 1.25,
        router_topk: int = 1,
        seq_impl: str = "ring",
        aux_coef: float = 0.01,
        optimizer: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]
        | None = None,
        learning_rate: float = 1e-2,
        mu_dtype: torch.dtype | None = None,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        compress: str | None = None,
        overlap: bool = False,
        dispatch_impl: str = "auto",
        device: str | torch.device | None = None,
    ) -> None:
        self.compress = validate_trainer_compress(compress, overlap=overlap)
        self.overlap = overlap
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(f"seq_impl must be one of {SEQ_IMPLS}, got {seq_impl!r}")
        if mesh is None:
            mesh = line_mesh(1, device=device, axis="data")
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        names = mesh.axis_names
        if len(names) not in (1, 2, 3):
            raise ValueError(
                f"need a (data[, expert] | data, seq, expert) mesh, got axes {names}")
        self.mesh = mesh
        self.data_axis = names[0]
        self.seq_axis = names[1] if len(names) == 3 else None
        self.expert_axis = names[-1] if len(names) > 1 else None
        self.dp = mesh.shape[self.data_axis]
        self.sp = mesh.shape[self.seq_axis] if self.seq_axis else 1
        self.ep = mesh.shape[self.expert_axis] if self.expert_axis else 1
        if n_experts % self.ep:
            raise ValueError(f"n_experts={n_experts} not divisible by ep={self.ep}")
        if seq_len % self.sp:
            raise ValueError(f"seq_len={seq_len} not divisible by seq shards {self.sp}")
        self.n_devices = self.dp * self.sp * self.ep
        self.data_shards = self.dp  # replica rows, as the JAX trainer counts them
        self.seq_len = seq_len
        self.seq_impl = seq_impl
        self.vocab = vocab
        self.aux_coef = aux_coef
        self.n_experts, self.router_topk = n_experts, router_topk
        self.device = mesh.device
        self.model = MoETransformerLM(
            vocab=vocab, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            n_layers=n_layers, n_experts=n_experts, capacity_factor=capacity_factor,
            compute_dtype=compute_dtype, router_topk=router_topk,
            dispatch_impl=dispatch_impl,
            expert_axis=self.expert_axis if self.ep > 1 else None, ep_size=self.ep,
            seq_axis=self.seq_axis if self.sp > 1 else None, seq_impl=seq_impl,
            seed=seed, device=self.device,
        )
        named = dict(self.model.named_parameters())
        self._params = {name: named[name] for name in leaf_order(self.model)}
        self._specs = self.model.param_specs()
        make = optimizer or (lambda ps: Adam(ps, lr=learning_rate, mu_dtype=mu_dtype))
        self.optimizer = make(self.model.parameters())
        self.param_count = sum(p.numel() for p in self.model.parameters())
        self.step_num = 0

    # -- stepping ------------------------------------------------------------

    def rank_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The global (batch, seq_len) tokens as the rank stack (n_devices,
        B_l, T_l): rank (d, s, e) holds rows ``[(d·ep + e)·B_l, ...)`` (data x
        expert, data major) and columns ``[s·T_l, (s+1)·T_l)``."""
        dp, sp, ep = self.dp, self.sp, self.ep
        bl, tl = x.shape[0] // (dp * ep), self.seq_len // sp
        g = x.reshape(dp, ep, bl, sp, tl).permute(0, 3, 1, 2, 4)
        return g.reshape(self.n_devices, bl, tl)

    def _step(self, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """One step on the global device tensors ``x``/``y`` under the (dp,)
        mask ``v``; returns the (loss, aux, dropped, contributors) device
        vector (no host read)."""
        self.optimizer.zero_grad(set_to_none=True)
        xs, ys = self.rank_tokens(x), self.rank_tokens(y)
        v_rank = v[self.mesh.index(self.data_axis)]  # (n_devices,)
        tokens_local = float(xs[0].numel())
        denom = torch.clamp_min((v_rank * tokens_local).sum(), 1.0)
        mesh, model, stats = self.mesh, self.model, {}

        def loss_terms(views, masked: bool):
            logits, aux, dropped = model(xs, mesh=mesh, params=views)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 ys.reshape(-1).long(), reduction="none")
            ce = ce.reshape(self.n_devices, -1).sum(1)
            stats.update(ce=ce.detach(), aux=aux.detach(), dropped=dropped.detach())
            total = ce + self.aux_coef * aux * tokens_local
            return (total * v_rank if masked else total) / denom

        if self.overlap:
            _, grads = overlap_value_and_grad(
                lambda views: loss_terms(views, False), self._params, self._specs, mesh,
                v_rank, wire_dtype=self.compress)
        else:
            _, grads = compressed_value_and_grad(
                lambda views: loss_terms(views, True), self._params, self._specs, mesh,
                wire_dtype=self.compress)
        for name, p in self._params.items():
            p.grad = grads[name]
        del grads
        self.optimizer.step()
        w = v_rank / denom
        return torch.stack([(stats["ce"] * w).sum(), (stats["aux"] * tokens_local * w).sum(),
                            (stats["dropped"] * tokens_local * w).sum(), v.sum()])

    def _tokens(self, a, what: str) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        rows = self.dp * self.ep
        if t.ndim != 2 or t.shape[1] != self.seq_len or t.shape[0] % rows:
            raise ValueError(
                f"{what} must be (batch, {self.seq_len}) with the global batch divisible by "
                f"{rows} row shards (data x expert), got {tuple(t.shape)}")
        return t.to(self.device, torch.int64)

    def _valid(self, valid: Sequence[float] | None) -> torch.Tensor:
        return torch.from_numpy(normalize_valid(valid, self.dp)).to(self.device)

    def _metrics(self, row: list[float]) -> MoEStepMetrics:
        self.step_num += 1
        loss, aux, dropped, cnt = row
        return MoEStepMetrics(step=self.step_num, loss=loss, aux_loss=aux, dropped=dropped,
                              contributors=cnt)

    def train_step(self, tokens, labels, valid: Sequence[float] | None = None
                   ) -> MoEStepMetrics:
        """One step on a GLOBAL (batch, seq_len) token array (numpy or
        tensor), batch divisible by dp x ep; ``valid``: the per-replica-row
        mask of shape (dp,), None = all."""
        v = self._valid(valid)
        x, y = self._tokens(tokens, "tokens"), self._tokens(labels, "labels")
        return self._metrics(self._step(x, y, v).tolist())

    def train(self, batches: Iterable) -> list[MoEStepMetrics]:
        return [self.train_step(x, y) for x, y in batches]

    def train_chain(
        self,
        sampler,
        steps: int,
        rows_per_device: int,
        *,
        valid: Sequence[float] | None = None,
        seed: int = 0,
    ) -> list[MoEStepMetrics]:
        """Run ``steps`` steps with batches drawn on the device by ``sampler``
        ``(generator, rows) -> (tokens, labels)`` of GLOBAL (rows, seq_len)
        sequences: one stream a (data, expert) coordinate, its generator
        seeded from ``seed``, ``step_num`` and the coordinate (consecutive
        chains continue the streams), the coordinate's seq ranks slicing
        their columns from it; the metrics are read back once, at the
        end."""
        if steps < 1:
            raise ValueError(f"need steps >= 1, got {steps}")
        v = self._valid(valid)
        base = seed * 2**32 + self.step_num
        gens = [torch.Generator(device=self.device).manual_seed(
            (base + c * _ROW_SEED_STRIDE) % 2**63) for c in range(self.dp * self.ep)]
        rows = []
        for _ in range(steps):
            drawn = [sampler(gen, rows_per_device) for gen in gens]
            x = torch.cat([d[0] for d in drawn])
            y = torch.cat([d[1] for d in drawn])
            rows.append(self._step(x, y, v))
        return [self._metrics(row) for row in torch.stack(rows).cpu().tolist()]

    # -- the binder seam -----------------------------------------------------

    def get_flat_params(self) -> np.ndarray:
        """The parameters as one host f32 vector in the JAX trainer's leaf
        order (``binder.leaf_order``)."""
        return self.flat_params_tensor().cpu().numpy()

    def flat_params_tensor(self) -> torch.Tensor:
        return flat_tensor(self.model)

    def set_flat_params(self, vec: np.ndarray | torch.Tensor) -> None:
        """Replace the parameters from a flat f32 vector in that order (a
        JAX trainer's ``get_flat_params`` loads here unchanged)."""
        load_flat_tensor(self.model, vec)

    # -- checkpoints ---------------------------------------------------------

    def _opt_entries(self):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        return [(i, self.optimizer.state[p]) for i, p in enumerate(params)]

    def checkpoint_capture(self) -> dict:
        """The state's live tensors (a bf16 first moment widened to f32, a
        new tensor), for the saves that copy it off the card later."""
        opt = {}
        for i, st in self._opt_entries():
            if set(st) != {"step", "exp_avg", "exp_avg_sq"}:
                raise NotImplementedError(
                    f"{type(self.optimizer).__name__}'s state {sorted(st)} has no "
                    "checkpoint form here (Adam's has)")
            opt[i] = {"step": st["step"], "exp_avg": st["exp_avg"].float(),
                      "exp_avg_sq": st["exp_avg_sq"]}
        return {"params": {n: p.detach() for n, p in self.model.named_parameters()},
                "opt_state": opt}

    def checkpoint_assemble(self, host: dict) -> dict:
        """The captured form is already the serialized one."""
        return host

    def checkpoint_state(self) -> dict:
        """The state as host numpy arrays (a synchronous copy)."""
        return host_tree(self.checkpoint_capture())

    def checkpoint_template(self) -> dict:
        """Shapes and dtypes of :meth:`checkpoint_state`, the restore target."""
        def spec(t: torch.Tensor) -> ShapeDtype:
            return ShapeDtype(tuple(t.shape), np.float32)

        return {
            "params": {n: spec(p) for n, p in self.model.named_parameters()},
            "opt_state": {i: {k: spec(st[k]) for k in ("step", "exp_avg", "exp_avg_sq")}
                          for i, st in self._opt_entries()},
        }

    def restore_checkpoint_state(self, state: dict) -> None:
        """Place a state of :meth:`checkpoint_state`'s form: each tensor
        copied in place, in its own dtype (the first moment narrowed back to
        ``mu_dtype``, exactly)."""
        named = dict(self.model.named_parameters())
        params, opt = state["params"], state["opt_state"]
        entries = self._opt_entries()
        if set(params) != set(named) or set(opt) != {i for i, _ in entries}:
            raise KeyError("checkpoint structure does not match the trainer's")

        def put(dst: torch.Tensor, arr, what: str) -> None:
            arr = np.asarray(arr)
            if arr.shape != tuple(dst.shape):
                raise ValueError(f"{what}: checkpoint shape {arr.shape} != {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(arr)))  # 0-d stays 0-d

        with torch.no_grad():
            for name, p in named.items():
                put(p, params[name], f"parameter {name!r}")
            for i, st in entries:
                for key in ("step", "exp_avg", "exp_avg_sq"):
                    put(st[key], opt[i][key], f"optimizer state {i}.{key}")
