"""The mixture-of-experts LM trainer, on one card.

Counterpart of ``akka_allreduce_tpu/train/moe.py`` (``MoEStepMetrics``,
``MoETrainer``) on a mesh of one rank: ``None`` or a one-rank ``(data,)``
mesh, which is how the JAX package trains its MoE LM on one
chip (``bench_mfu.py``'s ``run_moe``, ``train-moe``). Data, expert and
sequence parallelism (dp, ep or sp above 1), gradient ``compress`` and
``overlap`` need several ranks and raise ``NotImplementedError`` (ROADMAP
item 10).

A step is the JAX step with every collective of size one: with ``v`` the
replica row's contributor bit and ``n`` the batch's tokens,

- the loss is ``(sum(ce) + aux_coef · aux · n) · v / max(v · n, 1)``,
  ``backward()`` gives the gradient (K4's forward and backward on gated
  attention shapes), and the optimizer steps;
- the metrics are ``loss = sum(ce) · v / max(v · n, 1)``, ``aux_loss`` and
  ``dropped`` weighted the same way, ``contributors = v``.

The default optimizer is :class:`Adam`, ``optax.adam``'s arithmetic with
its ``mu_dtype``: the first moment is updated in f32 from the stored one,
used in f32, and only then stored in ``mu_dtype`` (bf16 halves its bytes,
the largest stream of the all-expert update). ``torch.optim.Adam`` keeps
its moments in the parameters' dtype and cannot do this.

``train_chain`` draws its batches on the card with a ``torch.Generator``
(``SyntheticCopyLM.device_sampler``) and reads the metrics back once a
chain. Checkpoints take the trainer-defined protocol in the pytree form
``{"params": {name}, "opt_state": {index: {"step", "exp_avg",
"exp_avg_sq"}}}`` (the form ``train.checkpoint`` captures from
``LongContextTrainer``), with a bf16 first moment widened to f32, which is
exact, so ``Snapshot`` and the elastic trainer work unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.binder.api import flat_tensor, load_flat_tensor
from akka_allreduce_tpu_torch.models.transformer import MoETransformerLM
from akka_allreduce_tpu_torch.parallel.mesh import RankMesh, line_mesh
from akka_allreduce_tpu_torch.train.checkpoint import ShapeDtype, host_tree
from akka_allreduce_tpu_torch.train.long_context import SEQ_IMPLS
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item 10)")


class MoETrainer:
    """The MoE LM trainer on one rank.

    Args:
      mesh: None or a one-rank ``(data,)`` ``RankMesh`` (None: one on
        ``device``). Any other mesh raises ``NotImplementedError``.
      seq_len: the sequence length every batch must have.
      optimizer: a factory ``parameters -> torch.optim.Optimizer``; default
        ``Adam(parameters, lr=learning_rate, mu_dtype=mu_dtype)``.
      mu_dtype: Adam's first-moment dtype (None: f32; ``torch.bfloat16``).
      compute_dtype: ``torch.float32`` or ``torch.bfloat16`` (parameters and
        the second moment stay f32).
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
        if compress is not None:
            raise _not_ported(f"compress={compress!r} (gradient wire compression)")
        if overlap:
            raise _not_ported("overlap (per-leaf gradient collectives)")
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(f"seq_impl must be one of {SEQ_IMPLS}, got {seq_impl!r}")
        if mesh is None:
            mesh = line_mesh(1, device=device, axis="data")
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        if len(mesh.axis_names) != 1 or mesh.sizes != (1,):
            raise _not_ported(
                f"a mesh with axes {mesh.axis_names} of sizes {mesh.sizes}: data, "
                "expert and sequence parallelism")
        self.mesh = mesh
        self.data_axis = mesh.axis_names[0]
        self.dp = self.ep = self.sp = 1  # the JAX trainer's mesh sizes
        self.n_devices = 1
        self.data_shards = 1  # train_chain streams: one per replica row
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
            dispatch_impl=dispatch_impl, seed=seed, device=self.device,
        )
        make = optimizer or (lambda ps: Adam(ps, lr=learning_rate, mu_dtype=mu_dtype))
        self.optimizer = make(self.model.parameters())
        self.param_count = sum(p.numel() for p in self.model.parameters())
        self.step_num = 0

    # -- stepping ------------------------------------------------------------

    def _step(self, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """One step on device tensors; returns the (loss, aux, dropped,
        contributors) device vector (no host read)."""
        self.optimizer.zero_grad(set_to_none=True)
        logits, aux, dropped = self.model(x)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long(),
                             reduction="sum")
        tokens_local = float(x.numel())
        denom = torch.clamp_min(v * tokens_local, 1.0)
        total = (ce + self.aux_coef * aux * tokens_local) * v / denom
        total.backward()
        self.optimizer.step()
        w = tokens_local * v / denom
        return torch.stack([ce.detach() * v / denom, aux.detach() * w,
                            dropped.detach() * w, v])

    def _tokens(self, a, what: str) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        if t.ndim != 2 or t.shape[1] != self.seq_len:
            raise ValueError(f"{what} must be (batch, {self.seq_len}), got {tuple(t.shape)}")
        return t.to(self.device, torch.int64)

    def _valid(self, valid: Sequence[float] | None) -> torch.Tensor:
        arr = normalize_valid(valid, self.dp)
        return torch.from_numpy(arr).to(self.device)[0]

    def _metrics(self, row: list[float]) -> MoEStepMetrics:
        self.step_num += 1
        loss, aux, dropped, cnt = row
        return MoEStepMetrics(step=self.step_num, loss=loss, aux_loss=aux, dropped=dropped,
                              contributors=cnt)

    def train_step(self, tokens, labels, valid: Sequence[float] | None = None
                   ) -> MoEStepMetrics:
        """One step on a (batch, seq_len) token array (numpy or tensor);
        ``valid``: the per-replica-row mask of shape (dp,), None = all."""
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
        ``(generator, rows) -> (tokens, labels)``; the generator is seeded
        from ``seed`` and ``step_num`` (consecutive chains continue the
        stream), and the metrics are read back once, at the end."""
        if steps < 1:
            raise ValueError(f"need steps >= 1, got {steps}")
        v = self._valid(valid)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((seed * 2**32 + self.step_num) % 2**63)
        rows = []
        for _ in range(steps):
            x, y = sampler(gen, rows_per_device)
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
