"""The binder protocol, and module parameters <-> one flat host f32 vector.

``AllreduceBinder`` is the port's copy of the JAX package's protocol of the
same name (``akka_allreduce_tpu/binder/api.py``). ``flatten_params`` is the
counterpart of ``akka_allreduce_tpu/binder/api.py::flatten_pytree``, the
seam through which the host engine, elastic mode and checkpoints see a
model as one buffer. The JAX trainers ravel their flax parameter tree
(``jax.flatten_util.ravel_pytree``), whose leaves come in the order of their
sorted paths. :func:`flatten_params` lays the port's parameters out in that
same order (each leaf's path from ``models.convert.flax_path``, compared
component by component as strings, so ``Block_10`` sorts before
``Block_2`` as it does there), each leaf raveled row-major. A vector from
one package therefore loads into the other.
"""

from __future__ import annotations

from typing import Callable, Protocol

import numpy as np
import torch
from torch import nn

from akka_allreduce_tpu_torch.models.convert import flax_path
from akka_allreduce_tpu_torch.protocol import (
    AllReduceInput,
    AllReduceInputRequest,
    AllReduceOutput,
)


class AllreduceBinder(Protocol):
    """What a worker needs from the ML side (reference ``AllreduceBinder``).

    By default the engine clones each chunk of the source's tensor before
    any delivery, so ``data_source`` may reuse one buffer. With
    ``WorkerConfig(zero_copy_scatter=True)`` the engine scatters views
    instead — then the returned tensor must stay unmutated until the round
    completes (publish new values by replacing the tensor, not by writing
    into it).
    """

    def data_source(self, req: AllReduceInputRequest) -> AllReduceInput: ...

    def data_sink(self, out: AllReduceOutput) -> None: ...

    @property
    def data_size(self) -> int: ...


def leaf_order(model: nn.Module) -> list[str]:
    """The model's parameter names in the JAX package's flat-vector order
    (by the model's own ``flax_path`` where it has one, as the MoE LM)."""
    key = getattr(model, "flax_path", flax_path)
    return sorted((name for name, _ in model.named_parameters()), key=key)


def flatten_params(
    model: nn.Module,
) -> tuple[np.ndarray, Callable[[np.ndarray], dict[str, torch.Tensor]]]:
    """The model's parameters as one host float32 vector (:func:`flat_tensor`
    copied to the host), and an unflattener: ``unflatten(vec)`` returns
    ``{name: f32 CPU tensor}`` in the parameters' shapes, ready for
    ``load_state_dict``. A vector of the wrong length raises ``ValueError``."""
    params = dict(model.named_parameters())
    names = leaf_order(model)
    shapes = [tuple(params[n].shape) for n in names]
    sizes = [int(np.prod(s)) for s in shapes]
    total = sum(sizes)

    def unflatten(vec: np.ndarray) -> dict[str, torch.Tensor]:
        arr = np.asarray(vec, np.float32)
        if arr.shape != (total,):
            raise ValueError(f"need a ({total},) vector, got {arr.shape}")
        out, start = {}, 0
        for name, shape, size in zip(names, shapes, sizes):
            out[name] = torch.from_numpy(arr[start:start + size].reshape(shape).copy())
            start += size
        return out

    return flat_tensor(model).cpu().numpy(), unflatten


def flat_tensor(model: nn.Module) -> torch.Tensor:
    """The model's parameters as one new f32 tensor on their device, in the
    JAX flat-vector order (:func:`leaf_order`), written on the current
    stream."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        return torch.cat([params[n].detach().float().reshape(-1) for n in leaf_order(model)])


def load_flat_tensor(model: nn.Module, vec: np.ndarray | torch.Tensor) -> None:
    """Copy a flat vector in :func:`leaf_order` into the model's parameters.
    A tensor is copied on its device, with no trip through the host; a
    numpy vector (a JAX trainer's ``get_flat_params``) is cast to f32 first.
    A vector of the wrong length raises ``ValueError``."""
    if not isinstance(vec, torch.Tensor):
        vec = torch.from_numpy(np.array(vec, np.float32))
    params = dict(model.named_parameters())
    names = leaf_order(model)
    sizes = [params[n].numel() for n in names]
    if tuple(vec.shape) != (sum(sizes),):
        raise ValueError(f"need a ({sum(sizes)},) vector, got {tuple(vec.shape)}")
    with torch.no_grad():
        for name, piece in zip(names, torch.split(vec.detach(), sizes)):
            p = params[name]
            p.copy_(piece.view(p.shape))
