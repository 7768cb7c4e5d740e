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
    """The model's parameter names in the JAX package's flat-vector order."""
    return sorted((name for name, _ in model.named_parameters()), key=flax_path)


def flatten_params(
    model: nn.Module,
) -> tuple[np.ndarray, Callable[[np.ndarray], dict[str, torch.Tensor]]]:
    """The model's parameters as one host float32 vector, and an
    unflattener: ``unflatten(vec)`` returns ``{name: f32 CPU tensor}`` in
    the parameters' shapes, ready for ``load_state_dict`` or a copy into
    each parameter. A vector of the wrong length raises ``ValueError``."""
    params = dict(model.named_parameters())
    names = leaf_order(model)
    shapes = [tuple(params[n].shape) for n in names]
    sizes = [int(np.prod(s)) for s in shapes]
    with torch.no_grad():
        flat = torch.cat([params[n].detach().float().reshape(-1).cpu() for n in names])
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

    return flat.numpy(), unflatten
