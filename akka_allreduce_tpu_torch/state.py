"""Hand-over of the round's state between numpy and the port.

The single-card round has no weights: its state is the ``(K, data)`` stack of
replicas and payloads. The JAX package holds it flat, ``(K, data)``, or
packed, ``(K, T, 128)`` (``pack_tiles``). :func:`state_from_numpy` takes
either layout as a numpy array (``np.asarray(jax_array)``) and returns the
port's tensor in the same layout; :func:`state_to_numpy` is its inverse.
Both copy, so the port's in-place updates never write into the caller's
array.
"""

from __future__ import annotations

import numpy as np
import torch

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.ops.local_reduce import LANE


def _check_layout(shape: tuple[int, ...]) -> None:
    if len(shape) == 2 or (len(shape) == 3 and shape[2] == LANE):
        return
    raise ValueError(
        f"state must be flat (K, data) or packed (K, T, {LANE}), got {shape}"
    )


def state_from_numpy(
    arr: np.ndarray, device: str | torch.device | None = None
) -> torch.Tensor:
    """A copy of ``arr`` as a tensor on ``device`` (the card by default)."""
    arr = np.asarray(arr)
    _check_layout(arr.shape)
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def state_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of the port's state tensor, in the same layout."""
    _check_layout(tuple(t.shape))
    return t.detach().to("cpu", copy=True).numpy()
