"""Helpers shared by the port's trainers.

Counterpart of the trainer-independent parts of
``akka_allreduce_tpu/train/trainer.py``: :func:`normalize_valid`, the
contributor mask's validation. ``DPTrainer`` waits for the MLP and the
data-parallel gradient sync.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def normalize_valid(valid: Sequence[float] | None, n: int) -> np.ndarray:
    """Contributor mask -> validated (n,) float32 array (shared by trainers)."""
    if valid is None:
        return np.ones((n,), np.float32)
    arr = np.asarray(valid, np.float32)
    if arr.shape != (n,):
        raise ValueError(f"valid must have shape ({n},), got {arr.shape}")
    return arr
