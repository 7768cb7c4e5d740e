"""Which device an entry point runs on, and which path an op takes.

Counterpart of ``akka_allreduce_tpu/ops/_platform.py``. The TPU package had
to pick between a compiled Pallas kernel and the Pallas interpreter; here the
choice follows the tensor alone:

- a CUDA tensor takes the hand-written kernel, or the op raises;
- a CPU tensor takes the op's plain PyTorch version.

There is no interpret mode and no silent fallback. Entry points that create
tensors resolve their device with :func:`resolve_device`: the card unless the
caller asks for ``"cpu"``, and an error when CUDA is missing. The port's f32
is IEEE f32 on the card too: :func:`ieee_f32` holds cuDNN's convolutions to
it wherever the port runs one.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda:0`` (or the named CUDA device) unless ``"cpu"`` is asked for.

    Raises ``RuntimeError`` when a CUDA device is wanted and CUDA is absent:
    a caller who did not ask for the CPU never ends up there.
    """
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda", 0 if dev.index is None else dev.index)


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """f32 convolutions in f32 inside the block, and the caller's setting
    back after it.

    cuDNN runs f32 convolutions in TF32 (a 10-bit mantissa) while
    ``torch.backends.cudnn.allow_tf32`` holds, which is PyTorch's default.
    The switch is process-wide and read at each launch, so a block that
    holds a forward and its backward (a training step) covers both; a
    backward run after the block has closed takes the caller's setting.
    """
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` must go through the CUDA kernel (it lies on the card)."""
    return t.is_cuda
