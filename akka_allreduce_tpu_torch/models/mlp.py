"""The MLP of the MNIST data-parallel SGD workload (BASELINE config 3).

Counterpart of ``akka_allreduce_tpu/models/mlp.py``: flatten, one ``Dense``
+ ReLU per hidden width, a ``Dense`` head, the products in
``compute_dtype`` (f32, or bf16 with f32 parameters) and the logits
returned in f32. Each layer keeps flax's shapes, a kernel ``(in, out)`` and
a bias ``(out,)``, and computes ``x @ kernel + bias``, so weights carried
across from a flax tree need no transpose (``models.convert``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.models.transformer import _dense, _param, _zeros

MNIST_FEATURES = 28 * 28 * 1


class Dense(nn.Module):
    """flax ``nn.Dense``: a ``(in, out)`` kernel and an ``(out,)`` bias."""

    def __init__(self, fan_in: int, width: int, gen: torch.Generator) -> None:
        super().__init__()
        self.kernel = _param(gen, fan_in, width, fan_in=fan_in)
        self.bias = _zeros(width)


class MLP(nn.Module):
    """``in_features`` -> hidden... -> classes, ReLU, optional bf16 compute.

    Parameters are f32, drawn from ``seed`` with a ``torch.Generator`` on the
    CPU (normal 1/sqrt(fan_in) kernels, zero biases), so the same seed gives
    the same weights on every device, then moved to ``device``: the CUDA
    card unless ``"cpu"`` is asked for (no CUDA and no ``"cpu"`` raises).
    Layer ``i`` is ``dense[i]``, flax's ``Dense_i``.
    """

    def __init__(
        self,
        hidden: Sequence[int] = (512, 512),
        classes: int = 10,
        compute_dtype: torch.dtype = torch.float32,
        *,
        in_features: int = MNIST_FEATURES,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.hidden = tuple(hidden)
        self.classes = classes
        self.compute_dtype = compute_dtype
        gen = torch.Generator().manual_seed(seed)
        widths = (in_features, *self.hidden, classes)
        self.dense = nn.ModuleList(
            Dense(fan_in, width, gen) for fan_in, width in zip(widths, widths[1:]))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        *layers, head = self.dense
        for layer in layers:
            x = F.relu(_dense(x, layer.kernel, layer.bias, self.compute_dtype))
        return _dense(x, head.kernel, head.bias, self.compute_dtype).float()
