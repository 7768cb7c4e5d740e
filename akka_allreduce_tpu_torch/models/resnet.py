"""ResNet-50 of the gradient-sync workload (BASELINE config 4: a 25M-parameter
gradient, the reference's chunked buffer).

Counterpart of ``akka_allreduce_tpu/models/resnet.py``: ``Bottleneck``,
``ResNet``, ``ResNet50`` and ``resnet_fwd_flops``, with the JAX model's
semantics:

- inputs are NHWC, as the datasets make them; inside, the activations are
  NCHW views of that layout, which is PyTorch's ``channels_last``;
- GroupNorm, not BatchNorm: ``num_groups = min(32, C)``, flax's epsilon
  1e-6 and fast variance, statistics in f32, and no state outside the
  parameters;
- flax's ``"SAME"`` padding, which splits an odd total with the extra row
  after (a stride-2 3x3 conv or max-pool on an even input pads 0 before and
  1 after), written out with ``F.pad`` (the max-pool's with -inf); the
  stem's 7x7 conv pads 3 on each side;
- the projection shortcut (1x1 conv + GroupNorm) on the first block of every
  stage, stage 0 included (64 -> 256 channels);
- with ``compute_dtype=torch.bfloat16`` each conv casts its input and kernel
  to bf16, GroupNorm's f32 parameters make its output f32, and the spatial
  mean and the final ``Dense`` are f32;
- f32 convs are f32 on the card: the forward runs under
  ``_device.ieee_f32`` (cuDNN would take TF32 under PyTorch's default), and
  so does each ``DPTrainer`` step, forward and backward. A backward that a
  caller runs outside those takes the caller's cuDNN setting.

Each conv kernel keeps flax's HWIO shape ``(kh, kw, in, out)``, so weights
carry over from a flax tree, and a flat parameter vector or gradient stack
lines up with the JAX package's, without a transpose; the forward hands
``conv2d`` its OIHW view. Parameters are f32, drawn from ``seed`` with a
``torch.Generator`` on the CPU (normal 1/sqrt(fan_in) kernels, GroupNorm
scale 1 and bias 0, a zero head bias), then moved to ``device``: the CUDA
card unless ``"cpu"`` is asked for.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from akka_allreduce_tpu_torch._device import ieee_f32, resolve_device
from akka_allreduce_tpu_torch.models.mlp import Dense
from akka_allreduce_tpu_torch.models.transformer import _param

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``(before, after)`` so
    that the output has ``ceil(size / stride)`` positions."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, window: int, stride: int, value: float = 0.0) -> torch.Tensor:
    (top, bottom), (left, right) = (same_pads(s, window, stride) for s in x.shape[2:])
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv`` without a bias: an HWIO ``kernel``, ``"SAME"``
    padding unless ``padding`` gives an explicit ``(lo, hi)`` per side."""

    def __init__(self, fan_in: int, features: int, window: int, gen: torch.Generator, *,
                 stride: int = 1, padding: tuple[int, int] | None = None) -> None:
        super().__init__()
        self.kernel = _param(gen, window, window, fan_in, features,
                             fan_in=window * window * fan_in)
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.padding is None:
            x = _pad_same(x, self.window, self.stride)
        else:
            lo, hi = self.padding
            x = F.pad(x, (lo, hi, lo, hi))
        w = self.kernel.permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(x.to(dtype), w.to(dtype), stride=self.stride)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``: f32 statistics and output, epsilon 1e-6, and
    flax's fast variance ``max(E[x^2] - E[x]^2, 0)``. ``F.group_norm``'s
    two-pass variance differs from it by percents where a group holds few
    values (4 at a 1x1 spatial size in a narrow model), so the statistics
    are written out."""

    def __init__(self, channels: int, groups: int = 32) -> None:
        super().__init__()
        self.groups = min(groups, channels)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.float().reshape(n, self.groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = torch.clamp_min((g * g).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + GN_EPS).expand(n, self.groups, c // self.groups).reshape(
            n, c) * self.scale
        y = (g - mean).reshape(x.shape) * mul.reshape(n, c, *[1] * (x.ndim - 2))
        return y + self.bias.reshape(c, *[1] * (x.ndim - 2))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 x4, each conv followed by GroupNorm, with
    a projection shortcut when the shape changes. ``conv[j]`` and
    ``norm[j]`` are flax's ``Conv_j`` and ``GroupNorm_j`` (j = 3: the
    projection)."""

    def __init__(self, fan_in: int, features: int, gen: torch.Generator, *,
                 strides: int = 1, groups: int = 32) -> None:
        super().__init__()
        out = 4 * features
        convs = [Conv(fan_in, features, 1, gen), Conv(features, features, 3, gen, stride=strides),
                 Conv(features, out, 1, gen)]
        norms = [GroupNorm(features, groups), GroupNorm(features, groups), GroupNorm(out, groups)]
        if fan_in != out or strides != 1:
            convs.append(Conv(fan_in, out, 1, gen, stride=strides))
            norms.append(GroupNorm(out, groups))
        self.conv = nn.ModuleList(convs)
        self.norm = nn.ModuleList(norms)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.relu(self.norm[0](self.conv[0](x, dtype)))
        y = F.relu(self.norm[1](self.conv[1](y, dtype)))
        y = self.norm[2](self.conv[2](y, dtype))
        residual = x if len(self.conv) == 3 else self.norm[3](self.conv[3](x, dtype))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Bottleneck ResNet on NHWC images; ``stage_sizes=(3, 4, 6, 3)`` is
    ResNet-50. Block ``i`` (counted over all stages) is ``blocks[i]``,
    flax's ``Bottleneck_i``; the stem is ``conv``/``norm`` (``Conv_0``,
    ``GroupNorm_0``) and the classifier ``head`` (``Dense_0``). Returns f32
    logits."""

    def __init__(
        self,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        classes: int = 1000,
        width: int = 64,
        compute_dtype: torch.dtype = torch.float32,
        *,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.stage_sizes = tuple(stage_sizes)
        self.classes = classes
        self.width = width
        self.compute_dtype = compute_dtype
        gen = torch.Generator().manual_seed(seed)
        self.conv = Conv(3, width, 7, gen, stride=2, padding=(3, 3))
        self.norm = GroupNorm(width)
        blocks, fan_in = [], width
        for stage, n_blocks in enumerate(self.stage_sizes):
            features = width * 2**stage
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(Bottleneck(fan_in, features, gen, strides=strides))
                fan_in = 4 * features
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(fan_in, classes, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        with ieee_f32():
            x = x.permute(0, 3, 1, 2).to(dtype)  # NHWC -> NCHW view (channels_last)
            x = F.relu(self.norm(self.conv(x, dtype)))
            x = F.max_pool2d(_pad_same(x, 3, 2, -math.inf), 3, 2)
            for block in self.blocks:
                x = block(x, dtype)
        x = x.float().mean(dim=(2, 3))
        return x @ self.head.kernel + self.head.bias


def ResNet50(classes: int = 1000, compute_dtype: torch.dtype = torch.float32, *,
             seed: int = 0, device: torch.device | str | None = None) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), classes=classes, compute_dtype=compute_dtype,
                  seed=seed, device=device)


def resnet_fwd_flops(model: ResNet, image_size: int, batch: int = 1) -> float:
    """Analytic forward conv and matmul FLOPs of one batch through ``model``
    at ``image_size`` x ``image_size`` inputs (2 FLOPs a multiply-add; norms
    and elementwise ops left out). Multiply by 3 for a training step. The
    JAX package's count, term for term."""
    total = 0.0

    def conv(cin, cout, k, h, w):
        nonlocal total
        total += 2.0 * k * k * cin * cout * h * w * batch

    h = -(-image_size // 2)  # stem 7x7 stride 2
    conv(3, model.width, 7, h, h)
    h = -(-h // 2)  # max-pool stride 2
    cin = model.width
    for stage, n_blocks in enumerate(model.stage_sizes):
        f = model.width * (2**stage)
        for block in range(n_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            h_out = -(-h // stride)
            conv(cin, f, 1, h, h)  # 1x1 reduce (input spatial)
            conv(f, f, 3, h_out, h_out)  # 3x3 (strided)
            conv(f, 4 * f, 1, h_out, h_out)  # 1x1 expand
            if cin != 4 * f or stride != 1:
                conv(cin, 4 * f, 1, h_out, h_out)  # projection shortcut
            cin = 4 * f
            h = h_out
    total += 2.0 * cin * model.classes * batch  # final Dense
    return total
