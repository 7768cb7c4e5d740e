"""Decoder-only Transformer LM, single device, with a KV-cache decode mode.

Counterpart of ``akka_allreduce_tpu/models/transformer.py`` (``rope``,
``Attention``, ``Block``, ``TransformerLM``). Parameters are f32 and keep
the flax shapes and names (``q_kernel`` (d, H, D), ``out_kernel``
(H, D, d), ...), so carried weights need no transpose
(:mod:`.convert`). Under a bf16 ``compute_dtype`` the numerics follow
flax's modules:

- ``Dense``/``DenseGeneral`` cast the input and the kernel (and bias) to
  the compute dtype, multiply, then add the bias;
- ``Embed`` casts the table to the compute dtype before the lookup;
- ``LayerNorm`` (eps 1e-6) takes its mean and variance in f32
  (``E[x^2] - E[x]^2``, clipped at 0) and casts the result;
- ``gelu`` is the tanh approximation;
- rope computes its angles and tables in f32, casts cos and sin to x's
  dtype and rotates by halves;
- the logits are cast to f32.

Attention goes through :func:`..ops.local_attention.local_attention`,
whose gated shapes run K4, the flash-attention kernel.

Decode mode: pass a :class:`KVCache` to :meth:`TransformerLM.forward`. Each
layer writes its chunk's K/V at the cache's host-int index and attends
over the live slots ``[0, index + t)`` only. An empty-cache prefill is then
exactly causal self-attention over the prompt (zero offsets, Tq == Tk), so
a gated prompt length launches K4. The JAX package attends over the whole
``max_len`` cache instead, with a traced index; the slots past the live
ones are causally masked there and add exactly 0 (``exp(-1e30 - m)`` is 0
in f32), so the values are the same function.

``remat=True`` wraps each :class:`Block` in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` when
gradients are recorded, as ``nn.remat(Block)`` does in the JAX package: the
backward re-runs each block's forward (K4's included, with its row
statistic) instead of keeping its activations. It changes memory, never the
parameters or their names.

Tensor and sequence parallelism, ``MoEBlock`` and the int8 cache wait for
later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.ops.local_attention import local_attention

LN_EPS = 1e-6


def rope(x: torch.Tensor, offset: int, *, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the last (even) dim; positions offset + arange(T).

    ``x``: (B, T, H, D). Angles and tables in f32; the rotation runs in x's
    dtype, by halves (not interleaved).
    """
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    pos = offset + torch.arange(x.shape[1], device=x.device)
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[:, None].to(torch.float32) * freqs[None, :]  # (T, D/2)
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1)


def _param(gen: torch.Generator | None, *shape: int, fan_in: int) -> nn.Parameter:
    """A normal(0, 1/fan_in) f32 parameter (flax's lecun-normal scale)."""
    w = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
    return nn.Parameter(w)


def _zeros(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense``: x (..., in) @ kernel (in, out) in ``dtype``, then the
    bias (cast to ``dtype``) added to the product."""
    y = x.to(dtype) @ kernel.to(dtype)
    return y if bias is None else y + bias.to(dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, eps 1e-6, result in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = _zeros(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        y = xf - mean
        mul = torch.rsqrt(var + LN_EPS) * self.scale
        y = y * mul + self.bias
        return y.to(self.dtype)


@dataclass
class KVCache:
    """Per-layer K/V caches, (B, max_len, H_kv, D) in the compute dtype, and
    the host-int index of the next free slot."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    index: int = 0

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]


class Attention(nn.Module):
    """Causal multi-head self-attention with RoPE and grouped-query K/V
    (``n_kv_heads`` < ``n_heads``; 1 = MQA). No bias on ``out``;
    ``out_bias`` is added after it."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int | None,
                 compute_dtype: torch.dtype, gen: torch.Generator | None) -> None:
        super().__init__()
        kv_heads = n_heads if n_kv_heads is None else n_kv_heads
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} not divisible by n_heads={n_heads}")
        if kv_heads < 1:
            raise ValueError(f"n_kv_heads must be >= 1, got {kv_heads}")
        if n_heads % kv_heads:
            raise ValueError(f"n_heads={n_heads} not divisible by n_kv_heads={kv_heads}")
        head = d_model // n_heads
        self.dtype = compute_dtype
        self.q_kernel = _param(gen, d_model, n_heads, head, fan_in=d_model)
        self.q_bias = _zeros(n_heads, head)
        self.k_kernel = _param(gen, d_model, kv_heads, head, fan_in=d_model)
        self.k_bias = _zeros(kv_heads, head)
        self.v_kernel = _param(gen, d_model, kv_heads, head, fan_in=d_model)
        self.v_bias = _zeros(kv_heads, head)
        self.out_kernel = _param(gen, n_heads, head, d_model, fan_in=n_heads * head)
        self.out_bias = _zeros(d_model)

    def _proj(self, x: torch.Tensor, kernel: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
        d, h, hd = kernel.shape
        y = _dense(x, kernel.reshape(d, h * hd), bias.reshape(h * hd), self.dtype)
        return y.reshape(*x.shape[:-1], h, hd)

    def forward(self, x: torch.Tensor, cache: KVCache | None = None,
                layer: int = 0) -> torch.Tensor:
        q = self._proj(x, self.q_kernel, self.q_bias)
        k = self._proj(x, self.k_kernel, self.k_bias)
        v = self._proj(x, self.v_kernel, self.v_bias)
        offset = 0 if cache is None else cache.index
        q, k = rope(q, offset), rope(k, offset)
        if cache is None:
            out = local_attention(q, k, v, causal=True)
        else:
            t = x.shape[1]
            ck, cv = cache.k[layer], cache.v[layer]
            ck[:, offset:offset + t] = k
            cv[:, offset:offset + t] = v
            # the live slots only: at an empty-cache prefill this is causal
            # self-attention over the chunk (K4 on gated lengths)
            out = local_attention(
                q, ck[:, :offset + t], cv[:, :offset + t], causal=True,
                q_offset=offset,
            )
        h, hd, d = self.out_kernel.shape
        y = _dense(out.reshape(*out.shape[:-2], h * hd),
                   self.out_kernel.reshape(h * hd, d), None, self.dtype)
        return y + self.out_bias.to(y.dtype)


class Block(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + mlp(LN(x)) + mlp_bias; no
    bias on ``mlp_down``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int | None,
                 mlp_ratio: int, compute_dtype: torch.dtype,
                 gen: torch.Generator | None) -> None:
        super().__init__()
        hidden = mlp_ratio * d_model
        self.dtype = compute_dtype
        self.ln1 = LayerNorm(d_model, compute_dtype)
        self.attn = Attention(d_model, n_heads, n_kv_heads, compute_dtype, gen)
        self.ln2 = LayerNorm(d_model, compute_dtype)
        self.mlp_up_kernel = _param(gen, d_model, hidden, fan_in=d_model)
        self.mlp_up_bias = _zeros(hidden)
        self.mlp_down_kernel = _param(gen, hidden, d_model, fan_in=hidden)
        self.mlp_bias = _zeros(d_model)

    def forward(self, x: torch.Tensor, cache: KVCache | None = None,
                layer: int = 0) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), cache, layer)
        h = _dense(self.ln2(x), self.mlp_up_kernel, self.mlp_up_bias, self.dtype)
        h = F.gelu(h, approximate="tanh")
        y = _dense(h, self.mlp_down_kernel, None, self.dtype)
        return x + y + self.mlp_bias.to(y.dtype)


class TransformerLM(nn.Module):
    """Tokens (B, T) -> logits (B, T, vocab) f32.

    Parameters are f32, drawn from ``seed`` with a ``torch.Generator`` on the
    CPU (flax's scales: normal 1/sqrt(fan_in) kernels, zero biases, unit
    norm scales), so the same seed gives the same weights on every device,
    then moved to ``device``: the CUDA card unless ``"cpu"`` is asked for
    (no CUDA and no ``"cpu"`` raises). ``compute_dtype`` is
    ``torch.float32`` or ``torch.bfloat16``. ``remat`` recomputes each
    block in the backward (see the module docstring).
    """

    def __init__(
        self,
        vocab: int = 256,
        d_model: int = 128,
        n_heads: int = 4,
        n_kv_heads: int | None = None,
        n_layers: int = 2,
        mlp_ratio: int = 4,
        compute_dtype: torch.dtype = torch.float32,
        *,
        seed: int = 0,
        device: torch.device | str | None = None,
        remat: bool = False,
    ) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_heads if n_kv_heads is None else n_kv_heads
        self.compute_dtype = compute_dtype
        self.remat = remat
        gen = torch.Generator().manual_seed(seed)
        self.embedding = _param(gen, vocab, d_model, fan_in=d_model)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, n_kv_heads, mlp_ratio, compute_dtype, gen)
            for _ in range(n_layers)
        )
        self.ln_f = LayerNorm(d_model, compute_dtype)
        self.head_kernel = _param(gen, d_model, vocab, fan_in=d_model)
        self.head_bias = _zeros(vocab)
        self.to(resolve_device(device))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def forward(self, tokens: torch.Tensor, cache: KVCache | None = None) -> torch.Tensor:
        if cache is not None and cache.index + tokens.shape[1] > cache.max_len:
            raise ValueError(
                f"cache index {cache.index} + {tokens.shape[1]} tokens exceeds "
                f"max_len {cache.max_len}"
            )
        x = self.embedding.to(self.compute_dtype)[tokens.long()]
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x, cache, i)
        x = self.ln_f(x)
        logits = _dense(x, self.head_kernel, self.head_bias, self.compute_dtype)
        if cache is not None:
            cache.index += tokens.shape[1]
        return logits.float()
