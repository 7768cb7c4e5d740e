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

``cache_quant="int8"`` (:class:`KVCache` with scales) stores the cache
quantized per (token, head) row: an int8 payload and one f32 scale a row,
as the JAX ``Attention`` stores it (:func:`quantize`). A chunk attends over
the live int8 slots with the scales folded in
(``quantized_cache_attention``) when ``t == 1``, when its f32 scores cost no
more bytes a key than a dequantized copy (``4·H·t <= 2·H_kv·D·itemsize``),
or when ``t * max_len <= 512²``; otherwise the live slots are dequantized
once and go through ``local_attention``, so an empty-cache prefill at a
gated length runs K4. The gate takes the cache's full length, as the JAX
gate does.

:class:`MoEBlock` and :class:`MoETransformerLM` are the Switch/GShard
mixture-of-experts LM (``ops.moe``): each returns its output with the
load-balancing loss and the dropped fraction, the LM both averaged over its
layers.

Sequence and tensor parallelism over virtual ranks (``seq_axis``,
``seq_impl``, ``model_axis``, ``tp_size``, as the JAX modules take them):
:meth:`TransformerLM.forward` with ``mesh`` runs every rank of a
``parallel.mesh.RankMesh`` on its own shard, the ranks folded into the
batch of each call. The tokens are a rank stack ``(mesh.size, B_local,
T_local)`` (the ``data`` axis splits the rows, ``seq_axis`` the columns,
every rank of a ``model`` group holds the same); every parameter reaches a
rank as its grid-form view (``parallel.mesh.rank_view`` under
:func:`tp_param_specs`): the whole leaf if it is replicated, its shard of
heads or hidden units under TP. Per rank, as the JAX code does it: rope's
positions start at ``seq_rank * T_local``; q/k/v project ``H/tp`` and
``H_kv/tp`` heads; attention is ``ring_attention`` or
``ulysses_attention`` over ``seq_axis`` (``local_attention`` at one seq
shard); the out-projection and ``mlp_down`` give partial sums that one psum
over ``model_axis`` completes (``RankMesh.psum``: its backward broadcasts
the cotangent summed over the group, the transpose of the sum), and
``out_bias``/``mlp_bias`` are added after it. Decode over a mesh
(:meth:`TransformerLM.decode_ranks`, ``models.generate.LMGenerator`` with
a mesh) takes each rank's cache of a :class:`RankKVCache`: its ``H_kv/tp``
heads and, over ``seq``, its ``max_len/sp`` slots. The MoE LM's rank mode
adds ``expert_axis`` (:func:`ep_param_specs`, the ``all_to_all`` pair of
``ops.moe``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.models.convert import flax_path, moe_flax_path
from akka_allreduce_tpu_torch.ops import local_attention as attention_ops
from akka_allreduce_tpu_torch.ops.moe import moe_dispatch_compute
from akka_allreduce_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention
from akka_allreduce_tpu_torch.parallel.mesh import PartitionSpec, RankMesh, rank_view

SEQ_IMPLS = ("ring", "ulysses")

LN_EPS = 1e-6


def rope(x: torch.Tensor, offset: int | torch.Tensor, *,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the last (even) dim; positions offset + arange(T).

    ``x``: (B, T, H, D); ``offset`` an int, or a (B,) tensor of one offset a
    row (a sequence shard's global start). Angles and tables in f32; the
    rotation runs in x's dtype, by halves (not interleaved).
    """
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    ar = torch.arange(x.shape[1], device=x.device)
    pos = offset[:, None] + ar if isinstance(offset, torch.Tensor) else (offset + ar)[None]
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[..., None].to(torch.float32) * freqs  # (1 or B, T, D/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1)


def _param(gen: torch.Generator | None, *shape: int, fan_in: int) -> nn.Parameter:
    """A normal(0, 1/fan_in) f32 parameter (flax's lecun-normal scale), drawn
    where ``gen`` lives."""
    device = None if gen is None else gen.device
    w = torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)
    return nn.Parameter(w)


def _zeros(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense``: x (..., in) @ kernel (in, out) in ``dtype``, then the
    bias (cast to ``dtype``) added to the product."""
    y = x.to(dtype) @ kernel.to(dtype)
    return y if bias is None else y + bias.to(dtype)


def _rank_dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
                dtype: torch.dtype) -> torch.Tensor:
    """:func:`_dense` of every rank at once: x (R, ..., in) @ its rank's
    kernel (R, in, out) in one batched product, plus its rank's bias (R,
    out). A replicated kernel is a stride-0 view; autograd gives each rank
    its own kernel gradient."""
    r, n_in = x.shape[0], x.shape[-1]
    y = torch.bmm(x.reshape(r, -1, n_in).to(dtype), kernel.to(dtype))
    if bias is not None:
        y = y + bias.to(dtype)[:, None, :]
    return y.reshape(*x.shape[:-1], kernel.shape[-1])


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
    y = xf - mean
    mul = torch.rsqrt(var + LN_EPS) * scale
    y = y * mul + bias
    return y.to(dtype)


def _rank_vector(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A rank's (R, n) vector shaped to broadcast over the rank stack ``x``
    (R, ..., n)."""
    return t.reshape(t.shape[0], *([1] * (x.ndim - 2)), t.shape[-1])


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, eps 1e-6, result in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = _zeros(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self.scale, self.bias, self.dtype)

    def forward_ranks(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        """Every rank's norm of its rows ``x`` (R, ..., d) with its own
        ``scale``/``bias`` (R, d)."""
        return _layer_norm(x, _rank_vector(p["scale"], x), _rank_vector(p["bias"], x), self.dtype)


CACHE_QUANTS = (None, "int8")
_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))  # f32(1/127)


@dataclass
class KVCache:
    """Per-layer K/V caches, (B, max_len, H_kv, D), and the host-int index of
    the next free slot. In the compute dtype, or (``k_scale``/``v_scale``
    given) int8 payloads with one f32 scale a (token, head) row, (B,
    max_len, H_kv)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    index: int = 0
    k_scale: list[torch.Tensor] | None = None
    v_scale: list[torch.Tensor] | None = None

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


@dataclass
class RankKVCache(KVCache):
    """The caches of every virtual rank of a decode mesh: per layer, rank
    stacks (R, B, max_len / sp, H_kv / tp, D) (the scales (R, B, max_len /
    sp, H_kv / tp)), rank r holding the slots of its ``seq`` shard and the
    K/V heads of its ``model`` shard; ``seq_shards`` is sp, so ``max_len``
    is the global slot count."""

    seq_shards: int = 1

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2] * self.seq_shards


def _write_slots(cache: torch.Tensor, chunk: torch.Tensor, mesh: RankMesh,
                 seq_axis: str | None, offset: int) -> None:
    """Write a rank stack ``chunk`` (R, B, t, ...) at global slots
    ``[offset, offset + t)`` of a rank cache (R, B, L_local, ...). With
    ``seq_axis`` each token lands only in the rank whose slots hold its
    position, taken from that rank's own row (the JAX scatter drops the
    others), also where the chunk spans ranks."""
    t = chunk.shape[2]
    if seq_axis is None:
        cache[:, :, offset:offset + t] = chunk
        return
    l_local, dim, k = cache.shape[2], mesh.dim(seq_axis), len(mesh.sizes)
    dst, src = mesh.grid(cache), mesh.grid(chunk)
    for s in range(mesh.shape[seq_axis]):
        lo, hi = max(offset, s * l_local), min(offset + t, (s + 1) * l_local)
        if lo < hi:  # after select, B is dim k - 1 and the slots dim k
            dst.select(dim, s).narrow(k, lo - s * l_local, hi - lo).copy_(
                src.select(dim, s).narrow(k, lo - offset, hi - lo))


def _int8_attend(q, ck, cks, cv, cvs, offset: int, max_len: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Attend a chunk ``q`` (B, t, H, D) at ``offset`` over the live slots of
    an int8 cache whose chunk is written: fused over the int8 payloads
    (``quantized_cache_attention``), or through ``local_attention`` over one
    dequantized copy in ``dtype``, by the JAX gate on the cache's full
    length ``max_len``."""
    t = q.shape[1]
    live = slice(0, offset + t)
    heads, kv_heads, head = q.shape[2], ck.shape[2], ck.shape[3]
    score_b = 4 * heads * t
    dequant_b = 2 * kv_heads * head * (torch.finfo(dtype).bits // 8)
    dense_max = attention_ops._DENSE_MAX_T
    if t == 1 or score_b <= dequant_b or t * max_len <= dense_max * dense_max:
        return attention_ops.quantized_cache_attention(
            q, ck[:, live], cks[:, live], cv[:, live], cvs[:, live], q_offset=offset)

    def dequant(c, s):
        return c[:, live].to(dtype) * s[:, live, :, None].to(dtype)

    return attention_ops.local_attention(
        q, dequant(ck, cks), dequant(cv, cvs), causal=True, q_offset=offset)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """A rank stack (R, B, ...) as one batch (R·B, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (token, head) row int8 quantization of ``x`` (..., D): the
    payload ``clip(round(x / s), -127, 127)`` and the f32 scale ``s =
    max(amax(|x|) / 127, 1e-8)``, each step in x's dtype as the JAX cache
    takes it (``/ 127`` as a multiply by f32(1/127), as XLA folds it), so
    the payloads and the scales are bit-equal to the jitted JAX ones."""
    amax = x.abs().amax(dim=-1)
    s = (amax.float() * _INV_127).to(x.dtype)
    s = torch.clamp_min(s, 1e-8).float()
    q = torch.clamp(torch.round(x / s[..., None].to(x.dtype)), -127, 127)
    return q.to(torch.int8), s


class Attention(nn.Module):
    """Causal multi-head self-attention with RoPE and grouped-query K/V
    (``n_kv_heads`` < ``n_heads``; 1 = MQA). No bias on ``out``;
    ``out_bias`` is added after it."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int | None,
                 compute_dtype: torch.dtype, gen: torch.Generator | None, *,
                 seq_axis: str | None = None, seq_impl: str = "ring",
                 model_axis: str | None = None, tp_size: int = 1) -> None:
        super().__init__()
        kv_heads = n_heads if n_kv_heads is None else n_kv_heads
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} not divisible by n_heads={n_heads}")
        if n_heads % tp_size:
            raise ValueError(f"self.n_heads={n_heads} not divisible by self.tp_size={tp_size}")
        if kv_heads < 1:
            raise ValueError(f"n_kv_heads must be >= 1, got {kv_heads}")
        if n_heads % kv_heads:
            raise ValueError(f"n_heads={n_heads} not divisible by n_kv_heads={kv_heads}")
        if kv_heads % tp_size:
            raise ValueError(
                f"n_kv_heads={kv_heads} not divisible by self.tp_size={tp_size}")
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(f"unknown seq_impl {seq_impl!r}")
        head = d_model // n_heads
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.model_axis, self.tp_size = model_axis, tp_size
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
            out = attention_ops.local_attention(q, k, v, causal=True)
        elif cache.quantized:
            t = x.shape[1]
            ck, cv = cache.k[layer], cache.v[layer]
            cks, cvs = cache.k_scale[layer], cache.v_scale[layer]
            (kq, ks), (vq, vs) = quantize(k), quantize(v)
            ck[:, offset:offset + t], cks[:, offset:offset + t] = kq, ks
            cv[:, offset:offset + t], cvs[:, offset:offset + t] = vq, vs
            out = _int8_attend(q, ck, cks, cv, cvs, offset, cache.max_len, k.dtype)
        else:
            t = x.shape[1]
            ck, cv = cache.k[layer], cache.v[layer]
            ck[:, offset:offset + t] = k
            cv[:, offset:offset + t] = v
            # the live slots only: at an empty-cache prefill this is causal
            # self-attention over the chunk (K4 on gated lengths)
            out = attention_ops.local_attention(
                q, ck[:, :offset + t], cv[:, :offset + t], causal=True,
                q_offset=offset,
            )
        h, hd, d = self.out_kernel.shape
        y = _dense(out.reshape(*out.shape[:-2], h * hd),
                   self.out_kernel.reshape(h * hd, d), None, self.dtype)
        return y + self.out_bias.to(y.dtype)

    def forward_ranks(self, x: torch.Tensor, p: dict, mesh: RankMesh) -> torch.Tensor:
        """Every rank's attention over its rows ``x`` (R, B, T_local, d)
        with its own parameters ``p`` (name -> (R, *local)): its H/tp query
        and H_kv/tp K/V heads, rope from its sequence shard's start, the
        sequence schedule over ``seq_axis``, the partial out-projection, one
        psum over ``model_axis``, then ``out_bias``."""
        r, b, t, _ = x.shape

        def proj(name: str) -> torch.Tensor:
            kernel = p[f"{name}_kernel"]
            y = _rank_dense(x, kernel.reshape(r, kernel.shape[1], -1),
                            p[f"{name}_bias"].reshape(r, -1), self.dtype)
            return y.reshape(r, b, t, kernel.shape[2], kernel.shape[3])

        q, k, v = proj("q"), proj("k"), proj("v")
        offset = 0
        if self.seq_axis is not None:
            offset = (mesh.index(self.seq_axis) * t).repeat_interleave(b)
        q = rope(q.reshape(r * b, *q.shape[2:]), offset).reshape(q.shape)
        k = rope(k.reshape(r * b, *k.shape[2:]), offset).reshape(k.shape)
        attend = ulysses_attention if self.seq_impl == "ulysses" else ring_attention
        if self.seq_axis is None:
            out = attention_ops.local_attention(
                q.reshape(r * b, *q.shape[2:]), k.reshape(r * b, *k.shape[2:]),
                v.reshape(r * b, *v.shape[2:]), causal=True).reshape(q.shape)
        else:
            out = attend(q, k, v, mesh, self.seq_axis, causal=True)
        kernel = p["out_kernel"]
        y = _rank_dense(out.reshape(r, b, t, -1), kernel.reshape(r, -1, kernel.shape[-1]),
                        None, self.dtype)
        if self.model_axis is not None:
            y = mesh.psum(y, self.model_axis)
        return y + _rank_vector(p["out_bias"], y).to(y.dtype)

    def decode_ranks(self, x: torch.Tensor, p: dict, mesh: RankMesh, cache: RankKVCache,
                     layer: int, *, seq_axis: str | None,
                     model_axis: str | None) -> torch.Tensor:
        """The decode branch of every rank: the chunk ``x`` (R, B, t, d),
        the same tokens on every rank, at the cache's index. Each rank
        projects its query and K/V heads, rope from the index, writes its
        K/V (int8 payloads and scales when quantized) into its cache slots
        (:func:`_write_slots`), then attends: with ``seq_axis`` over every
        rank's slots through ``seq_decode_attention`` (int8 or not, as the
        JAX branch), else over its live slots as on one device (the ranks
        folded into the batch: one K4 launch for all at a gated prefill).
        The out-projection's partial sums are psummed over ``model_axis``
        before ``out_bias``."""
        r, b, t, _ = x.shape
        offset = cache.index

        def proj(name: str) -> torch.Tensor:
            kernel = p[f"{name}_kernel"]
            y = _rank_dense(x, kernel.reshape(r, kernel.shape[1], -1),
                            p[f"{name}_bias"].reshape(r, -1), self.dtype)
            y = y.reshape(r * b, t, kernel.shape[2], kernel.shape[3])
            return rope(y, offset) if name != "v" else y

        q, k, v = proj("q"), proj("k"), proj("v")
        ck, cv = cache.k[layer], cache.v[layer]
        scales = (None, None)
        if cache.quantized:
            (k, ks), (v, vs) = quantize(k), quantize(v)
            scales = (cache.k_scale[layer], cache.v_scale[layer])
            for c, chunk in zip(scales, (ks, vs)):
                _write_slots(c, chunk.reshape(r, b, *chunk.shape[1:]), mesh, seq_axis, offset)
        for c, chunk in ((ck, k), (cv, v)):
            _write_slots(c, chunk.reshape(r, b, *chunk.shape[1:]), mesh, seq_axis, offset)
        if seq_axis is not None:
            out = attention_ops.seq_decode_attention(
                q.reshape(r, b, *q.shape[1:]), ck, cv, mesh, seq_axis, q_offset=offset,
                k_scale=scales[0], v_scale=scales[1]).reshape(q.shape)
        elif cache.quantized:
            out = _int8_attend(q, _fold(ck), _fold(scales[0]), _fold(cv), _fold(scales[1]),
                               offset, cache.max_len, self.dtype)
        else:
            live = offset + t
            out = attention_ops.local_attention(
                q, _fold(ck)[:, :live], _fold(cv)[:, :live], causal=True, q_offset=offset)
        kernel = p["out_kernel"]
        y = _rank_dense(out.reshape(r, b, t, -1), kernel.reshape(r, -1, kernel.shape[-1]),
                        None, self.dtype)
        if model_axis is not None:
            y = mesh.psum(y, model_axis)
        return y + _rank_vector(p["out_bias"], y).to(y.dtype)


class Block(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + mlp(LN(x)) + mlp_bias; no
    bias on ``mlp_down``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int | None,
                 mlp_ratio: int, compute_dtype: torch.dtype,
                 gen: torch.Generator | None, *, seq_axis: str | None = None,
                 seq_impl: str = "ring", model_axis: str | None = None,
                 tp_size: int = 1) -> None:
        super().__init__()
        hidden = mlp_ratio * d_model
        if hidden % tp_size:
            raise ValueError(f"mlp hidden {hidden} not divisible by self.tp_size={tp_size}")
        self.dtype = compute_dtype
        self.model_axis = model_axis
        self.ln1 = LayerNorm(d_model, compute_dtype)
        self.attn = Attention(d_model, n_heads, n_kv_heads, compute_dtype, gen,
                              seq_axis=seq_axis, seq_impl=seq_impl,
                              model_axis=model_axis, tp_size=tp_size)
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

    def forward_ranks(self, x: torch.Tensor, p: dict, mesh: RankMesh) -> torch.Tensor:
        """The block on every rank's rows ``x`` (R, B, T_local, d) with its
        own parameters ``p`` (name -> (R, *local)): the MLP's hidden units
        split over ``model_axis``, one psum completing ``mlp_down``, then
        ``mlp_bias``."""
        x = x + self.attn.forward_ranks(self.ln1.forward_ranks(x, _sub(p, "ln1.")),
                                        _sub(p, "attn."), mesh)
        return self._mlp_ranks(x, p, mesh, self.model_axis)

    def decode_ranks(self, x: torch.Tensor, p: dict, mesh: RankMesh, cache: RankKVCache,
                     layer: int, *, seq_axis: str | None,
                     model_axis: str | None) -> torch.Tensor:
        """The block's decode step on every rank (``Attention.decode_ranks``),
        the MLP's psum over ``model_axis``."""
        x = x + self.attn.decode_ranks(self.ln1.forward_ranks(x, _sub(p, "ln1.")),
                                       _sub(p, "attn."), mesh, cache, layer,
                                       seq_axis=seq_axis, model_axis=model_axis)
        return self._mlp_ranks(x, p, mesh, model_axis)

    def _mlp_ranks(self, x: torch.Tensor, p: dict, mesh: RankMesh,
                   model_axis: str | None) -> torch.Tensor:
        h = _rank_dense(self.ln2.forward_ranks(x, _sub(p, "ln2.")), p["mlp_up_kernel"],
                        p["mlp_up_bias"], self.dtype)
        h = F.gelu(h, approximate="tanh")
        y = _rank_dense(h, p["mlp_down_kernel"], None, self.dtype)
        if model_axis is not None:
            y = mesh.psum(y, model_axis)
        return x + y + _rank_vector(p["mlp_bias"], y).to(y.dtype)


class _RankMode:
    """What both LMs' rank modes share: the parameters as rank views under
    the model's ``param_specs()``, and the embedding of a rank stack of
    tokens."""

    def rank_views(self, mesh: RankMesh) -> dict[str, torch.Tensor]:
        """Every parameter as its grid-form rank view (``rank_view``)."""
        specs = self.param_specs()
        return {name: rank_view(p, specs[name], mesh) for name, p in self.named_parameters()}

    def _embed_ranks(self, tokens, mesh, params):
        """Each rank's parameters, (R, *local) (its rank views by default),
        and its embedded tokens from the rank stack (R, B, T)."""
        r = mesh.size
        if tokens.ndim != 3 or tokens.shape[0] != r:
            raise ValueError(f"need a ({r}, B, T) rank stack of tokens, got {tuple(tokens.shape)}")
        if params is None:
            params = self.rank_views(mesh)
        k = len(mesh.sizes)
        p = {name: t.reshape(r, *t.shape[k:]) for name, t in params.items()}
        ranks = torch.arange(r, device=tokens.device)[:, None, None]
        return p, p["embedding"].to(self.compute_dtype)[ranks, tokens.long()]


class TransformerLM(_RankMode, nn.Module):
    """Tokens (B, T) -> logits (B, T, vocab) f32.

    Parameters are f32, drawn from ``seed`` with a ``torch.Generator`` on the
    CPU (flax's scales: normal 1/sqrt(fan_in) kernels, zero biases, unit
    norm scales), so the same seed gives the same weights on every device,
    then moved to ``device``: the CUDA card unless ``"cpu"`` is asked for
    (no CUDA and no ``"cpu"`` raises). ``compute_dtype`` is
    ``torch.float32`` or ``torch.bfloat16``. ``remat`` recomputes each
    block in the backward (see the module docstring).

    ``seq_axis``/``seq_impl``/``model_axis``/``tp_size``: with either axis
    set the model runs over a mesh of virtual ranks (the module docstring);
    its parameters keep their full shapes, ``tp_size`` fixes how the TP
    leaves split (:meth:`param_specs`).
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
        seq_axis: str | None = None,
        seq_impl: str = "ring",
        model_axis: str | None = None,
        tp_size: int = 1,
    ) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_heads if n_kv_heads is None else n_kv_heads
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.model_axis, self.tp_size = model_axis, tp_size
        gen = torch.Generator().manual_seed(seed)
        self.embedding = _param(gen, vocab, d_model, fan_in=d_model)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, n_kv_heads, mlp_ratio, compute_dtype, gen,
                  seq_axis=seq_axis, seq_impl=seq_impl, model_axis=model_axis,
                  tp_size=tp_size)
            for _ in range(n_layers)
        )
        self.ln_f = LayerNorm(d_model, compute_dtype)
        self.head_kernel = _param(gen, d_model, vocab, fan_in=d_model)
        self.head_bias = _zeros(vocab)
        self.to(resolve_device(device))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def sharded(self) -> bool:
        """Whether the model runs over a mesh (``seq_axis`` or ``model_axis``)."""
        return self.seq_axis is not None or self.model_axis is not None

    def param_specs(self) -> dict[str, PartitionSpec]:
        """Each parameter's spec: :func:`tp_param_specs` over ``model_axis``
        when ``tp_size`` > 1, else replicated."""
        if self.model_axis is not None and self.tp_size > 1:
            return tp_param_specs(self, self.model_axis)
        return {name: () for name, _ in self.named_parameters()}

    def forward(self, tokens: torch.Tensor, cache: KVCache | None = None, *,
                mesh: RankMesh | None = None,
                params: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
        """Tokens (B, T) -> logits (B, T, vocab) f32; or, for a sharded
        model, the rank stack of tokens (R, B_local, T_local) -> every rank's
        logits (R, B_local, T_local, vocab) f32 over ``mesh``, from
        ``params`` (name -> grid-form rank view, as :meth:`rank_views` makes
        them from the model's own parameters by default)."""
        if self.sharded:
            return self._forward_ranks(tokens, cache, mesh, params)
        if mesh is not None or params is not None:
            raise ValueError("mesh and params are for a model with seq_axis or model_axis")
        return self.forward_one(tokens, cache)

    def forward_one(self, tokens: torch.Tensor, cache: KVCache | None = None) -> torch.Tensor:
        """The model on one device, whatever its axes (its parameters have
        their full shapes): tokens (B, T) -> logits (B, T, vocab) f32."""
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

    def _forward_ranks(self, tokens, cache, mesh, params) -> torch.Tensor:
        if mesh is None:
            raise ValueError("a model with seq_axis or model_axis runs over a mesh: pass mesh=")
        for axis in (self.seq_axis, self.model_axis):
            if axis is not None and axis not in mesh.axis_names:
                raise ValueError(f"axis {axis!r} not in mesh axes {mesh.axis_names}")
        if self.model_axis is not None and mesh.shape[self.model_axis] != self.tp_size:
            raise ValueError(f"tp_size={self.tp_size} but the mesh's {self.model_axis!r} axis "
                             f"has {mesh.shape[self.model_axis]} ranks")
        if cache is not None:
            return self.decode_ranks(tokens, cache, mesh, params, seq_axis=self.seq_axis,
                                     model_axis=self.model_axis)
        p, x = self._embed_ranks(tokens, mesh, params)
        remat = self.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            sub = _sub(p, f"blocks.{i}.")
            if remat:
                x = checkpoint(block.forward_ranks, x, sub, mesh, use_reentrant=False)
            else:
                x = block.forward_ranks(x, sub, mesh)
        x = self.ln_f.forward_ranks(x, _sub(p, "ln_f."))
        return _rank_dense(x, p["head_kernel"], p["head_bias"], self.compute_dtype).float()

    def decode_ranks(self, tokens: torch.Tensor, cache: RankKVCache, mesh: RankMesh,
                     params: dict[str, torch.Tensor] | None = None, *,
                     seq_axis: str | None = None,
                     model_axis: str | None = None) -> torch.Tensor:
        """Decode over a mesh of virtual ranks: the chunk ``tokens`` (R, B,
        t), the same on every rank, at the cache's index -> every rank's
        logits (R, B, t, vocab) f32, equal across ranks; the index then
        moves by t. ``seq_axis`` shards the cache's slots (``cache`` has
        ``seq_shards`` equal to its size), ``model_axis`` the heads, whose
        parameters then reach each rank as their TP shards (``params``:
        name -> grid-form view, e.g. ``rank_view`` under
        :func:`tp_param_specs`)."""
        sp = mesh.shape[seq_axis] if seq_axis is not None else 1
        if not isinstance(cache, RankKVCache):
            raise TypeError("decode over a mesh takes a RankKVCache (LMGenerator.init_cache "
                            "with a mesh)")
        if cache.seq_shards != sp:
            raise ValueError(f"the cache is in {cache.seq_shards} slot shards, the mesh's "
                             f"seq axis has {sp}")
        t = tokens.shape[-1]
        if cache.index + t > cache.max_len:
            raise ValueError(f"cache index {cache.index} + {t} tokens exceeds "
                             f"max_len {cache.max_len}")
        p, x = self._embed_ranks(tokens, mesh, params)
        for i, block in enumerate(self.blocks):
            x = block.decode_ranks(x, _sub(p, f"blocks.{i}."), mesh, cache, i,
                                   seq_axis=seq_axis, model_axis=model_axis)
        x = self.ln_f.forward_ranks(x, _sub(p, "ln_f."))
        cache.index += t
        return _rank_dense(x, p["head_kernel"], p["head_bias"], self.compute_dtype).float()


class MoEBlock(nn.Module):
    """Pre-norm block whose MLP is a Switch/GShard mixture of experts:
    x + attn(LN(x)), then x + moe(LN(x)); returns ``(x, aux, dropped)``.
    The router (d, E) and the stacked experts ``moe_w1`` (E, d, hidden),
    ``moe_b1`` (E, hidden), ``moe_w2`` (E, hidden, d) are f32 parameters
    (lecun-normal scales over flax's fans, which count the expert dim),
    cast to the compute dtype inside :func:`..ops.moe.moe_dispatch_compute`;
    the router's logits are f32. ``expert_axis``/``ep_size``, ``seq_axis``
    and ``seq_impl`` are the JAX block's, for :meth:`forward_ranks`."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int | None, n_experts: int,
                 mlp_ratio: int, capacity_factor: float, compute_dtype: torch.dtype,
                 router_topk: int, dispatch_impl: str, gen: torch.Generator | None, *,
                 expert_axis: str | None = None, ep_size: int = 1,
                 seq_axis: str | None = None, seq_impl: str = "ring") -> None:
        super().__init__()
        if n_experts % ep_size:
            raise ValueError(f"self.n_experts={n_experts} not divisible by "
                             f"self.ep_size={ep_size}")
        hidden = mlp_ratio * d_model
        self.n_experts, self.capacity_factor = n_experts, capacity_factor
        self.router_topk, self.dispatch_impl = router_topk, dispatch_impl
        self.expert_axis = expert_axis if ep_size > 1 else None
        self.seq_axis = seq_axis
        self.ln1 = LayerNorm(d_model, compute_dtype)
        self.attn = Attention(d_model, n_heads, n_kv_heads, compute_dtype, gen,
                              seq_axis=seq_axis, seq_impl=seq_impl)
        self.ln2 = LayerNorm(d_model, compute_dtype)
        self.router = _param(gen, d_model, n_experts, fan_in=d_model)
        self.moe_w1 = _param(gen, n_experts, d_model, hidden, fan_in=n_experts * d_model)
        self.moe_b1 = _zeros(n_experts, hidden)
        self.moe_w2 = _param(gen, n_experts, hidden, d_model, fan_in=n_experts * hidden)

    def forward(self, x: torch.Tensor):
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        y, aux, dropped = moe_dispatch_compute(
            h.reshape(-1, h.shape[-1]), self.router, self.moe_w1, self.moe_b1, self.moe_w2,
            n_experts=self.n_experts, capacity_factor=self.capacity_factor,
            router_topk=self.router_topk, dispatch_impl=self.dispatch_impl,
        )
        return x + y.reshape(x.shape), aux, dropped

    def forward_ranks(self, x: torch.Tensor, p: dict, mesh: RankMesh):
        """The block on every rank's rows ``x`` (R, B, T_local, d) with its
        own parameters ``p`` (name -> (R, *local): its shard of the experts
        under ``expert_axis``): attention over ``seq_axis``, then each rank
        routes its own tokens; returns ``(x, aux (R,), dropped (R,))``."""
        r, d = x.shape[0], x.shape[-1]
        x = x + self.attn.forward_ranks(self.ln1.forward_ranks(x, _sub(p, "ln1.")),
                                        _sub(p, "attn."), mesh)
        h = self.ln2.forward_ranks(x, _sub(p, "ln2."))
        y, aux, dropped = moe_dispatch_compute(
            h.reshape(r, -1, d), p["router"], p["moe_w1"], p["moe_b1"], p["moe_w2"],
            n_experts=self.n_experts, capacity_factor=self.capacity_factor,
            expert_axis=self.expert_axis, router_topk=self.router_topk,
            seq_axis=self.seq_axis, dispatch_impl=self.dispatch_impl, mesh=mesh,
        )
        return x + y.reshape(x.shape), aux, dropped


class MoETransformerLM(_RankMode, nn.Module):
    """Decoder-only LM with Switch/GShard MoE MLPs: tokens (B, T) ->
    ``(logits f32, aux / n_layers, dropped / n_layers)``.

    The JAX ``MoETransformerLM``: ``n_experts`` experts, ``router_topk`` 1
    (Switch) or 2 (GShard), ``dispatch_impl`` "einsum", "scatter" or "auto"
    (``ops.moe``). Parameters are drawn from ``seed`` by a generator on
    ``device`` (the card unless ``"cpu"``), at :class:`TransformerLM`'s
    scales: at the bench width the 2.28B weights would take tens of seconds
    to draw on the host. So one seed gives other weights on the card than on
    the CPU; carry them across (``set_flat_params``) to compare the two. Its
    parameter names map onto the flax tree's ``MoEBlock_i``
    (:func:`..models.convert.moe_flax_path`).

    Over virtual ranks (``forward(..., mesh=...)``), as ``TransformerLM``'s
    rank mode: every rank on its rows and ``seq_axis`` columns, its view of
    each parameter (:meth:`param_specs`: :func:`ep_param_specs` over
    ``expert_axis`` when ``ep_size`` > 1, its ``n_experts / ep_size``
    experts), attention over ``seq_axis`` by ``seq_impl``, the experts
    reached through the all_to_all pair; the parameters keep their full
    shapes."""

    flax_path = staticmethod(moe_flax_path)

    def __init__(
        self,
        vocab: int = 256,
        d_model: int = 128,
        n_heads: int = 4,
        n_kv_heads: int | None = None,
        n_layers: int = 2,
        n_experts: int = 4,
        mlp_ratio: int = 4,
        capacity_factor: float = 1.25,
        compute_dtype: torch.dtype = torch.float32,
        router_topk: int = 1,
        dispatch_impl: str = "auto",
        *,
        expert_axis: str | None = None,
        ep_size: int = 1,
        seq_axis: str | None = None,
        seq_impl: str = "ring",
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(f"unknown seq_impl {seq_impl!r}")
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_heads if n_kv_heads is None else n_kv_heads
        self.n_experts, self.router_topk = n_experts, router_topk
        self.compute_dtype = compute_dtype
        self.expert_axis, self.ep_size = expert_axis, ep_size
        self.seq_axis = seq_axis
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedding = _param(gen, vocab, d_model, fan_in=d_model)
        self.blocks = nn.ModuleList(
            MoEBlock(d_model, n_heads, n_kv_heads, n_experts, mlp_ratio, capacity_factor,
                     compute_dtype, router_topk, dispatch_impl, gen,
                     expert_axis=expert_axis, ep_size=ep_size, seq_axis=seq_axis,
                     seq_impl=seq_impl)
            for _ in range(n_layers)
        )
        self.ln_f = LayerNorm(d_model, compute_dtype)
        self.head_kernel = _param(gen, d_model, vocab, fan_in=d_model)
        self.head_bias = _zeros(vocab)
        self.to(dev)

    def param_specs(self) -> dict[str, PartitionSpec]:
        """Each parameter's spec: :func:`ep_param_specs` over
        ``expert_axis`` when ``ep_size`` > 1, else replicated."""
        if self.expert_axis is not None and self.ep_size > 1:
            return ep_param_specs(self, self.expert_axis)
        return {name: () for name, _ in self.named_parameters()}

    def forward(self, tokens: torch.Tensor, *, mesh: RankMesh | None = None,
                params: dict[str, torch.Tensor] | None = None):
        """Tokens (B, T) -> ``(logits (B, T, vocab) f32, aux, dropped)``; or,
        over ``mesh``, the rank stack (R, B_local, T_local) -> every rank's
        ``(logits (R, B_local, T_local, vocab), aux (R,), dropped (R,))``
        from ``params`` (name -> grid-form rank view; :meth:`rank_views`
        by default)."""
        if mesh is not None:
            return self._forward_ranks(tokens, mesh, params)
        if self.expert_axis is not None and self.ep_size > 1 or self.seq_axis is not None:
            raise ValueError("a model with expert_axis or seq_axis runs over a mesh: pass mesh=")
        x = self.embedding.to(self.compute_dtype)[tokens.long()]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        dropped_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x, aux, dropped = block(x)
            aux_total = aux_total + aux
            dropped_total = dropped_total + dropped
        x = self.ln_f(x)
        logits = _dense(x, self.head_kernel, self.head_bias, self.compute_dtype)
        return logits.float(), aux_total / self.n_layers, dropped_total / self.n_layers

    def _forward_ranks(self, tokens, mesh, params):
        for axis in (self.expert_axis, self.seq_axis):
            if axis is not None and axis not in mesh.axis_names:
                raise ValueError(f"axis {axis!r} not in mesh axes {mesh.axis_names}")
        if self.expert_axis is not None and mesh.shape[self.expert_axis] != self.ep_size:
            raise ValueError(f"ep_size={self.ep_size} but the mesh's {self.expert_axis!r} "
                             f"axis has {mesh.shape[self.expert_axis]} ranks")
        r = mesh.size
        p, x = self._embed_ranks(tokens, mesh, params)
        aux_total = torch.zeros(r, dtype=torch.float32, device=x.device)
        dropped_total = torch.zeros(r, dtype=torch.float32, device=x.device)
        for i, block in enumerate(self.blocks):
            x, aux, dropped = block.forward_ranks(x, _sub(p, f"blocks.{i}."), mesh)
            aux_total = aux_total + aux
            dropped_total = dropped_total + dropped
        x = self.ln_f.forward_ranks(x, _sub(p, "ln_f."))
        logits = _rank_dense(x, p["head_kernel"], p["head_bias"], self.compute_dtype)
        return logits.float(), aux_total / self.n_layers, dropped_total / self.n_layers


def tp_param_specs(model: nn.Module, model_axis: str) -> dict[str, PartitionSpec]:
    """Each parameter's spec (``parallel.mesh.PartitionSpec``) for
    Megatron-style TP over ``model_axis``, by the JAX function's path rules
    on the leaf's flax path (``models.convert.flax_path``): q/k/v kernels and
    biases shard on the HEAD dim, the out-projection kernel on its head
    input dim, ``mlp_up`` on the hidden (output) dim, ``mlp_down`` on the
    hidden (input) dim; everything else (embeddings, norms, the post-psum
    biases, the LM head) replicates, ``()``. Optimizer moments are the same
    elements, so the same specs hold for them."""
    key = getattr(model, "flax_path", flax_path)

    def spec(name: str) -> PartitionSpec:
        joined = "/".join(("params", *key(name)))
        if "/q/" in joined or "/k/" in joined or "/v/" in joined:
            if joined.endswith("kernel"):
                return (None, model_axis, None)
            return (model_axis, None)  # bias (heads, head_dim)
        if joined.endswith("out/kernel"):
            return (model_axis, None, None)
        if joined.endswith("mlp_up/kernel"):
            return (None, model_axis)
        if joined.endswith("mlp_up/bias"):
            return (model_axis,)
        if joined.endswith("mlp_down/kernel"):
            return (model_axis, None)
        return ()

    return {name: spec(name) for name, _ in model.named_parameters()}


def ep_param_specs(model: nn.Module, expert_axis: str) -> dict[str, PartitionSpec]:
    """Each parameter's spec for expert parallelism over ``expert_axis``, by
    the JAX function's path rules: ``moe_w1``/``moe_w2`` shard their leading
    (expert) dim, ``(expert_axis, None, None)``, ``moe_b1`` as
    ``(expert_axis, None)``; the router and everything else replicate. The
    same specs hold for the optimizer's moments."""
    key = getattr(model, "flax_path", flax_path)

    def spec(name: str) -> PartitionSpec:
        joined = "/".join(("params", *key(name)))
        if joined.endswith("moe_w1") or joined.endswith("moe_w2"):
            return (expert_axis, None, None)
        if joined.endswith("moe_b1"):
            return (expert_axis, None)
        return ()

    return {name: spec(name) for name, _ in model.named_parameters()}
