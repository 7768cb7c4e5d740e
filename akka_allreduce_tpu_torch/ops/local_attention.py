"""Single-device attention cores: blockwise (flash-style) and kernel dispatch.

Counterpart of ``akka_allreduce_tpu/ops/local_attention.py``.
:func:`local_attention` dispatches three ways, as the JAX function does:

- dense (:func:`attention_reference`) when the score matrix is small,
  Tq * Tk <= 512 * 512 (the decode-over-cache shape lands here);
- K4, the flash-attention kernel (:mod:`.flash_attention`), when the flash
  gate holds: zero offsets, Tq == Tk and :func:`flash_shapes_ok`;
- :func:`blockwise_attention` otherwise: an online-softmax loop over K/V
  blocks, O(T * block) live memory instead of O(T^2). Each block's fold
  is checkpointed, as the JAX ``lax.scan`` step is under ``jax.checkpoint``:
  the backward recomputes the block's scores, so autograd keeps one
  ``(o, l, m)`` carry per block, O((T / block) * T * D), not the scores.

The JAX gate also refused interpret mode, because the Pallas kernel cannot
run compiled off the TPU. Here the K4 wrapper makes that choice from the
tensor itself: a CUDA tensor runs the kernel (or raises), a CPU tensor runs
K4's plain PyTorch version. So on the CPU a gated shape takes K4's plain
version, and on the card it takes the kernel, never a silent fallback.

Convention for a query row with no visible keys: the output row is zero.

:func:`quantized_cache_attention` attends over an int8 KV cache with its
per-row scales folded into the scores and the weights
(:func:`_scaled_masked_scores`, :func:`_weighted_v`), so no dequantized
copy of the cache is made. As in the JAX package these are plain einsums
outside any kernel.

:func:`seq_decode_attention` attends over a cache whose slots are sharded
over a mesh axis of virtual ranks (``parallel.mesh.RankMesh``): each rank
computes its partial softmax over its own slots and the partials merge
split-K style, one ``pmax`` and two ``psum`` s of the rank stack, in f32.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from akka_allreduce_tpu_torch.ops.flash_attention import flash_attention
from akka_allreduce_tpu_torch.ops.ring_attention import (
    _MASK_VALUE,
    attention_reference,
    causal_mask,
    online_softmax_update,
    repeat_kv,
)

# dense is fine (and fastest) below this score-matrix side
_DENSE_MAX_T = 512


def _blockwise_olm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    q_offset: int,
    k_offset: int | torch.Tensor,
    block_k: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
):
    """Blockwise online-softmax partials ``(o, l, m)`` over a local K/V
    slice: ``o`` (B, H, Tq, D), ``l`` and ``m`` (B, H, Tq), all f32. The
    un-normalized core of :func:`blockwise_attention` and the local stage of
    :func:`seq_decode_attention`; a Python loop over the K/V blocks takes
    the place of the JAX ``lax.scan``, and each fold is checkpointed when a
    gradient will be taken, as JAX's ``jax.checkpoint`` step is.

    ``k_offset``: an int, or a (B,) tensor of one offset a batch row (each
    virtual rank's first slot, its rows folded into the batch). With
    ``k_scale``/``v_scale`` (B, Tk, H_kv) f32, ``k``/``v`` are int8 payloads
    dequantized to f32 one block at a time."""
    h = q.shape[2]
    if k.shape[2] != h:  # grouped-query K/V expand at compute
        group = h // k.shape[2]
        k, v = repeat_kv(k, h), repeat_kv(v, h)
        if k_scale is not None:
            k_scale = torch.repeat_interleave(k_scale, group, dim=2)
            v_scale = torch.repeat_interleave(v_scale, group, dim=2)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qf = q.float()
    q_pos = q_offset + torch.arange(tq, device=q.device)
    o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), _MASK_VALUE, dtype=torch.float32, device=q.device)
    fold = online_softmax_update
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        fold = functools.partial(checkpoint, online_softmax_update, use_reentrant=False)
    per_row = isinstance(k_offset, torch.Tensor)
    for start in range(0, tk, block_k):
        # the last block is short where JAX zero-pads it and masks the tail:
        # the padded keys contribute exactly zero either way
        kk = k[:, start:start + block_k]
        vv = v[:, start:start + block_k]
        if k_scale is not None:
            kk = kk.float() * k_scale[:, start:start + block_k, :, None]
            vv = vv.float() * v_scale[:, start:start + block_k, :, None]
        ar = start + torch.arange(kk.shape[1], device=q.device)
        mask = None
        if causal and per_row:  # (B, 1, Tq, block): each row its own offset
            mask = (q_pos[:, None] >= k_offset[:, None, None] + ar)[:, None]
        elif causal:
            mask = q_pos[:, None] >= (k_offset + ar)[None, :]
        o, l, m = fold((o, l, m), qf, kk, vv, scale, mask)
    return o, l, m


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
    block_k: int = 512,
) -> torch.Tensor:
    """Memory-efficient attention over K/V blocks; same result as
    :func:`attention_reference` to float tolerance.

    Shapes: ``q`` (B, Tq, H, D); ``k``/``v`` (B, Tk, H, D). Offsets position
    the local windows globally for causal masking.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    o, l, _ = _blockwise_olm(
        q, k, v, causal=causal, scale=scale,
        q_offset=q_offset, k_offset=k_offset, block_k=block_k,
    )
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_shapes_ok(t: int, d: int) -> bool:
    """The flash gate on shapes: T > 512, T % 512 == 0 and D % 32 == 0 (the
    JAX package's static gate for the Pallas kernel, kept as it is)."""
    return t > _DENSE_MAX_T and t % 512 == 0 and d % 32 == 0


def _flash_ok(q: torch.Tensor, k: torch.Tensor, q_offset, k_offset) -> bool:
    """Shape and placement gate for K4: zero int offsets, Tq == Tk and
    :func:`flash_shapes_ok`. Whether the kernel or its plain version runs
    follows the tensor's device, inside the K4 wrapper."""
    if not (isinstance(q_offset, int) and q_offset == 0):
        return False
    if not (isinstance(k_offset, int) and k_offset == 0):
        return False
    tq, d = q.shape[1], q.shape[3]
    return tq == k.shape[1] and flash_shapes_ok(tq, d)


def local_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Best single-device attention for the shape at hand.

    Dispatch: dense for small score matrices, K4 on gated shapes, else the
    blockwise path. All three agree with the dense oracle. Grouped-query
    K/V (fewer heads than ``q``) expand at the compute site; K4 reads the
    compact form directly.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] * k.shape[1] <= _DENSE_MAX_T * _DENSE_MAX_T:
        h = q.shape[2]
        return attention_reference(
            q, repeat_kv(k, h), repeat_kv(v, h), causal=causal, sm_scale=scale,
            q_offset=q_offset, k_offset=k_offset,
        )
    if _flash_ok(q, k, q_offset, k_offset):
        return flash_attention(q, k, v, causal=causal, sm_scale=scale)
    return blockwise_attention(
        q, k, v, causal=causal, sm_scale=scale,
        q_offset=q_offset, k_offset=k_offset,
    )


def _scaled_masked_scores(q, k, k_scale, scale: float, q_offset: int,
                          k_offset: int | torch.Tensor):
    """f32 (B, H, Tq, L) causally masked scores of ``q`` against a K slice:
    grouped-query heads repeat at the compute site, and an int8 slice's
    per-row scales fold into the scores (q·(k·s) = (q·k)·s), the product
    ``k_scale * scale`` taken first as the JAX function takes it.
    ``k_offset``: an int, or a (B,) tensor of one offset a batch row."""
    h = q.shape[2]
    kc = repeat_kv(k.to(q.dtype), h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float())
    if k_scale is not None:
        ks = torch.repeat_interleave(k_scale, h // k.shape[2], dim=2)  # (B, L, H)
        scores = scores * (ks.transpose(1, 2)[:, :, None, :] * scale)
    else:
        scores = scores * scale
    if isinstance(k_offset, torch.Tensor):
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset[:, None] + torch.arange(k.shape[1], device=q.device)  # (B, L)
        mask = (q_pos[None, :, None] >= k_pos[:, None, :])[:, None]  # (B, 1, Tq, L)
    else:
        mask = causal_mask(q.shape[1], k.shape[1], q_offset, k_offset, q.device)[None, None]
    return torch.where(mask, scores, _MASK_VALUE)


def _weighted_v(p, v, v_scale):
    """(B, H, Tq, L) weights times a V slice -> (B, H, Tq, D) f32, an int8
    slice's row scales folded into the weights (sum p·s·v = (p·s)·v)."""
    h = p.shape[1]
    vc = repeat_kv(v, h)
    if v_scale is not None:
        vs = torch.repeat_interleave(v_scale, h // v.shape[2], dim=2)
        p = p * vs.transpose(1, 2)[:, :, None, :]
    return torch.einsum("bhqk,bkhd->bhqd", p.float(), vc.float())


def quantized_cache_attention(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    q_offset: int,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Causal attention over an int8-quantized KV cache without a
    dequantized copy of it: the per-row scales fold into the scores and the
    weights, so the cache is read as int8 payloads only.

    Shapes: ``q`` (B, Tq, H, D); ``k_q``/``v_q`` (B, L, H_kv, D) int8 with
    (B, L, H_kv) f32 scales. Built for the decode shape (small Tq over a
    long cache); the scores are (B, H, Tq, L) f32.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = _scaled_masked_scores(q, k_q, k_scale, scale, q_offset, 0)
    probs = torch.softmax(scores, dim=-1)
    out = _weighted_v(probs, v_q, v_scale)
    return out.transpose(1, 2).to(q.dtype)


def seq_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str,
    *,
    q_offset: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Decode attention over a sequence-sharded KV cache.

    Rank stacks over ``mesh``: ``q`` (R, B, Tq, H, D), the same on every
    rank of ``axis_name``; ``k``/``v`` (R, B, L_local, H_kv, D), each rank's
    slice of the cache, whose first slot is global position ``seq_rank *
    L_local`` (the JAX function's ``k_offset``). Each rank scores ``q``
    against its slots (causal against global positions) and the partials
    merge over ``axis_name``:

    - dense, when ``Tq * L_local <= 512²``: the masked scores, one global
      max (``RankMesh.pmax``) taken before the exponent, so every rank's
      ``p`` has the same reference as a one-device softmax; then the psums
      of ``sum(p)`` and of ``p @ v``;
    - otherwise each rank's blockwise ``(o, l, m)`` (:func:`_blockwise_olm`)
      rescaled to the global max, then psummed.

    With ``k_scale``/``v_scale`` (R, B, L_local, H_kv) f32, ``k``/``v`` are
    int8 payloads whose scales fold into the scores and weights, as in
    :func:`quantized_cache_attention`. Accumulation is f32 throughout; the
    ranks fold into the batch of every product. Returns (R, B, Tq, H, D) in
    q's dtype, equal on every rank of the axis.
    """
    r, b, tq, h, d = q.shape
    l_local = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)

    def fold(x):
        return None if x is None else x.reshape(r * b, *x.shape[2:])

    qf, kf, vf, ksf, vsf = map(fold, (q, k, v, k_scale, v_scale))
    k_offset = (mesh.index(axis_name) * l_local).repeat_interleave(b)  # (R·B,)

    def merge(x):  # a psum over the axis of an (R·B, ...) partial
        return mesh.psum(x.reshape(r, -1), axis_name).reshape(x.shape)

    if tq * l_local <= _DENSE_MAX_T * _DENSE_MAX_T:
        scores = _scaled_masked_scores(qf, kf, ksf, scale, q_offset, k_offset)
        m_g = mesh.pmax(scores.amax(dim=-1).reshape(r, -1), axis_name)
        p = torch.exp(scores - m_g.reshape(r * b, h, tq, 1))  # masked slots: exp(-huge) = 0
        l_g = merge(p.sum(dim=-1))
        o_g = merge(_weighted_v(p, vf, vsf))
    else:
        o, l, m = _blockwise_olm(qf, kf, vf, causal=True, scale=scale, q_offset=q_offset,
                                 k_offset=k_offset, block_k=512, k_scale=ksf, v_scale=vsf)
        m_g = mesh.pmax(m.reshape(r, -1), axis_name).reshape(m.shape)
        corr = torch.exp(m - m_g)
        l_g = merge(l * corr)
        o_g = merge(o * corr[..., None])
    out = o_g / torch.clamp_min(l_g, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype).reshape(r, b, tq, h, d)
