"""Sequence parallelism: ring attention and all-to-all (Ulysses), and the
attention helpers every attention path of the port shares.

Counterpart of ``akka_allreduce_tpu/ops/ring_attention.py``: the finite
mask value, the grouped-query K/V expansion, the online-softmax block fold,
the dense oracle, and the two schedules that shard the sequence over a mesh
axis:

- :func:`ring_attention` — each rank keeps its Q shard and K/V shards
  rotate one rank a step, folded into running ``(o, l, m)`` statistics by
  :func:`online_softmax_update` (plain PyTorch einsums: the JAX fold is
  XLA einsums, no TPU kernel);
- :func:`ulysses_attention` — one all-to-all re-shards (B, T/n, H, D) to
  (B, T, H/n, D), full-sequence ``local_attention`` runs on the local head
  group (K4 on gated shapes), and the inverse all-to-all re-shards back.

The JAX functions run inside ``shard_map`` on one device's shard. Here the
ranks are virtual (``parallel.mesh.RankMesh``): ``q``/``k``/``v`` are rank
stacks ``(mesh.size, B, T_local, H, D)``, one row per rank in rank order,
and ``axis_name`` names the mesh axis the sequence is sharded over (the
other axes batch). ``ppermute`` is a roll of the stack along that axis, the
all-to-all a permutation of it (``RankMesh.all_to_all``), and every rank's
causal mask and positions come from its own position on the axis
(``RankMesh.index``). The ranks fold
into the batch of one call: one K4 launch covers every rank.

Layout of the helpers, as in the JAX package: ``q`` is (B, Tq, H, D),
``k``/``v`` are (B, Tk, H, D) (or H_kv heads before :func:`repeat_kv`).
Offsets are host ints: the global positions of the local windows for causal
masking.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

# Finite stand-in for -inf: keeps the online-softmax recurrence NaN-free when
# an entire (causal-masked) block is invisible to a query row. Masked entries
# get p = 0 explicitly, so the sentinel never leaks into l or o.
_MASK_VALUE = -1e30


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Expand grouped-query K/V (B, T, H_kv, D) to ``n_heads`` by repeating
    each KV head over its query group (GQA; H_kv == 1 is MQA)."""
    h_kv = k.shape[2]
    if h_kv == n_heads:
        return k
    if n_heads % h_kv:
        raise ValueError(f"n_heads={n_heads} not divisible by kv heads {h_kv}")
    return torch.repeat_interleave(k, n_heads // h_kv, dim=2)


def causal_mask(tq: int, tk: int, q_offset: int, k_offset: int,
                device: torch.device) -> torch.Tensor:
    """(Tq, Tk) bool visibility: global q position >= global k position."""
    q_pos = q_offset + torch.arange(tq, device=device)
    k_pos = k_offset + torch.arange(tk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def online_softmax_update(olm, qf, kk, vv, scale: float, mask):
    """One flash-style block fold: merge K/V block (kk, vv) into the running
    ``(o, l, m)`` statistics for queries ``qf`` (all f32).

    ``o`` (B, H, Tq, D), ``l`` and ``m`` (B, H, Tq). ``mask``: bool
    (Tq, Tk_block) visibility, one a batch row broadcast over the heads
    (B, 1, Tq, Tk_block), or None for a fully visible block. Masked
    positions contribute exactly zero, including the corner case where a
    whole row has seen nothing yet (m still at the sentinel).
    """
    o, l, m = olm
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kk.float()) * scale
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None, None]
        scores = torch.where(mask, scores, _MASK_VALUE)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vv.float())
    return o, l, m_new


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Dense softmax attention, the single-device oracle.

    Shapes: ``q`` (B, Tq, H, D); ``k``/``v`` (B, Tk, H, D). Scores and the
    softmax are f32; the output is cast to ``q``'s dtype.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], q_offset, k_offset, q.device)
        scores = torch.where(mask[None, None], scores, _MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _fold_ranks(x: torch.Tensor) -> torch.Tensor:
    """A rank stack (R, B, ...) as one batch (R·B, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _local_core(q, k, v, causal: bool, sm_scale):
    """``local_attention`` over every rank of the stacks at once."""
    from akka_allreduce_tpu_torch.ops.local_attention import local_attention

    out = local_attention(_fold_ranks(q), _fold_ranks(k), _fold_ranks(v),
                          causal=causal, sm_scale=sm_scale)
    return out.reshape(q.shape)


def _ring_fold(olm, qf, kk, vv, scale: float, mask):
    """One ring step's fold: the compact K/V block expands to q's heads at
    the compute site, then merges into ``(o, l, m)``."""
    h = qf.shape[2]
    return online_softmax_update(olm, qf, repeat_kv(kk, h), repeat_kv(vv, h), scale, mask)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Blockwise ring attention over the sequence shards of ``axis_name``.

    ``q``/``k``/``v``: rank stacks ``(mesh.size, B, T_local, H, D)`` (K/V
    may carry H_kv heads dividing H); the global sequence of a rank is the
    concatenation of the shards of the ranks that differ from it only along
    ``axis_name``, in axis order. Returns the ``(mesh.size, B, T_local, H,
    D)`` stack of outputs, as if dense attention ran over each full
    sequence.

    K/V rotate one rank a step (position i -> i + 1), so after step ``s``
    the rank at position ``i`` holds the shard of ``(i - s) mod n``; the
    last block is folded without a rotation after it. The compact GQA form
    rotates. Each rank's causal mask at each step comes from its own
    position and the source's. Each fold is checkpointed when a gradient
    will be taken (the backward recomputes its scores, as the blockwise
    path does), so the dense (T_local, T_local) blocks are not kept. At
    n = 1 this is ``local_attention`` over every rank at once.
    """
    n = mesh.shape[axis_name]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if n == 1:
        return _local_core(q, k, v, causal, scale)
    r, b, t, h, d = q.shape
    my = mesh.index(axis_name)  # (R,)
    qf = _fold_ranks(q).float()
    ar = torch.arange(t, device=q.device)
    q_pos = my[:, None] * t + ar  # (R, t)
    o = torch.zeros((r * b, h, t, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((r * b, h, t), dtype=torch.float32, device=q.device)
    m = torch.full((r * b, h, t), _MASK_VALUE, dtype=torch.float32, device=q.device)
    fold = _ring_fold
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        fold = functools.partial(checkpoint, _ring_fold, use_reentrant=False)
    kk, vv = k, v
    for s in range(n):
        mask = None
        if causal:
            k_pos = ((my - s) % n)[:, None] * t + ar  # the source's positions
            mask = q_pos[:, :, None] >= k_pos[:, None, :]  # (R, t, t)
            mask = mask.repeat_interleave(b, dim=0)[:, None]  # (R·B, 1, t, t)
        o, l, m = fold((o, l, m), qf, _fold_ranks(kk), _fold_ranks(vv), scale, mask)
        if s < n - 1:
            kk = mesh.ppermute(kk, axis_name)
            vv = mesh.ppermute(vv, axis_name)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype).reshape(q.shape)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """All-to-all sequence parallelism over ``axis_name``.

    Re-shards the rank stacks (R, B, T/n, H, D) -> (R, B, T, H/n, D), runs
    full-sequence ``local_attention`` on every rank's head group in one call
    (the ranks folded into the batch: K4 on gated shapes), and re-shards
    back. Requires H divisible by the axis size. K/V cross in compact form
    when H_kv divides by it too; otherwise they are expanded first. The
    permutations copy: each crossing moves the tensor's bytes once.
    """
    n = mesh.shape[axis_name]
    h = q.shape[3]
    if n == 1:
        return _local_core(q, k, v, causal, sm_scale)
    if h % n:
        raise ValueError(f"ulysses needs heads ({h}) divisible by axis size {n}")
    if k.shape[3] % n:
        k = repeat_kv(_fold_ranks(k), h).reshape(*q.shape[:3], h, k.shape[4])
        v = repeat_kv(_fold_ranks(v), h).reshape(*q.shape[:3], h, v.shape[4])
    # all_to_all(split_axis=2, concat_axis=1): the rank at position j gets
    # head chunk j of every rank of its group, their T_l chunks in axis order
    qg, kg, vg = (mesh.all_to_all(x, axis_name, 2, 1) for x in (q, k, v))
    out = _local_core(qg, kg, vg, causal, sm_scale)
    return mesh.all_to_all(out, axis_name, 1, 2)  # the inverse
