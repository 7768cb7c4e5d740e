"""Attention helpers shared by every attention path of the port.

Counterpart of ``akka_allreduce_tpu/ops/ring_attention.py``, the helpers
only: the finite mask value, the grouped-query K/V expansion, the
online-softmax block fold and the dense oracle. ``ring_attention`` and
``ulysses_attention`` (sequence parallelism over a mesh axis) wait for a
sequence-parallel slice.

Layout, as in the JAX package: ``q`` is (B, Tq, H, D), ``k``/``v`` are
(B, Tk, H, D) (or H_kv heads before :func:`repeat_kv`). Offsets are host
ints: the global positions of the local windows for causal masking.
"""

from __future__ import annotations

import math

import torch

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
    (Tq, Tk_block) visibility, or None for a fully visible block. Masked
    positions contribute exactly zero, including the corner case where a
    whole row has seen nothing yet (m still at the sentinel).
    """
    o, l, m = olm
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kk.float()) * scale
    if mask is not None:
        scores = torch.where(mask[None, None], scores, _MASK_VALUE)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
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
