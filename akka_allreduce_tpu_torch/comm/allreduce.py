"""Threshold-masked allreduce over n virtual ranks on one device.

Counterpart of ``akka_allreduce_tpu/comm/allreduce.py``, forward path only.
Semantics are the JAX package's: every rank contributes ``(payload, valid)``
where ``valid`` is 1.0 for a live contributor and 0.0 for a straggler whose
data must not count; one round computes ``sum = psum(payload * valid)`` and
``count = psum(valid)``, and consumers divide. The mask may be per bucket
(the ``max_chunk_size`` granularity). Counts always stay float32.

Where the signatures differ from JAX's: the JAX primitives run inside
``shard_map`` on each device's own ``(data,)`` payload and name the mesh
axis they reduce over (``axis_name``); here a mesh is n virtual ranks on one
device (``parallel.mesh.RankMesh``), so every function takes the whole
``(n, data)`` stack, one row per rank in the mesh's row-major rank order,
and returns the per-rank results as a stack. The ring functions reduce over
the rows of their stack and take no axis at all; ``masked_psum`` and
``_staged_masked_psum`` take the mesh and the axes to reduce over, so a
partial axis of a grid works as in ``shard_map``. A ``ppermute`` to rank
``(i + 1) % n`` is a roll of the stack by one row.

Schedules (``build_threshold_allreduce`` / ``threshold_allreduce``):

- ``"psum"``      — one fused sum over all axes, ranks added in rank order
  (as XLA's all-reduce adds its participants); ``compress="bf16"`` casts
  the payload to bf16 and rounds the float32 sum back to bf16, as XLA's bf16
  all-reduce does.
- ``"butterfly"`` — staged per-axis sums on a 2D grid: ``rows`` then ``cols``.
- ``"ring"``      — the explicit reduce-scatter + all-gather ring of the JAX
  package (``ring_allreduce_sum``), plain tensor code: the all-gather
  forwards the quantized pair unchanged, so ranks agree bit for bit.
- ``"pallas_ring"`` — the same schedule through K3, the ring kernel
  (``ops.ring``), in buckets; on the card it runs the hand-written CUDA
  kernel (one launch, a whole-payload mask applied inside it), on the CPU
  its plain version.

:func:`ring_ef_residual` is the int8 trainer's error-feedback residual.

Per-leaf syncs inside the backward (``DPTrainer(overlap=True)``):
:func:`backward_psum_sync`, :func:`backward_sync_ef` and
:func:`backward_ring_sync` each return a ``sync`` that hands one parameter
leaf to the n ranks (its forward broadcasts ``p`` to ``(n, *p.shape)``) and
whose backward takes that leaf's whole ``(n, *p.shape)`` cotangent stack,
masks it, syncs it and returns the synced gradient, so leaf k's sync
depends only on leaf k's part of the backward. Unlike the JAX functions,
which return the masked SUM and leave the division to the trainer, these
return the masked AVERAGE ``sum_r v_r g_r / max(count, 1)``: in f32 that
is K1 (``ops.local_reduce.masked_average``, one launch a leaf on the card),
which divides inside the kernel.

The sharded-tree helpers serve trainers whose parameters shard over a mesh
axis (``LongContextTrainer`` under TP): a tree is a ``{name: tensor}`` dict
in leaf order with one spec a leaf (``parallel.mesh.PartitionSpec``, e.g.
``models.transformer.tp_param_specs``), and a leaf is summed over the mesh
axes its spec does NOT shard over (its "class"). :func:`localize_tree`
hands every rank its own grid-form view of each full leaf as a new leaf,
so that autograd yields one gradient a rank; :func:`grouped_tree_psum` sums
those per class, leaves grouped by (reduce axes, dtype) into one buffer each
in leaf order: an f32 class over every axis is K1 (``masked_average`` with
every rank counted, times the count: the sum), bf16 ``_psum_grid``'s
rounding, int8 the plain ring once per reduce axis in mesh order,
re-quantizing between axes; :func:`backward_tree_sync` does the same per
leaf inside the backward, the mask applied there (K1 once a leaf).
:func:`compressed_value_and_grad` and :func:`overlap_value_and_grad` are
the one-call forms. As in the JAX package they return SUMS (the loss
carries the division); unlike it, the results come back as full-shape
leaves, each shard put back in place.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from akka_allreduce_tpu_torch.ops.local_reduce import masked_average
from akka_allreduce_tpu_torch.ops.ring import (
    _DEF_SEG_ROWS,
    COMPRESS_MODES,
    LANE,
    _quantize,
    ring_kernel_allreduce_sum,
)
from akka_allreduce_tpu_torch.parallel.mesh import (
    PartitionSpec,
    RankMesh,
    rank_unview,
    rank_view,
    spec_axes,
)

Axes = tuple[str, ...]
SCHEDULES = ("psum", "butterfly", "ring", "pallas_ring")


def _normalize_axes(mesh: RankMesh, axes: str | Sequence[str] | None) -> Axes:
    if axes is None:
        names = tuple(mesh.axis_names)
    elif isinstance(axes, str):
        names = (axes,)
    else:
        names = tuple(axes)
    for name in names:
        if name not in mesh.axis_names:
            raise ValueError(f"axis {name!r} not in mesh axes {mesh.axis_names}")
    return names


def _num_buckets(data_size: int, bucket_size: int | None) -> int:
    if bucket_size is None:
        return 1
    if bucket_size <= 0:
        raise ValueError(f"bucket_size must be positive, got {bucket_size}")
    return math.ceil(data_size / bucket_size)


def _rank_mask(mesh: RankMesh, xs: torch.Tensor, valid) -> torch.Tensor:
    """``valid`` as float32 on xs's device: a scalar (every rank alike),
    ``(n,)`` or ``(n, n_buckets)``."""
    if isinstance(valid, torch.Tensor) and valid.device != xs.device:
        raise ValueError(f"valid is on {valid.device}, xs on {xs.device}")
    v = torch.as_tensor(valid, dtype=torch.float32, device=xs.device)
    if v.ndim == 0:
        v = v.expand(mesh.size)
    if v.shape[0] != mesh.size:
        raise ValueError(
            f"valid must have one row per rank ({mesh.size}), got {tuple(v.shape)}"
        )
    return v


def _apply_mask(
    xs: torch.Tensor, v: torch.Tensor, bucket_size: int | None
) -> torch.Tensor:
    """``x * valid`` per rank: a whole-payload ``(n,)`` mask, or a per-bucket
    ``(n, n_buckets)`` one over buckets of ``bucket_size``."""
    mask = v.to(xs.dtype)
    if mask.ndim == 1:
        return xs * mask[:, None]
    if bucket_size is None:
        raise ValueError("per-bucket valid mask requires bucket_size")
    n, data = xs.shape
    n_buckets = _num_buckets(data, bucket_size)
    if mask.shape != (n, n_buckets):
        raise ValueError(
            f"per-bucket mask must have shape ({n_buckets},), got "
            f"{tuple(mask.shape[1:])}"
        )
    xp = F.pad(xs, (0, n_buckets * bucket_size - data))
    xp = xp.reshape(n, n_buckets, bucket_size)
    return (xp * mask[:, :, None]).reshape(n, -1)[:, :data].contiguous()


# A stack in "grid form" has the mesh's shape in front, ``(*mesh.sizes,
# ...)``; a dim of size 1 there holds a value replicated along that axis.


def _grid(t: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    return t.reshape(*mesh.sizes, *t.shape[1:])


def _psum_grid(
    g: torch.Tensor,
    mesh: RankMesh,
    axis_names: Axes,
    wire_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Sum the grid-form ``g`` over ``axis_names``; the reduced dims come back
    as size 1.

    Ranks are added one at a time in rank order, as XLA's all-reduce adds its
    participants. With ``wire_dtype`` each rank's payload is cast to it, the
    sum runs in g's dtype and is rounded to ``wire_dtype`` once, as XLA's
    bf16 all-reduce on the CPU does; the result comes back in g's dtype."""
    dims = sorted(mesh.axis_names.index(a) for a in axis_names)
    cast = wire_dtype is not None and g.dtype != wire_dtype
    total = None
    for idx in itertools.product(*(range(mesh.sizes[d]) for d in dims)):
        at = [slice(None)] * len(mesh.sizes)
        for d, i in zip(dims, idx):
            at[d] = slice(i, i + 1) if g.shape[d] > 1 else slice(0, 1)
        part = g[tuple(at)]
        if cast:
            part = part.to(wire_dtype).to(g.dtype)
        total = part if total is None else total + part
    if cast:
        total = total.to(wire_dtype).to(g.dtype)
    return total


def _per_rank(g: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """A grid-form result as the ``(n, ...)`` per-rank stack."""
    rest = g.shape[len(mesh.sizes):]
    return g.expand(*mesh.sizes, *rest).reshape(mesh.size, *rest).contiguous()


def _rank0(g: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Rank 0's entry of a grid-form result."""
    return g[(0,) * len(mesh.sizes)]


def masked_psum(
    mesh: RankMesh,
    xs: torch.Tensor,
    valid,
    axis_names: str | Axes,
    *,
    bucket_size: int | None = None,
    wire_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused threshold-masked allreduce of the rank stack over ``axis_names``.

    Args:
      mesh: the virtual ranks; ``xs`` has one row per rank, in rank order.
      xs: ``(n, data)`` payloads.
      valid: scalar 0/1 mask (every rank alike), ``(n,)``, or per-bucket
        ``(n, n_buckets)`` when ``bucket_size`` is given.
      axis_names: mesh axis (or axes) to reduce over; a partial axis of a
        grid reduces within each group of ranks that share the other axes.
      wire_dtype: dtype the PAYLOAD sum runs in (e.g. ``torch.bfloat16``).
        The count sum always runs float32: 0/1 sums must stay exact.
    Returns:
      ``(sum, count)`` per rank: ``sum`` ``(n, data)`` in xs's dtype, ``count``
      float32 ``(n,)`` or ``(n, n_buckets)``.
    """
    names = _normalize_axes(mesh, axis_names)
    v = _rank_mask(mesh, xs, valid)
    if bucket_size is not None and v.ndim == 1:
        n_buckets = _num_buckets(xs.shape[1], bucket_size)
        raise ValueError(
            f"per-bucket mask must have shape ({n_buckets},), got ()"
        )
    masked = _apply_mask(xs, v, bucket_size)
    total = _psum_grid(_grid(masked, mesh), mesh, names, wire_dtype)
    count = _psum_grid(_grid(v, mesh), mesh, names)
    return _per_rank(total, mesh), _per_rank(count, mesh)


def expand_counts(
    count: torch.Tensor, data_size: int, bucket_size: int | None
) -> torch.Tensor:
    """Expand a per-bucket count vector to per-element counts of ``data_size``."""
    if count.ndim == 0:
        return count.reshape(1).expand(data_size).contiguous()
    return torch.repeat_interleave(count, bucket_size)[:data_size]


def _staged_grid(
    mesh: RankMesh,
    masked: torch.Tensor,
    v: torch.Tensor,
    axis_names: Axes,
    wire_dtype: torch.dtype | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Butterfly stages over the masked stack: grid-form (sum, count)."""
    total, count = _grid(masked, mesh), _grid(v, mesh)
    for name in axis_names:
        total = _psum_grid(total, mesh, (name,), wire_dtype)
        count = _psum_grid(count, mesh, (name,))
    return total, count


def _staged_masked_psum(
    mesh: RankMesh,
    xs: torch.Tensor,
    valid,
    axis_names: Axes,
    bucket_size: int | None,
    wire_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Butterfly: reduce one grid axis at a time, in ``axis_names`` order
    (dim-0 sink feeds dim-1 source). Numerically the fused sum reassociated;
    ``wire_dtype`` (e.g. bf16) compresses each stage's payload sum, counts
    always stay float32. Per-rank ``(sum, count)`` stacks, as
    :func:`masked_psum`."""
    names = _normalize_axes(mesh, axis_names)
    v = _rank_mask(mesh, xs, valid)
    masked = _apply_mask(xs, v, bucket_size)
    total, count = _staged_grid(mesh, masked, v, names, wire_dtype)
    return _per_rank(total, mesh), _per_rank(count, mesh)


# -- the ring over the rank dimension -------------------------------------------


def _compress_seg(
    seg: torch.Tensor, mode: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ring segments (..., seg) for the wire: (payload, scale), one
    scale per segment (``(..., 1)``). ``bf16``: round the mantissa, scale 1.
    ``int8``: the ``ops.ring.int8_quantize`` formula per segment."""
    if mode == "bf16":
        return seg.to(torch.bfloat16), torch.ones(
            (*seg.shape[:-1], 1), dtype=torch.float32, device=seg.device
        )
    return _quantize(seg, -1)


def _decompress_seg(
    payload: torch.Tensor, scale: torch.Tensor, mode: str
) -> torch.Tensor:
    if mode == "bf16":
        return payload.to(torch.float32)
    return payload.to(torch.float32) * scale


def _compressed_hop(block: torch.Tensor, compress: str | None, *, with_sent=False):
    """One ring hop of ``block`` (n, seg), row r = what rank r sends to rank
    r+1: (optionally compress,) roll by one rank (, decompress).

    ``with_sent=True`` also returns each sender's own reconstruction of what
    its receiver decodes (``block`` itself when uncompressed): ``block -
    sent`` is the quantization error the hop injects."""
    if compress is None:
        recv = torch.roll(block, 1, 0)
        return (recv, block) if with_sent else recv
    payload, scale = _compress_seg(block, compress)
    sent = _decompress_seg(payload, scale, compress)
    payload = torch.roll(payload, 1, 0)
    if compress == "int8":
        scale = torch.roll(scale, 1, 0)
    recv = _decompress_seg(payload, scale, compress)
    return (recv, sent) if with_sent else recv


def _forward_hop(payload, scale, compress: str):
    """One forward-only hop of an already-quantized (payload, scale) pair,
    unchanged (no requantization); bf16 carries no scale to move."""
    payload = torch.roll(payload, 1, 0)
    if compress == "int8":
        scale = torch.roll(scale, 1, 0)
    return payload, scale


def _rs_phase(segs: torch.Tensor, n: int, compress: str | None):
    """The ring reduce-scatter phase over ``segs`` (ranks, n, seg): ``n - 1``
    hops, each sending every rank's current partial of a rotating segment and
    accumulating the neighbour's, with each hop's quantization error recorded
    at the segment it affected. Returns ``(segs, errs)``; after it, rank
    ``i`` owns fully-reduced segment ``(i + 1) mod n``."""
    ranks = torch.arange(n, device=segs.device)
    errs = torch.zeros_like(segs)
    for s in range(n - 1):
        send_i = (ranks - s) % n
        block = segs[ranks, send_i]
        recv, sent = _compressed_hop(block, compress, with_sent=True)
        errs[ranks, send_i] = block - sent
        recv_i = (ranks - s - 1) % n
        segs[ranks, recv_i] = segs[ranks, recv_i] + recv
    return segs, errs


def _ring_segments(xs: torch.Tensor) -> torch.Tensor:
    """(n, data) -> a new (n, n, ceil(data / n)) stack of zero-padded
    segments, rank by rank."""
    n, data = xs.shape
    seg = math.ceil(data / n)
    segs = F.pad(xs, (0, n * seg - data)).reshape(n, n, seg)
    if segs.data_ptr() == xs.data_ptr():
        segs = segs.clone()
    return segs


def ring_allreduce_sum(
    xs: torch.Tensor,
    *,
    compress: str | None = None,
    return_residual: bool = False,
):
    """Explicit ring allreduce over the ranks (rows) of ``xs`` (n, data).

    Reduce-scatter then all-gather, each in ``n - 1`` steps, the payload
    padded to ``n`` equal segments. ``compress`` ("bf16" | "int8")
    quantizes every reduce-scatter hop; the reduced segment is quantized once
    more by its owner and the all-gather forwards that (payload, scale) pair
    unchanged, so every rank's row is bit-identical.

    ``return_residual=True`` also returns each rank's injected quantization
    error ``(n, data)``: its reduce-scatter hop errors plus the owner's final
    requantization error, at the elements they affected; the float32 ring
    result minus the compressed one equals the sum of all ranks' residuals.
    Requires ``compress``.
    """
    n = xs.shape[0]
    if return_residual and compress is None:
        raise ValueError("return_residual needs a compress mode")
    if n == 1:
        return (xs.clone(), torch.zeros_like(xs)) if return_residual else xs.clone()
    if compress not in COMPRESS_MODES:
        raise ValueError(f"unknown compress mode {compress!r}")
    data = xs.shape[1]
    segs = _ring_segments(xs)
    ranks = torch.arange(n, device=xs.device)
    segs, errs = _rs_phase(segs, n, compress)
    # rank i now owns fully-reduced segment (i + 1) mod n
    if compress is not None:
        own_i = (ranks + 1) % n
        own = segs[ranks, own_i]
        payload, scale = _compress_seg(own, compress)
        own_q = _decompress_seg(payload, scale, compress)
        errs[ranks, own_i] = errs[ranks, own_i] + (own - own_q)
        payloads = torch.zeros((n, *segs.shape[1:]), dtype=payload.dtype,
                               device=xs.device)
        payloads[ranks, own_i] = payload
        scales = torch.zeros((n, n, 1), dtype=torch.float32, device=xs.device)
        scales[ranks, own_i] = scale
        for s in range(n - 1):
            send_i = (ranks + 1 - s) % n
            recv_p, recv_s = _forward_hop(
                payloads[ranks, send_i], scales[ranks, send_i], compress
            )
            recv_i = (ranks - s) % n
            payloads[ranks, recv_i] = recv_p
            scales[ranks, recv_i] = recv_s
        segs = _decompress_seg(payloads, scales, compress)
    else:
        for s in range(n - 1):
            send_i = (ranks + 1 - s) % n
            recv = _compressed_hop(segs[ranks, send_i], compress)
            segs[ranks, (ranks - s) % n] = recv
    out = segs.reshape(n, -1)[:, :data]
    if return_residual:
        return out, errs.reshape(n, -1)[:, :data]
    return out


def ring_ef_residual(
    c: torch.Tensor, v: torch.Tensor, hop_err: torch.Tensor
) -> torch.Tensor:
    """Next-step error-feedback residual of a ring sync with per-hop
    accounting: a masked rank's whole folded contribution carries forward
    (``c·(1−v)``), plus every quantization error the rank injected while
    sending or relaying (``hop_err`` from ``ring_allreduce_sum(...,
    return_residual=True)``). ``c`` and ``hop_err`` are ``(n, data)`` rank
    stacks, ``v`` the ``(n,)`` mask."""
    return c * (1.0 - v.to(c.dtype))[:, None] + hop_err.reshape(c.shape)


# -- per-leaf syncs inside the backward ------------------------------------------


def _row0(rows: torch.Tensor) -> torch.Tensor:
    """What every rank takes from a sync's per-rank rows: rank 0's."""
    return rows[0]


class _LeafSync(torch.autograd.Function):
    """Hands a parameter leaf to the n ranks: the forward broadcasts ``p`` to
    ``(n, *p.shape)``; the backward gives ``reduce`` that leaf's whole
    ``(n, *p.shape)`` cotangent stack and returns its result as ``p``'s
    gradient.

    A plain ``expand`` would make autograd sum the ranks' cotangents before
    any mask could be applied (the implicit psum the JAX trainer avoids with
    ``pcast``). ``reduce`` is a closure that holds the mask and, with error
    feedback, the residual view it rewrites in place; a residual saved
    through ``ctx.save_for_backward`` would trip autograd's version check
    once another leaf's backward had written the shared ``(n, P)`` buffer.
    """

    @staticmethod
    def forward(ctx, p, n, reduce):
        ctx.reduce = reduce
        return p.unsqueeze(0).expand(n, *p.shape)

    @staticmethod
    def backward(ctx, ct):
        return ctx.reduce(ct), None, None


def _rows(ct: torch.Tensor) -> torch.Tensor:
    """A cotangent stack as contiguous ``(n, leaf)`` rows: the layout K1
    reads (vmap's backward may hand over a strided or expanded stack)."""
    return ct.reshape(ct.shape[0], -1).contiguous()


def _k1_axes(mesh: RankMesh, names: Axes, wire_dtype) -> bool:
    """Whether a sync is K1's: f32 on the wire, over every rank."""
    return wire_dtype is None and set(names) == set(mesh.axis_names)


def _psum_average(mesh, c, v, names, wire_dtype, hand_out):
    """``masked_psum`` of the ``(n, leaf)`` rows ``c`` under the ``(n,)``
    mask: rank 0's row of the per-rank sums (handed out through
    ``hand_out``) over its count."""
    total, cnt = masked_psum(mesh, c, v, names, wire_dtype=wire_dtype)
    return hand_out(total) / torch.clamp_min(cnt[0], 1.0)


def backward_psum_sync(
    mesh: RankMesh,
    axis_names: str | Axes | None = None,
    wire_dtype: torch.dtype | None = None,
):
    """A leaf's sync with the masked psum in its backward: ``sync(p, v, *,
    hand_out=row 0)`` returns ``p`` broadcast to ``(n, *p.shape)``; the
    backward returns ``sum_r v_r g_r / max(count, 1)`` of the leaf's
    cotangent stack ``g`` as ``p``'s gradient.

    f32 over every rank is K1 (``masked_average``, one launch a leaf on the
    card, every rank reading one shared buffer); ``wire_dtype`` (e.g. bf16)
    or a partial axis set takes ``masked_psum`` (mask, then cast), whose
    per-rank rows go through ``hand_out`` before rank 0's is taken. ``v`` is
    the ``(n,)`` f32 contributor mask.
    """
    names = _normalize_axes(mesh, axis_names)
    n = mesh.size

    def sync(p, v, *, hand_out=_row0):
        def reduce(ct):
            c = _rows(ct)
            if _k1_axes(mesh, names, wire_dtype):
                avg = masked_average(c, v)[0]
            else:
                avg = _psum_average(mesh, c, v, names, wire_dtype, hand_out)
            return avg.view(p.shape)

        return _LeafSync.apply(p, n, reduce)

    return sync


def backward_sync_ef(
    mesh: RankMesh,
    axis_names: str | Axes | None = None,
    wire_dtype: torch.dtype | None = None,
):
    """:func:`backward_psum_sync` with error feedback: ``sync(p, e, v, *,
    hand_out=row 0)``, where ``e`` is the leaf's ``(n, *p.shape)`` residual
    (a view into the trainer's ``(n, P)`` buffer). The backward folds it in,
    ``c = g + e``, syncs ``c`` under the mask and writes the new residual
    into ``e`` in place: ``c - cast(c v)`` (``c - c v`` on a lossless wire),
    so a masked rank's whole ``c`` carries forward. The JAX function hands
    the new residual back as the cotangent of ``e`` instead."""
    names = _normalize_axes(mesh, axis_names)
    n = mesh.size

    def sync(p, e, v, *, hand_out=_row0):
        def reduce(ct):
            c = _rows(ct) + e.reshape(n, -1)
            if _k1_axes(mesh, names, wire_dtype):
                avg = masked_average(c, v)[0]
            else:
                avg = _psum_average(mesh, c, v, names, wire_dtype, hand_out)
            sent = c * v.to(c.dtype)[:, None]
            if wire_dtype is not None and c.dtype != wire_dtype:
                sent = sent.to(wire_dtype).to(c.dtype)
            e.copy_((c - sent).view(e.shape))
            return avg.view(p.shape)

        return _LeafSync.apply(p, n, reduce)

    return sync


def backward_ring_sync(
    mesh: RankMesh, *, compress: str = "int8", error_feedback: bool = False
):
    """A leaf's sync with a compressed ring inside its backward: the leaf's
    masked cotangent rows ride :func:`ring_allreduce_sum` (the plain ring,
    the JAX trainer's XLA ring), whose all-gather rows go through
    ``hand_out`` before rank 0's is divided by the count.

    Without EF: ``sync(p, v, *, hand_out=row 0)``. With EF: ``sync(p, e, v,
    *, hand_out=row 0)``, ``c = g + e`` on the wire and the new residual
    ``ring_ef_residual(c, v, hop errors)`` written into ``e`` in place.
    The ring reduces over every rank, so the mesh must have one axis.
    """
    if compress not in ("bf16", "int8"):
        raise ValueError(f"ring sync needs a compress mode, got {compress!r}")
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"the ring reduces over ONE mesh axis; got axes {mesh.axis_names}")
    n = mesh.size

    def ring_average(c, v, e, hand_out):
        m = c * v.to(c.dtype)[:, None]
        if e is None:
            total = ring_allreduce_sum(m, compress=compress)
        else:
            total, hop_err = ring_allreduce_sum(m, compress=compress, return_residual=True)
            e.copy_(ring_ef_residual(c, v, hop_err).view(e.shape))
        return hand_out(total) / torch.clamp_min(v.sum(), 1.0)

    if not error_feedback:

        def sync(p, v, *, hand_out=_row0):
            def reduce(ct):
                return ring_average(_rows(ct), v, None, hand_out).view(p.shape)

            return _LeafSync.apply(p, n, reduce)

        return sync

    def sync_ef(p, e, v, *, hand_out=_row0):
        def reduce(ct):
            c = _rows(ct) + e.reshape(n, -1)
            return ring_average(c, v, e, hand_out).view(p.shape)

        return _LeafSync.apply(p, n, reduce)

    return sync_ef


# -- the sharded-tree helpers ----------------------------------------------------


def localize_tree(tree: dict[str, torch.Tensor], specs: dict[str, PartitionSpec],
                  mesh: RankMesh) -> dict[str, torch.Tensor]:
    """Every leaf as its grid-form rank view (``rank_view``: the whole leaf
    on the axes its spec does not shard over, its shard on those it does),
    each a new autograd leaf cut from the tensor's history: the gradient of
    a loss with respect to it has one entry a rank, the per-rank gradients
    that :func:`grouped_tree_psum` then sums (the JAX function's ``pcast``
    to varying, which keeps them local)."""
    return {name: rank_view(p.detach(), specs[name], mesh).requires_grad_(True)
            for name, p in tree.items()}


def _wire(wire_dtype):
    """The trainers' ``compress`` vocabulary: "bf16" -> torch.bfloat16,
    "int8" -> the ring; None or a dtype as it is."""
    if wire_dtype == "bf16":
        return torch.bfloat16
    if isinstance(wire_dtype, str) and wire_dtype != "int8":
        raise ValueError(f"unknown wire mode {wire_dtype!r}")
    return wire_dtype


def _ring_axis(g: torch.Tensor, mesh: RankMesh, axis: str, compress: str) -> torch.Tensor:
    """The plain ring (``ring_allreduce_sum``) along one axis of the
    grid-form ``g`` (*mesh.sizes, P), once for each group of ranks that
    differ only along it."""
    rows = g.movedim(mesh.dim(axis), 0)
    shape = rows.shape
    rows = rows.reshape(shape[0], -1, shape[-1])
    out = torch.stack([ring_allreduce_sum(rows[:, j].contiguous(), compress=compress)
                       for j in range(rows.shape[1])], dim=1)
    return out.reshape(shape).movedim(0, mesh.dim(axis))


def _k1_class(mesh: RankMesh, reduce_over: Axes, wire, dtype: torch.dtype) -> bool:
    """Whether a class's sum is K1's: f32 on the wire, over every axis of a
    mesh of several ranks."""
    return (wire is None and dtype == torch.float32 and mesh.size > 1
            and set(reduce_over) == set(mesh.axis_names))


def _class_sum(g: torch.Tensor, mesh: RankMesh, reduce_over: Axes, wire,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Sum the grid-form stack ``g`` (*mesh.sizes, P) over ``reduce_over``
    (under the per-rank mask ``valid``, when given; not with int8): f32 over
    every axis is K1 times the count; bf16 ``_psum_grid``'s rounding; int8
    one ring per axis. The reduced dims come back as size 1 (int8: full,
    every rank equal)."""
    if wire == "int8":
        total = g.float()
        for ax in reduce_over:
            total = _ring_axis(total, mesh, ax, "int8")
        return total.to(g.dtype)
    if _k1_class(mesh, reduce_over, wire, g.dtype):
        v = torch.ones(mesh.size, device=g.device) if valid is None else valid
        avg, count = masked_average(g.reshape(mesh.size, -1).contiguous(), v)
        return (avg * count).reshape(*([1] * len(mesh.sizes)), -1)
    masked = g if valid is None else g * mesh.grid(valid).to(g.dtype)[..., None]
    return _psum_grid(masked, mesh, reduce_over, wire)


def grouped_tree_psum(
    mesh: RankMesh,
    grads: dict[str, torch.Tensor],
    specs: dict[str, PartitionSpec],
    axis_names: str | Axes | None = None,
    wire_dtype=None,
) -> dict[str, torch.Tensor]:
    """Explicit allreduce of a tree of per-rank gradients with sharded
    leaves: ``grads`` maps each leaf name, in leaf order, to its grid-form
    ``(*mesh.sizes, *local)`` stack; the result maps it to the full-shape
    sum.

    Each leaf is summed over the axes of ``axis_names`` (default every
    axis) its spec does not shard over. Leaves are grouped by (reduce axes,
    dtype); a class whose collective sees the whole class, K1's and the int8
    ring's, is concatenated, rank by rank in leaf order, into one
    ``(*mesh.sizes, P_class)`` buffer: one collective a class, never one a
    leaf. Any other class is an elementwise sum, taken leaf by leaf (the
    same values as over one buffer, without copying the class's per-rank
    gradients). ``wire_dtype``: None (f32; a class over every axis goes through
    K1, one launch on the card), ``"bf16"``/``torch.bfloat16`` (each rank's
    payload cast, summed, the sum rounded once, as XLA's bf16 all-reduce on
    the CPU), or ``"int8"`` (the plain ring over each reduce axis in turn,
    its segments cut from the class buffer, re-quantizing between axes). A
    leaf sharded over every axis is already final; so is an f32 class over
    axes of one rank (XLA drops such a psum; bf16 still rounds).
    """
    names = _normalize_axes(mesh, axis_names)
    wire = _wire(wire_dtype)
    groups: dict = {}
    for name, g in grads.items():
        reduce_over = tuple(a for a in names if a not in spec_axes(specs[name]))
        groups.setdefault((reduce_over, g.dtype), []).append(name)
    k = len(mesh.sizes)
    out = {}
    for (reduce_over, dtype), group in groups.items():
        if not reduce_over or (wire is None
                               and math.prod(mesh.shape[a] for a in reduce_over) == 1):
            for name in group:
                out[name] = rank_unview(grads[name], specs[name], mesh)
            continue
        if wire != "int8" and not _k1_class(mesh, reduce_over, wire, dtype):
            # an elementwise sum: leaf by leaf it is the class buffer's, bit
            # for bit, without a copy of the class's per-rank gradients
            for name in group:
                g = grads[name]
                total = _class_sum(g.reshape(*mesh.sizes, -1), mesh, reduce_over, wire)
                out[name] = rank_unview(total.reshape(*total.shape[:k], *g.shape[k:]),
                                        specs[name], mesh)
            continue
        flat = torch.cat([grads[n].reshape(*mesh.sizes, -1) for n in group], dim=k)
        total = _class_sum(flat, mesh, reduce_over, wire)
        start = 0
        for name in group:
            local = grads[name].shape[k:]
            size = math.prod(local)
            piece = total[..., start:start + size].reshape(*total.shape[:k], *local)
            out[name] = rank_unview(piece, specs[name], mesh)
            start += size
    return {name: out[name] for name in grads}


class _TreeLeafSync(torch.autograd.Function):
    """Hands a full leaf to the ranks as its grid-form rank view; the
    backward gives ``reduce`` the leaf's whole per-rank cotangent stack and
    returns its result, a full-shape gradient, as the leaf's."""

    @staticmethod
    def forward(ctx, p, view, reduce):
        ctx.reduce = reduce
        return view(p)

    @staticmethod
    def backward(ctx, ct):
        return ctx.reduce(ct), None, None


def backward_tree_sync(
    specs: dict[str, PartitionSpec],
    mesh: RankMesh,
    axis_names: str | Axes | None = None,
    wire_dtype=None,
):
    """Per-leaf in-backward sync of a sharded tree: returns ``apply(tree,
    v)``, which hands each leaf to the ranks as its rank view through a sync
    whose backward masks the leaf's per-rank cotangent by ``v`` (the
    ``(mesh.size,)`` f32 contributor mask) and sums it over the axes its
    spec does not shard over (K1 once a leaf for an f32 leaf over every
    axis, times the count; bf16 as :func:`grouped_tree_psum`). Leaf k's
    collective then depends only on leaf k's part of the backward.

    The wrapped loss must NOT also multiply by ``v``: the mask would be
    squared. A leaf sharded over every axis would skip the mask, so it is
    refused."""
    names = _normalize_axes(mesh, axis_names)
    wire = _wire(wire_dtype)
    if wire == "int8":
        raise ValueError("backward_tree_sync sums on the wire: int8 needs the ring "
                         "(validate_trainer_compress refuses overlap with int8)")

    def reduce_over(spec) -> Axes:
        axes = tuple(a for a in names if a not in spec_axes(spec))
        if not axes:
            raise ValueError(
                f"leaf spec {spec} shards over every mesh axis: its grad has no "
                "replication axes to sync over, and the in-backward mask would be "
                "skipped — overlap does not support it")
        return axes

    def apply(tree: dict[str, torch.Tensor], v: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        for name, p in tree.items():
            spec = specs[name]
            axes = reduce_over(spec)

            def reduce(ct, spec=spec, axes=axes):
                g = ct.reshape(*mesh.sizes, -1)
                total = _class_sum(g, mesh, axes, wire, valid=v)
                return rank_unview(total.reshape(*total.shape[:len(mesh.sizes)],
                                                 *ct.shape[len(mesh.sizes):]), spec, mesh)

            out[name] = _TreeLeafSync.apply(
                p, lambda t, spec=spec: rank_view(t, spec, mesh), reduce)
        return out

    return apply


def overlap_value_and_grad(
    loss_fn: Callable,
    params: dict[str, torch.Tensor],
    specs: dict[str, PartitionSpec],
    mesh: RankMesh,
    v: torch.Tensor,
    *,
    wire_dtype=None,
):
    """``(value, grads)`` with per-leaf in-backward masked syncs
    (:func:`backward_tree_sync`): ``loss_fn`` takes the tree of rank views
    and returns the per-rank ``(mesh.size,)`` losses, UNMASKED (each leaf's
    sync masks its cotangent by ``v``; a ``v`` in the loss too would square
    the mask); ``grads`` maps each leaf name to its full-shape synced sum.
    The value comes back unmasked; callers fold ``v`` into their metric."""
    sync = backward_tree_sync(specs, mesh, wire_dtype=wire_dtype)
    value = loss_fn(sync(params, v))
    grads = torch.autograd.grad(value.sum(), list(params.values()))
    return value.detach(), dict(zip(params, grads))


def compressed_value_and_grad(
    loss_fn: Callable,
    params: dict[str, torch.Tensor],
    specs: dict[str, PartitionSpec],
    mesh: RankMesh,
    *,
    wire_dtype="bf16",
):
    """``(value, grads)`` with an explicit grouped gradient sum: the one-call
    form of :func:`localize_tree` + :func:`grouped_tree_psum`. ``loss_fn``
    takes the tree of rank views and returns the per-rank ``(mesh.size,)``
    losses; the gradient of their sum gives every rank its own gradient,
    which one collective a class then sums (``wire_dtype`` None, "bf16" or
    "int8"). The value comes back per rank."""
    local = localize_tree(params, specs, mesh)
    value = loss_fn(local)
    per_rank = torch.autograd.grad(value.sum(), list(local.values()))
    grads = grouped_tree_psum(mesh, dict(zip(params, per_rank)), specs, wire_dtype=wire_dtype)
    return value.detach(), grads


def validate_trainer_compress(compress: str | None, *, overlap: bool = False) -> str | None:
    """Shared guard for the sharded-param trainers' ``compress`` knob."""
    if compress not in (None, "bf16", "int8"):
        raise ValueError(f"compress must be None, 'bf16' or 'int8', got {compress!r}")
    if compress == "int8" and overlap:
        raise ValueError(
            "overlap excludes compress='int8' for SHARDED-param trainers: "
            "their leaves reduce over per-sharding-class axis SETS, and "
            "the int8 ring schedule reduces over one axis (DPTrainer's "
            "1-axis mesh composes overlap with int8 via "
            "backward_ring_sync)"
        )
    return compress


def ring_reduce_scatter_sum(
    xs: torch.Tensor,
    *,
    compress: str | None = None,
    return_residual: bool = False,
):
    """Ring reduce-scatter over the ranks (rows) of ``xs`` (n, data): row
    ``i`` of the result is the fully-reduced segment ``i``, shape
    ``(n, ceil(data / n))`` with a zero-padded tail.

    The reduce half of :func:`ring_allreduce_sum` plus one final
    (compressed) hop that moves each reduced segment from its ring owner
    ``(i + 1) mod n`` back to rank ``i``. ``return_residual=True`` also
    returns each rank's full-length ``(n, n * seg)`` injected quantization
    error; requires ``compress``.
    """
    n, data = xs.shape
    seg = math.ceil(data / n)
    if return_residual and compress is None:
        raise ValueError("return_residual needs a compress mode")
    if n == 1:
        out = F.pad(xs, (0, seg * n - data))
        return (out, torch.zeros_like(out)) if return_residual else out
    if compress not in COMPRESS_MODES:
        raise ValueError(f"unknown compress mode {compress!r}")
    segs = _ring_segments(xs)
    ranks = torch.arange(n, device=xs.device)
    segs, errs = _rs_phase(segs, n, compress)
    # rank i owns reduced segment (i + 1) mod n; one more hop hands segment j
    # to rank j
    own_i = (ranks + 1) % n
    own = segs[ranks, own_i]
    out, sent = _compressed_hop(own, compress, with_sent=True)
    if return_residual:
        errs[ranks, own_i] = own - sent
        return out, errs.reshape(n, -1)
    return out


# -- host-facing collective -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AllreduceResult:
    """Mirror of the sink payload (protocol.AllReduceOutput) on the device."""

    sum: torch.Tensor  # (data,) — masked sum across contributors
    count: torch.Tensor  # (data,) — per-element contributor count

    def average(self) -> torch.Tensor:
        return self.sum / torch.clamp_min(self.count, 1.0)


def _to_mesh_order(t: torch.Tensor, mesh: RankMesh, axis_names: Axes):
    """Rows of ``t`` in ``axis_names``-major order -> the mesh's rank order
    (how ``PartitionSpec(axis_names)`` lays a stack over the devices)."""
    if axis_names == mesh.axis_names:
        return t
    sizes = [mesh.shape[a] for a in axis_names]
    perm = [axis_names.index(a) for a in mesh.axis_names]
    rest = t.shape[1:]
    g = t.reshape(*sizes, *rest).permute(*perm, *range(len(sizes), len(sizes) + len(rest)))
    return g.reshape(mesh.size, *rest)


def build_threshold_allreduce(
    mesh: RankMesh,
    *,
    axes: str | Sequence[str] | None = None,
    bucket_size: int | None = None,
    schedule: str = "psum",
    compress: str | None = None,
) -> Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Build a ``(xs, valid) -> (sum, count)`` collective over ``mesh``.

    ``xs`` is the ``(n, data)`` float32 stack on ``mesh.device``, one row per
    rank (in ``axes``-major order, as JAX lays a stack sharded over
    ``axes``); ``valid`` is ``(n,)`` (whole-payload mask) or
    ``(n, n_buckets)`` (per-chunk mask). The outputs are the replicated
    result, taken from rank 0: ``sum`` and ``count`` both ``(data,)``.

    ``compress``: ``"bf16"`` runs the psum/butterfly sums in bfloat16 (or
    bf16 ring hops); ``"int8"`` (ring schedules only) quarters the hop bytes
    with per-segment max-abs scaling. Counts always stay float32.

    The JAX function's ``donate`` has no counterpart: the port never writes
    the caller's stack.
    """
    axis_names = _normalize_axes(mesh, axes)
    if set(axis_names) != set(mesh.axis_names):
        raise ValueError(
            "host-facing allreduce reduces over the full mesh (output is "
            f"replicated); got axes {axis_names} of {mesh.axis_names}. For "
            "partial-axis reduction call masked_psum on the rank stack."
        )
    n_devices = int(np.prod([mesh.shape[a] for a in axis_names]))
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "butterfly" and len(axis_names) < 2:
        raise ValueError("butterfly schedule needs a 2D grid mesh")
    if schedule in ("ring", "pallas_ring") and len(axis_names) != 1:
        raise ValueError("ring schedules reduce over exactly one axis")
    if compress not in COMPRESS_MODES:
        raise ValueError(f"unknown compress mode {compress!r}")
    if compress == "int8" and schedule not in ("ring", "pallas_ring"):
        raise ValueError(
            "int8 compression needs per-hop scales: only the ring schedules "
            "carry them (psum/butterfly sum on the wire)"
        )
    wire = torch.bfloat16 if compress else None

    def collective(xs: torch.Tensor, valid: torch.Tensor):
        data_size = xs.shape[1]
        xs = _to_mesh_order(xs, mesh, axis_names)
        v = _to_mesh_order(_rank_mask(mesh, xs, valid), mesh, axis_names)
        if bucket_size is not None and v.ndim == 1:
            v = v[:, None].expand(n_devices, _num_buckets(data_size, bucket_size))
        if bucket_size is None and v.ndim != 1:
            raise ValueError("per-bucket valid mask requires bucket_size")
        if schedule == "pallas_ring":
            # max_chunk_size doubles as the kernel's staging size: one ring
            # step moves bucket_size / n elements per neighbour
            seg_rows = (
                max(1, bucket_size // (n_devices * LANE))
                if bucket_size is not None
                else _DEF_SEG_ROWS
            )
            if v.ndim == 1:
                # K3 masks each row as it first reads it: no masked copy
                stack, mask = xs.contiguous(), v.contiguous()
            else:
                stack, mask = _apply_mask(xs, v, bucket_size), None
            total = ring_kernel_allreduce_sum(
                stack, seg_rows=seg_rows, compress=compress, valid=mask
            )[0]
            count = _rank0(_psum_grid(_grid(v, mesh), mesh, axis_names), mesh)
        elif schedule == "ring":
            total = ring_allreduce_sum(_apply_mask(xs, v, bucket_size),
                                       compress=compress)[0]
            count = _rank0(_psum_grid(_grid(v, mesh), mesh, axis_names), mesh)
        elif schedule == "butterfly":
            masked = _apply_mask(xs, v, bucket_size)
            t, c = _staged_grid(mesh, masked, v, axis_names, wire)
            total, count = _rank0(t, mesh), _rank0(c, mesh)
        else:
            masked = _apply_mask(xs, v, bucket_size)
            g = _psum_grid(_grid(masked, mesh), mesh, axis_names, wire)
            total = _rank0(g, mesh)
            count = _rank0(_psum_grid(_grid(v, mesh), mesh, axis_names), mesh)
        return total.clone(), expand_counts(count, data_size, bucket_size)

    return collective


def threshold_allreduce(
    mesh: RankMesh,
    xs,
    valid=None,
    *,
    axes: str | Sequence[str] | None = None,
    bucket_size: int | None = None,
    schedule: str = "psum",
    compress: str | None = None,
) -> AllreduceResult:
    """Convenience entry: threshold-masked allreduce of per-rank payloads.

    ``xs``: ``(n_devices, data)``, a numpy array or a tensor (moved to
    ``mesh.device`` as float32; the caller's tensor is never written).
    ``valid``: None (all contribute), ``(n_devices,)``, or
    ``(n_devices, n_buckets)``. ``compress``: None | "bf16" | "int8" — see
    :func:`build_threshold_allreduce`.
    """
    fn = build_threshold_allreduce(
        mesh, axes=axes, bucket_size=bucket_size, schedule=schedule,
        compress=compress,
    )
    n_devices = mesh.size
    xs = torch.as_tensor(xs, dtype=torch.float32, device=mesh.device)
    if xs.ndim != 2 or xs.shape[0] != n_devices:
        raise ValueError(
            f"xs must be (n_devices={n_devices}, data), got {tuple(xs.shape)}"
        )
    if valid is None:
        valid = torch.ones((n_devices,), dtype=torch.float32, device=mesh.device)
    valid = torch.as_tensor(valid, dtype=torch.float32, device=mesh.device)
    total, count = fn(xs.contiguous(), valid)
    return AllreduceResult(sum=total, count=count)
