"""Mixture-of-experts dispatch: Switch top-1 and GShard top-2 routing with
a static expert capacity, on one device or over virtual ranks.

Counterpart of ``akka_allreduce_tpu/ops/moe.py``.

- Routing keeps a fixed capacity per expert, ``C = max(1, ceil(int(T · cf)
  · k / E))``; assignments past it are dropped (their token's residual
  passes through untouched). Expert queue slots go rank-major: every
  token's primary choice takes its slot before any secondary choice, so
  under pressure secondary assignments drop first.
- :func:`route_indices` is the one source of routing truth; the dense
  one-hot form (:func:`topk_route`, the small-shape oracle, the "einsum"
  dispatch) and the scatter/gather form (the "scatter" dispatch) both
  consume it. Every routing function takes leading batch dims, one routing
  decision per leading index (a virtual rank's own tokens).
- The scatter, the gather and the batched expert products are PyTorch ops
  (``index_add``, ``index_select``, ``torch.bmm``), as the JAX package
  computes them with XLA outside any Pallas kernel. PyTorch's index ops
  neither drop nor clip, so a dropped assignment is sent to a spare row past
  the last slot, which is sliced off; the gather's indices are in range by
  construction (the slot is clamped, its weight 0 when dropped).
- Ties between experts go to the lower index, as ``lax.top_k`` breaks them
  (a stable descending sort).
- Over a mesh of virtual ranks (``mesh`` given; ``parallel.mesh.RankMesh``)
  each rank routes its own tokens over every expert with its capacity from
  its own token count. With ``expert_axis`` the experts are sharded over
  that axis and the JAX package's tiled ``all_to_all`` pair becomes
  ``RankMesh.all_to_all`` of the rank stack (rank p's block q goes to rank
  q's slot p), every rank's experts run as one ``bmm`` over (ranks x
  E / ep); with ``seq_axis`` the load-balancing statistics are psummed over
  the sequence shards, so the aux loss is that of the whole sequence.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

DISPATCH_IMPLS = ("auto", "einsum", "scatter")
# "auto" takes the scatter once the one-hot (T, E, C) tensor would pass this
AUTO_SCATTER_ELEMENTS = 1 << 22


class RouteResult(NamedTuple):
    dispatch: torch.Tensor  # (T, E, C) one-hot token -> slot assignment
    combine: torch.Tensor  # (T, E, C) dispatch scaled by the router gate
    aux_loss: torch.Tensor  # scalar Switch load-balancing loss
    dropped: torch.Tensor  # dropped (token, choice) assignments / (k * T)


class RouteIndices(NamedTuple):
    """Index-form routing decision: O(T·k), never the (T, E, C) tensor."""

    idx: torch.Tensor  # (T, k) int64 chosen expert per rank
    slot: torch.Tensor  # (T, k) int64 queue position in the expert (clamped)
    keep: torch.Tensor  # (T, k) f32 1.0 iff the assignment fit in capacity
    gates: torch.Tensor  # (T, k) f32 router gate per assignment
    aux_loss: torch.Tensor  # scalar Switch load-balancing loss
    dropped: torch.Tensor  # dropped assignments / (k * T)


def expert_capacity(t: int, n_experts: int, capacity_factor: float, k: int) -> int:
    """Slots per expert for ``t`` tokens: the JAX expression, precedence and
    all, ``max(1, -(-int(t * cf) * k // E))``."""
    return max(1, -(-int(t * capacity_factor) * k // n_experts))


def switch_route(logits: torch.Tensor, capacity: int) -> RouteResult:
    """Top-1 (Switch) routing with static capacity: ``logits`` (T, E)."""
    return topk_route(logits, capacity, k=1)


def route_indices(logits: torch.Tensor, capacity: int, k: int = 1) -> RouteIndices:
    """Top-k routing with static capacity, in index form (k 1 Switch, 2
    GShard), of ``logits`` (..., T, E): one decision a leading index.

    Each token goes to its ``k`` highest-probability experts; under k > 1
    the gates renormalize over the chosen k. Slots are assigned rank-major.
    The aux loss is ``E · sum_e f_e · P_e`` over the primary assignments.
    """
    t, e = logits.shape[-2:]
    if not 1 <= k <= e:
        raise ValueError(f"need 1 <= k <= {e} experts, got {k}")
    lead = logits.shape[:-2]
    probs = torch.softmax(logits.float(), dim=-1)
    # a stable descending sort: ties go to the lower expert, as lax.top_k
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[..., :k], idx[..., :k]
    if k == 1:
        gates = gate_vals  # Switch: the raw router probability
    else:
        gates = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    slots, keeps = [], []
    kept = torch.zeros(lead, dtype=torch.float32, device=logits.device)
    base = torch.zeros((*lead, 1, e), dtype=torch.float32, device=logits.device)
    for r in range(k):
        onehot = F.one_hot(idx[..., r], e).float()  # (..., T, E)
        # position in this rank's queue, after the earlier ranks' fill
        within = (torch.cumsum(onehot, dim=-2) - 1.0) * onehot
        pos_t = (within + base * onehot).sum(dim=-1)  # (..., T)
        keep = (pos_t < capacity).float()
        slots.append(torch.clamp_max(pos_t, capacity - 1).long())
        keeps.append(keep)
        kept = kept + keep.sum(dim=-1)
        base = base + onehot.sum(dim=-2, keepdim=True)
    primary = F.one_hot(idx[..., 0], e).float()
    aux = e * torch.sum(primary.mean(dim=-2) * probs.mean(dim=-2), dim=-1)
    dropped = 1.0 - kept / (k * t)
    return RouteIndices(idx, torch.stack(slots, dim=-1), torch.stack(keeps, dim=-1), gates,
                        aux, dropped)


def _dense_route_from_indices(r: RouteIndices, n_experts: int,
                              capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T, E, C) one-hot dispatch and combine tensors from index form."""
    k = r.idx.shape[-1]
    shape = (*r.idx.shape[:-1], n_experts, capacity)
    dispatch = torch.zeros(shape, device=r.idx.device)
    combine = torch.zeros(shape, device=r.idx.device)
    for rank in range(k):
        d_r = (F.one_hot(r.idx[..., rank], n_experts).float()[..., :, None]
               * F.one_hot(r.slot[..., rank], capacity).float()[..., None, :]
               * r.keep[..., rank, None, None])
        dispatch = dispatch + d_r
        combine = combine + d_r * r.gates[..., rank, None, None]
    return dispatch, combine


def topk_route(logits: torch.Tensor, capacity: int, k: int = 2) -> RouteResult:
    """The dense (T, E, C) one-hot form of :func:`route_indices`: the oracle
    of the scatter path, viable at small T·E·C only."""
    r = route_indices(logits, capacity, k)
    dispatch, combine = _dense_route_from_indices(r, logits.shape[1], capacity)
    return RouteResult(dispatch, combine, r.aux_loss, r.dropped)


def _row_base(lead: tuple[int, ...], rows: int, device) -> torch.Tensor:
    """Each leading index's first row in the flat (prod(lead) · rows, d)
    buffer, shaped to broadcast over (..., T, k)."""
    n = math.prod(lead)
    return (torch.arange(n, device=device) * rows).reshape(*lead, 1, 1)


def dispatch_scatter(x: torch.Tensor, route: RouteIndices, n_experts: int,
                     capacity: int) -> torch.Tensor:
    """Tokens into expert slots by a scatter-add: (..., T, d) -> (..., E, C, d).

    Kept assignments land on unique (expert, slot) rows; dropped ones go to
    a spare row past the last, which is sliced off (the JAX scatter's
    ``mode="drop"``), so their tokens get no gradient from the slots."""
    *lead, t, d = x.shape
    k = route.idx.shape[-1]
    per = n_experts * capacity
    spare = math.prod(lead) * per
    flat = _row_base(tuple(lead), per, x.device) + route.idx * capacity + route.slot
    tgt = torch.where(route.keep > 0, flat, torch.full_like(flat, spare))
    src = x[..., None, :].expand(*lead, t, k, d).reshape(-1, d)
    slots = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
    slots = slots.index_add(0, tgt.reshape(-1), src)
    return slots[:spare].reshape(*lead, n_experts, capacity, d)


def combine_gather(ys: torch.Tensor, route: RouteIndices, capacity: int) -> torch.Tensor:
    """Expert outputs back to their tokens: (..., E, C, d) -> (..., T, d),
    each token mixing its k slots by the router gates. A dropped
    assignment's slot is in range (clamped) and carries weight 0."""
    *lead, e, c, d = ys.shape
    tgt = _row_base(tuple(lead), e * c, ys.device) + route.idx * capacity + route.slot
    g = ys.reshape(-1, d).index_select(0, tgt.reshape(-1)).reshape(*tgt.shape, d)
    w = (route.gates * route.keep).to(ys.dtype)
    return (g * w[..., None]).sum(dim=-2)


def expert_ffn(xs: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """Batched per-expert 2-layer MLP: (E, N, d) -> (E, N, d), gelu (tanh)."""
    h = torch.bmm(xs, w1) + b1[:, None, :]
    return torch.bmm(F.gelu(h, approximate="tanh"), w2)


def moe_dispatch_compute(
    x: torch.Tensor,
    router_w: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    *,
    n_experts: int,
    capacity_factor: float = 1.25,
    expert_axis: str | None = None,
    router_topk: int = 1,
    seq_axis: str | None = None,
    dispatch_impl: str = "auto",
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route ``x`` (T, d) through the expert MLPs; returns (y, aux, dropped).

    On one device (``mesh`` None): ``w1`` (E, d, hidden), ``b1`` (E,
    hidden) and ``w2`` (E, hidden, d) are all experts; they are cast to x's
    dtype, the router's logits ``x.float() @ router_w`` stay f32.
    ``dispatch_impl``: "einsum" moves tokens by (T, E, C) one-hot products,
    "scatter" by scatter-add and gather, "auto" takes the scatter once T·E·C
    passes 2**22; both follow the same :func:`route_indices`.

    Over ``mesh`` every argument is a rank stack: ``x`` (R, T, d), each
    rank's tokens; ``router_w`` (R, d, E); the expert weights (R, E / ep,
    ...) with ``expert_axis`` (each rank's shard of the experts), else (R,
    E, ...); ``y`` is (R, T, d), ``aux`` and ``dropped`` (R,). ``seq_axis``
    makes the aux statistics those of every rank of the axis together.
    """
    if mesh is None and (expert_axis is not None or seq_axis is not None):
        raise ValueError(f"expert_axis={expert_axis!r}, seq_axis={seq_axis!r} need the "
                         "mesh of virtual ranks they name (mesh=)")
    t = x.shape[-2]
    capacity = expert_capacity(t, n_experts, capacity_factor, router_topk)
    if dispatch_impl not in DISPATCH_IMPLS:
        raise ValueError(f"unknown dispatch_impl={dispatch_impl!r}")
    if dispatch_impl == "auto":
        dispatch_impl = (
            "scatter" if t * n_experts * capacity > AUTO_SCATTER_ELEMENTS else "einsum")
    logits = x.float() @ router_w  # (..., T, E): the router is always f32
    route = route_indices(logits, capacity, k=router_topk)
    aux = route.aux_loss
    if seq_axis is not None:
        # the Switch statistics over the whole sequence: every seq rank's
        # counts and router probabilities summed before E · sum f · P
        probs = torch.softmax(logits, dim=-1)
        primary = F.one_hot(route.idx[..., 0], n_experts).float()
        t_global = float(t * mesh.shape[seq_axis])
        f = mesh.psum(primary.sum(dim=-2), seq_axis) / t_global
        p = mesh.psum(probs.sum(dim=-2), seq_axis) / t_global
        aux = n_experts * torch.sum(f * p, dim=-1)
    w1, b1, w2 = (w.to(x.dtype) for w in (w1, b1, w2))
    if dispatch_impl == "scatter":
        slots = dispatch_scatter(x, route, n_experts, capacity)
    else:
        dispatch, combine = _dense_route_from_indices(route, n_experts, capacity)
        slots = torch.einsum("...tec,...td->...ecd", dispatch.to(x.dtype), x)
    if mesh is None:
        ys = expert_ffn(slots, w1, b1, w2)
    elif expert_axis is None:
        r, e, c, d = slots.shape
        ys = expert_ffn(slots.reshape(r * e, c, d), w1.reshape(r * e, *w1.shape[2:]),
                        b1.reshape(r * e, -1), w2.reshape(r * e, *w2.shape[2:])
                        ).reshape(slots.shape)
    else:
        r, e, c, d = slots.shape
        ep = mesh.shape[expert_axis]
        e_local = e // ep
        # each rank gets its experts' slots from every rank of the axis:
        # block p of the result is sender p's
        inbound = mesh.all_to_all(slots, expert_axis, 0, 0)
        inbound = inbound.reshape(r, ep, e_local, c, d).transpose(1, 2)
        out = expert_ffn(inbound.reshape(r * e_local, ep * c, d),
                         w1.reshape(r * e_local, *w1.shape[2:]),
                         b1.reshape(r * e_local, -1), w2.reshape(r * e_local, *w2.shape[2:]))
        out = out.reshape(r, e_local, ep, c, d).transpose(1, 2).reshape(r, e, c, d)
        ys = mesh.all_to_all(out, expert_axis, 0, 0)  # back at the sender
    if dispatch_impl == "scatter":
        y = combine_gather(ys, route, capacity)
    else:
        y = torch.einsum("...tec,...ecd->...td", combine.to(x.dtype), ys)
    return y, aux, route.dropped
