"""Meshes of virtual ranks on one device.

Counterpart of ``akka_allreduce_tpu/parallel/mesh.py``. The JAX package lays
a ``jax.sharding.Mesh`` over real (or virtual CPU) devices; the port's
counterpart is ``n`` virtual ranks on one device: rank ``r`` is row ``r`` of
an ``(n, data)`` stack, and a collective over the mesh is a function of that
stack (``comm.allreduce``). Ranks are numbered row-major over the mesh axes,
as ``jax.make_mesh`` numbers devices: rank ``r`` of a ``rows x cols`` grid
sits at ``(r // cols, r % cols)``.

- ``line_mesh(n)``    — one line of n ranks; allreduce rides the ``line`` axis.
- ``grid_mesh(r, c)`` — the 2D butterfly grid; a round reduces along ``rows``
  then ``cols``.
- ``data_seq_mesh(dp, sp)`` — the (data, seq) mesh of long-context training:
  DP replicas along ``data``, each replica's sequence sharded along ``seq``
  (``train.long_context.LongContextTrainer``).
- ``data_seq_model_mesh(dp, sp, tp)`` — the same with a third, innermost
  ``model`` axis of Megatron-style tensor parallelism.

A tensor whose leading dim has one entry per rank, in rank order, is a
**rank stack**; its **grid form** has the mesh's sizes in front instead
(``RankMesh.grid``). A collective of ``shard_map`` is then a function of the
stack: ``lax.axis_index`` is :meth:`RankMesh.index`, ``lax.ppermute`` a roll
along one grid dim (:meth:`RankMesh.ppermute`), ``lax.psum`` a sum over grid
dims, ranks added in rank order (:meth:`RankMesh.psum`, differentiable: the
backward of the sum is the broadcast of the cotangent summed over the same
ranks, the transpose JAX takes), ``lax.pmax`` a max over them
(:meth:`RankMesh.pmax`), and the tiled ``lax.all_to_all`` a swap of two dims
(:meth:`RankMesh.all_to_all`).

Where the signatures differ from JAX's: the JAX helpers take a device list
and default to every device; a virtual mesh has no device list, so the rank
count is given (``n``) and ``device`` names the one device all ranks share
(the card unless ``"cpu"`` is asked for, see ``_device.resolve_device``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from akka_allreduce_tpu_torch._device import resolve_device

LINE_AXIS = "line"
GRID_AXES = ("rows", "cols")
DATA_SEQ_AXES = ("data", "seq")
DATA_SEQ_MODEL_AXES = ("data", "seq", "model")


@dataclass(frozen=True)
class RankMesh:
    """``prod(sizes)`` virtual ranks on ``device``, over named axes."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, like ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Number of ranks."""
        return math.prod(self.sizes)

    def dim(self, axis: str) -> int:
        """The grid dim of ``axis``."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes {self.axis_names}")
        return self.axis_names.index(axis)

    def index(self, axis: str) -> torch.Tensor:
        """Each rank's position along ``axis`` (``lax.axis_index``): a
        ``(size,)`` int64 tensor on the mesh's device, in rank order."""
        d = self.dim(axis)
        stride = math.prod(self.sizes[d + 1:])
        ranks = torch.arange(self.size, device=self.device)
        return ranks // stride % self.sizes[d]

    def grid(self, x: torch.Tensor) -> torch.Tensor:
        """A rank stack ``(size, ...)`` in grid form ``(*sizes, ...)``."""
        return x.reshape(*self.sizes, *x.shape[1:])

    def ppermute(self, x: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
        """``lax.ppermute`` of a rank stack along ``axis``: the rank at
        position ``i`` sends to ``(i + shift) mod n``."""
        g = torch.roll(self.grid(x), shift, self.dim(axis))
        return g.reshape(x.shape)

    def psum(self, x: torch.Tensor, axes: str | tuple[str, ...]) -> torch.Tensor:
        """``lax.psum`` of a rank stack over ``axes``: every rank gets the
        sum over the ranks that differ from it only along ``axes``, added
        one at a time in rank order, axis by axis. Differentiable."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        g = self.grid(x)
        total = None
        for d in sorted(self.dim(a) for a in axes):
            parts = g.unbind(d)
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            g = total.unsqueeze(d)
        return g.expand(*self.sizes, *x.shape[1:]).reshape(x.shape)

    def pmax(self, x: torch.Tensor, axes: str | tuple[str, ...]) -> torch.Tensor:
        """``lax.pmax`` of a rank stack over ``axes``: every rank gets the
        elementwise max over the ranks that differ from it only along
        ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        g = self.grid(x)
        for d in sorted(self.dim(a) for a in axes):
            g = g.amax(dim=d, keepdim=True)
        return g.expand(*self.sizes, *x.shape[1:]).reshape(x.shape)

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`` of
        a rank stack (``split_dim``/``concat_dim`` count a rank's own dims,
        ``x.shape[1:]``): each rank cuts its ``split_dim`` into n blocks and
        sends block q to the rank at position q along ``axis``, which
        concatenates what it receives along ``concat_dim`` in sender order.
        In grid form that is one swap of two dims, the axis's and the block
        index's; autograd takes it back with the inverse swap."""
        n, a, k = self.shape[axis], self.dim(axis), len(self.sizes)
        local = list(x.shape[1:])
        if local[split_dim] % n:
            raise ValueError(f"dim {split_dim} of {local[split_dim]} does not split "
                             f"into {n} blocks")
        s = k + split_dim
        g = self.grid(x)
        g = g.reshape(*g.shape[:s], n, local[split_dim] // n, *g.shape[s + 1:])
        g = g.transpose(a, s)  # [.., a=q, .., s=p, ..]: block q of sender p
        if concat_dim != split_dim:
            g = g.movedim(s, k + concat_dim)  # the sender index before concat_dim
        out = list(local)
        out[split_dim] //= n
        out[concat_dim] *= n
        return g.reshape(self.size, *out)


def _check_count(n: int) -> int:
    if not isinstance(n, int) or n <= 0:
        raise ValueError(f"need a positive rank count, got {n}")
    return n


def line_mesh(
    n: int, *, device: str | torch.device | None = None, axis: str = LINE_AXIS
) -> RankMesh:
    """A 1D mesh: one line of ``n`` virtual ranks."""
    return RankMesh((axis,), (_check_count(n),), resolve_device(device))


def grid_factors(n: int) -> tuple[int, int]:
    """Split n into the most-square (rows, cols) factorization, rows <= cols."""
    if n <= 0:
        raise ValueError(f"need a positive device count, got {n}")
    best = (1, n)
    for r in range(1, int(math.isqrt(n)) + 1):
        if n % r == 0:
            best = (r, n // r)
    return best


def grid_mesh(
    rows: int | None = None,
    cols: int | None = None,
    *,
    n: int | None = None,
    device: str | torch.device | None = None,
    axes: tuple[str, str] = GRID_AXES,
) -> RankMesh:
    """A 2D butterfly grid of virtual ranks. With no shape given, factors
    ``n`` into the most-square grid (16 ranks -> 4x4, BASELINE config 2's
    16-worker butterfly); with one side given, derives the other from ``n``.
    """
    if rows is not None and cols is not None:
        given_n = rows * cols if n is None else n
    elif n is None:
        raise ValueError("give both rows and cols, or the rank count n")
    else:
        given_n = n
    given_n = _check_count(given_n)
    if rows is None and cols is None:
        rows, cols = grid_factors(given_n)
    elif rows is None or cols is None:
        # honor the given dimension; derive the other from the rank count
        given = rows if rows is not None else cols
        if given_n % given == 0:
            derived = given_n // given
        else:
            raise ValueError(
                f"{given_n} devices do not divide into a grid with one side {given}"
            )
        rows, cols = (given, derived) if rows is not None else (derived, given)
    if rows * cols != given_n:
        raise ValueError(f"grid {rows}x{cols} != {given_n} devices")
    return RankMesh(tuple(axes), (rows, cols), resolve_device(device))


def data_seq_mesh(
    dp: int | None = None,
    sp: int | None = None,
    *,
    n: int | None = None,
    device: str | torch.device | None = None,
    axes: tuple[str, str] = DATA_SEQ_AXES,
) -> RankMesh:
    """A 2D (data, seq) mesh for long-context training: DP replicas along
    ``data``, each replica's sequence sharded along ``seq``. With no shape
    given, factors ``n`` into the most-square grid with ``sp`` the larger
    side (sequence parallelism is the scarcer resource). Same shape logic
    and errors as :func:`grid_mesh`, only the axis roles differ."""
    return grid_mesh(dp, sp, n=n, device=device, axes=axes)


def data_seq_model_mesh(
    dp: int,
    sp: int,
    tp: int,
    *,
    device: str | torch.device | None = None,
    axes: tuple[str, str, str] = DATA_SEQ_MODEL_AXES,
) -> RankMesh:
    """A 3D (data, seq, model) mesh: DP replicas x sequence shards x
    Megatron-style tensor-parallel groups, ``model`` the innermost axis (the
    JAX mesh puts TP's per-layer psums on directly wired neighbours; here it
    makes a TP group's ranks adjacent rows of the rank stack)."""
    for n in (dp, sp, tp):
        _check_count(n)
    return RankMesh(tuple(axes), (dp, sp, tp), resolve_device(device))


# A leaf's sharding, the port's ``PartitionSpec``: a tuple with one entry a
# leading dim of the leaf, each an axis name, a tuple of axis names (sharded
# over their product, the first major) or None; dims past the tuple's end
# are not sharded, so ``()`` is a replicated leaf.
PartitionSpec = tuple


def spec_axes(spec: PartitionSpec) -> tuple[str, ...]:
    """Mesh axis names a spec shards over (flattening tuples)."""
    axes: list[str] = []
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.extend(entry)
        else:
            axes.append(entry)
    return tuple(axes)


def _spec_entries(spec: PartitionSpec, ndim: int) -> list[tuple[str, ...]]:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the leaf's {ndim} dims")
    out = []
    for entry in spec + (None,) * (ndim - len(spec)):
        if entry is None:
            out.append(())
        elif isinstance(entry, (tuple, list)):
            out.append(tuple(entry))
        else:
            out.append((entry,))
    return out


def local_shape(shape: tuple[int, ...], spec: PartitionSpec, mesh: RankMesh) -> tuple[int, ...]:
    """A rank's shape of a leaf of ``shape`` under ``spec``."""
    out = []
    for n, axes in zip(shape, _spec_entries(spec, len(shape))):
        k = math.prod(mesh.shape[a] for a in axes)
        if n % k:
            raise ValueError(f"dim of {n} does not evenly divide over {axes} ({k} shards)")
        out.append(n // k)
    return tuple(out)


def rank_view(p: torch.Tensor, spec: PartitionSpec, mesh: RankMesh) -> torch.Tensor:
    """What every rank sees of the full leaf ``p`` under ``spec``, in grid
    form ``(*mesh.sizes, *local)``: a view (no copy), the whole leaf on the
    axes the spec does not shard over (stride 0 there), its shard on the
    axes it does, as ``shard_map``'s ``in_specs`` deliver it."""
    entries = _spec_entries(spec, p.ndim)
    split, lead, local = [], {}, []
    for n, axes in zip(p.shape, entries):
        k = math.prod(mesh.shape[a] for a in axes)
        if n % k:
            raise ValueError(f"dim of {n} does not evenly divide over {axes} ({k} shards)")
        for a in axes:
            lead[a] = len(split)
            split.append(mesh.shape[a])
        local.append(len(split))
        split.append(n // k)
    t = p.reshape(split)
    perm = []
    for a in mesh.axis_names:
        if a not in lead:
            lead[a] = t.ndim
            t = t.unsqueeze(-1)
        perm.append(lead[a])
    t = t.permute(*perm, *local)
    return t.expand(*mesh.sizes, *t.shape[len(mesh.sizes):])


def rank_unview(g: torch.Tensor, spec: PartitionSpec, mesh: RankMesh) -> torch.Tensor:
    """The full leaf from a grid-form ``(*mesh.sizes or 1, *local)`` stack
    that agrees along every axis ``spec`` does not shard over (a psum's
    result): the first rank's entry there, the shards put back in place."""
    k = len(mesh.sizes)
    local = g.shape[k:]
    entries = _spec_entries(spec, len(local))
    sharded = [a for a in mesh.axis_names if any(a in e for e in entries)]
    t = g[tuple(slice(None) if a in sharded else 0 for a in mesh.axis_names)]
    order, shape = [], []
    for j, (n, axes) in enumerate(zip(local, entries)):
        for a in axes:
            order.append(sharded.index(a))
            shape.append(mesh.shape[a])
        order.append(len(sharded) + j)
        shape.append(n)
    full = [n * math.prod(mesh.shape[a] for a in axes) for n, axes in zip(local, entries)]
    return t.permute(order).reshape(full)
