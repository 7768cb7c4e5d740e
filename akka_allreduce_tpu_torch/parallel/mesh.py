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
  (``train.long_context.LongContextTrainer``, which takes 1 x 1 for now).

Where the signatures differ from JAX's: the JAX helpers take a device list
and default to every device; a virtual mesh has no device list, so the rank
count is given (``n``) and ``device`` names the one device all ranks share
(the card unless ``"cpu"`` is asked for, see ``_device.resolve_device``).
``data_seq_model_mesh`` arrives with tensor parallelism.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from akka_allreduce_tpu_torch._device import resolve_device

LINE_AXIS = "line"
GRID_AXES = ("rows", "cols")
DATA_SEQ_AXES = ("data", "seq")


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
