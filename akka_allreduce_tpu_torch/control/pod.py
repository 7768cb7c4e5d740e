"""Grid-coordinate pod bootstrap and pure shard assignment: the port's own
copy of the JAX package's ``control/pod.py`` (RESILIENCE.md "Scale").

Every process learns its index and derives its place in an RxC grid from
it, not from the order its join reached the master:

- :func:`parse_grid` — the ``RxC`` spec (``"2x8"``);
- :func:`resolve_process_index` — an explicit value, else the environment
  (``AKKA_PROCESS_INDEX``, then the common launchers' variables, torchrun's
  ``RANK`` among them), else the rank of an initialized
  ``torch.distributed`` group (where the JAX package asks
  ``jax.process_index()``);
- :func:`grid_coords` / :func:`grid_node_id` — process index <-> (row,
  col) <-> node id, row-major: the node id is the coordinate;
- :func:`shard_assignment` / :func:`coordinate_shard_assignment` — the
  pure functions the ``GridMaster`` re-shards with on every reorganize:
  the same membership view gives the same shards on every rebuild.
"""

from __future__ import annotations

import os

__all__ = [
    "parse_grid",
    "resolve_process_index",
    "grid_coords",
    "grid_node_id",
    "shard_assignment",
    "coordinate_shard_assignment",
]

#: environment variables consulted for the process index, in precedence
#: order — the first one set wins. AKKA_PROCESS_INDEX is ours; the rest
#: are what common pod/task launchers export for exactly this purpose.
PROCESS_INDEX_ENV = (
    "AKKA_PROCESS_INDEX",
    "JAX_PROCESS_INDEX",
    "CLOUD_TPU_TASK_ID",
    "TPU_WORKER_ID",
    "SLURM_PROCID",
    "OMPI_COMM_WORLD_RANK",
    "RANK",
)


def parse_grid(spec: str) -> tuple[int, int]:
    """``"RxC"`` -> (rows, cols); both sides positive integers."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"grid spec must be RxC (e.g. 2x8), got {spec!r}")
    try:
        rows, cols = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"grid spec must be RxC with integer sides, got {spec!r}"
        ) from None
    if rows < 1 or cols < 1:
        raise ValueError(f"grid sides must be >= 1, got {spec!r}")
    return rows, cols


def resolve_process_index(explicit: int | None = None) -> int:
    """This process's pod index: an explicit value wins, then the first
    set entry of :data:`PROCESS_INDEX_ENV`, then the rank of a
    ``torch.distributed`` group that is already up (never initialized from
    here). Raises when nothing answers: a pod bootstrap with an unknowable
    coordinate is a config error, not node id -1."""
    if explicit is not None and explicit >= 0:
        return explicit
    for var in PROCESS_INDEX_ENV:
        val = os.environ.get(var)
        if val is not None and val.strip() != "":
            try:
                idx = int(val)
            except ValueError:
                raise ValueError(
                    f"{var}={val!r} is not an integer process index"
                ) from None
            if idx < 0:
                raise ValueError(f"{var}={idx} must be >= 0")
            return idx
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    raise ValueError(
        "cannot resolve a process index: pass --process-index, set "
        f"one of {PROCESS_INDEX_ENV}, or run under torch.distributed"
    )


def grid_coords(process_index: int, rows: int, cols: int) -> tuple[int, int]:
    """Row-major (row, col) of ``process_index`` in an RxC grid."""
    if not 0 <= process_index < rows * cols:
        raise ValueError(
            f"process index {process_index} outside the {rows}x{cols} grid"
        )
    return process_index // cols, process_index % cols


def grid_node_id(row: int, col: int, cols: int) -> int:
    """The node id OF a coordinate — row-major, so ids enumerate the pod
    the same way process indices do and shard membership follows the
    layout, not join order."""
    return row * cols + col


def shard_assignment(
    nodes, shards: int
) -> list[list[int]]:
    """Contiguous, balanced split of a membership view into up to
    ``shards`` non-empty shards — the dims-1 ``--line-shards`` rule.

    A PURE function of (sorted view, shard count): same view -> identical
    shards, across GridMaster rebuilds and standby takeovers alike. Sizes
    differ by at most one, larger shards first.
    """
    view = sorted(nodes)
    if not view:
        return []
    n_shards = max(1, min(int(shards), len(view)))
    base, extra = divmod(len(view), n_shards)
    out: list[list[int]] = []
    start = 0
    for s in range(n_shards):
        size = base + (1 if s < extra else 0)
        out.append(view[start : start + size])
        start += size
    return out


def coordinate_shard_assignment(
    nodes, rows: int, cols: int, shards: int
) -> list[list[int]]:
    """Shard membership from GRID COORDINATES: the full RxC coordinate
    space is cut into up to ``shards`` fixed, contiguous, row-major
    blocks, and each live node lands in the block its node id (== its
    coordinate) belongs to. Dead members just shrink their block — the
    boundaries never move, so a single expulsion can never shuffle
    workers between shards the way a balanced re-split of the live view
    would. Empty blocks drop out (their members are all gone).

    Pure in (view, grid, shard count), like :func:`shard_assignment`.
    Ids at or past ``rows*cols`` (a non-pod joiner minted past the grid)
    overflow into the LAST block rather than being dropped — membership
    is the master's call, the layout just places it.
    """
    view = sorted(nodes)
    if not view:
        return []
    total = rows * cols
    n_shards = max(1, min(int(shards), total))
    base, extra = divmod(total, n_shards)
    # block s covers coordinate indices [bounds[s], bounds[s+1])
    bounds = [0]
    for s in range(n_shards):
        bounds.append(bounds[-1] + base + (1 if s < extra else 0))
    blocks: list[list[int]] = [[] for _ in range(n_shards)]
    for nid in view:
        s = n_shards - 1
        for i in range(n_shards):
            if nid < bounds[i + 1]:
                s = i
                break
        blocks[s].append(nid)
    return [b for b in blocks if b]
