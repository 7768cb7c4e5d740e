"""Replica checks over virtual ranks.

Counterpart of ``akka_allreduce_tpu/utils/verify.py``. The JAX package
checks at run time that every device holding the same global slice of a
"replicated" array holds the same bytes, where its static varying-axes
check is off (the ring schedules, the overlap syncs). On one card the
ranks share one parameter set, so what can diverge is what a sync hands
each rank: the rows of ``masked_psum``'s ``(n, ...)`` output and the int8
ring's all-gather rows, before every rank takes rank 0's. Here a replica is
such a row.

- :func:`assert_replica_consistent` compares every row of each ``(n, ...)``
  stack with row 0, bit for bit.
- :func:`record_replicas` makes a ``DPTrainer`` keep, from then on, the
  per-rank rows of each sync of its latest step (the trainer's private
  ``_hand_out``, which every such sync already calls);
  :func:`assert_trainer_replicas` checks them.

K1's syncs (the f32 average, fused or per leaf) write one buffer that every
rank reads: they hand out no rows, so they add no pairs to the count.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def assert_replica_consistent(rows: Mapping[str, torch.Tensor], *, name: str = "tree") -> int:
    """Bit-compare every rank's row of each ``(n, ...)`` stack in ``rows``
    with rank 0's. Returns the number of row pairs compared; raises
    ``AssertionError`` naming the stack, the rank and max|diff| on the
    first mismatch."""
    compared = 0
    for leaf, stack in rows.items():
        ref = _bits(stack[0])
        for r in range(1, stack.shape[0]):
            if not torch.equal(ref, _bits(stack[r])):
                diff = float((stack[r].double() - stack[0].double()).abs().max())
                raise AssertionError(
                    f"replica divergence in {name}/{leaf}: rank {r} vs rank 0, "
                    f"max |diff| = {diff}")
            compared += 1
    return compared


def record_replicas(trainer) -> None:
    """From now on, keep the per-rank rows of each sync of the trainer's
    latest step, by name (``grad_sum``, ``grad_count``, or the leaf's name
    under ``overlap``), for :func:`assert_trainer_replicas`."""
    trainer._replica_log = {}


def assert_trainer_replicas(trainer) -> int:
    """Replica check over the rows the trainer's syncs handed out in its
    latest step (:func:`record_replicas` must come before the steps).
    Returns the row pairs compared: more than zero for every bf16 or int8
    sync, fused or per leaf, with or without EF; zero for K1's."""
    log = getattr(trainer, "_replica_log", None)
    if log is None:
        raise ValueError("call record_replicas(trainer) before its steps")
    return assert_replica_consistent(log, name="trainer")
