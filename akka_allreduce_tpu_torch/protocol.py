"""Round wire protocol: the port's own copy of the JAX package's
``protocol.py``, message for message.

The reference's actor protocol (``StartAllreduce``, ``ScatterBlock``,
``ReduceBlock``, ``CompleteAllreduce``, ``PrepareAllreduce``,
``ConfirmPreparation``) plus the data source/sink seam
(``AllReduceInputRequest``, ``AllReduceInput``, ``AllReduceOutput``) and the
per-round ``RoundPolicy`` stamp.

Where the JAX messages carry numpy payloads, these carry tensors: ``value``
and ``data`` are float32, ``count`` int32. A tensor keeps its device (the
engine's: the card, or the CPU), so a payload made on the card never leaves
it; numpy (or any array-like) is taken once into a CPU tensor, without a
copy where it can be, and the buffer that stores it moves it onto its own
device. Payload-carrying messages use ``eq=False`` and compare by identity;
pure-control messages compare by value, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from akka_allreduce_tpu_torch import tensor_reduce


def as_tensor(value, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``value`` as a ``dtype`` tensor: a tensor keeps its device (and is
    not copied when it already has the dtype); anything else becomes a CPU
    tensor over the same memory where numpy allows it."""
    if isinstance(value, torch.Tensor):
        return value if value.dtype == dtype else value.to(dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.int32
    arr = np.asarray(value, dtype=np_dtype)
    if not arr.flags.writeable:
        arr = arr.copy()  # torch.from_numpy needs writable memory
    return torch.from_numpy(arr)


@dataclasses.dataclass(frozen=True)
class RoundPolicy:
    """Per-round degradation knobs a leader stamps onto every
    ``PrepareAllreduce``/``StartAllreduce``, so every worker applies the
    same effective threshold and wire precision for a given round id.

    Falsy fields inherit the configured value, so the default policy is a
    no-op.

    - ``th_reduce``: effective scatter-reduce threshold for the round
      (``0.0`` = the configured ``ThresholdConfig.th_reduce``).
    - ``wire``: wire precision of the round's payload frames, ``"f32"``,
      ``"f16"`` or ``"int8"`` (``""`` = the configured
      ``MetaDataConfig.wire_dtype``). Under ``int8`` the sending worker
      feeds each chunk's quantization residual into the next round's chunk
      (error feedback).
    """

    th_reduce: float = 0.0
    wire: str = ""

    #: wire-mode byte values (``0`` = inherit)
    WIRE_MODES = ("", "f32", "f16", "int8")

    def __post_init__(self) -> None:
        if self.th_reduce and not (0.0 < self.th_reduce <= 1.0):
            raise ValueError(
                f"policy th_reduce must be 0 or in (0, 1], got {self.th_reduce}"
            )
        if self.wire not in self.WIRE_MODES:
            raise ValueError(
                f"policy wire must be one of {self.WIRE_MODES}, got {self.wire!r}"
            )

    @property
    def is_default(self) -> bool:
        return not self.th_reduce and not self.wire

    def reduce_count(self, peer_size: int) -> int | None:
        """Effective scatter-reduce trigger, or None to keep the
        configured one."""
        if not self.th_reduce:
            return None
        return max(1, math.ceil(self.th_reduce * peer_size))

    def describe(self) -> str:
        """Compact human/JSONL form (span attributes, drill logs)."""
        return f"{self.wire or 'full'}@{self.th_reduce or 'cfg'}"


#: the inherit-everything policy (one shared frozen instance)
DEFAULT_POLICY = RoundPolicy()


@dataclasses.dataclass(frozen=True)
class StartAllreduce:
    """LineMaster -> worker: begin round ``round_num``.

    ``epoch`` is the issuing master's leadership epoch (``-1`` = unfenced,
    as in-process systems run); ``policy`` is the round's
    :class:`RoundPolicy`, the same on every re-issued Start of the round.
    """

    round_num: int
    epoch: int = -1
    policy: RoundPolicy = DEFAULT_POLICY


@dataclasses.dataclass(frozen=True, eq=False)
class ScatterBlock:
    """Worker -> peer: one chunk of the sender's partition of its input.

    ``value`` is the chunk destined for ``dest_id``'s block, chunk ``chunk_id``.
    """

    value: torch.Tensor
    src_id: int
    dest_id: int
    chunk_id: int
    round_num: int

    def __post_init__(self) -> None:
        object.__setattr__(self, "value", as_tensor(self.value))


@dataclasses.dataclass(frozen=True, eq=False)
class ReduceBlock:
    """Worker -> peer: a reduced (summed) chunk plus its contributor count.

    ``count`` is the number of peers whose scatter contribution made it into
    the sum before ``th_reduce`` fired; consumers divide by it.
    """

    value: torch.Tensor
    src_id: int
    dest_id: int
    chunk_id: int
    round_num: int
    count: int

    def __post_init__(self) -> None:
        object.__setattr__(self, "value", as_tensor(self.value))


@dataclasses.dataclass(frozen=True)
class CompleteAllreduce:
    """Worker -> LineMaster: this worker's round output is flushed."""

    src_id: int
    round_num: int


@dataclasses.dataclass(frozen=True)
class PrepareAllreduce:
    """Master/LineMaster -> worker: (re)configuration handshake.

    Sent on membership change (dropout, late joiner): workers rebuild buffers
    for the new peer list and confirm before rounds resume.
    """

    config_id: int
    peer_ids: Sequence[int]
    worker_id: int
    round_num: int
    line_id: int = 0  # where CompleteAllreduce/ConfirmPreparation go
    epoch: int = -1  # issuing master's leadership epoch (-1 = unfenced)
    policy: RoundPolicy = DEFAULT_POLICY  # in force when this was prepared

    def __post_init__(self) -> None:
        object.__setattr__(self, "peer_ids", tuple(self.peer_ids))


@dataclasses.dataclass(frozen=True)
class ConfirmPreparation:
    """Worker -> master: buffers rebuilt for ``config_id``; ready to resume."""

    config_id: int
    worker_id: int


# --- dataSource / dataSink seam ----------------------------------------------


@dataclasses.dataclass(frozen=True)
class AllReduceInputRequest:
    """Engine -> dataSource: pull the payload for ``iteration``."""

    iteration: int


@dataclasses.dataclass(frozen=True, eq=False)
class AllReduceInput:
    """dataSource -> engine: the flat float payload for one round.

    A source that hands over a tensor already on the engine's device costs
    no copy; one that hands over numpy costs a host-to-device copy a round.
    """

    data: torch.Tensor

    def __post_init__(self) -> None:
        object.__setattr__(self, "data", as_tensor(self.data))


@dataclasses.dataclass(frozen=True, eq=False)
class AllReduceOutput:
    """Engine -> dataSink: reduced sums plus per-element contributor counts,
    both on the engine's device.

    The consumer divides ``data`` by ``count`` (elementwise, guarding zeros)
    to obtain the partial average.
    """

    data: torch.Tensor
    count: torch.Tensor
    iteration: int

    def __post_init__(self) -> None:
        object.__setattr__(self, "data", as_tensor(self.data))
        object.__setattr__(self, "count", as_tensor(self.count, torch.int32))

    def average(self) -> torch.Tensor:
        """Sum / count with zero-contribution elements left at 0, on the
        output's device."""
        return tensor_reduce.average(self.data, self.count)
