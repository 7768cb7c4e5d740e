"""Gradient-sync binder, the port's own copy of the JAX package's
``binder/grad_sync.py``: per round, contribute the latest local gradient; on
output apply the partial-average gradient through a caller-supplied applier
(an optimizer step). This is the host-engine form of gradient sync; the
in-step form is ``train.DPTrainer``'s masked average (same semantics). The
average is taken on the engine's device, where the gradients handed in
live."""

from __future__ import annotations

from typing import Callable

import torch

from akka_allreduce_tpu_torch.protocol import (
    AllReduceInput,
    AllReduceInputRequest,
    AllReduceOutput,
)


class GradSyncBinder:
    def __init__(
        self,
        get_gradient: Callable[[int], torch.Tensor],
        apply_average: Callable[[torch.Tensor, torch.Tensor], None],
        data_size: int | None = None,
    ) -> None:
        """``get_gradient(round) -> flat grad``; ``apply_average(avg, counts)``
        applies the partial-average gradient (elements with count 0 are zero).
        ``data_size`` sizes the engine's round buffers; when omitted it is
        probed from ``get_gradient(0)``."""
        self.get_gradient = get_gradient
        self.apply_average = apply_average
        self._data_size = data_size
        self.rounds_applied = 0

    @property
    def data_size(self) -> int:
        if self._data_size is None:
            self._data_size = int(self.get_gradient(0).shape[0])
        return self._data_size

    def data_source(self, req: AllReduceInputRequest) -> AllReduceInput:
        return AllReduceInput(self.get_gradient(req.iteration))

    def data_sink(self, out: AllReduceOutput) -> None:
        self.apply_average(out.average(), out.count)
        self.rounds_applied += 1
