"""Elastic-averaging weight binder (the reference's ``ElasticAverageBinder``),
the port's own copy of the JAX package's ``binder/elastic.py``: per round,
contribute the current weights; on output move the local weights toward the
group's partial average by ``elastic_rate``:

    w <- (1 - a) * w + a * (sum / count)     where count > 0

Elements nobody contributed (count 0 under thresholds) keep their local
weight. The update runs on the device the weights live on.
"""

from __future__ import annotations

from typing import Callable

import torch

from akka_allreduce_tpu_torch import tensor_reduce
from akka_allreduce_tpu_torch.protocol import (
    AllReduceInput,
    AllReduceInputRequest,
    AllReduceOutput,
)


class ElasticAverageBinder:
    def __init__(
        self,
        get_weights: Callable[[], torch.Tensor],
        set_weights: Callable[[torch.Tensor], None],
        elastic_rate: float = 0.5,
    ) -> None:
        if not 0.0 < elastic_rate <= 1.0:
            raise ValueError(f"elastic_rate must be in (0, 1], got {elastic_rate}")
        self.get_weights = get_weights
        self.set_weights = set_weights
        self.elastic_rate = elastic_rate
        self.rounds_applied = 0

    @property
    def data_size(self) -> int:
        return int(self.get_weights().shape[0])

    def data_source(self, req: AllReduceInputRequest) -> AllReduceInput:
        return AllReduceInput(self.get_weights())

    def data_sink(self, out: AllReduceOutput) -> None:
        w = self.get_weights().to(torch.float32).clone()  # fresh writable copy
        tensor_reduce.elastic_update(
            w, out.data.to(w.device), out.count.to(w.device), self.elastic_rate
        )
        self.set_weights(w)
        self.rounds_applied += 1
