"""Trainers of the port: the long-context LM trainer on one card
(``LongContextTrainer``) and the helpers the trainers share.
``DPTrainer`` and the sharded families wait for later slices."""

from akka_allreduce_tpu_torch.train.long_context import (  # noqa: F401
    LongContextStepMetrics,
    LongContextTrainer,
)
from akka_allreduce_tpu_torch.train.trainer import normalize_valid  # noqa: F401
