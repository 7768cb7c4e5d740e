"""Trainers of the port: the data-parallel trainer over virtual ranks
(``DPTrainer``), the long-context LM trainer on one card
(``LongContextTrainer``) and the helpers the trainers share. The sharded
families wait for later slices."""

from akka_allreduce_tpu_torch.train.long_context import (  # noqa: F401
    LongContextStepMetrics,
    LongContextTrainer,
)
from akka_allreduce_tpu_torch.train.trainer import (  # noqa: F401
    DPTrainer,
    TrainStepMetrics,
    default_classification_loss,
    ef_fold,
    ef_residual,
    normalize_valid,
)
