"""Trainers of the port: the data-parallel trainer over virtual ranks
(``DPTrainer``), its ZeRO-1 form (``Zero1DPTrainer``), the long-context LM
trainer on one card (``LongContextTrainer``), the helpers the trainers share,
and checkpoints (``TrainerCheckpointer``, ``DeltaCheckpointer``, their async
forms, ``Snapshot``). The other sharded families wait for later slices."""

from akka_allreduce_tpu_torch.train.checkpoint import (  # noqa: F401
    AsyncDeltaCheckpointer,
    AsyncTrainerCheckpointer,
    DeltaCheckpointer,
    Snapshot,
    TrainerCheckpointer,
)
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
from akka_allreduce_tpu_torch.train.zero1 import Zero1DPTrainer  # noqa: F401
