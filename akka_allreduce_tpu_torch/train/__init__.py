"""Trainers of the port: the data-parallel trainer over virtual ranks
(``DPTrainer``), its ZeRO-1 form (``Zero1DPTrainer``), the long-context LM
trainer over (data, seq[, model]) virtual ranks (``LongContextTrainer``), the MoE LM trainer on one card
(``MoETrainer``), the helpers the trainers share, checkpoints
(``TrainerCheckpointer``, ``DeltaCheckpointer``, their async forms,
``Snapshot``), elastic re-meshing over the live nodes' ranks
(``ElasticTrainer``, ``ElasticDPTrainer``, ``ElasticLongContextTrainer``,
``ElasticMoETrainer``, ``adaptive_parallel_factor``) and elastic-averaging
training over the TCP cluster (``ElasticClusterNode``). The other sharded
families wait for later slices."""

from akka_allreduce_tpu_torch.train.checkpoint import (  # noqa: F401
    AsyncDeltaCheckpointer,
    AsyncTrainerCheckpointer,
    DeltaCheckpointer,
    Snapshot,
    TrainerCheckpointer,
)
from akka_allreduce_tpu_torch.train.cluster import ElasticClusterNode  # noqa: F401
from akka_allreduce_tpu_torch.train.elastic import (  # noqa: F401
    ElasticDPTrainer,
    ElasticLongContextTrainer,
    ElasticMoETrainer,
    ElasticTrainer,
    adaptive_parallel_factor,
)
from akka_allreduce_tpu_torch.train.long_context import (  # noqa: F401
    LongContextStepMetrics,
    LongContextTrainer,
)
from akka_allreduce_tpu_torch.train.moe import MoEStepMetrics, MoETrainer  # noqa: F401
from akka_allreduce_tpu_torch.train.trainer import (  # noqa: F401
    DPTrainer,
    TrainStepMetrics,
    default_classification_loss,
    ef_fold,
    ef_residual,
    normalize_valid,
)
from akka_allreduce_tpu_torch.train.zero1 import Zero1DPTrainer  # noqa: F401
