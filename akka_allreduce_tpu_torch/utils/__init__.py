"""Timing, card-description and per-round metrics helpers, and the replica
checks over virtual ranks."""

from akka_allreduce_tpu_torch.utils.benchmarking import (  # noqa: F401
    SlopeEstimate,
    card_info,
    cuda_event_ms,
    dense_train_flops,
    device_peak_flops,
    median_slope,
    mfu,
    moe_active_params,
    transformer_forward_flops,
    transformer_train_flops,
)
from akka_allreduce_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger,
    RoundMetrics,
)
from akka_allreduce_tpu_torch.utils.verify import (  # noqa: F401
    assert_replica_consistent,
    assert_trainer_replicas,
    record_replicas,
)
