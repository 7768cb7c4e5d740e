"""Timing and card-description helpers."""

from akka_allreduce_tpu_torch.utils.benchmarking import (  # noqa: F401
    SlopeEstimate,
    card_info,
    cuda_event_ms,
    median_slope,
)
