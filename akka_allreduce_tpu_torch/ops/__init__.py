"""Hand-written Hopper kernels for the port's hot data-plane ops.

- :mod:`.local_reduce` — fused single-card threshold reduce: the masked
  average (K1) and the elastic-average step (K2) over K stacked payloads in
  one pass over HBM, with their plain PyTorch versions beside them.
- :mod:`.ring` — the ring allreduce-sum (K3) over n virtual ranks on one
  card, f32 or bf16/int8 hops, with its plain PyTorch version.

Flash attention arrives with the transformer families.
"""

from akka_allreduce_tpu_torch.ops.local_reduce import (
    elastic_average_step,
    masked_average,
    pack_tiles,
    unpack_tiles,
)
from akka_allreduce_tpu_torch.ops.ring import (
    int8_quantize,
    ring_kernel_allreduce_sum,
)

__all__ = [
    "elastic_average_step",
    "int8_quantize",
    "masked_average",
    "pack_tiles",
    "ring_kernel_allreduce_sum",
    "unpack_tiles",
]
