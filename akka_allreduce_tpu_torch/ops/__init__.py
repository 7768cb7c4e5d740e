"""Hand-written Hopper kernels for the port's hot data-plane ops.

- :mod:`.local_reduce` — fused single-card threshold reduce: the masked
  average (K1) and the elastic-average step (K2) over K stacked payloads in
  one pass over HBM, with their plain PyTorch versions beside them.

The inter-chip ring (``ops/ring.py`` in the JAX package) and flash attention
arrive with later slices of the port.
"""

from akka_allreduce_tpu_torch.ops.local_reduce import (
    elastic_average_step,
    masked_average,
    pack_tiles,
    unpack_tiles,
)

__all__ = [
    "elastic_average_step",
    "masked_average",
    "pack_tiles",
    "unpack_tiles",
]
