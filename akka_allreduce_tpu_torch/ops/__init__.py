"""Hand-written Hopper kernels for the port's hot data-plane ops.

- :mod:`.local_reduce` — fused single-card threshold reduce: the masked
  average (K1) and the elastic-average step (K2) over K stacked payloads in
  one pass over HBM, with their plain PyTorch versions beside them.
- :mod:`.ring` — the ring allreduce-sum (K3) over n virtual ranks on one
  card, f32 or bf16/int8 hops, with its plain PyTorch version.
- :mod:`.flash_attention` — flash attention (K4), forward and backward,
  f32 or bf16, causal or not, behind one ``torch.autograd.Function``, with
  the plain PyTorch versions; reached through
  :func:`.local_attention.local_attention`, which also holds the dense and
  blockwise paths (helpers in :mod:`.ring_attention`). The two functions
  share their modules' names, so they are imported from the modules.
"""

from akka_allreduce_tpu_torch.ops.local_attention import blockwise_attention
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
from akka_allreduce_tpu_torch.ops.ring_attention import attention_reference

__all__ = [
    "attention_reference",
    "blockwise_attention",
    "elastic_average_step",
    "int8_quantize",
    "masked_average",
    "pack_tiles",
    "ring_kernel_allreduce_sum",
    "unpack_tiles",
]
