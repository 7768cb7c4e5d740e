"""The Transformer LM family on one device: the model, its decoder, the copy
task's data and the carrying-over of flax weights."""

from akka_allreduce_tpu_torch.models.convert import transformer_state_dict_from_flax
from akka_allreduce_tpu_torch.models.data import SyntheticCopyLM, lm_copy_task
from akka_allreduce_tpu_torch.models.generate import LMGenerator
from akka_allreduce_tpu_torch.models.transformer import (
    Attention,
    Block,
    KVCache,
    TransformerLM,
    rope,
)

__all__ = [
    "Attention",
    "Block",
    "KVCache",
    "LMGenerator",
    "SyntheticCopyLM",
    "TransformerLM",
    "lm_copy_task",
    "rope",
    "transformer_state_dict_from_flax",
]
