"""The models of the port on one device: the Transformer LM and its
decoder, the MLP of config 3, their synthetic data and the carrying-over of
flax weights."""

from akka_allreduce_tpu_torch.models.convert import (
    mlp_state_dict_from_flax,
    transformer_state_dict_from_flax,
)
from akka_allreduce_tpu_torch.models.data import (
    SyntheticClassification,
    SyntheticCopyLM,
    lm_copy_task,
    mnist_like,
)
from akka_allreduce_tpu_torch.models.generate import LMGenerator
from akka_allreduce_tpu_torch.models.mlp import MLP
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
    "MLP",
    "SyntheticClassification",
    "SyntheticCopyLM",
    "TransformerLM",
    "lm_copy_task",
    "mlp_state_dict_from_flax",
    "mnist_like",
    "rope",
    "transformer_state_dict_from_flax",
]
