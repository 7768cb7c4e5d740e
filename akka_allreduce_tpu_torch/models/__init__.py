"""The models of the port on one device: the Transformer LM and its
decoder, the mixture-of-experts LM, the MLP of config 3, ResNet-50 of
config 4, their data and the carrying-over of flax weights."""

from akka_allreduce_tpu_torch.models.convert import (
    mlp_state_dict_from_flax,
    moe_state_dict_from_flax,
    resnet_state_dict_from_flax,
    transformer_state_dict_from_flax,
)
from akka_allreduce_tpu_torch.models.data import (
    FileDataset,
    SyntheticClassification,
    SyntheticCopyLM,
    imagenet_like,
    lm_copy_task,
    mnist_like,
)
from akka_allreduce_tpu_torch.models.generate import LMGenerator
from akka_allreduce_tpu_torch.models.mlp import MLP
from akka_allreduce_tpu_torch.models.resnet import ResNet, ResNet50, resnet_fwd_flops
from akka_allreduce_tpu_torch.models.transformer import (
    Attention,
    Block,
    KVCache,
    MoEBlock,
    MoETransformerLM,
    RankKVCache,
    TransformerLM,
    ep_param_specs,
    rope,
    tp_param_specs,
)

__all__ = [
    "Attention",
    "Block",
    "FileDataset",
    "KVCache",
    "LMGenerator",
    "MLP",
    "MoEBlock",
    "MoETransformerLM",
    "RankKVCache",
    "ResNet",
    "ResNet50",
    "SyntheticClassification",
    "SyntheticCopyLM",
    "TransformerLM",
    "ep_param_specs",
    "tp_param_specs",
    "imagenet_like",
    "lm_copy_task",
    "mlp_state_dict_from_flax",
    "mnist_like",
    "moe_state_dict_from_flax",
    "resnet_fwd_flops",
    "resnet_state_dict_from_flax",
    "rope",
    "transformer_state_dict_from_flax",
]
