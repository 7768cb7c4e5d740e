"""The ML integration seam (the reference's ``AllreduceBinder``): the binder
protocol, parameters to and from one flat f32 vector in the JAX trainers'
leaf order (``akka_allreduce_tpu/binder/``), and the host engine's two
binders — gradient sync (``GradSyncBinder``) and elastic averaging of the
weights (``ElasticAverageBinder``)."""

from akka_allreduce_tpu_torch.binder.api import (  # noqa: F401
    AllreduceBinder,
    flat_tensor,
    flatten_params,
    leaf_order,
    load_flat_tensor,
)
from akka_allreduce_tpu_torch.binder.elastic import ElasticAverageBinder  # noqa: F401
from akka_allreduce_tpu_torch.binder.grad_sync import GradSyncBinder  # noqa: F401
