"""The binder seam: module parameters to and from one host f32 vector, in
the JAX trainers' leaf order (``akka_allreduce_tpu/binder/api.py``)."""

from akka_allreduce_tpu_torch.binder.api import (  # noqa: F401
    flatten_params,
    leaf_order,
)
