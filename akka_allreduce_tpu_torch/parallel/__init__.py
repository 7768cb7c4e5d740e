"""Mesh helpers: n virtual ranks on one device, named like the JAX package's
``parallel`` axes (a 1D ``line`` mesh, a 2D ``rows`` x ``cols`` grid, the
``data`` x ``seq`` mesh of long-context training and its ``data`` x ``seq``
x ``model`` form with tensor parallelism).

Process groups over several cards (``parallel/multihost.py`` in the JAX
package) wait for a machine with several cards.
"""

from akka_allreduce_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_SEQ_AXES,
    DATA_SEQ_MODEL_AXES,
    GRID_AXES,
    LINE_AXIS,
    PartitionSpec,
    RankMesh,
    data_seq_mesh,
    data_seq_model_mesh,
    grid_factors,
    grid_mesh,
    line_mesh,
    local_shape,
    rank_unview,
    rank_view,
    spec_axes,
)
