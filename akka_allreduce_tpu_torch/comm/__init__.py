"""The threshold allreduce over n virtual ranks on one device.

Counterpart of the JAX package's ``comm``: ``sum = psum(payload * valid)``
and ``count = psum(valid)`` over the ranks of a ``parallel.mesh.RankMesh``,
with the psum, butterfly, ring and Pallas-ring (K3) schedules and bf16 or
int8 wire compression, plus the bus-bandwidth harness. The ranks are the
rows of one ``(n, data)`` stack; the transport between real cards waits for
a machine with several cards.
"""

from akka_allreduce_tpu_torch.comm.allreduce import (  # noqa: F401
    AllreduceResult,
    build_threshold_allreduce,
    masked_psum,
    threshold_allreduce,
)
from akka_allreduce_tpu_torch.comm.bandwidth import (  # noqa: F401
    BandwidthReport,
    bus_bandwidth_gbps,
    measure_allreduce,
)
