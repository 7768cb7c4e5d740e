"""The host engine: the reference's actor roles as transport-agnostic state
machines, the port's own copy of the JAX package's ``control/``.

The reference's ``Master`` / ``LineMaster`` / ``AllreduceWorker`` actors
become plain message handlers: each exposes ``handle(msg) -> list[Envelope]``
and owns no thread. A router delivers envelopes: in-process that is
``LocalRouter``; across processes it is the TCP control plane,
``remote.RemoteTransport`` with ``bootstrap.MasterProcess`` and
``bootstrap.NodeProcess`` (the wire codec in ``wire.py``, membership in
``cluster.py``, ``failure.py`` and ``gossip.py``, peer state transfer in
``statetransfer.py``).

The worker's payloads — scatter chunks, the round buffers' sums and the
assembled output — are tensors on the engine's device, the card unless the
caller asks for the CPU; the masters and every threshold decision stay on
the host.
"""

from akka_allreduce_tpu_torch.control.envelope import (  # noqa: F401
    MASTER,
    Envelope,
    master_addr,
    peer_addr,
)
from akka_allreduce_tpu_torch.control.grid_master import GridMaster, dim_worker_id  # noqa: F401
from akka_allreduce_tpu_torch.control.line_master import LineMaster  # noqa: F401
from akka_allreduce_tpu_torch.control.local import (  # noqa: F401
    LocalAllreduceSystem,
    LocalRouter,
)
from akka_allreduce_tpu_torch.control.node import AllreduceNode  # noqa: F401
from akka_allreduce_tpu_torch.control.worker import AllreduceWorker  # noqa: F401
