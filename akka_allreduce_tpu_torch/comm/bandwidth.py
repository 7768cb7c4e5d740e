"""Bus-bandwidth measurement harness for the threshold allreduce.

Counterpart of ``akka_allreduce_tpu/comm/bandwidth.py``. The rules are the
JAX package's: warm up first, time each iteration from a fresh device copy of
the inputs (made outside the timed window), end the window when the device
is done (``torch.cuda.synchronize`` on the card), and report *bus* bandwidth
``2 * (n - 1) / n * bytes / t``, the standard allreduce wire-traffic metric.

Where it differs: the mesh is n virtual ranks on ONE device, so every
"transfer" of the collective is a copy within that device's memory. A
record's bus GB/s is therefore an HBM figure, not an interconnect figure;
records say so with ``path: "virtual_ranks_one_card"`` and carry the card's
``device`` name and ``power_limit`` (``"cpu"`` and null on the CPU, where
the times are the CPU's and no device metric).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from akka_allreduce_tpu_torch.comm.allreduce import (
    _normalize_axes,
    build_threshold_allreduce,
)
from akka_allreduce_tpu_torch.parallel.mesh import RankMesh
from akka_allreduce_tpu_torch.utils.benchmarking import device_fields
from akka_allreduce_tpu_torch.utils.metrics import MetricsLogger, RoundMetrics

PATH = "virtual_ranks_one_card"


def bus_bandwidth_gbps(n_devices: int, nbytes: int, seconds: float) -> float:
    if seconds <= 0 or n_devices <= 0:
        return 0.0
    return 2.0 * (n_devices - 1) / n_devices * nbytes / seconds / 1e9


@dataclasses.dataclass
class BandwidthReport:
    num_floats: int
    n_devices: int
    schedule: str
    iters: int
    mean_s: float
    min_s: float
    median_s: float
    bus_gbps_mean: float
    bus_gbps_best: float
    bus_gbps_median: float  # the robust headline
    compress: str | None = None
    device: str = "cpu"  # the card's name, or "cpu"
    power_limit: str | None = None  # nvidia-smi's, null on the CPU
    path: str = PATH  # every rank on one device: bus GB/s are HBM figures

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_allreduce(
    mesh: RankMesh,
    num_floats: int,
    *,
    axes=None,
    bucket_size: int | None = None,
    schedule: str = "psum",
    iters: int = 10,
    warmup: int = 2,
    logger: MetricsLogger | None = None,
    seed: int = 0,
    compress: str | None = None,
) -> BandwidthReport:
    """Time the threshold allreduce at full participation and report bus GB/s.

    Bus GB/s counts PAYLOAD bytes (fp32) whatever ``compress`` is: a
    compressed run moving the same payload in fewer wire bytes shows up as
    higher payload throughput. Inputs are made from ``seed`` with numpy, as
    in the JAX package, and moved to the device once.
    """
    axis_names = _normalize_axes(mesh, axes)
    n = int(np.prod([mesh.shape[a] for a in axis_names]))
    fn = build_threshold_allreduce(
        mesh,
        axes=axis_names,
        bucket_size=bucket_size,
        schedule=schedule,
        compress=compress,
    )
    dev = mesh.device
    rng = np.random.default_rng(seed)
    master_x = torch.from_numpy(
        rng.standard_normal((n, num_floats), dtype=np.float32)
    ).to(dev)
    master_v = torch.ones((n,), dtype=torch.float32, device=dev)

    def fresh_args():
        return master_x.clone(), master_v.clone()

    for _ in range(warmup):
        fn(*fresh_args())
    _sync(dev)

    nbytes = num_floats * 4
    times = []
    for i in range(iters):
        args = fresh_args()
        _sync(dev)
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        dt = time.perf_counter() - t0
        times.append(dt)
        if logger is not None:
            logger.log_round(
                RoundMetrics(
                    round_num=i,
                    latency_s=dt,
                    data_bytes=nbytes,
                    n_devices=n,
                    contributors=float(n),
                    schedule=schedule,
                    extra={"num_floats": num_floats, "path": PATH},
                )
            )

    mean_s = float(np.mean(times))
    min_s = float(np.min(times))
    median_s = float(np.median(times))
    return BandwidthReport(
        num_floats=num_floats,
        n_devices=n,
        schedule=schedule,
        iters=iters,
        mean_s=mean_s,
        min_s=min_s,
        median_s=median_s,
        bus_gbps_mean=bus_bandwidth_gbps(n, nbytes, mean_s),
        bus_gbps_best=bus_bandwidth_gbps(n, nbytes, min_s),
        bus_gbps_median=bus_bandwidth_gbps(n, nbytes, median_s),
        compress=compress,
        **device_fields(dev),
    )
