"""Single-card benchmark: prints ONE JSON line
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., ...}

The port's counterpart of the root ``bench.py`` with one device: K = 8
virtual workers' payloads over a 64M-float buffer are threshold-reduced and
elastic-averaged on the card by the fused kernel (K2), the buffer updated
every iteration. The value is input bytes reduced per second
(``local_threshold_reduce_bw_<N>Mfloat``); per-iteration time is the median
slope between short and long runs, each ended by ``torch.cuda.synchronize``.
The line also carries ``device`` and ``power_limit``.

Usage: ``python -m akka_allreduce_tpu_torch.bench [--device cpu]``; the sizes
follow ``BENCH_FLOATS``, ``BENCH_INNER_LO``, ``BENCH_INNER_HI``,
``BENCH_OUTER`` and ``BENCH_MAX_SPREAD_PCT`` as in the JAX package. More
than one rank needs the transport between cards, which waits for a
machine with several cards, and raises.
"""

from __future__ import annotations

import argparse
import json
import os

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.bench_suite import (
    REFERENCE_GBPS,
    VIRTUAL_WORKERS,
    _world_size,
    device_fields,
    time_elastic_rounds,
)


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser("akka_allreduce_tpu_torch.bench")
    p.add_argument("--device", default=None, help="'cpu' or a CUDA device")
    args = p.parse_args(argv)

    num_floats = int(os.environ.get("BENCH_FLOATS", 64 * 1024 * 1024))
    inner_lo = int(os.environ.get("BENCH_INNER_LO", 5))
    inner_hi = int(os.environ.get("BENCH_INNER_HI", 405))
    outer = int(os.environ.get("BENCH_OUTER", 8))
    max_spread = float(os.environ.get("BENCH_MAX_SPREAD_PCT", 15.0))
    mfloat = num_floats // (1024 * 1024)
    if _world_size() >= 2:
        raise NotImplementedError(
            "multi-rank bus bandwidth arrives with the next slice of the port "
            "that has several cards (comm.allreduce runs virtual ranks on one "
            "card; `python -m akka_allreduce_tpu_torch bench` measures them)"
        )
    dev = resolve_device(args.device)
    est, _ = time_elastic_rounds(
        num_floats, dev, trips_lo=inner_lo, trips_hi=inner_hi, outer=outer
    )
    dt = est.seconds_per_iter
    if dt <= 0:
        metric, value = f"allreduce_bench_UNMEASURABLE_{mfloat}Mfloat", 0.0
    else:
        metric = f"local_threshold_reduce_bw_{mfloat}Mfloat"
        if est.noisy(max_spread):
            metric += "_NOISY"  # loud flag: estimate unstable beyond tolerance
        per_worker = num_floats // VIRTUAL_WORKERS
        value = VIRTUAL_WORKERS * per_worker * 4 / dt / 1e9
    rec = {
        "metric": metric,
        "value": round(value, 3),
        "unit": "GB/s",
        "vs_baseline": round(value / REFERENCE_GBPS, 3),
        "spread_pct": est.spread_pct,
        "n_samples": est.n_samples,
        **device_fields(dev),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
