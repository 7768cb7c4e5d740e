#!/usr/bin/env python3
"""A CPU reading of the band that ``tests/test_torch_elastic.py`` holds the
port's compressed drop/rejoin cycle to. It runs on the CPU only and is no
part of the port.

``python3 elastic_numerics.py`` runs the test's cycle (2 steps over 8 ranks,
node 3 dropped to 6 ranks, 1 step, node 3 back to 8, 1 step; ``MLP(16,)``,
4 rows a rank, ``mnist_like``) in JAX's ``ElasticDPTrainer`` with
``compress="bf16"``, ``error_feedback=True`` and ``overlap=True`` on the
8-device virtual CPU mesh, and the port's from the same initial weights in
four modes: the same one, an f32 wire, a bf16 wire without the residual, and
a bf16 wire without overlap. For each it prints, at every point of the
cycle, max|port - JAX| of the parameters as a share of max|param| of JAX's,
and the losses' relative distance; then the share by which the last update
moved JAX's parameters.

    JAX_PLATFORMS=cpu python3 elastic_numerics.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

import conftest  # noqa: E402,F401  (the 8-device virtual CPU mesh)
import test_torch_elastic as T  # noqa: E402

MODES = {
    "bf16 + EF + overlap": dict(compress="bf16", error_feedback=True, overlap=True),
    "f32 wire, overlap": dict(overlap=True),
    "bf16 without EF, overlap": dict(compress="bf16", overlap=True),
    "bf16 + EF, no overlap": dict(compress="bf16", error_feedback=True),
}


def main() -> None:
    init, jax_record, _ = T._jax_cycle(compress="bf16", error_feedback=True, overlap=True)
    print(f"band in the test: {T.BF16_EF_BAND:g} of max|param|")
    for name, kw in MODES.items():
        e, now = T._port(init, **kw)
        record = T._cycle(e, now)
        drifts = [T.param_drift(a["params"], b["params"]) for a, b in zip(record, jax_record)]
        losses = [None if b["loss"] is None else abs(a["loss"] - b["loss"]) / abs(b["loss"])
                  for a, b in zip(record, jax_record)]
        print(f"{name}: drift {[f'{d:.3e}' for d in drifts]} max {max(drifts):.3e}; "
              f"loss rel {[None if x is None else f'{x:.2e}' for x in losses]}")
    last = T.param_drift(jax_record[-2]["params"], jax_record[-1]["params"])
    print(f"the last update moves JAX's parameters by {last:.3e} of max|param|")


if __name__ == "__main__":
    main()
