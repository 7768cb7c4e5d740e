#!/usr/bin/env python3
"""Host-clock time of ``DPTrainer``'s fused f32 step on the MNIST MLP, to
compare two checkouts' trainers in one call.

Run from the root of the checkout whose ``akka_allreduce_tpu_torch`` is to
be timed, with this script's path: ``python3 <path>/dp_step_timing.py``.
It builds ``MLP(hidden=(2048, 2048))`` (5,824,522 parameters) over
``line_mesh(8)`` on the CUDA card, draws one ``mnist_like`` batch of 16
rows a rank (seed 0), takes 10 warm-up steps, then 7 rounds of 20 steps
(each round ended by a synchronize) and prints one JSON object: the median
and the quartiles of the rounds' ms a step, with the card's name and power
limit. Nothing else runs in the process, so the step is timed alone. It
exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

WARMUP, ROUNDS, STEPS = 10, 7, 20


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_step_timing: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from akka_allreduce_tpu_torch.models import MLP, mnist_like
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer

    mesh = line_mesh(8)
    trainer = DPTrainer(MLP(hidden=(2048, 2048), device=mesh.device), mesh)
    x, y = next(mnist_like().batches(8 * 16, 1))
    for _ in range(WARMUP):
        trainer.train_step(x, y)
    torch.cuda.synchronize()
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_step(x, y)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / STEPS * 1e3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    q1, med, q3 = np.percentile(rounds, [25, 50, 75])
    print(json.dumps({"checkout": os.getcwd(), "ms_per_step_median": med,
                      "ms_per_step_q1": q1, "ms_per_step_q3": q3, "rounds_ms": rounds,
                      "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
