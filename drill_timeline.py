#!/usr/bin/env python3
"""Where a chaos drill's wall time goes: one drill, each line of its output
stamped with the seconds since the drill started.

``python3 drill_timeline.py <drill> [its flags]`` first prints how long
``import torch`` and the first CUDA context take in a fresh interpreter on
this host (every role of a drill pays them), then runs ``python -m
akka_allreduce_tpu_torch <drill> [its flags]`` and prints every line of its
standard output (``OUT``) and of its standard error, where its roles log
(``ERR``), after the seconds at which it arrived; the drill's exit code
last. Read the master's ``listening``, the nodes' ``joined`` and the fault's
lines against the summary's to see start-up apart from the drill's phases.

    python3 drill_timeline.py chaos-train --family dp --out-dir /tmp/ct
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time

IMPORT_TIMES = """
import time
t = time.perf_counter()
import torch
print(f"import torch {time.perf_counter() - t:.2f} s")
if torch.cuda.is_available():
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    print(f"first CUDA context {time.perf_counter() - t:.2f} s")
"""


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    subprocess.run([sys.executable, "-c", IMPORT_TIMES], check=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "akka_allreduce_tpu_torch", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def pump(stream, tag: str) -> None:
        for line in stream:
            print(f"{time.perf_counter() - t0:7.2f} {tag} {line.rstrip()}", flush=True)

    pumps = [threading.Thread(target=pump, args=(proc.stdout, "OUT")),
             threading.Thread(target=pump, args=(proc.stderr, "ERR"))]
    for t in pumps:
        t.start()
    rc = proc.wait()
    for t in pumps:
        t.join()
    print(f"{time.perf_counter() - t0:7.2f} RC {rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
