"""Command line of the port: ``python -m akka_allreduce_tpu_torch <command>``.

Commands:

- ``bench-suite [--quick] [--device cpu] [--floats N] [--out FILE]`` — the
  BASELINE configs this slice ports (2 and 4), one JSON record each.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_bench_suite(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        "bench-suite",
        description="run the ported BASELINE configs (2 and 4), one JSON "
        "record each",
    )
    p.add_argument("--out", default=None, help="append records to this JSONL")
    p.add_argument(
        "--quick", action="store_true",
        help="1/8-size payloads at fixed trip counts",
    )
    p.add_argument(
        "--device", default=None,
        help="'cpu' runs the plain PyTorch path; default: the CUDA card",
    )
    p.add_argument(
        "--floats", type=int, default=None,
        help="payload floats of every config (overrides the config sizes)",
    )
    args = p.parse_args(argv)

    from akka_allreduce_tpu_torch.bench_suite import run_suite

    run_suite(quick=args.quick, out=args.out, device=args.device, floats=args.floats)
    return 0


COMMANDS = {"bench-suite": _cmd_bench_suite}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(
            f"usage: python -m akka_allreduce_tpu_torch {{{','.join(COMMANDS)}}} ...",
            file=sys.stderr,
        )
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
