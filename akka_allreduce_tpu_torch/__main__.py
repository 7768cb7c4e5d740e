"""Command line of the port: ``python -m akka_allreduce_tpu_torch <command>``.

Commands:

- ``bench-suite [--quick] [--device cpu] [--floats N] [--out FILE]`` — the
  BASELINE configs ported so far (2 and 4), one JSON record each.
- ``bench [--floats N] [--iters N] [--schedule psum|butterfly|ring]
  [--bucket N] [--compress bf16|int8] [--devices N] [--mesh line|grid]
  [--device cpu]`` — threshold-allreduce bandwidth over N virtual ranks on
  one device, one JSON line (``BandwidthReport.to_dict()``: bus GB/s, which
  on one card are HBM figures, with ``device``, ``power_limit`` and
  ``path``).
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


def _cmd_bench(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        "bench", description="threshold-allreduce bandwidth over virtual ranks"
    )
    p.add_argument("--floats", type=int, default=64 * 1024 * 1024)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--schedule", choices=("psum", "butterfly", "ring"), default="psum")
    p.add_argument("--bucket", type=int, default=None)
    p.add_argument(
        "--compress",
        choices=("bf16", "int8"),
        default=None,
        help="wire compression: bf16 halves collective bytes "
        "(psum/butterfly/ring), int8 quarters them (ring only)",
    )
    p.add_argument("--devices", type=int, default=8, help="virtual ranks")
    p.add_argument(
        "--mesh", choices=("line", "grid"), default="line",
        help="1D line or 2D butterfly grid",
    )
    p.add_argument(
        "--device", default=None,
        help="'cpu' runs the plain PyTorch path; default: the CUDA card",
    )
    args = p.parse_args(argv)

    import json

    from akka_allreduce_tpu_torch.comm.bandwidth import measure_allreduce
    from akka_allreduce_tpu_torch.parallel import grid_mesh, line_mesh

    if args.mesh == "grid":
        mesh = grid_mesh(n=args.devices, device=args.device)
    else:
        mesh = line_mesh(args.devices, device=args.device)
    r = measure_allreduce(
        mesh,
        args.floats,
        iters=args.iters,
        schedule=args.schedule,
        bucket_size=args.bucket,
        compress=args.compress,
    )
    print(json.dumps(r.to_dict()), flush=True)
    return 0


COMMANDS = {"bench-suite": _cmd_bench_suite, "bench": _cmd_bench}


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
