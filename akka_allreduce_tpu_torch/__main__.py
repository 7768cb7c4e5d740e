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
- ``lm-generate [--vocab N] [--d-model N] [--heads N] [--kv-heads N]
  [--layers N] [--batch N] [--prompt-len N] [--gen N] [--temperature X]
  [--bf16] [--device cpu]`` — KV-cache decoding of a Transformer LM with
  seeded random weights: prints the generated tokens, the ``decode: X
  ms/token`` line (slope between two generation lengths) and one JSON
  record with ``prefill_ms``, the prefill's model TFLOP/s and MFU,
  ``ms_per_token``, ``device`` and ``power_limit``. ``--train-steps``, ``--sp``, ``--tp`` and
  ``--cache-quant`` are not ported yet and are refused.
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


def _cmd_lm_generate(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        "lm-generate",
        description="KV-cache autoregressive decoding (models/generate.py) "
        "with seeded random weights: prefill time and decode ms/token "
        "(slope between two generation lengths)",
    )
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument(
        "--kv-heads", type=int, default=None,
        help="GQA: shrink the KV cache (B, L, H_kv, D) by heads/kv_heads",
    )
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument(
        "--gen", type=int, default=64,
        help="tokens to generate (>= 2: the slope timing needs two lengths)",
    )
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument(
        "--device", default=None,
        help="'cpu' runs the plain PyTorch path; default: the CUDA card",
    )
    # the JAX command's options that need parts not ported yet
    p.add_argument("--train-steps", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--sp", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--tp", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--cache-quant", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, value, default, what in (
        ("--train-steps", args.train_steps, 0, "training waits for the training slice"),
        ("--sp", args.sp, 1, "sequence-sharded decode"),
        ("--tp", args.tp, 1, "tensor-parallel decode"),
        ("--cache-quant", args.cache_quant, None, "the int8 KV cache"),
    ):
        if value != default:
            p.error(f"{flag} is not ported yet ({what})")
    if args.gen < 2:
        p.error("--gen must be >= 2 (the slope timing needs two lengths)")

    import json
    import statistics
    import time

    import torch

    from akka_allreduce_tpu_torch._device import resolve_device
    from akka_allreduce_tpu_torch.models import LMGenerator, SyntheticCopyLM, TransformerLM
    from akka_allreduce_tpu_torch.utils.benchmarking import (
        device_fields,
        device_peak_flops,
        transformer_forward_flops,
    )

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_kv_heads=args.kv_heads, n_layers=args.layers, compute_dtype=dtype,
        seed=0, device=dev,
    )
    # the JAX command's prompt: the copy task's first batch at seed offset
    # 123, from a stream at least as long as the prompt
    seq_len = max(64, args.prompt_len + args.prompt_len % 2)
    x, _ = next(SyntheticCopyLM(seq_len, vocab=args.vocab).batches(
        args.batch, 1, seed_offset=123))
    prompt = torch.from_numpy(x[:, : args.prompt_len]).to(dev)
    gen = LMGenerator(model, max_len=args.prompt_len + args.gen)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    lo = max(1, args.gen // 4)
    gen.generate(prompt, lo, temperature=args.temperature)  # warm-up
    out = gen.generate(prompt, args.gen, temperature=args.temperature)

    def timed(steps: int) -> float:
        sync()
        t0 = time.perf_counter()
        gen.generate(prompt, steps, temperature=args.temperature)
        sync()
        return time.perf_counter() - t0

    # decode throughput: slope between a short and the full generation so
    # prefill and launch overhead cancel
    slopes = [(timed(args.gen) - timed(lo)) / (args.gen - lo) for _ in range(5)]
    ms_per_tok = statistics.median(slopes) * 1e3
    prefill = []
    with torch.no_grad():
        for _ in range(3):
            cache = gen.init_cache(args.batch)
            sync()
            t0 = time.perf_counter()
            model(prompt, cache)
            sync()
            prefill.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(prefill)
    prefill_flops = transformer_forward_flops(
        n_params=sum(p.numel() for p in model.parameters()), batch=args.batch,
        seq=args.prompt_len, d_model=args.d_model, n_layers=args.layers,
    )
    tflops = prefill_flops / prefill_ms / 1e9
    peak = device_peak_flops(dev)

    out_list = out[0].tolist()
    head = prompt[0, :64].tolist()
    more = f" ... ({args.prompt_len} tokens)" if args.prompt_len > 64 else ""
    print(f"prompt : {head}{more}")
    print(f"decoded: {out_list}")
    if ms_per_tok > 1e-3:
        rate = f"{args.batch * 1e3 / ms_per_tok:.0f} tokens/s"
    else:
        rate = "n/a (noise-dominated at this size)"
    kv = args.kv_heads or args.heads
    print(
        f"decode: {ms_per_tok:.2f} ms/token, {rate} "
        f"(batch {args.batch}, cache (B,{gen.max_len},{kv},"
        f"{args.d_model // args.heads}))"
    )
    record = {
        "metric": "lm_generate",
        "prefill_ms": prefill_ms,
        "prefill_tflops_per_s": tflops,
        # model FLOPs over the card's dense bf16 peak (None off the card)
        "prefill_mfu": None if peak is None else tflops * 1e12 / peak,
        "ms_per_token": ms_per_tok,
        "tokens_per_s": args.batch * 1e3 / ms_per_tok if ms_per_tok > 0 else None,
        "batch": args.batch,
        "prompt_len": args.prompt_len,
        "gen": args.gen,
        "vocab": args.vocab,
        "d_model": args.d_model,
        "heads": args.heads,
        "kv_heads": kv,
        "layers": args.layers,
        "compute_dtype": "bfloat16" if args.bf16 else "float32",
        "temperature": args.temperature,
        **device_fields(dev),
    }
    print(json.dumps(record), flush=True)
    return 0


COMMANDS = {
    "bench-suite": _cmd_bench_suite,
    "bench": _cmd_bench,
    "lm-generate": _cmd_lm_generate,
}


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
