"""MFU benchmark of the port: slope-timed training chains + a FLOP model.

Counterpart of ``akka_allreduce_tpu/bench_mfu.py``, the ``lm``, ``mlp``,
``resnet`` and ``moe`` workloads. ``lm``: the flagship LM (``--workload lm``
defaults: vocab 256, d_model 2048, 16 heads of D 128, 8 layers, 404M
parameters, seq 2048, batch 8, bf16 compute, f32 parameters and Adam
moments, no remat) trained by
``LongContextTrainer.train_chain`` (batches drawn on the card, one host read
a chain) over a ``data_seq_mesh(--dp, --sp)`` of virtual ranks (1 x 1 by
default; ring attention, the JAX default ``seq_impl``); the record gains
``dp``, ``sp``, ``seq_impl`` and ``virtual_ranks``, and its MFU is the one
card's. A step's time is the difference between a short and a long chain
(constant set-up and synchronisation cancel), with the JAX package's
escalation rule: the long chain grows until the differential signal reaches
about ``SIGNAL_S`` seconds. MFU is the model FLOPs (``transformer_train_flops``:
no remat recompute, causal-halved attention) over the card's dense bf16 peak
(``utils.benchmarking.device_peak_flops``). ``mlp``: the MNIST MLP at
``--hidden`` (default 2048 2048, 5.8M parameters) trained by ``DPTrainer``
over 8 virtual ranks, ``--batch`` rows split across them, lr 0.1, its FLOPs
``dense_train_flops``. ``resnet``: ``ResNet50(classes=1000)`` in bf16
compute (f32 parameters) trained by ``DPTrainer`` over ``line_mesh(8)``, lr
0.1, on ``--image-size`` (64) px images, ``--batch`` (8) rows a step split
across the ranks, the gradient unbucketed (the JAX record's trainer); its
FLOPs ``3 · resnet_fwd_flops``. ``moe``: the Switch/GShard MoE LM at the
same width (``--experts`` 8, ``--topk`` 1, ``--capacity-factor`` 1.25,
``--dispatch auto``, bf16 compute, 2.28B parameters at the defaults) trained
by ``MoETrainer.train_chain`` at lr 1e-3 (``--mu-bf16``: Adam's first moment
in bf16), its FLOPs ``transformer_train_flops`` on the active parameters
(``moe_active_params``), the dropped fraction of a 2-step chain after the
timing in the record.

The record has the JAX record's fields, plus ``device`` and ``power_limit``;
``compile_s`` is the warm-up (the first chains), since nothing is compiled
ahead here. The fsdp workload is not ported yet.
Runs on the card unless ``--device cpu`` (where MFU is None: no peak).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

WORKLOADS = ("fsdp", "lm", "mlp", "moe", "resnet")
SIGNAL_S = 3.0  # seconds of differential signal the slope timing aims at


def _chain_mfu_record(
    name: str,
    timed,
    flops_per_step: float,
    *,
    lo: int = 2,
    hi: int = 10,
    outer: int = 4,
    n_devices: int = 1,
    device=None,
    extra: dict | None = None,
) -> dict:
    """Time ``timed(steps)`` chains at two lengths, return the JSON record.

    The probe takes the median of 3 (hi, lo) pairs; while the differential
    ``rough * (hi - lo)`` stays under two thirds of ``SIGNAL_S``, ``hi``
    grows to ``lo + SIGNAL_S / rough`` (16x when the probe is not positive),
    at most 3 times and 100,000 steps, after which the record is flagged
    ``timing_suspect``.
    """
    import torch

    from akka_allreduce_tpu_torch.utils.benchmarking import (
        device_fields,
        device_peak_flops,
        median_slope,
        mfu,
    )

    t0 = time.perf_counter()
    timed(lo)
    timed(hi)  # warm BOTH lengths before any timing pair
    compile_s = time.perf_counter() - t0
    timing_suspect = False
    for attempt in range(4):  # probe, escalate, re-probe: at most 3 times
        rough = statistics.median(
            (timed(hi) - timed(lo)) / (hi - lo) for _ in range(3)
        )
        if rough > 0 and rough * (hi - lo) >= SIGNAL_S * 2 / 3:
            break  # differential signal reaches the target
        if attempt == 3:
            timing_suspect = True  # escalations exhausted, still noisy
            break
        if rough <= 0:
            new_hi = lo + min((hi - lo) * 16, 100_000)
        else:
            new_hi = lo + min(int(round(SIGNAL_S / rough)), 100_000)
        if new_hi <= hi:
            timing_suspect = True  # capped (100k steps); signal still short
            break
        hi = new_hi
        t1 = time.perf_counter()
        timed(hi)  # warm the rescaled length
        compile_s += time.perf_counter() - t1
    est = median_slope(timed, lo, hi, outer=outer, warmup=False)
    sec = est.seconds_per_iter
    dev = torch.device("cpu") if device is None else torch.device(device)
    u = mfu(flops_per_step, sec, device_peak_flops(dev), n_devices=n_devices)
    metric = f"{name}_mfu"
    if est.noisy():
        metric += "_NOISY"
    rec = {
        "metric": metric,
        "value": round(u, 4) if u is not None else None,
        "unit": "mfu",
        "tflops_per_step": round(flops_per_step / 1e12, 3),
        "tflops_per_s": round(flops_per_step / sec / 1e12, 2),
        "ms_per_step": round(sec * 1e3, 2),
        "spread_pct": est.spread_pct,
        "compile_s": round(compile_s, 1),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        **device_fields(dev),
    }
    if timing_suspect:
        rec["timing_suspect"] = True
    rec.update(extra or {})
    return rec


def run_lm(args) -> dict:
    import torch

    from akka_allreduce_tpu_torch.models.data import SyntheticCopyLM
    from akka_allreduce_tpu_torch.parallel import data_seq_mesh
    from akka_allreduce_tpu_torch.train import LongContextTrainer
    from akka_allreduce_tpu_torch.utils.benchmarking import transformer_train_flops

    heads = args.heads or max(1, args.d_model // 128)
    mesh = data_seq_mesh(args.dp or 1, args.sp or 1, device=args.device)
    trainer = LongContextTrainer(
        mesh,
        vocab=args.vocab,
        d_model=args.d_model,
        n_heads=heads,
        n_kv_heads=args.kv_heads,
        n_layers=args.layers,
        seq_len=args.seq_len,
        compute_dtype=torch.bfloat16,
        remat=bool(args.remat),
        learning_rate=1e-3,
    )
    rows = max(1, args.batch // trainer.dp)
    batch = rows * trainer.dp
    sampler = SyntheticCopyLM(args.seq_len, vocab=args.vocab).device_sampler()

    def timed(steps: int) -> float:
        t0 = time.perf_counter()
        trainer.train_chain(sampler, steps, rows)  # ends in its one host read
        return time.perf_counter() - t0

    flops = transformer_train_flops(
        n_params=trainer.param_count,
        batch=batch,
        seq=args.seq_len,
        d_model=args.d_model,
        n_layers=args.layers,
    )
    # MFU of the one card: the virtual ranks share it
    return _chain_mfu_record(
        "lm",
        timed,
        flops,
        device=trainer.device,
        extra={
            "params_m": round(trainer.param_count / 1e6, 1),
            "d_model": args.d_model,
            "n_layers": args.layers,
            "seq_len": args.seq_len,
            "batch": batch,
            "remat": args.remat,
            "compute_dtype": "bf16",
            "dp": trainer.dp,
            "sp": trainer.sp,
            "seq_impl": trainer.seq_impl,
            "virtual_ranks": trainer.n_devices,
        },
    )


def run_mlp(args) -> dict:
    from akka_allreduce_tpu_torch.bench_suite import VIRTUAL_WORKERS
    from akka_allreduce_tpu_torch.models import MLP, mnist_like
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer
    from akka_allreduce_tpu_torch.utils.benchmarking import dense_train_flops

    hidden = tuple(args.hidden)
    mesh = line_mesh(VIRTUAL_WORKERS, device=args.device)
    trainer = DPTrainer(MLP(hidden=hidden, classes=10, device=mesh.device), mesh,
                        learning_rate=0.1)
    per_rank = max(1, args.batch // trainer.n_devices)
    batch = per_rank * trainer.n_devices
    sampler = mnist_like().device_sampler()

    def timed(steps: int) -> float:
        t0 = time.perf_counter()
        trainer.train_chain(sampler, steps, per_rank)  # ends in its one host read
        return time.perf_counter() - t0

    return _chain_mfu_record(
        "mlp",
        timed,
        dense_train_flops(trainer.param_count, batch),
        device=trainer.device,
        extra={
            "params_m": round(trainer.param_count / 1e6, 3),
            "hidden": list(hidden),
            "batch": batch,
            "virtual_ranks": trainer.n_devices,
        },
    )


def run_resnet(args) -> dict:
    import torch

    from akka_allreduce_tpu_torch.bench_suite import VIRTUAL_WORKERS
    from akka_allreduce_tpu_torch.models import ResNet50, SyntheticClassification, resnet_fwd_flops
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer

    mesh = line_mesh(VIRTUAL_WORKERS, device=args.device)
    model = ResNet50(args.classes, torch.bfloat16, device=mesh.device)
    trainer = DPTrainer(model, mesh, learning_rate=0.1)
    per_rank = max(1, args.batch // trainer.n_devices)
    batch = per_rank * trainer.n_devices
    size = args.image_size
    sampler = SyntheticClassification((size, size, 3), args.classes, seed=0).device_sampler()

    def timed(steps: int) -> float:
        t0 = time.perf_counter()
        trainer.train_chain(sampler, steps, per_rank)  # ends in its one host read
        return time.perf_counter() - t0

    return _chain_mfu_record(
        "resnet",
        timed,
        3.0 * resnet_fwd_flops(model, size, batch),
        device=trainer.device,
        extra={
            "params_m": round(trainer.param_count / 1e6, 1),
            "image_size": size,
            "batch": batch,
            "compute_dtype": "bf16",
            "virtual_ranks": trainer.n_devices,
        },
    )


def run_moe(args) -> dict:
    import torch

    from akka_allreduce_tpu_torch.models import lm_copy_task
    from akka_allreduce_tpu_torch.train import MoETrainer
    from akka_allreduce_tpu_torch.utils.benchmarking import (
        moe_active_params,
        transformer_train_flops,
    )

    heads = args.heads or max(1, args.d_model // 128)
    trainer = MoETrainer(
        vocab=args.vocab,
        d_model=args.d_model,
        n_heads=heads,
        n_layers=args.layers,
        n_experts=args.experts,
        seq_len=args.seq_len,
        router_topk=args.topk,
        capacity_factor=args.capacity_factor,
        learning_rate=1e-3,
        compute_dtype=torch.bfloat16,
        dispatch_impl=args.dispatch,
        mu_dtype=torch.bfloat16 if args.mu_bf16 else None,
        device=args.device,
    )
    rows = max(1, args.batch // trainer.n_devices)
    batch = rows * trainer.n_devices
    sampler = lm_copy_task(args.seq_len, vocab=args.vocab).device_sampler()

    def timed(steps: int) -> float:
        t0 = time.perf_counter()
        trainer.train_chain(sampler, steps, rows)  # ends in its one host read
        return time.perf_counter() - t0

    active = moe_active_params(trainer.model, args.topk, args.experts)
    flops = transformer_train_flops(
        n_params=active,
        batch=batch,
        seq=args.seq_len,
        d_model=args.d_model,
        n_layers=args.layers,
    )
    rec = _chain_mfu_record(
        "moe",
        timed,
        flops,
        n_devices=trainer.n_devices,
        device=trainer.device,
        extra={
            "params_m": round(trainer.param_count / 1e6, 1),
            "active_params_m": round(active / 1e6, 1),
            "dispatch": args.dispatch,
            "experts": args.experts,
            "topk": args.topk,
            "mu_bf16": args.mu_bf16,
            "capacity_factor": args.capacity_factor,
            "d_model": args.d_model,
            "n_layers": args.layers,
            "seq_len": args.seq_len,
            "batch": batch,
            "compute_dtype": "bf16",
        },
    )
    # the capacity trade rides the record: a 2-step chain after the timing
    drop_sample = trainer.train_chain(sampler, 2, rows)
    rec["dropped_frac"] = round(
        float(sum(m.dropped for m in drop_sample) / len(drop_sample)), 4)
    return rec


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        "bench-mfu",
        description="slope-timed MFU of the training workloads on the card "
        "(one JSON line; flagship = lm; lm, mlp, resnet and moe ported so far)",
    )
    p.add_argument("--workload", choices=WORKLOADS, default="lm")
    p.add_argument("--batch", type=int, default=8, help="global batch size")
    p.add_argument("--d-model", type=int, default=2048)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--heads", type=int, default=None, help="default d/128")
    p.add_argument(
        "--kv-heads", type=int, default=None,
        help="grouped-query attention K/V heads",
    )
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--hidden", type=int, nargs="+", default=[2048, 2048],
                   help="mlp only: hidden widths")
    p.add_argument("--image-size", type=int, default=64, help="resnet only")
    p.add_argument("--classes", type=int, default=1000, help="resnet only")
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--sp", type=int, default=None)
    p.add_argument(
        "--remat", nargs="?", const="full", default=False, choices=("full",),
        help="'full' = recompute each block in the backward",
    )
    p.add_argument("--experts", type=int, default=8, help="moe only")
    p.add_argument(
        "--capacity-factor", type=float, default=None,
        help="moe only: expert slot slack (E*C = cf*topk*T). 1.0 removes "
        "the 25%% of expert FFN compute the default spends on empty "
        "slots, at the cost of more dropped assignments (recorded)",
    )
    p.add_argument(
        "--mu-bf16", action="store_true",
        help="moe only: adam first moment in bf16, halving the biggest "
        "traffic stream of the all-expert optimizer update",
    )
    p.add_argument("--topk", type=int, choices=(1, 2), default=1)
    p.add_argument("--dispatch", choices=("auto", "einsum", "scatter"), default="auto")
    p.add_argument(
        "--device", default=None,
        help="'cpu' runs the plain PyTorch path; default: the CUDA card",
    )
    args = p.parse_args(argv)
    if args.workload == "fsdp":
        p.error("--workload fsdp is not ported yet (lm, mlp, resnet and moe only)")
    for flag, value in (("--dp", args.dp), ("--sp", args.sp)):
        if value not in (None, 1) and args.workload != "lm":
            p.error(f"{flag} is the lm workload's mesh; the {args.workload} workload "
                    "takes none (as in the JAX bench, the MoE mesh is every device on "
                    "one data axis: one card)")
    if args.mu_bf16 and args.workload != "moe":
        p.error("--mu-bf16 is the MoE optimizer knob; moe workload only")
    if args.capacity_factor is not None and args.workload != "moe":
        p.error("--capacity-factor is the MoE slot knob; moe workload only")
    if args.capacity_factor is None:
        args.capacity_factor = 1.25  # MoETrainer's default
    run = {"lm": run_lm, "mlp": run_mlp, "resnet": run_resnet, "moe": run_moe}[args.workload]
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
