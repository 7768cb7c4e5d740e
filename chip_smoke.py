#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card; without one (or without the repo beside it) it exits
non-zero and prints no result.

Phases, each printed as it ends:

1. card: name, power limit and count (``nvidia-smi``);
2. build: ``nvcc`` compiles every kernel source of the path, in parallel;
3. kernel vs plain: K1 ``masked_average`` and K2 ``elastic_average_step``
   against their plain versions on the card, at the main path's shapes
   (K = 16 workers x 64M floats with a 12-of-16 threshold mask, and the
   bench's packed K = 8 stacks), plus the zero mask (K2 leaves X
   bit-identical, K1 gives zeros and count 0), ragged widths (17, 1000,
   65537) and K above the register-resident bound (40);
4. main path, with every launch counter set to 0 just before it: threshold
   rounds at K = 16 x 64M (each round's result from ``masked_average``, the
   fold from ``elastic_average_step`` on the packed form), checked against
   the same rounds through the plain versions; then the bench (the
   ``local_threshold_reduce_bw`` metric) and ``bench_suite.run_suite`` for
   configs 2 and 4; the counters are read just after;
5. timings at K = 16 x 64M: each kernel by CUDA events, its plain version,
   the nearest PyTorch library calls, and the HBM bound;
6. one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, ...}`` line.

Kernel and plain version are compared with rtol = atol = 1e-6 (the JAX
package's tolerance); the kernels avoid FMA contraction, so the error is
expected to be exactly 0.
"""

from __future__ import annotations

import json
import math
import sys
import time

SEED = 0
K_WORKERS = 16
DATA = 64 * 1024 * 1024  # floats per worker: BASELINE config 2's buffer
ALPHA = 0.125
ROUNDS = 3
RTOL = ATOL = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SOURCE = "akka_allreduce_tpu_torch/ops/csrc/local_reduce.cu"
REPLACES = {
    "masked_average": "akka_allreduce_tpu/ops/local_reduce.py:79",
    "elastic_average_step": "akka_allreduce_tpu/ops/local_reduce.py:142",
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(label: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": label, "s": round(time.perf_counter() - t0, 3), **fields}),
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; nothing was run", file=sys.stderr)
        return 1

    from akka_allreduce_tpu_torch import bench, bench_suite
    from akka_allreduce_tpu_torch.config import ThresholdConfig
    from akka_allreduce_tpu_torch.ops import _build
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.utils import card_info, cuda_event_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the library yardstick in fp32
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. card --------------------------------------------------------------
    card = card_info(dev)
    phase("card", t_start, name=card["name"], power_limit=card["power_limit"],
          count=card["count"])

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build("local_reduce")
    for path in paths.values():
        ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        print("\n".join(ptxas), file=sys.stderr)
    phase("build", t0, libraries=[str(p.name) for p in paths.values()])

    def threshold_mask(k: int, gen: torch.Generator) -> torch.Tensor:
        """The first reduce_count(k) workers of a seeded arrival order."""
        need = ThresholdConfig(th_reduce=0.75).reduce_count(k)
        order = torch.randperm(k, generator=gen)
        valid = torch.zeros(k)
        valid[order[:need]] = 1.0
        return valid.to(dev)

    def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
        require(got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}")
        require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        require(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                f"{what}: max abs err {err}")
        return err

    def check_pair(x: torch.Tensor, valid: torch.Tensor, what: str) -> tuple[float, float]:
        """K1 and K2 on x (K, data) or packed, each against its plain version;
        returns (K1 error, K2 error). x is left untouched."""
        flat = x.reshape(x.shape[0], -1)
        avg, count = lr.masked_average(flat, valid)
        ref_avg, ref_count = lr.masked_average_reference(flat, valid)
        e1 = compare(avg, ref_avg, f"masked_average {what}")
        require(float(count) == float(ref_count), f"count {what}")
        del avg, ref_avg
        xk = x.clone()
        out = lr.elastic_average_step(xk, valid, ALPHA)
        require(out is xk, "elastic_average_step returns the caller's tensor")
        ref = lr.elastic_average_step_reference(x, valid, ALPHA)
        e2 = compare(xk, ref, f"elastic_average_step {what}")
        return e1, e2

    # -- 3. kernel vs plain -----------------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mask_gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((K_WORKERS, DATA), generator=gen, device=dev)
    valid = threshold_mask(K_WORKERS, mask_gen)
    require(int(valid.sum()) == 12, "12-of-16 threshold mask")
    err = {"masked_average": 0.0, "elastic_average_step": 0.0}

    def note(errs: tuple[float, float]) -> None:
        err["masked_average"] = max(err["masked_average"], errs[0])
        err["elastic_average_step"] = max(err["elastic_average_step"], errs[1])

    note(check_pair(x, valid, f"K={K_WORKERS} x {DATA}"))
    torch.cuda.empty_cache()
    # the bench's packed K = 8 stacks (configs 2 and 4, bench.py)
    for floats in (64 * 1024 * 1024, 25_000_000):
        xb = lr.pack_tiles(torch.randn((8, floats // 8), generator=gen, device=dev))
        note(check_pair(xb, torch.ones(8, device=dev), f"packed {tuple(xb.shape)}"))
        del xb

    zeros = torch.zeros(K_WORKERS, device=dev)
    avg, count = lr.masked_average(x, zeros)
    require(float(count) == 0.0 and not bool(avg.any()), "zero mask: zeros and count 0")
    xz = x.clone()
    lr.elastic_average_step(xz, zeros, ALPHA)
    require(torch.equal(xz.view(torch.int32), x.view(torch.int32)),
            "zero mask: elastic_average_step leaves X bit-identical")
    del xz, avg
    torch.cuda.empty_cache()

    small = []
    for k, data in ((16, 1000), (16, 17), (16, 65537), (3, 1000), (40, 1000), (40, 17)):
        xs = torch.randn((k, data), generator=gen, device=dev)
        small.append(check_pair(xs, threshold_mask(k, mask_gen), f"K={k} x {data}"))
        # a 16-byte-misaligned but contiguous stack takes the scalar path
        buf = torch.randn(k * data + 1, generator=gen, device=dev)
        small.append(check_pair(buf[1:].view(k, data), threshold_mask(k, mask_gen),
                                f"misaligned K={k} x {data}"))
    torch.cuda.synchronize()
    phase("kernel_vs_plain", t0, max_abs_err=err,
          small_max_abs_err=[max(e[0] for e in small), max(e[1] for e in small)],
          tolerance={"rtol": RTOL, "atol": ATOL})

    # -- 4. main path -------------------------------------------------------------
    t0 = time.perf_counter()
    x0 = x.clone()
    round_gen = torch.Generator().manual_seed(SEED + 1)
    masks = [threshold_mask(K_WORKERS, round_gen) for _ in range(ROUNDS)]
    for key in lr.LAUNCHES:
        lr.LAUNCHES[key] = 0
    xt = lr.pack_tiles(x)  # DATA is a whole number of tiles: a view of x
    results = []
    for v in masks:
        results.append(lr.masked_average(x, v))  # the round's output
        lr.elastic_average_step(xt, v, ALPHA)  # folded into every replica
    per_round = {key: n / ROUNDS for key, n in lr.LAUNCHES.items()}
    bench_rec = bench.main([])
    records = bench_suite.run_suite(quick=False, device=dev)
    torch.cuda.synchronize()
    launches = dict(lr.LAUNCHES)
    require(all(n > 0 for n in launches.values()), f"every kernel launched: {launches}")

    # the same rounds through the plain versions (no kernel launches)
    for r, v in enumerate(masks):
        ref_avg, ref_count = lr.masked_average_reference(x0, v)
        avg, count = results[r]
        compare(avg, ref_avg, f"round {r} result")
        require(float(count) == float(ref_count) == 12.0, f"round {r} count")
        x0 = lr.elastic_average_step_reference(x0, v, ALPHA)
    compare(x, x0, "state after the rounds")
    require(xt.shape == (K_WORKERS, DATA // 128, 128), "packed state shape")
    del x0, results
    torch.cuda.empty_cache()
    require(bench_rec["metric"].startswith("local_threshold_reduce_bw_64Mfloat")
            and bench_rec["value"] > 0, f"bench record {bench_rec}")
    require([r["config"] for r in records] == [2, 4], "configs 2 and 4")
    for rec in records:
        require(math.isfinite(rec["seconds_per_iter"]) and rec["seconds_per_iter"] > 0
                and rec["device"] == card["name"] and rec["power_limit"]
                == card["power_limit"], f"record {rec}")
    phase("main_path", t0, rounds=ROUNDS, launches_per_round=per_round,
          launches=launches)

    # -- 5. timings at K = 16 x 64M -----------------------------------------------
    t0 = time.perf_counter()
    k = K_WORKERS
    ones = torch.ones(k, device=dev)
    keep, pull = 1.0 - ALPHA, ALPHA

    def library_average():
        return torch.mv(x.t(), valid) / torch.clamp_min(valid.sum(), 1.0)

    def library_step():
        x.addr_(ones, library_average(), beta=keep, alpha=pull)

    timing = {
        "masked_average": {
            "ms": cuda_event_ms(lambda: lr.masked_average(x, valid), 20),
            "plain_ms": cuda_event_ms(lambda: lr.masked_average_reference(x, valid), 5),
            "library_ms": cuda_event_ms(library_average, 20),
            "bytes": (k * DATA + k + DATA + 1) * 4,
            "ops": 2 * k * DATA + DATA,
        },
        "elastic_average_step": {
            "ms": cuda_event_ms(lambda: lr.elastic_average_step(x, valid, ALPHA), 20),
            "plain_ms": cuda_event_ms(
                lambda: lr.elastic_average_step_reference(x, valid, ALPHA), 5),
            "library_ms": cuda_event_ms(library_step, 20),
            "bytes": (2 * k * DATA + k) * 4,
            "ops": 2 * k * DATA + DATA + 3 * k * DATA,
        },
    }
    require(bool(torch.isfinite(x).all()), "state finite after the timing loops")
    kernels = []
    for name, t in timing.items():
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["ops"] / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t["library_ms"],
        })
        print(f"{name}: {t['ms']:.4f} ms, {t['bytes'] / t['ms'] / 1e6:.1f} GB/s "
              f"({max(bytes_ms, ops_ms) / t['ms'] * 100:.1f}% of the HBM bound "
              f"{max(bytes_ms, ops_ms):.4f} ms); plain {t['plain_ms']:.4f} ms; "
              f"library {t['library_ms']:.4f} ms", flush=True)
    phase("timings", t0, library_note="masked_average: torch.mv + sum + clamp + "
          "div; elastic_average_step: the same plus Tensor.addr_")

    # -- 6. result lines ----------------------------------------------------------
    phase("total", t_start)
    print(json.dumps({"kernels": kernels}))
    print(card["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
