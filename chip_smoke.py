#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card; without one (or without the repo beside it) it exits
non-zero and prints no result.

Phases, each printed as it ends:

1. card: name, power limit and count (``nvidia-smi``);
2. build: ``nvcc`` compiles every kernel source of the path (``local_reduce``
   and ``ring``), all in parallel;
3. kernel vs plain: K1 ``masked_average`` and K2 ``elastic_average_step``
   against their plain versions on the card, at the main path's shapes
   (K = 16 workers x 64M floats with a 12-of-16 threshold mask, and the
   bench's packed K = 8 stacks), plus the zero mask (K2 leaves X
   bit-identical, K1 gives zeros and count 0), ragged widths (17, 1000,
   65537) and K above the register-resident bound (40); then K3, the ring
   allreduce, against its plain version: n in {2, 3, 4, 8, 16} ranks,
   ``seg_rows`` in {1, 4, 512}, every compress mode, ragged data, an int8
   all-zero segment, and the full shape, n = 8 ranks x 25,000,000 floats
   (BASELINE config 4's ResNet-50 buffer; 48 buckets) under a 6-of-8 mask,
   with every rank's row checked against rank 0's;
4. main paths, each with its launch counters set to 0 just before it and
   read just after: (a) threshold rounds at K = 16 x 64M (each round's
   result from ``masked_average``, the fold from ``elastic_average_step`` on
   the packed form), checked against the same rounds through the plain
   versions, then the bench (the ``local_threshold_reduce_bw`` metric) and
   ``bench_suite.run_suite`` for configs 2 and 4; (b) for each compress
   mode, ``threshold_allreduce(line_mesh(8), ..., schedule="pallas_ring")``
   at 8 x 25M against the same round through the plain K3, and one
   ``measure_allreduce`` record, printed on its own line; (c) the butterfly
   ``threshold_allreduce(grid_mesh(4, 4), ...)`` at 16 x 64M (config 2's
   shape) against a float64 sum;
5. timings: K1 and K2 at K = 16 x 64M, K3 in each mode at 8 x 25M (padded to
   whole buckets), each by CUDA events, beside its plain version, the
   nearest PyTorch library call and the HBM bound;
6. one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, ...}`` line.

Kernel and plain version are compared with rtol = atol = 1e-6 (the JAX
package's tolerance); the kernels avoid FMA contraction, so the error is
expected to be exactly 0, and K1, K2 and K3 in f32 and bf16 are held to bit
equality.
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
RING_RANKS = 8
RING_FLOATS = 25_000_000  # BASELINE config 4: ResNet-50's gradient buffer
RING_MODES = (None, "bf16", "int8")


def ring_name(mode: str | None) -> str:
    """The kernels line's name of K3 in one compress mode."""
    return f"ring_allreduce_{mode or 'f32'}"


SOURCE = {
    "masked_average": "akka_allreduce_tpu_torch/ops/csrc/local_reduce.cu",
    "elastic_average_step": "akka_allreduce_tpu_torch/ops/csrc/local_reduce.cu",
    **{ring_name(m): "akka_allreduce_tpu_torch/ops/csrc/ring.cu" for m in RING_MODES},
}
REPLACES = {
    "masked_average": "akka_allreduce_tpu/ops/local_reduce.py:79",
    "elastic_average_step": "akka_allreduce_tpu/ops/local_reduce.py:142",
    **{ring_name(m): "akka_allreduce_tpu/ops/ring.py:264" for m in RING_MODES},
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
    from akka_allreduce_tpu_torch.comm import measure_allreduce, threshold_allreduce
    from akka_allreduce_tpu_torch.config import ThresholdConfig
    from akka_allreduce_tpu_torch.ops import _build
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.ops import ring as rk
    from akka_allreduce_tpu_torch.parallel import grid_mesh, line_mesh
    from akka_allreduce_tpu_torch.utils import MetricsLogger, card_info, cuda_event_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the library yardstick in fp32
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. card --------------------------------------------------------------
    card = card_info(dev)
    phase("card", t_start, name=card["name"], power_limit=card["power_limit"],
          count=card["count"])

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build("local_reduce", "ring")
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

    # -- 3b. K3 vs plain ----------------------------------------------------------
    t0 = time.perf_counter()

    def check_ring(got: torch.Tensor, want: torch.Tensor, mode, what: str) -> float:
        """K3 against its plain version: f32 and bf16 bit for bit, int8 within
        rtol = atol = 1e-6; every rank's row against rank 0's. Returns the
        largest absolute difference."""
        err_ = compare(got, want, what)
        if mode != "int8":
            require(torch.equal(got, want), f"{what}: not bit-identical")
        for d in range(1, got.shape[0]):
            if mode == "int8":
                require(torch.allclose(got[d], got[0], rtol=2e-6, atol=1e-6),
                        f"{what}: rank {d} differs from rank 0")
            else:
                require(torch.equal(got[d], got[0]),
                        f"{what}: rank {d} differs from rank 0")
        return err_

    ring_small = 0.0
    for n in (2, 3, 4, 8, 16):
        for seg_rows in (1, 4, 512):
            xs = torch.randn((n, 2 * n * seg_rows * 128 + 37), generator=gen,
                             device=dev)
            for mode in RING_MODES:
                got = rk.ring_kernel_allreduce_sum(xs, seg_rows=seg_rows, compress=mode)
                want = rk.ring_kernel_allreduce_sum_reference(
                    xs, seg_rows=seg_rows, compress=mode)
                ring_small = max(ring_small, check_ring(
                    got, want, mode, f"ring n={n} seg_rows={seg_rows} {mode}"))
    xz = torch.randn((4, 4 * 4 * 128), generator=gen, device=dev)
    xz[:, :4 * 128] = 0.0  # an all-zero int8 segment on every rank
    zr = rk.ring_kernel_allreduce_sum(xz, seg_rows=4, compress="int8")
    check_ring(zr, rk.ring_kernel_allreduce_sum_reference(xz, seg_rows=4,
                                                          compress="int8"),
               "int8", "ring int8 all-zero segment")
    require(not bool(zr[:, :4 * 128].any()), "all-zero segment reduces to zeros")

    xr = torch.randn((RING_RANKS, RING_FLOATS), generator=gen, device=dev)
    ring_valid = threshold_mask(RING_RANKS, mask_gen)
    require(int(ring_valid.sum()) == 6, "6-of-8 threshold mask")
    vx = xr * ring_valid[:, None]  # masking happens before the kernel
    ring_ref = {}  # rank 0's plain-K3 result per mode, for the main path
    for mode in RING_MODES:
        got = rk.ring_kernel_allreduce_sum(vx, compress=mode)
        want = rk.ring_kernel_allreduce_sum_reference(vx, compress=mode)
        err[ring_name(mode)] = check_ring(
            got, want, mode, f"ring {RING_RANKS} x {RING_FLOATS} {mode}")
        ring_ref[mode] = want[0].clone()
        del got, want
    del vx
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase("ring_vs_plain", t0, small_max_abs_err=ring_small,
          max_abs_err={ring_name(m): err[ring_name(m)] for m in RING_MODES},
          tolerance={"f32": "bit-exact", "bf16": "bit-exact",
                     "int8": {"rtol": RTOL, "atol": ATOL}})

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

    # -- 4b. main path: the threshold allreduce over 8 virtual ranks ------------
    t0 = time.perf_counter()
    line8 = line_mesh(RING_RANKS)
    oracle = (xr.double() * ring_valid.double()[:, None]).sum(0)
    scale = float(oracle.abs().max())
    ring_launches, ring_records, ring_round_ms = {}, {}, {}
    for mode in RING_MODES:
        rk.LAUNCHES["ring_allreduce"] = 0
        res = threshold_allreduce(line8, xr, ring_valid, schedule="pallas_ring",
                                  compress=mode)
        rounds = MetricsLogger()
        rec = measure_allreduce(line8, RING_FLOATS, schedule="pallas_ring",
                                compress=mode, iters=10, warmup=2, logger=rounds)
        torch.cuda.synchronize()
        ring_launches[ring_name(mode)] = rk.LAUNCHES["ring_allreduce"]
        require(rk.LAUNCHES["ring_allreduce"] > 0, f"ring kernel launched ({mode})")
        print(json.dumps(rec.to_dict()), flush=True)
        ring_records[mode] = rec.to_dict()
        ring_round_ms[ring_name(mode)] = [m.latency_s * 1e3 for m in rounds.records]
        require(rec.path == "virtual_ranks_one_card" and rec.device == card["name"]
                and rec.bus_gbps_median > 0, f"bandwidth record {rec}")
        # the same round through the plain versions: mask, plain K3, count
        compare(res.sum, ring_ref[mode], f"pallas_ring {mode} round")
        if mode != "int8":
            require(torch.equal(res.sum, ring_ref[mode]), f"{mode} round bit-exact")
        require(bool((res.count == 6.0).all()), f"pallas_ring {mode} count")
        tol = {None: 1e-5, "bf16": 2e-2, "int8": 8e-2}[mode]
        rel = float((res.sum.double() - oracle).abs().max()) / scale
        require(rel < tol, f"pallas_ring {mode} vs the f64 sum: {rel}")
        del res
    del oracle, ring_ref
    torch.cuda.empty_cache()
    phase("ring_main_path", t0, launches=ring_launches,
          bus_gbps_median={ring_name(m): r["bus_gbps_median"]
                           for m, r in ring_records.items()},
          round_ms=ring_round_ms,
          note="bus GB/s over 8 virtual ranks on one card: HBM figures")

    # -- 4c. main path: the 16-rank butterfly at config 2's shape -----------------
    t0 = time.perf_counter()
    res = threshold_allreduce(grid_mesh(4, 4), x, valid, schedule="butterfly")
    oracle = torch.zeros(DATA, dtype=torch.float64, device=dev)
    for k in range(K_WORKERS):
        oracle += x[k].double() * float(valid[k])
    torch.cuda.synchronize()
    require(res.sum.shape == (DATA,) and bool(torch.isfinite(res.sum).all()),
            "butterfly sum finite")
    require(bool((res.count == 12.0).all()), "butterfly count 12")
    bf_err = float((res.sum.double() - oracle).abs().max())
    require(torch.allclose(res.sum.double(), oracle, rtol=1e-5, atol=1e-5),
            f"butterfly vs the f64 sum: {bf_err}")
    del res, oracle
    bf_ms = []
    for _ in range(3):  # the round's time on the host clock, warmed
        t1 = time.perf_counter()
        threshold_allreduce(grid_mesh(4, 4), x, valid, schedule="butterfly")
        torch.cuda.synchronize()
        bf_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.empty_cache()
    phase("butterfly_main_path", t0, ranks=K_WORKERS, floats=DATA,
          max_abs_err_vs_f64=bf_err, round_ms=bf_ms)

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
    del x
    torch.cuda.empty_cache()

    # K3 at 8 x 25M, padded to whole buckets so the call is the kernel's alone
    n = RING_RANKS
    padded = -(-RING_FLOATS // (n * 512 * 128)) * n * 512 * 128
    xp = torch.nn.functional.pad(xr, (0, padded - RING_FLOATS))
    del xr
    hops = 2 * (n - 1) * padded  # elements sent over all ranks and steps
    per_element_ops = {None: 0, "bf16": 2, "int8": 6}  # cast pair / int8 codec
    for mode in RING_MODES:
        timing[ring_name(mode)] = {
            "ms": cuda_event_ms(
                lambda: rk.ring_kernel_allreduce_sum(xp, compress=mode), 10),
            "plain_ms": cuda_event_ms(
                lambda: rk.ring_kernel_allreduce_sum_reference(xp, compress=mode), 3),
            "library_ms": cuda_event_ms(
                lambda: xp.sum(0, keepdim=True).expand_as(xp).contiguous(), 10)
            if mode is None else None,
            "bytes": 2 * n * padded * 4,
            "ops": (n - 1) * padded + per_element_ops[mode] * hops,
        }
    kernels = []
    for name, t in timing.items():
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["ops"] / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": {**launches, **ring_launches}[name],
            "max_abs_err": err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t["library_ms"],
        })
        library = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"{name}: {t['ms']:.4f} ms, {t['bytes'] / t['ms'] / 1e6:.1f} GB/s "
              f"({max(bytes_ms, ops_ms) / t['ms'] * 100:.1f}% of the HBM bound "
              f"{max(bytes_ms, ops_ms):.4f} ms); plain {t['plain_ms']:.4f} ms; "
              f"library {library}", flush=True)
    phase("timings", t0, library_note="masked_average: torch.mv + sum + clamp + "
          "div; elastic_average_step: the same plus Tensor.addr_; "
          "ring_allreduce_f32: xs.sum(0, keepdim=True).expand_as(xs).contiguous(); "
          "bf16 and int8 rings: none", ring_shape=[n, padded])

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
