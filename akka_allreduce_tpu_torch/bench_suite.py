"""The BASELINE benchmark matrix on the port: config 1, the single-card
branch of configs 2 and 4, config 3 and config 5
(``akka_allreduce_tpu/bench_suite.py``), one JSON record each.

Config 1 is the reference's local N-worker fixture on the host engine
(``control.LocalAllreduceSystem``): a master and 4 workers in one process
over the full protocol, their round buffers on the card, the bookkeeping
on the host. On one card the round's work of configs 2 and 4 is the fused
threshold reduce over K = 8 virtual workers (the reference's "N local
workers" shape): the payload is masked, averaged and folded back into every
replica by the elastic-average kernel (K2), in a slope-timed loop. Config 3
is the MLP/MNIST data-parallel SGD step over 8 virtual ranks (``DPTrainer``,
its gradient average through K1 on the card). Records carry the same fields
as the JAX package's, plus ``device`` (the card's name, or ``"cpu"``) and
``power_limit`` (``nvidia-smi``'s, or null on the CPU).

Config 5 is dropout recovery in both tiers of the fault model: threshold
completion on the host engine with one worker's messages lost, and the
elastic re-mesh (``train.elastic``) around a node's loss and a late joiner,
timed with each re-mesh's first step. On one card the rank count cannot
change, so, as the JAX record does on one chip, a zero-rank control node
drops and rejoins and the full snapshot -> rebuild -> restore -> first step
cycle runs on the card. Its pipeline fields are null until that trainer
is ported (``families_not_ported``).

The multi-rank collective branch waits for a later slice of the port; it
is not stubbed.

Usage: ``python -m akka_allreduce_tpu_torch bench-suite [--quick]
[--device cpu] [--floats N] [--out FILE]``.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Callable

import torch

from akka_allreduce_tpu_torch._device import resolve_device
from akka_allreduce_tpu_torch.control.local import local_engine
from akka_allreduce_tpu_torch.models import MLP, lm_copy_task, mnist_like
from akka_allreduce_tpu_torch.ops import elastic_average_step, pack_tiles
from akka_allreduce_tpu_torch.parallel import line_mesh
from akka_allreduce_tpu_torch.train import (
    DPTrainer,
    ElasticDPTrainer,
    ElasticLongContextTrainer,
    ElasticMoETrainer,
    ElasticTrainer,
    Zero1DPTrainer,
)
from akka_allreduce_tpu_torch.utils.benchmarking import (
    SlopeEstimate,
    dense_train_flops,
    device_fields,
    device_peak_flops,
    median_slope,
    mfu,
)

REFERENCE_GBPS = 1.25  # 10 GbE ceiling of the reference's Netty data plane
VIRTUAL_WORKERS = 8
ALPHA = 0.125


def _record(config: int, name: str, **fields: Any) -> dict:
    rec = {"config": config, "name": name}
    rec.update(fields)
    return rec


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# -- config 1: fp32 allreduce on the host engine, 1M floats, 4 local workers --


def config1_local_engine(
    size: int = 1_000_000,
    rounds: int = 30,
    *,
    device: str | torch.device | None = None,
) -> dict:
    """The reference's local N-worker fixture (BASELINE.json:6): a master
    and 4 workers in one process, full protocol, chunk 262,144, thresholds
    1.0, 30 rounds so per-run setup amortizes. ``engine`` names where the
    round buffers lived (``"cuda"`` or ``"cpu"``), as the JAX record's
    ``native_engine`` names its hot loop."""
    dev = resolve_device(device)
    run = local_engine(size, rounds=rounds, device=dev).run()
    return _record(
        1,
        "local_engine_allreduce",
        workers=4,
        floats=size,
        rounds=run.rounds,
        seconds=round(run.seconds, 4),
        throughput_mbs=round(run.rounds * size * 4 / run.seconds / 1e6, 1),
        engine=dev.type,
        path="host_engine",
        **device_fields(dev),
    )


def elastic_rounds(
    xt: torch.Tensor, valid: torch.Tensor, alpha: float, rounds: int
) -> torch.Tensor:
    """``rounds`` elastic-averaging rounds over the stack ``xt`` in place."""
    for _ in range(rounds):
        elastic_average_step(xt, valid, alpha)
    return xt


def time_elastic_rounds(
    floats: int,
    dev: torch.device,
    *,
    trips_lo: int,
    trips_hi: int,
    outer: int,
    target_signal_s: float | None = None,
) -> tuple[SlopeEstimate, torch.Tensor]:
    """Slope-timed elastic rounds over ``floats`` floats split across the K
    virtual workers (seeded normal data, all-ones mask, alpha 0.125), carried
    in the packed form. Returns the estimate and the packed stack."""
    k = VIRTUAL_WORKERS
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((k, floats // k), generator=gen, device=dev)
    valid = torch.ones(k, device=dev)
    xt = pack_tiles(x)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()

    def timed(trips: int) -> float:
        t0 = time.perf_counter()
        elastic_rounds(xt, valid, ALPHA, trips)
        sync()
        return time.perf_counter() - t0

    est = median_slope(
        timed, trips_lo, trips_hi, outer=outer, target_signal_s=target_signal_s
    )
    return est, xt


def _allreduce_record(
    config: int,
    name: str,
    floats: int,
    *,
    device: str | torch.device | None = None,
    target_signal_s: float | None = 0.3,
) -> dict:
    """The single-card analog of the allreduce: fused K-worker threshold
    reduce on the card. More than one rank needs the transport between
    cards, which waits for a machine with several cards."""
    if _world_size() >= 2:
        raise NotImplementedError(
            "multi-rank allreduce arrives with the next slice of the port "
            "that has several cards (comm.allreduce runs virtual ranks on one "
            "card)"
        )
    dev = resolve_device(device)
    est, xt = time_elastic_rounds(
        floats, dev, trips_lo=3, trips_hi=103, outer=6,
        target_signal_s=target_signal_s,
    )
    k = VIRTUAL_WORKERS
    per = floats // k
    dt = est.seconds_per_iter
    gbps = k * per * 4 / dt / 1e9 if dt > 0 else 0.0
    max_spread = float(os.environ.get("BENCH_MAX_SPREAD_PCT", 15.0))
    if dt <= 0:
        suffix = "_UNMEASURABLE"
    elif est.noisy(max_spread):
        suffix = "_NOISY"
    else:
        suffix = ""
    # The JAX record tags working sets under ~110 MB "_vmem_resident" (the
    # v5e's VMEM held the whole loop carry). Hopper has no such memory: the
    # 50 MB L2 is all there is, so the path tag has no counterpart here.
    return _record(
        config,
        name + suffix,
        devices=1,
        virtual_workers=k,
        floats=floats,
        working_set_mb=round(xt.numel() * 4 / 1e6, 1),
        seconds_per_iter=round(dt, 6),
        spread_pct=est.spread_pct if math.isfinite(est.spread_pct) else None,
        reduce_gbps=round(gbps, 2),
        vs_baseline=round(gbps / REFERENCE_GBPS, 1),
        path="single_chip_fused_reduce",
        **device_fields(dev),
    )


# -- config 2: butterfly allreduce, 16 workers, 64M floats --------------------


def config2_butterfly(
    floats: int = 64 * 1024 * 1024,
    *,
    device: str | torch.device | None = None,
    target_signal_s: float | None = 0.3,
) -> dict:
    return _allreduce_record(
        2, "butterfly_allreduce", floats, device=device,
        target_signal_s=target_signal_s,
    )


# -- config 3: MLP/MNIST DP-SGD step -------------------------------------------


def config3_mlp_step(
    steps: int = 20,
    batch_per_device: int = 16,
    *,
    device: str | torch.device | None = None,
    target_signal_s: float | None = 1.0,
    chain_trips: tuple[int, int] = (5, 25),
    outer: int = 4,
) -> dict:
    """``MLP(hidden=(128,))`` trained by ``DPTrainer`` over 8 virtual ranks,
    16 rows a rank, lr 0.1: ``step_ms`` is the host loop's mean over
    ``steps + 2`` steps after one warm-up step (each ends in its loss's host
    read); ``device_step_ms`` the slope between ``train_chain``s of
    ``chain_trips`` steps (batches drawn on the device, one host read a
    chain), grown to ``target_signal_s`` of signal. ``steps_taken`` counts
    every step the trainer took, and so the gradient syncs."""
    dev = resolve_device(device)
    trainer = DPTrainer(MLP(hidden=(128,), classes=10, device=dev),
                        line_mesh(VIRTUAL_WORKERS, device=dev), learning_rate=0.1)
    ds = mnist_like()
    batch = batch_per_device * trainer.n_devices
    it = ds.batches(batch, steps + 3)
    trainer.train_step(*next(it))  # warm-up
    losses = []
    t0 = time.perf_counter()
    for x, y in it:
        losses.append(trainer.train_step(x, y).loss)
    dt = (time.perf_counter() - t0) / max(len(losses), 1)

    sampler = ds.device_sampler()
    last_losses = []

    def timed_chain(n_steps: int) -> float:
        t0 = time.perf_counter()
        chain_losses, _ = trainer.train_chain(sampler, n_steps, batch_per_device,
                                              fetch_metrics=False)
        last_losses[:] = [float(chain_losses[-1])]  # the host read ends the chain
        return time.perf_counter() - t0

    lo, hi = chain_trips
    chain_est = median_slope(timed_chain, lo, hi, outer=outer,
                             target_signal_s=target_signal_s)
    sec = chain_est.seconds_per_iter
    u = mfu(dense_train_flops(trainer.param_count, batch), sec, device_peak_flops(dev))
    return _record(
        3,
        "mlp_mnist_dp_sgd",
        devices=1,
        virtual_workers=trainer.n_devices,
        params=trainer.param_count,
        global_batch=batch,
        step_ms=round(dt * 1e3, 2),
        device_step_ms=round(sec * 1e3, 3),
        mfu=round(u, 4) if u is not None else None,
        device_step_spread_pct=(
            chain_est.spread_pct if math.isfinite(chain_est.spread_pct) else None),
        chain_loss_last=round(last_losses[0], 4),
        loss_first=round(losses[0], 4),
        loss_last=round(losses[-1], 4),
        steps_taken=trainer.step_num,
        path="k1_masked_average" if dev.type == "cuda" else "plain_masked_average",
        **device_fields(dev),
    )


# -- config 4: ResNet-50-class grad sync, 25M params --------------------------


def config4_grad_sync(
    params: int = 25_000_000,
    *,
    device: str | torch.device | None = None,
    target_signal_s: float | None = 0.3,
) -> dict:
    return _allreduce_record(
        4, "resnet_grad_sync_25M", params, device=device,
        target_signal_s=target_signal_s,
    )


# -- config 5: dropout and late-joiner recovery, both tiers ---------------------


def remesh_cycle(elastic, clock: dict, lost: int, batch_for) -> dict:
    """Drop, late rejoin, a warm second drop and a rejoin on ``elastic``
    (its clock reads ``clock["t"]``): node ``lost`` goes silent while the
    others keep beating across a 60 s gap, then beats again. Each re-mesh
    is timed alone and with the first step after it (the step ends in its
    loss's host read). ``batch_for(trainer, seed_offset)`` gives a batch
    for the current mesh. "Warm" means the second drop's rank count was
    built before: the caching allocator and the cuBLAS handles are ready;
    nothing is compiled."""
    survivors = [k for k in elastic.devices_by_node if k != lost]
    x, y = batch_for(elastic.trainer, 0)
    elastic.train_step(x, y)

    def timed(offset: int):
        t0 = time.perf_counter()
        changed = elastic.poll()
        t1 = time.perf_counter()
        m = elastic.train_step(*batch_for(elastic.trainer, offset))
        return changed, m, t1 - t0, time.perf_counter() - t0

    def drop():
        for k in survivors:
            elastic.heartbeat(k)
        clock["t"] += 60.0
        for k in survivors:
            elastic.heartbeat(k)
        return timed(2)

    def rejoin():
        clock["t"] += 1.0
        elastic.heartbeat(lost)
        return timed(3)

    dropped, m_drop, drop_remesh_s, drop_s = drop()
    rejoined, m_join, rejoin_remesh_s, rejoin_s = rejoin()
    _, _, warm_remesh_s, warm_s = drop()
    rejoin()  # full membership again for whoever comes next
    return {"dropped": bool(dropped), "rejoined": bool(rejoined),
            "drop_s": drop_s, "rejoin_s": rejoin_s, "warm_drop_s": warm_s,
            "drop_remesh_s": drop_remesh_s, "rejoin_remesh_s": rejoin_remesh_s,
            "warm_drop_remesh_s": warm_remesh_s, "m_drop": m_drop, "m_join": m_join}


def config5_dropout_recovery(
    size: int = 200_000, *, device: str | torch.device | None = None
) -> dict:
    """Both tiers of the fault model. Tier 1: 4 workers on the host engine,
    ``size`` floats, chunk 16,384, thresholds 0.75, 10 rounds, every message
    of worker 3 lost (node 0's flushes counted). Tier 2: the re-mesh cycle
    of :func:`remesh_cycle` on ``ElasticDPTrainer`` (``MLP(hidden=(16,))``),
    ``ElasticTrainer`` over ``Zero1DPTrainer`` (SGD 0.1),
    ``ElasticMoETrainer`` (4 experts, capacity factor 4.0) and
    ``ElasticLongContextTrainer`` (both vocab 16, d_model 32, 2 heads,
    seq_len 32, 1 layer), over ``{0: [rank], 1: []}``: one rank on the
    device and a zero-rank control node that drops and rejoins; the MoE
    tier over 4 nodes of 2 ranks, the last of which drops and rejoins (the
    JAX suite's assignment on several devices: its (data, expert) mesh goes
    2 x 4 -> 3 x 2 -> 2 x 4)."""
    dev = resolve_device(device)
    n, rounds = 4, 10
    run = local_engine(size, nodes=n, chunk=16_384, rounds=rounds, th=0.75,
                       drop_worker=3, device=dev, keep_outputs=True).run()
    node0 = run.outputs[0]
    mean_count = float(node0[-1].count.float().mean()) if node0 else 0.0

    assignment = {0: [0], 1: []}
    lost = 1
    clock = {"t": 0.0}
    now = lambda: clock["t"]  # noqa: E731
    ds = mnist_like()

    def mnist_for(t, s):
        return next(iter(ds.batches(8 * t.n_devices, 1, seed_offset=s)))

    dp = remesh_cycle(
        ElasticDPTrainer(MLP(hidden=(16,), classes=10, device=dev), assignment,
                         clock=now, device=dev),
        clock, lost, mnist_for)

    def z1_factory(mesh):
        return Zero1DPTrainer(MLP(hidden=(16,), classes=10, device=mesh.device), mesh,
                              optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))

    z1 = remesh_cycle(ElasticTrainer(z1_factory, assignment, clock=now, device=dev),
                      clock, lost, mnist_for)

    lm_ds = lm_copy_task(32, vocab=16)
    fam_kw = dict(vocab=16, d_model=32, n_heads=2, learning_rate=1e-2, seed=0, clock=now,
                  device=dev)
    # the MoE tier over the JAX suite's multi-device assignment: 4 nodes of 2
    # ranks, the last one lost, so the mesh goes (data, expert) 2 x 4 -> 3 x 2
    moe = remesh_cycle(
        ElasticMoETrainer({k: [2 * k, 2 * k + 1] for k in range(4)}, n_experts=4,
                          n_layers=1, seq_len=32, capacity_factor=4.0, **fam_kw),
        clock, 3, lambda t, s: next(lm_ds.batches(t.dp * t.ep, 1, seed_offset=s)))
    lc = remesh_cycle(
        ElasticLongContextTrainer(assignment, seq_len=32, max_sp=4, n_layers=1, **fam_kw),
        clock, lost, lambda t, s: next(lm_ds.batches(t.dp, 1, seed_offset=s)))

    def family(prefix: str, c: dict | None) -> dict:
        keys = ("remeshed", "drop_remesh_and_first_step_s",
                "rejoin_remesh_and_first_step_s", "warm_drop_remesh_and_first_step_s",
                "post_rejoin_loss")
        if c is None:
            return {f"{prefix}_{k}": None for k in keys}
        return {f"{prefix}_remeshed": c["dropped"] and c["rejoined"],
                f"{prefix}_drop_remesh_and_first_step_s": c["drop_s"],
                f"{prefix}_rejoin_remesh_and_first_step_s": c["rejoin_s"],
                f"{prefix}_warm_drop_remesh_and_first_step_s": c["warm_drop_s"],
                f"{prefix}_post_rejoin_loss": c["m_join"].loss}

    return _record(
        5,
        "threshold_dropout_recovery",
        workers=n,
        threshold=0.75,
        rounds_completed=len(node0),
        seconds=run.seconds,
        mean_contributors=mean_count,
        dropped_remeshed=dp["dropped"],
        rejoin_remeshed=dp["rejoined"],
        remeshed=dp["dropped"] and dp["rejoined"],
        remesh_nodes=len(assignment),
        device_platform=dev.type,
        zero_device_control_node=True,
        drop_remesh_and_first_step_s=dp["drop_s"],
        rejoin_remesh_and_first_step_s=dp["rejoin_s"],
        warm_drop_remesh_and_first_step_s=dp["warm_drop_s"],
        drop_remesh_s=dp["drop_remesh_s"],
        rejoin_remesh_s=dp["rejoin_remesh_s"],
        warm_drop_remesh_s=dp["warm_drop_remesh_s"],
        compile_cache=None,  # nothing is compiled at a re-mesh
        post_remesh_loss=dp["m_drop"].loss,
        post_rejoin_loss=dp["m_join"].loss,
        **family("zero1", z1),
        **family("moe", moe),
        **family("pipeline", None),
        **family("long_context", lc),
        families_not_ported=["pipeline"],
        path="host_engine + elastic_remesh",
        **device_fields(dev),
    )


# -- suite driver --------------------------------------------------------------


def run_suite(
    *,
    quick: bool = False,
    out: str | None = None,
    device: str | torch.device | None = None,
    floats: int | None = None,
) -> list[dict]:
    """Configs 1 to 5, one JSON line each. ``quick`` runs 1/8-size
    payloads and short chains at fixed trip counts (no growing them to a
    timing signal, so its run time is bounded); ``floats`` sets the payload
    sizes of configs 1, 2 and 4."""
    scale = 8 if quick else 1
    signal = None if quick else 0.3
    configs: list[Callable[[], dict]] = [
        lambda: config1_local_engine(floats or 1_000_000 // scale, device=device),
        lambda: config2_butterfly(
            floats or 64 * 1024 * 1024 // scale, device=device,
            target_signal_s=signal,
        ),
        lambda: config3_mlp_step(
            device=device,
            target_signal_s=None if quick else 1.0,
            chain_trips=(2, 6) if quick else (5, 25),
            outer=2 if quick else 4,
        ),
        lambda: config4_grad_sync(
            floats or 25_000_000 // scale, device=device,
            target_signal_s=signal,
        ),
        lambda: config5_dropout_recovery(200_000 // scale, device=device),
    ]
    records = []
    stream = open(out, "a", buffering=1) if out else None
    try:
        for fn in configs:
            rec = fn()
            records.append(rec)
            line = json.dumps(rec)
            print(line, flush=True)
            if stream:
                stream.write(line + "\n")
    finally:
        if stream:
            stream.close()
    return records
