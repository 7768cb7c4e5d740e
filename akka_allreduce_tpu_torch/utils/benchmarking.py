"""Timing helpers for the port.

- :class:`SlopeEstimate` / :func:`median_slope`: the port's copy of the JAX
  package's slope timing (``akka_allreduce_tpu/utils/benchmarking.py``).
  Per-iteration time is the median slope between interleaved short and long
  runs, so constant launch and sync overhead cancels in the difference.
- :func:`cuda_event_ms`: a kernel's time on the card from CUDA events around
  many launches after a warm-up.
- :func:`card_info`: the card's name, power limit and count, as
  ``nvidia-smi`` reports them; every number measured on a card is written
  down beside them.
- FLOP accounting: the port's copies of ``dense_train_flops``,
  ``transformer_train_flops`` and ``moe_active_params``, a
  forward-only form for serving (:func:`transformer_forward_flops`),
  :func:`device_peak_flops`, the card's dense bf16 peak, and the port's copy
  of :func:`mfu`.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Callable

import torch

SMI_QUERY = (
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
)

#: dense bf16 tensor-core peak FLOP/s by ``torch.cuda.get_device_name``
#: (NVIDIA's data sheet; the SXM part at its full 700 W limit)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM
}


def device_peak_flops(device: torch.device | int | None = None) -> float | None:
    """Dense bf16 peak of the CUDA card ``device`` (default: card 0), or None
    for the CPU and for cards without an entry."""
    if isinstance(device, torch.device) and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    if isinstance(device, torch.device):
        index = device.index or 0
    else:
        index = device or 0
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(index))


def mfu(
    flops_per_step: float,
    seconds_per_step: float,
    peak_flops: float | None = None,
    *,
    n_devices: int = 1,
) -> float | None:
    """Model-FLOPs utilization in [0, 1]; None when no peak applies (the
    CPU, or a card without a ``PEAK_BF16_FLOPS`` entry).

    ``flops_per_step`` is the whole batch's model work, so the denominator
    is ``n_devices`` x the per-card peak.
    """
    if peak_flops is None:
        peak_flops = device_peak_flops()
    if peak_flops is None or seconds_per_step <= 0:
        return None
    return flops_per_step / seconds_per_step / (peak_flops * n_devices)


def dense_train_flops(
    n_params: int | float, tokens: int | float, *, remat: bool = False
) -> float:
    """Model FLOPs of one training step of a dense (matmul-dominated) model:
    ``6·N·tokens`` (2N forward + 4N backward per token or sample); ``remat``
    adds one forward (``8·N·tokens``)."""
    per_token = 8.0 if remat else 6.0
    return per_token * float(n_params) * float(tokens)


def transformer_train_flops(
    *,
    n_params: int | float,
    batch: int,
    seq: int,
    d_model: int,
    n_layers: int,
    causal: bool = True,
    remat: bool = False,
) -> float:
    """Model FLOPs of one Transformer LM training step (the JAX package's
    accounting): dense ``6·N·B·T`` (``8·N·B·T`` with ``remat``) plus the
    attention score/value products, ``4·B·T²·d`` per layer forward, 2x that
    backward, halved for causal attention."""
    n_forwards = 4.0 if remat else 3.0  # forward-equivalents in one step
    dense = 2.0 * float(n_params) * batch * seq * n_forwards
    attn = 4.0 * batch * float(seq) ** 2 * d_model * n_layers * n_forwards
    if causal:
        attn *= 0.5
    return dense + attn


def transformer_forward_flops(
    *,
    n_params: int | float,
    batch: int,
    seq: int,
    d_model: int,
    n_layers: int,
    causal: bool = True,
) -> float:
    """Model FLOPs of one forward (a prefill): ``2·N·B·T`` plus the
    attention products ``4·B·T²·d`` per layer, halved for causal."""
    attn = 4.0 * batch * float(seq) ** 2 * d_model * n_layers
    return 2.0 * float(n_params) * batch * seq + (0.5 * attn if causal else attn)


def moe_active_params(model: torch.nn.Module, topk: int, n_experts: int) -> float:
    """Active parameter count of a Switch/GShard MoE model: each token runs
    ``topk`` of the ``n_experts`` expert MLPs, so a parameter whose name
    holds ``moe_`` counts at topk/n_experts and every other one fully (the
    JAX function's rule over flax paths, here over ``named_parameters``).
    Feed it to :func:`transformer_train_flops` as ``n_params``."""
    total = expert = 0
    for name, p in model.named_parameters():
        total += p.numel()
        if "moe_" in name:
            expert += p.numel()
    return total - expert + expert * topk / n_experts


@dataclass(frozen=True)
class SlopeEstimate:
    """Per-iteration seconds with a robustness diagnostic."""

    seconds_per_iter: float  # median of per-pair slopes
    spread_pct: float  # 100 * IQR / median over the slope samples
    n_samples: int

    def noisy(self, max_spread_pct: float = 15.0) -> bool:
        return not (self.spread_pct <= max_spread_pct)


def median_slope(
    timed: Callable[[int], float],
    trips_lo: int,
    trips_hi: int,
    *,
    outer: int = 8,
    warmup: bool = True,
    target_signal_s: float | None = None,
    max_trips: int = 100_000,
) -> SlopeEstimate:
    """Median per-iteration time from interleaved (lo, hi) timing pairs.

    ``timed(trips)`` runs the workload ``trips`` iterations, waits for it to
    finish, and returns wall seconds including any constant overhead.
    ``target_signal_s`` rescales ``trips_hi`` from one rough warm-up slope so
    the (hi - lo) signal reaches that many seconds whatever the throughput.
    """
    import numpy as np

    if trips_hi <= trips_lo:
        raise ValueError(f"need trips_hi > trips_lo, got {trips_lo}/{trips_hi}")
    t_hi_rough = None
    if warmup:
        timed(trips_lo)
        t_hi_rough = timed(trips_hi)
    if target_signal_s is not None:
        # grow trips_hi until the (hi - lo) signal is clearly positive and
        # ~target_signal_s seconds, at most 16x per step
        for _ in range(4):
            if t_hi_rough is None:
                t_hi_rough = timed(trips_hi)
            rough = (t_hi_rough - timed(trips_lo)) / (trips_hi - trips_lo)
            t_hi_rough = None
            if rough > 0:
                want = trips_lo + int(target_signal_s / rough)
                if want <= trips_hi or trips_hi >= max_trips:
                    break
                trips_hi = min(want, 16 * trips_hi, max_trips)
            elif trips_hi >= max_trips:
                break
            else:
                trips_hi = min(16 * trips_hi, max_trips)
    slopes = []
    for _ in range(outer):
        t_lo = timed(trips_lo)
        t_hi = timed(trips_hi)
        slopes.append((t_hi - t_lo) / (trips_hi - trips_lo))
    med = float(np.median(slopes))
    q1, q3 = np.percentile(slopes, [25, 75])
    spread = 100.0 * float(q3 - q1) / med if med > 0 else float("inf")
    return SlopeEstimate(med, round(spread, 1), outer)


def cuda_event_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` back-to-back calls on the current stream, after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_info(device: torch.device | int = 0) -> dict:
    """``{"smi": raw nvidia-smi line, "name", "power_limit", "count"}`` for
    the card ``device``; raises when there is no card or no ``nvidia-smi``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    index = device if isinstance(device, int) else (device.index or 0)
    out = subprocess.run(
        SMI_QUERY, capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()
    line = out[index] if index < len(out) else out[0]
    name, _, limit = line.rpartition(",")
    return {
        "smi": line,
        "name": name.strip(),
        "power_limit": limit.strip(),
        "count": torch.cuda.device_count(),
    }


def device_fields(dev: torch.device) -> dict:
    """``device`` and ``power_limit`` for a record measured on ``dev``: the
    card's name and power limit, or ``"cpu"`` and None."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    info = card_info(dev)
    return {"device": info["name"], "power_limit": info["power_limit"]}
