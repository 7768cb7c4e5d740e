"""The host engine's four reductions, on tensors.

Counterpart of the reduction entry points of the JAX package's ``native/``
(``accumulate``, ``average``, ``elastic_update`` and ``expand_counts``, the
C++ loops of ``native/threshold_reduce.cpp`` with their numpy fallbacks).
Those are host loops, not Pallas kernels, so their port is plain PyTorch:
each function runs on the device its tensors lie on, which for the engine
is the card, or the CPU in the tests.

Every f32 result equals the C++ loop's bit for bit: each element goes
through the same IEEE f32 operations in the same order, as separate ops
that nothing contracts into an FMA. The wire codec half of ``native/``
(checksums, ``sendmmsg``, io_uring) belongs to the TCP transport and is not
here.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_shapes(*tensors: torch.Tensor) -> None:
    if len({tuple(t.shape) for t in tensors}) != 1:
        raise ValueError(
            "shape mismatch: " + " vs ".join(str(tuple(t.shape)) for t in tensors)
        )


def accumulate(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst += src`` in place (float32)."""
    _check_shapes(dst, src)
    dst.add_(src)


def average(total: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``total / counts`` where ``counts > 0``, else 0 (the consumer's divide)."""
    _check_shapes(total, counts)
    quotient = total / counts.to(torch.float32).clamp_min(1.0)
    return torch.where(counts > 0, quotient, torch.zeros_like(quotient))


def elastic_update(
    w: torch.Tensor, total: torch.Tensor, counts: torch.Tensor, alpha: float
) -> None:
    """In place: ``w <- keep * w + a * (total / counts)`` where ``counts > 0``,
    with ``a = f32(alpha)`` and ``keep = f32(1) - a`` (the C++ loop's
    ``1.0f - alpha``); elements nobody contributed keep their weight."""
    _check_shapes(w, total, counts)
    a32 = np.float32(alpha)
    a, keep = float(a32), float(np.float32(1.0) - a32)
    avg = total / counts.to(torch.float32).clamp_min(1.0)
    moved = w * keep + avg * a
    w.copy_(torch.where(counts > 0, moved, w))


def expand_counts(
    chunk_counts: np.ndarray,
    lengths: np.ndarray,
    n_out: int,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """Per-chunk counts to per-element counts, ``(n_out,)`` int32 on
    ``device``: chunk c's count repeated ``lengths[c]`` times, cut at
    ``n_out`` and zero-padded past the last chunk.

    The counts stay on the host and reach the device as the scalar of one
    fill a run of equal counts (one fill a round under full participation),
    so nothing is copied between host and device and nothing waits on the
    card.
    """
    counts = np.ascontiguousarray(chunk_counts, dtype=np.int32).reshape(-1)
    lens = np.ascontiguousarray(lengths, dtype=np.int64).reshape(-1)
    if counts.shape != lens.shape:
        raise ValueError("chunk_counts and lengths must align")
    out = torch.empty(n_out, dtype=torch.int32, device=device)
    pos = run_start = 0
    run_value = None
    for count, length in zip(counts.tolist(), lens.tolist()):
        if pos >= n_out:
            break
        if count != run_value:
            if pos > run_start:
                out[run_start:pos].fill_(run_value)
            run_start, run_value = pos, count
        pos = min(pos + max(length, 0), n_out)
    if pos > run_start:
        out[run_start:pos].fill_(run_value)
    if pos < n_out:
        out[pos:].fill_(0)
    return out
