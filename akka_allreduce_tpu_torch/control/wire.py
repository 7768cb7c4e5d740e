"""The int8 half of the wire codec that the worker's error feedback needs:
the port's copy of ``quantize_int8`` and ``int8_roundtrip`` from the JAX
package's ``control/wire.py``.

This is the wire's quantizer, not the ring's: the scale is
``max|x| / 127`` computed in float64 on the host (the value a frame
carries), and the division is by that scale rounded to float32, rounded
half to even. (The ring's ``int8_quantize`` uses ``amax * f32(1/127)``, as
XLA folds it.) The rest of the codec comes with the port's TCP transport.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from akka_allreduce_tpu_torch.obs import metrics as _obs_metrics

_INT8_SATURATED = _obs_metrics.counter("wire.int8_saturated")

#: non-finite int8 inputs saturate here: far past any sane payload, yet
#: ``127 * (_I8_SAT_MAX / 127)`` stays inside float32, so a saturated chunk
#: dequantizes finite
_I8_SAT_MAX = 1e30


def quantize_int8(value: torch.Tensor) -> tuple[float, torch.Tensor, torch.Tensor]:
    """``(scale, int8 tensor, sanitized f32 tensor)`` with one shared scale
    for the chunk, ``max|x| / 127`` (1.0 for an all-zero chunk).

    Non-finite inputs are saturated first (counted, ``wire.int8_saturated``),
    and residuals must be computed against the sanitized tensor. The scale
    is a host float, as a frame carries it, so this reads ``max|x|`` back
    from the tensor's device.
    """
    arr = value.to(torch.float32).contiguous()
    m = float(arr.abs().max()) if arr.numel() else 0.0
    if not math.isfinite(m):
        bad = int((~torch.isfinite(arr)).sum())
        _INT8_SATURATED.inc(bad)
        arr = torch.nan_to_num(arr, nan=0.0, posinf=_I8_SAT_MAX, neginf=-_I8_SAT_MAX)
        m = float(arr.abs().max())
    scale = m / 127.0 if m > 0.0 else 1.0
    q = torch.round(arr / float(np.float32(scale))).to(torch.int8)
    return scale, q, arr


def int8_roundtrip(value: torch.Tensor) -> torch.Tensor:
    """What the receiver sees after an int8 wire round trip; the worker's
    error feedback carries ``value - int8_roundtrip(value)`` into the next
    round's chunk."""
    scale, q, _ = quantize_int8(value)
    return q.to(torch.float32) * float(np.float32(scale))
