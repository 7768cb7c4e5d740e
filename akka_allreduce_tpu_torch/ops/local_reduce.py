"""Fused single-card threshold-reduce kernels.

Counterpart of ``akka_allreduce_tpu/ops/local_reduce.py``. K worker payloads
stacked as ``(K, data)`` are masked-summed, counted, divided and, for elastic
averaging, folded back into every replica.

Two kernels, hand-written in CUDA C++ for Hopper (``csrc/local_reduce.cu``):

- **K1 ``masked_average``** replaces ``_masked_average_impl`` /
  ``_avg_kernel`` of the JAX package. Bound: HBM bytes, X read once plus
  ``data`` floats written. Design: each thread streams 4 contiguous columns
  (16-byte loads) down all K rows with every load in flight at once, and
  accumulates in k order; the count is summed on the device.
- **K2 ``elastic_average_step``** replaces ``_elastic_step_tiled_impl`` /
  ``_elastic_kernel``. Bound: HBM bytes, X read once and written once.
  Design: the K values of a column stay in registers between the sum and the
  update (K <= 32; a second read above that), so one pass does what XLA
  needed two for; the ``count > 0`` gate is decided in the kernel, so the
  host never syncs. It updates ``x`` in place, as the TPU kernel aliased its
  input (``input_output_aliases={0: 0}``).

Beside each kernel is its plain PyTorch version (``*_reference``): the CPU
path and the yardstick the card is held against, never the card's path. A
CUDA tensor takes the kernel or raises; a CPU tensor takes the plain
version. ``LAUNCHES`` counts kernel launches, one per call that reached a
kernel, so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes

import torch

from akka_allreduce_tpu_torch._device import use_kernel
from akka_allreduce_tpu_torch.ops import _build

LANE = 128
_DEF_ROWS = 512  # the JAX package's tile height; only shapes depend on it

LAUNCHES = {"masked_average": 0, "elastic_average_step": 0}

_LIB = "local_reduce"
_ARGTYPES = {
    # x, valid, avg, count, k, data, device, stream
    "akka_masked_average": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ],
    # x, valid, alpha, k, data, device, stream
    "akka_elastic_average_step": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ],
}


def _kernel(fn: str):
    lib = _build.load(_LIB)
    entry = getattr(lib, fn)
    if entry.argtypes is None:
        entry.argtypes = _ARGTYPES[fn]
        entry.restype = ctypes.c_int
    return lib, entry


def _check_stack(x: torch.Tensor, valid: torch.Tensor) -> int:
    """Validate ``x`` (K, ...) against ``valid`` (K,); returns K."""
    if not isinstance(x, torch.Tensor) or not isinstance(valid, torch.Tensor):
        raise TypeError("x and valid must be torch tensors")
    if x.ndim < 2 or x.shape[0] == 0:
        raise ValueError(f"x must be (K, ...) with K >= 1, got {tuple(x.shape)}")
    if valid.shape != (x.shape[0],):
        raise ValueError(
            f"valid must be ({x.shape[0]},) for x {tuple(x.shape)}, "
            f"got {tuple(valid.shape)}"
        )
    return x.shape[0]


def _check_card(x: torch.Tensor, valid: torch.Tensor) -> None:
    """What the kernels take: float32, contiguous, both on one card."""
    if x.dtype != torch.float32 or valid.dtype != torch.float32:
        raise TypeError(
            f"the CUDA kernels take float32 only, got x {x.dtype}, "
            f"valid {valid.dtype}"
        )
    if valid.device != x.device:
        raise ValueError(f"valid is on {valid.device}, x on {x.device}")
    if not x.is_contiguous() or not valid.is_contiguous():
        raise ValueError("x and valid must be contiguous")


# -- K1: masked average ---------------------------------------------------------


def masked_average_reference(
    x: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``(avg, count)`` with the sum taken in k order."""
    k = _check_stack(x, valid)
    v = valid.to(x.dtype)
    count = v.sum()
    rows = x.reshape(k, -1)
    total = rows[0] * v[0]
    for i in range(1, k):
        total = total + rows[i] * v[i]
    return total / torch.clamp_min(count, 1.0), count


def masked_average(
    x: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-pass threshold reduce of K stacked payloads.

    Args:
      x: ``(K, data)`` float payloads (one row per virtual worker).
      valid: ``(K,)`` 0/1 contribution mask.
    Returns:
      ``(avg, count)``: ``avg[i] = sum_k v_k x_k[i] / max(count, 1)`` of shape
      ``(data,)`` and ``count = sum_k v_k`` as a 0-d tensor on x's device.
    """
    k = _check_stack(x, valid)
    if x.ndim != 2:
        raise ValueError(f"x must be (K, data), got {tuple(x.shape)}")
    if not use_kernel(x):
        return masked_average_reference(x, valid)
    _check_card(x, valid)
    data = x.shape[1]
    avg = torch.empty(data, dtype=x.dtype, device=x.device)
    count = torch.empty((), dtype=x.dtype, device=x.device)
    lib, fn = _kernel("akka_masked_average")
    rc = fn(
        x.data_ptr(), valid.data_ptr(), avg.data_ptr(), count.data_ptr(),
        k, data, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "masked_average kernel launch")
    LAUNCHES["masked_average"] += 1
    return avg, count


# -- K2: elastic averaging step -------------------------------------------------


def elastic_average_step_reference(
    x: torch.Tensor, valid: torch.Tensor, alpha: float | torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch K2 (out of place): ``keep * x + pull * avg`` with
    ``(keep, pull) = (1 - alpha, alpha)`` if anyone contributed, else (1, 0),
    both taken in x's dtype as the JAX kernel takes them."""
    avg, count = masked_average_reference(x, valid)
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    keep = torch.where(count > 0, 1.0 - a, torch.ones_like(a))
    pull = torch.where(count > 0, a, torch.zeros_like(a))
    return keep * x + pull * avg.reshape(x.shape[1:])


def pack_tiles(x: torch.Tensor, rows: int = _DEF_ROWS) -> torch.Tensor:
    """(K, data) -> (K, T, LANE), zero-padding data to a multiple of
    ``rows * LANE`` (at least one tile), the JAX package's tiled layout.

    A view of ``x`` when no padding is needed, else a new tensor. The kernels
    read the tiled form as the flat ``(K, T * LANE)`` memory it is."""
    k, data = x.shape
    tile = rows * LANE
    padded = max(1, -(-data // tile)) * tile
    if padded != data:
        x = torch.nn.functional.pad(x, (0, padded - data))
    return x.reshape(k, padded // LANE, LANE)


def unpack_tiles(xt: torch.Tensor, data: int) -> torch.Tensor:
    """(K, T, LANE) -> (K, data): inverse of :func:`pack_tiles` (a view)."""
    return xt.reshape(xt.shape[0], -1)[:, :data]


def elastic_average_step(
    x: torch.Tensor,
    valid: torch.Tensor,
    alpha: float | torch.Tensor,
    *,
    rows: int = _DEF_ROWS,
) -> torch.Tensor:
    """Fused elastic-averaging round over K local replicas, one HBM pass.

    ``x' = (1-alpha) * x + alpha * avg`` where ``avg`` is the threshold-masked
    contributor average; if no replica contributed (``sum(valid) == 0``) the
    state is unchanged. ``x`` is ``(K, data)`` or the pre-tiled
    ``(K, m*rows, LANE)`` form of :func:`pack_tiles`; any other 3-D shape
    raises ``ValueError``.

    **The caller's tensor is overwritten**: the update is written into ``x``
    in place and ``x`` itself is returned, as the TPU kernel aliased its
    input to its output. Clone first to keep the old state.

    ``alpha`` is a Python float, or a tensor that is not on the card (a card
    scalar would make the host wait for it).
    """
    k = _check_stack(x, valid)
    if x.ndim == 3:
        if x.shape[2] != LANE or x.shape[1] % rows:
            raise ValueError(
                f"tiled input must be (K, m*{rows}, {LANE}), got {tuple(x.shape)}"
            )
    elif x.ndim != 2:
        raise ValueError(f"x must be (K, data) or tiled, got {tuple(x.shape)}")
    if not use_kernel(x):
        return x.copy_(elastic_average_step_reference(x, valid, alpha))
    _check_card(x, valid)
    if isinstance(alpha, torch.Tensor) and alpha.is_cuda:
        raise ValueError(
            "alpha must be a Python float or a CPU tensor: reading a card "
            "scalar would make the host wait for the card"
        )
    data = x.numel() // k
    lib, fn = _kernel("akka_elastic_average_step")
    rc = fn(
        x.data_ptr(), valid.data_ptr(), float(alpha), k, data, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "elastic_average_step kernel launch")
    LAUNCHES["elastic_average_step"] += 1
    return x
