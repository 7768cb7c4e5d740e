"""Ring allreduce-sum over n virtual ranks on one card (K3).

Counterpart of ``akka_allreduce_tpu/ops/ring.py``. The TPU kernel
(``pallas_ring_allreduce_sum`` / ``_ring_kernel``) runs on every chip of an
ICI ring and moves each hop by remote DMA. Here the n ranks are the rows of
one ``(n, data)`` stack on one card, and one kernel launch runs every rank's
schedule (``csrc/ring.cu``, hand-written CUDA C++ for ``sm_90a``):

- **What it computes**: per bucket of ``n * seg_rows * 128`` floats, the
  TPU kernel's reduce-scatter then all-gather, 2(n-1) steps, two receive
  slots per rank with back-pressure, optional bf16 or int8 hops (int8 with
  one f32 scale per segment; the owner requantizes its reduced segment at the
  turn and every gather hop requantizes what it forwards).
- **What bounds it**: HBM bytes (the stack read once, the result written
  once: ``2 * n * padded * 4`` bytes). A bucket's working set stays in L2, so
  the schedule's extra passes cost hand-shakes more than bytes.
- **Design**: each rank is a group of CTAs, CTA c owning one column slice
  of every segment; a hop is a push into the right neighbour's receive slot
  followed by a release-store of a step-tagged "ready" flag, and consumed
  slots are handed back with a "free" flag (the capacity semaphore). The
  grid is launched cooperatively so every CTA is resident, and every spin is
  bounded (a hung protocol traps instead of hanging). See ``csrc/ring.cu``.

The padding to whole buckets and the one-launch-per-bucket split follow the
TPU wrapper. ``interpret``, ``detect_races`` and ``collective_id`` have no
counterpart and are dropped: there is no interpreter (the CPU takes the plain
version), no race detector (the protocol's waits are bounded instead), and
no other collective kernel shares flag words with this one.

Beside the kernel is its plain PyTorch version,
``ring_kernel_allreduce_sum_reference``: it emulates ``_ring_kernel`` step by
step over the stack, vectorised over buckets and ranks, in the same
arithmetic order. A CUDA tensor takes the kernel or raises; a CPU tensor
takes the plain version. ``LAUNCHES["ring_allreduce"]`` counts kernel
launches (one per bucket).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from akka_allreduce_tpu_torch._device import use_kernel
from akka_allreduce_tpu_torch.ops import _build

LANE = 128
_DEF_SEG_ROWS = 512  # per-step transfer: 512 * 128 fp32 = 256 KB
COMPRESS_MODES = (None, "bf16", "int8")

LAUNCHES = {"ring_allreduce": 0}

_LIB = "ring"
_MODE = {None: 0, "bf16": 1, "int8": 2}
_WIRE = {None: torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_ARGTYPES = {
    # mode, n, seg, device, *ctas, *width
    "akka_ring_plan": [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
    ],
    # mode, x, out, slots, scales, flags, amax, arrive, error,
    # n, buckets, seg, stride, ctas, width, device, stream
    "akka_ring_allreduce": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p,
    ],
}


def _kernel(fn: str):
    lib = _build.load(_LIB)
    entry = getattr(lib, fn)
    if entry.argtypes is None:
        entry.argtypes = _ARGTYPES[fn]
        entry.restype = ctypes.c_int
    return lib, entry


# -- int8 wire format -------------------------------------------------------------


# f32(1/127): XLA folds the JAX package's ``amax / 127.0`` into a product
# with this constant (the compiled HLO shows ``multiply``, not ``divide``)
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _quantize(
    seg: torch.Tensor, dim: int | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 quantization with one scale over ``dim`` (keepdim), or over all
    of ``seg`` when ``dim`` is None (a 0-d scale)."""
    a = seg.abs()
    amax = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax * _INV127, torch.ones_like(amax))
    # scale is a tensor on seg's device, so this is a true division (PyTorch's
    # CUDA division by a Python scalar would multiply by its reciprocal)
    q = torch.clamp(torch.round(seg / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_quantize(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-segment max-abs int8 quantization: ``(q, scale)``.

    The int8 wire formula, shared by K3, its plain version and the XLA-style
    ring (``comm.allreduce._compress_seg``): ``scale = max|seg| * f32(1/127)``
    (XLA's folding of the JAX package's ``max|seg| / 127``; 1 for an all-zero
    segment, so dequantizing never divides by zero) and
    ``q = clip(round(seg / scale), -127, 127)`` with a true division and ties
    to even."""
    return _quantize(seg, None)


def _wire_roundtrip(seg: torch.Tensor, compress: str | None) -> torch.Tensor:
    """What the receiver reconstructs from a hop of ``seg`` (..., seg): the
    float32 value itself, its bf16 cast, or int8 with one scale per row."""
    if compress is None:
        return seg
    if compress == "bf16":
        return seg.to(torch.bfloat16).to(torch.float32)
    q, scale = _quantize(seg, -1)
    return q.to(torch.float32) * scale


# -- K3: ring allreduce-sum ---------------------------------------------------------


def _check_ring(xs: torch.Tensor, seg_rows: int, compress: str | None) -> int:
    """Validate the stack and options; returns the rank count n."""
    if not isinstance(xs, torch.Tensor):
        raise TypeError("xs must be a torch tensor")
    if xs.ndim != 2 or xs.shape[0] == 0:
        raise ValueError(f"xs must be (n, data) with n >= 1, got {tuple(xs.shape)}")
    if compress not in COMPRESS_MODES:
        raise ValueError(f"unknown compress mode {compress!r}")
    if not isinstance(seg_rows, int) or seg_rows < 1:
        raise ValueError(f"seg_rows must be a positive int, got {seg_rows!r}")
    return xs.shape[0]


def _buckets(n: int, data: int, seg_rows: int) -> tuple[int, int]:
    """``(bucket floats, bucket count)``: whole buckets of ``n`` segments."""
    bucket = n * seg_rows * LANE
    return bucket, max(1, -(-data // bucket))


def ring_kernel_allreduce_sum_reference(
    xs: torch.Tensor, *, seg_rows: int = _DEF_SEG_ROWS, compress: str | None = None
) -> torch.Tensor:
    """Plain PyTorch K3: the TPU kernel's schedule, step by step, over the
    ``(n, data)`` stack, all buckets and ranks at once. Returns the
    ``(n, data)`` per-rank results (a new tensor)."""
    n = _check_ring(xs, seg_rows, compress)
    if n == 1:
        return xs.clone()
    data = xs.shape[1]
    bucket, n_buckets = _buckets(n, data, seg_rows)
    seg = seg_rows * LANE
    # (rank, bucket, segment, element); F.pad copies, so xs is never written
    out = F.pad(xs, (0, n_buckets * bucket - data)).reshape(n, n_buckets, n, seg)
    if out.data_ptr() == xs.data_ptr():
        out = out.clone()
    ranks = torch.arange(n, device=xs.device)
    for s in range(2 * (n - 1)):
        rs = s < n - 1
        sp = s - (n - 1)
        send_idx = (ranks - s if rs else ranks + 1 - sp) % n
        recv_idx = (ranks - s - 1 if rs else ranks - sp) % n
        if compress is not None and s == n - 1:
            # entering the gather: the owner requantizes its reduced segment
            own = (ranks + 1) % n
            out[ranks, :, own] = _wire_roundtrip(out[ranks, :, own], compress)
        # rank r receives what rank r-1 sent, as the receiver decodes it
        recv = torch.roll(_wire_roundtrip(out[ranks, :, send_idx], compress), 1, 0)
        if rs:
            out[ranks, :, recv_idx] = out[ranks, :, recv_idx] + recv
        else:
            out[ranks, :, recv_idx] = recv
    return out.reshape(n, -1)[:, :data]


def ring_kernel_allreduce_sum(
    xs: torch.Tensor, *, seg_rows: int = _DEF_SEG_ROWS, compress: str | None = None
) -> torch.Tensor:
    """Ring-allreduce ``sum`` over the ranks (rows) of ``xs``.

    Args:
      xs: ``(n, data)`` float32, one row per virtual rank; never written.
      seg_rows: segment height in 128-float rows; a bucket is
        ``n * seg_rows * 128`` floats per rank, and data is zero-padded to
        whole buckets, one kernel launch each.
      compress: None, ``"bf16"`` or ``"int8"``: the wire format of every hop.
    Returns:
      ``(n, data)``: row r is rank r's result, the sum over ranks (under
      int8 the rows agree to about 1 ulp, as on the TPU).
    """
    n = _check_ring(xs, seg_rows, compress)
    if n == 1:
        return xs.clone()
    if not use_kernel(xs):
        return ring_kernel_allreduce_sum_reference(
            xs, seg_rows=seg_rows, compress=compress
        )
    if xs.dtype != torch.float32:
        raise TypeError(f"the ring kernel takes float32 only, got {xs.dtype}")
    if not xs.is_contiguous():
        raise ValueError("xs must be contiguous")
    data = xs.shape[1]
    bucket, n_buckets = _buckets(n, data, seg_rows)
    padded = n_buckets * bucket
    seg = seg_rows * LANE
    dev = xs.device
    if padded != data:
        src = out = F.pad(xs, (0, padded - data))  # a new tensor: run in place
    else:
        src, out = xs, torch.empty_like(xs)  # the kernel copies xs into out
    mode = _MODE[compress]
    lib, plan = _kernel("akka_ring_plan")
    ctas, width = ctypes.c_int(), ctypes.c_int64()
    _build.check(lib, plan(mode, n, seg, dev.index, ctypes.byref(ctas),
                           ctypes.byref(width)), "ring kernel plan")
    c = ctas.value
    slots = torch.empty((n, 2, seg), dtype=_WIRE[compress], device=dev)
    # ready and free flags, then one error word
    flags = torch.zeros(2 * n * c * 2 + 1, dtype=torch.int32, device=dev)
    scales = amax = arrive = 0  # null: only the int8 kernel reads them
    if compress == "int8":
        int8_scales = torch.empty(n * c * 2, dtype=torch.float32, device=dev)
        phases = n_buckets * n * (2 * (n - 1) + 1)
        stats = torch.zeros(2 * phases, dtype=torch.int32, device=dev)
        scales = int8_scales.data_ptr()
        amax, arrive = stats.data_ptr(), stats.data_ptr() + 4 * phases
    _, launch = _kernel("akka_ring_allreduce")
    rc = launch(
        mode, src.data_ptr(), out.data_ptr(), slots.data_ptr(),
        scales, flags.data_ptr(), amax, arrive,
        flags.data_ptr() + 4 * (flags.numel() - 1),
        n, n_buckets, seg, padded, c, width.value, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "ring allreduce kernel launch")
    LAUNCHES["ring_allreduce"] += n_buckets
    return out if padded == data else out[:, :data]
