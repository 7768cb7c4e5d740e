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
  turn and every gather hop requantizes what it forwards). An optional
  per-rank ``valid`` mask multiplies each row as it is first read.
- **What bounds it**: HBM bytes, the stack read once and the result written
  once: ``2 * n * data * 4`` bytes.
- **Design**: the TPU kernel's shape on a thread-block cluster. A cluster is
  the n ranks of one column slice (one CTA a rank up to 16 ranks, several
  above); a hop is ``st.async`` into the right neighbour's receive slot in
  its shared memory, completing its "full" mbarrier, and the receiver hands
  the slot back by a remote arrive on the sender's "empty" one. Partial sums
  stay in registers and shared memory, so x is read once and the result
  written once. Persistent clusters walk (bucket, column slice) items in one
  launch; the ragged tail is read as zeros and never written, so nothing is
  padded. An int8 segment wider than one item is shared by a team of
  co-resident clusters that agree on its scale through a global word. Every
  wait is bounded (a hung protocol traps instead of hanging).

``interpret``, ``detect_races`` and ``collective_id`` have no counterpart and
are dropped: there is no interpreter (the CPU takes the plain version), no
race detector (the protocol's waits are bounded instead), and no other
collective kernel shares its barriers.

Beside the kernel is its plain PyTorch version,
``ring_kernel_allreduce_sum_reference``: it masks the stack, pads it to whole
buckets and emulates ``_ring_kernel`` step by step, vectorised over buckets
and ranks, in the same arithmetic order. A CUDA tensor takes the kernel or
raises; a CPU tensor takes the plain version. ``LAUNCHES["ring_allreduce"]``
counts kernel launches (one a call).
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
_ARGTYPES = {
    # mode, n, seg, buckets, device, *out (7 int64)
    "akka_ring_plan": [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ],
    # mode, x, out, valid, words, error, n, data, buckets, seg, vec, device,
    # stream
    "akka_ring_allreduce": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
}
PLAN_KEYS = ("ranks_per_cta", "cluster", "clusters", "width", "chunks", "team",
             "smem_bytes")


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


def _check_valid(valid: torch.Tensor | None, xs: torch.Tensor) -> None:
    """``valid`` is None or an ``(n,)`` float32 mask on xs's device."""
    if valid is None:
        return
    if not isinstance(valid, torch.Tensor):
        raise TypeError("valid must be a torch tensor or None")
    if valid.shape != (xs.shape[0],) or valid.dtype != torch.float32:
        raise ValueError(
            f"valid must be ({xs.shape[0]},) float32, got {tuple(valid.shape)} "
            f"{valid.dtype}"
        )
    if valid.device != xs.device:
        raise ValueError(f"valid is on {valid.device}, xs on {xs.device}")


def _buckets(n: int, data: int, seg_rows: int) -> tuple[int, int]:
    """``(bucket floats, bucket count)``: whole buckets of ``n`` segments."""
    bucket = n * seg_rows * LANE
    return bucket, max(1, -(-data // bucket))


def ring_kernel_allreduce_sum_reference(
    xs: torch.Tensor,
    *,
    seg_rows: int = _DEF_SEG_ROWS,
    compress: str | None = None,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch K3: ``xs * valid[:, None]`` (when a mask is given), then
    the TPU kernel's schedule, step by step, over the stack zero-padded to
    whole buckets, all buckets and ranks at once. Returns the ``(n, data)``
    per-rank results (a new tensor)."""
    n = _check_ring(xs, seg_rows, compress)
    _check_valid(valid, xs)
    if valid is not None:
        xs = xs * valid[:, None]
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


def ring_plan(
    n: int, *, data: int, seg_rows: int = _DEF_SEG_ROWS,
    compress: str | None = None, device: torch.device | int = 0,
) -> dict:
    """How the kernel would launch for an ``(n, data)`` stack on a CUDA
    device: ranks per CTA, CTAs per cluster, clusters in the grid, columns
    per work item, work items per bucket, the int8 team size (clusters that
    agree on one segment's scale; 1 when a CTA holds the whole segment or
    there is no int8) and dynamic shared memory bytes. Needs the card."""
    if compress not in COMPRESS_MODES:
        raise ValueError(f"unknown compress mode {compress!r}")
    if n < 2:
        raise ValueError(f"the kernel runs for n >= 2 ranks, got {n}")
    dev = torch.device("cuda", device) if isinstance(device, int) else device
    _, n_buckets = _buckets(n, data, seg_rows)
    lib, plan = _kernel("akka_ring_plan")
    out = (ctypes.c_int64 * len(PLAN_KEYS))()
    _build.check(lib, plan(_MODE[compress], n, seg_rows * LANE, n_buckets,
                           dev.index or 0, out), "ring kernel plan")
    return dict(zip(PLAN_KEYS, out))


def ring_kernel_allreduce_sum(
    xs: torch.Tensor,
    *,
    seg_rows: int = _DEF_SEG_ROWS,
    compress: str | None = None,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ring-allreduce ``sum`` over the ranks (rows) of ``xs``.

    Args:
      xs: ``(n, data)`` float32, one row per virtual rank; never written.
      seg_rows: segment height in 128-float rows; a bucket is
        ``n * seg_rows * 128`` floats per rank, the ragged last one read as
        if zero-padded. The whole stack is one kernel launch.
      compress: None, ``"bf16"`` or ``"int8"``: the wire format of every hop.
      valid: optional ``(n,)`` float32 per-rank mask; row r enters the sum
        as ``xs[r] * valid[r]``.
    Returns:
      ``(n, data)``: row r is rank r's result, the sum over ranks (under
      int8 the rows agree to about 1 ulp, as on the TPU).
    """
    n = _check_ring(xs, seg_rows, compress)
    _check_valid(valid, xs)
    if n == 1 or not use_kernel(xs):
        return ring_kernel_allreduce_sum_reference(
            xs, seg_rows=seg_rows, compress=compress, valid=valid
        )
    if xs.dtype != torch.float32:
        raise TypeError(f"the ring kernel takes float32 only, got {xs.dtype}")
    if not xs.is_contiguous():
        raise ValueError("xs must be contiguous")
    data = xs.shape[1]
    _, n_buckets = _buckets(n, data, seg_rows)
    dev = xs.device
    out = torch.empty_like(xs)
    # the int8 team's (max, count) words, then one error word
    words = n_buckets * n * (2 * n - 1) * 4 if compress == "int8" else 0
    sync_words = torch.zeros(words + 1, dtype=torch.int32, device=dev)
    if valid is not None:
        valid = valid.contiguous()
    vec = data % 4 == 0 and xs.data_ptr() % 16 == 0
    lib, launch = _kernel("akka_ring_allreduce")
    rc = launch(
        _MODE[compress], xs.data_ptr(), out.data_ptr(),
        0 if valid is None else valid.data_ptr(),
        sync_words.data_ptr(), sync_words.data_ptr() + 4 * words,
        n, data, n_buckets, seg_rows * LANE, int(vec), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "ring allreduce kernel launch")
    LAUNCHES["ring_allreduce"] += 1
    return out
