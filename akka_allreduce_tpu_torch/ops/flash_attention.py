"""Flash-attention forward (K4), hand-written for Hopper.

Counterpart of the flash branch of ``akka_allreduce_tpu/ops/local_attention.py``
(``local_attention``, which calls the library Pallas TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` with 512 blocks). The
kernel is ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``:

- **What it computes**: ``softmax(Q K^T * scale, causal or not) V`` per
  (batch, head), with the scores, the running max and sum and the output
  accumulator in f32, and the output in the input dtype (f32 or bf16).
- **What bounds it**: operations. At the flagship shape (B 8, H 16, T 2048,
  D 128, causal) the two products are 1.37e11 FLOP against 268 MB of
  Q, K, V and O: far above the card's ridge in bf16.
- **Design**: one CTA per (b, h, block of 64 query rows), four warps of 16
  rows each; K and V tiles staged through shared memory; the online
  softmax over key blocks, skipping the blocks wholly above the diagonal
  under causal masking. bf16 runs both products on the tensor cores
  (``mma.sync`` m16n8k16, P rounded to bf16 for the PV product); f32 runs
  them as f32 FMAs, never TF32. See the source for the details.

The kernel reads the (B, T, H, D) layout in place (row strides passed in,
so a slice of a longer KV cache needs no copy) and grouped-query K/V in
their compact (B, T, H_kv, D) form. It covers every shape the flash gate
admits (``local_attention.flash_shapes_ok``: D a multiple of 32 up to 256,
T a multiple of 512); other shapes raise.

Beside the kernel is :func:`flash_attention_reference`, its plain PyTorch
version: dense f32 softmax attention with the same masking constants. A
CUDA tensor takes the kernel or raises; a CPU tensor takes the plain
version. ``LAUNCHES["flash_attention"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from akka_allreduce_tpu_torch._device import use_kernel
from akka_allreduce_tpu_torch.ops import _build
from akka_allreduce_tpu_torch.ops.ring_attention import (
    _MASK_VALUE,
    causal_mask,
    repeat_kv,
)

LAUNCHES = {"flash_attention": 0}

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = "flash_attention"
# dtype, q, k, v, o, B, T, H, H_kv, D,
# q/k/v/o batch strides, q/k/v/o row strides, scale, causal, device, stream
_ARGTYPES = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int64,
    *[ctypes.c_int64] * 8,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Shapes every path accepts: (B, T, H, D) q over (B, T, H_kv, D) k/v."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"{name} must be a (B, T, H, D) tensor")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        raise ValueError(
            f"k and v must be (B, T, H_kv, D) like q {tuple(q.shape)}, got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"H={h} not divisible by kv heads {k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch K4: dense f32 softmax attention over (B, T, H, D).

    Scores ``(q . k) * scale`` in f32, masked entries set to -1e30, the row
    max subtracted, masked p set to exactly 0, and the output divided by
    ``max(l, 1e-30)``, so a row with no visible key is zero (the
    blockwise path's rule). Output in ``q``'s dtype.
    """
    _check(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    h = q.shape[2]
    kf, vf = repeat_kv(k, h).float(), repeat_kv(v, h).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = None
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], 0, 0, q.device)
        scores = torch.where(mask[None, None], scores, _MASK_VALUE)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    l = p.sum(dim=-1)  # (B, H, T)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _strides(t: torch.Tensor, what: str) -> tuple[int, int]:
    """(batch, row) strides in elements; heads and D must be dense."""
    d = t.shape[3]
    if t.stride(3) != 1 or t.stride(2) != d:
        raise ValueError(f"{what}: heads and D must be contiguous, strides {t.stride()}")
    if t.stride(1) % 8 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned, strides {t.stride()}")
    return t.stride(0), t.stride(1)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Flash-attention forward over (B, T, H, D) ``q`` and (B, T, H_kv, D)
    ``k``/``v`` (H_kv dividing H); returns (B, T, H, D) in ``q``'s dtype.

    On a CUDA tensor it launches K4 or raises: dtypes other than f32 and
    bf16, D not a multiple of 32 or above 256, and T not a multiple of 64
    are not covered. On a CPU tensor it runs the plain version.
    """
    _check(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel(q):
        return flash_attention_reference(q, k, v, causal=causal, sm_scale=scale)
    b, t, h, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got {q.dtype}")
    if d % 32 or not 32 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel covers D in 32..{MAX_HEAD_DIM} "
                         f"step 32, got D={d}")
    if t % 64 or t == 0:
        raise ValueError(f"the flash kernel needs T a multiple of 64, got T={t}")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    (qb, qt), (kb, kt), (vb, vt), (ob, ot) = (
        _strides(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))
    )
    lib = _build.load(_LIB)
    fn = lib.akka_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, t, h, k.shape[2], d,
        qb, kb, vb, ob, qt, kt, vt, ot,
        float(scale), int(bool(causal)), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash attention kernel launch")
    LAUNCHES["flash_attention"] += 1
    return out
