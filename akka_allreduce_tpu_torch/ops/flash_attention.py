"""Flash attention (K4), forward and backward, hand-written for Hopper.

Counterpart of the flash branch of ``akka_allreduce_tpu/ops/local_attention.py``
(``local_attention``, which calls the library Pallas TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` with 512 blocks, and
differentiates it through the kernel's custom VJP). The kernels are CUDA C++
for ``sm_90a``:

- **Forward**: ``softmax(Q K^T * scale, causal or not) V`` per (batch,
  head), with the scores, the running max and sum and the output
  accumulator in f32, the output in the input dtype, and the row statistic
  ``lse = m + log(l)`` (B, H, T) f32 from the same launch. A fixed dispatch
  by dtype (:func:`forward_kernel`), the same for every D the gate admits:
  bf16 goes to ``csrc/flash_attention_wgmma.cu``, designed for Hopper (one
  CTA per 128 query rows, a TMA producer warpgroup and two ``wgmma``
  consumer warpgroups, K/V through a ring of ``mbarrier`` stages, exp2
  softmax); f32 goes to ``csrc/flash_attention_3xtf32.cu``, designed for
  Hopper in split TF32 (one CTA per 128 query rows, two ``wgmma`` consumer
  warpgroups with thread 0 issuing the TMA loads, Q resident in shared
  memory, 64-key tiles up to D 128; P as the register A operand of
  ``O += P V`` against V's split written transposed, since TF32 ``wgmma``
  has no transposed operand). Both skip causal blocks above the diagonal.
- **Backward**: dQ, dK, dV from Q, K, V, O, dO and ``lse``, with
  ``di = sum(o * do, -1)``, in two deterministic kernels (no atomics): dQ,
  one CTA per block of queries looping over the key blocks, and dK/dV, one
  CTA per block of keys looping over the query blocks and the query heads
  of its GQA group. dK and dV come back in the compact (B, T, H_kv, D)
  shape. A fixed dispatch by dtype (:func:`backward_kernel`): bf16 goes to
  ``csrc/flash_attention_bwd_wgmma.cu``, designed for Hopper (two ``wgmma``
  consumer warpgroups a CTA, TMA tiles through a ring of ``mbarrier``
  stages, P and dS kept in registers as the A operand, and ``di`` taken
  from O and dO by the dQ kernel, which runs first); f32 goes to
  ``csrc/flash_attention_bwd_3xtf32.cu``, designed for Hopper on the same
  plan in split TF32 (each f32 operand a TF32 big part plus a TF32 small
  remainder, three TF32 ``wgmma`` products a product, as PyTorch's f32
  attention does it; two consumer warpgroups a CTA with a role each, one
  forming P and the other dS, with Q/dO or K/V held in registers up to
  D 128; the products over the stored rows computed transposed, since TF32
  ``wgmma`` has no transposed operand; ``di`` from O and dO in its dQ
  kernel too).
- **What bounds them**: operations. At the flagship shape (B 8, H 16, T 2048,
  D 128, causal) the forward's two products are 1.37e11 FLOP and the
  backward's five 3.44e11 FLOP, against 268 MB and 403 MB moved: far above
  the card's ridge in bf16. bf16 runs every product on the tensor cores
  through ``wgmma`` (P, and dS in the backward, rounded to bf16). f32 runs
  them on the tensor cores in split TF32 in both directions (an error of
  about 2^-21 of |a||b| a term, far inside the 1e-4 f32 parity; a single
  TF32 pass, at 2^-11, would break it).

:class:`FlashAttention` is the ``torch.autograd.Function`` that joins them,
and :func:`flash_attention` goes through it on every device: on the CPU both
directions take the plain versions (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_reference`); on the card both take the kernels or
raise. The kernels read the (B, T, H, D) layout in place (row strides passed
in, so a slice of a longer KV cache needs no copy) and grouped-query K/V in
their compact (B, T, H_kv, D) form. They cover every shape the flash gate
admits (``local_attention.flash_shapes_ok``: D a multiple of 32 up to 256,
T a multiple of 512; the kernels need T a multiple of 64, and rows
16-byte aligned, which TMA needs too); other shapes raise.
``LAUNCHES["flash_attention"]`` counts every forward launch,
``["flash_attention_wgmma"]`` those of the bf16 Hopper kernel among them and
``["flash_attention_3xtf32"]`` those of the f32 one;
``["flash_attention_bwd"]`` counts every backward launch,
``["flash_attention_bwd_wgmma"]`` those of the bf16 Hopper kernels among
them and ``["flash_attention_bwd_3xtf32"]`` those of the f32 ones.
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

LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0, "flash_attention_3xtf32": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
            "flash_attention_bwd_3xtf32": 0}

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p
# both forward entries: q, k, v, o, lse, B, T, H, H_kv, D,
# q/k/v/o batch strides, q/k/v/o row strides, scale, causal, device, stream
_FWD_ARGTYPES = [
    _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I64, _I64,
    *[_I64] * 8, ctypes.c_float, ctypes.c_int, ctypes.c_int, _PTR,
]
# the forward's entry in each source
_FWD_ENTRIES = {
    "flash_attention_wgmma": "akka_flash_attention_fwd_wgmma",
    "flash_attention_3xtf32": "akka_flash_attention_fwd_3xtf32",
}
# both backward entries: q, k, v, o, do, lse, di, dq, dk, dv, B, T, H, H_kv,
# D, q/k/v/o/do batch strides, q/k/v/o/do row strides, scale, causal,
# device, stream
_BWD_WGMMA_ARGTYPES = [
    *[_PTR] * 10, _I64, _I64, _I64, _I64, _I64,
    *[_I64] * 10, ctypes.c_float, ctypes.c_int, ctypes.c_int, _PTR,
]
# the backward's entry in each source
_BWD_ENTRIES = {
    "flash_attention_bwd_wgmma": "akka_flash_attention_bwd_wgmma",
    "flash_attention_bwd_3xtf32": "akka_flash_attention_bwd_3xtf32",
}


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


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _scores(q, k, causal: bool, scale: float):
    """f32 scaled scores (B, H, T, T) over GQA-expanded k, masked to -1e30,
    and the (T, T) visibility mask (None when not causal)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), repeat_kv(k, q.shape[2]).float())
    scores = scores * scale
    mask = None
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], 0, 0, q.device)
        scores = torch.where(mask[None, None], scores, _MASK_VALUE)
    return scores, mask


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
):
    """Plain PyTorch K4: dense f32 softmax attention over (B, T, H, D).

    Scores ``(q . k) * scale`` in f32, masked entries set to -1e30, the row
    max subtracted, masked p set to exactly 0, and the output divided by
    ``max(l, 1e-30)``, so a row with no visible key is zero (the
    blockwise path's rule). Output in ``q``'s dtype; with ``return_lse``
    also the (B, H, T) f32 row statistic ``m + log(l)`` (-inf for a row
    with no visible key).
    """
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    scores, mask = _scores(q, k, causal, scale)
    m = scores.amax(dim=-1)  # (B, H, T)
    p = torch.exp(scores - m[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, repeat_kv(v, q.shape[2]).float())
    out = (out / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]).to(q.dtype)
    return (out, m + torch.log(l)) if return_lse else out


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4 backward: ``(dq, dk, dv)``, dk and dv in the compact
    (B, T, H_kv, D) shape, each in its input's dtype.

    The equations of the library's ``mha_reference_bwd``, in f32:
    ``p = exp(s * scale - lse)`` (masked p exactly 0), ``dv = p^T do``,
    ``dp = do v^T``, ``di = sum(o * do, -1)``, ``ds = p (dp - di)``,
    ``dq = ds k * scale``, ``dk = ds^T q * scale``; dk and dv summed over
    each KV head's group of query heads. A row with no visible key has
    every p masked, so its gradients are zero (no NaN).
    """
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    scores, mask = _scores(q, k, causal, scale)
    p = torch.exp(scores - lse.float()[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, repeat_kv(v, h).float())
    di = (o.float() * dof).sum(dim=-1).transpose(1, 2)  # (B, H, T)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, repeat_kv(k, h).float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    if h_kv != h:  # query head i belongs to kv head i // (H / H_kv)
        dk = dk.reshape(b, t, h_kv, h // h_kv, d).sum(dim=3)
        dv = dv.reshape(b, t, h_kv, h // h_kv, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def forward_kernel(dtype: torch.dtype) -> str:
    """The source (``csrc/<name>.cu``) whose kernel runs K4's forward for
    this dtype: a fixed dispatch, not a fallback, the same at every D the
    gate admits (32 to 256, step 32). bf16 takes the Hopper kernel
    (``flash_attention_wgmma``: key tiles of 128 up to D 128, of 64 above);
    f32 takes ``flash_attention_3xtf32`` (split-TF32 ``wgmma``: key tiles of
    64 up to D 128, of 16 above)."""
    return ("flash_attention_wgmma" if dtype == torch.bfloat16
            else "flash_attention_3xtf32")


def backward_kernel(dtype: torch.dtype) -> str:
    """The source (``csrc/<name>.cu``) whose kernels run K4's backward for
    this dtype: a fixed dispatch, not a fallback, the same at every D the
    gate admits. Each is a dQ kernel that also writes ``di``, then a dK/dV
    kernel: bf16 takes ``flash_attention_bwd_wgmma`` (bf16 ``wgmma``), f32
    takes ``flash_attention_bwd_3xtf32`` (split-TF32 ``wgmma``)."""
    return ("flash_attention_bwd_wgmma" if dtype == torch.bfloat16
            else "flash_attention_bwd_3xtf32")


def _strides(t: torch.Tensor, what: str) -> tuple[int, int]:
    """(batch, row) strides in elements, as the kernels and their TMA maps
    take them: heads and D dense; row and batch strides multiples of 8
    elements and the base 16-byte aligned (TMA's rule: every row 16-byte
    aligned). A batch of one passes its rows' span as its stride, since
    PyTorch may give a size-1 dim any stride and TMA wants a multiple of
    16 bytes."""
    b, t_len, _, d = t.shape
    if t.stride(3) != 1 or t.stride(2) != d:
        raise ValueError(f"{what}: heads and D must be contiguous, strides {t.stride()}")
    row = t.stride(1)
    batch = t.stride(0) if b > 1 else t_len * row
    if row % 8 or batch % 8 or t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned, strides {t.stride()}")
    return batch, row


def _check_kernel_shape(q: torch.Tensor, *others: torch.Tensor) -> None:
    """What both kernels cover; raises on the rest."""
    t, d = q.shape[1], q.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got {q.dtype}")
    if d % 32 or not 32 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel covers D in 32..{MAX_HEAD_DIM} "
                         f"step 32, got D={d}")
    if t % 64 or t == 0:
        raise ValueError(f"the flash kernel needs T a multiple of 64, got T={t}")
    if not all(x.is_cuda and x.device == q.device for x in others):
        raise ValueError("q, k and v must lie on one CUDA device")


def _entry(lib_name: str, fn_name: str, argtypes: list):
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _forward(q, k, v, causal: bool, scale: float):
    """K4's forward on the card: ``(out, lse)``, from the kernel
    :func:`forward_kernel` names."""
    _check_kernel_shape(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    (qb, qt), (kb, kt), (vb, vt), (ob, ot) = (
        _strides(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))
    )
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, t, h, k.shape[2], d, qb, kb, vb, ob, qt, kt, vt, ot,
        float(scale), int(bool(causal)), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = forward_kernel(q.dtype)
    lib, fn = _entry(name, _FWD_ENTRIES[name], _FWD_ARGTYPES)
    _build.check(lib, fn(*args), "flash attention kernel launch")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[name] += 1
    return out, lse


def _backward(q, k, v, o, lse, do, causal: bool, scale: float):
    """K4's backward on the card: ``(dq, dk, dv, di)`` from the kernels
    :func:`backward_kernel` names, ``di = sum(o * do, -1)`` (B, H, T) f32 as
    the dQ kernel wrote it."""
    _check_kernel_shape(q, k, v, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be {tuple(q.shape)}, got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    b, t, h, d = q.shape
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {t}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    o = o.to(q.dtype).contiguous()
    do = do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    if lse.data_ptr() % 16:
        raise ValueError("lse must be 16-byte aligned")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    (qb, qt), (kb, kt), (vb, vt), (ob, ot), (db, dt) = (
        _strides(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do"))
    )
    di = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    name = backward_kernel(q.dtype)
    lib, fn = _entry(name, _BWD_ENTRIES[name], _BWD_WGMMA_ARGTYPES)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, h, k.shape[2], d, qb, kb, vb, ob, db, qt, kt, vt, ot, dt,
        float(scale), int(bool(causal)), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash attention backward kernel launch")
    LAUNCHES["flash_attention_bwd"] += 1
    LAUNCHES[name] += 1
    return dq, dk, dv, di


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's backward: ``(dq, dk, dv)`` from the forward's inputs, its output
    ``o`` and row statistic ``lse`` (B, H, T) f32, and the output gradient
    ``do``; dk and dv in the compact (B, T, H_kv, D) shape, all in the input
    dtype.

    On a CUDA tensor it launches the backward kernels :func:`backward_kernel`
    names or raises (the forward's coverage); ``o`` and ``do`` are made dense
    in heads and D first, since autograd may hand over any layout. On a CPU
    tensor it runs the plain version.
    """
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    if not use_kernel(q):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                             sm_scale=scale)
    return _backward(q, k, v, o, lse, do, causal, scale)[:3]


class FlashAttention(torch.autograd.Function):
    """K4 as a differentiable op: the forward saves q, k, v, o and lse, the
    backward calls :func:`flash_attention_bwd`. On the CPU both directions
    take the plain versions; on the card both take the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if use_kernel(q):
            out, lse = _forward(q, k, v, causal, scale)
        else:
            out, lse = flash_attention_reference(q, k, v, causal=causal,
                                                 sm_scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=ctx.causal,
                                         sm_scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Flash attention over (B, T, H, D) ``q`` and (B, T, H_kv, D) ``k``/``v``
    (H_kv dividing H); returns (B, T, H, D) in ``q``'s dtype, differentiable
    through :class:`FlashAttention`.

    On a CUDA tensor it launches K4 (and K4's backward when differentiated)
    or raises: dtypes other than f32 and bf16, D not a multiple of 32 or
    above 256, T not a multiple of 64 and rows not 16-byte aligned are not
    covered. bf16 runs the Hopper kernels (``wgmma``, TMA, ``mbarrier``
    pipelines) in both directions at every covered D; f32 runs the split-TF32
    Hopper kernels in both directions (:func:`forward_kernel`,
    :func:`backward_kernel`). On a CPU tensor it runs the plain versions.
    """
    _check(q, k, v)
    return FlashAttention.apply(q, k, v, bool(causal), _scale(q, sm_scale))
