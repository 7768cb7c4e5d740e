"""The port's attention paths against the JAX package's, on the CPU.

Same seeded numpy inputs through ``akka_allreduce_tpu.ops`` (JAX on the
CPU, where ``local_attention`` takes the blockwise path for long sequences)
and ``akka_allreduce_tpu_torch.ops``:

- the five behaviours of ``tests/test_local_attention.py`` (blockwise vs
  dense, gradients, global offsets, zero rows, the dispatch), atol 2e-5 as
  there (gradients 3e-4), zero rows exact;
- the blockwise fold's checkpoint: what autograd saves at T 4096 against
  the score matrix, and gradients equal to the un-checkpointed loop's;
- K4's plain version against JAX ``local_attention`` at B 1, H 2,
  T 1024, D 32, causal and not: f32 within 2e-5, bf16 within 2e-2 (the two
  sides round the bf16 output of f32 sums taken in another order);
- K4's plain backward, through ``FlashAttention``, against ``jax.grad`` of
  JAX ``local_attention`` at that shape, causal and not, and with compact
  GQA K/V (H 4 over 2): f32 within 2e-5; and against torch autograd of the
  plain forward, with ``lse`` against ``torch.logsumexp``;
- which path ``local_attention`` takes for each shape and offset;
- the guards of the K4 wrapper that hold on every device, the forward's
  fixed dispatch by dtype and the stride rules of the kernels' TMA maps;
- the API at a negative or zero scale, against softmax written out densely;
- the f32 kernels' split-TF32 numerics, emulated: within 1e-5 of the plain
  forward, where one TF32 pass misses 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.ops import attention_reference as j_attention_reference
from akka_allreduce_tpu.ops import local_attention as j_local_attention
from akka_allreduce_tpu.ops.ring_attention import online_softmax_update as j_olm
from akka_allreduce_tpu.ops.ring_attention import repeat_kv as j_repeat_kv
from akka_allreduce_tpu_torch.ops import flash_attention as fa
from akka_allreduce_tpu_torch.ops import local_attention as la
from akka_allreduce_tpu_torch.ops import ring_attention as ra

ATOL = 2e-5


def _qkv(b=2, tq=96, tk=96, h=2, d=8, seed=0, h_kv=None):
    rng = np.random.default_rng(seed)
    h_kv = h if h_kv is None else h_kv
    return (
        rng.standard_normal((b, tq, h, d)).astype(np.float32),
        rng.standard_normal((b, tk, h_kv, d)).astype(np.float32),
        rng.standard_normal((b, tk, h_kv, d)).astype(np.float32),
    )


def _jax(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tk", [96, 100, 33])
def test_blockwise_matches_dense_and_jax(causal, tk):
    q, k, v = _qkv(tk=tk)
    want = np.asarray(j_attention_reference(*_jax(q, k, v), causal=causal))
    got = la.blockwise_attention(*_torch(q, k, v), causal=causal, block_k=32)
    dense = ra.attention_reference(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(dense.numpy(), want, atol=ATOL)


def test_blockwise_grads_match_jax_dense():
    q, k, v = _qkv(tq=64, tk=64)

    def jloss(q, k, v):
        return (j_attention_reference(q, k, v, causal=True) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(q, k, v))
    qt, kt, vt = (t.requires_grad_() for t in _torch(q, k, v))
    (la.blockwise_attention(qt, kt, vt, causal=True, block_k=16) ** 2).sum().backward()
    for a, b in zip(want, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=3e-4)


def _saved_mib(fn) -> float:
    """MiB that autograd saves for the backward while ``fn`` runs, each
    storage counted once."""
    sizes = {}

    def pack(t):
        st = t.untyped_storage()
        sizes[st.data_ptr()] = max(sizes.get(st.data_ptr(), 0), st.nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(sizes.values()) / 2**20


def test_blockwise_saves_far_less_than_the_score_matrix():
    """The block fold is checkpointed, as JAX's ``lax.scan`` step is: at B 1,
    H 2, T 4096, D 32, causal, block_k 512, the forward leaves autograd under
    a quarter of the (B, H, T, T) f32 score matrix (one carry and mask per
    block, O((T / block) * T * D)); keeping every block's scores and
    probabilities saved 3.2x the matrix."""
    b, t, h, d = 1, 4096, 2, 32
    q, k, v = (x.requires_grad_() for x in _torch(*_qkv(b=b, tq=t, tk=t, h=h, d=d, seed=11)))
    saved = _saved_mib(lambda: la.blockwise_attention(q, k, v, causal=True, block_k=512))
    scores = b * h * t * t * 4 / 2**20
    assert 0 < saved < scores / 4


def test_blockwise_checkpoint_leaves_gradients_unchanged(monkeypatch):
    """The checkpointed fold's gradients equal, bit for bit, those of the
    same loop with every block's intermediates kept."""
    q, k, v = _qkv(tq=64, tk=64, seed=12)

    def grads():
        qt, kt, vt = (t.requires_grad_() for t in _torch(q, k, v))
        (la.blockwise_attention(qt, kt, vt, causal=True, block_k=16) ** 2).sum().backward()
        return qt.grad, kt.grad, vt.grad

    got = grads()
    monkeypatch.setattr(la, "checkpoint", lambda fn, *args, **kw: fn(*args))
    for g, w in zip(got, grads()):
        assert torch.equal(g, w)


def test_blockwise_with_offsets_matches_windowed_dense():
    """Ring-attention-style global windows: q rows 64.., k rows 32.."""
    q, k, v = _qkv(tq=32, tk=32, seed=3)
    want = j_attention_reference(*_jax(q, k, v), causal=True, q_offset=64, k_offset=32)
    got = la.blockwise_attention(
        *_torch(q, k, v), causal=True, q_offset=64, k_offset=32, block_k=8
    )
    dense = ra.attention_reference(*_torch(q, k, v), causal=True, q_offset=64, k_offset=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), atol=ATOL)


def test_fully_masked_rows_are_zero():
    """A query window entirely before its key window gives zero rows."""
    q, k, v = _qkv(tq=8, tk=5, seed=7)
    out = la.blockwise_attention(
        *_torch(q, k, v), causal=True, q_offset=0, k_offset=32, block_k=4
    )
    assert torch.equal(out, torch.zeros_like(out))
    # K4's plain version: row 0 of a causal window sees key 0 alone, so it
    # is v's row 0, with nothing leaking in from the masked keys
    qt, kt, vt = _torch(*_qkv(tq=8, tk=8, seed=8))
    ref = fa.flash_attention_reference(qt, kt, vt, causal=True)
    torch.testing.assert_close(ref[:, 0], vt[:, 0], rtol=0, atol=1e-6)


def test_local_attention_dispatches_and_matches():
    # short: dense path; long: blockwise path (both sides) — same numbers
    q, k, v = _qkv(tq=64, tk=64, seed=5)
    want = j_attention_reference(*_jax(q, k, v), causal=True)
    got = la.local_attention(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    q, k, v = _qkv(tq=768, tk=768, h=1, d=8, seed=6)
    want = j_local_attention(*_jax(q, k, v), causal=True)
    got = la.local_attention(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_local_attention(causal, dtype):
    """K4's plain version vs JAX local_attention at a gated shape (JAX takes
    blockwise on the CPU); the port's local_attention dispatches to K4."""
    q, k, v = _qkv(b=1, tq=1024, tk=1024, h=2, d=32, seed=11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_local_attention(*(x.astype(jdt) for x in _jax(q, k, v)), causal=causal)
    tq, tk, tv = (x.to(tdt) for x in _torch(q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tdt
    via = la.local_attention(tq, tk, tv, causal=causal)
    assert torch.equal(via, got)
    tol = ATOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_flash_plain_reads_compact_gqa_kv():
    q, k, v = _qkv(b=1, tq=1024, tk=1024, h=4, d=32, seed=12, h_kv=2)
    jq, jk, jv = _jax(q, k, v)
    want = j_attention_reference(jq, j_repeat_kv(jk, 4), j_repeat_kv(jv, 4), causal=True)
    got = fa.flash_attention(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_local_attention_takes_each_path(monkeypatch):
    """dense for small score matrices, K4 on gated shapes with zero int
    offsets and Tq == Tk, blockwise otherwise."""
    calls = []
    monkeypatch.setattr(la, "flash_attention",
                        lambda *a, **kw: calls.append("flash") or fa.flash_attention(*a, **kw))
    real_blockwise = la.blockwise_attention
    monkeypatch.setattr(la, "blockwise_attention",
                        lambda *a, **kw: calls.append("blockwise") or real_blockwise(*a, **kw))
    q, k, v = _torch(*_qkv(b=1, tq=1024, tk=1024, h=1, d=32, seed=2))
    la.local_attention(q, k, v, causal=True)
    la.local_attention(q[:, 512:], k, v, causal=True, q_offset=512)  # offset
    la.local_attention(q[:, :768], k[:, :768], v[:, :768], causal=True)  # T % 512
    la.local_attention(q[:, :1], k, v, causal=True, q_offset=1023)  # dense
    assert calls == ["flash", "blockwise", "blockwise"]
    assert la.flash_shapes_ok(1024, 32) and la.flash_shapes_ok(2048, 128)
    assert not la.flash_shapes_ok(512, 32) and not la.flash_shapes_ok(1024, 48)
    assert not la._flash_ok(q, k, 0, 1) and la._flash_ok(q, k, 0, 0)


def test_online_softmax_update_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(b=1, tq=16, tk=8, h=2, d=8, seed=9)
    o = rng.standard_normal((1, 2, 16, 8)).astype(np.float32)
    l_ = rng.uniform(1, 2, (1, 2, 16)).astype(np.float32)
    m = rng.standard_normal((1, 2, 16)).astype(np.float32)
    m[0, 0, :4] = -1e30  # rows that have seen nothing yet
    mask = rng.uniform(size=(16, 8)) > 0.4
    mask[:2] = False  # fully masked rows
    want = j_olm(_jax(o, l_, m), *_jax(q, k, v), 0.3, jnp.asarray(mask))
    got = ra.online_softmax_update(_torch(o, l_, m), *_torch(q, k, v), 0.3,
                                   torch.from_numpy(mask))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_repeat_kv_matches_jax_and_rejects_bad_groups():
    k = np.random.default_rng(3).standard_normal((2, 5, 2, 4)).astype(np.float32)
    got = ra.repeat_kv(torch.from_numpy(k), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_repeat_kv(jnp.asarray(k), 6)))
    assert ra.repeat_kv(torch.from_numpy(k), 2).data_ptr() == torch.from_numpy(k).data_ptr()
    with pytest.raises(ValueError, match="not divisible"):
        ra.repeat_kv(torch.from_numpy(k), 3)


def test_flash_wrapper_guards_on_every_device():
    q, k, v = _torch(*_qkv(b=1, tq=64, tk=64, h=4, d=32))
    with pytest.raises(ValueError, match="k and v must be"):
        fa.flash_attention(q, k[:, :32], v[:, :32])
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, k[:, :, :3], v[:, :, :3])
    with pytest.raises(TypeError, match="dtypes differ"):
        fa.flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError, match=r"\(B, T, H, D\)"):
        fa.flash_attention(q[0], k, v)
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q, k, v, causal=True)  # the CPU takes the plain version
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("d", range(32, 257, 32))
def test_forward_kernel_dispatch_by_dtype(d):
    """The fixed dispatch of K4's forward: bf16 to the bf16 Hopper kernel and
    f32 to the split-TF32 one, each naming a source that exists; the
    kernels' shape check passes D and raises on the D between and beyond."""
    assert fa.forward_kernel(torch.bfloat16) == "flash_attention_wgmma"
    assert fa.forward_kernel(torch.float32) == "flash_attention_3xtf32"
    for dtype in (torch.bfloat16, torch.float32):
        assert (fa._build.CSRC / f"{fa.forward_kernel(dtype)}.cu").is_file()
    with pytest.raises(ValueError, match="lie on one CUDA device"):  # D passed
        fa._check_kernel_shape(torch.zeros((1, 64, 1, d)), torch.zeros(1))
    for bad in (d - 16, d + 8, 0, 288):
        with pytest.raises(ValueError, match="covers D"):
            fa._check_kernel_shape(torch.zeros((1, 64, 1, max(bad, 0))))


@pytest.mark.parametrize("d", range(32, 257, 32))
def test_backward_kernel_dispatch_by_dtype(d):
    """The fixed dispatch of K4's backward: bf16 to the bf16 Hopper kernels
    and f32 to the split-TF32 ones, each naming a source that exists and
    differs from the other; the backward's shape check passes D (and raises
    on the card check) and raises on the D between and beyond."""
    assert fa.backward_kernel(torch.bfloat16) == "flash_attention_bwd_wgmma"
    assert fa.backward_kernel(torch.float32) == "flash_attention_bwd_3xtf32"
    for dtype in (torch.bfloat16, torch.float32):
        assert (fa._build.CSRC / f"{fa.backward_kernel(dtype)}.cu").is_file()
    q = torch.zeros((1, 64, 2, d), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="lie on one CUDA device"):  # D passed
        fa._backward(q, q, q, q, lse, q, True, d ** -0.5)
    for bad in (d - 16, d + 8, 288):
        qb = torch.zeros((1, 64, 2, bad), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="covers D"):
            fa._backward(qb, qb, qb, qb, lse, qb, True, 1.0)


def test_kernel_strides_meet_the_tensor_map_rules():
    """(batch, row) strides as the kernels' TMA maps take them: a dense
    tensor, a KV-cache slice read in place, a batch of one with an odd
    batch stride (passed as its rows' span); rows not 16-byte aligned and
    heads or D not dense raise."""
    x = torch.zeros((2, 128, 4, 64), dtype=torch.bfloat16)
    assert fa._strides(x, "q") == (128 * 256, 256)
    cache = torch.zeros((2, 320, 2, 64), dtype=torch.bfloat16)
    assert fa._strides(cache[:, :256], "k") == (320 * 128, 128)
    one = torch.zeros((1, 64, 2, 32)).as_strided((1, 64, 2, 32), (12, 64, 32, 1))
    assert fa._strides(one, "q") == (64 * 64, 64)
    flat = torch.zeros(2 * 128 * 260 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):  # row stride 260 elements
        fa._strides(flat[: 2 * 128 * 260].view(2, 128, 260)[..., :256].unflatten(2, (4, 64)), "q")
    with pytest.raises(ValueError, match="16-byte aligned"):  # base 8 bytes off
        fa._strides(flat[4: 4 + 2 * 128 * 256].view(2, 128, 4, 64), "q")
    with pytest.raises(ValueError, match="contiguous"):
        fa._strides(x.transpose(2, 3).contiguous().transpose(2, 3), "q")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [-0.25, 0.0])
def test_flash_attention_takes_any_scale(scale, causal):
    """A negative or zero scale is a softmax like any other: the output
    equals softmax((q . k) * scale) v written out densely (within 1e-6),
    lse its log-sum-exp, and ``flash_attention`` the plain version, at GQA
    (H 4 over 2)."""
    q, k, v = _torch(*_qkv(b=1, tq=128, tk=128, h=4, d=32, seed=37, h_kv=2))
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal, sm_scale=scale,
                                            return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, dim=2)) * scale
    if causal:
        s = s.masked_fill(torch.ones(128, 128, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.repeat_interleave(2, dim=2))
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fa.flash_attention(q, k, v, causal=causal, sm_scale=scale),
                               out, rtol=0, atol=0)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10 mantissa bits, to
    nearest, ties away from zero (on the f32 bit pattern, sign apart)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_products(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands and f32 sums: one pass (big x big) or split
    TF32's three (small x big + big x small, then big x big)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


@pytest.mark.parametrize("causal", [True, False])
def test_split_tf32_forward_numerics_hold_f32_parity(causal):
    """The numerics argument of the f32 forward kernel: both of its products
    (S = Q K^T and O = P V) taken as split TF32, with ``cvt.rna.tf32``
    emulated on the bit patterns, land within 1e-5 of
    ``flash_attention_reference`` at B 1, T 128, H 2, D 64; one TF32 pass
    does not hold the kernels' 1e-4 parity. The tolerance: each split-TF32
    product errs by about 2^-21 |a||b| a term (the dropped small x small
    term and the rounding of the small parts), summed over 64 terms of
    unit-variance inputs and scaled by 1/8 that is under 1e-6 in a score,
    and the softmax and P V carry it to the output at that size; 1e-5
    leaves a margin of ten. One pass errs by about 2^-11 a term."""
    rng = np.random.default_rng(41)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 64)).astype(np.float32))
               for _ in range(3))
    want, want_lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                  return_lse=True)
    qh, kh, vh = (x[0].transpose(0, 1) for x in (q, k, v))  # (H, T, D)
    err = {}
    for passes in (3, 1):
        s = _tf32_products(qh, kh.transpose(1, 2), passes) * 64 ** -0.5
        if causal:
            s = s.masked_fill(torch.ones(128, 128, dtype=torch.bool).triu(1), float("-inf"))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        out = (_tf32_products(p, vh, passes) / l).transpose(0, 1)[None]
        lse = (m + torch.log(l))[..., 0][None]
        err[passes] = max(float((out - want).abs().max()),
                          float((lse - want_lse).abs().max()))
    assert err[3] <= 1e-5, err
    assert err[1] > 1e-4, err


# -- K4's backward ------------------------------------------------------------


@pytest.mark.parametrize("causal,h,h_kv", [(True, 2, 2), (False, 2, 2), (True, 4, 2)])
def test_flash_plain_backward_matches_jax_grad(causal, h, h_kv):
    """The gradients through the port's ``local_attention`` at a gated shape
    (K4's plain forward and backward, through ``FlashAttention``) against
    ``jax.grad`` of JAX ``local_attention`` (the blockwise path on the CPU),
    with compact GQA K/V on both sides: f32 within 2e-5."""
    q, k, v = _qkv(b=1, tq=1024, tk=1024, h=h, d=32, seed=21, h_kv=h_kv)
    w = np.random.default_rng(22).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(j_local_attention(q_, k_, v_, causal=causal) * jnp.asarray(w))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*_jax(q, k, v))
    leaves = [x.requires_grad_() for x in _torch(q, k, v)]
    before = dict(fa.LAUNCHES)
    out = la.local_attention(*leaves, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    assert fa.LAUNCHES == before  # the CPU launches nothing
    for name, got, ref in zip("qkv", leaves, want):
        assert got.grad.shape == ref.shape, name
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_backward_matches_autograd_and_lse(causal):
    """``flash_attention_bwd_reference`` against torch autograd through the
    plain forward, compact GQA dk/dv included; ``lse`` against
    ``torch.logsumexp`` of the masked scaled scores."""
    q, k, v = _torch(*_qkv(b=2, tq=128, tk=128, h=4, d=16, seed=23, h_kv=2))
    do = torch.from_numpy(np.random.default_rng(24).standard_normal(q.shape).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention_reference(*leaves, causal=causal).backward(do)
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal, return_lse=True)
    got = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal)
    for name, g, leaf in zip("qkv", got, leaves):
        assert g.shape == leaf.shape, name
        torch.testing.assert_close(g, leaf.grad, rtol=1e-5, atol=1e-5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, ra.repeat_kv(k, 4)) * 0.25
    if causal:
        scores = scores.masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(),
                                    float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1), rtol=1e-6, atol=1e-6)

