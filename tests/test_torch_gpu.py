"""The port's CUDA kernels (K1 masked_average, K2 elastic_average_step, K3
the ring allreduce, K4 the flash-attention forward and backward) against
their plain PyTorch versions on the card, and the LM's training path
through them; ZeRO-1's f32 step through K1 once, equal to ``DPTrainer``'s,
and the async checkpoint capture (clones drained on a side stream into
pinned buffers) holding capture-time values; and the host engine with its round buffers on the card
against the same runs on the CPU, bit for bit (config 1's shape, the
dropout tier of config 5, the 2-D butterfly), with no copy between host and
card inside a round and no K1-K4 launch; and the TCP control plane with
payloads on the card: each wire mode's frame equal to the CPU copy's bytes,
a deferred frame reading the stream that wrote its sums, and a 3-node
cluster equal to the numpy mean; and the elastic DP cycle (8 -> 6 -> 8
ranks) with K1 once a step, bit-equal to its continuation oracle, with no
memory left behind by five more re-mesh cycles; and the int8 KV cache (K4
once a layer at a gated prefill, none in decode, ``quantized_cache_attention``
on the card against the CPU) and the MoE trainer (K4's forward and backward
once a layer a step; a dense width's steps against the CPU's); and the
LM's trainer over virtual ranks: Ulysses over (data, seq, model) at a gated
length launching K4's forward and backward once a layer for all 8 ranks and
K1 once a step, and ring, Ulysses and TP steps on the card against the
same steps on the CPU.

Marked ``gpu``; without a card every test skips (decided in the ``card``
fixture, never at import). Run on the card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.

The kernels avoid FMA contraction, so they are held to bit equality with the
plain versions (which run as separate mul and add kernels on the card), K3
in all three wire modes too.
K4 sums in another order than the plain version's dense products and, in
bf16, rounds P to bf16 for the PV product: f32 is held to rtol = atol =
1e-4, bf16 to rtol = atol = 2e-2, the forward's lse to 1e-4 (absolute),
and two launches of either forward on the same inputs to bit equality.
K4's backward (which also rounds P and dS to bf16 in bf16) is held to the
same numbers relative to max|grad|, two of its launches on the same inputs
to bit equality, and the bf16 kernel's di to 1e-5 of PyTorch's reduction.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.comm import allreduce as ar
from akka_allreduce_tpu_torch.control.local import local_engine
from chip_smoke import (
    check_overlap_k1,
    engine_buffers,
    engine_flushes_equal,
    kernel_counts,
    profile_engine,
    watch_leaf_syncs,
)
from akka_allreduce_tpu_torch.models import (
    MLP,
    LMGenerator,
    SyntheticCopyLM,
    TransformerLM,
    mnist_like,
)
from akka_allreduce_tpu_torch.ops import flash_attention as fa
from akka_allreduce_tpu_torch.ops import local_attention as la
from akka_allreduce_tpu_torch.ops import local_reduce as lr
from akka_allreduce_tpu_torch.ops import ring as rk
from akka_allreduce_tpu_torch.parallel import (
    data_seq_mesh,
    data_seq_model_mesh,
    grid_mesh,
    line_mesh,
)
from akka_allreduce_tpu_torch.train import (
    AsyncDeltaCheckpointer,
    DPTrainer,
    LongContextTrainer,
    Zero1DPTrainer,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _stack(k, data, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((k, data)).astype(np.float32)).to(dev)


def _mask(bits, dev):
    return torch.tensor(bits, dtype=torch.float32, device=dev)


SHAPES = [(4, 17), (4, 1000), (8, 65536), (8, 65537), (16, 1000), (13, 4099),
          (32, 1000), (40, 1000), (40, 17), (1, 1000)]


def _partial(k):
    return [float(i % 3 != 1) for i in range(k)]


@pytest.mark.parametrize("k,data", SHAPES)
def test_masked_average_matches_plain(card, k, data):
    x = _stack(k, data, card)
    valid = _mask(_partial(k), card)
    before = lr.LAUNCHES["masked_average"]
    avg, count = lr.masked_average(x, valid)
    ref_avg, ref_count = lr.masked_average_reference(x, valid)
    torch.cuda.synchronize()
    assert lr.LAUNCHES["masked_average"] == before + 1
    assert avg.is_cuda and avg.shape == (data,) and count.shape == ()
    assert float(count) == float(ref_count)
    assert torch.equal(avg, ref_avg)


@pytest.mark.parametrize("k,data", SHAPES)
def test_elastic_average_step_matches_plain_in_place(card, k, data):
    x = _stack(k, data, card, seed=1)
    valid = _mask(_partial(k), card)
    ref = lr.elastic_average_step_reference(x, valid, 0.3)
    ptr = x.data_ptr()
    before = lr.LAUNCHES["elastic_average_step"]
    out = lr.elastic_average_step(x, valid, 0.3)
    torch.cuda.synchronize()
    assert lr.LAUNCHES["elastic_average_step"] == before + 1
    assert out is x and x.data_ptr() == ptr  # the caller's tensor, overwritten
    assert torch.equal(x, ref)


def test_packed_form_matches_flat(card):
    x = _stack(4, 1000, card, seed=3)
    valid = _mask([1, 0, 1, 1], card)
    flat = lr.elastic_average_step(x.clone(), valid, 0.3)
    xt = lr.pack_tiles(x)
    lr.elastic_average_step(xt, valid, 0.3)
    assert torch.equal(lr.unpack_tiles(xt, 1000), flat)


def test_zero_mask_keeps_state_bit_exact(card):
    x = _stack(8, 4099, card, seed=4)
    keep = x.clone()
    valid = torch.zeros(8, device=card)
    lr.elastic_average_step(x, valid, 0.5)
    avg, count = lr.masked_average(keep, valid)
    torch.cuda.synchronize()
    assert torch.equal(x.view(torch.int32), keep.view(torch.int32))
    assert float(count) == 0.0 and not bool(avg.any())


def test_misaligned_contiguous_stack(card):
    buf = torch.arange(4 * 1000 + 1, dtype=torch.float32, device=card)
    x = buf[1:].view(4, 1000)  # contiguous, 4 bytes past a 16-byte boundary
    valid = _mask([1, 1, 0, 1], card)
    ref = lr.elastic_average_step_reference(x, valid, 0.25)
    avg, _ = lr.masked_average(x, valid)
    assert torch.equal(avg, lr.masked_average_reference(x, valid)[0])
    lr.elastic_average_step(x, valid, 0.25)
    assert torch.equal(x, ref)


def test_card_rejects_what_the_kernels_do_not_take(card):
    x = _stack(4, 100, card)
    valid = torch.ones(4, device=card)
    with pytest.raises(TypeError):
        lr.masked_average(x.double(), valid.double())
    with pytest.raises(TypeError):
        lr.elastic_average_step(x, valid.to(torch.int32), 0.5)
    with pytest.raises(ValueError):
        lr.elastic_average_step(x.t(), torch.ones(100, device=card), 0.5)
    with pytest.raises(ValueError):
        lr.elastic_average_step(x, valid.cpu(), 0.5)
    with pytest.raises(ValueError):
        lr.elastic_average_step(x, valid, torch.tensor(0.5, device=card))


def test_kernels_run_on_the_callers_stream(card):
    x = _stack(8, 1 << 20, card, seed=5)
    valid = torch.ones(8, device=card)
    ref = lr.elastic_average_step_reference(x, valid, 0.125)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lr.elastic_average_step(x, valid, 0.125)
        avg, _ = lr.masked_average(x, valid)
        snapshot = avg.clone()  # ordered after the kernels on the same stream
    side.synchronize()
    assert torch.equal(x, ref)
    assert torch.equal(snapshot, lr.masked_average_reference(ref, valid)[0])


# -- K3: the ring allreduce ------------------------------------------------------


def _assert_ring_equal(out, ref, compress):
    # no FMA contraction and the same rounding in every mode: bit equality
    assert torch.equal(out, ref), compress


def _assert_replicated(out, compress):
    for d in range(out.shape[0]):
        if compress == "int8":
            torch.testing.assert_close(out[d], out[0], rtol=2e-6, atol=1e-6)
        else:
            assert torch.equal(out[d], out[0])


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
@pytest.mark.parametrize("seg_rows", [1, 4, 512])
@pytest.mark.parametrize("n", [2, 3, 4, 8, 16, 24])
def test_ring_kernel_matches_plain(card, n, seg_rows, compress):
    data = 2 * n * seg_rows * rk.LANE + 37  # three buckets, ragged tail
    xs = _stack(n, data, card, seed=n + seg_rows)
    keep = xs.clone()
    before = rk.LAUNCHES["ring_allreduce"]
    out = rk.ring_kernel_allreduce_sum(xs, seg_rows=seg_rows, compress=compress)
    ref = rk.ring_kernel_allreduce_sum_reference(xs, seg_rows=seg_rows,
                                                 compress=compress)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["ring_allreduce"] == before + 1  # one launch a call
    assert out.shape == (n, data) and out.is_cuda
    assert torch.equal(xs, keep)  # the caller's stack is never written
    _assert_ring_equal(out, ref, compress)
    _assert_replicated(out, compress)
    if compress is None:
        torch.testing.assert_close(out[0], xs.sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
@pytest.mark.parametrize("n", [3, 8, 16, 24])
def test_ring_kernel_masked_matches_plain(card, n, compress):
    """A per-rank mask applied inside the kernel, on a ragged payload."""
    data = 3 * n * 4 * rk.LANE + 53
    xs = _stack(n, data, card, seed=100 + n)
    keep = xs.clone()
    valid = _mask(_partial(n), card)
    out = rk.ring_kernel_allreduce_sum(xs, seg_rows=4, compress=compress, valid=valid)
    ref = rk.ring_kernel_allreduce_sum_reference(xs, seg_rows=4, compress=compress,
                                                 valid=valid)
    assert torch.equal(xs, keep)
    _assert_ring_equal(out, ref, compress)
    _assert_replicated(out, compress)


@pytest.mark.parametrize("n,seg_rows", [(8, 2048), (24, 512)])
def test_ring_kernel_int8_segment_spans_clusters(card, n, seg_rows):
    """int8 segments wider than one cluster's work item: a team of clusters
    agrees on each segment's scale through global words."""
    data = 2 * n * seg_rows * rk.LANE + 37
    plan = rk.ring_plan(n, data=data, seg_rows=seg_rows, compress="int8")
    assert plan["team"] > 1 and plan["chunks"] == plan["team"]
    assert plan["clusters"] % plan["team"] == 0
    xs = _stack(n, data, card, seed=200 + n)
    out = rk.ring_kernel_allreduce_sum(xs, seg_rows=seg_rows, compress="int8")
    ref = rk.ring_kernel_allreduce_sum_reference(xs, seg_rows=seg_rows,
                                                 compress="int8")
    _assert_ring_equal(out, ref, "int8")
    _assert_replicated(out, "int8")


def test_ring_kernel_int8_subnormal_scale_and_large_values(card):
    """A subnormal scale takes the measured path for every round trip; huge
    values the known max (127 * scale); both stay bit-equal."""
    for factor in (1e-37, 1e30):
        xs = _stack(8, 2 * 8 * 512 * rk.LANE + 37, card, seed=7) * factor
        out = rk.ring_kernel_allreduce_sum(xs, compress="int8")
        ref = rk.ring_kernel_allreduce_sum_reference(xs, compress="int8")
        _assert_ring_equal(out, ref, "int8")


@pytest.mark.parametrize("n", [2, 8, 16, 24])
def test_ring_kernel_cluster_plan(card, n):
    """One rank per CTA up to 8 ranks (portable clusters), several CTAs of
    ranks per cluster never above 16 CTAs, and a grid the card can hold."""
    for compress in (None, "bf16", "int8"):
        plan = rk.ring_plan(n, data=n * 512 * rk.LANE * 3, compress=compress)
        assert plan["cluster"] <= 16 and plan["clusters"] >= 1
        assert plan["cluster"] * plan["ranks_per_cta"] >= n
        assert plan["cluster"] == -(-n // plan["ranks_per_cta"])
        if n <= 8:
            assert plan["ranks_per_cta"] == 1
        if n > 16:
            assert plan["ranks_per_cta"] > 1


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
def test_ring_kernel_whole_buckets_copy_path(card, compress):
    """Whole buckets and 16-byte rows (the vector loads and stores): the
    result is a new tensor and the stack is left as it was."""
    xs = _stack(8, 8 * 4 * rk.LANE * 2, card, seed=9)
    keep = xs.clone()
    out = rk.ring_kernel_allreduce_sum(xs, seg_rows=4, compress=compress)
    ref = rk.ring_kernel_allreduce_sum_reference(xs, seg_rows=4, compress=compress)
    assert out.data_ptr() != xs.data_ptr() and torch.equal(xs, keep)
    _assert_ring_equal(out, ref, compress)


def test_ring_kernel_int8_all_zero_segment(card):
    xs = _stack(4, 4 * 4 * rk.LANE, card, seed=10)
    xs[:, : 4 * rk.LANE] = 0.0  # segment 0 is zero on every rank
    out = rk.ring_kernel_allreduce_sum(xs, seg_rows=4, compress="int8")
    ref = rk.ring_kernel_allreduce_sum_reference(xs, seg_rows=4, compress="int8")
    assert bool(torch.isfinite(out).all())
    assert not bool(out[:, : 4 * rk.LANE].any())
    _assert_ring_equal(out, ref, "int8")


def test_ring_kernel_runs_on_the_callers_stream(card):
    xs = _stack(8, 1 << 20, card, seed=11)
    ref = rk.ring_kernel_allreduce_sum_reference(xs, compress="bf16")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = rk.ring_kernel_allreduce_sum(xs, compress="bf16")
        snapshot = out.clone()  # ordered after the kernel on the same stream
    side.synchronize()
    assert torch.equal(snapshot, ref)


def test_ring_rejects_what_the_kernel_does_not_take(card):
    xs = _stack(4, 1000, card)
    with pytest.raises(TypeError):
        rk.ring_kernel_allreduce_sum(xs.double())
    with pytest.raises(ValueError):
        rk.ring_kernel_allreduce_sum(xs.t().contiguous().t())
    mesh = line_mesh(4)
    with pytest.raises(ValueError, match="valid is on cpu"):
        ar.masked_psum(mesh, xs, torch.ones(4), "line")


@pytest.mark.parametrize(
    "schedule,compress,bucket",
    [("psum", None, None), ("psum", "bf16", 1000), ("ring", "int8", None),
     ("pallas_ring", None, None), ("pallas_ring", "bf16", 4096),
     ("pallas_ring", "int8", 2048), ("butterfly", "bf16", None)],
)
def test_threshold_allreduce_card_equals_cpu(card, schedule, compress, bucket):
    """The card's result (K3 for pallas_ring, plain tensor code otherwise)
    equals the CPU's (the plain versions) on the same inputs."""
    rng = np.random.default_rng(12)
    xs = rng.standard_normal((8, 5000)).astype(np.float32)
    n_b = 1 if bucket is None else -(-5000 // bucket)
    valid = (rng.uniform(size=(8, n_b)) > 0.3).astype(np.float32)
    valid = valid[:, 0] if bucket is None else valid
    make = grid_mesh if schedule == "butterfly" else line_mesh
    args = (2, 4) if schedule == "butterfly" else (8,)
    kw = dict(schedule=schedule, compress=compress, bucket_size=bucket)
    on_card = ar.threshold_allreduce(make(*args), xs, valid, **kw)
    on_cpu = ar.threshold_allreduce(make(*args, device="cpu"), xs, valid, **kw)
    torch.testing.assert_close(on_card.sum.cpu(), on_cpu.sum, rtol=1e-6, atol=1e-6)
    assert torch.equal(on_card.count.cpu(), on_cpu.count)


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
def test_pallas_ring_round_passes_the_mask_into_one_launch(card, compress):
    """The round with a whole-payload mask launches K3 once with the mask,
    and its sum and count equal, bit for bit, masking the stack first and
    running the plain K3 (the round before the mask moved into the kernel)."""
    rng = np.random.default_rng(13)
    xs = torch.from_numpy(rng.standard_normal((8, 50_000)).astype(np.float32)).to(card)
    valid = _mask([1, 1, 0, 1, 1, 0, 1, 1], card)
    before = rk.LAUNCHES["ring_allreduce"]
    res = ar.threshold_allreduce(line_mesh(8), xs, valid, schedule="pallas_ring",
                                 compress=compress)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["ring_allreduce"] == before + 1
    want = rk.ring_kernel_allreduce_sum_reference(xs * valid[:, None],
                                                  compress=compress)[0]
    assert torch.equal(res.sum, want)
    assert torch.equal(res.count, torch.full((50_000,), 6.0, device=card))


# -- K4: the flash-attention forward ------------------------------------------

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _qkv(b, t, h, h_kv, d, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)

    def draw(heads):
        x = rng.standard_normal((b, t, heads, d)).astype(np.float32)
        return torch.from_numpy(x).to(dev, dtype)

    return draw(h), draw(h_kv), draw(h_kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,t,h,h_kv,d",
    [(1, 128, 2, 2, 32), (2, 192, 4, 2, 64), (1, 256, 2, 1, 96),
     (1, 1024, 2, 2, 128), (1, 320, 3, 3, 160), (2, 128, 2, 2, 192),
     (1, 128, 1, 1, 224), (1, 192, 2, 1, 256)],
)
def test_flash_kernel_matches_plain(card, b, t, h, h_kv, d, dtype, causal):
    q, k, v = _qkv(b, t, h, h_kv, d, dtype, card)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    for name in ("flash_attention_wgmma", "flash_attention_3xtf32"):
        assert fa.LAUNCHES[name] == before[name] + (name == fa.forward_kernel(dtype))
    assert out.dtype == dtype and out.shape == (b, t, h, d)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 128),
                                     (torch.bfloat16, 64), (torch.bfloat16, 128)])
def test_flash_kernel_reads_a_cache_slice_in_place(card, dtype, d):
    """K/V as the live slots of a longer cache (batch stride > T * H * D)."""
    q, k, v = _qkv(2, 256, 4, 2, d, dtype, card, seed=5)
    ck = torch.zeros((2, 320, 2, d), dtype=dtype, device=card)
    cv = torch.zeros_like(ck)
    ck[:, :256], cv[:, :256] = k, v
    out = fa.flash_attention(q, ck[:, :256], cv[:, :256], causal=True)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv", [(2, 2), (8, 4), (4, 1)])
@pytest.mark.parametrize("t", [576, 1088])
@pytest.mark.parametrize("d", range(32, 257, 32))
def test_wgmma_forward_matches_plain(card, d, t, h, h_kv, causal):
    """The bf16 Hopper forward at every D it covers, at T a multiple of 64
    but not of 128 (a ragged last query and key block), with compact GQA
    K/V: the output within 2e-2 and lse within 1e-4 of the plain version,
    one launch of that kernel, and a repeat bit-identical."""
    q, k, v = _qkv(1, t, h, h_kv, d, torch.bfloat16, card, seed=d + t + h_kv)
    assert fa.forward_kernel(q.dtype) == "flash_attention_wgmma"
    before = dict(fa.LAUNCHES)
    out, lse = fa._forward(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_wgmma"] == before["flash_attention_wgmma"] + 1
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, return_lse=True)
    assert out.dtype == torch.bfloat16 and out.shape == (1, t, h, d)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    again, again_lse = fa._forward(q, k, v, causal, d ** -0.5)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    assert torch.equal(lse, again_lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv", [(2, 2), (8, 4), (4, 1)])
@pytest.mark.parametrize("t", [576, 1088])
@pytest.mark.parametrize("d", range(32, 257, 32))
def test_3xtf32_forward_matches_plain(card, d, t, h, h_kv, causal):
    """The f32 Hopper forward (split TF32) at every D it covers, at T a
    multiple of 64 but not of 128 (a ragged last query block), with compact
    GQA K/V: the output within 1e-4 and lse within 1e-4 of the plain
    version, one launch of that kernel, and a repeat bit-identical."""
    q, k, v = _qkv(1, t, h, h_kv, d, torch.float32, card, seed=d + t + h_kv)
    assert fa.forward_kernel(q.dtype) == "flash_attention_3xtf32"
    before = dict(fa.LAUNCHES)
    out, lse = fa._forward(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_3xtf32"] == before["flash_attention_3xtf32"] + 1
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_wgmma"] == before["flash_attention_wgmma"]
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, return_lse=True)
    assert out.dtype == torch.float32 and out.shape == (1, t, h, d)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    again, again_lse = fa._forward(q, k, v, causal, d ** -0.5)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    assert torch.equal(lse.view(torch.int32), again_lse.view(torch.int32))


@pytest.mark.parametrize("d", range(32, 257, 32))
def test_forward_dispatch_sends_each_dtype_where_the_source_says(card, d):
    """bf16 launches the bf16 Hopper kernel and f32 the split-TF32 one, at
    every D, and both take any scale: a negative and a zero one match the
    plain version as the default does."""
    for dtype, wgmma in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, k, v = _qkv(1, 128, 2, 2, d, dtype, card, seed=d)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        for scale in (None, -d ** -0.5, 0.0):
            before = dict(fa.LAUNCHES)
            out = fa.flash_attention(q, k, v, causal=True, sm_scale=scale)
            assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
            assert (fa.LAUNCHES["flash_attention_wgmma"]
                    == before["flash_attention_wgmma"] + wgmma)
            assert (fa.LAUNCHES["flash_attention_3xtf32"]
                    == before["flash_attention_3xtf32"] + 1 - wgmma)
            ref = fa.flash_attention_reference(q, k, v, causal=True, sm_scale=scale)
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_flash_kernel_runs_on_the_callers_stream(card):
    q, k, v = _qkv(1, 1024, 2, 2, 64, torch.bfloat16, card, seed=2)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.current_stream(card).wait_stream(side)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_flash_rejects_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(1, 128, 2, 2, 32, torch.float32, card)
    for bad_d in (16, 48, 288):
        qd, kd, vd = _qkv(1, 128, 2, 2, bad_d, torch.float32, card)
        with pytest.raises(ValueError, match="covers D"):
            fa.flash_attention(qd, kd, vd, causal=True)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of 64"):
        fa.flash_attention(q[:, :100], k[:, :100], v[:, :100])
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention(q, k.cpu(), v.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_attention_takes_the_kernel_on_gated_shapes(card, dtype):
    q, k, v = _qkv(1, 1024, 2, 1, 64, dtype, card, seed=3)
    before = fa.LAUNCHES["flash_attention"]
    out = la.local_attention(q, k, v, causal=True)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    # the blockwise path and an ungated call (nonzero offset) launch nothing
    want = la.blockwise_attention(q, k, v, causal=True)
    tail = la.local_attention(q[:, 512:], k, v, causal=True, q_offset=512)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(tail.float(), want[:, 512:].float(), rtol=tol, atol=tol)


def test_lm_forward_and_prefill_launch_the_kernel(card):
    """A gated forward launches K4 once a layer, as does an empty-cache
    prefill; teacher-forced chunks at nonzero offsets launch none, and all
    three agree."""
    model = TransformerLM(vocab=32, d_model=64, n_heads=2, n_layers=2,
                          seed=1, device=card)
    tokens = torch.randint(0, 32, (2, 1024), generator=torch.Generator().manual_seed(4))
    before = fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        logits = model(tokens.to(card))
    assert fa.LAUNCHES["flash_attention"] == before + 2
    gen = LMGenerator(model, max_len=1040)
    chunked = gen.decode_logits(tokens, chunk=256)
    assert fa.LAUNCHES["flash_attention"] == before + 2
    scale = float(logits.abs().max())
    torch.testing.assert_close(chunked, logits, rtol=0, atol=1e-4 * scale)
    out = gen.generate(tokens, 4)
    assert fa.LAUNCHES["flash_attention"] == before + 4
    assert out.shape == (2, 4) and out.dtype == torch.int32


# -- K4's backward ------------------------------------------------------------

BWD_SHAPES = [(1, 128, 2, 2, 32), (2, 192, 4, 2, 64), (1, 256, 2, 1, 96),
              (1, 1024, 2, 2, 128), (1, 320, 3, 3, 160), (2, 128, 2, 2, 192),
              (1, 128, 1, 1, 224), (1, 192, 4, 1, 256)]


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: the backward's tolerance scale."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,h_kv,d", BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain(card, b, t, h, h_kv, d, dtype, causal):
    """dq, dk, dv (compact GQA shape) and the forward's lse against the plain
    versions, relative to max|grad|: f32 within 1e-4, bf16 within 2e-2.
    bf16 goes through the bf16 Hopper kernels, f32 through the split-TF32
    ones, each counter moving for its own dtype only (T 192 and 320 leave a
    ragged 128-row block)."""
    q, k, v = _qkv(b, t, h, h_kv, d, dtype, card, seed=7)
    do = _qkv(b, t, h, h, d, dtype, card, seed=8)[0]
    o, lse = fa._forward(q, k, v, causal, d ** -0.5)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                  return_lse=True)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    name = fa.backward_kernel(dtype)
    assert name == ("flash_attention_bwd_wgmma" if dtype == torch.bfloat16
                    else "flash_attention_bwd_3xtf32")
    for key in ("flash_attention_bwd", "flash_attention_bwd_wgmma",
                "flash_attention_bwd_3xtf32"):
        assert fa.LAUNCHES[key] == before[key] + (key in ("flash_attention_bwd", name)), key
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel_err(g, w) <= FLASH_TOL[dtype], (name, _rel_err(g, w))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,t,h,h_kv,d", [(1, 1024, 16, 1, 64), (1, 4096, 4, 1, 64),
                                          (1, 1024, 16, 1, 256)])
def test_f32_bwd_holds_long_runs_of_query_rows(card, b, t, h, h_kv, d, seed):
    """dK and dV sum over every query row of a kv head's GQA group: 16,384
    rows here. The f32 backward holds them within 1e-4 of max|grad| of the
    plain version: its tensor-core accumulators are added into dK and dV in
    f32 every 1,024 rows, where one run over all 16,384 drifted past 1e-4."""
    q, k, v = _qkv(b, t, h, h_kv, d, torch.float32, card, seed=seed)
    do = _qkv(b, t, h, h, d, torch.float32, card, seed=seed + 100)[0]
    o, lse = fa._forward(q, k, v, True, d ** -0.5)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= 1e-4, (name, _rel_err(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_repeats_bit_identical(card, dtype):
    q, k, v = _qkv(2, 256, 4, 2, 64, dtype, card, seed=9)
    do = _qkv(2, 256, 4, 4, 64, dtype, card, seed=10)[0]
    o, lse = fa._forward(q, k, v, True, 0.125)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,h_kv,d", [(1, 192, 4, 2, 32), (2, 256, 2, 2, 128),
                                         (1, 320, 4, 1, 256)])
def test_bwd_kernel_writes_di(card, b, t, h, h_kv, d, dtype):
    """The dQ kernel's di = sum(o * do, -1), (B, H, T) f32, within 1e-5 of
    the same reduction in PyTorch, every row written (ragged T too)."""
    q, k, v = _qkv(b, t, h, h_kv, d, dtype, card, seed=13)
    do = _qkv(b, t, h, h, d, dtype, card, seed=14)[0]
    o, lse = fa._forward(q, k, v, True, d ** -0.5)
    di = fa._backward(q, k, v, o, lse, do, True, d ** -0.5)[3]
    want = (o.float() * do.float()).sum(-1).transpose(1, 2)
    assert di.shape == (b, h, t) and di.dtype == torch.float32
    torch.testing.assert_close(di, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_runs_on_the_callers_stream(card, dtype):
    """A backward launched on a side stream gives the plain version's
    gradients once that stream is joined."""
    q, k, v = _qkv(1, 1024, 4, 2, 64, dtype, card, seed=15)
    do = _qkv(1, 1024, 4, 4, 64, dtype, card, seed=16)[0]
    o, lse = fa._forward(q, k, v, True, 0.125)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.current_stream(card).wait_stream(side)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= FLASH_TOL[dtype], (name, _rel_err(g, w))


def test_flash_bwd_rejects_what_the_kernel_does_not_take(card):
    for bad_d in (16, 48, 288):
        q, k, v = _qkv(1, 128, 2, 2, bad_d, torch.float32, card)
        lse = torch.zeros((1, 2, 128), device=card)
        with pytest.raises(ValueError, match="covers D"):
            fa.flash_attention_bwd(q, k, v, q, lse, q, causal=True)
    q, k, v = _qkv(1, 128, 2, 2, 32, torch.float32, card)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd(q, k, v, q, torch.zeros((1, 128, 2), device=card), q)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q.half(), k.half(), v.half(), q.half(),
                               torch.zeros((1, 2, 128), device=card), q.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h_kv", [2, 1])
def test_local_attention_gradients_go_through_the_kernels(card, dtype, h_kv):
    """The flash branch is differentiable on the card: q.grad, k.grad and
    v.grad through local_attention at a gated shape equal the plain
    version's autograd gradients, and the forward and backward kernels
    each launched once."""
    q, k, v = _qkv(1, 1024, 2, h_kv, 64, dtype, card, seed=11)
    do = _qkv(1, 1024, 2, 2, 64, dtype, card, seed=12)[0]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = la.local_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    out.backward(do)
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert (fa.LAUNCHES["flash_attention_bwd_wgmma"]
            == before["flash_attention_bwd_wgmma"] + int(dtype == torch.bfloat16))
    assert (fa.LAUNCHES["flash_attention_bwd_3xtf32"]
            == before["flash_attention_bwd_3xtf32"] + int(dtype == torch.float32))
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention_reference(*plain, causal=True).backward(do)
    for name, got, want in zip("qkv", leaves, plain):
        assert got.grad is not None and got.grad.dtype == dtype, name
        assert _rel_err(got.grad, want.grad) <= FLASH_TOL[dtype], (name, _rel_err(got.grad, want.grad))


# -- the LM's training path ---------------------------------------------------


def test_training_step_launches_both_kernels_once_a_layer(card):
    """One bf16 step at a gated length: K4's forward and backward each launch
    once a layer (twice the forward under remat), the loss is finite, and a
    ``valid=[0]`` step gives loss 0 and contributors 0."""
    for remat, fwd in ((False, 2), (True, 4)):
        trainer = LongContextTrainer(vocab=32, d_model=128, n_heads=2, n_layers=2,
                                     seq_len=1024, compute_dtype=torch.bfloat16,
                                     remat=remat, learning_rate=1e-3, device=card)
        x, y = next(SyntheticCopyLM(1024, vocab=32).batches(2, 1))
        before = dict(fa.LAUNCHES)
        m = trainer.train_step(x, y)
        assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + fwd
        assert fa.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 2
        assert (fa.LAUNCHES["flash_attention_bwd_wgmma"]
                == before["flash_attention_bwd_wgmma"] + 2)
        assert np.isfinite(m.loss) and m.contributors == 1.0
        m = trainer.train_step(x, y, valid=[0.0])
        assert m.loss == 0.0 and m.contributors == 0.0
    hist = trainer.train_chain(SyntheticCopyLM(1024, vocab=32).device_sampler(), 3, 2)
    assert [h.step for h in hist] == [3, 4, 5] and all(np.isfinite(h.loss) for h in hist)


def test_model_gradient_with_kernels_matches_plain_attention(card, monkeypatch):
    """The whole model's f32 gradient through the kernels against the same
    model's gradient with the plain attention on the card, per parameter,
    within 1e-4 of that parameter's max|grad|."""
    model = TransformerLM(vocab=32, d_model=128, n_heads=2, n_kv_heads=1, n_layers=2,
                          seed=2, device=card)
    x, y = (torch.from_numpy(a).to(card).long()
            for a in next(SyntheticCopyLM(1024, vocab=32).batches(2, 1)))

    def grads():
        model.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(model(x).reshape(-1, 32), y.reshape(-1)).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    before = dict(fa.LAUNCHES)
    got = grads()
    assert fa.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 2
    assert (fa.LAUNCHES["flash_attention_bwd_3xtf32"]
            == before["flash_attention_bwd_3xtf32"] + 2)
    monkeypatch.setattr(la, "flash_attention", lambda q, k, v, causal, sm_scale:
                        fa.flash_attention_reference(q, k, v, causal=causal,
                                                     sm_scale=sm_scale))
    want = grads()
    assert fa.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 2
    assert (fa.LAUNCHES["flash_attention_bwd_3xtf32"]
            == before["flash_attention_bwd_3xtf32"] + 2)
    for name in want:
        scale = float(want[name].abs().max())
        err = float((got[name] - want[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


# -- the data-parallel trainer over virtual ranks ---------------------------------


def _dp(card, **kw):
    return DPTrainer(MLP(hidden=(256, 128), seed=1, device=card), line_mesh(8, device=card),
                     **kw)


@pytest.mark.parametrize("mesh", ["line", "grid"])
def test_dp_f32_step_launches_k1_once_bit_equal_to_plain(card, mesh):
    """Every f32 step syncs through one K1 launch; on the step's gradient
    stack K1 equals its plain version bit for bit, and so do the parameters
    after the update from either average."""
    m = line_mesh(8, device=card) if mesh == "line" else grid_mesh(4, 2, device=card)
    t = DPTrainer(MLP(hidden=(256, 128), seed=1, device=card), m, bucket_size=4096)
    batches = list(mnist_like().batches(64, 3))
    valid = [1, 1, 1, 1, 1, 1, 1, 0]
    before = lr.LAUNCHES["masked_average"]
    hist = [t.train_step(x, y, valid) for x, y in batches]
    assert lr.LAUNCHES["masked_average"] == before + 3
    assert [h.contributors for h in hist] == [7.0] * 3 and hist[-1].loss < hist[0].loss
    x, y = t._place_batch(*batches[0])
    stack, _ = t.rank_gradients(x, y)
    v = torch.tensor(valid, dtype=torch.float32, device=card)
    got, count = lr.masked_average(stack, v)
    want, want_count = lr.masked_average_reference(stack, v)
    assert torch.equal(got, want) and float(count) == float(want_count) == 7.0
    p0 = t.get_flat_params()
    t.apply_gradients(want)
    p_plain = t.get_flat_params()
    t.set_flat_params(p0)
    t.apply_gradients(t.sync(stack, v)[0])
    np.testing.assert_array_equal(t.get_flat_params(), p_plain)


def test_dp_trainer_without_a_device_raises_when_cuda_is_absent(card, monkeypatch):
    model = MLP(hidden=(16,), device=card)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DPTrainer(model, line_mesh(8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MLP(hidden=(16,))


def test_dp_int8_rows_agree_bit_for_bit(card):
    """The int8 ring's rows on the card are bit-identical and within 1e-6
    of max|sum| of the CPU's; with EF the residual is the masked rank's
    whole contribution plus every rank's per-hop errors."""
    t = _dp(card, compress="int8", error_feedback=True)
    x, y = t._place_batch(*next(mnist_like().batches(64, 1)))
    stack, _ = t.rank_gradients(x, y)
    total = ar.ring_allreduce_sum(stack, compress="int8")
    for r in range(1, 8):
        assert torch.equal(total[r], total[0])
    total_cpu = ar.ring_allreduce_sum(stack.cpu(), compress="int8")
    assert float((total[0].cpu() - total_cpu[0]).abs().max()) <= 1e-6 * float(
        total_cpu.abs().max())
    v = torch.tensor([1, 1, 1, 0, 1, 1, 1, 1], dtype=torch.float32, device=card)
    average, count = t.sync(stack, v)
    assert float(count) == 7.0 and bool(torch.isfinite(average).all())
    _, hop = ar.ring_allreduce_sum(stack * v[:, None], compress="int8", return_residual=True)
    # the masked rank banks its whole gradient beside its own per-hop errors
    assert torch.equal(t._ef, ar.ring_ef_residual(stack, v, hop))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_bwd_dq_holds_long_runs_of_keys(card, d, seed):
    """dQ sums over every key tile of a query row: 16,384 keys at the last
    rows of T 16,384, causal, one head. The f32 backward holds dq, dk and dv
    within 1e-4 of max|grad| of the plain version."""
    q, k, v = _qkv(1, 16384, 1, 1, d, torch.float32, card, seed=seed)
    do = _qkv(1, 16384, 1, 1, d, torch.float32, card, seed=seed + 100)[0]
    o, lse = fa._forward(q, k, v, True, d ** -0.5)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= 1e-4, (name, _rel_err(g, w))


def test_dp_overlap_launches_k1_once_a_leaf_equal_to_the_fused_average(card):
    """Under overlap each f32 step launches K1 once a leaf, and each leaf's
    K1 output equals the matching slice of one fused K1 average of all the
    leaves' cotangent stacks, bit for bit (K1 is independent per column);
    the step lands within rtol 1e-5, atol 1e-7 of the fused step."""
    t = _dp(card, overlap=True)
    fused = _dp(card)
    x, y = next(mnist_like().batches(64, 1))
    valid = [1, 1, 1, 1, 1, 1, 1, 0]
    before = lr.LAUNCHES["masked_average"]
    with watch_leaf_syncs(t) as seen:
        m = t.train_step(x, y, valid)
    assert lr.LAUNCHES["masked_average"] == before + len(t._params) == before + 6
    assert m.contributors == 7.0
    assert sorted(c.shape[1] for c in seen["ct"]) == sorted(t._sizes)
    assert check_overlap_k1(seen, _mask(valid, card), "MLP overlap") == 6
    fused.train_step(x, y, valid)
    np.testing.assert_allclose(t.get_flat_params(), fused.get_flat_params(), rtol=1e-5,
                               atol=1e-7)


def test_dp_accum_step_launches_k1_once(card):
    a, b = _dp(card), _dp(card)
    x, y = next(mnist_like().batches(64, 1))
    before = lr.LAUNCHES["masked_average"]
    m_acc = b.train_step_accum(x, y, 4)
    assert lr.LAUNCHES["masked_average"] == before + 1
    m_full = a.train_step(x, y)
    assert abs(m_full.loss - m_acc.loss) < 1e-5
    np.testing.assert_allclose(a.get_flat_params(), b.get_flat_params(), atol=2e-5)


@pytest.mark.parametrize("p", [25_557_032, 23_528_522])
def test_k1_at_resnet50_stack_shapes(card, p):
    """K1 on ResNet-50's (8, P) gradient stacks (1000 and 10 classes: the
    float4 and the scalar path) equals its plain version bit for bit, with
    every rank and with rank 7 masked."""
    x = _stack(8, p, card, seed=p % 97)
    for bits in ([1.0] * 8, [1.0] * 7 + [0.0]):
        valid = _mask(bits, card)
        got, count = lr.masked_average(x, valid)
        want, want_count = lr.masked_average_reference(x, valid)
        assert torch.equal(got, want) and float(count) == float(want_count) == sum(bits)


def test_resnet_f32_convs_stay_f32_under_the_default_cudnn_setting(card, monkeypatch):
    """PyTorch lets cuDNN run f32 convs in TF32 by default; the port holds
    them to f32 (``_device.ieee_f32``) in the model's forward and across a
    ``DPTrainer`` step, and hands the setting back. ResNet-50's f32 logits on
    the card within 1e-4 of max|logit| of the same weights on the CPU; the
    trainer's gradient stack within 1e-5 of max|grad| of the one taken with
    TF32 off for the whole process (the same algorithms, up to the order of
    cuDNN's weight-gradient sums). With the hold taken out, TF32 misses both
    bands: they can see it."""
    from akka_allreduce_tpu_torch.models import ResNet50
    from akka_allreduce_tpu_torch.models import resnet as resnet_mod
    from akka_allreduce_tpu_torch.train import trainer as trainer_mod

    assert torch.backends.cudnn.allow_tf32  # PyTorch's default
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, 8))
    model = ResNet50(1000, device=card)
    want = ResNet50(1000, device="cpu")(x[:4]).detach()
    t = DPTrainer(model, line_mesh(8, device=card))

    def logit_err():
        with torch.no_grad():
            got = model(x[:4].to(card)).cpu()
        return float((got - want).abs().max() / want.abs().max())

    def stack():
        return t.rank_gradients(x.to(card), y.to(card))[0]

    assert logit_err() <= 1e-4 and torch.backends.cudnn.allow_tf32
    ours = stack()
    assert torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ieee = stack()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    scale = float(ieee.abs().max())
    assert float((ours - ieee).abs().max()) <= 1e-5 * scale
    for mod in (resnet_mod, trainer_mod):
        monkeypatch.setattr(mod, "ieee_f32", contextlib.nullcontext)
    assert logit_err() > 1e-4
    assert float((stack() - ieee).abs().max()) > 1e-5 * scale


# -- the host engine, its round buffers on the card ---------------------------


@pytest.mark.parametrize(
    "shape",
    [dict(size=1_000_000, rounds=30),  # BASELINE config 1
     dict(size=200_000, chunk=16_384, th=0.75, rounds=10, drop_worker=3),  # config 5
     dict(size=100_003, chunk=4_096, dims=2, rounds=4)],
    ids=["config1", "dropout", "butterfly"],
)
def test_engine_on_the_card_equals_its_cpu_run(card, shape):
    """Every node's every flush, data and counts, bit for bit: the same
    order of messages gives the same f32 adds on either device."""
    before = kernel_counts()
    on_card = local_engine(device=card, keep_outputs=True, **shape)
    seen = {}

    def look(env):
        seen.update((t.data_ptr(), t.is_cuda) for t in engine_buffers(on_card.system))
        return False

    if "drop_worker" not in shape:
        on_card.system.router.drop_filter = look
    on_card.run()
    on_cpu = local_engine(device="cpu", keep_outputs=True, **shape).run()
    assert engine_flushes_equal(on_card, on_cpu) == sum(map(len, on_cpu.outputs)) > 0
    assert len(on_card.outputs[0]) == shape["rounds"]
    assert all(seen.values())
    assert kernel_counts() == before  # no K1-K4 on the engine's path


def test_engine_round_copies_nothing_back_to_the_host(card):
    engine = local_engine(1_000_000, rounds=3, device=card)  # inputs on the card
    prof = profile_engine(engine.run)
    assert prof["dtoh"] == 0 and prof["htod"] == 0
    assert not prof["k1_k4"] and prof["launches"] > 0


def _zero1(card, n=8, **kw):
    return Zero1DPTrainer(MLP(hidden=(256, 128), seed=1, device=card), line_mesh(n, device=card),
                          optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3), **kw)


def test_zero1_f32_step_launches_k1_once_equal_to_dp_trainer(card):
    """Each f32 ZeRO-1 step reduce-scatters through one K1 launch on its
    ``(8, padded)`` stack, and its flat weights equal ``DPTrainer``'s with
    the same optimizer, bit for bit."""
    z = _zero1(card)
    d = DPTrainer(MLP(hidden=(256, 128), seed=1, device=card), line_mesh(8, device=card),
                  optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3))
    batches = list(mnist_like().batches(64, 3))
    before = lr.LAUNCHES["masked_average"]
    for (x, y), v in zip(batches, [None, [1, 1, 1, 0, 1, 1, 1, 1], None]):
        mz = z.train_step(x, y, v)
        assert lr.LAUNCHES["masked_average"] == before + 1
        before += 1
        md = d.train_step(x, y, v)
        before += 1
        assert mz.loss == md.loss and mz.contributors == md.contributors
    np.testing.assert_array_equal(z.get_flat_params(), d.get_flat_params())
    assert z.flat_params.is_cuda and z._padded % 8 == 0


def test_async_capture_is_of_capture_time_through_pinned_buffers(card, tmp_path):
    """The async save clones each leaf on the card and drains the clones on a
    side stream into pinned host buffers while in-place Adam steps change the
    live weights: the store holds the values of the moment of ``save``, the
    buffers are pinned and reused by the next save, and the restored trainer
    continues bit-equal to the one that saved."""
    t = _zero1(card)
    batches = list(mnist_like().batches(64, 6))
    t.train_step(*batches[0], [1, 1, 1, 0, 1, 1, 1, 1])
    ref = t.checkpoint_state()
    with AsyncDeltaCheckpointer(tmp_path / "a") as ck:
        assert ck.save(t)
        for x, y in batches[1:4]:
            t.train_step(x, y)
        ck.wait_until_finished()
        bufs = dict(ck.host_buffers.buffers)
        assert bufs and all(b.is_pinned() for b in bufs.values())
        live = t.checkpoint_state()
        assert not np.array_equal(live["flat_params"], ref["flat_params"])
        fresh = _zero1(card)
        assert ck.restore(fresh) == 1
        got = fresh.checkpoint_state()
        for key in ("flat_params", "ef_sum", "format_version"):
            np.testing.assert_array_equal(got[key], ref[key])
        for a, b in zip(got["opt_state"][0], ref["opt_state"][0]):
            np.testing.assert_array_equal(a, b)
        for x, y in batches[1:4]:
            fresh.train_step(x, y)
        np.testing.assert_array_equal(fresh.get_flat_params(), t.get_flat_params())
        assert ck.save(t, block=True)
        assert all(ck.host_buffers.buffers[k] is b for k, b in bufs.items())


# -- the TCP control plane, the nodes' round buffers on the card ---------------


@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
def test_card_payload_frames_equal_their_cpu_copys(card, mode):
    """A payload on the card encodes to the bytes of its CPU copy in every
    wire mode, NaN, infinities and values past f16's range included."""
    from akka_allreduce_tpu_torch.control import wire
    from akka_allreduce_tpu_torch.protocol import ReduceBlock, ScatterBlock

    x = torch.from_numpy(np.random.default_rng(9).standard_normal(70_001).astype(np.float32))
    x[[3, 99, 1000]] = torch.tensor([float("nan"), float("inf"), -7e4])
    for make in (lambda v: ScatterBlock(v, 1, 2, 3, 4), lambda v: ReduceBlock(v, 1, 2, 3, 4, 3)):
        on_card, on_cpu = make(x.to(card)), make(x.clone())
        assert wire.encode_frame("worker:2", on_card, wire=mode) == wire.encode_frame(
            "worker:2", on_cpu, wire=mode)
        assert wire.to_host(on_card).value.device.type == "cpu"


def test_deferred_frame_reads_the_stream_that_wrote_the_sums(card):
    """The engine's adds run on a side stream behind a long sleep; the
    ReduceBlock sent right after reduce is encoded later on a sender thread,
    while round r + 1's adds and a late arrival for round r are queued. Its
    bytes must be round r's sum at reduce time: the copy to the host runs on
    the stream that wrote the sums, when the message is sent."""
    import asyncio

    from akka_allreduce_tpu_torch.buffers import ScatteredDataBuffer
    from akka_allreduce_tpu_torch.config import DataPlaneConfig, MetaDataConfig, ThresholdConfig
    from akka_allreduce_tpu_torch.control.envelope import Envelope
    from akka_allreduce_tpu_torch.control.remote import RemoteTransport
    from akka_allreduce_tpu_torch.protocol import ReduceBlock

    n = 1 << 20
    md, th = MetaDataConfig(data_size=n, max_chunk_size=n), ThresholdConfig(1.0, 0.5, 1.0)
    parts = [torch.from_numpy(np.random.default_rng(k).standard_normal(n).astype(np.float32))
             for k in range(4)]
    expected = (parts[0] + parts[1]).numpy()
    # on the card before the sleep, so that the stores are queued copies and
    # adds on the side stream, not synchronous uploads
    dparts = [p.to(card) for p in parts]
    torch.cuda.synchronize(card)
    side = torch.cuda.Stream(card)

    async def run():
        rx = RemoteTransport(device="cpu")
        tx = RemoteTransport(device=card)
        tx.configure_data_plane(DataPlaneConfig(streams=3))
        got: list = []
        rx.register("sink", lambda m: got.append(m) or [])
        ep = await rx.start()
        await tx.start()
        tx.set_route("sink", ep)
        try:
            with torch.cuda.stream(side):
                r0 = ScatteredDataBuffer(md, th, 4, block_size=n, device=card)
                r1 = ScatteredDataBuffer(md, th, 4, block_size=n, device=card)
                torch.cuda._sleep(200_000_000)  # the adds below land late
                r0.store(dparts[0], 0, 0)
                assert r0.store(dparts[1], 1, 0)
                value, count = r0.reduce(0)
                await tx.send(Envelope("sink", ReduceBlock(value, 0, 1, 0, 0, count)))
                for src in range(4):
                    r1.store(dparts[src] * 3.0, src, 0)
                r0.store(dparts[2], 2, 0)
            loop = asyncio.get_running_loop()
            end = loop.time() + 20.0
            while not got:
                assert loop.time() < end
                await asyncio.sleep(0.01)
            np.testing.assert_array_equal(got[0].value.numpy(), expected)
            assert tx.stage_seconds["d2h"] > 0
        finally:
            await tx.stop()
            await rx.stop()

    asyncio.run(asyncio.wait_for(run(), 60.0))


def test_three_node_cluster_on_the_card_matches_the_numpy_mean(card):
    """A master and three ``NodeProcess(device="cuda")`` nodes over loopback
    TCP: every node's last flush is the numpy mean of the three payloads,
    the outputs stay on the card, and no K1-K4 kernel runs."""
    from chip_smoke import inproc_cluster, inproc_mean_err

    before = kernel_counts()
    h = inproc_cluster(card, nodes=3, size=300_001, rounds=4)
    assert all(o.data.is_cuda for outs in h["outputs"].values() for o in outs)
    assert inproc_mean_err(h, range(3), range(3), 3) < 1e-5
    for node in h["nodes"].values():
        assert node.transport.stage_seconds["h2d"] > 0
        assert node.transport.stage_seconds["d2h"] > 0
    assert kernel_counts() == before


def test_elastic_dp_cycle_launches_k1_once_a_step_equal_to_the_oracle(card):
    """``ElasticDPTrainer`` over 4 nodes x 2 ranks on the card, 8 -> 6 -> 8
    ranks: one K1 launch an elastic step, every step bit-equal to a fresh
    ``DPTrainer`` restored from a ``Snapshot`` at each re-mesh, the final
    parameters within ``STEP_TOL`` of the same cycle on the CPU."""
    from chip_smoke import STEP_TOL_KW, elastic_dp_cycle

    cyc = elastic_dp_cycle(card, (256,), 4, oracle=True)
    assert cyc["k1_per_step"] == [1] * 6 and cyc["ranks"] == [8, 8, 6, 6, 8, 8]
    assert all(cyc["oracle_equal"]) and len(cyc["oracle_equal"]) == 6
    assert cyc["trainer"].trainer.device.type == "cuda"
    cpu = elastic_dp_cycle(torch.device("cpu"), (256,), 4)
    np.testing.assert_allclose(cyc["params"], cpu["params"], **STEP_TOL_KW)


def test_elastic_remesh_cycles_leave_no_memory_behind(card):
    """Five more drop/rejoin cycles after the first: the old trainers are
    freed, ``memory_allocated`` ends within 1 MiB of its value after the
    first cycle; once built, the elastic trainer holds one copy of the
    weights on the card, not a template beside it."""
    from chip_smoke import LEAK_BYTES, elastic_dp_cycle

    cyc = elastic_dp_cycle(card, (1024, 1024), 8, leak_cycles=5)
    weight_bytes = 4 * cyc["trainer"].param_count
    assert weight_bytes <= cyc["built_bytes"] < 1.5 * weight_bytes
    assert cyc["mem_after_first_cycle"] > 0
    assert cyc["mem_after_cycles"] - cyc["mem_after_first_cycle"] <= LEAK_BYTES
    assert cyc["k1_per_step"] == [1] * len(cyc["k1_per_step"])


def test_int8_prefill_launches_k4_once_a_layer_and_decode_none(card):
    """An int8-cache prefill at a gated length (T 1024, D 128, bf16) takes
    the dequantize branch: K4 once a layer, its logits within 2e-2 of the
    plain attention over the same dequantized cache; decode over the int8
    slots launches no K4."""
    import contextlib
    from unittest import mock

    model = TransformerLM(vocab=64, d_model=256, n_heads=2, n_layers=2,
                          compute_dtype=torch.bfloat16, seed=0, device=card)
    gen = LMGenerator(model, max_len=1024 + 4, cache_quant="int8")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 1024))).to(card)
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    cache = gen.init_cache(2)
    with torch.no_grad():
        got = model(tokens, cache)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_wgmma"] == fa.LAUNCHES["flash_attention"] == 2
    with contextlib.ExitStack() as stack, torch.no_grad():
        stack.enter_context(mock.patch.object(
            la, "flash_attention", lambda q, k, v, causal, sm_scale:
            fa.flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)))
        want = model(tokens, gen.init_cache(2))
        tok = torch.argmax(got[:, -1], dim=-1)[:, None]
        for _ in range(3):
            tok = torch.argmax(model(tok, cache)[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 2
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 2e-2, err


def test_quantized_cache_attention_on_the_card_equals_the_cpu(card):
    """One decode step over an int8 cache: the card's f32 result within
    1e-5 of max|out| of the CPU's (summation order only)."""
    from chip_smoke import QCA_TOL

    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((4, 1, 8, 64)).astype(np.float32))
    kq, vq = (torch.from_numpy(rng.integers(-127, 128, (4, 300, 2, 64)).astype(np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(1e-3, 5e-2, (4, 300, 2)).astype(np.float32))
              for _ in range(2))
    want = la.quantized_cache_attention(q, kq, ks, vq, vs, q_offset=299)
    got = la.quantized_cache_attention(*(t.to(card) for t in (q, kq, ks, vq, vs)),
                                       q_offset=299).cpu()
    assert float((got - want).abs().max()) <= QCA_TOL * float(want.abs().max())


def test_moe_step_launches_k4_once_a_layer_and_a_small_width_matches_the_cpu(card):
    """A bf16 MoE step at a gated length runs K4's forward and backward once
    a layer; at a dense width three f32 SGD steps on the card match the CPU's
    within 1e-4 (losses, aux, dropped relative; parameters of max|param|)."""
    from chip_smoke import MOE_SMALL, MOE_SMALL_TOL

    from akka_allreduce_tpu_torch.models import lm_copy_task
    from akka_allreduce_tpu_torch.train import MoETrainer

    t = MoETrainer(vocab=64, d_model=256, n_heads=2, n_layers=2, n_experts=4, seq_len=1024,
                   compute_dtype=torch.bfloat16, device=card)
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    m = t.train_step(*next(lm_copy_task(1024, vocab=64).batches(2, 1)))
    torch.cuda.synchronize()
    assert np.isfinite(m.loss)
    assert fa.LAUNCHES["flash_attention_wgmma"] == fa.LAUNCHES["flash_attention_bwd_wgmma"] == 2
    kw = dict(**MOE_SMALL, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    cpu, on_card = MoETrainer(**kw, device="cpu"), MoETrainer(**kw, device=card)
    on_card.set_flat_params(cpu.get_flat_params())
    for x, y in lm_copy_task(MOE_SMALL["seq_len"], vocab=MOE_SMALL["vocab"]).batches(8, 3):
        a, b = on_card.train_step(x, y), cpu.train_step(x, y)
        for key in ("loss", "aux_loss", "dropped"):
            assert abs(getattr(a, key) - getattr(b, key)) <= MOE_SMALL_TOL * max(
                abs(getattr(b, key)), 1e-6), (key, a, b)
    want = cpu.get_flat_params()
    assert np.abs(on_card.get_flat_params() - want).max() <= MOE_SMALL_TOL * np.abs(want).max()


# -- the LM's trainer over virtual ranks -----------------------------------------


def test_sharded_training_step_folds_the_ranks_into_one_launch(card):
    """Ulysses over (data, seq, model) = (2, 2, 2) at T 2048: each seq rank
    attends over the whole sequence on its heads, all 8 ranks in one K4
    launch a layer, forward and backward; the replicated gradient class
    through K1 once a step; a masked replica row counts no contributor."""
    trainer = LongContextTrainer(data_seq_model_mesh(2, 2, 2, device=card), vocab=32,
                                 d_model=256, n_heads=4, n_layers=2, seq_len=2048,
                                 seq_impl="ulysses", compute_dtype=torch.bfloat16,
                                 learning_rate=1e-3)
    x, y = next(SyntheticCopyLM(2048, vocab=32).batches(4, 1))
    before_fa, before_k1 = dict(fa.LAUNCHES), lr.LAUNCHES["masked_average"]
    m = trainer.train_step(x, y)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_wgmma"] == before_fa["flash_attention_wgmma"] + 2
    assert (fa.LAUNCHES["flash_attention_bwd_wgmma"]
            == before_fa["flash_attention_bwd_wgmma"] + 2)
    assert lr.LAUNCHES["masked_average"] == before_k1 + 1
    assert np.isfinite(m.loss) and m.contributors == 2.0
    assert trainer.train_step(x, y, valid=[1.0, 0.0]).contributors == 1.0


@pytest.mark.parametrize("shape,kw", [((2, 2), dict(seq_impl="ring")),
                                      ((2, 2), dict(seq_impl="ulysses")),
                                      ((2, 2, 2), dict(seq_impl="ring")),
                                      ((2, 2, 2), dict(seq_impl="ring", overlap=True))])
def test_sharded_steps_on_the_card_match_the_cpu(card, shape, kw):
    """Two SGD steps at a small width (dense attention: no K4) on the card
    against the CPU from the same weights: losses within 1e-5 relative, the
    parameters within 1e-5 of max|param|."""
    mesh = data_seq_mesh if len(shape) == 2 else data_seq_model_mesh
    cfg = dict(vocab=32, d_model=64, n_heads=4, n_layers=2, seq_len=128,
               optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1), **kw)
    on_card = LongContextTrainer(mesh(*shape, device=card), **cfg)
    cpu = LongContextTrainer(mesh(*shape, device="cpu"), **cfg)
    cpu.set_flat_params(on_card.get_flat_params())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i, (x, y) in enumerate(SyntheticCopyLM(128, vocab=32).batches(4, 2)):
            valid = [1.0, 0.0] if i else None
            a, b = on_card.train_step(x, y, valid), cpu.train_step(x, y, valid)
            assert a.contributors == b.contributors
            assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    got, want = on_card.get_flat_params(), cpu.get_flat_params()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -- sharded decode and MoE over virtual ranks ---------------------------------------


def test_tp_decode_prefill_folds_the_ranks_into_one_k4_launch(card):
    """Decode over (model,) tp 2 at a gated prompt (T 1024, D 128, bf16): the
    prefill launches K4's forward once a layer for both ranks, the decode
    steps none, every rank's logits equal and within 2e-2 of max|logit| of
    the unsharded generator's; over (seq,) sp 2 no K4 (the split-K merge);
    in f32 the greedy tokens of (model,), (seq,) and (seq, model) meshes
    equal the unsharded generator's."""
    from chip_smoke import teacher_forced

    from akka_allreduce_tpu_torch.parallel import RankMesh

    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 1028))).to(card)
    model = TransformerLM(vocab=64, d_model=256, n_heads=2, n_layers=2,
                          compute_dtype=torch.bfloat16, seed=0, device=card)
    want = teacher_forced(LMGenerator(model, 1040), tokens, 1024)
    for axes, k4 in ((("model",), 2), (("seq",), 0)):
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        gen = LMGenerator(model, 1040, mesh=RankMesh(axes, (2,), card))
        got = teacher_forced(gen, tokens, 1024, every_rank=True)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention_wgmma"] == fa.LAUNCHES["flash_attention"] == k4
        assert torch.equal(got[0], got[1])
        assert float((got[0] - want).abs().max()) <= 2e-2 * float(want.abs().max())
    model32 = TransformerLM(vocab=64, d_model=256, n_heads=2, n_layers=2, seed=0, device=card)
    ref = LMGenerator(model32, 1040).generate(tokens[:, :1024], 8)
    for axes, shape in ((("model",), (2,)), (("seq",), (2,)), (("seq", "model"), (2, 2))):
        gen = LMGenerator(model32, 1040, mesh=RankMesh(axes, shape, card))
        assert torch.equal(gen.generate(tokens[:, :1024], 8), ref)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sharded_decode_on_the_card_matches_the_cpu(card, quant):
    """f32 decode over (data, seq, model) = (2, 2, 2) at a small width, a
    prefill chunk spanning seq ranks then single tokens: the card's logits
    within 1e-5 of max|logit| of the CPU's (the same seeded weights)."""
    from chip_smoke import teacher_forced

    from akka_allreduce_tpu_torch.parallel import RankMesh

    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (2, 12)))
    got, want = (
        teacher_forced(LMGenerator(
            TransformerLM(vocab=32, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, seed=0,
                          device=d),
            16, cache_quant=quant,
            mesh=RankMesh(("data", "seq", "model"), (2, 2, 2), torch.device(d))),
            tokens.to(d), 6).cpu()
        for d in (card, "cpu"))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_moe_over_ranks_folds_the_ranks_and_matches_the_cpu(card):
    """A bf16 MoE step over (data, expert) = (2, 4) at a gated length: K4's
    forward and backward once a layer for all 8 ranks, K1 once a step (the
    replicated class); at a small width over (data, seq, expert) = (2, 2, 2)
    two SGD steps (the second with replica row 1 masked) on the card within
    1e-5 of the CPU's."""
    from akka_allreduce_tpu_torch.models import lm_copy_task
    from akka_allreduce_tpu_torch.parallel import RankMesh
    from akka_allreduce_tpu_torch.train import MoETrainer

    t = MoETrainer(RankMesh(("data", "expert"), (2, 4), card), vocab=64, d_model=256,
                   n_heads=2, n_layers=2, n_experts=8, seq_len=1024,
                   compute_dtype=torch.bfloat16)
    before_fa, before_k1 = dict(fa.LAUNCHES), lr.LAUNCHES["masked_average"]
    m = t.train_step(*next(lm_copy_task(1024, vocab=64).batches(8, 1)))
    torch.cuda.synchronize()
    assert np.isfinite(m.loss) and m.contributors == 2.0
    for name in ("flash_attention_wgmma", "flash_attention_bwd_wgmma"):
        assert fa.LAUNCHES[name] == before_fa[name] + 2
    assert lr.LAUNCHES["masked_average"] == before_k1 + 1
    kw = dict(vocab=32, d_model=64, n_heads=4, n_layers=2, n_experts=4, seq_len=64,
              capacity_factor=4.0, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05))
    on_card, cpu = (MoETrainer(RankMesh(("data", "seq", "expert"), (2, 2, 2), torch.device(d)),
                               **kw) for d in (card, "cpu"))
    cpu.set_flat_params(on_card.get_flat_params())
    for i, (x, y) in enumerate(lm_copy_task(64, vocab=32).batches(8, 2)):
        valid = [1.0, 0.0] if i else None
        a, b = on_card.train_step(x, y, valid), cpu.train_step(x, y, valid)
        assert a.contributors == b.contributors
        assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)
    got, want = on_card.get_flat_params(), cpu.get_flat_params()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
