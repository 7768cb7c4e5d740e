"""The port's CUDA kernels (K1 masked_average, K2 elastic_average_step)
against their plain PyTorch versions on the card.

Marked ``gpu``; without a card every test skips (decided in the ``card``
fixture, never at import). Run on the card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.

The kernels avoid FMA contraction, so they are held to bit equality with the
plain versions (which run as separate mul and add kernels on the card).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.ops import local_reduce as lr

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
