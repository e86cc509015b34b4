"""Kernel 19's op (superresolution_tpu_torch/utils/dma_probe.py) on the
CPU, where the passthrough runs its plain form, x.clone(). There is no
JAX side to compare with: the reference's make_pt is local to
bench.py's dma_probe, which builds a Pallas call for the TPU and cannot
be reached from a test. What can be checked here is the copy itself
(exact), the row-band rule (H % rb raises, as the reference's grid
requires), the reference's probe shapes, and that the probe measures
only the card."""

import numpy as np
import pytest
import torch

from superresolution_tpu_torch.utils import dma_probe as dp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_passthrough_copies_exactly(dtype):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 12, 8, 16)).astype(np.float32)).to(dtype)
    before = dp.passthrough.launches
    fn = dp.make_pt(tuple(x.shape), 4)
    y = fn(x)
    assert torch.equal(y, x) and y.dtype == dtype
    assert y.data_ptr() != x.data_ptr()
    assert dp.passthrough.launches == before


@pytest.mark.parametrize("h,rb", [(12, 5), (376, 100), (8, 0)])
def test_row_band_must_divide_h(h, rb):
    with pytest.raises(ValueError, match="row band"):
        dp.make_pt((1, h, 8, 8), rb)
    with pytest.raises(ValueError, match="row band"):
        dp.passthrough(torch.zeros((1, h, 8, 8)), rb)


def test_make_pt_holds_its_shape():
    fn = dp.make_pt((1, 8, 8, 8), 4)
    with pytest.raises(ValueError, match="built for"):
        fn(torch.zeros((1, 8, 8, 4)))


def test_probe_shapes_are_the_reference_pair():
    """bench.py:dma_probe's two shapes: equal bytes, the second with half
    the pixels per row and twice the channels, both whole bands of 94
    rows."""
    (t64, s64), (t128, s128) = dp.PROBE_SHAPES
    assert (t64, s64) == ("lane64", (24, 376, 272, 64))
    assert (t128, s128) == ("lane128", (24, 376, 136, 128))
    assert np.prod(s64) == np.prod(s128)
    assert s64[1] % dp.PROBE_RB == 0 and dp.PROBE_RB == 94


def test_probe_measures_only_the_card():
    with pytest.raises(ValueError, match="measures the card"):
        dp.dma_probe("cpu")
