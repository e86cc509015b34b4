"""The port's synthetic data (superresolution_tpu_torch/data/dataset.py)
is numpy, like the JAX package's: its arrays must be bit-identical."""

import numpy as np
import pytest

from superresolution_tpu.data import dataset as jax_ds
from superresolution_tpu_torch.data import dataset as ds


@pytest.mark.parametrize("channels,lr_scale", [(1, 4), (1, None), (3, 2)])
def test_synthetic_dataset_bit_identical(channels, lr_scale):
    a = ds.SyntheticHRDataset(3, 64, channels, seed=2, lr_scale=lr_scale)
    b = jax_ds.SyntheticHRDataset(3, 64, channels, seed=2, lr_scale=lr_scale)
    assert len(a) == len(b) == 3
    for i in (0, 2, 4):  # 4 wraps around, as the reference's
        x, y = a[i], b[i]
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_observed_lr_and_blur_bit_identical():
    hr = ds.make_synthetic_image(5, 32, 1, seed=7)
    np.testing.assert_array_equal(
        ds._gaussian_blur_2d(hr.astype(np.float64), 1.3),
        jax_ds._gaussian_blur_2d(hr.astype(np.float64), 1.3))
    lr = ds.synthesize_observed_lr(hr, 4, np.random.default_rng(3))
    ref = jax_ds.synthesize_observed_lr(hr, 4, np.random.default_rng(3))
    assert lr.shape == (8, 8, 1)
    np.testing.assert_array_equal(lr, ref)
