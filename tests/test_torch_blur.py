"""The port's fixed smoothing filters (superresolution_tpu_torch/ops/
blur.py) against the JAX package's, on the same numpy inputs, f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import blur as jblur
from superresolution_tpu_torch.ops import blur


@pytest.mark.parametrize("size,norm", [(3, 16.0), (5, 256.0), (7, 1600.0),
                                       (5, None)])
def test_binomial_kernel_equals_jax(size, norm):
    np.testing.assert_array_equal(blur.binomial_kernel(size, norm),
                                  jblur.binomial_kernel(size, norm))


@pytest.mark.parametrize("mode", ["light", "balanced", "strong"])
def test_anti_checkerboard_matches_jax(mode):
    x = np.random.default_rng(0).standard_normal((2, 13, 17, 3)).astype(
        np.float32)
    ref = np.asarray(jblur.anti_checkerboard(jnp.asarray(x), mode))
    got = blur.anti_checkerboard(torch.from_numpy(x), mode).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_depthwise_blur_unit_kernel_and_none_modes():
    x = np.random.default_rng(1).random((1, 12, 11, 2), np.float32)
    k = blur.binomial_kernel(5)
    ref = np.asarray(jblur.depthwise_blur(jnp.asarray(x), k))
    got = blur.depthwise_blur(torch.from_numpy(x), k).numpy()
    assert got.shape == ref.shape == (1, 12, 11, 2)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    t = torch.from_numpy(x)
    assert blur.anti_checkerboard(t, None) is t
    assert blur.anti_checkerboard(t, "none") is t
    with pytest.raises(ValueError):
        blur.anti_checkerboard(t, "heavy")
