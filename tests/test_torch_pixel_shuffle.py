"""The PyTorch port's depth_to_space / space_to_depth
(superresolution_tpu_torch/ops/pixel_shuffle.py) equal the JAX package's
bit for bit, in torch.nn.PixelShuffle's channel order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import pixel_shuffle as jps
from superresolution_tpu_torch.ops.pixel_shuffle import (
    depth_to_space,
    space_to_depth,
)


@pytest.mark.parametrize("r", [2, 4])
def test_depth_to_space_matches_jax(r):
    x = np.random.default_rng(r).standard_normal(
        (2, 3, 5, 3 * r * r)).astype(np.float32)
    got = depth_to_space(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jps.depth_to_space(jnp.asarray(x), r)))
    # torch.nn.PixelShuffle's order, on NHWC
    ps = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got, ps.numpy())


@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth_matches_jax_and_inverts(r):
    x = np.random.default_rng(10 + r).standard_normal(
        (2, 3 * r, 2 * r, 5)).astype(np.float32)
    got = space_to_depth(torch.from_numpy(x), r)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jps.space_to_depth(jnp.asarray(x), r)))
    np.testing.assert_array_equal(depth_to_space(got, r).numpy(), x)


def test_pixel_shuffle_rejects_bad_shapes():
    with pytest.raises(ValueError):
        depth_to_space(torch.zeros(1, 2, 2, 6), 2)
    with pytest.raises(ValueError):
        space_to_depth(torch.zeros(1, 3, 4, 1), 2)
