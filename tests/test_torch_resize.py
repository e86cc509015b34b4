"""The port's resize and degradation (superresolution_tpu_torch/ops/
resize.py, degradation.py) against the JAX package's, in f32 within 1e-6
of max |ref|: every bicubic convention (a -0.5 and -0.75, antialias on
and off, replicate and renorm borders), up and down, NHWC and HWC; the
interpolation matrices exactly; nearest; degrade_bicubic; HybridSR's
resize to output_size (models/hybrid.resize_to_output)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import degradation as jdeg
from superresolution_tpu.ops import resize as jresize
from superresolution_tpu_torch.models.hybrid import resize_to_output
from superresolution_tpu_torch.ops import resize
from superresolution_tpu_torch.ops.degradation import degrade_bicubic

TOL = 1e-6


def _close(got: torch.Tensor, ref) -> None:
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.max(np.abs(got - ref)) <= TOL * np.max(np.abs(ref))


@pytest.mark.parametrize("n_in,n_out", [(16, 40), (40, 16), (17, 5)])
@pytest.mark.parametrize("a,antialias,border", [
    (-0.5, True, "replicate"), (-0.5, True, "renorm"),
    (-0.5, False, "replicate"), (-0.75, False, "replicate"),
    (-0.75, True, "renorm")])
def test_resize_matrix_equals_jax(n_in, n_out, a, antialias, border):
    np.testing.assert_array_equal(
        resize._resize_matrix(n_in, n_out, a, antialias, border),
        jresize._resize_matrix(n_in, n_out, a, antialias, border))


@pytest.mark.parametrize("shape,out_hw", [((2, 12, 20, 3), (30, 8)),
                                          ((9, 7, 1), (27, 21))])
@pytest.mark.parametrize("a,antialias,border", [
    (-0.5, True, "replicate"), (-0.5, True, "renorm"),
    (-0.75, False, "replicate")])
def test_resize_bicubic_matches_jax(shape, out_hw, a, antialias, border):
    x = np.random.default_rng(0).random(shape, np.float32)
    ref = jresize.resize_bicubic(jnp.asarray(x), out_hw, a, antialias,
                                 border)
    _close(resize.resize_bicubic(torch.from_numpy(x), out_hw, a, antialias,
                                 border), ref)


def test_resize_nearest_equals_jax():
    x = np.random.default_rng(1).random((2, 5, 7, 2), np.float32)
    for out_hw in ((15, 21), (3, 4)):
        np.testing.assert_array_equal(
            resize.resize_nearest(torch.from_numpy(x), out_hw).numpy(),
            np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw)))
    np.testing.assert_array_equal(
        resize.resize_nearest(torch.from_numpy(x[0]), (10, 14)).numpy(),
        np.asarray(jresize.resize_nearest(jnp.asarray(x[0]), (10, 14))))


@pytest.mark.parametrize("shape,scale", [((2, 32, 24, 3), 4),
                                         ((30, 18, 1), 3)])
def test_degrade_bicubic_matches_jax(shape, scale):
    hr = np.random.default_rng(2).random(shape, np.float32)
    _close(degrade_bicubic(torch.from_numpy(hr), scale),
           jdeg.degrade_bicubic(jnp.asarray(hr), scale))


@pytest.mark.parametrize("side,output_size", [(32, 40), (48, 20), (24, 24),
                                              (24, None)])
def test_hybrid_resize_matches_jax(side, output_size):
    """The JAX HybridSR's rule: resize (a=-0.75, no antialias) when the
    height is not output_size, else (or with no output_size) pass
    through."""
    x = np.random.default_rng(3).random((2, side, side, 1), np.float32)
    got = resize_to_output(torch.from_numpy(x), output_size)
    if output_size in (None, side):
        np.testing.assert_array_equal(got.numpy(), x)
        return
    _close(got, jresize.resize_bicubic(jnp.asarray(x),
                                       (output_size, output_size),
                                       a=-0.75, antialias=False))


def test_resize_keeps_dtype():
    x = torch.rand(1, 6, 6, 1).to(torch.bfloat16)
    assert resize.resize_bicubic(x, (12, 12)).dtype == torch.bfloat16
