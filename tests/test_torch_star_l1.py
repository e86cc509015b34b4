"""Kernel 14's plain version (superresolution_tpu_torch/ops/star_l1.py on
CPU tensors, losses/basic.star_weighted_l1) and the port's CombinedLoss
against the JAX package: star_weighted_l1_pallas in interpret mode, and
the jnp losses. Value and gradient within 1e-5 relative, at a ragged n
(not a multiple of the kernel's block) and at a custom threshold and
weight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_tpu.losses.combined import CombinedLoss as JaxLoss
from superresolution_tpu.ops.pallas_loss import star_weighted_l1_pallas
from superresolution_tpu.utils.config import LossConfig as JaxLossConfig
from superresolution_tpu_torch.losses.combined import CombinedLoss
from superresolution_tpu_torch.ops import star_l1
from superresolution_tpu_torch.utils.config import LossConfig


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    t = rng.random(shape, dtype=np.float32) * 0.04
    p = (t + rng.standard_normal(shape) * 0.01).astype(np.float32)
    return p, t


@pytest.mark.parametrize("shape,thr,w", [
    ((2, 33, 37, 1), 0.02, 500.0),      # 2442 elements: ragged n
    ((1, 64, 64, 1), 0.02, 500.0),
    ((7, 11, 13), 0.01, 10.0),          # custom threshold and weight
])
def test_value_and_grad_match_jax_kernel(shape, thr, w):
    p, t = _pair(sum(shape), shape)
    with pltpu.force_tpu_interpret_mode():
        ref, ref_g = jax.value_and_grad(
            lambda a: star_weighted_l1_pallas(a, jnp.asarray(t), thr, w) * 1.7
        )(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    before = star_l1.star_weighted_l1_cuda.launches
    got = star_l1.star_weighted_l1_cuda(pt, torch.from_numpy(t), thr, w) * 1.7
    got.backward()
    assert star_l1.star_weighted_l1_cuda.launches == before  # plain on CPU
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-12)


def test_threshold_is_strict():
    t = np.full((4,), 0.02, np.float32)
    p = np.zeros((4,), np.float32)
    got = star_l1.star_weighted_l1_cuda(torch.from_numpy(p),
                                        torch.from_numpy(t))
    assert float(got) == pytest.approx(0.02)  # weight 1 at t == thr


def test_autograd_function_raises_off_cuda():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        star_l1.StarWeightedL1.apply(p, p, 0.02, 500.0)


@pytest.mark.parametrize("terms", [
    {"star_l1": 1.0}, {"l1": 1.0, "l2": 0.5},
    {"charbonnier": 1.0, "astro": 0.05, "star_l1_pallas": 0.1}])
def test_combined_loss_matches_jax(terms):
    p, t = _pair(5, (2, 16, 16, 1))
    with pltpu.force_tpu_interpret_mode():  # star_l1_pallas on the CPU
        ref_total, ref_logs = JaxLoss(JaxLossConfig(terms=terms))(
            jnp.asarray(p), jnp.asarray(t))
    total, logs = CombinedLoss(LossConfig(terms=terms))(
        torch.from_numpy(p), torch.from_numpy(t))
    assert set(logs) == set(ref_logs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(ref_logs[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)


def test_combined_loss_terms_not_ported():
    x = torch.zeros(1, 4, 4, 1)
    with pytest.raises(NotImplementedError, match="VGG19"):
        CombinedLoss(LossConfig(terms={"perceptual": 1.0}))(x, x)
    total, logs = CombinedLoss(LossConfig(terms={"l1": 1.0, "gan": 0.1}))(
        x, x)
    assert "gan" not in logs and float(total) == 0.0
