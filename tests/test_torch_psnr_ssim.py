"""The port's PSNR / SSIM (superresolution_tpu_torch/metrics/psnr_ssim.py)
against the JAX package's, in f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

from superresolution_tpu.metrics import psnr_ssim as J
from superresolution_tpu_torch.metrics import psnr_ssim as T


def _imgs(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((3, 24, 20, 2), dtype=np.float32)
    b = np.clip(a + rng.standard_normal(a.shape) * 0.1, -0.2, 1.2) \
        .astype(np.float32)
    return a, b


def test_psnr_ssim_match_jax():
    a, b = _imgs()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(T.psnr(tb, ta).numpy(),
                               np.asarray(J.psnr(jnp.asarray(b), a)),
                               rtol=1e-5)
    np.testing.assert_allclose(T.psnr(tb, ta, clamp=False).numpy(),
                               np.asarray(J.psnr(jnp.asarray(b), a,
                                                 clamp=False)), rtol=1e-5)
    np.testing.assert_allclose(T.ssim(tb, ta).numpy(),
                               np.asarray(J.ssim(jnp.asarray(b), a)),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(T.ssim_reference(tb, ta)),
                               float(J.ssim_reference(jnp.asarray(b), a)),
                               rtol=1e-4)


def test_metrics_accumulator_matches_jax():
    a, b = _imgs(1)
    m, jm = T.Metrics(), J.Metrics()
    for sl in (slice(0, 2), slice(2, 3)):
        m.update(torch.from_numpy(b[sl]), torch.from_numpy(a[sl]))
        jm.update(jnp.asarray(b[sl]), jnp.asarray(a[sl]))
    got, ref = m.compute(), jm.compute()
    assert abs(got["psnr"] - ref["psnr"]) < 1e-4
    assert abs(got["ssim"] - ref["ssim"]) < 1e-5
    m.reset()
    assert m.compute() == {"psnr": 0.0, "ssim": 0.0}
    m.update_sums(30.0, 1.5, 2)
    assert m.compute() == {"psnr": 15.0, "ssim": 0.75}
