"""The port's synthetic LR degradation (superresolution_tpu_torch/ops/
degradation.py) and device input stage (train/steps.make_device_input)
against the JAX package, on the same numpy-seeded images, in f32 on the
CPU.

Tolerances: the blur and the bicubic downscale 1e-5 (f32, another
summation order); the JPEG model 1e-5 on all but at most 1% of the
pixels (an f32 DCT summed in another order can move a coefficient
across a .5 quantization tie, which moves its whole 8x8 block);
degradation_pipeline with the draws fixed to the JAX key's (sigma, noise
level, quality and the noise field itself), the same. Noise cannot match
JAX bit for bit (another RNG), so it is held by its mean and standard
deviation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import degradation as jd
from superresolution_tpu.train.steps import (
    make_device_input as jax_make_device_input,
)
from superresolution_tpu.utils.config import DataConfig as JaxDataConfig
from superresolution_tpu_torch.ops import degradation as td
from superresolution_tpu_torch.train.steps import make_device_input
from superresolution_tpu_torch.utils.config import DataConfig

TOL = 1e-5
JPEG_SHARE = 0.01


def _img(seed, shape=(32, 40, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _share_past(got, ref, tol=TOL):
    return float(np.mean(np.abs(np.asarray(got) - np.asarray(ref)) > tol))


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.7, 3.0])
def test_blur_matches_jax(sigma):
    x = _img(1)
    ref = jd.gaussian_blur_random(jnp.asarray(x), jnp.float32(sigma))
    got = td.gaussian_blur_random(torch.from_numpy(x)[None], sigma)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_blur_batch_takes_one_sigma_per_image():
    x = np.stack([_img(2), _img(3)])
    got = td.gaussian_blur_random(torch.from_numpy(x),
                                  torch.tensor([0.4, 2.2]))
    for i, s in enumerate((0.4, 2.2)):
        ref = jd.gaussian_blur_random(jnp.asarray(x[i]), jnp.float32(s))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_bicubic_matches_jax(scale):
    x = _img(4, (2, 48, 36, 3))
    ref = jd.degrade_bicubic(jnp.asarray(x), scale)
    got = td.degrade_bicubic(torch.from_numpy(x), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("quality", [5.0, 37.5, 60.0, 77.3, 95.0, 100.0])
def test_jpeg_matches_jax(quality):
    x = _img(5, (32, 48, 3))
    ref = np.asarray(jd.jpeg_compress(jnp.asarray(x), jnp.float32(quality)))
    got = td.jpeg_compress(torch.from_numpy(x)[None], quality)[0].numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _share_past(got, ref) <= JPEG_SHARE
    np.testing.assert_allclose(td._dct8(), jd._dct8())
    np.testing.assert_allclose(
        td._quality_scale(torch.tensor(quality)).numpy(),
        np.asarray(jd._quality_scale(jnp.float32(quality))), rtol=1e-6)


def test_jpeg_needs_blocks_of_8():
    with pytest.raises(ValueError, match="divisible by 8"):
        td.jpeg_compress(torch.zeros(1, 12, 16, 1), 80.0)


def _jax_draws(key, blur=(0.2, 2.0), noise=(0.0, 10.0), q=(60.0, 95.0)):
    """degradation_pipeline's own draws for `key` (its split and order)."""
    k_blur, k_noise, k_jpeg, k_q = jax.random.split(key, 4)
    return (float(jax.random.uniform(k_blur, (), minval=blur[0],
                                     maxval=blur[1])),
            float(jax.random.uniform(k_noise, (), minval=noise[0],
                                     maxval=noise[1])),
            float(jax.random.uniform(k_q, (), minval=q[0], maxval=q[1])),
            k_jpeg)


@pytest.mark.parametrize("mode", ["bicubic", "blur_bicubic", "bsr_light"])
def test_pipeline_matches_jax_with_the_draws_fixed(mode):
    hr = _img(6, (64, 96, 3))
    key = jax.random.key(11)
    ref = np.asarray(jd.degradation_pipeline(key, jnp.asarray(hr), 4, mode))
    sigma, ns, q, k_noise = _jax_draws(key)
    noise = np.array(jax.random.normal(k_noise, ref.shape, jnp.float32))
    got = td.degrade_with_draws(torch.from_numpy(hr)[None], 4, mode, sigma,
                                ns, q, torch.from_numpy(noise)[None])[0]
    got = got.numpy()
    assert got.shape == ref.shape == (16, 24, 3)
    if mode == "bsr_light":
        assert _share_past(got, ref) <= JPEG_SHARE
    else:
        np.testing.assert_allclose(got, ref, atol=TOL)
    if mode == "bicubic":  # no draws: the generator-driven form agrees
        np.testing.assert_allclose(
            td.degradation_pipeline(None, torch.from_numpy(hr), 4,
                                    mode).numpy(), ref, atol=TOL)


def test_pipeline_rejects_none_and_unknown():
    hr = torch.zeros(16, 16, 1)
    with pytest.raises(ValueError, match="real LR"):
        td.degradation_pipeline(None, hr, 4, "none")
    with pytest.raises(ValueError, match="unknown"):
        td.degradation_pipeline(None, hr, 4, "sinc")


def test_noise_statistics():
    """x + N(0, (sigma/255)^2), clipped: away from the clip its mean is x
    and its standard deviation sigma/255 (to 3% over 12,288 samples),
    as JAX's add_gaussian_noise."""
    x = torch.full((1, 64, 64, 3), 0.5)
    g = torch.Generator().manual_seed(0)
    for sigma in (5.0, 10.0):
        noise = torch.randn(x.shape, generator=g)
        z = (td.add_gaussian_noise(x, sigma, noise) - 0.5) * 255.0 / sigma
        assert abs(float(z.mean())) < 0.03
        assert abs(float(z.std()) - 1.0) < 0.03
    ref = np.asarray(jd.add_gaussian_noise(jax.random.key(0),
                                           jnp.full((64, 64, 3), 0.5), 10.0))
    zr = (ref - 0.5) * 25.5
    assert abs(zr.mean()) < 0.03 and abs(zr.std() - 1.0) < 0.03


def test_draws_are_uniform_in_their_ranges():
    d = td.draw_degradation(torch.Generator().manual_seed(1), 4000,
                            (0.2, 2.0), (0.0, 10.0), (60, 95))
    for k, (lo, hi) in (("sigma", (0.2, 2.0)), ("noise_sigma", (0.0, 10.0)),
                        ("quality", (60.0, 95.0))):
        v = d[k].numpy()
        assert v.min() >= lo and v.max() <= hi, k
        assert abs(v.mean() - (lo + hi) / 2) < 0.02 * (hi - lo), k


@pytest.mark.parametrize("augment", [False, True])
def test_make_device_input_bicubic_matches_jax(augment):
    """Bicubic LR from the batch's HR equals the JAX input stage's (no
    augmentation; with it, each LR/HR pair is one of the eight
    dihedral transforms of the reference pair)."""
    hr = np.stack([_img(7, (32, 32, 3)), _img(8, (32, 32, 3))])
    jfn = jax_make_device_input(JaxDataConfig(degradation="bicubic"), 4,
                                augment=False)
    ref_lr, _ = jfn(jax.random.key(0), {"hr": jnp.asarray(hr)})
    fn = make_device_input(DataConfig(degradation="bicubic"), 4,
                           augment=augment)
    lr, hr_out = fn({"hr": torch.from_numpy(hr)},
                    torch.Generator().manual_seed(0))
    ref_lr = np.asarray(ref_lr)
    if not augment:
        np.testing.assert_allclose(lr.numpy(), ref_lr, atol=TOL)
        np.testing.assert_array_equal(hr_out.numpy(), hr)
        return
    for i in range(2):
        cands = [np.rot90(f, k) for f in (ref_lr[i], ref_lr[i][:, ::-1])
                 for k in range(4)]
        assert any(np.allclose(lr[i].numpy(), c, atol=TOL) for c in cands)


@pytest.mark.parametrize("mode", ["none", "bicubic", "bsr_light"])
def test_batch_lr_wins(mode):
    """A batch's own LR is used whatever the mode, as in JAX's stage."""
    hr = np.stack([_img(9, (32, 32, 1))] * 2)
    lr = np.random.default_rng(9).random((2, 8, 8, 1), dtype=np.float32)
    fn = make_device_input(DataConfig(degradation=mode), 4, augment=False)
    got, _ = fn({"hr": torch.from_numpy(hr), "lr": torch.from_numpy(lr)},
                None)
    jfn = jax_make_device_input(JaxDataConfig(degradation=mode), 4,
                                augment=False)
    ref, _ = jfn(jax.random.key(0), {"hr": jnp.asarray(hr),
                                     "lr": jnp.asarray(lr)})
    np.testing.assert_array_equal(got.numpy(), lr)
    np.testing.assert_array_equal(np.asarray(ref), lr)


def test_each_image_gets_its_own_draws():
    """bsr_light on a batch of two identical HR images: the step's
    generator gives each its own blur, noise and quality, so the LRs
    differ; the same generator seed gives the same batch again."""
    dc = dataclasses.replace(DataConfig(), degradation="bsr_light",
                             augment=False)
    fn = make_device_input(dc, 4)
    hr = torch.from_numpy(np.stack([_img(10, (64, 64, 3))] * 2))
    a, _ = fn({"hr": hr}, torch.Generator().manual_seed(3))
    b, _ = fn({"hr": hr}, torch.Generator().manual_seed(3))
    assert a.shape == (2, 16, 16, 3)
    assert not torch.allclose(a[0], a[1], atol=1e-3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    d = td.draw_degradation(torch.Generator().manual_seed(3), 2)
    assert float((d["sigma"][0] - d["sigma"][1]).abs()) > 0
