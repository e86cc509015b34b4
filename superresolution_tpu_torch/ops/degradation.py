"""Synthetic LR degradation: blur, bicubic downscale, noise, JPEG.

Counterpart of superresolution_tpu/ops/degradation.py (degrade_bicubic,
gaussian_blur_random, add_gaussian_noise, jpeg_compress with _dct8 and
_quality_scale, degradation_pipeline). Every stage is plain PyTorch in
f32 where the images are, as the reference computes them outside any
Pallas kernel: the 21-tap Gaussian as a banded matrix along H and W
(zero padding, SAME), the bicubic downscale as ops/resize's matrices,
the 8x8 block DCT as matmuls. The stages take NHWC batches with one
draw per image (or one for all).

The draws (blur sigma, noise sigma in 8-bit units, JPEG quality, the
noise field) come from an explicit torch.Generator on the CPU, so they
cost no device sync; degrade_with_draws takes them as arguments, so a
test can fix them. The reference draws from a JAX key, so its noise and
draws cannot match bit for bit: with the draws fixed, every stage
matches it to f32 rounding, except that a DCT coefficient within
rounding of a .5 quantization tie may round the other way.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from superresolution_tpu_torch.ops.resize import resize_bicubic

_BLUR_KSIZE = 21  # the reference's fixed support

_Q_LUMA = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32)

MODES = ("none", "bicubic", "blur_bicubic", "bsr_light")


def _per_image(v, b: int, device) -> torch.Tensor:
    """A draw given per image ([B]) or once (a scalar) -> [B] f32."""
    return torch.as_tensor(v, dtype=torch.float32).reshape(-1).expand(
        b).to(device)


def _gaussian_1d(sigma: torch.Tensor) -> torch.Tensor:
    """[B] sigmas -> [B, 21] normalized taps (sigma floored at 1e-4, so
    sigma <= 0 is a delta)."""
    xs = torch.arange(_BLUR_KSIZE, dtype=torch.float32,
                      device=sigma.device) - (_BLUR_KSIZE - 1) / 2.0
    g = torch.exp(-(xs ** 2) / (2.0 * sigma.clamp(min=1e-4)[:, None] ** 2))
    return g / g.sum(-1, keepdim=True)


def _band(g: torch.Tensor, n: int) -> torch.Tensor:
    """[B, 21] taps -> [B, n, n]: out[i] = sum_k M[i, k] in[k], the SAME
    zero-padded 1-D convolution along a length-n axis."""
    r = (_BLUR_KSIZE - 1) // 2
    i = torch.arange(n, device=g.device)
    d = i[None, :] - i[:, None] + r           # tap index of in[k] for out[i]
    ok = (d >= 0) & (d < _BLUR_KSIZE)
    return torch.where(ok, g[:, d.clamp(0, _BLUR_KSIZE - 1)],
                       torch.zeros((), dtype=g.dtype, device=g.device))


def gaussian_blur_random(x: torch.Tensor, sigma) -> torch.Tensor:
    """Separable 21-tap Gaussian blur of NHWC `x` (f32), one sigma per
    image, SAME zero padding (ops/degradation.py:31-47 there)."""
    b, h, w, _ = x.shape
    g = _gaussian_1d(_per_image(sigma, b, x.device))
    out = torch.einsum("bik,bkwc->biwc", _band(g, h), x.float())
    out = torch.einsum("bjk,bhkc->bhjc", _band(g, w), out)
    return out.to(x.dtype)


def degrade_bicubic(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """PIL/MATLAB-convention bicubic x1/scale downscale of HWC/NHWC `hr`
    (a=-0.5, antialiased, border window renormalized)."""
    h, w = hr.shape[-3], hr.shape[-2]
    return resize_bicubic(hr, (h // scale, w // scale), a=-0.5,
                          antialias=True, border="renorm")


def add_gaussian_noise(x: torch.Tensor, sigma255, noise) -> torch.Tensor:
    """clip(x + noise * sigma255 / 255, 0, 1): `noise` a standard normal
    field of x's shape, sigma in 8-bit units, one per image."""
    s = _per_image(sigma255, x.shape[0], x.device) / 255.0
    return (x + noise.to(x) * s[:, None, None, None]).clamp(0.0, 1.0)


@lru_cache(maxsize=None)
def _dct8() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix."""
    n = 8
    d = np.zeros((n, n), dtype=np.float64)
    for k in range(n):
        for i in range(n):
            d[k, i] = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] /= np.sqrt(2.0)
    return d.astype(np.float32)


def _quality_scale(quality: torch.Tensor) -> torch.Tensor:
    """libjpeg quality -> quant-table scale factor."""
    q = quality.clamp(1.0, 100.0)
    return torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)


def jpeg_compress(x: torch.Tensor, quality) -> torch.Tensor:
    """Grayscale-model JPEG round trip of NHWC `x` in [0, 1], one quality
    per image: the luminance path per channel, 8x8 block DCT, quantized
    with the quality-scaled table (round half to even), inverse DCT. H
    and W must be multiples of 8."""
    b, h, w, c = x.shape
    if h % 8 or w % 8:
        raise ValueError("jpeg_compress needs H, W divisible by 8")
    d = torch.from_numpy(_dct8()).to(x.device)
    scale = _quality_scale(_per_image(quality, b, x.device))
    qtab = torch.floor((torch.from_numpy(_Q_LUMA).to(x.device)
                        * scale[:, None, None] + 50.0) / 100.0)
    qtab = qtab.clamp(1.0, 255.0)[:, None, None, None]  # [B,1,1,1,8,8]
    v = x.float() * 255.0 - 128.0
    blocks = v.reshape(b, h // 8, 8, w // 8, 8, c).permute(0, 1, 3, 5, 2, 4)
    coef = torch.einsum("ki,...ij,lj->...kl", d, blocks, d)
    coef = torch.round(coef / qtab) * qtab
    rec = torch.einsum("ki,...kl,lj->...ij", d, coef, d)
    out = rec.permute(0, 1, 4, 2, 5, 3).reshape(b, h, w, c)
    return ((out + 128.0) / 255.0).clamp(0.0, 1.0).to(x.dtype)


def degrade_with_draws(hr: torch.Tensor, scale: int, mode: str,
                       sigma=None, noise_sigma=0.0, quality=None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """HR [0,1] NHWC -> LR [0,1] under `mode` with the draws given: blur
    sigma, noise sigma (8-bit units) and JPEG quality (one each per
    image, or scalars), and the standard normal `noise` field of the
    LR's shape (None: no noise)."""
    if mode == "none":
        raise ValueError("mode='none' means real LR is supplied by the "
                         "dataset")
    if mode not in MODES:
        raise ValueError(f"unknown degradation mode {mode!r}")
    if mode == "bicubic":
        return degrade_bicubic(hr, scale).clamp(0.0, 1.0)
    lr = degrade_bicubic(gaussian_blur_random(hr, sigma),
                         scale).clamp(0.0, 1.0)
    if mode == "blur_bicubic":
        return lr
    if noise is not None:
        lr = add_gaussian_noise(lr, noise_sigma, noise)
    return jpeg_compress(lr, quality)


def draw_degradation(generator: torch.Generator | None, n: int,
                     blur_sigma=(0.2, 2.0), noise_sigma=(0.0, 10.0),
                     jpeg_quality=(60.0, 95.0)) -> dict[str, torch.Tensor]:
    """n images' draws, uniform in each range, from `generator` (CPU):
    {'sigma', 'noise_sigma', 'quality'}, each [n] f32."""
    u = torch.rand((3, n), generator=generator)
    lo = torch.tensor([blur_sigma[0], noise_sigma[0], jpeg_quality[0]],
                      dtype=torch.float32)[:, None]
    hi = torch.tensor([blur_sigma[1], noise_sigma[1], jpeg_quality[1]],
                      dtype=torch.float32)[:, None]
    v = lo + u * (hi - lo)
    return {"sigma": v[0], "noise_sigma": v[1], "quality": v[2]}


def degradation_pipeline(generator: torch.Generator | None,
                         hr: torch.Tensor, scale: int, mode: str = "bicubic",
                         blur_sigma=(0.2, 2.0), noise_sigma=(0.0, 10.0),
                         jpeg_quality=(60.0, 95.0)) -> torch.Tensor:
    """HR [0,1] NHWC (or one HWC image) -> LR [0,1], each image with its
    own blur sigma, noise level, JPEG quality and noise field drawn from
    `generator` (a CPU torch.Generator; None draws from torch's global
    one)."""
    if mode in ("none", "bicubic") or mode not in MODES:
        return degrade_with_draws(hr, scale, mode)
    squeeze = hr.ndim == 3
    x = hr[None] if squeeze else hr
    b, h, w, c = x.shape
    dr = draw_degradation(generator, b, blur_sigma, noise_sigma,
                          jpeg_quality)
    noise = None
    if mode == "bsr_light":
        noise = torch.randn((b, h // scale, w // scale, c),
                            generator=generator).to(x.device)
    lr = degrade_with_draws(x, scale, mode, dr["sigma"], dr["noise_sigma"],
                            dr["quality"], noise)
    return lr[0] if squeeze else lr
