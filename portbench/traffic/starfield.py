"""Astronomical star fields and their observed low-resolution pairs.

A frozen copy of the port's procedural generator
(superresolution_tpu_torch/data/dataset.py: make_synthetic_image's
one-channel branch, _gaussian_blur_2d, synthesize_observed_lr), so the
benchmark's inputs stay what they are whatever the program later does
with its own copy: a dark background with faint nebulosity and
PSF-blurred stars, about 2% of pixels above the star-weighted loss's
0.02 threshold; the LR is a PSF blur at about the LR pixel scale, a
sub-LR-pixel shift, a box downsample and faint read noise.
"""

from __future__ import annotations

import numpy as np


def star_field(rng: np.random.Generator, size: int) -> np.ndarray:
    """[size, size, 1] float32 in [0, 1]."""
    img = np.zeros((size, size), np.float64)
    low = rng.random((size // 16 + 2, size // 16 + 2))
    ys = np.linspace(0, low.shape[0] - 1.001, size)
    xs = np.linspace(0, low.shape[1] - 1.001, size)
    yi, xi = ys.astype(int), xs.astype(int)
    fy, fx = ys - yi, xs - xi
    neb = ((1 - fy)[:, None] * ((1 - fx) * low[yi][:, xi]
                                + fx * low[yi][:, xi + 1])
           + fy[:, None] * ((1 - fx) * low[yi + 1][:, xi]
                           + fx * low[yi + 1][:, xi + 1]))
    img += 0.015 * neb
    n_stars = rng.integers(size // 4, size)
    ys_s = rng.random(n_stars) * size
    xs_s = rng.random(n_stars) * size
    flux = 10 ** rng.uniform(-1.5, 0.0, n_stars)
    sigma = rng.uniform(0.8, 2.0, n_stars)
    yy = np.arange(size)
    for cy, cx, f, s in zip(ys_s, xs_s, flux, sigma):
        y0, y1 = max(0, int(cy - 4 * s)), min(size, int(cy + 4 * s) + 1)
        x0, x1 = max(0, int(cx - 4 * s)), min(size, int(cx + 4 * s) + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        gy = np.exp(-((yy[y0:y1] - cy) ** 2) / (2 * s * s))
        gx = np.exp(-((yy[x0:x1] - cx) ** 2) / (2 * s * s))
        img[y0:y1, x0:x1] += f * np.outer(gy, gx)
    return np.clip(img, 0.0, 1.0).astype(np.float32)[..., None]


def _gaussian_blur_2d(img: np.ndarray, sigma: float) -> np.ndarray:
    radius = max(1, int(3.0 * sigma + 0.5))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k /= k.sum()
    for axis in (0, 1):
        pad = [(0, 0)] * img.ndim
        pad[axis] = (radius, radius)
        p = np.pad(img, pad, mode="reflect")
        out = np.zeros_like(img, np.float64)
        for t, w in enumerate(k):
            sl = [slice(None)] * img.ndim
            sl[axis] = slice(t, t + img.shape[axis])
            out += w * p[tuple(sl)]
        img = out
    return img


def observed_lr(hr: np.ndarray, scale: int,
                rng: np.random.Generator) -> np.ndarray:
    """The co-registered 'telescope' LR of an HR star field."""
    img = _gaussian_blur_2d(hr.astype(np.float64),
                            sigma=rng.uniform(0.5, 0.9) * scale)
    dy, dx = (int(rng.integers(0, scale)) for _ in range(2))
    img = np.roll(img, (dy, dx), axis=(0, 1))
    h, w, c = img.shape
    lr = img.reshape(h // scale, scale, w // scale, scale, c).mean((1, 3))
    lr += rng.normal(0.0, rng.uniform(0.5, 2.0) / 255.0, lr.shape)
    return np.clip(lr, 0.0, 1.0).astype(np.float32)
