"""Procedural synthetic HR data (numpy), with co-registered LR.

The port's own copy of the numpy part of superresolution_tpu/data/
dataset.py (make_synthetic_image, _gaussian_blur_2d,
synthesize_observed_lr, SyntheticHRDataset): the same arithmetic, so the
arrays come out bit-identical to the JAX package's. PairedDataset, the
manifest-driven real pairs, waits for data/io and data/manifest.
"""

from __future__ import annotations

import numpy as np


def make_synthetic_image(index: int, size: int, channels: int = 1,
                         seed: int = 0) -> np.ndarray:
    """Deterministic procedural HR image in [0,1].

    1-channel: astronomical starfield (dark background, PSF-blurred stars,
    faint nebulosity) — matches the star-weighted loss regime where only
    ~2% of pixels exceed the 0.02 'star' threshold.
    3-channel: band-limited multi-scale noise (texture-rich, SR-meaningful).
    """
    rng = np.random.default_rng(np.uint32(seed * 1_000_003 + index))
    if channels == 1:
        img = np.zeros((size, size), np.float64)
        # faint nebulosity: smooth low-frequency field
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
        # stars: gaussian PSFs at random positions/fluxes
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
    # RGB: sum of band-limited noise octaves
    img = np.zeros((size, size, 3), np.float64)
    for octave, amp in ((4, 0.5), (16, 0.3), (64, 0.2)):
        g = rng.random((min(octave, size), min(octave, size), 3))
        reps = -(-size // g.shape[0])
        up = np.kron(g, np.ones((reps, reps, 1)))[:size, :size]
        img += amp * up
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _gaussian_blur_2d(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur over (H, W, C), reflect-padded."""
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


def synthesize_observed_lr(hr: np.ndarray, scale: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Co-registered 'telescope' LR from an HR image: PSF blur at roughly
    the LR pixel scale, a sub-LR-pixel registration shift (the reprojection
    analog — an integer HR-pixel shift < `scale` is a fractional LR-pixel
    shift), box downsample, and faint read noise.

    This is the paired-synthetic stand-in for the reference's real-LR
    regime (reference Dataset_step3_extractpatches.py:245-263 reprojects
    real observatory frames into the HR footprint; no degradation model
    exists there), used when degradation='none' with no manifest.
    """
    img = hr.astype(np.float64)
    img = _gaussian_blur_2d(img, sigma=rng.uniform(0.5, 0.9) * scale)
    dy, dx = (int(rng.integers(0, scale)) for _ in range(2))
    img = np.roll(img, (dy, dx), axis=(0, 1))
    h, w, c = img.shape
    lr = img.reshape(h // scale, scale, w // scale, scale, c).mean((1, 3))
    lr += rng.normal(0.0, rng.uniform(0.5, 2.0) / 255.0, lr.shape)
    return np.clip(lr, 0.0, 1.0).astype(np.float32)


class SyntheticHRDataset:
    """Procedural dataset; HR-only by default (LR comes from the on-device
    degradation pipeline). With `lr_scale` set, also emits a co-registered
    synthetic-telescope LR so degradation='none' presets run with zero
    downloads."""

    def __init__(self, length: int, hr_size: int, channels: int = 1,
                 seed: int = 0, lr_scale: int | None = None):
        self.length = length
        self.hr_size = hr_size
        self.channels = channels
        self.seed = seed
        self.lr_scale = lr_scale

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        hr = make_synthetic_image(i % self.length, self.hr_size,
                                  self.channels, self.seed)
        if self.lr_scale is None:
            return {"hr": hr}
        rng = np.random.default_rng(
            np.uint32(self.seed * 2_000_003 + i % self.length))
        return {"hr": hr,
                "lr": synthesize_observed_lr(hr, self.lr_scale, rng)}
