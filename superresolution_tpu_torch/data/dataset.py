"""Datasets: manifest-driven paired patches and procedural synthetic HR.

The port's own copy of superresolution_tpu/data/dataset.py (numpy only):
PairedDataset, the reference's loader contract (items {'lr': [h,w,1],
'hr': [H,W,1]} float32 in [0,1], a black tensor shaped like the last
good item for a file that fails to load, and get_batch, the native
batch decode the Loader takes first); make_synthetic_image,
_gaussian_blur_2d, synthesize_observed_lr and SyntheticHRDataset with
the same arithmetic, so the arrays come out bit-identical to the JAX
package's.
"""

from __future__ import annotations

import os

import numpy as np

from superresolution_tpu_torch.data.io import load_image
from superresolution_tpu_torch.data.manifest import load_manifest


class PairedDataset:
    """Real LR/HR pairs from a JSON manifest."""

    def __init__(self, manifest_path: str, base_path: str = "",
                 lr_size: int | None = None, hr_size: int | None = None):
        self.entries = load_manifest(manifest_path)
        self.base = base_path
        self.lr_size = lr_size
        self.hr_size = hr_size
        # shapes of the last pair that loaded: the black-tensor fallback
        # must match the real items' shapes or the loader's stack fails
        self._good_shapes: tuple | None = None

    def __len__(self) -> int:
        return len(self.entries)

    def _resolve(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.base, p)

    @staticmethod
    def _load(path: str) -> np.ndarray:
        # the native decoder for the TIFF dataset format; PIL otherwise
        if path.endswith((".tif", ".tiff")):
            from superresolution_tpu_torch.data.native_io import decode_tiff

            arr = decode_tiff(path)
            if arr is not None:
                return arr
        return load_image(path)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        e = self.entries[i]
        try:
            hr = self._load(self._resolve(e["hubble_path"]))
            lr = self._load(self._resolve(e["ground_path"]))
            if self.hr_size and hr.shape[0] != self.hr_size:
                raise ValueError(f"hr size {hr.shape} != {self.hr_size}")
            if self.lr_size and lr.shape[0] != self.lr_size:
                raise ValueError(f"lr size {lr.shape} != {self.lr_size}")
            self._good_shapes = (lr.shape, hr.shape)
            return {"lr": lr, "hr": hr}
        except Exception:
            # black-tensor fallback (reference src/dataset.py:45-48),
            # shaped like the real items once a good pair has loaded
            if self._good_shapes is not None:
                lshape, hshape = self._good_shapes
            else:
                ls = self.lr_size or 128
                hs = self.hr_size or ls * 4
                lshape, hshape = (ls, ls, 1), (hs, hs, 1)
            return {"lr": np.zeros(lshape, np.float32),
                    "hr": np.zeros(hshape, np.float32)}

    def get_batch(self, indices) -> dict[str, np.ndarray] | None:
        """One native call decodes every TIFF of the batch across a thread
        pool (native/loader.cpp). None whenever that does not apply
        (non-TIFF entries, multi-channel items, no toolchain, any decode
        failure): the Loader then takes the per-item path, which also
        gives the black-tensor semantics for corrupt files."""
        from superresolution_tpu_torch.data.native_io import decode_batch

        hp = [self._resolve(self.entries[i]["hubble_path"])
              for i in indices]
        lp = [self._resolve(self.entries[i]["ground_path"])
              for i in indices]
        if not all(p.endswith((".tif", ".tiff")) for p in hp + lp):
            return None
        if self._good_shapes is None:
            self[indices[0]]  # prime the shapes (validates sizes too)
        if self._good_shapes is None:
            return None
        lshape, hshape = self._good_shapes
        if lshape[-1] != 1 or hshape[-1] != 1:
            return None  # the native decoder is single-channel
        hr = decode_batch(hp, hshape[:2])
        lr = decode_batch(lp, lshape[:2])
        if hr is None or lr is None:
            return None
        return {"lr": lr, "hr": hr}


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
