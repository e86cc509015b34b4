"""Image I/O: 16-bit scientific TIFF and PNG, via PIL and numpy.

Counterpart of superresolution_tpu/data/io.py, with the same contracts and
file bytes:
  * load_image: PNG/TIFF/JPEG -> HWC float32 in [0, 1]; 16-bit and 'I'
    inputs divide by 65535, 8-bit by 255, mode 'F' is taken as it is;
    NaN -> 0, +inf -> 1, -inf -> 0, then clipped; grayscale gets a
    trailing channel dim;
  * save_tiff16: clip to [0, 1], x65535, uint16 mode 'I;16';
  * save_png: clip to [0, 1], x255 rounded half up, 8-bit.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """Load PNG/TIFF/JPEG as HWC float in [0,1]. 16-bit inputs divide by
    65535, 8-bit by 255. Grayscale gets a trailing channel dim."""
    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I;16L", "I"):
            arr = np.asarray(im, dtype=np.float64) / 65535.0
        elif im.mode == "F":
            arr = np.asarray(im, dtype=np.float64)
        else:
            if im.mode not in ("L", "RGB"):
                im = im.convert("RGB")
            arr = np.asarray(im, dtype=np.float64) / 255.0
    arr = np.nan_to_num(arr, nan=0.0, posinf=1.0, neginf=0.0)
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.clip(arr, 0.0, 1.0).astype(dtype)


def save_tiff16(arr: np.ndarray, path: str) -> None:
    """HWC (one channel) or HW float [0,1] -> 16-bit TIFF (mode 'I;16')."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 3:
        if a.shape[-1] != 1:
            raise ValueError("16-bit TIFF writer is single-channel")
        a = a[..., 0]
    a16 = (np.clip(a, 0.0, 1.0) * 65535.0).astype(np.uint16)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im = Image.fromarray(a16)  # uint16 -> mode 'I;16' (Pillow >= 10)
    if im.mode != "I;16":  # older Pillow
        im = im.convert("I;16")
    im.save(path)


def save_png(arr: np.ndarray, path: str) -> None:
    """HWC (1 or 3 channel) or HW float [0,1] -> 8-bit PNG."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    a8 = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(a8).save(path)
