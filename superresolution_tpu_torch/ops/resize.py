"""Separable bicubic resize as two dense f32 matmuls, and nearest resize.

Counterpart of superresolution_tpu/ops/resize.py, with its own numpy copy
of cubic_kernel and _resize_matrix (the port imports nothing of the JAX
package): out = W_h @ x @ W_w^T with [n_out, n_in] interpolation
matrices built on the host and cached per geometry. Conventions:
  * a = -0.5 (Keys / MATLAB / PIL) with antialias and border='renorm':
    the standard SR degradation (ops/degradation.degrade_bicubic);
  * a = -0.75 without antialias, border='replicate': F.interpolate's
    'bicubic' (align_corners=False), HybridSR's output resize.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def cubic_kernel(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel with free parameter `a`."""
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    return np.where(
        t <= 1.0,
        (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0,
        np.where(t < 2.0, a * t3 - 5.0 * a * t2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


@lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, a: float, antialias: bool,
                   border: str = "replicate") -> np.ndarray:
    """Dense [n_out, n_in] bicubic interpolation matrix, align_corners=False,
    rows normalized to sum 1. border='replicate' clamps out-of-range taps
    to the edge pixel; 'renorm' drops them and renormalizes the window."""
    scale = n_in / n_out
    s = max(scale, 1.0) if antialias else 1.0  # only downscaling widens
    support = 2.0 * s
    out_coords = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for o, c in enumerate(out_coords):
        lo = int(np.floor(c - support)) + 1
        hi = int(np.ceil(c + support))
        taps = np.arange(lo, hi + 1)
        vals = cubic_kernel((taps - c) / s, a)
        if border == "renorm":
            keep = (taps >= 0) & (taps < n_in)
            taps, vals = taps[keep], vals[keep]
        np.add.at(w[o], np.clip(taps, 0, n_in - 1), vals)
        ssum = w[o].sum()
        if ssum != 0.0:
            w[o] /= ssum
    return w.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int],
                   a: float = -0.5, antialias: bool = True,
                   border: str = "replicate") -> torch.Tensor:
    """Bicubic resize of NHWC (or HWC) `x` to spatial size `out_hw`, in
    f32 (full-precision matmuls), returned in x's dtype."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = out_hw
    xf = x.float()
    if oh != h:
        wh = torch.from_numpy(_resize_matrix(h, oh, a, antialias, border))
        xf = torch.einsum("oh,bhwc->bowc", wh.to(x.device), xf)
    if ow != w:
        ww = torch.from_numpy(_resize_matrix(w, ow, a, antialias, border))
        xf = torch.einsum("ow,bhwc->bhoc", ww.to(x.device), xf)
    out = xf.to(x.dtype)
    return out[0] if squeeze else out


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC (or HWC) `x`: output row r reads
    input row floor(r * h / oh)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = out_hw
    rows = ((torch.arange(oh) * h) // oh).clamp(0, h - 1).to(x.device)
    cols = ((torch.arange(ow) * w) // ow).clamp(0, w - 1).to(x.device)
    out = x[:, rows][:, :, cols]
    return out[0] if squeeze else out
