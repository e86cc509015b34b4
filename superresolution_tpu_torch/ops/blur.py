"""Fixed (non-learned) binomial smoothing filters on NHWC tensors.

Counterpart of superresolution_tpu/ops/blur.py: the anti-checkerboard
layer of the system this repo is modelled on, a depthwise binomial blur
in three strengths, 'light' 3x3/16, 'balanced' 5x5/256 and 'strong'
7x7/1600 (deliberately over-unity: the 7x7 binomial sums to 4096), with
SAME zero padding per channel. A plain depthwise F.conv2d, as the
reference leaves it to XLA; the Pallas blur there (pallas_blur.py) is
not on any default path.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

_MODES = {"light": (3, 16.0), "balanced": (5, 256.0), "strong": (7, 1600.0)}


@lru_cache(maxsize=None)
def binomial_kernel(size: int, norm: float | None = None) -> np.ndarray:
    """2-D binomial (Pascal) kernel of odd `size`, divided by `norm`
    (None: by its own sum, so it sums to 1)."""
    row = np.array([math.comb(size - 1, k) for k in range(size)],
                   dtype=np.float64)
    k2d = np.outer(row, row)
    k2d /= norm if norm is not None else k2d.sum()
    return k2d.astype(np.float32)


def depthwise_blur(x: torch.Tensor, kernel2d) -> torch.Tensor:
    """Depthwise 2-D SAME (zero-padded) convolution of NHWC `x` with one
    shared odd-sized kernel, cast to x's dtype."""
    c = x.shape[-1]
    k = torch.as_tensor(np.asarray(kernel2d), device=x.device).to(x.dtype)
    kh, kw = k.shape
    y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, kh, kw),
                 padding=(kh // 2, kw // 2), groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


def anti_checkerboard(x: torch.Tensor, mode: str | None = "balanced"
                      ) -> torch.Tensor:
    """mode in {'light', 'balanced', 'strong', 'none', None}."""
    if mode in (None, "none"):
        return x
    if mode not in _MODES:
        raise ValueError(f"unknown smoothing mode {mode!r}")
    size, norm = _MODES[mode]
    return depthwise_blur(x, binomial_kernel(size, norm))
