"""Fixed (non-learned) binomial smoothing filters on NHWC tensors.

Counterpart of superresolution_tpu/ops/blur.py: the anti-checkerboard
layer of the system this repo is modelled on, a depthwise binomial blur
in three strengths, 'light' 3x3/16, 'balanced' 5x5/256 and 'strong'
7x7/1600 (deliberately over-unity: the 7x7 binomial sums to 4096), with
SAME zero padding per channel. A plain depthwise F.conv2d, as the
reference leaves it to XLA, is what every path of the port runs.

Kernel 17, anti_checkerboard_kernel, is the counterpart of the
reference's Pallas blur (pallas_blur.py:anti_checkerboard_pallas), which
no path there runs either: on CUDA tensors the hand-written blur_kernel
(csrc/extra_kernels.cu), f32 sums rounded once to x's type; on CPU
tensors the plain anti_checkerboard.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build

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


def anti_checkerboard_kernel(x: torch.Tensor, mode: str | None = "balanced",
                             th: int = 64) -> torch.Tensor:
    """Kernel 17: anti_checkerboard(x, mode) on NHWC x of any C, H and W.
    CPU tensors run the plain version; CUDA tensors (bf16 or f32) launch
    the kernel or raise. `th`, the reference's row band, is accepted and
    does not change the result."""
    if mode in (None, "none"):
        return x
    if mode not in _MODES:
        raise ValueError(f"unknown smoothing mode {mode!r}")
    if th < 1:
        raise ValueError(f"anti_checkerboard_kernel: th must be >= 1, "
                         f"got {th}")
    if x.ndim != 4:
        raise ValueError(f"anti_checkerboard_kernel: NHWC x expected, got "
                         f"shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return anti_checkerboard(x, mode)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"anti_checkerboard_kernel: the kernel takes bf16 "
                        f"or f32, got {x.dtype}")
    x = x.contiguous()
    _build.require_cuda(x, dtype=x.dtype, name="anti_checkerboard_kernel")
    out = torch.empty_like(x)
    size, norm = _MODES[mode]
    _build.blur(x, size, norm, out)
    anti_checkerboard_kernel.launches += 1
    return out


anti_checkerboard_kernel.launches = 0
