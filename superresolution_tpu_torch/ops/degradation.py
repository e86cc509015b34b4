"""Synthetic LR degradation: the bicubic downscale.

Counterpart of superresolution_tpu/ops/degradation.py:50-55
(degrade_bicubic) only; the blur, noise and JPEG stages come with the
degradation-training slice.
"""

from __future__ import annotations

import torch

from superresolution_tpu_torch.ops.resize import resize_bicubic


def degrade_bicubic(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """PIL/MATLAB-convention bicubic x1/scale downscale of HWC/NHWC `hr`
    (a=-0.5, antialiased, border window renormalized)."""
    h, w = hr.shape[-3], hr.shape[-2]
    return resize_bicubic(hr, (h // scale, w // scale), a=-0.5,
                          antialias=True, border="renorm")
