"""Pixel-space SR losses on NHWC tensors in [0, 1], each a scalar f32.

Counterpart of superresolution_tpu/losses/basic.py: the loss math runs
in f32 even under the bf16 compute policy (`_f32`). star_weighted_l1 is
the plain version of kernel 14 (ops/star_l1.py).
"""

from __future__ import annotations

import torch


def _f32(pred: torch.Tensor, target: torch.Tensor):
    return pred.to(torch.float32), target.to(torch.float32)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p, t = _f32(pred, target)
    return (p - t).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p, t = _f32(pred, target)
    return ((p - t) ** 2).mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """sqrt(diff^2 + eps), eps inside the sqrt."""
    p, t = _f32(pred, target)
    d = p - t
    return torch.sqrt(d * d + eps).mean()


def star_weighted_l1(pred: torch.Tensor, target: torch.Tensor,
                     threshold: float = 0.02,
                     weight: float = 500.0) -> torch.Tensor:
    """L1 where pixels with target > threshold (stars) weigh `weight`x."""
    p, t = _f32(pred, target)
    w = torch.where(t > threshold, weight, 1.0)
    return ((p - t).abs() * w).mean()


def astro_loss(pred: torch.Tensor, target: torch.Tensor,
               scale: float = 5.0, eps: float = 1e-6) -> torch.Tensor:
    """Brightness-weighted Charbonnier: weight map 1 + scale * target."""
    p, t = _f32(pred, target)
    d = (p - t).abs()
    return (torch.sqrt(d * d + eps) * (1.0 + scale * t)).mean()
