"""PSNR / SSIM with the reference's semantics, on NHWC tensors in f32.

Counterpart of superresolution_tpu/metrics/psnr_ssim.py: an 11x11
Gaussian window (sigma 1.5), VALID convolution, C1 = 0.01^2, C2 = 0.03^2;
`ssim` is per image, `ssim_reference` the whole batch's mean. PSNR clamps
to [0, 1] and takes 10 log10(1 / (mse + 1e-8)) per image.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-((x - size // 2) ** 2) / (2.0 * sigma ** 2))
                  for x in range(size)], dtype=np.float64)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


_WIN = _gaussian_window()


def _valid_depthwise(x: torch.Tensor) -> torch.Tensor:
    """VALID depthwise conv of NHWC x with the window -> NCHW."""
    c = x.shape[-1]
    win = torch.as_tensor(_WIN, device=x.device, dtype=x.dtype)
    return F.conv2d(x.permute(0, 3, 1, 2), win.expand(c, 1, *win.shape),
                    groups=c)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mu1, mu2 = _valid_depthwise(img1), _valid_depthwise(img2)
    s1 = _valid_depthwise(img1 * img1) - mu1 * mu1
    s2 = _valid_depthwise(img2 * img2) - mu2 * mu2
    s12 = _valid_depthwise(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))


def ssim_reference(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Scalar SSIM, mean over the whole batch."""
    return _ssim_map(img1.float(), img2.float()).mean()


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image SSIM -> [B]."""
    return _ssim_map(img1.float(), img2.float()).mean((1, 2, 3))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         clamp: bool = True) -> torch.Tensor:
    """Per-image PSNR of images in [0, 1] -> [B]."""
    p, t = pred.float(), target.float()
    if clamp:
        p, t = p.clamp(0.0, 1.0), t.clamp(0.0, 1.0)
    mse = ((p - t) ** 2).mean((1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-8))


class Metrics:
    """Running-mean PSNR/SSIM, accumulated on the host in float64."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._psnr = 0.0
        self._ssim = 0.0
        self._count = 0

    def update(self, pred: torch.Tensor, target: torch.Tensor) -> None:
        n = int(pred.shape[0])
        self._psnr += float(psnr(pred, target).sum())
        # the reference weights the batch-mean SSIM by the batch size
        self._ssim += float(ssim_reference(pred.clamp(0, 1),
                                           target.clamp(0, 1))) * n
        self._count += n

    def update_sums(self, psnr_sum: float, ssim_sum: float, n: float) -> None:
        """Accumulate per-image sums an eval step computed (masked)."""
        self._psnr += psnr_sum
        self._ssim += ssim_sum
        self._count += n

    def compute(self) -> dict[str, float]:
        if not self._count:
            return {"psnr": 0.0, "ssim": 0.0}
        return {"psnr": self._psnr / self._count,
                "ssim": self._ssim / self._count}
