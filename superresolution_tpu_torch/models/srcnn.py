"""SRCNN: a bicubic upscale to the target size, then a 9-5-5 conv stack.

Counterpart of superresolution_tpu/models/srcnn.py: the upscale is the
port's resize_bicubic with a = -0.5 and no antialiasing. Parameters:
conv1 (9x9, relu), conv2 (5x5, relu), conv3 (5x5). The public method
takes and returns NHWC in [0, 1]; the convs run NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from superresolution_tpu_torch.models.common import Conv
from superresolution_tpu_torch.ops.resize import resize_bicubic
from superresolution_tpu_torch.runtime import resolve_device


class SRCNN(nn.Module):
    """Parameters are initialized on the CPU from `generator` (MSRA, zero
    biases) and moved to `device` (default cuda; raises without a GPU
    unless device='cpu')."""

    def __init__(self, scale: int = 2, in_channels: int = 1,
                 out_channels: int = 1, f1: int = 64, f2: int = 32,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = scale
        self.in_channels, self.out_channels = in_channels, out_channels
        self.conv1 = Conv(in_channels, f1, kernel=9, generator=generator)
        self.conv2 = Conv(f1, f2, kernel=5, generator=generator)
        self.conv3 = Conv(f2, out_channels, kernel=5, generator=generator)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, in] -> [B, H*scale, W*scale, out]."""
        h, w = x.shape[1] * self.scale, x.shape[2] * self.scale
        x = resize_bicubic(x, (h, w), a=-0.5, antialias=False)
        x = F.relu(self.conv1(x.permute(0, 3, 1, 2)))
        x = F.relu(self.conv2(x))
        return self.conv3(x).permute(0, 2, 3, 1)
