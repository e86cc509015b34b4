"""ESPCN, the efficient sub-pixel CNN: every conv runs at LR, and the last
one with the depth_to_space after it is one launch of kernel 15.

Counterpart of superresolution_tpu/models/espcn.py. Parameters: conv1
(5x5, tanh), conv2 (3x3, tanh), conv3 (3x3 to out_channels * scale^2).
The public method takes and returns NHWC; the convs run NCHW-shaped on
a channels-last activation (as EDSR's do), the layout kernel 15's
tensor-core body takes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from superresolution_tpu_torch.models.common import Conv
from superresolution_tpu_torch.ops.subpixel import conv3x3_depth_to_space
from superresolution_tpu_torch.runtime import resolve_device


class ESPCN(nn.Module):
    """Parameters are initialized on the CPU from `generator` (MSRA, zero
    biases) and moved to `device` (default cuda; raises without a GPU
    unless device='cpu')."""

    def __init__(self, scale: int = 4, in_channels: int = 1,
                 out_channels: int = 1, f1: int = 64, f2: int = 32,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = scale
        self.in_channels, self.out_channels = in_channels, out_channels
        self.conv1 = Conv(in_channels, f1, kernel=5, generator=generator)
        self.conv2 = Conv(f1, f2, generator=generator)
        self.conv3 = Conv(f2, out_channels * scale * scale,
                          generator=generator)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, in] -> [B, H*scale, W*scale, out]."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = torch.tanh(self.conv1(x))
        x = torch.tanh(self.conv2(x))
        x = conv3x3_depth_to_space(x, self.conv3.weight, self.conv3.bias,
                                   self.scale)
        return x.permute(0, 2, 3, 1)
