"""FSRCNN: feature extraction, shrink, mapping, expand, and a sub-pixel
head (a 9x9 conv to out_channels * scale^2, then the pixel shuffle) in
place of the paper's transposed conv, as the reference has it.

Counterpart of superresolution_tpu/models/fsrcnn.py. The head's conv is
9x9, so it is not kernel 15's function: it stays a conv and
F.pixel_shuffle. Each PReLU has one slope, initialized to 0.01 as flax's
PReLU is (torch's default is 0.25). Parameters: conv_feat, prelu_feat,
conv_shrink, prelu_shrink, conv_map.{i}, prelu_map.{i}, conv_expand,
prelu_expand, conv_last. The public method takes and returns NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from superresolution_tpu_torch.models.common import Conv
from superresolution_tpu_torch.runtime import resolve_device


def _prelu() -> nn.PReLU:
    return nn.PReLU(1, init=0.01, device="cpu")


class FSRCNN(nn.Module):
    """d features, s shrunk, m mapping layers. Parameters are initialized
    on the CPU from `generator` (MSRA, zero biases) and moved to `device`
    (default cuda; raises without a GPU unless device='cpu')."""

    def __init__(self, scale: int = 4, in_channels: int = 1,
                 out_channels: int = 1, d: int = 56, s: int = 12, m: int = 4,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = scale
        self.in_channels, self.out_channels = in_channels, out_channels
        self.conv_feat = Conv(in_channels, d, kernel=5, generator=generator)
        self.prelu_feat = _prelu()
        self.conv_shrink = Conv(d, s, kernel=1, generator=generator)
        self.prelu_shrink = _prelu()
        self.conv_map = nn.ModuleList(Conv(s, s, generator=generator)
                                      for _ in range(m))
        self.prelu_map = nn.ModuleList(_prelu() for _ in range(m))
        self.conv_expand = Conv(s, d, kernel=1, generator=generator)
        self.prelu_expand = _prelu()
        self.conv_last = Conv(d, out_channels * scale * scale, kernel=9,
                              generator=generator)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, in] -> [B, H*scale, W*scale, out]."""
        x = self.prelu_feat(self.conv_feat(x.permute(0, 3, 1, 2)))
        x = self.prelu_shrink(self.conv_shrink(x))
        for conv, act in zip(self.conv_map, self.prelu_map):
            x = act(conv(x))
        x = self.prelu_expand(self.conv_expand(x))
        x = F.pixel_shuffle(self.conv_last(x), self.scale)
        return x.permute(0, 2, 3, 1)
