"""VGG-style discriminator for ESRGAN GAN training.

Counterpart of superresolution_tpu/models/discriminator.py:17-50. Ten
blocks, each a 3x3 stride-1 or 4x4 stride-2 conv, GroupNorm(min(32,
feats), eps 1e-6: flax's default) and lrelu 0.2 (the first block has a
bias and no norm); widths f, f, then (2, 4, 8, 8) f, two blocks each;
then Dense 100, lrelu, Dense 1. The convs pad as SAME does (for a 4x4
stride-2 conv, (1, 1) on an even size and (1, 2) on an odd one). The map
is flattened in NHWC order, as flax flattens it, so a bridged Dense
kernel is a plain transpose. Inits: MSRA convs, lecun-normal Dense
weights (flax's default), zero biases.

Parameter names: blocks.{i}.conv, blocks.{i}.norm (i >= 1), fc1, fc2.
The public method takes NHWC, as the generators return it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from superresolution_tpu_torch.models.common import (
    lecun_normal_,
    lrelu,
    msra_init_,
)
from superresolution_tpu_torch.runtime import resolve_device


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of SAME for a size-n axis, kernel k, stride s."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, norm: bool,
                 generator: torch.Generator | None):
        super().__init__()
        self.k = 3 if stride == 1 else 4
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, self.k, stride=stride,
                              bias=not norm, device="cpu")
        msra_init_(self.conv.weight, 1.0, generator)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)
        self.norm = (nn.GroupNorm(min(32, cout), cout, eps=1e-6,
                                  device="cpu") if norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pad(x.shape[2], self.k, self.stride)
        pw = same_pad(x.shape[3], self.k, self.stride)
        x = self.conv(F.pad(x, (*pw, *ph)))
        if self.norm is not None:
            x = self.norm(x)
        return lrelu(x)


class VGGStyleDiscriminator(nn.Module):
    """Parameters are initialized on the CPU from `generator` and moved
    to `device` (default cuda; raises without a GPU unless
    device='cpu'). `input_size` declares (and enforces) the HR patch
    the flattened Dense head is sized for."""

    def __init__(self, in_channels: int = 3, features: int = 64,
                 input_size: int = 128,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.input_size = input_size
        f = features
        plan = [(f, 1, False), (f, 2, True)]
        for mult in (2, 4, 8, 8):
            plan += [(f * mult, 1, True), (f * mult, 2, True)]
        blocks, cin, n = [], in_channels, input_size
        for cout, stride, norm in plan:
            blocks.append(_Block(cin, cout, stride, norm, generator))
            cin = cout
            n = -(-n // stride)
        self.blocks = nn.ModuleList(blocks)
        self.fc1 = nn.Linear(cin * n * n, 100, device="cpu")
        self.fc2 = nn.Linear(100, 1, device="cpu")
        for fc in (self.fc1, self.fc2):
            lecun_normal_(fc.weight, fc.in_features, generator)
            nn.init.zeros_(fc.bias)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, S, in] -> logits [B, 1]; S must be input_size."""
        if self.input_size and x.shape[1] != self.input_size:
            raise ValueError(
                f"discriminator built for {self.input_size}^2 inputs, got"
                f" {x.shape[1]}x{x.shape[2]}")
        x = x.permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC order
        return self.fc2(lrelu(self.fc1(x)))
