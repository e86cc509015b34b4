"""EDSR, a residual conv trunk without batch norm, with a sub-pixel
upsampler whose stages run through kernel 15.

Counterpart of superresolution_tpu/models/edsr.py. EDSR-baseline is 16
resblocks x 64 features at res_scale 1.0, EDSR-full 32 x 256 at 0.1.
RGB inputs have the DIV2K channel mean subtracted, and added back at the
end, in the input's dtype; res_scale is cast to it too, as the reference
does. Parameter names follow BasicSR's EDSR (conv_first, body.{i}.conv1
/conv2, conv_after_body, upsample.{0,2,...}, conv_last), so the JAX
trees bridged by models/convert.py load with strict=True. The public
method takes and returns NHWC; the convs run NCHW-shaped on a
channels-last activation (a view of a contiguous NHWC input, copied
once otherwise), which is the layout kernel 15's tensor-core body
takes.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from superresolution_tpu_torch.models.common import Conv, pixel_shuffle_stages
from superresolution_tpu_torch.ops.subpixel import conv3x3_depth_to_space
from superresolution_tpu_torch.runtime import resolve_device

_DIV2K_MEAN = (0.4488, 0.4371, 0.4040)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


class ResBlock(nn.Module):
    """conv -> relu -> conv (MSRA x 0.1: with res_scale 1 and no BN a
    unit-gain branch would double the activation variance per block), then
    x + res_scale * branch."""

    def __init__(self, features: int, res_scale: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv(features, features, generator=generator)
        self.conv2 = Conv(features, features, init_scale=0.1,
                          generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(x)))
        rs = _in_dtype(self.res_scale, x.dtype)
        return x + (y if rs == 1.0 else y * rs)


class EDSR(nn.Module):
    """EDSR with BasicSR's key names. scan_blocks names the JAX tree's
    layout (a scan over resblocks or one subtree each); the module is the
    same either way and models/convert.py reads both. Each upsampler
    stage (x2 or x3; scales 2, 3, 4, 8) is one launch of kernel 15 on the
    card. Parameters are initialized on the CPU from `generator` and moved
    to `device` (default cuda; raises without a GPU unless
    device='cpu')."""

    def __init__(self, scale: int = 4, in_channels: int = 3,
                 out_channels: int = 3, features: int = 64,
                 num_blocks: int = 16, res_scale: float = 1.0,
                 scan_blocks: bool = True,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.scale, self.num_blocks, self.features = scale, num_blocks, features
        self.in_channels, self.out_channels = in_channels, out_channels
        self.res_scale, self.scan_blocks = res_scale, scan_blocks
        c = features
        self.up_stages = tuple(pixel_shuffle_stages(scale))
        self.conv_first = Conv(in_channels, c, generator=generator)
        self.body = nn.Sequential(*[ResBlock(c, res_scale, generator=generator)
                                    for _ in range(num_blocks)])
        self.conv_after_body = Conv(c, c, generator=generator)
        ups: list[nn.Module] = []
        for r in self.up_stages:
            ups += [Conv(c, c * r * r, generator=generator),
                    nn.PixelShuffle(r)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = Conv(c, out_channels, generator=generator)
        self.register_buffer("mean", torch.tensor(_DIV2K_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, in] -> [B, H*scale, W*scale, out]."""
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        rgb = self.in_channels == 3
        if rgb:
            mean = self.mean.to(x.dtype)
            x = x - mean
        x = head = self.conv_first(x)
        x = self.conv_after_body(self.body(x)) + head
        for conv, r in zip(self.upsample[0::2], self.up_stages):
            x = conv3x3_depth_to_space(x, conv.weight, conv.bias, r)
        x = self.conv_last(x)
        if rgb:
            x = x + mean
        return x.permute(0, 2, 3, 1)
