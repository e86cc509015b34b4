"""RRDBNet, the ESRGAN generator, in eager PyTorch.

Counterpart of superresolution_tpu/models/rrdbnet.py. Parameter names
follow BasicSR (conv_first, body.{i}.rdb{k}.conv{j}, conv_body,
conv_up{n}, conv_hr, conv_last), so reference-ecosystem state dicts and
the JAX trees bridged by models/convert.py load with strict=True.

`trunk` (LR body) and `tail` (x`scale` head) are separate methods, as in
the JAX model, so tiled inference can batch them differently. The
public methods take and return NHWC; the convs run NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from superresolution_tpu_torch.models.common import (
    Conv,
    lrelu,
    pixel_shuffle_stages,
    pixel_shuffle_upsample,
    remat,
)
from superresolution_tpu_torch.ops.pixel_shuffle import space_to_depth
from superresolution_tpu_torch.runtime import resolve_device


class DenseBlock(nn.Module):
    """5-conv dense block: conv_j sees [x, y1..y_{j-1}]; residual scale 0.2."""

    def __init__(self, features: int, growth: int = 32,
                 init_scale: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, g = features, growth
        for j in range(1, 6):
            setattr(self, f"conv{j}",
                    Conv(c + (j - 1) * g, g if j < 5 else c,
                         init_scale=init_scale, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for j in range(1, 5):
            conv = getattr(self, f"conv{j}")
            feats.append(lrelu(conv(torch.cat(feats, 1))))
        out = self.conv5(torch.cat(feats, 1))
        return x + out * 0.2


class FusedDenseBlock(nn.Module):
    """The same dense block in the JAX package's projection layout: each
    source computes its contributions to all later convs in one wide conv
    (x -> 4g+c channels, y_i -> (4-i)g+c); every bias rides `px`.
    models/convert.py's _unfuse_dense maps its weights onto DenseBlock."""

    def __init__(self, features: int, growth: int = 32,
                 init_scale: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, g = features, growth
        self.features, self.growth = c, g
        self.px = Conv(c, 4 * g + c, init_scale=init_scale,
                       generator=generator)
        for i in range(1, 5):
            setattr(self, f"proj_y{i}",
                    Conv(g, (4 - i) * g + c, bias=False,
                         init_scale=init_scale, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.growth
        px = self.px(x)
        acc = px[:, 4 * g:]
        pre = [px[:, i * g:(i + 1) * g] for i in range(4)]
        for i in range(1, 5):
            p = getattr(self, f"proj_y{i}")(lrelu(pre[i - 1]))
            for k in range(i, 4):
                pre[k] = pre[k] + p[:, (k - i) * g:(k - i + 1) * g]
            acc = acc + p[:, (4 - i) * g:]
        return x + acc * 0.2


class RRDB(nn.Module):
    def __init__(self, features: int, growth: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        for k in range(1, 4):
            setattr(self, f"rdb{k}",
                    DenseBlock(features, growth, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.rdb3(self.rdb2(self.rdb1(x)))
        return x + y * 0.2


class RRDBNet(nn.Module):
    """ESRGAN RRDBNet with the sub-pixel ('pixelshuffle', conv C -> C r^2
    + shuffle + lrelu per stage) or the nearest-conv ('nearest_conv',
    nearest x2 + conv + lrelu per stage) upsampler. The default is the
    JAX model's, 'nearest_conv'; the deploy paths pass 'pixelshuffle'.

    pixel_unshuffle_input: BasicSR's convention for scale < 4 — the input
    is space-to-depth'd by this factor and upsampled by scale * factor.
    remat: each RRDB's activations are recomputed in the backward
    (models/common.remat), the reference's remat per scanned RRDB.
    scan_blocks and fused_dense name the JAX tree's layout (a scan over
    RRDBs, FusedDenseBlock projections); this model keeps BasicSR's
    layout either way and models/convert.py maps both onto it.
    Parameters are initialized on the CPU from `generator` (MSRA x 0.1 in
    the dense blocks, x 1 elsewhere, zero biases) and moved to `device`
    (default cuda; raises without a GPU unless device='cpu')."""

    def __init__(self, scale: int = 4, in_channels: int = 3,
                 out_channels: int = 3, features: int = 64,
                 num_blocks: int = 23, growth: int = 32,
                 upsampler: str = "nearest_conv",
                 scan_blocks: bool = True, fused_dense: bool = True,
                 remat: bool = False, pixel_unshuffle_input: int = 1,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if upsampler not in ("pixelshuffle", "nearest_conv"):
            raise ValueError(f"unknown upsampler {upsampler!r}")
        dev = resolve_device(device)
        self.scale, self.num_blocks = scale, num_blocks
        self.features, self.growth = features, growth
        self.in_channels, self.out_channels = in_channels, out_channels
        self.upsampler, self.remat = upsampler, remat
        self.scan_blocks, self.fused_dense = scan_blocks, fused_dense
        self.pixel_unshuffle_input = u = pixel_unshuffle_input
        c = features
        self.conv_first = Conv(in_channels * u * u, c, generator=generator)
        self.body = nn.Sequential(*[RRDB(c, growth, generator=generator)
                                    for _ in range(num_blocks)])
        self.conv_body = Conv(c, c, generator=generator)
        if upsampler == "nearest_conv":
            if scale * u not in (2, 4, 8):
                raise ValueError(f"unsupported scale {scale * u}")
            self.up_stages = (2,) * ((scale * u).bit_length() - 1)
        else:
            self.up_stages = tuple(pixel_shuffle_stages(scale * u))
        for n, r in enumerate(self.up_stages, 1):
            cout = c if upsampler == "nearest_conv" else c * r * r
            setattr(self, f"conv_up{n}", Conv(c, cout, generator=generator))
        self.conv_hr = Conv(c, c, generator=generator)
        self.conv_last = Conv(c, out_channels, generator=generator)
        self.to(dev)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, in] -> LR features [B, H/u, W/u, features]."""
        if self.pixel_unshuffle_input > 1:
            x = space_to_depth(x, self.pixel_unshuffle_input)
        x = head = self.conv_first(x.permute(0, 3, 1, 2))
        for blk in self.body:
            x = remat(blk, x) if self.remat else blk(x)
        x = self.conv_body(x) + head
        return x.permute(0, 2, 3, 1)

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """LR features [B, h, w, features] -> [B, h*s, w*s, out]."""
        convs = [getattr(self, f"conv_up{n}")
                 for n in range(1, len(self.up_stages) + 1)]
        x = x.permute(0, 3, 1, 2)
        if self.upsampler == "nearest_conv":
            for conv in convs:
                x = lrelu(conv(F.interpolate(x, scale_factor=2,
                                             mode="nearest")))
        else:
            x = pixel_shuffle_upsample(x, convs, self.up_stages, act=lrelu)
        x = self.conv_last(lrelu(self.conv_hr(x)))
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.trunk(x))
