"""Shared building blocks for the SR models (NCHW inside, NHWC at the
model's public methods).

Counterpart of superresolution_tpu/models/common.py.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def msra_init_(w: torch.Tensor, scale: float = 1.0,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Kaiming-normal (fan_in) scaled by `scale`, truncated at two standard
    deviations: the JAX package's variance_scaling(2*scale^2, 'fan_in',
    'truncated_normal'). ESRGAN initializes its RRDB convs with scale 0.1."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    # 0.8796...: stddev of a standard normal truncated to [-2, 2]
    std = math.sqrt(2.0 * scale * scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's default kernel init: variance_scaling(1, 'fan_in',
    'truncated_normal'), truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Conv(nn.Conv2d):
    """SAME conv (3x3 unless `kernel` says otherwise; odd sizes) with MSRA
    x `init_scale` weights and zero bias.

    Parameters are made on the CPU from `generator`; the owning model
    moves them to its device."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True, init_scale: float = 1.0,
                 generator: torch.Generator | None = None, kernel: int = 3):
        super().__init__(in_channels, out_channels, kernel,
                         padding=kernel // 2, bias=bias, device="cpu")
        msra_init_(self.weight, init_scale, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def pixel_shuffle_stages(scale: int) -> Sequence[int]:
    """The x2/x3 stages of a sub-pixel upsampler of total `scale`."""
    if scale == 1:
        return ()
    if scale in (2, 3):
        return (scale,)
    if scale == 4:
        return (2, 2)
    if scale == 8:
        return (2, 2, 2)
    raise ValueError(f"unsupported scale {scale}")


def pixel_shuffle_upsample(x: torch.Tensor, convs: Sequence[nn.Module],
                           stages: Sequence[int],
                           act: Callable | None = None) -> torch.Tensor:
    """conv(C -> C*r^2) + PixelShuffle (+ act) per stage, NCHW.

    The JAX package's PixelShuffleUpsampler as a function over convs the
    caller owns, so a model keeps the BasicSR key names (conv_up1, ...)."""
    for conv, r in zip(convs, stages):
        x = F.pixel_shuffle(conv(x), r)
        if act is not None:
            x = act(x)
    return x


def remat(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """module(x), its activations recomputed in the backward
    (torch.utils.checkpoint, use_reentrant=False), as the reference's
    nn.remat does. The module's parameters are inputs of the checkpointed
    call, so under torch.func.functional_call the recompute sees the same
    (e.g. bf16-cast) tensors as the forward, not the module's own."""
    names, params = zip(*module.named_parameters())

    def run(x, *ps):
        return torch.func.functional_call(module, dict(zip(names, ps)),
                                          (x,))

    return checkpoint(run, x, *params, use_reentrant=False)
