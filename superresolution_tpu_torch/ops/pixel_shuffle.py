"""Sub-pixel primitives on NHWC tensors.

Counterpart of superresolution_tpu/ops/pixel_shuffle.py. Channel order
matches torch.nn.PixelShuffle: input channel c*r*r + i*r + j goes to
output sub-pixel (i, j) of channel c.
"""

from __future__ import annotations

import torch


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, H, W, C*r*r] -> [B, H*r, W*r, C]."""
    b, h, w, c = x.shape
    r = block
    if c % (r * r):
        raise ValueError(f"channels {c} not divisible by block^2={r * r}")
    c_out = c // (r * r)
    x = x.reshape(b, h, w, c_out, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c_out)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, H*r, W*r, C] -> [B, H, W, C*r*r]; exact inverse of depth_to_space."""
    b, hr, wr, c = x.shape
    r = block
    if hr % r or wr % r:
        raise ValueError(f"spatial dims ({hr},{wr}) not divisible by block={r}")
    h, w = hr // r, wr // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h, w, c * r * r)
