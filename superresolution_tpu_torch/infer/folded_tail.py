"""Deploy-time folded x4 sub-pixel tail, the phase tail's plain reference.

Counterpart of superresolution_tpu/infer/folded_tail.py. The standard
RRDBNet pixelshuffle tail is

    conv1(64->256) -> d2s(2) -> lrelu -> conv2(64->256)@2x -> d2s(2)
    -> lrelu -> conv_hr@4x -> lrelu -> conv_last@4x

lrelu commutes with depth_to_space, so conv2 can run in phase space at LR
resolution: each of its 4 output phases (a, b) is a 2x2 conv over the
256-channel phase layout of conv1's output, with the kernel derived from
the 3x3 conv2 kernel by the exact index transform of fold_stage2_kernel.
The two d2s(2) stages collapse into one d2s(4). Plain F.conv2d
throughout; equal to the standard tail up to fp reassociation.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from superresolution_tpu_torch.infer.common import (
    conv_nhwc,
    param_conv,
    state_tensors,
)
from superresolution_tpu_torch.ops.pixel_shuffle import depth_to_space
from superresolution_tpu_torch.runtime import resolve_device


def fold_stage2_kernel(k3: np.ndarray) -> np.ndarray:
    """Standard stage-2 kernel [3,3,C,C*4] (HWIO, applied at 2x after
    d2s(2)) -> phase kernels [2,2,2,2,C*4,C*4] indexed
    [a,b,di,dj,cin,cout] where cin = f*4 + i1*2 + j1 is the stage-1 phase
    layout.

    Output position (2I+a, 2J+b) at 2x reads input row 2I+a+dy, which is
    source phase i1 = (a+dy) % 2 at LR row I + di - (1-a) with
    di = (a+dy-i1)//2 + 1 - a in {0, 1}: pad (1-a, a) rows and run a
    VALID 2x2 conv."""
    kh, kw, c, cout = k3.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {kh}x{kw}")
    kf = np.zeros((2, 2, 2, 2, 4 * c, cout), k3.dtype)
    for a in (0, 1):
        for b in (0, 1):
            for dy in (-1, 0, 1):
                i1 = (a + dy) % 2
                di = (a + dy - i1) // 2 + 1 - a
                for dx in (-1, 0, 1):
                    j1 = (b + dx) % 2
                    dj = (b + dx - j1) // 2 + 1 - b
                    for f in range(c):
                        kf[a, b, di, dj, f * 4 + i1 * 2 + j1] = \
                            k3[dy + 1, dx + 1, f]
    return kf


def make_folded_tail(params: Mapping, clip: bool = True,
                     device: str | torch.device | None = None):
    """tail_fn(feat [B,H,W,C]) -> [B,4H,4W,out] from a BasicSR-keyed
    RRDBNet(pixelshuffle, scale=4) state dict (OIHW)."""
    dev = resolve_device(device)
    p = state_tensors(params, dev)
    k3 = p["conv_up2.weight"].float().cpu().numpy().transpose(2, 3, 1, 0)
    # [a, b] -> OIHW 2x2 kernels
    kf = torch.from_numpy(np.ascontiguousarray(
        fold_stage2_kernel(k3).transpose(0, 1, 5, 4, 2, 3))).to(dev)
    c = p["conv_up1.weight"].shape[1]

    def tail_fn(feat: torch.Tensor) -> torch.Tensor:
        z1 = F.leaky_relu(param_conv(feat, p, "conv_up1"), 0.2)
        phases = []
        for a in (0, 1):
            row = []
            for b in (0, 1):
                zp = F.pad(z1, (0, 0, 1 - b, b, 1 - a, a))
                y = conv_nhwc(zp, kf[a, b], p["conv_up2.bias"],
                              padding="valid")
                row.append(F.leaky_relu(y, 0.2))
            phases.append(row)
        bsz, h, w, _ = z1.shape
        # [i1][j1] of [B,H,W, f*4+i2*2+j2] -> composite phase layout
        # f*16 + i1*8 + i2*4 + j1*2 + j2 == the d2s(4) channel convention
        z2 = torch.stack([torch.stack(r, dim=3) for r in phases], dim=3)
        z2 = z2.reshape(bsz, h, w, 2, 2, c, 2, 2)  # [.., i1, j1, f, i2, j2]
        z2 = z2.permute(0, 1, 2, 5, 3, 6, 4, 7)    # [.., f, i1, i2, j1, j2]
        y = depth_to_space(z2.reshape(bsz, h, w, 16 * c), 4)
        y = F.leaky_relu(param_conv(y, p, "conv_hr"), 0.2)
        y = param_conv(y, p, "conv_last")
        return y.clamp(0.0, 1.0) if clip else y

    return tail_fn
