"""HybridSR: the two-stage generator with its smoothing slots.

Counterpart of superresolution_tpu/models/hybrid.py: stage1 -> smooth ->
[stage2 -> smooth] -> resize to output_size -> 'light' smooth, NHWC. The
bicubic resize (ops/resize.resize_bicubic) is not ported yet, so a
forward whose stage output is not output_size raises NotImplementedError;
the hybrid deploy configuration (128 -> 256 -> 512) needs no resize.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from superresolution_tpu_torch.ops.blur import anti_checkerboard


def check_output_size(x: torch.Tensor, output_size: int | None) -> None:
    if output_size and x.shape[1] != output_size:
        raise NotImplementedError(
            f"HybridSR would resize {x.shape[1]} -> {output_size}; "
            "resize_bicubic is not ported yet")


class HybridSR(nn.Module):
    def __init__(self, stage1: nn.Module, stage2: nn.Module | None = None,
                 output_size: int | None = 512,
                 smoothing: str | None = "balanced"):
        super().__init__()
        if stage1 is None:
            raise ValueError("HybridSR requires a stage1 module")
        self.stage1, self.stage2 = stage1, stage2
        self.output_size, self.smoothing = output_size, smoothing

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stage1(x)
        if self.smoothing:
            x = anti_checkerboard(x, self.smoothing)
        if self.stage2 is not None:
            x = self.stage2(x)
            if self.smoothing:
                x = anti_checkerboard(x, self.smoothing)
        check_output_size(x, self.output_size)
        if self.smoothing:
            x = anti_checkerboard(x, "light")
        return x
