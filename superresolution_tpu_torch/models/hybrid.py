"""HybridSR: the two-stage generator with its smoothing slots.

Counterpart of superresolution_tpu/models/hybrid.py: stage1 -> smooth ->
[stage2 -> smooth] -> bicubic resize to output_size (a=-0.75, no
antialias: F.interpolate's convention) -> 'light' smooth, NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from superresolution_tpu_torch.ops.blur import anti_checkerboard
from superresolution_tpu_torch.ops.resize import resize_bicubic
from superresolution_tpu_torch.utils.profiling import span


def resize_to_output(x: torch.Tensor, output_size: int | None
                     ) -> torch.Tensor:
    """x resized to output_size x output_size when its height differs,
    as the reference decides it."""
    if output_size and x.shape[1] != output_size:
        return resize_bicubic(x, (output_size, output_size), a=-0.75,
                              antialias=False)
    return x


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
        with span("hybrid"):
            with span("hybrid.stage1"):
                x = self.stage1(x)
            if self.smoothing:
                x = anti_checkerboard(x, self.smoothing)
            if self.stage2 is not None:
                with span("hybrid.stage2"):
                    x = self.stage2(x)
                if self.smoothing:
                    x = anti_checkerboard(x, self.smoothing)
            x = resize_to_output(x, self.output_size)
            if self.smoothing:
                x = anti_checkerboard(x, "light")
            return x
