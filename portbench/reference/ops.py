"""Plain operations of the reference, and the precision they compute in.

`Precision` says what the operands of every conv, dense layer and
attention product are rounded to before the product: nothing (float32,
the reference), float8 e4m3 with one scale per tensor (the control:
the next precision below the bfloat16 the configurations state, as an
fp8 path of the program would compute) or bfloat16 (the precision the
configurations state, computed plainly: a witness of what rounding
alone does to a reading). Sums, norms, activations and softmax stay in
the tensors' own type (float32, or float64 for a witness).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded through float8 e4m3 with a per-tensor scale that maps
    its largest magnitude to 448; the gradient passes straight through."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    s = FP8_MAX / amax
    y = ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)
    return t + (y - t).detach()


def fake_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded through bfloat16; the gradient passes straight through."""
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t).detach()


class Precision:
    def __init__(self, fp8: bool = False, bf16: bool = False):
        self.fp8, self.bf16 = fp8, bf16

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return fake_fp8(t)
        return fake_bf16(t) if self.bf16 else t


F32 = Precision()
FP8 = Precision(fp8=True)
BF16 = Precision(bf16=True)


def conv(x: torch.Tensor, p: dict, name: str, pr: Precision = F32
         ) -> torch.Tensor:
    """SAME conv of NCHW x with p[name.weight] (OIHW) and p[name.bias]."""
    w = p[f"{name}.weight"]
    return F.conv2d(pr.q(x), pr.q(w), p.get(f"{name}.bias"),
                    padding=w.shape[-1] // 2)


def conv_nhwc(x: torch.Tensor, p: dict, name: str, pr: Precision = F32
              ) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2), p, name, pr).permute(0, 2, 3, 1)


def linear(x: torch.Tensor, p: dict, name: str, pr: Precision = F32
           ) -> torch.Tensor:
    return F.linear(pr.q(x), pr.q(p[f"{name}.weight"]), p[f"{name}.bias"])


def layer_norm(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps=1e-5)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def binomial_blur(x: torch.Tensor, mode: str | None) -> torch.Tensor:
    """The hybrid's fixed anti-checkerboard blur on NHWC x: a depthwise
    binomial kernel, 'light' 3x3 / 16, 'balanced' 5x5 / 256, 'strong'
    7x7 / 1600, SAME zero padding."""
    if mode in (None, "none"):
        return x
    size, norm = {"light": (3, 16.0), "balanced": (5, 256.0),
                  "strong": (7, 1600.0)}[mode]
    row = torch.tensor([math.comb(size - 1, k) for k in range(size)],
                       dtype=torch.float64)
    k = (torch.outer(row, row) / norm).to(x.dtype).to(x.device)
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, size, size),
                 padding=size // 2, groups=c)
    return y.permute(0, 2, 3, 1)
