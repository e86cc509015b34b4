"""Kernel 14: the star-weighted L1 loss as a hand-written CUDA op.

Replaces superresolution_tpu/ops/pallas_loss.py:star_weighted_l1_pallas
(forward _fwd_kernel, backward _bwd_kernel). What it computes, over all
n elements of pred and target:

    loss = sum(|p - t| * w(t)) / n,   w(t) = weight if t > threshold else 1
    dp   = sign(p - t) * w(t) * g / n      (sign(0) = 0; no grad to target)

On the card (csrc/train_kernels.cu) the forward is one launch: float4
loads, per-block f32 partials, and the last block to finish sums them in
block order, so two runs give the same bits; the backward is one
elementwise float4 launch that reads the upstream gradient g on the
card. Both are bound by bytes: at the main path's [4,512,512,1] f32 the
forward reads 8 MB and the backward moves 12 MB, ~6 us at 3.35 TB/s.

`launches` counts the op's launches on the card: one per forward and
one per backward. The plain version is
losses/basic.star_weighted_l1; CPU tensors run it.
"""

from __future__ import annotations

import torch

from superresolution_tpu_torch.losses.basic import star_weighted_l1
from superresolution_tpu_torch.ops import _build


def _check(pred: torch.Tensor, target: torch.Tensor) -> None:
    _build.require_cuda(pred, target, dtype=torch.float32,
                        name="star_weighted_l1_cuda")
    if pred.shape != target.shape:
        raise ValueError(f"star_weighted_l1_cuda: pred {tuple(pred.shape)} "
                         f"!= target {tuple(target.shape)}")
    if pred.numel() == 0:
        raise ValueError("star_weighted_l1_cuda: empty input")


class StarWeightedL1(torch.autograd.Function):
    """Kernel 14 with its backward; CUDA f32 tensors only (raises on other
    devices and types)."""

    @staticmethod
    def forward(ctx, pred, target, threshold: float, weight: float):
        _check(pred, target)
        out = torch.empty(1, dtype=torch.float32, device=pred.device)
        _build.star_l1_value(pred, target, threshold, weight, out)
        star_weighted_l1_cuda.launches += 1
        ctx.save_for_backward(pred, target)
        ctx.threshold, ctx.weight = threshold, weight
        return out.reshape(())

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        dp = torch.empty_like(pred)
        _build.star_l1_grad(pred, target, ctx.threshold, ctx.weight,
                            g.to(torch.float32).reshape(1).contiguous(), dp)
        star_weighted_l1_cuda.launches += 1
        return dp, None, None, None


def star_weighted_l1_cuda(pred: torch.Tensor, target: torch.Tensor,
                          threshold: float = 0.02,
                          weight: float = 500.0) -> torch.Tensor:
    """Kernel 14. CPU tensors run the plain version; CUDA tensors (f32,
    contiguous) launch the kernels or raise."""
    if pred.device.type == "cpu":
        return star_weighted_l1(pred, target, threshold, weight)
    return StarWeightedL1.apply(pred.contiguous(), target.contiguous(),
                                float(threshold), float(weight))


star_weighted_l1_cuda.launches = 0
