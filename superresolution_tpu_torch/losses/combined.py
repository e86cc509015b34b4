"""CombinedLoss: a weighted sum of named terms with a per-term log dict.

Counterpart of superresolution_tpu/losses/combined.py. `star_l1` and
`star_l1_pallas` run kernel 14 (ops/star_l1.py) on CUDA tensors and its
plain version on CPU tensors, as the reference runs its Pallas kernel on
the accelerator (combined.py:43-59). `perceptual` is the VGG19
feature-space L1 at cfg.perceptual_layers[0] (losses/perceptual.py);
`gan` is skipped (the GAN step, train/gan.py, adds it).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from superresolution_tpu_torch.losses.basic import (
    astro_loss,
    charbonnier_loss,
    l1_loss,
    l2_loss,
)
from superresolution_tpu_torch.losses.perceptual import perceptual_loss
from superresolution_tpu_torch.ops.star_l1 import star_weighted_l1_cuda
from superresolution_tpu_torch.utils.config import LossConfig


@dataclass
class CombinedLoss:
    config: LossConfig = field(default_factory=LossConfig)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor):
        """-> (total f32 scalar, {term: value, ..., 'total': total})."""
        cfg = self.config
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        logs: dict[str, torch.Tensor] = {}
        for name, weight in cfg.terms.items():
            if name == "l1":
                v = l1_loss(pred, target)
            elif name == "l2":
                v = l2_loss(pred, target)
            elif name == "charbonnier":
                v = charbonnier_loss(pred, target, cfg.charbonnier_eps)
            elif name in ("star_l1", "star_l1_pallas"):
                v = star_weighted_l1_cuda(pred, target, cfg.star_threshold,
                                          cfg.star_weight)
            elif name == "astro":
                v = astro_loss(pred, target, cfg.astro_weight_scale,
                               cfg.charbonnier_eps)
            elif name == "perceptual":
                v = perceptual_loss(pred, target,
                                    tap=cfg.perceptual_layers[0])
            elif name == "gan":
                continue  # the adversarial term is added by the GAN step
            else:
                raise ValueError(f"unknown loss term {name!r}")
            logs[name] = v
            total = total + weight * v
        logs["total"] = total
        return total, logs
