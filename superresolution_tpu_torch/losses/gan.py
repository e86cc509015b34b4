"""Relativistic average GAN losses (the ESRGAN formulation).

Counterpart of superresolution_tpu/losses/gan.py: D learns that real
logits exceed the mean fake logit and fake logits fall below the mean
real one; G gets the mirrored targets, so its gradient flows through
both the real and the fake logits. Logits are [B, 1]; the math is f32.
"""

from __future__ import annotations

import torch


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Numerically stable BCE-with-logits against a constant target of
    0.0 or 1.0: max(x, 0) - x t + log1p(exp(-|x|))."""
    x = logits.float()
    return (x.clamp(min=0) - x * target
            + torch.log1p(torch.exp(-x.abs()))).mean()


def relativistic_gan_d_loss(real_logits: torch.Tensor,
                            fake_logits: torch.Tensor) -> torch.Tensor:
    rl, fl = real_logits.float(), fake_logits.float()
    loss_real = _bce_with_logits(rl - fl.mean(), 1.0)
    loss_fake = _bce_with_logits(fl - rl.mean(), 0.0)
    return 0.5 * (loss_real + loss_fake)


def relativistic_gan_g_loss(real_logits: torch.Tensor,
                            fake_logits: torch.Tensor) -> torch.Tensor:
    rl, fl = real_logits.float(), fake_logits.float()
    loss_real = _bce_with_logits(rl - fl.mean(), 0.0)
    loss_fake = _bce_with_logits(fl - rl.mean(), 1.0)
    return 0.5 * (loss_real + loss_fake)
