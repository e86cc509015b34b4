"""Paired geometric augmentation on the device.

Counterpart of superresolution_tpu/data/augment.py:17-41: an independent
50% horizontal flip, 50% vertical flip and a uniform k * 90 degree
rotation, in that order, with the same draw for LR and HR. The draw
comes from a CPU torch.Generator, so it costs no device sync; the flips
and rotations run where the images are. Square HWC patches, as in the
reference.
"""

from __future__ import annotations

import torch


def _rot90_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """HWC rotation by k * 90 degrees, k in [0, 4), as the reference's
    lax.switch branches."""
    if k == 0:
        return x
    if k == 1:
        return x.transpose(0, 1).flip(0)
    if k == 2:
        return x.flip((0, 1))
    return x.transpose(0, 1).flip(1)


def _apply(x: torch.Tensor, hflip: bool, vflip: bool, k: int) -> torch.Tensor:
    if hflip:
        x = x.flip(1)
    if vflip:
        x = x.flip(0)
    return _rot90_k(x, k)


def paired_augment(generator: torch.Generator, lr: torch.Tensor,
                   hr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Augment one HWC LR/HR pair with one shared draw from `generator`
    (a CPU generator)."""
    hflip, vflip = torch.randint(0, 2, (2,), generator=generator).tolist()
    k = int(torch.randint(0, 4, (), generator=generator))
    return (_apply(lr, bool(hflip), bool(vflip), k),
            _apply(hr, bool(hflip), bool(vflip), k))
