"""VGG19 perceptual (feature-space) loss.

Counterpart of superresolution_tpu/losses/perceptual.py:27-117: the
VGG19 feature stack up to `tap` (relu3_4 by default, torchvision's
vgg19.features[:18]; conv5_4 before its ReLU with pre_activation, as
ESRGAN takes it), frozen, on inputs clipped to [0, 1] and
ImageNet-normalized, a 1-channel input repeated to 3 channels; the loss
is mean |phi(pred) - phi(target)| in f32, with no gradient through the
target's features.

The stack is an nn.Sequential laid out as torchvision's
(`features.N` = conv, ReLU or 2x2 max-pool), so a local npz named by
SRTPU_VGG19_NPZ with torchvision's keys (`features.N.weight` OIHW,
`features.N.bias`) loads as it is; models/convert.vgg19_npz_from_jax
writes one from the JAX package's VGG tree. Without such a file the
weights are a fixed-seed random init (torch.Generator().manual_seed(0),
flax's lecun-normal kernels and zero biases): its values are the port's
own draw, not JAX's. Nothing is downloaded.

One frozen network per (tap, pre_activation, device), built on first
use and cached; it is never part of a generator's parameters,
optimizer or checkpoints.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn

from superresolution_tpu_torch.models.common import lecun_normal_

# (name, out_channels); 'M' = 2x2 max-pool. The VGG19 feature stack.
VGG19_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), ("M", 0),
    ("conv2_1", 128), ("conv2_2", 128), ("M", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("M", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("M", 0),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# torchvision's features.N index of each conv (a ReLU follows each)
TORCH_IDX: dict[str, int] = {}
_i = 0
for _name, _c in VGG19_CFG:
    if _name == "M":
        _i += 1
    else:
        TORCH_IDX[_name] = _i
        _i += 2


class VGG19Features(nn.Module):
    """The VGG19 trunk up to `tap` (inclusive; post-ReLU unless
    pre_activation). Input NHWC in [0, 1], 1 or 3 channels; returns the
    NCHW feature map. Built on the CPU from `generator`."""

    def __init__(self, tap: str = "relu3_4", pre_activation: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        target = tap.replace("relu", "conv")
        if target not in TORCH_IDX:
            raise ValueError(f"unknown tap {tap!r}")
        layers: list[nn.Module] = []
        cin = 3
        for name, ch in VGG19_CFG:
            if name == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            conv = nn.Conv2d(cin, ch, 3, padding=1, device="cpu")
            lecun_normal_(conv.weight, cin * 9, generator)
            nn.init.zeros_(conv.bias)
            layers.append(conv)
            cin = ch
            if name == target and pre_activation:
                break
            layers.append(nn.ReLU())
            if name == target:
                break
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        x = (x.clamp(0.0, 1.0) - self.mean) / self.std
        return self.features(x)


def _load_npz(model: VGG19Features, path: str) -> None:
    """The npz's features.N tensors into the model's layers it has."""
    with np.load(path) as raw:
        sd = {k: torch.from_numpy(np.asarray(raw[k], np.float32))
              for k in model.state_dict() if k in raw}
    model.load_state_dict(sd, strict=False)


def _pretrained_npz() -> str | None:
    """The path SRTPU_VGG19_NPZ names, when that file exists."""
    npz = os.environ.get("SRTPU_VGG19_NPZ", "")
    return npz if npz and os.path.exists(npz) else None


@lru_cache(maxsize=None)
def _load_cached(tap: str, pre_activation: bool, device: str):
    model = VGG19Features(tap, pre_activation,
                          generator=torch.Generator().manual_seed(0))
    npz = _pretrained_npz()
    if npz:
        _load_npz(model, npz)
    return model.to(device).eval().requires_grad_(False)


def vgg19_features(tap: str = "relu3_4", pre_activation: bool = False,
                   device: str | torch.device = "cpu") -> VGG19Features:
    """The cached frozen network for (tap, pre_activation, device)."""
    return _load_cached(tap, pre_activation, str(torch.device(device)))


def perceptual_loss(pred: torch.Tensor, target: torch.Tensor,
                    tap: str = "relu3_4",
                    pre_activation: bool = False) -> torch.Tensor:
    """L1 distance in VGG19 feature space (f32), on pred's device."""
    net = vgg19_features(tap, pre_activation, pred.device)
    fp = net(pred.float())
    with torch.no_grad():
        ft = net(target.float())
    return (fp - ft).abs().mean()


def has_pretrained_vgg() -> bool:
    """True when SRTPU_VGG19_NPZ names an existing file, from which a
    network built now loads its weights."""
    return _pretrained_npz() is not None
