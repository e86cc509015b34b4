"""Shared helpers for the deploy-time inference rewrites.

Counterpart of superresolution_tpu/infer/common.py: the convs the JAX
package leaves to XLA are plain F.conv2d here, on NHWC tensors with
PyTorch's OIHW weights. Weights are read from a BasicSR-keyed state dict
(models/convert.py bridges the JAX trees into one).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F


def state_tensors(params: Mapping, device: torch.device
                  ) -> dict[str, torch.Tensor]:
    """A state dict of numpy arrays or tensors -> detached tensors on
    `device`, each keeping its dtype."""
    return {k: (v.detach() if isinstance(v, torch.Tensor)
                else torch.tensor(np.asarray(v))).to(device)
            for k, v in params.items()}


def hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv kernel -> contiguous HWIO, the layout the kernels read."""
    return w.permute(2, 3, 1, 0).contiguous()


def conv_nhwc(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor | None = None,
              padding: str = "same") -> torch.Tensor:
    """Conv of NHWC `x` with an OIHW kernel (+ optional bias), in x's
    dtype; returns contiguous NHWC."""
    w = w.to(x.dtype)
    b = None if b is None else b.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def param_conv(x: torch.Tensor, params: Mapping[str, torch.Tensor],
               name: str, padding: str = "same") -> torch.Tensor:
    """conv_nhwc on the `name.weight` / `name.bias` entries of a state dict."""
    return conv_nhwc(x, params[f"{name}.weight"], params[f"{name}.bias"],
                     padding)


class PreboundModel:
    """A deploy model whose weights are bound already (fused_rrdb_model,
    fused_hybrid_model): .apply(_params, x) ignores the params, as the
    reference's PreboundModel, so the tilers take it in place of a module
    and its state dict; calling it runs the bound function too."""

    def __init__(self, apply_fn):
        self._fn = apply_fn

    def apply(self, _params, x: torch.Tensor) -> torch.Tensor:
        return self._fn(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._fn(x)
