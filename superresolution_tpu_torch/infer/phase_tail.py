"""Deploy-time x4 tail through the B2 and B3 CUDA kernels.

Counterpart of superresolution_tpu/infer/phase_tail.py: the up1 conv
stays a plain conv (XLA's in the reference) + lrelu, then
ops/phase_tail.phase_hr_last runs up2 and conv_hr (B2) and conv_last
(B3), writing the [B,4H,4W,out] image directly. Same contract as
make_folded_tail (infer/folded_tail.py), its plain reference: equal on
the same weights up to fp reassociation.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.infer.common import (
    hwio,
    param_conv,
    state_tensors,
)
from superresolution_tpu_torch.ops.phase_tail import phase_hr_last
from superresolution_tpu_torch.runtime import resolve_device


def make_phase_tail(params: Mapping, clip: bool = True,
                    device: str | torch.device | None = None):
    """tail_fn(feat [B,H,W,C]) -> [B,4H,4W,out] from a BasicSR-keyed
    RRDBNet(pixelshuffle, scale=4) state dict. Kernels keep the params'
    dtype and are cast to the features' at the call (bf16 on the card);
    biases run in f32."""
    dev = resolve_device(device)
    p = state_tensors(params, dev)
    if "conv_up3.weight" in p or "conv_up2.weight" not in p:
        raise ValueError("the phase tail takes a x4 pixelshuffle tail "
                         "(conv_up1 and conv_up2)")
    ks = {n: hwio(p[f"{n}.weight"]) for n in ("conv_up2", "conv_hr",
                                               "conv_last")}
    bs = {n: p[f"{n}.bias"].float() for n in ks}

    def tail_fn(feat: torch.Tensor) -> torch.Tensor:
        z1 = F.leaky_relu(param_conv(feat, p, "conv_up1"), 0.2)
        dt = z1.dtype
        y = phase_hr_last(z1, ks["conv_up2"].to(dt), bs["conv_up2"],
                          ks["conv_hr"].to(dt), bs["conv_hr"],
                          ks["conv_last"].to(dt), bs["conv_last"])
        return y.clamp(0.0, 1.0) if clip else y

    return tail_fn
