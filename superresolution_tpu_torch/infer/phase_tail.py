"""Deploy-time x4 tail through the B2 and B3 CUDA kernels.

Counterpart of superresolution_tpu/infer/phase_tail.py: the up1 conv
stays a plain conv (XLA's in the reference) + lrelu, then
ops/phase_tail.phase_hr_last runs up2 and conv_hr (B2) and conv_last
(B3), writing the [B,4H,4W,out] image directly. Same contract as
make_folded_tail (infer/folded_tail.py), its plain reference: equal on
the same weights up to fp reassociation.

B2 reads z1 phase-major (ops/phase_tail.to_phase_major), so the tail
permutes conv_up1's output channels and bias once, when it is made, and
makes conv_up2's phase-major operands (phase_major_up2) once too; the
function is unchanged.
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
from superresolution_tpu_torch.ops.phase_tail import (
    phase_hr_last,
    phase_major_up2,
    to_phase_major,
)
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
    # conv_up1's output channels (OIHW rows) in phase-major order, so that
    # z1 comes out as B2 reads it
    up1 = {"conv_up1.weight": to_phase_major(
               p["conv_up1.weight"].movedim(0, -1)).movedim(-1, 0)
           .contiguous(),
           "conv_up1.bias": to_phase_major(p["conv_up1.bias"])}
    up2_phase = phase_major_up2(ks["conv_up2"], bs["conv_up2"])

    def tail_fn(feat: torch.Tensor) -> torch.Tensor:
        z1 = F.leaky_relu(param_conv(feat, up1, "conv_up1"), 0.2)
        dt = z1.dtype
        y = phase_hr_last(z1, ks["conv_up2"].to(dt), bs["conv_up2"],
                          ks["conv_hr"].to(dt), bs["conv_hr"],
                          ks["conv_last"].to(dt), bs["conv_last"],
                          layout="phase",
                          up2_phase=(up2_phase[0].to(dt), up2_phase[1]))
        return y.clamp(0.0, 1.0) if clip else y

    return tail_fn
