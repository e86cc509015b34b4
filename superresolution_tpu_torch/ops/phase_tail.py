"""B2 and B3: the x4 tail after the up1 conv, as hand-written CUDA ops.

Replaces superresolution_tpu/ops/pallas_phase_tail.py (_up2hr_kernel and
_last_kernel via phase_hr_last). From z1 = lrelu(up1 conv) at LR,
[B,H,W,4c], the tail computes

    B2 up2_hr:          t = lrelu(conv_up2(d2s(z1, 2)) + b)     [B,2H,2W,4c]
                        y = lrelu(conv_hr(d2s(t, 2)) + b)       [B,4H,4W,c]
    B3 conv_last_phase: out = conv_last(y) + b                  [B,4H,4W,cout]

Both B2 launches read their input through the depth_to_space(2) view of
the shared conv (csrc/sr_kernels.cu), so no pixel-shuffle copy is made,
and lrelu commutes with depth_to_space, so it rides the conv epilogue.
Out-of-image rows and columns read as zero, which is conv_hr's and
conv_last's SAME padding at 2x and 4x by construction (the subtle point
of pallas_phase_tail.py:33-36). B3 writes HR layout directly, so the
caller needs no depth_to_space(4).

Bounds on the H100 per LR pixel: B2 does 1.18 M MACs (4 x 9*64*256 at 2x
plus 16 x 9*64*64 at 4x), ~5.5 TFLOP per 2K frame -> 5.5 ms at 989
TFLOP/s, and writes the 4x 64-channel map (~4.7 GB per frame, 1.4 ms):
bound by operations. B3 reads that map once (1.4 ms) for 27.6 K MACs per
LR pixel: bound by bytes. Weights are HWIO kernels (bf16 on the card)
and f32 biases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops.pixel_shuffle import depth_to_space


def _conv_hwio(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 b.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def up2_hr_reference(z1, up2_w, up2_b, hr_w, hr_b) -> torch.Tensor:
    """Plain PyTorch version of B2."""
    t = F.leaky_relu(_conv_hwio(depth_to_space(z1, 2), up2_w, up2_b), 0.2)
    y = F.leaky_relu(_conv_hwio(depth_to_space(t, 2), hr_w, hr_b), 0.2)
    return y.contiguous()


def conv_last_phase_reference(y, last_w, last_b) -> torch.Tensor:
    """Plain PyTorch version of B3."""
    return _conv_hwio(y, last_w, last_b).contiguous()


def up2_hr(z1: torch.Tensor, up2_w: torch.Tensor, up2_b: torch.Tensor,
           hr_w: torch.Tensor, hr_b: torch.Tensor) -> torch.Tensor:
    """B2: z1 [B,H,W,4c] -> y [B,4H,4W,c]. CPU tensors run the plain
    version; CUDA tensors launch the kernel (two launches) or raise."""
    if z1.device.type == "cpu":
        return up2_hr_reference(z1, up2_w, up2_b, hr_w, hr_b)
    _build.require_cuda(z1, up2_w, hr_w, name="up2_hr")
    _build.require_cuda(up2_b, hr_b, dtype=torch.float32, name="up2_hr")
    b, h, w, c4 = z1.shape
    c = c4 // 4
    if (c4 % 4 or tuple(up2_w.shape) != (3, 3, c, c4)
            or tuple(hr_w.shape) != (3, 3, c, c)
            or tuple(up2_b.shape) != (c4,) or tuple(hr_b.shape) != (c,)):
        raise ValueError(
            f"up2_hr: z1 {tuple(z1.shape)}, up2 {tuple(up2_w.shape)}/"
            f"{tuple(up2_b.shape)}, hr {tuple(hr_w.shape)}/"
            f"{tuple(hr_b.shape)} do not fit [B,H,W,4c], [3,3,c,4c], "
            "[3,3,c,c]")
    t = torch.empty((b, 2 * h, 2 * w, c4), dtype=z1.dtype, device=z1.device)
    _build.conv3x3(z1, c, up2_w, up2_b, t, 0, c4, geom=(b, 2 * h, 2 * w),
                   d2s=True, lrelu=True)
    up2_hr.launches += 1
    y = torch.empty((b, 4 * h, 4 * w, c), dtype=z1.dtype, device=z1.device)
    _build.conv3x3(t, c, hr_w, hr_b, y, 0, c, geom=(b, 4 * h, 4 * w),
                   d2s=True, lrelu=True)
    up2_hr.launches += 1
    return y


up2_hr.launches = 0


def conv_last_phase(y: torch.Tensor, last_w: torch.Tensor,
                    last_b: torch.Tensor) -> torch.Tensor:
    """B3: y [B,H,W,c] -> [B,H,W,cout] (c % 8 == 0, c <= 64, cout <= 4
    on the card). CPU tensors run the plain version."""
    if y.device.type == "cpu":
        return conv_last_phase_reference(y, last_w, last_b)
    _build.require_cuda(y, last_w, name="conv_last_phase")
    _build.require_cuda(last_b, dtype=torch.float32, name="conv_last_phase")
    b, h, w, c = y.shape
    cout = last_w.shape[-1]
    if (c % 8 or c > 64 or cout > 4 or tuple(last_w.shape) != (3, 3, c, cout)
            or tuple(last_b.shape) != (cout,)):
        raise ValueError(
            f"conv_last_phase: y {tuple(y.shape)}, kernel "
            f"{tuple(last_w.shape)}, bias {tuple(last_b.shape)}; the kernel "
            "takes c % 8 == 0, c <= 64, cout <= 4")
    out = torch.empty((b, h, w, cout), dtype=y.dtype, device=y.device)
    _build.conv_last(y, last_w, last_b, out)
    conv_last_phase.launches += 1
    return out


conv_last_phase.launches = 0


def phase_hr_last(z1, up2_w, up2_b, hr_w, hr_b, last_w,
                  last_b) -> torch.Tensor:
    """z1 [B,H,W,4c] -> [B,4H,4W,cout]: B2 then B3.

    The JAX phase_hr_last returns [B,H,W,16*cout] phase slabs for one
    depth_to_space(4); this one returns the HR image directly."""
    return conv_last_phase(up2_hr(z1, up2_w, up2_b, hr_w, hr_b),
                           last_w, last_b)
