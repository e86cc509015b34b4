"""B2 and B3: the x4 tail after the up1 conv, as hand-written CUDA ops.

Replaces superresolution_tpu/ops/pallas_phase_tail.py (_up2hr_kernel and
_last_kernel via phase_hr_last). From z1 = lrelu(up1 conv) at LR,
[B,H,W,4c], the tail computes

    B2 up2_hr:          t = lrelu(conv_up2(d2s(z1, 2)) + b)     [B,2H,2W,4c]
                        y = lrelu(conv_hr(d2s(t, 2)) + b)       [B,4H,4W,c]
    B3 conv_last_phase: out = conv_last(y) + b                  [B,4H,4W,cout]

Both B2 launches (csrc/tail_kernels.cu, the PhaseUp policy of the conv
engine) read their input through the depth_to_space(2) view, so no
pixel-shuffle copy is made, and lrelu commutes with depth_to_space, so it
rides the conv epilogue. Out-of-image rows and columns read as zero,
which is conv_hr's and conv_last's SAME padding at 2x and 4x by
construction (the subtle point of pallas_phase_tail.py:33-36). B3 writes
HR layout directly, so the caller needs no depth_to_space(4).

Layouts. depth_to_space takes channel f*4 + p of an LR pixel to
sub-pixel p = i*2 + j, channel f, so one HR pixel's channels lie 4 apart.
The kernel reads them as contiguous runs from the phase-major layout
(channel p*c + f holds channel f*4 + p; to_phase_major): B2's own
intermediate t is written so by permuting conv_up2's output columns and
bias (phase_major_up2, built once by the caller), and z1 comes so from a
model whose conv_up1 output channels were permuted the same way
(infer/phase_tail.make_phase_tail does it once); up2_hr's `layout` says
which z1 it holds. uses_tensor_cores routes the launches: bf16 with
c % 8 == 0 runs the engine's tensor-core body, any other c its direct
body; each launch counts on `launches` and on its body's count.

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


def to_phase_major(z: torch.Tensor) -> torch.Tensor:
    """[..., 4c] in depth_to_space's channel order (f*4 + p) -> the
    phase-major order (p*c + f), a new contiguous tensor; works on an
    HWIO kernel's output columns and a bias too."""
    c = z.shape[-1] // 4
    return z.unflatten(-1, (c, 4)).transpose(-1, -2).flatten(-2).contiguous()


def from_phase_major(z: torch.Tensor) -> torch.Tensor:
    """The inverse of to_phase_major."""
    c = z.shape[-1] // 4
    return z.unflatten(-1, (4, c)).transpose(-1, -2).flatten(-2).contiguous()


def phase_major_up2(up2_w: torch.Tensor, up2_b: torch.Tensor) -> tuple:
    """conv_up2's HWIO kernel [3,3,c,4c] and bias [4c] with the output
    columns in phase-major order, so that its output t is phase-major: the
    operands of B2's first launch, built once by a model (up2_hr's
    `up2_phase`)."""
    return to_phase_major(up2_w), to_phase_major(up2_b)


def up2_hr_reference(z1, up2_w, up2_b, hr_w, hr_b,
                     layout: str = "channel") -> torch.Tensor:
    """Plain PyTorch version of B2; z1 in `layout` ("channel": as
    conv_up1 computes it, "phase": to_phase_major of that)."""
    if layout == "phase":
        z1 = from_phase_major(z1)
    t = F.leaky_relu(_conv_hwio(depth_to_space(z1, 2), up2_w, up2_b), 0.2)
    y = F.leaky_relu(_conv_hwio(depth_to_space(t, 2), hr_w, hr_b), 0.2)
    return y.contiguous()


def conv_last_phase_reference(y, last_w, last_b) -> torch.Tensor:
    """Plain PyTorch version of B3."""
    return _conv_hwio(y, last_w, last_b).contiguous()


# The tensor-core body stages c channels of each input pixel.
TC_MAX_CIN = 256


def uses_tensor_cores(z1: torch.Tensor, c: int) -> bool:
    """The route rule: both B2 launches run the conv engine's tensor-core
    body when z1 is bf16 and 8 <= c <= TC_MAX_CIN with c % 8 == 0 (every
    staged run of 8 channels is 16 bytes), else its direct body. It
    routes by shape alone."""
    return (z1.dtype == torch.bfloat16 and c % 8 == 0
            and 8 <= c <= TC_MAX_CIN)


def up2_hr(z1: torch.Tensor, up2_w: torch.Tensor, up2_b: torch.Tensor,
           hr_w: torch.Tensor, hr_b: torch.Tensor, layout: str = "channel",
           up2_phase: tuple | None = None) -> torch.Tensor:
    """B2: z1 [B,H,W,4c] -> y [B,4H,4W,c]; z1 in `layout` ("channel" or
    "phase", see to_phase_major); up2_phase: phase_major_up2(up2_w,
    up2_b), made once by the caller (else made in the call). CPU tensors
    run the plain version; CUDA tensors launch the kernel (two launches)
    or raise. A channel-layout z1 on the card is re-laid by one copy
    first."""
    if layout not in ("channel", "phase"):
        raise ValueError(f"up2_hr: layout {layout!r}, expected 'channel' or "
                         "'phase'")
    if z1.device.type == "cpu":
        return up2_hr_reference(z1, up2_w, up2_b, hr_w, hr_b, layout)
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
    wp, bp = up2_phase or phase_major_up2(up2_w, up2_b)
    if wp.shape != up2_w.shape or bp.shape != up2_b.shape:
        raise ValueError("up2_hr: up2_phase does not match conv_up2's shapes")
    _build.require_cuda(z1, wp, hr_w, name="up2_hr")
    _build.require_cuda(bp, hr_b, dtype=torch.float32, name="up2_hr")
    if layout == "channel":
        z1 = to_phase_major(z1)
    return up2_hr_launches(z1, wp, bp, hr_w, hr_b)


def up2_hr_launches(z1: torch.Tensor, up2_wp: torch.Tensor,
                    up2_bp: torch.Tensor, hr_w: torch.Tensor,
                    hr_b: torch.Tensor) -> torch.Tensor:
    """B2's two launches on a phase-major z1 with conv_up2's phase-major
    operands, in the body uses_tensor_cores picks, each counted; callers
    have validated the CUDA tensors."""
    b, h, w, c4 = z1.shape
    c = c4 // 4
    tc = uses_tensor_cores(z1, c)
    t = torch.empty((b, 2 * h, 2 * w, c4), dtype=z1.dtype, device=z1.device)
    _build.up_conv(z1, up2_wp, up2_bp, t, tc)
    _count(tc)
    y = torch.empty((b, 4 * h, 4 * w, c), dtype=z1.dtype, device=z1.device)
    _build.up_conv(t, hr_w, hr_b, y, tc)
    _count(tc)
    return y


def _count(tc: bool) -> None:
    up2_hr.launches += 1
    if tc:
        up2_hr.tc_launches += 1
    else:
        up2_hr.direct_launches += 1


up2_hr.launches = 0
up2_hr.tc_launches = 0   # by body
up2_hr.direct_launches = 0


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


def phase_hr_last(z1, up2_w, up2_b, hr_w, hr_b, last_w, last_b,
                  layout: str = "channel",
                  up2_phase: tuple | None = None) -> torch.Tensor:
    """z1 [B,H,W,4c] -> [B,4H,4W,cout]: B2 then B3 (layout and up2_phase
    as up2_hr's).

    The JAX phase_hr_last returns [B,H,W,16*cout] phase slabs for one
    depth_to_space(4); this one returns the HR image directly."""
    return conv_last_phase(up2_hr(z1, up2_w, up2_b, hr_w, hr_b, layout,
                                  up2_phase), last_w, last_b)
