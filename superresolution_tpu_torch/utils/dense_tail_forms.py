"""Plain-torch models of B1's, B2's and kernels 4 and 5's conv-engine
launches, in the conv engine's GEMM form.

The CUDA bodies run only on the card, so these forms hold, on the CPU,
what one launch computes and in which order (ops/csrc/dense_kernels.cu
DenseConv, ops/csrc/tail_kernels.cu PhaseUp, both under conv_engine.cuh's
tensor-core body, and DenseConv's conv_first under its direct body): the
staged input tile (im2col with a zero halo, column tap * cin + ci, tap =
ky * 3 + kx) times the HWIO weight read as the K-major matrix [9 * cin,
cout], summed in f32, plus the f32 bias, then the policy's epilogue in
f32 and one rounding to the output's type. Each takes the arguments of
its _build launch helper, so a test can put it in the helper's place and
run the wrappers' launch sequences (ops/dense_trunk.dense_block_launches,
prologue_launches, epilogue_launches, ops/phase_tail.up2_hr_launches) on
CPU tensors, planted faults included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops._build import PLANT_HALO_CLAMPED

# the planted faults of B2 (_build.PLANT_SWAP_PHASE, PLANT_CLAMP_EDGE,
# PLANT_BIAS_OFF)
SWAP_PHASE, CLAMP_EDGE, BIAS_OFF = 1, 2, 3


def im2col(u: torch.Tensor, pad: str = "zeros") -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 9C], column tap * C + ci, the halo zero
    (pad "zeros") or the nearest border pixel ("replicate")."""
    h, w = u.shape[1:3]
    t = u.permute(0, 3, 1, 2)
    t = (F.pad(t, (1, 1, 1, 1)) if pad == "zeros"
         else F.pad(t, (1, 1, 1, 1), mode="replicate"))
    cols = [t[:, :, ky:ky + h, kx:kx + w] for ky in range(3)
            for kx in range(3)]
    return torch.cat(cols, dim=1).permute(0, 2, 3, 1)


def image_row_mask(h: int, seg) -> torch.Tensor:
    """[H, 1, 1] f32: 1 on the image rows of a map packed with seg =
    (stride, valid), 0 on its spacer rows; all 1 without seg."""
    y = torch.arange(h)
    keep = torch.ones(h) if seg is None else (y % seg[0] < seg[1]).float()
    return keep[:, None, None]


def dense_conv_form(x: torch.Tensor, ws: torch.Tensor | None, cin1: int,
                    w: torch.Tensor, bias: torch.Tensor | None,
                    out: torch.Tensor, out_off: int, *, lrelu: bool = False,
                    xres: torch.Tensor | None = None,
                    res: torch.Tensor | None = None,
                    add: torch.Tensor | None = None, seg=None,
                    seg_plant: int = 0) -> None:
    """One launch of _build.dense_conv (DenseConv): the K rows are x's C
    channels then ws's first cin1, each staged run read as zero on a
    spacer row; f32 sums, bias, lrelu, x + 0.2 v, res + 0.2 v, v + add,
    spacer rows 0 (not with seg_plant), then one rounding into out[...,
    out_off:out_off + cout]."""
    cout = w.shape[-1]
    u = torch.cat([x, ws[..., :cin1]], -1) if cin1 else x
    keep = image_row_mask(x.shape[1], seg)
    a = im2col(u.float() * keep)
    v = a @ w.float().reshape(-1, cout)
    if bias is not None:
        v = v + bias.float()
    if lrelu:
        v = F.leaky_relu(v, 0.2)
    if xres is not None:
        v = xres.float() + 0.2 * v
    if res is not None:
        v = res.float() + 0.2 * v
    if add is not None:
        v = v + add.float()
    if not seg_plant:
        v = v * keep
    out[..., out_off:out_off + cout] = v.to(out.dtype)


def first_conv_form(x_raw: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor | None, out: torch.Tensor,
                    plant: int = 0) -> None:
    """One launch of _build.first_conv (kernel 4's conv_first, DenseConv
    on the direct body): im2col of x_raw's Cin channels, any Cin, times
    the HWIO weight as [9 * Cin, cout], f32 sums plus the bias, one
    rounding into out; with _build.PLANT_HALO_CLAMPED in plant the halo
    reads the nearest border pixel, not zero."""
    cout = w.shape[-1]
    pad = "replicate" if plant & PLANT_HALO_CLAMPED else "zeros"
    v = im2col(x_raw.float(), pad) @ w.float().reshape(-1, cout)
    if bias is not None:
        v = v + bias.float()
    out.copy_(v.to(out.dtype))


def d2s_view(z: torch.Tensor, swap: bool = False) -> torch.Tensor:
    """The logical [B, 2h, 2w, c] input that PhaseUp reads from a
    phase-major z [B, h, w, 4c]: pixel (Y, X), channel f is z's pixel
    (Y / 2, X / 2), channel p * c + f with p = (Y & 1) * 2 + (X & 1)
    (swap: p = (X & 1) * 2 + (Y & 1))."""
    b, h, w, c4 = z.shape
    t = z.reshape(b, h, w, 2, 2, c4 // 4)  # [.., i, j, f], p = i * 2 + j
    if swap:
        t = t.transpose(3, 4)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c4 // 4)


def up_conv_form(z: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
                 out: torch.Tensor, tc: bool = True, plant: int = 0) -> None:
    """One launch of _build.up_conv (PhaseUp), either body: out = lrelu(
    im2col(d2s_view(z)) @ w + bias) in f32, one rounding; the planted
    faults as the kernel's (the phases swapped, the halo clamped to the
    border, the bias dropped)."""
    n = w.shape[-1]
    u = d2s_view(z.float(), swap=plant == SWAP_PHASE)
    a = im2col(u, "replicate" if plant == CLAMP_EDGE else "zeros")
    v = a @ w.float().reshape(-1, n)
    if bias is not None and plant != BIAS_OFF:
        v = v + bias.float()
    out.copy_(F.leaky_relu(v, 0.2).to(out.dtype))
