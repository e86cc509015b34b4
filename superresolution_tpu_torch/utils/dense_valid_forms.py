"""Kernel 16's stages on the conv engine's tensor-core body (ops/csrc/
dense_valid_kernels.cu, policy DenseStage) as plain PyTorch, for the CPU
tests.

The CUDA body runs only on the card. dense_stage_form repeats what one
launch of stage j computes, in the engine's GEMM form: over the padded
frame's region [j, H+10-j) x [j, W+10-j), each output pixel's 3x3 window
of input pixels (x's c channels, zero outside the image: the pad; then
y_1..y_{j-1} from the workspace) as the im2col row tap * cin_j + ci,
times stage j's K-major weights (ops/dense_valid.pack_stage_weights),
summed in f32, plus the f32 bias, then finish in f32 (lrelu for j < 5,
x + 0.2 v for j = 5) and one rounding to x's type, stored at the
workspace's channels (j-1)g.. (frame pixel (r, s) at (r-1, s-1)) or the
output. It takes the arguments of _build.dense_valid_tc, so a test can put
it in the helper's place and run ops/dense_valid.dense_valid_launches on
CPU tensors, planted faults included (ops/_build.PLANT_SAME,
PLANT_NO_SCALE)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops._build import PLANT_NO_SCALE, PLANT_SAME

PAD = 5  # the one zero pad around x


def stage_inputs(x: torch.Tensor, ws: torch.Tensor, j: int) -> torch.Tensor:
    """[B, H+10, W+10, c + (j-1)g] f32: stage j's input channels over the
    whole padded frame, x's zero outside the image, the workspace's y_1..
    y_{j-1} at frame pixel (r, s) = workspace pixel (r-1, s-1) (0 on the
    frame's outer ring, which no stage reads)."""
    g = ws.shape[-1] // 4
    xp = F.pad(x.float(), (0, 0, PAD, PAD, PAD, PAD))
    if j == 1:
        return xp
    wsf = F.pad(ws[..., :(j - 1) * g].float(), (0, 0, 1, 1, 1, 1))
    return torch.cat([xp, wsf], -1)


def dense_stage_form(x: torch.Tensor, ws: torch.Tensor, out: torch.Tensor,
                     wk: torch.Tensor, bias: torch.Tensor, j: int,
                     plant: int = 0) -> None:
    """One launch of _build.dense_valid_tc: stage j (1..5) of kernel 16
    on x [B,H,W,c], the workspace ws [B,H+8,W+8,4g] and out [B,H,W,c],
    with wk stage j's K-major [9 * cin_j, cout_j] and bias [4g + c]."""
    h, w, c = x.shape[1:]
    g = ws.shape[-1] // 4
    rows, cols = h + 10 - 2 * j, w + 10 - 2 * j
    u = stage_inputs(x, ws, j)
    # the region with its 1-pixel halo: frame rows and columns j-1 ..
    win = u[:, j - 1:j + 1 + rows, j - 1:j + 1 + cols]
    a = torch.cat([win[:, ky:ky + rows, kx:kx + cols] for ky in range(3)
                   for kx in range(3)], -1)
    n = wk.shape[1]
    v = a @ wk.float() + bias.float()[(j - 1) * g:(j - 1) * g + n]
    if j < 5:
        v = F.leaky_relu(v, 0.2)
        if plant & PLANT_SAME:
            r = torch.arange(j, j + rows)
            s = torch.arange(j, j + cols)
            inside = (((r >= PAD) & (r < h + PAD))[:, None]
                      & ((s >= PAD) & (s < w + PAD))[None, :])
            v = v * inside[..., None]
        ws[:, j - 1:j - 1 + rows, j - 1:j - 1 + cols,
           (j - 1) * g:j * g] = v.to(ws.dtype)
        return
    scale = 1.0 if plant & PLANT_NO_SCALE else 0.2
    out.copy_((x.float() + scale * v).to(out.dtype))
