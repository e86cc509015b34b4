"""Plain-torch models of the arithmetic of kernels 17 and B3.

Each function computes what its CUDA kernel computes, in the kernel's own
decomposition and order of sums, so the CPU tests can hold that
decomposition against the plain ops and the reference's Pallas kernels
(the CUDA bodies run only on the card). Each takes the kernel's `plant`
bits (ops/_build.PLANT_*), so the tests can also show how far each
planted fault moves the output.

  blur_separable     kernel 17, ops/csrc/extra_kernels.cu blur_kernel: the
                     map in chunks of at most 64 channels, each image row a
                     chunk-space row of W * cc elements (pixel p, channel c
                     at p * cc + c) zero-padded by r rows and r * cc
                     elements; a row pass with the integer binomial row
                     (horizontal tap dx is element s + (dx - r) * cc), a
                     column pass with the same row, one scale by 1 / norm,
                     one rounding.
  conv_last_tap_major  B3, ops/csrc/stream_kernels.cu conv_last_kernel:
                     strips of 126 output columns with a 1-pixel ring;
                     every input row of a strip through one GEMM [ring
                     pixels, cin] @ [cin, 9 * cout] in f32 (the partials);
                     output (y, x) = bias + the nine partials of input rows
                     y - 1 .. y + 1 at ring pixels x .. x + 2, added in the
                     kernel's order (ky, then kx), rounded once.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops.blur import _MODES

BLUR_CMAX = 64   # channels a chunk (extra_kernels.cu BLUR_CMAX)
LAST_TW = 126    # output columns a strip (stream_kernels.cu TW)


def binomial_row(size: int) -> list[float]:
    """C(size - 1, i): the integer row both blur passes use."""
    return [float(math.comb(size - 1, i)) for i in range(size)]


def blur_separable(x: torch.Tensor, mode: str, plant: int = 0
                   ) -> torch.Tensor:
    """Kernel 17's arithmetic on NHWC x (any C), in x's dtype."""
    size, norm = _MODES[mode]
    r = size // 2
    row = binomial_row(size)
    if plant & _build.PLANT_NORM:
        norm = sum(row)
    scale = float(np.float32(1.0 / norm))
    b, h, w, c = x.shape
    cc = min(c, BLUR_CMAX)
    outs = []
    for c0 in range(0, c, cc):
        xc = x[..., c0:c0 + cc].float()
        real = xc.shape[-1]
        lc = w * cc
        rows = F.pad(xc, (0, cc - real)).reshape(b, h, lc)
        zp = F.pad(rows, (r * cc, r * cc, r, r))
        hsum = torch.zeros((b, h + 2 * r, lc))
        for dx in range(size):
            hsum = hsum + row[dx] * zp[:, :, dx * cc:dx * cc + lc]
        acc = torch.zeros((b, h, lc))
        for dy in range(size):
            acc = acc + row[dy] * hsum[:, dy:dy + h]
        if plant & _build.PLANT_CORNER:
            acc = acc - row[0] * row[0] * zp[:, :h, :lc]
        outs.append((acc * scale).reshape(b, h, w, cc)[..., :real])
    return torch.cat(outs, dim=-1).to(x.dtype)


def conv_last_tap_major(y: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        plant: int = 0) -> torch.Tensor:
    """B3's arithmetic: y [B,H,W,cin], w HWIO [3,3,cin,cout], bias [cout]
    f32 -> [B,H,W,cout] in y's dtype."""
    b, h, wd, cin = y.shape
    cout = w.shape[-1]
    # GEMM columns tap * cout + o, tap = ky * 3 + kx
    wm = w.float().permute(2, 0, 1, 3).reshape(cin, 9 * cout)
    mode = "replicate" if plant & _build.PLANT_ROW_CLAMP else "constant"
    rows = F.pad(y.float().permute(0, 3, 1, 2), (0, 0, 1, 1),
                 mode=mode).permute(0, 2, 3, 1)       # [B, H+2, W, cin]
    strips = -(-wd // LAST_TW)
    rows = F.pad(rows, (0, 0, 1, strips * LAST_TW + 1 - wd))
    b_add = (torch.zeros(cout) if plant & _build.PLANT_BIAS_DROPPED
             else bias.float())
    out = []
    for x0 in range(0, wd, LAST_TW):
        part = rows[:, :, x0:x0 + LAST_TW + 2] @ wm   # [B, H+2, ring, 9c]
        acc = b_add.expand(b, h, LAST_TW, cout)
        for ky in range(3):
            for kx in range(3):
                px = (1 if plant & _build.PLANT_WRONG_NEIGHBOUR
                      and (ky, kx) == (1, 0) else kx)
                tap = (ky * 3 + kx) * cout
                acc = acc + part[:, ky:ky + h, px:px + LAST_TW,
                                 tap:tap + cout]
        out.append(acc)
    return torch.cat(out, dim=2)[:, :, :wd].to(y.dtype)
