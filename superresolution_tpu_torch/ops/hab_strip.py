"""Kernel 11: the HAB block read from and written to the spatial map, as
a hand-written CUDA op.

Replaces superresolution_tpu/ops/pallas_hab_strip.py: strip_hab_block
(_kernel). On x and cab_y [B,H,W,C] (cab_y the CAB's pre-squeeze-excite
conv output, kernel 7's) and se [B,1,C] (the squeeze-excite sigmoid
times conv_scale, f32), with shift 0 or ws // 2, it computes

    roll(x, -shift) -> window_partition -> kernel 8's body with
    cab = bf16(cab_y * se) -> window_merge -> roll(+shift)

as one launch: one thread block per (image, window) reads its tokens
straight from the maps, token (tr, tc) of window (wr, wc) at pixel
((wr*ws + tr + shift) mod H, (wc*ws + tc + shift) mod W), builds the
Swin region mask from those rolled-frame positions, and writes each
output back to the pixel it came from (csrc/hat_kernels.cu, hab_kernel
with the map addressing). The TPU kernel's row strips (rb) exist to keep
a VMEM block large; the card needs none, so rb only has to be what the
reference would accept (a multiple of ws that divides H) and the result
does not depend on it, as in the reference.

The CAB term is rounded once, bf16(cab_y * se), as the strip kernel
rounds it; the windowed path rounds twice (y * s, then * conv_scale).

Bound on the H100: kernel 8's work, 86,016 MACs per token at (96, 64,
192), for x and cab_y read once and the output written once (576 bytes a
token): 0.0114 ms at [1,256,256,96], ws 8: bound by operations. It runs
kernel 8's tensor-core body, on the dense kernels as hab_weights packs
them for it (ops/hab.mma_weights).
"""

from __future__ import annotations

from typing import Mapping

import torch

from superresolution_tpu_torch.models.hat_lite import (
    shift_region_ids,
    window_merge,
    window_partition,
)
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops.hab import (
    check_hab_weights,
    hab_body_reference,
)

# the geometries kernel 11 is instantiated for: kernel 8's without c_real
# ((C, heads, tokens n, MLP hidden); the reference's strip path runs only
# unpadded)
STRIP_GEOMETRIES = ((96, 6, 64, 192), (96, 6, 256, 192), (120, 6, 256, 240))

__all__ = ["STRIP_GEOMETRIES", "strip_hab_block", "strip_hab_block_reference",
           "strip_weights"]


def strip_weights(weights: Mapping[str, torch.Tensor], nh: int,
                  n: int) -> dict[str, torch.Tensor]:
    """Kernel 8's weights (ops/hab.hab_weights) -> kernel 11's: the same
    dict, with rpb [nh, n, n]. Like the reference's strip_weights it
    takes rpb in either layout, here also the reference's stacked [nh*n,
    n] (block h = rpb[h].T), which it unstacks."""
    w = dict(weights)
    if tuple(w["rpb"].shape) == (nh * n, n):
        w["rpb"] = w["rpb"].reshape(nh, n, n).transpose(1, 2).contiguous()
    return w


def strip_hab_block_reference(x: torch.Tensor, cab_y: torch.Tensor,
                              se: torch.Tensor,
                              weights: Mapping[str, torch.Tensor],
                              num_heads: int, ws: int,
                              shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel 11: the roll, window partition,
    kernel 8's plain body (hab_body_reference) on cab = bf16(cab_y * se),
    window merge and roll back."""
    b, h, w, c = x.shape
    cab = (cab_y.float() * se.float().reshape(b, 1, 1, c)).to(x.dtype)
    ids = None
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        cab = torch.roll(cab, (-shift, -shift), dims=(1, 2))
        ids = torch.as_tensor(shift_region_ids(h, w, ws, shift),
                              device=x.device)
    out = hab_body_reference(window_partition(x, ws),
                             window_partition(cab, ws), weights, num_heads,
                             ids)
    out = window_merge(out, ws, (h, w))
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out.contiguous()


def strip_hab_block(x: torch.Tensor, cab_y: torch.Tensor, se: torch.Tensor,
                    weights: Mapping[str, torch.Tensor], *, num_heads: int,
                    window_size: int, shift: int = 0,
                    rb: int | None = None) -> torch.Tensor:
    """Kernel 11. x, cab_y [B,H,W,C], H and W multiples of window_size;
    se [B,1,C] f32; weights by HAB_WEIGHTS (rpb [nh, n, n] or the
    reference's stacked [nh*n, n]); shift 0 or window_size // 2; rb, the
    reference's row block, checked and otherwise unused; on the card the
    dense kernels' packings too (hab_weights packs them). Returns
    [B,H,W,C]. CPU tensors run the plain version; CUDA tensors launch
    the kernel ((C, heads, n, MLP) in STRIP_GEOMETRIES; bf16 maps and
    dense kernels, f32 se and the rest) or raise."""
    b, h, w, c = x.shape
    ws, nh = int(window_size), int(num_heads)
    n = ws * ws
    if h % ws or w % ws:
        raise ValueError(f"strip_hab_block: H={h}, W={w} must be multiples "
                         f"of ws={ws}")
    if shift not in (0, ws // 2):
        raise ValueError(f"strip_hab_block: shift={shift} must be 0 or "
                         f"ws//2={ws // 2}")
    if rb is not None and (rb < ws or rb % ws or h % rb):
        raise ValueError(f"strip_hab_block: rb={rb} must be a multiple of "
                         f"ws={ws} that divides H={h}")
    if cab_y.shape != x.shape or tuple(se.shape) != (b, 1, c):
        raise ValueError(f"strip_hab_block: cab_y {tuple(cab_y.shape)} and "
                         f"se {tuple(se.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    wts = strip_weights(weights, nh, n)
    if x.device.type == "cpu":
        return strip_hab_block_reference(x, cab_y, se, wts, nh, ws, shift)
    check_hab_weights("strip_hab_block", wts, c, nh, n, STRIP_GEOMETRIES)
    _build.require_cuda(x, cab_y, name="strip_hab_block")
    _build.require_cuda(se, dtype=torch.float32, name="strip_hab_block")
    out = torch.empty_like(x)
    _build.strip_hab(x, cab_y, se, wts, nh, ws, shift, out)
    strip_hab_block.launches += 1
    return out


strip_hab_block.launches = 0
