"""Kernel 7's one-launch tensor-core body (ops/csrc/cab_kernels.cu
cab_tc_kernel) as plain PyTorch, tile by tile, for the CPU tests.

The CUDA body runs only on the card. This form repeats what one launch
does to each TH x 16 output tile, in the kernel's order and with its
rounding points, so that tests/test_torch_cab_forms.py can hold it
against the reference's Pallas kernel in interpret mode:

  1. the tile of x with a 2-pixel halo, zeros outside the image and in
     the channels C .. kp1 (C rounded up to a k-step of 16);
  2. LN of the staged pixels inside the image (f32 statistics divided by
     c_real, one rounding to x's dtype); pixels outside stay 0;
  3. conv1 as the implicit GEMM over the (TH + 2) x 18 hidden pixels of
     the tile and its 1-pixel halo: for each tap, the staged tile's
     shifted window times the tap's [kp1, mid] block of the packed
     weights, read back from their fragment order as the kernel's lanes
     read them (tap_block); bias, exact GELU, 0 at the hidden pixels
     outside the image, one rounding;
  4. conv2 the same way over the hidden tile, in passes of NJ2 8-column
     fragments; bias, one rounding; the pixels inside the image stored.

`plant` takes the kernel's fault bits (ops/_build.PLANT_CAB_*): staged
pixels outside the image as LN(0) = ln bias, the hidden map not zeroed
outside the image, a 1-pixel halo (the staged tile's outer ring read as
zero), each output pixel stored at column x XOR 1 (kernel 12's fault:
the pixels of a pair swapped; at an even W, its only width)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops.hab import layer_norm

TW = 16   # the kernel's tile columns
NJ2 = 8   # conv2's 8-column fragments a pass


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def tap_block(packed: torch.Tensor, tap: int, j0: int = 0,
              nj: int | None = None) -> torch.Tensor:
    """The [kp, 8 nj] block of a packed conv kernel (ops/hab.
    pack_conv_mma: [9 kp / 16, N / 8, 32, 4]) that tap `tap` and 8-column
    fragments j0 .. j0 + nj multiply, in f32: lane 4 g + t of fragment
    (k-step ks, j) holds rows 16 ks + 2 t + e and 16 ks + 8 + 2 t + e
    (e = 0, 1) of column 8 j + g, the mma.sync B fragment."""
    ks_n = packed.shape[0] // 9
    nj = packed.shape[1] - j0 if nj is None else nj
    frag = packed[tap * ks_n:(tap + 1) * ks_n, j0:j0 + nj].float()
    # [ks, j, g, t, half, e] -> rows (ks, half, t, e), columns (j, g)
    return (frag.reshape(ks_n, nj, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2)
            .reshape(ks_n * 16, nj * 8))


def cab_tile_form(x: torch.Tensor, weights: list[torch.Tensor], *,
                  th: int = 8, c_real: int | None = None,
                  hidden: torch.Tensor | None = None,
                  plant: int = 0) -> torch.Tensor:
    """Kernel 7's tensor-core body on x [B,H,W,C] with weights packed by
    ops/hab.cab_mma_weights, tile by tile (th x 16 tiles); rounds to x's
    dtype where the kernel rounds to bf16. `hidden` [B,H,W,mid] receives
    the GELU map, as the kernel's does when given one."""
    ln_s, ln_b, k1, b1, _, b2, w1, w2 = weights
    bsz, h, w, c = x.shape
    mid = k1.shape[-1]
    kp1, kp2 = _up16(c), _up16(mid)
    blk1 = [tap_block(w1, tap) for tap in range(9)]
    passes = [(j0, min(NJ2, c // 8 - j0)) for j0 in range(0, c // 8, NJ2)]
    blk2 = [[tap_block(w2, tap, j0, nj) for tap in range(9)]
            for j0, nj in passes]
    out = torch.empty_like(x)
    for b in range(bsz):
        for y0 in range(0, h, th):
            for x0 in range(0, w, TW):
                tile, hid = _tile(x[b], y0, x0, th, c_real, plant, kp1, kp2,
                                  ln_s, ln_b, blk1, b1, blk2, passes, b2)
                ty, tx = min(th, h - y0), min(TW, w - x0)
                if plant & _build.PLANT_CAB_SWAP_PAIR:
                    tile = tile[:, torch.arange(TW) ^ 1]
                out[b, y0:y0 + ty, x0:x0 + tx] = tile[:ty, :tx]
                if hidden is not None:
                    hidden[b, y0:y0 + ty, x0:x0 + tx] = \
                        hid[1:1 + ty, 1:1 + tx, :mid]
    return out


def _inside(y0: int, x0: int, rows: int, cols: int, h: int,
            w: int) -> torch.Tensor:
    """[rows, cols] bool: pixel (y0 + i, x0 + j) lies in the image."""
    ys = torch.arange(y0, y0 + rows)
    xs = torch.arange(x0, x0 + cols)
    return (((ys >= 0) & (ys < h))[:, None]
            & ((xs >= 0) & (xs < w))[None, :])


def _tile(img, y0, x0, th, c_real, plant, kp1, kp2, ln_s, ln_b, blk1, b1,
          blk2, passes, b2):
    """One block's work: (output tile [th, 16, C], hidden tile [th + 2,
    18, kp2]), in img's dtype."""
    dt = img.dtype
    h, w, c = img.shape
    mid = b1.shape[0]
    xh, xw, hh, hw = th + 4, TW + 4, th + 2, TW + 2
    # 1. staged: x inside the image (not the outer ring under HALO1)
    on = _inside(y0 - 2, x0 - 2, xh, xw, h, w)
    if plant & _build.PLANT_CAB_HALO1:
        on[0], on[-1], on[:, 0], on[:, -1] = False, False, False, False
    pad = F.pad(img, (0, 0, 2, TW + 2, 2, th + 2))
    staged = pad[y0:y0 + xh, x0:x0 + xw].float()
    # 2. LN in place; 0 where nothing was staged (LN(0) under LN_BORDER)
    ln = layer_norm(staged.to(dt), ln_s, ln_b, c_real).float()
    keep = on | bool(plant & _build.PLANT_CAB_LN_BORDER)
    ln = torch.where(keep[..., None], ln, torch.zeros_like(ln))
    ln = F.pad(ln.to(dt).float(), (0, kp1 - c))
    # 3. conv1: the GEMM of the hidden pixels, one tap at a time
    acc = sum(ln[ky:ky + hh, kx:kx + hw].reshape(-1, kp1) @ blk1[3 * ky + kx]
              for ky in range(3) for kx in range(3))
    hid = F.gelu(acc + b1.float()).reshape(hh, hw, mid)
    if not plant & _build.PLANT_CAB_HID_BORDER:
        hid = torch.where(_inside(y0 - 1, x0 - 1, hh, hw, h, w)[..., None],
                          hid, torch.zeros_like(hid))
    hid = F.pad(hid.to(dt).float(), (0, kp2 - mid))
    # 4. conv2 in passes of NJ2 fragments
    cols = []
    for (j0, nj), blks in zip(passes, blk2):
        acc = sum(hid[ky:ky + th, kx:kx + TW].reshape(-1, kp2)
                  @ blks[3 * ky + kx] for ky in range(3) for kx in range(3))
        cols.append(acc + b2[8 * j0:8 * (j0 + nj)].float())
    return torch.cat(cols, -1).reshape(th, TW, c).to(dt), hid.to(dt)
