"""The reference's tilers and the numbers a comparison reads."""

from __future__ import annotations

import torch


def tiled(fn, img: torch.Tensor, scale: int, tile, halo: int, batch: int
          ) -> torch.Tensor:
    """Overlap-halo tiled inference of an HWC image: the image edge-padded
    (index clamped) by `halo`, cut into a grid of (th, tw) tiles each
    with its halo, `fn` run over `batch` tiles at a time, each tile's
    halo cropped from its x`scale` output and the tiles placed back."""
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    h, w, _ = img.shape
    ny, nx = -(-h // th), -(-w // tw)
    dev = img.device
    rows = torch.arange(-halo, ny * th + halo, device=dev).clamp(0, h - 1)
    cols = torch.arange(-halo, nx * tw + halo, device=dev).clamp(0, w - 1)
    padded = img[rows][:, cols]
    coords = [(iy * th, ix * tw) for iy in range(ny) for ix in range(nx)]
    hs = halo * scale
    out = None
    for s in range(0, len(coords), batch):
        part = coords[s:s + batch]
        o = fn(torch.stack([padded[y:y + th + 2 * halo, x:x + tw + 2 * halo]
                            for y, x in part]))
        if out is None:
            out = o.new_empty((ny * th * scale, nx * tw * scale, o.shape[-1]))
        for t, (y, x) in enumerate(part):
            out[y * scale:(y + th) * scale, x * scale:(x + tw) * scale] = \
                o[t, hs:hs + th * scale, hs:hs + tw * scale]
    return out[:h * scale, :w * scale]


def image_gap(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """rms_err: the RMS of out - ref, and max_err: the largest
    |out - ref|, both in the image's own units (the outputs are images
    in about [0, 1]; weights.py gives the random models a trained
    model's range and contrast there)."""
    d = out.float() - ref.float()
    return {"rms_err": float(d.square().mean().sqrt()),
            "max_err": float(d.abs().max())}


def worst(gaps: list) -> dict:
    return {k: max(g[k] for g in gaps) for k in gaps[0]}
