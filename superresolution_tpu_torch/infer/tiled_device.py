"""On-device overlap-halo tiled inference for trunk/tail-split models.

Counterpart of superresolution_tpu/infer/tiled_device.py
(make_tiled_infer_staged without `mesh`): edge-pad the image, gather the
static tile grid, run the LR trunk over `trunk_batch` tiles at a time
(default: all), run the x`scale` tail in `tail_batch` chunks, crop each
tile's halo and reassemble. Everything stays on the device. Eager
PyTorch needs no jit, so each tail chunk's cropped tiles are written
straight into the output image instead of stacking all tail outputs
first; the result is the same.
"""

from __future__ import annotations

import torch

from superresolution_tpu_torch.runtime import resolve_device


def make_tiled_infer_staged(trunk_fn, tail_fn, scale: int, tile, halo: int,
                            tail_batch: int, h: int, w: int, channels: int,
                            trunk_batch: int | None = None,
                            split_stages: bool = False,
                            device: str | torch.device | None = None):
    """-> run(img [h, w, channels]) -> [h*scale, w*scale, out].

    `tile` is an int or an (th, tw) pair. trunk_fn maps
    [B, th+2*halo, tw+2*halo, channels] to LR features of the same
    spatial size; tail_fn maps tail_batch such feature tiles to x`scale`.
    With split_stages=True, returns (run_trunk, run_tail) instead, for
    per-stage timing."""
    dev = resolve_device(device)
    th_t, tw_t = (tile, tile) if isinstance(tile, int) else tile
    ny, nx = -(-h // th_t), -(-w // tw_t)
    n = ny * nx
    ti_h, ti_w = th_t + 2 * halo, tw_t + 2 * halo
    ts_h, ts_w = th_t * scale, tw_t * scale
    hs = halo * scale
    kb = trunk_batch or n
    n_run = n + (-n) % kb
    coords = ([(iy * th_t, ix * tw_t) for iy in range(ny) for ix in range(nx)]
              + [(0, 0)] * (n_run - n))
    # edge padding as a gather: padded row r is image row clamp(r - halo)
    rows = torch.arange(-halo, ny * th_t + halo, device=dev).clamp(0, h - 1)
    cols = torch.arange(-halo, nx * tw_t + halo, device=dev).clamp(0, w - 1)

    @torch.inference_mode()
    def run_trunk(img) -> torch.Tensor:
        img = torch.as_tensor(img, device=dev)
        if tuple(img.shape) != (h, w, channels):
            raise ValueError(f"image {tuple(img.shape)} != {(h, w, channels)}")
        padded = img[rows][:, cols]
        tiles = torch.stack([padded[y:y + ti_h, x:x + ti_w]
                             for y, x in coords])
        feats = torch.cat([trunk_fn(t) for t in tiles.split(kb)])
        return feats[:n]

    @torch.inference_mode()
    def run_tail(feats: torch.Tensor) -> torch.Tensor:
        out = None
        for s in range(0, n, tail_batch):
            chunk = feats[s:s + tail_batch]
            k = chunk.shape[0]
            if k < tail_batch:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (tail_batch - k, *chunk.shape[1:]))])
            o = tail_fn(chunk)
            if out is None:
                out = o.new_empty((ny * ts_h, nx * ts_w, o.shape[-1]))
            for t in range(k):
                iy, ix = divmod(s + t, nx)
                out[iy * ts_h:(iy + 1) * ts_h, ix * ts_w:(ix + 1) * ts_w] = \
                    o[t, hs:hs + ts_h, hs:hs + ts_w]
        return out[:h * scale, :w * scale]

    if split_stages:
        return run_trunk, run_tail

    def run(img) -> torch.Tensor:
        return run_tail(run_trunk(img))

    return run
