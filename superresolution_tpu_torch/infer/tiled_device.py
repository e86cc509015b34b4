"""On-device overlap-halo tiled inference.

Counterpart of superresolution_tpu/infer/tiled_device.py:
  * make_tiled_infer / upscale_on_device: edge-pad the image, gather the
    static tile grid, run the network over fixed-size tile batches, crop
    each tile's halo and reassemble;
  * make_tiled_infer_staged: the same for trunk/tail-split models, the
    LR trunk over `trunk_batch` tiles at a time (default: all), the
    x`scale` tail in `tail_batch` chunks; with `mesh` (parallel/mesh.py)
    the tiles are spread over its data ranks, each running trunk and
    tail on its share, and one all_gather reassembles the image on every
    rank (the reference's tile-parallel multi-chip inference).
Everything stays on the device, and the output too. Eager PyTorch needs
no jit, so each batch's cropped tiles are written straight into the
output image instead of stacking all outputs first; the result is the
same. Crop is the only blend (exact away from the border for a
shift-invariant net whose half receptive field is at most `halo`).
"""

from __future__ import annotations

import math

import torch

from superresolution_tpu_torch.infer.tiled import model_fn
from superresolution_tpu_torch.runtime import resolve_device
from superresolution_tpu_torch.utils.profiling import span


def _edge_index(halo: int, n: int, size: int, device) -> torch.Tensor:
    """Edge padding as a gather: padded index r reads clamp(r - halo)."""
    return torch.arange(-halo, n + halo, device=device).clamp(0, size - 1)


def make_tiled_infer(fn, scale: int, tile: int, halo: int, batch: int,
                     h: int, w: int, channels: int,
                     device: str | torch.device | None = None):
    """-> run(img [h, w, channels] on the device) -> [h*scale, w*scale,
    C'] on the device. fn maps [batch, tile+2*halo, tile+2*halo,
    channels] to its x`scale` upscale; it runs ceil(ntiles/batch) times,
    the last batch filled up with copies of the first tile, as the
    reference's static grid does."""
    dev = resolve_device(device)
    ny, nx = -(-h // tile), -(-w // tile)
    n = ny * nx
    n_run = n + (-n) % batch
    t_in, ts, hs = tile + 2 * halo, tile * scale, halo * scale
    coords = ([(iy * tile, ix * tile) for iy in range(ny) for ix in range(nx)]
              + [(0, 0)] * (n_run - n))
    rows = _edge_index(halo, ny * tile, h, dev)
    cols = _edge_index(halo, nx * tile, w, dev)

    @torch.inference_mode()
    def run(img) -> torch.Tensor:
        with span("tiler"):
            img = torch.as_tensor(img, device=dev)
            if tuple(img.shape) != (h, w, channels):
                raise ValueError(
                    f"image {tuple(img.shape)} != {(h, w, channels)}")
            with span("tiler.gather"):
                padded = img[rows][:, cols]
                tiles = torch.stack([padded[y:y + t_in, x:x + t_in]
                                     for y, x in coords])
            out = None
            for s in range(0, n, batch):
                o = fn(tiles[s:s + batch])
                with span("tiler.scatter"):
                    if out is None:
                        out = o.new_empty((ny * ts, nx * ts, o.shape[-1]))
                    for t in range(min(batch, n - s)):
                        iy, ix = divmod(s + t, nx)
                        out[iy * ts:(iy + 1) * ts, ix * ts:(ix + 1) * ts] = \
                            o[t, hs:hs + ts, hs:hs + ts]
            return out[:h * scale, :w * scale]

    return run


def upscale_on_device(img, scale: int, model, params, tile: int = 256,
                      halo: int = 16, batch: int = 8,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device | None = None
                      ) -> torch.Tensor:
    """Device-resident tiled SR of one HWC image: `model` (an nn.Module,
    or a PreboundModel whose own weights are used) with the weights of
    the state dict `params` in compute_dtype, the output clipped to
    [0, 1] in f32 and left on the device."""
    h, w, c = img.shape
    fn = model_fn(model, params, compute_dtype, device)
    return make_tiled_infer(fn, scale, tile, halo, batch, h, w, c,
                            device)(img)


def make_tiled_infer_staged(trunk_fn, tail_fn, scale: int, tile, halo: int,
                            tail_batch: int, h: int, w: int, channels: int,
                            trunk_batch: int | None = None,
                            split_stages: bool = False, mesh=None,
                            device: str | torch.device | None = None):
    """-> run(img [h, w, channels]) -> [h*scale, w*scale, out].

    `tile` is an int or an (th, tw) pair. trunk_fn maps
    [B, th+2*halo, tw+2*halo, channels] to LR features of the same
    spatial size; tail_fn maps tail_batch such feature tiles to x`scale`.
    With split_stages=True, returns (run_trunk, run_tail) instead, for
    per-stage timing. With `mesh`, the tile count is padded (with copies
    of the first tile) so that the tail chunks and the data ranks divide
    it, and with an explicit trunk_batch to the common multiple of that
    and the trunk chunk, as the reference pads it (tiled_device.py:88-107
    there); each data rank runs its contiguous share of the tiles through
    the trunk (in chunks of trunk_batch / ndata) and the tail, and the
    image is reassembled on every rank from one all_gather."""
    dev = resolve_device(device)
    th_t, tw_t = (tile, tile) if isinstance(tile, int) else tile
    ny, nx = -(-h // th_t), -(-w // tw_t)
    n = ny * nx
    ti_h, ti_w = th_t + 2 * halo, tw_t + 2 * halo
    ts_h, ts_w = th_t * scale, tw_t * scale
    hs = halo * scale
    nd = mesh.shape["data"] if mesh is not None else 1
    if mesh is not None:
        mult = tail_batch * nd
        n_pad_tail = (-n) % mult
        kb = trunk_batch or n + n_pad_tail
        n_pad = max(n_pad_tail, (-n) % kb)
        if trunk_batch:
            n_pad = (-n) % math.lcm(kb, mult)
        n_run = n + n_pad
        share = n_run // nd
        r = mesh.coord("data")
        mine = range(r * share, (r + 1) * share)
        kb_local = max(1, -(-kb // nd))
    else:
        kb = trunk_batch or n
        n_run = n + (-n) % kb
        mine, kb_local = range(n_run), kb
    coords = ([(iy * th_t, ix * tw_t) for iy in range(ny) for ix in range(nx)]
              + [(0, 0)] * (n_run - n))
    rows = _edge_index(halo, ny * th_t, h, dev)
    cols = _edge_index(halo, nx * tw_t, w, dev)

    @torch.inference_mode()
    def run_trunk(img) -> torch.Tensor:
        img = torch.as_tensor(img, device=dev)
        if tuple(img.shape) != (h, w, channels):
            raise ValueError(f"image {tuple(img.shape)} != {(h, w, channels)}")
        with span("tiler.gather"):
            padded = img[rows][:, cols]
            tiles = torch.stack([padded[y:y + ti_h, x:x + ti_w]
                                 for y, x in (coords[i] for i in mine)])
        feats = torch.cat([trunk_fn(t) for t in tiles.split(kb_local)])
        return feats if mesh is not None else feats[:n]

    def place(out, t, o):
        iy, ix = divmod(t, nx)
        out[iy * ts_h:(iy + 1) * ts_h, ix * ts_w:(ix + 1) * ts_w] = o

    @torch.inference_mode()
    def run_tail(feats: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            # this rank's tiles, cropped, then every rank's in tile order
            crops = torch.cat([tail_fn(c)[:, hs:hs + ts_h, hs:hs + ts_w]
                               for c in feats.split(tail_batch)])
            from superresolution_tpu_torch.parallel.mesh import all_gather

            crops = torch.cat(all_gather(crops, mesh.group("data")))
            with span("tiler.scatter"):
                out = crops.new_empty((ny * ts_h, nx * ts_w,
                                       crops.shape[-1]))
                for t in range(n):
                    place(out, t, crops[t])
            return out[:h * scale, :w * scale]
        out = None
        for s in range(0, n, tail_batch):
            chunk = feats[s:s + tail_batch]
            k = chunk.shape[0]
            if k < tail_batch:
                with span("tiler.scatter"):
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (tail_batch - k, *chunk.shape[1:]))])
            o = tail_fn(chunk)
            with span("tiler.scatter"):
                if out is None:
                    out = o.new_empty((ny * ts_h, nx * ts_w, o.shape[-1]))
                for t in range(k):
                    place(out, s + t, o[t, hs:hs + ts_h, hs:hs + ts_w])
        return out[:h * scale, :w * scale]

    if split_stages:
        return run_trunk, run_tail

    def run(img) -> torch.Tensor:
        with span("tiler"):
            return run_tail(run_trunk(img))

    return run
