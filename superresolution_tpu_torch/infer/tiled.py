"""Overlap-halo tiled inference with the image on the host.

Counterpart of superresolution_tpu/infer/tiled.py: the image is cut into
a static grid of `tile`-sized blocks, each padded by `halo` pixels of real
neighbouring context (edge-replicated or zero at the image border); the
network runs on fixed-shape batches of padded blocks (the ragged tail is
zero-padded to `batch`), each batch moving to the device and back; the
halo is cropped from each upscaled block before reassembly ('crop'), or
the blocks are blended with raised-cosine weights over their overlap
('hann'). Crop is exact away from the image border for a shift-invariant
net whose half receptive field is at most `halo`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import functional_call

from superresolution_tpu_torch.infer.common import PreboundModel, state_tensors
from superresolution_tpu_torch.runtime import resolve_device
from superresolution_tpu_torch.utils.precision import get_policy


def _pad(img: np.ndarray, top: int, bottom: int, left: int, right: int,
         mode: str) -> np.ndarray:
    kw = {"mode": "edge"} if mode == "edge" else {"mode": "constant"}
    return np.pad(img, ((top, bottom), (left, right), (0, 0)), **kw)


def tiled_apply(fn, img, scale: int, tile: int = 256, halo: int = 16,
                batch: int = 8, blend: str = "crop", pad_mode: str = "edge",
                device: str | torch.device | None = None) -> np.ndarray:
    """Apply `fn` ([N,h,w,C] tensor -> [N,h*scale,w*scale,C']) to the HWC
    (or HW) numpy image `img` tile-wise; returns f32 numpy.

    fn is called ceil(ntiles/batch) times, always on a [batch,
    tile+2*halo, tile+2*halo, C] tensor on `device` (default cuda).
    pad_mode: 'edge' or 'zero'; blend: 'crop' or 'hann'."""
    if blend not in ("crop", "hann"):
        raise ValueError(f"unknown blend mode {blend!r}")
    dev = resolve_device(device)
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    ny, nx = -(-h // tile), -(-w // tile)
    ph, pw = ny * tile - h, nx * tile - w
    padded = _pad(img, halo, ph + halo, halo, pw + halo, pad_mode)

    t_in = tile + 2 * halo
    tiles = np.empty((ny * nx, t_in, t_in, c), img.dtype)
    for iy in range(ny):
        for ix in range(nx):
            y0, x0 = iy * tile, ix * tile
            tiles[iy * nx + ix] = padded[y0:y0 + t_in, x0:x0 + t_in]

    n = tiles.shape[0]
    outs = None
    for i in range(0, n, batch):
        chunk = tiles[i:i + batch]
        if chunk.shape[0] < batch:
            chunk = np.concatenate(
                [chunk, np.zeros((batch - chunk.shape[0], *chunk.shape[1:]),
                                 chunk.dtype)])
        res = fn(torch.from_numpy(chunk).to(dev)).float().cpu().numpy()
        if outs is None:
            outs = np.empty((n, *res.shape[1:]), np.float32)
        outs[i:i + batch] = res[: min(batch, n - i)]

    co = outs.shape[-1]
    hs, ts, os_ = halo * scale, tile * scale, (tile + 2 * halo) * scale
    if blend == "crop":
        out = np.empty((ny * ts, nx * ts, co), np.float32)
        for iy in range(ny):
            for ix in range(nx):
                o = outs[iy * nx + ix]
                out[iy * ts:(iy + 1) * ts, ix * ts:(ix + 1) * ts] = \
                    o[hs:hs + ts, hs:hs + ts]
    else:
        # crop the outer half-halo, then raised-cosine overlap-add over
        # the remaining halo-wide overlap; sin^2 + cos^2 = 1 across each
        # seam, so tiles that agree blend exactly
        m = hs // 2
        span = os_ - 2 * m  # ts + hs
        ramp = np.ones(span, np.float64)
        if hs:
            r = np.sin(np.linspace(0, math.pi / 2, hs, endpoint=False)) ** 2
            ramp[:hs] = r
            ramp[-hs:] = r[::-1]
        wgt = np.outer(ramp, ramp)[..., None]
        acc = np.zeros(((ny * tile + 2 * halo) * scale,
                        (nx * tile + 2 * halo) * scale, co), np.float64)
        den = np.zeros_like(acc)
        for iy in range(ny):
            for ix in range(nx):
                y0, x0 = iy * ts + m, ix * ts + m
                o = outs[iy * nx + ix][m:os_ - m, m:os_ - m]
                acc[y0:y0 + span, x0:x0 + span] += o * wgt
                den[y0:y0 + span, x0:x0 + span] += wgt
        out = (acc / np.maximum(den, 1e-12))[hs:hs + ny * ts,
                                             hs:hs + nx * ts].astype(np.float32)
    out = out[: h * scale, : w * scale]
    return out[..., 0] if squeeze else out


def _default_model_params(img, scale, model, params, device=None,
                          **model_kwargs):
    """Resolve (model, params): `model` may be an nn.Module, a registry
    name, or None ('rrdbnet'), built on `device`; params None -> the
    model's own random initialization (smoke tests and benchmarks
    only)."""
    from superresolution_tpu_torch.models.factory import get_model

    c = 1 if np.ndim(img) == 2 else np.shape(img)[-1]
    if model is None or isinstance(model, str):
        model = get_model(model or "rrdbnet", scale=scale, in_channels=c,
                          out_channels=c, device=device, **model_kwargs)
    if params is None and not isinstance(model, PreboundModel):
        params = model.state_dict()
    return model, params


def model_fn(model, params, compute_dtype: torch.dtype,
             device: str | torch.device | None = None):
    """-> fn(x) = clip(model(x) with the weights of the state dict
    `params` cast to compute_dtype, 0, 1) in f32. x goes to the device in
    compute_dtype; `model` itself is not modified. A PreboundModel
    carries its own weights: `params` is ignored."""
    dev = resolve_device(device)
    if isinstance(model, PreboundModel):
        @torch.inference_mode()
        def prebound(x: torch.Tensor) -> torch.Tensor:
            out = model.apply(params, x.to(dev, compute_dtype))
            return out.float().clamp(0.0, 1.0)

        return prebound
    p = {k: v.to(compute_dtype) if v.is_floating_point() else v
         for k, v in state_tensors(params, dev).items()}

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        out = functional_call(model, p, (x.to(dev, compute_dtype),))
        return out.float().clamp(0.0, 1.0)

    return fn


def upscale(img, scale: int = 4, *, model=None, params=None,
            tile: int = 256, halo: int = 16, batch: int = 8,
            blend: str = "crop", pad_mode: str = "edge",
            precision: str = "bf16", device: str | torch.device | None = None,
            **model_kwargs) -> np.ndarray:
    """Public API: super-resolve an HWC (or HW) image in [0,1] by `scale`
    with the host tiler; returns f32 numpy, clipped to [0, 1].

    `model` may be an nn.Module (the port's), a registry name, or None
    ('rrdbnet'); `params` its state dict (None: the model's random
    initialization, for smoke tests only), cast to the precision
    policy's compute type. Runs on `device` (default cuda)."""
    model, params = _default_model_params(img, scale, model, params,
                                          device=device, **model_kwargs)
    fn = model_fn(model, params, get_policy(precision).compute_dtype,
                  device)
    return tiled_apply(fn, img, scale, tile=tile, halo=halo, batch=batch,
                       blend=blend, pad_mode=pad_mode, device=device)
