"""Literature-convention SR benchmark evaluation (Set5/Set14/DIV2K).

Counterpart of superresolution_tpu/metrics/benchmark_eval.py. Published
SR numbers (SRCNN/EDSR/ESRGAN papers) are computed on the Y channel of
YCbCr (ITU-R BT.601, digital), after shaving a `scale`-pixel border;
the reference's own metrics (metrics/psnr_ssim.py) are full-image. The
metrics run on torch tensors on the host, in f32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from superresolution_tpu_torch.metrics.psnr_ssim import psnr, ssim


def rgb_to_y(img: torch.Tensor) -> torch.Tensor:
    """HWC or NHWC RGB in [0,1] -> Y (luma) in [0,1], BT.601 digital:
    Y_255 = 16 + (65.481 R + 128.553 G + 24.966 B). Single-channel input
    passes through unchanged."""
    if img.shape[-1] == 1:
        return img
    r, g, b = img[..., 0:1], img[..., 1:2], img[..., 2:3]
    return (16.0 + 65.481 * r + 128.553 * g + 24.966 * b) / 255.0


def shave(img: torch.Tensor, border: int) -> torch.Tensor:
    """Drop a `border`-pixel frame of an [..., H, W, C] image."""
    if border <= 0:
        return img
    return img[..., border:-border, border:-border, :]


def sr_metrics(pred, target, scale: int,
               y_channel: bool = True) -> dict[str, float]:
    """Per-image-pair PSNR/SSIM with the standard convention: Y channel,
    shave `scale` border. Inputs NHWC (or HWC) in [0,1], tensors or
    arrays."""
    p, t = (torch.as_tensor(a).float().cpu() for a in (pred, target))
    if p.ndim == 3:
        p, t = p[None], t[None]
    if y_channel:
        p, t = rgb_to_y(p), rgb_to_y(t)
    p, t = shave(p, scale), shave(t, scale)
    return {"psnr": float(psnr(p, t).mean()),
            "ssim": float(ssim(p, t).mean())}


def evaluate_folder(upscale_fn, hr_dir: str, scale: int,
                    y_channel: bool = True,
                    degrade: bool = True) -> dict[str, float]:
    """Benchmark `upscale_fn(lr_hwc) -> sr_hwc` over every image in
    `hr_dir` (Set5-style: HR images; LR synthesized by MATLAB-convention
    bicubic). Images are center-cropped to a multiple of `scale`."""
    from superresolution_tpu_torch.data.io import load_image
    from superresolution_tpu_torch.ops.degradation import degrade_bicubic

    psnrs, ssims = [], []
    names = sorted(f for f in os.listdir(hr_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp",
                                          ".tif", ".tiff")))
    if not names:
        raise FileNotFoundError(f"no images in {hr_dir}")
    for name in names:
        hr = load_image(os.path.join(hr_dir, name))
        h, w = (hr.shape[0] // scale) * scale, (hr.shape[1] // scale) * scale
        y0 = (hr.shape[0] - h) // 2  # center crop (the standard
        x0 = (hr.shape[1] - w) // 2  # benchmark convention)
        hr = hr[y0:y0 + h, x0:x0 + w]
        lr = degrade_bicubic(torch.from_numpy(hr), scale).numpy() \
            if degrade else hr
        m = sr_metrics(upscale_fn(lr), hr, scale, y_channel)
        psnrs.append(m["psnr"])
        ssims.append(m["ssim"])
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            "n": len(psnrs)}
