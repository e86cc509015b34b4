"""Test harness: a trained model over its test split.

Counterpart of superresolution_tpu/infer/evaluate.py:21-55 (the
re-design of the reference's scripts/Modello_5.py:71-91): the trainer's
eval step over every test pair, PSNR/SSIM accumulated in f32 and
written to metrics.txt, one result file per image (a 16-bit TIFF for one
channel, else a PNG) and an [LR-nearest | SR | HR] comparison strip,
framed and labelled with `labeled`.
"""

from __future__ import annotations

import os

import numpy as np

from superresolution_tpu_torch.data.io import save_png, save_tiff16
from superresolution_tpu_torch.data.loader import Loader, prefetch_to_device
from superresolution_tpu_torch.metrics.psnr_ssim import Metrics
from superresolution_tpu_torch.ops.resize import resize_nearest
from superresolution_tpu_torch.utils.collage import frame_and_label_collage


def run_test(trainer, out_dir: str | None = None,
             save_outputs: bool = True, labeled: bool = False) -> dict:
    """Evaluate `trainer`'s current params on its test split (its
    test_ds: the test manifest, else the validation set); returns
    {'psnr', 'ssim'}."""
    from superresolution_tpu_torch.train.trainer import _step_generator

    out_dir = out_dir or os.path.join(trainer.workdir, "test_results")
    os.makedirs(out_dir, exist_ok=True)
    m = Metrics()
    loader = Loader(trainer.test_ds, 1, shuffle=False, num_workers=2)
    for i, batch in enumerate(prefetch_to_device(loader,
                                                 device=trainer.device)):
        out = trainer._eval_step(
            trainer.state, batch,
            _step_generator(trainer.cfg.train.seed, 2**29 + i))
        m.update_sums(float(out["psnr_sum"]), float(out["ssim_sum"]),
                      float(out["n"]))
        if not save_outputs:
            continue
        sr = out["pred"][0].cpu().numpy()
        hr0 = out["hr"][0].cpu().numpy()
        if sr.shape[-1] == 1:
            save_tiff16(sr, os.path.join(out_dir, f"result_{i:04d}.tiff"))
        else:
            save_png(sr, os.path.join(out_dir, f"result_{i:04d}.png"))
        lr_up = resize_nearest(out["lr"][0].float(), hr0.shape[:2])
        strip = np.concatenate([lr_up.cpu().numpy(), sr, hr0], axis=1)
        spath = os.path.join(out_dir, f"comparison_{i:04d}.png")
        if labeled:
            frame_and_label_collage(strip, spath,
                                    labels=("Input", "Result", "Target"))
        else:
            save_png(strip, spath)
    result = m.compute()
    with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
        f.write(f"PSNR: {result['psnr']:.4f} dB\nSSIM: {result['ssim']:.6f}\n")
    return result
