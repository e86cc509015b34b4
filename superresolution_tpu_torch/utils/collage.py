"""Labeled comparison collage — capability parity with reference
scripts/ShowResult.py:10-110 (white border, per-panel header labels,
cross-platform font lookup).

The port's own copy of superresolution_tpu/utils/collage.py (PIL and
numpy only): the same canvas, font lookup and label placement, so the
files come out byte-equal."""

from __future__ import annotations

import os

import numpy as np
from PIL import Image, ImageDraw, ImageFont

_FONT_CANDIDATES = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/liberation/LiberationSans-Bold.ttf",
    "/System/Library/Fonts/Helvetica.ttc",
    "C:/Windows/Fonts/arialbd.ttf",
]


def get_best_font(size: int = 28):
    for path in _FONT_CANDIDATES:
        if os.path.exists(path):
            try:
                return ImageFont.truetype(path, size)
            except Exception:
                continue
    return ImageFont.load_default()


def frame_and_label_collage(strip: np.ndarray, out_path: str,
                            labels=("Input", "Result", "Target"),
                            border: int = 12, header: int = 48,
                            panel_widths=None) -> str:
    """strip: HWC float [0,1], horizontally concatenated panels. Adds a
    white frame and a header row with one label per panel. panel_widths
    gives each panel's pixel width (panels need not be equal — an LR
    input is scale-x narrower than the SR result); defaults to equal
    splits."""
    a = np.asarray(strip, dtype=np.float64)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    img8 = (np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8)
    h, w, _ = img8.shape
    canvas = Image.new("RGB", (w + 2 * border, h + header + 2 * border),
                       "white")
    canvas.paste(Image.fromarray(img8), (border, header + border))
    draw = ImageDraw.Draw(canvas)
    font = get_best_font()
    if panel_widths is None:
        panel_widths = [w // len(labels)] * len(labels)
    x0 = 0
    for label, pw in zip(labels, panel_widths):
        bbox = draw.textbbox((0, 0), label, font=font)
        tw = bbox[2] - bbox[0]
        x = border + x0 + (pw - tw) // 2
        draw.text((x, border // 2 + 4), label, fill="black", font=font)
        x0 += pw
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    canvas.save(out_path)
    return out_path
