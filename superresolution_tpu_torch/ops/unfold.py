"""Overlapping-window (unfold) extraction for the OCAB key/value gather.

Counterpart of superresolution_tpu/ops/unfold.py: for every ws-strided
query window, the enlarged ows x ows patch of the padded key/value map
around it, token-ordered row-major (token = di*ows + dj). Two
Tensor.unfold views and one copy. Kernel 9 (ops/flash_oca.py) reads the
same patches straight from the map; this gather is its plain version's.
"""

from __future__ import annotations

import torch


def extract_overlapping_windows(kv: torch.Tensor, ws: int, ows: int,
                                nh_w: int, nw_w: int) -> torch.Tensor:
    """kv [B, H + (ows-ws), W + (ows-ws), C] -> [B*nh_w*nw_w, ows*ows, C]."""
    b, _, _, c = kv.shape
    p = kv.unfold(1, ows, ws).unfold(2, ows, ws)  # [B, nh, nw, C, di, dj]
    p = p[:, :nh_w, :nw_w].permute(0, 1, 2, 4, 5, 3)
    return p.reshape(b * nh_w * nw_w, ows * ows, c)
