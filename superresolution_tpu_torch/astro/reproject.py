"""WCS-to-WCS bilinear reprojection (the hot op of ETL steps 1 and 3;
the reference uses the `reproject` package's reproject_interp,
scripts/Dataset_step1_datasetwcs.py:262, Dataset_step3:253-258).

Fully vectorized numpy: compute the sky position of every target pixel,
invert through the source WCS, bilinear-sample, NaN outside coverage. Also
returns a footprint mask like reproject_interp.

The port's own copy of superresolution_tpu/astro/reproject.py, line for
line (plain numpy on the host; the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import numpy as np

from superresolution_tpu_torch.astro.wcs import TanWCS


def reproject_bilinear(src: np.ndarray, src_wcs: TanWCS, dst_wcs: TanWCS,
                       dst_shape: tuple[int, int]):
    """Returns (resampled [H,W] float64 with NaN outside, footprint [H,W])."""
    h, w = dst_shape
    yy, xx = np.mgrid[0:h, 0:w]
    ra, dec = dst_wcs.pixel_to_world(xx, yy)
    sx, sy = src_wcs.world_to_pixel(ra, dec)

    sh, sw = src.shape
    eps = 1e-6  # tolerate round-trip float jitter at the exact border
    inside = ((sx >= -eps) & (sx <= sw - 1 + eps)
              & (sy >= -eps) & (sy <= sh - 1 + eps))
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, sw - 2)
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, sh - 2)
    fx = np.clip(sx - x0, 0.0, 1.0)
    fy = np.clip(sy - y0, 0.0, 1.0)
    s = np.asarray(src, np.float64)
    v00 = s[y0, x0]
    v01 = s[y0, x0 + 1]
    v10 = s[y0 + 1, x0]
    v11 = s[y0 + 1, x0 + 1]
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    out = np.where(inside, out, np.nan)
    return out, inside.astype(np.float64)
