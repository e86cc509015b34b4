"""Astronomy ETL (host-side, offline): FITS I/O, TAN WCS, reprojection,
plate-solve adapter, and the 4-step dataset pipeline of the reference
(solve/register -> QC mosaic -> WCS-aligned patch extraction -> log-stretch
normalization). Pure numpy (+ optional matplotlib for QC), without
astropy: the needed subset — FITS primary-HDU images and
celestial TAN projections — is implemented here from the standards
(FITS 4.0, WCS Paper II).

The port's own copy of superresolution_tpu/astro/, line for line (plain
numpy on the host; the port imports nothing of the JAX package).
"""

from superresolution_tpu_torch.astro.fits import read_fits, write_fits  # noqa: F401
from superresolution_tpu_torch.astro.wcs import TanWCS, create_aligned_lr_wcs  # noqa: F401
from superresolution_tpu_torch.astro.reproject import reproject_bilinear  # noqa: F401
