"""Celestial TAN (gnomonic) WCS: header parsing, pixel<->sky transforms,
and the LR/HR aligned-WCS derivation invariant.

Implements the subset of FITS WCS (Paper II) the reference pipeline uses:
CRVALi/CRPIXi + CD matrix (or CDELTi/CROTA2), CTYPE '---TAN'. The key
invariant re-created from the reference (reference:
scripts/Dataset_step3_extractpatches.py:195-219): the LR patch WCS is
DERIVED from the HR patch WCS by scaling the CD matrix by `factor` and
moving CRPIX so CRVAL and rotation are preserved and the LR footprint
covers exactly the HR footprint.

The port's own copy of superresolution_tpu/astro/wcs.py, line for line
(plain numpy on the host; the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

_D2R = np.pi / 180.0


@dataclass(frozen=True)
class TanWCS:
    crval: tuple[float, float]  # (ra, dec) deg
    crpix: tuple[float, float]  # 1-based FITS pixel coords (x, y)
    cd: tuple[tuple[float, float], tuple[float, float]]  # deg/pixel

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_header(h: dict) -> "TanWCS | None":
        ctype1 = str(h.get("CTYPE1", ""))
        if "TAN" not in ctype1.upper():
            return None
        # a CTYPE placeholder without the numeric cards (partially
        # written header) is "no WCS", not an exception
        if any(k not in h for k in
               ("CRVAL1", "CRVAL2", "CRPIX1", "CRPIX2")):
            return None
        if "CD1_1" not in h and ("CDELT1" not in h or "CDELT2" not in h):
            return None
        crval = (float(h["CRVAL1"]), float(h["CRVAL2"]))
        crpix = (float(h["CRPIX1"]), float(h["CRPIX2"]))
        if "CD1_1" in h:
            cd = ((float(h["CD1_1"]), float(h.get("CD1_2", 0.0))),
                  (float(h.get("CD2_1", 0.0)), float(h["CD2_2"])))
        else:
            cdelt1 = float(h["CDELT1"])
            cdelt2 = float(h["CDELT2"])
            rot = float(h.get("CROTA2", 0.0)) * _D2R
            cd = ((cdelt1 * np.cos(rot), -cdelt2 * np.sin(rot)),
                  (cdelt1 * np.sin(rot), cdelt2 * np.cos(rot)))
        return TanWCS(crval, crpix, cd)

    def to_header(self) -> dict:
        return {
            "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN",
            "CRVAL1": self.crval[0], "CRVAL2": self.crval[1],
            "CRPIX1": self.crpix[0], "CRPIX2": self.crpix[1],
            "CD1_1": self.cd[0][0], "CD1_2": self.cd[0][1],
            "CD2_1": self.cd[1][0], "CD2_2": self.cd[1][1],
        }

    # -- transforms (vectorized; x, y are 0-based numpy pixel coords) ------
    def pixel_to_world(self, x, y):
        """0-based pixel coords -> (ra, dec) in degrees."""
        cd = np.asarray(self.cd)
        dx = np.asarray(x, np.float64) + 1.0 - self.crpix[0]
        dy = np.asarray(y, np.float64) + 1.0 - self.crpix[1]
        xi = (cd[0, 0] * dx + cd[0, 1] * dy) * _D2R
        eta = (cd[1, 0] * dx + cd[1, 1] * dy) * _D2R
        ra0 = self.crval[0] * _D2R
        dec0 = self.crval[1] * _D2R
        denom = np.cos(dec0) - eta * np.sin(dec0)
        ra = ra0 + np.arctan2(xi, denom)
        dec = np.arctan((np.sin(dec0) + eta * np.cos(dec0))
                        / np.sqrt(xi**2 + denom**2))
        return (np.mod(ra / _D2R, 360.0), dec / _D2R)

    def world_to_pixel(self, ra, dec):
        """(ra, dec) deg -> 0-based pixel coords (x, y)."""
        ra = np.asarray(ra, np.float64) * _D2R
        dec = np.asarray(dec, np.float64) * _D2R
        ra0 = self.crval[0] * _D2R
        dec0 = self.crval[1] * _D2R
        dra = ra - ra0
        denom = np.sin(dec) * np.sin(dec0) + np.cos(dec) * np.cos(dec0) * np.cos(dra)
        xi = np.cos(dec) * np.sin(dra) / denom / _D2R
        eta = (np.sin(dec) * np.cos(dec0)
               - np.cos(dec) * np.sin(dec0) * np.cos(dra)) / denom / _D2R
        cd_inv = np.linalg.inv(np.asarray(self.cd))
        dx = cd_inv[0, 0] * xi + cd_inv[0, 1] * eta
        dy = cd_inv[1, 0] * xi + cd_inv[1, 1] * eta
        return (dx + self.crpix[0] - 1.0, dy + self.crpix[1] - 1.0)

    # -- derived WCSes ------------------------------------------------------
    def slice(self, y0: int, x0: int) -> "TanWCS":
        """WCS of the sub-image starting at 0-based pixel (y0, x0)."""
        return replace(self, crpix=(self.crpix[0] - x0, self.crpix[1] - y0))

    def pixel_scale_deg(self) -> float:
        cd = np.asarray(self.cd)
        return float(np.sqrt(abs(np.linalg.det(cd))))


def create_aligned_lr_wcs(hr_wcs: TanWCS, factor: int = 4) -> TanWCS:
    """LR WCS covering exactly the HR footprint at 1/factor resolution:
    CD x factor, CRPIX remapped so sky positions are preserved
    (the invariant of reference scripts/Dataset_step3_extractpatches.py:
    195-219; this version uses the exact pixel-center mapping
    lr = (hr - 0.5)/factor + 0.5 rather than the reference's crpix/factor
    approximation, so the footprints align to machine precision)."""
    cd = tuple(tuple(c * factor for c in row) for row in hr_wcs.cd)
    crpix = tuple((p - 0.5) / factor + 0.5 for p in hr_wcs.crpix)
    return TanWCS(hr_wcs.crval, crpix, cd)  # type: ignore[arg-type]


def has_celestial(header: dict) -> bool:
    """Is there a usable celestial TAN WCS in this header? (the reference's
    skip-if-already-solved check, scripts/Dataset_step1_datasetwcs.py:137-147)"""
    return TanWCS.from_header(header) is not None and "CRVAL1" in header
