"""ASTAP plate-solve adapter.

The reference shells out to the ASTAP native binary with a two-attempt
fast/blind contract (reference: scripts/Dataset_step1_datasetwcs.py:60-97,
117-177): attempt 1 with search radius 30 deg, attempt 2 blind (radius 180,
optional -fov override). This adapter keeps that exact CLI contract but is
gated on the binary's presence (SRTPU_ASTAP env var or PATH lookup) —
pre-solved inputs (headers already carrying a celestial WCS) skip solving
entirely, which is also the reference's behavior.

The port's own copy of superresolution_tpu/astro/solve.py, line for line
(plain numpy on the host; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import shutil
import subprocess

from superresolution_tpu_torch.astro.fits import read_fits
from superresolution_tpu_torch.astro.wcs import has_celestial

_CANDIDATES = [
    "astap", "astap_cli",
    "/usr/local/bin/astap", "/usr/bin/astap",
    "/opt/astap/astap",
    "C:/Program Files/astap/astap.exe",
]


def find_astap() -> str | None:
    env = os.environ.get("SRTPU_ASTAP")
    if env and os.path.exists(env):
        return env
    for cand in _CANDIDATES:
        path = shutil.which(cand) if os.sep not in cand else (
            cand if os.path.exists(cand) else None)
        if path:
            return path
    return None


def solve_with_astap(path: str, astap: str | None = None,
                     fov_deg: float | None = None,
                     timeout: int = 300) -> bool:
    """Solve `path` in place (-update). Returns True if a celestial WCS is
    present afterwards. Skips files that already carry one."""
    _, header = read_fits(path)
    if has_celestial(header):
        return True
    astap = astap or find_astap()
    if astap is None:
        return False
    # attempt 1: fast (search radius 30 deg around header hint)
    cmd_fast = [astap, "-f", path, "-update", "-r", "30"]
    try:
        subprocess.run(cmd_fast, capture_output=True, timeout=timeout)
        _, header = read_fits(path)
        if has_celestial(header):
            return True
    except (subprocess.TimeoutExpired, OSError):
        pass
    # attempt 2: blind
    cmd_blind = [astap, "-f", path, "-update", "-r", "180"]
    if fov_deg:
        cmd_blind += ["-fov", str(fov_deg)]
    try:
        subprocess.run(cmd_blind, capture_output=True, timeout=timeout)
        _, header = read_fits(path)
        return has_celestial(header)
    except (subprocess.TimeoutExpired, OSError):
        return False
