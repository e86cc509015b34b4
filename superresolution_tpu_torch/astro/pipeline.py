"""The 4-step astronomy dataset pipeline (host-side ETL).

Re-creates the reference's offline stages with the same on-disk contracts:

  step1 `register_images`   — plate-solve (ASTAP adapter) + resample all
        frames onto a common TAN grid at native pixel scale
        (reference: scripts/Dataset_step1_datasetwcs.py:196-299)
  step2 `qc_overlay`        — median-stacked observatory canvas, max-composited
        Hubble mosaic, green/magenta alignment overlay PNG
        (reference: scripts/Dataset_step2_mosaicHSTObs.py)
  step3 `extract_patches`   — slide an HR window over the master frame,
        derive the aligned LR WCS (x factor), reproject observatory frames
        into it, write pair FITS + diagnostic cards
        (reference: scripts/Dataset_step3_extractpatches.py)
  step4 `normalize_pairs`   — global robust log-stretch stats, per-pair
        16-bit TIFF normalization (reference:
        scripts/Dataset_step4_normalization.py)

The port's own copy of superresolution_tpu/astro/pipeline.py, line for
line (plain numpy on the host; the port imports nothing of the JAX
package). normalize_pairs writes through the port's data/io.py;
matplotlib is imported only inside qc_overlay and save_diagnostic_card.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
import threading

import numpy as np

from superresolution_tpu_torch.astro.fits import read_fits, write_fits
from superresolution_tpu_torch.astro.reproject import reproject_bilinear
from superresolution_tpu_torch.astro.solve import find_astap, solve_with_astap
from superresolution_tpu_torch.astro.wcs import TanWCS, create_aligned_lr_wcs

log = logging.getLogger("srtpu.astro")


# ---------------------------------------------------------------------------
# step 1: solve + register
# ---------------------------------------------------------------------------

def register_images(hubble_files: list[str], obs_files: list[str],
                    out_dir: str, workers: int = 2,
                    fov_deg: float | None = None) -> dict:
    """Solve every frame (skipping pre-solved ones), then resample each onto
    a TAN grid centered on the first solved Hubble frame's CRVAL at the
    image's native pixel scale. Writes reg_*.fits; returns path lists."""
    os.makedirs(out_dir, exist_ok=True)
    astap = find_astap()

    def solve_all(files):
        solved = []
        with cf.ThreadPoolExecutor(workers) as pool:
            futs = {pool.submit(solve_with_astap, f, astap, fov_deg): f
                    for f in files}
            for fut in cf.as_completed(futs):
                f = futs[fut]
                try:
                    if fut.result():
                        solved.append(f)
                    else:
                        log.warning("solve failed (skipped): %s", f)
                except Exception as e:
                    log.warning("solve error %s: %s", f, e)
        return sorted(solved)

    h_solved = solve_all(hubble_files)
    o_solved = solve_all(obs_files)
    if not h_solved:
        raise RuntimeError("no solved Hubble frames; cannot register")
    _, ref_header = read_fits(h_solved[0])
    ref_wcs = TanWCS.from_header(ref_header)

    def register_one(path):
        data, header = read_fits(path)
        wcs = TanWCS.from_header(header)
        if wcs is None or data is None:
            return None
        data = np.where(data < -10000, np.nan, data)  # bad-pixel mask
        # target: TAN centered at reference CRVAL, native pixel scale,
        # north-up (reference register_single_image_smart, :256-260)
        scale = wcs.pixel_scale_deg()
        h, w = data.shape
        tgt = TanWCS(ref_wcs.crval, (w / 2 + 0.5, h / 2 + 0.5),
                     ((-scale, 0.0), (0.0, scale)))
        # NaN bad pixels propagate through the bilinear sample (like
        # reproject_interp) and zero AFTER reprojection — passing
        # nan_to_num'd data would bake them in as valid zeros
        out, _ = reproject_bilinear(data, wcs, tgt, (h, w))
        out = np.nan_to_num(out).astype(np.float32)
        name = "reg_" + os.path.basename(path)
        opath = os.path.join(out_dir, name)
        hdr = tgt.to_header()
        hdr["REG_METH"] = "tan_native_scale"
        write_fits(opath, out, hdr)
        return opath

    registered = {"hubble": [], "observatory": []}
    with cf.ThreadPoolExecutor(workers) as pool:
        for key, files in (("hubble", h_solved), ("observatory", o_solved)):
            for res in pool.map(register_one, files):
                if res:
                    registered[key].append(res)
    return registered


# ---------------------------------------------------------------------------
# step 2: QC overlay
# ---------------------------------------------------------------------------

def zscale_limits(img: np.ndarray, contrast: float = 0.25,
                  n_samples: int = 1000, krej: float = 2.5,
                  max_iterations: int = 5,
                  min_npixels: int = 5) -> tuple[float, float]:
    """IRAF/astropy ZScale display limits (the algorithm behind the
    reference's ZScaleInterval, Dataset_step2_mosaicHSTObs.py:111-116):
    sample the image, fit a line to the sorted sample with k-sigma
    rejection, and expand the midpoint by slope/contrast."""
    finite = img[np.isfinite(img)]
    if finite.size == 0:
        return 0.0, 1.0
    stride = max(1, finite.size // n_samples)
    samples = np.sort(finite.ravel()[::stride][:n_samples].astype(np.float64))
    n = samples.size
    zmin, zmax = samples[0], samples[-1]
    if n < min_npixels:
        return float(zmin), float(zmax)
    x = np.arange(n, dtype=np.float64)
    center = (n - 1) / 2.0
    median = float(np.median(samples))
    good = np.ones(n, bool)
    slope = 0.0
    for _ in range(max_iterations):
        xi, yi = x[good], samples[good]
        if xi.size < min_npixels:
            break
        slope, intercept = np.polyfit(xi, yi, 1)
        resid = samples - (slope * x + intercept)
        sigma = resid[good].std()
        if sigma <= 0:
            break
        new_good = np.abs(resid) <= krej * sigma
        if new_good.sum() == good.sum():
            break
        good = new_good
    if good.sum() < min_npixels:
        return float(zmin), float(zmax)
    if contrast > 0:
        slope = slope / contrast
    z1 = max(zmin, median - center * slope)
    z2 = min(zmax, median + (n - center) * slope)
    return float(z1), float(z2)


def zscale(img: np.ndarray, contrast: float = 0.25):
    """ZScale display normalization of `img` to [0, 1]."""
    lo, hi = zscale_limits(img, contrast)
    if hi <= lo:
        hi = lo + 1e-9
    return np.clip((img - lo) / (hi - lo), 0, 1)


def qc_overlay(hubble_files: list[str], obs_files: list[str],
               out_png: str, max_obs: int = 10) -> str:
    """3-panel alignment check: Hubble mosaic / observatory canvas /
    green-magenta overlay."""
    frames = []
    canvas_wcs = None
    shape = None
    for f in obs_files[:max_obs]:
        data, header = read_fits(f)
        wcs = TanWCS.from_header(header)
        if data is None or wcs is None:
            continue
        if canvas_wcs is None:
            canvas_wcs, shape = wcs, data.shape
            frames.append(np.nan_to_num(data))
        else:
            out, _ = reproject_bilinear(np.nan_to_num(data), wcs,
                                        canvas_wcs, shape)
            frames.append(np.nan_to_num(out))
    if not frames:
        raise RuntimeError("no usable observatory frames")
    master_obs = np.median(np.stack(frames), axis=0)

    mosaic = np.zeros(shape)
    for f in hubble_files:
        data, header = read_fits(f)
        wcs = TanWCS.from_header(header)
        if data is None or wcs is None:
            continue
        out, foot = reproject_bilinear(np.nan_to_num(data), wcs,
                                       canvas_wcs, shape)
        mosaic = np.maximum(mosaic, np.nan_to_num(out))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hn, on = zscale(mosaic), zscale(master_obs)
    overlay = np.stack([on, hn, on], axis=-1)  # hubble=green, obs=magenta
    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    for ax, img, title in zip(
            axes, [hn, on, overlay],
            ["Hubble mosaic", "Observatory (median)", "Overlay G=HST M=Obs"]):
        ax.imshow(img, cmap=None if img.ndim == 3 else "gray",
                  origin="lower")
        ax.set_title(title)
        ax.axis("off")
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_png


# ---------------------------------------------------------------------------
# step 3: WCS-aware patch extraction
# ---------------------------------------------------------------------------

def extract_patches(hubble_path: str, obs_paths: list[str], out_dir: str,
                    hr_size: int = 512, stride: int = 75, factor: int = 4,
                    min_coverage: float = 0.5, signal_floor: float = 1e-4,
                    diag_first: int = 50, workers: int = 4) -> int:
    """Slide an hr_size window over the master Hubble frame; for each
    sufficiently-covered patch, derive the aligned LR WCS and reproject
    every observatory frame into it. Writes
    pair_NNNNNN/{hubble,observatory}.fits. Returns the number of pairs."""
    os.makedirs(out_dir, exist_ok=True)
    hubble, h_header = read_fits(hubble_path)
    h_wcs = TanWCS.from_header(h_header)
    if hubble is None or h_wcs is None:
        raise RuntimeError(f"master frame unusable: {hubble_path}")
    hubble = np.nan_to_num(hubble)

    obs = []
    for p in obs_paths:
        data, header = read_fits(p)
        wcs = TanWCS.from_header(header)
        if data is None or wcs is None:
            continue
        # keep frames whose center is near the master frame center
        cy, cx = data.shape[0] / 2, data.shape[1] / 2
        ra, dec = wcs.pixel_to_world(cx, cy)
        dra = (ra - h_wcs.crval[0] + 180.0) % 360.0 - 180.0  # RA wrap
        sep = np.hypot(dra * np.cos(np.deg2rad(h_wcs.crval[1])),
                       dec - h_wcs.crval[1])
        if sep < 1.0:
            obs.append((np.nan_to_num(data), wcs))
    if not obs:
        raise RuntimeError("no observatory frames overlap the master frame")

    lr_size = hr_size // factor
    tasks = [(y, x)
             for y in range(0, hubble.shape[0] - hr_size + 1, stride)
             for x in range(0, hubble.shape[1] - hr_size + 1, stride)]
    counter = {"i": 0}
    lock = threading.Lock()

    def process(task):
        # One pair is written for EVERY observatory frame that passes the
        # coverage gate — the same HR window can yield several pairs
        # (reference Dataset_step3_extractpatches.py:245-293, saved_count).
        y, x = task
        hr_patch = hubble[y:y + hr_size, x:x + hr_size]
        if (hr_patch > signal_floor).mean() < min_coverage:
            return 0
        patch_wcs = h_wcs.slice(y, x)
        lr_wcs = create_aligned_lr_wcs(patch_wcs, factor)
        saved = 0
        for data, wcs in obs:
            lr_patch, foot = reproject_bilinear(data, wcs, lr_wcs,
                                                (lr_size, lr_size))
            lr_patch = np.nan_to_num(lr_patch)
            if foot.mean() < min_coverage or \
                    (lr_patch > signal_floor).mean() < min_coverage:
                continue
            with lock:
                idx = counter["i"]
                counter["i"] += 1
            pdir = os.path.join(out_dir, f"pair_{idx:06d}")
            write_fits(os.path.join(pdir, "hubble.fits"),
                       hr_patch.astype(np.float32), patch_wcs.to_header())
            write_fits(os.path.join(pdir, "observatory.fits"),
                       lr_patch.astype(np.float32), lr_wcs.to_header())
            if idx < diag_first:
                save_diagnostic_card(hr_patch, lr_patch, patch_wcs, lr_wcs,
                                     os.path.join(out_dir, "diagnostics",
                                                  f"pair_{idx:06d}.png"))
            saved += 1
        return saved

    with cf.ThreadPoolExecutor(workers) as pool:
        list(pool.map(process, tasks))
    return counter["i"]


def save_diagnostic_card(hr, lr, hr_wcs: TanWCS, lr_wcs: TanWCS,
                         out_png: str) -> float:
    """Alignment card with the computed RA/Dec mismatch in arcsec and a
    PERFECT/MISMATCH verdict at 1 arcsec (reference Dataset_step3:78-180).
    Returns the mismatch."""
    # centers of the two footprints must coincide on the sky
    hy, hx = (np.asarray(hr.shape) - 1) / 2.0
    ly, lx = (np.asarray(lr.shape) - 1) / 2.0
    ra_h, dec_h = hr_wcs.pixel_to_world(hx, hy)
    ra_l, dec_l = lr_wcs.pixel_to_world(lx, ly)
    dra_deg = (ra_h - ra_l + 180.0) % 360.0 - 180.0  # RA 0/360 wrap
    dra = dra_deg * np.cos(np.deg2rad(dec_h)) * 3600.0
    ddec = (dec_h - dec_l) * 3600.0
    mismatch = float(np.hypot(dra, ddec))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 3, figsize=(15, 9))
        verdict = "PERFECT" if mismatch < 1.0 else "MISMATCH"
        axes[0, 0].imshow(zscale(hr), cmap="gray", origin="lower")
        axes[0, 0].set_title("HR patch")
        axes[0, 1].imshow(zscale(lr), cmap="gray", origin="lower")
        axes[0, 1].set_title("LR patch")
        up = np.kron(zscale(lr), np.ones((hr.shape[0] // lr.shape[0],
                                          hr.shape[1] // lr.shape[1])))
        axes[0, 2].imshow(np.stack([up, zscale(hr), up], -1),
                          origin="lower")
        axes[0, 2].set_title("overlay")
        axes[1, 0].hist(hr.ravel(), bins=64)
        axes[1, 0].set_title("HR histogram")
        axes[1, 1].hist(lr.ravel(), bins=64)
        axes[1, 1].set_title("LR histogram")
        axes[1, 2].axis("off")
        axes[1, 2].text(0.1, 0.5,
                        f"center mismatch: {mismatch:.4f}\"\n{verdict}",
                        fontsize=16)
        os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
        fig.savefig(out_png, dpi=90, bbox_inches="tight")
        plt.close(fig)
    except Exception:
        pass
    return mismatch


# ---------------------------------------------------------------------------
# step 4: log-stretch normalization -> 16-bit TIFF
# ---------------------------------------------------------------------------

def calculate_robust_stats(pair_dirs: list[str], sample_px: int = 4000,
                           black_p: float = 3.0, white_p: float = 99.99,
                           valid_floor: float = 1e-5) -> tuple[float, float]:
    """Global percentiles of log1p(valid pixels), sampled per image
    (reference Dataset_step4:21-31,55-91)."""
    rng = np.random.default_rng(0)
    samples = []
    for d in pair_dirs:
        for name in ("hubble.fits", "observatory.fits"):
            path = os.path.join(d, name)
            if not os.path.exists(path):
                continue
            data, _ = read_fits(path)
            if data is None:
                continue
            v = np.log1p(np.maximum(np.nan_to_num(data), 0.0))
            v = v[v > valid_floor].ravel()
            if v.size > sample_px:
                v = rng.choice(v, sample_px, replace=False)
            samples.append(v)
    if not samples:
        raise RuntimeError("no valid pixels for stats")
    allv = np.concatenate(samples)
    lo, hi = np.percentile(allv, [black_p, white_p])
    return float(lo), float(hi)


def normalize_pairs(pairs_root: str, out_dir: str, black_p: float = 3.0,
                    white_p: float = 99.99, debug_every: int = 50) -> int:
    """Log-stretch + global min-max -> uint16 TIFF pairs
    (pair_NNNNNN/{hubble,observatory}.tiff — the step-4 contract)."""
    from superresolution_tpu_torch.data.io import save_png, save_tiff16

    pair_dirs = sorted(
        os.path.join(pairs_root, d) for d in os.listdir(pairs_root)
        if d.startswith("pair_"))
    lo, hi = calculate_robust_stats(pair_dirs, black_p=black_p,
                                    white_p=white_p)
    span = max(hi - lo, 1e-9)
    n = 0
    for i, d in enumerate(pair_dirs):
        outs = {}
        ok = True
        for name in ("hubble", "observatory"):
            data, _ = read_fits(os.path.join(d, f"{name}.fits"))
            if data is None:
                ok = False
                break
            v = np.log1p(np.maximum(np.nan_to_num(data), 0.0))
            outs[name] = np.clip((v - lo) / span, 0.0, 1.0)
        if not ok:
            continue
        od = os.path.join(out_dir, os.path.basename(d))
        for name, img in outs.items():
            save_tiff16(img.astype(np.float32),
                        os.path.join(od, f"{name}.tiff"))
        if debug_every and i % debug_every == 0:
            dbg = np.concatenate(
                [outs["hubble"],
                 np.kron(outs["observatory"],
                         np.ones((outs["hubble"].shape[0]
                                  // outs["observatory"].shape[0],) * 2))],
                axis=1)
            save_png(dbg[..., None],
                     os.path.join(out_dir, "debug", f"pair_{i:06d}.png"))
        n += 1
    return n
