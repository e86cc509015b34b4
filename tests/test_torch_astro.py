"""The port's astro ETL (superresolution_tpu_torch/astro/) against the JAX
package's numpy copy it was taken from, on the same inputs: every case
of tests/test_astro.py runs through both, and the arrays, headers, file
bytes and pair counts must agree. Both are the same float64 numpy, so
arrays are held bit-equal (FITS files byte-equal); a case that only the
port's copy runs keeps the reference test's own tolerance.

One end-to-end case more: extract_patches -> normalize_pairs ->
data/manifest.prepare_splits -> one port Trainer step on the CPU on the
TIFF pairs it wrote."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from superresolution_tpu import astro as ref_astro
from superresolution_tpu.astro import pipeline as ref_pipe
from superresolution_tpu.astro import solve as ref_solve
from superresolution_tpu.astro.wcs import has_celestial as ref_has_celestial
from superresolution_tpu_torch.astro import (
    TanWCS,
    create_aligned_lr_wcs,
    read_fits,
    reproject_bilinear,
    write_fits,
)
from superresolution_tpu_torch.astro import solve
from superresolution_tpu_torch.astro.pipeline import (
    calculate_robust_stats,
    extract_patches,
    normalize_pairs,
    save_diagnostic_card,
    zscale,
    zscale_limits,
)
from superresolution_tpu_torch.astro.wcs import has_celestial

WCS0 = TanWCS(crval=(150.1163, 2.2058), crpix=(256.5, 256.5),
              cd=((-7.0e-5, 1.2e-6), (1.1e-6, 7.0e-5)))
REF_WCS0 = ref_astro.TanWCS(WCS0.crval, WCS0.crpix, WCS0.cd)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SRTPU_NO_TB", "1")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The trainer step's CPU tensors are small: intra-op threads gain
    nothing, and on a host loaded by parallel test workers their
    spin-waits cost several times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_header(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert type(a[k]) is type(b[k]) and a[k] == b[k], k


def test_fits_roundtrip(tmp_path, rng):
    data = rng.random((32, 48)).astype(np.float32)
    path, rpath = str(tmp_path / "img.fits"), str(tmp_path / "ref.fits")
    write_fits(path, data, WCS0.to_header())
    ref_astro.write_fits(rpath, data, REF_WCS0.to_header())
    assert filecmp.cmp(path, rpath, shallow=False)
    back, header = read_fits(path)
    rback, rheader = ref_astro.read_fits(path)
    np.testing.assert_array_equal(back, rback)
    np.testing.assert_allclose(back, data, rtol=1e-6)
    _same_header(header, rheader)
    assert header["NAXIS1"] == 48 and header["NAXIS2"] == 32
    w = TanWCS.from_header(header)
    assert w is not None
    assert w == TanWCS(*dataclasses.astuple(
        ref_astro.TanWCS.from_header(rheader)))
    np.testing.assert_allclose(w.crval, WCS0.crval, rtol=1e-10)
    assert has_celestial(header) and ref_has_celestial(header)


def test_fits_int16_bscale(tmp_path):
    # a hand-built BITPIX=16 file with BSCALE/BZERO
    import struct
    cards = []
    for k, v in [("SIMPLE", "T"), ("BITPIX", "16"), ("NAXIS", "2"),
                 ("NAXIS1", "2"), ("NAXIS2", "1"),
                 ("BSCALE", "2.0"), ("BZERO", "100.0")]:
        cards.append(f"{k:<8}= {v:>20}".ljust(80))
    cards.append("END".ljust(80))
    htext = "".join(cards)
    htext += " " * ((-len(htext)) % 2880)
    body = struct.pack(">2h", 5, -3)
    body += b"\x00" * ((-len(body)) % 2880)
    path = str(tmp_path / "i16.fits")
    with open(path, "wb") as f:
        f.write(htext.encode())
        f.write(body)
    data, header = read_fits(path)
    rdata, rheader = ref_astro.read_fits(path)
    np.testing.assert_allclose(data, [[110.0, 94.0]])
    np.testing.assert_array_equal(data, rdata)
    _same_header(header, rheader)


def test_wcs_pixel_world_roundtrip():
    xs = np.array([0.0, 100.3, 511.0, 255.5])
    ys = np.array([0.0, 400.7, 511.0, 255.5])
    ra, dec = WCS0.pixel_to_world(xs, ys)
    rra, rdec = REF_WCS0.pixel_to_world(xs, ys)
    np.testing.assert_array_equal(ra, rra)
    np.testing.assert_array_equal(dec, rdec)
    xb, yb = WCS0.world_to_pixel(ra, dec)
    rxb, ryb = REF_WCS0.world_to_pixel(ra, dec)
    np.testing.assert_array_equal(xb, rxb)
    np.testing.assert_array_equal(yb, ryb)
    np.testing.assert_allclose(xb, xs, atol=1e-8)
    np.testing.assert_allclose(yb, ys, atol=1e-8)


def test_wcs_crpix_maps_to_crval():
    ra, dec = WCS0.pixel_to_world(WCS0.crpix[0] - 1.0, WCS0.crpix[1] - 1.0)
    np.testing.assert_allclose([ra, dec], WCS0.crval, atol=1e-12)
    assert WCS0.pixel_scale_deg() == REF_WCS0.pixel_scale_deg()


def test_wcs_slice():
    sub = WCS0.slice(100, 50)
    assert dataclasses.astuple(sub) == dataclasses.astuple(
        REF_WCS0.slice(100, 50))
    ra1, dec1 = WCS0.pixel_to_world(60.0, 110.0)
    ra2, dec2 = sub.pixel_to_world(10.0, 10.0)
    np.testing.assert_allclose([ra1, dec1], [ra2, dec2], atol=1e-12)


def test_aligned_lr_wcs_invariant():
    """The LR footprint covers exactly the HR footprint (corners within a
    tiny fraction of an arcsec), and the derived WCS is the reference's."""
    hr_wcs = WCS0.slice(37, 89)
    lr_wcs = create_aligned_lr_wcs(hr_wcs, 4)
    assert dataclasses.astuple(lr_wcs) == dataclasses.astuple(
        ref_astro.create_aligned_lr_wcs(REF_WCS0.slice(37, 89), 4))
    hr_size = 512
    for cx, cy in [(-0.5, -0.5), (hr_size - 0.5, -0.5),
                   (-0.5, hr_size - 0.5), (hr_size - 0.5, hr_size - 0.5),
                   ((hr_size - 1) / 2, (hr_size - 1) / 2)]:
        ra_h, dec_h = hr_wcs.pixel_to_world(cx, cy)
        ra_l, dec_l = lr_wcs.pixel_to_world((cx + 0.5) / 4 - 0.5,
                                            (cy + 0.5) / 4 - 0.5)
        dra = abs(ra_h - ra_l) * np.cos(np.deg2rad(dec_h)) * 3600
        ddec = abs(dec_h - dec_l) * 3600
        assert np.hypot(dra, ddec) < 1e-6, (cx, cy, dra, ddec)


def test_reproject_identity(rng):
    img = rng.random((64, 64))
    out, foot = reproject_bilinear(img, WCS0, WCS0, (64, 64))
    rout, rfoot = ref_astro.reproject_bilinear(img, REF_WCS0, REF_WCS0,
                                               (64, 64))
    np.testing.assert_array_equal(out, rout)
    np.testing.assert_array_equal(foot, rfoot)
    np.testing.assert_allclose(out, img, atol=1e-9)
    assert foot.min() == 1.0


def test_reproject_shifted_grid(rng):
    img = np.zeros((64, 64))
    img[32, 32] = 1.0
    shifted = TanWCS(WCS0.crval, (WCS0.crpix[0] - 10, WCS0.crpix[1] - 5),
                     WCS0.cd)
    out, foot = reproject_bilinear(img, WCS0, shifted, (64, 64))
    rout, rfoot = ref_astro.reproject_bilinear(
        img, REF_WCS0, ref_astro.TanWCS(*dataclasses.astuple(shifted)),
        (64, 64))
    np.testing.assert_array_equal(out, rout)  # NaN outside, in both
    np.testing.assert_array_equal(foot, rfoot)
    yy, xx = np.unravel_index(np.nanargmax(out), out.shape)
    assert (yy, xx) == (27, 22)


def test_diagnostic_card_mismatch_metric(tmp_path, rng):
    """(128-px cards: the metric does not depend on the size, and the
    reference's own case draws 512-px ones.)"""
    hr_wcs = WCS0.slice(0, 0)
    lr_wcs = create_aligned_lr_wcs(hr_wcs, 4)
    hr = rng.random((128, 128))
    lr = rng.random((32, 32))
    mm = save_diagnostic_card(hr, lr, hr_wcs, lr_wcs,
                              str(tmp_path / "card.png"))
    rmm = ref_pipe.save_diagnostic_card(
        hr, lr, REF_WCS0.slice(0, 0),
        ref_astro.create_aligned_lr_wcs(REF_WCS0.slice(0, 0), 4),
        str(tmp_path / "ref_card.png"))
    assert mm == rmm and mm < 1e-6  # aligned by construction
    assert os.path.exists(tmp_path / "card.png")


def _master_and_obs(tmp_path, rng, size, obs_size, crpix_obs,
                    noise=0.0, tag="obs"):
    master = (rng.random((size, size)) * 0.5 + 0.5).astype(np.float64)
    h_wcs = TanWCS(crval=(150.0, 2.0), crpix=(size / 2 + 0.5,) * 2,
                   cd=((-1.4e-5, 0.0), (0.0, 1.4e-5)))
    hpath = str(tmp_path / "hubble_master.fits")
    write_fits(hpath, master.astype(np.float32), h_wcs.to_header())
    opaths = []
    for k, crpix in enumerate(crpix_obs):
        o_wcs = TanWCS(crval=(150.0, 2.0), crpix=crpix,
                       cd=((-5.6e-5, 0.0), (0.0, 5.6e-5)))
        obs, _ = reproject_bilinear(master, h_wcs, o_wcs,
                                    (obs_size, obs_size))
        obs = np.nan_to_num(obs) + noise * rng.random((obs_size, obs_size))
        opath = str(tmp_path / f"{tag}_{k}.fits")
        write_fits(opath, obs.astype(np.float32), o_wcs.to_header())
        opaths.append(opath)
    return hpath, opaths


def _same_tree(a: str, b: str) -> None:
    """Two ETL output trees hold the same files, FITS and TIFF byte-equal
    (PNG cards are drawings, compared by name only)."""
    fa = sorted(os.path.relpath(os.path.join(d, f), a)
                for d, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(d, f), b)
                for d, _, fs in os.walk(b) for f in fs)
    assert fa == fb
    for f in fa:
        if not f.endswith(".png"):
            assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                               shallow=False), f


def test_extract_and_normalize_end_to_end(tmp_path, rng):
    """Synthetic master frame + 1 observatory frame -> pairs -> TIFFs ->
    manifests -> PairedDataset loads them; the reference's steps 3 and 4
    on the same files write the same bytes. (The reference's test runs
    512-px patches; this one 64-px patches, the same code path.)"""
    hpath, opaths = _master_and_obs(tmp_path, rng, 176, 44,
                                    [(22.5, 22.5)])
    pairs, rpairs = str(tmp_path / "pairs"), str(tmp_path / "rpairs")
    n = extract_patches(hpath, opaths, pairs, hr_size=64, stride=48,
                        factor=4, diag_first=1, workers=2)
    rn = ref_pipe.extract_patches(hpath, opaths, rpairs, hr_size=64,
                                  stride=48, factor=4, diag_first=1,
                                  workers=1)
    assert n == rn and n >= 1
    dirs = sorted(os.path.join(pairs, d) for d in os.listdir(pairs)
                  if d.startswith("pair_"))
    lo, hi = calculate_robust_stats(dirs)
    assert (lo, hi) == ref_pipe.calculate_robust_stats(dirs)
    assert hi > lo

    tiffs, rtiffs = str(tmp_path / "tiffs"), str(tmp_path / "rtiffs")
    assert normalize_pairs(pairs, tiffs, debug_every=1) == n
    assert ref_pipe.normalize_pairs(pairs, rtiffs, debug_every=1) == n
    _same_tree(tiffs, rtiffs)

    from superresolution_tpu_torch.data.dataset import PairedDataset
    from superresolution_tpu_torch.data.manifest import prepare_splits

    paths = prepare_splits(tiffs, str(tmp_path / "splits"), mode="overfit")
    item = PairedDataset(paths["train"])[0]
    assert item["hr"].shape == (64, 64, 1)
    assert item["lr"].shape == (16, 16, 1)
    assert item["hr"].max() > 0.1  # normalization produced real signal


def test_extract_patches_pair_per_passing_frame(tmp_path, rng):
    """N overlapping observatory frames yield N pairs per HR window (a
    pair for every frame passing the coverage gate), as in the
    reference."""
    hpath, opaths = _master_and_obs(tmp_path, rng, 200, 80,
                                    [(40.5, 40.5), (43.5, 37.5)],
                                    noise=0.01)
    pairs, rpairs = str(tmp_path / "pairs"), str(tmp_path / "rpairs")
    n = extract_patches(hpath, opaths, pairs, hr_size=128, stride=200,
                        factor=4, diag_first=0, workers=1)
    assert n == ref_pipe.extract_patches(hpath, opaths, rpairs, hr_size=128,
                                         stride=200, factor=4, diag_first=0,
                                         workers=1) == 2
    _same_tree(pairs, rpairs)
    hr0, _ = read_fits(os.path.join(pairs, "pair_000000", "hubble.fits"))
    hr1, _ = read_fits(os.path.join(pairs, "pair_000001", "hubble.fits"))
    np.testing.assert_array_equal(hr0, hr1)  # same HR window both times
    lr0, _ = read_fits(os.path.join(pairs, "pair_000000",
                                    "observatory.fits"))
    lr1, _ = read_fits(os.path.join(pairs, "pair_000001",
                                    "observatory.fits"))
    assert not np.array_equal(lr0, lr1)  # distinct observatory frames


def test_diagnostic_card_ra_wraparound(tmp_path, rng):
    """Patch centers straddling RA=0 (true separation ~0.1 arcsec) report
    ~0 arcsec, as the reference does."""
    hr_wcs = TanWCS(crval=(0.00001, 10.0), crpix=(257.0, 256.5),
                    cd=((-7.0e-5, 0.0), (0.0, 7.0e-5)))
    lr_wcs = TanWCS(crval=(359.99998, 10.0), crpix=(64.0, 64.5),
                    cd=((-2.8e-4, 0.0), (0.0, 2.8e-4)))
    hr = rng.random((512, 512))
    lr = rng.random((128, 128))
    ra_h, _ = hr_wcs.pixel_to_world((512 - 1) / 2.0, (512 - 1) / 2.0)
    ra_l, _ = lr_wcs.pixel_to_world((128 - 1) / 2.0, (128 - 1) / 2.0)
    assert ra_h < 1.0 and ra_l > 359.0  # genuinely straddling RA=0
    mm = save_diagnostic_card(hr, lr, hr_wcs, lr_wcs,
                              str(tmp_path / "card0.png"))
    rmm = ref_pipe.save_diagnostic_card(
        hr, lr, ref_astro.TanWCS(*dataclasses.astuple(hr_wcs)),
        ref_astro.TanWCS(*dataclasses.astuple(lr_wcs)),
        str(tmp_path / "ref0.png"))
    assert mm == rmm and mm < 1.0, mm


def test_from_header_partial_returns_none():
    """A CTYPE placeholder without numeric cards is 'no WCS'."""
    headers = [{"CTYPE1": "RA---TAN"},
               {"CTYPE1": "RA---TAN", "CRVAL1": 1.0, "CRVAL2": 2.0,
                "CRPIX1": 1.0, "CRPIX2": 1.0}]  # no CD/CDELT
    for h in headers:
        assert TanWCS.from_header(h) is None
        assert ref_astro.TanWCS.from_header(h) is None
    assert not has_celestial({"CTYPE1": "RA---TAN"})
    # CDELT/CROTA2 headers build the same CD matrix as the reference's
    h = {"CTYPE1": "RA---TAN", "CRVAL1": 10.0, "CRVAL2": -5.0,
         "CRPIX1": 3.0, "CRPIX2": 4.0, "CDELT1": -1e-4, "CDELT2": 1e-4,
         "CROTA2": 12.5}
    assert dataclasses.astuple(TanWCS.from_header(h)) == \
        dataclasses.astuple(ref_astro.TanWCS.from_header(h))


def test_fits_end_prefix_keyword_does_not_truncate(tmp_path, rng):
    """ENDTIME/ENDDATE do not end the header: WCS cards after them
    survive."""
    data = rng.random((8, 8)).astype(np.float32)
    header = {"ENDTIME": "2026-08-17T00:00:00"}
    header.update(WCS0.to_header())
    path = str(tmp_path / "endtime.fits")
    write_fits(path, data, header)
    back, h = read_fits(path)
    _same_header(h, ref_astro.read_fits(path)[1])
    np.testing.assert_allclose(back, data, rtol=1e-6)
    w = TanWCS.from_header(h)
    assert w is not None
    np.testing.assert_allclose(w.crval, WCS0.crval, rtol=1e-10)


def test_fits_long_string_value_keeps_quote(tmp_path, rng):
    """Long string values truncate inside the quotes (an escaped '' is
    not cut in half); later cards parse."""
    data = rng.random((8, 8)).astype(np.float32)
    header = {"LONGVAL": "x" * 100, "QUOTED": "it's" * 30}
    header.update(WCS0.to_header())
    path, rpath = str(tmp_path / "long.fits"), str(tmp_path / "rlong.fits")
    write_fits(path, data, header)
    ref_astro.write_fits(rpath, data, header)
    assert filecmp.cmp(path, rpath, shallow=False)
    back, h = read_fits(path)
    _same_header(h, ref_astro.read_fits(path)[1])
    assert str(h["LONGVAL"]).startswith("xxx")
    assert TanWCS.from_header(h) is not None


def test_zscale_and_astap_absent(tmp_path, rng, monkeypatch):
    """zscale_limits / zscale give the reference's values; with no ASTAP
    binary, find_astap is None and solve_with_astap returns False without
    raising (a pre-solved file returns True without a binary)."""
    img = rng.standard_normal((40, 50)) ** 2
    img[3, 4] = np.nan
    assert zscale_limits(img) == ref_pipe.zscale_limits(img)
    np.testing.assert_array_equal(zscale(img), ref_pipe.zscale(img))
    monkeypatch.setenv("SRTPU_ASTAP", str(tmp_path / "missing"))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert solve.find_astap() is None and ref_solve.find_astap() is None
    bare = str(tmp_path / "bare.fits")
    write_fits(bare, np.ones((4, 4), np.float32), {})
    assert solve.solve_with_astap(bare) is False
    assert ref_solve.solve_with_astap(bare) is False
    solved = str(tmp_path / "solved.fits")
    write_fits(solved, np.ones((4, 4), np.float32), WCS0.to_header())
    assert solve.solve_with_astap(solved) is True


def test_register_and_qc_match_reference(tmp_path, rng):
    """register_images on pre-solved frames (no ASTAP needed) writes the
    reference's reg_*.fits bytes; qc_overlay writes its PNG."""
    from superresolution_tpu_torch.astro.pipeline import (
        qc_overlay,
        register_images,
    )

    hpath, opaths = _master_and_obs(tmp_path, rng, 48, 24,
                                    [(12.5, 12.5)])
    out = register_images([hpath], opaths, str(tmp_path / "reg"),
                          workers=1)
    rout = ref_pipe.register_images([hpath], opaths, str(tmp_path / "rreg"),
                                    workers=1)
    assert {k: len(v) for k, v in out.items()} == \
        {k: len(v) for k, v in rout.items()} == {"hubble": 1,
                                                 "observatory": 1}
    _same_tree(str(tmp_path / "reg"), str(tmp_path / "rreg"))
    png = qc_overlay(out["hubble"], out["observatory"],
                     str(tmp_path / "qc.png"))
    assert os.path.getsize(png) > 0


def test_trainer_step_on_extracted_pairs(tmp_path, rng):
    """extract -> normalize -> prepare_splits -> one port Trainer step on
    the CPU on the TIFF pairs the ETL wrote."""
    from superresolution_tpu_torch.data.manifest import prepare_splits
    from superresolution_tpu_torch.train.trainer import Trainer
    from superresolution_tpu_torch.utils.config import get_preset

    hpath, opaths = _master_and_obs(tmp_path, rng, 112, 28,
                                    [(14.5, 14.5)])
    pairs, tiffs = str(tmp_path / "pairs"), str(tmp_path / "tiffs")
    n = extract_patches(hpath, opaths, pairs, hr_size=32, stride=40,
                        factor=4, diag_first=0, workers=1)
    assert normalize_pairs(pairs, tiffs, debug_every=0) == n >= 2
    man = prepare_splits(tiffs, str(tmp_path / "splits"), mode="split")
    cfg = get_preset("hybrid_astro")
    cfg = cfg.replace(
        model=dataclasses.replace(
            cfg.model, scale=4, refiner=None, smoothing=None,
            kwargs={"features": 8, "num_blocks": 1, "growth": 4}),
        data=dataclasses.replace(
            cfg.data, hr_patch=32, batch_size=2, num_workers=1,
            train_manifest=man["train"], val_manifest=man["val"]),
        train=dataclasses.replace(cfg.train, epochs=1, steps_per_epoch=1,
                                  precision="fp32"))
    with Trainer(cfg, str(tmp_path / "run"), device="cpu") as tr:
        assert len(tr.train_ds) >= 2 and tr.batch_size == 2
        before = {k: v.clone() for k, v in tr.state.params.items()}
        out = tr.fit()
    assert out["final_step"] == 1 and np.isfinite(out["best"]["psnr"])
    assert any(not torch.equal(before[k], v)
               for k, v in tr.state.params.items())
