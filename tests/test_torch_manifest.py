"""Manifest-driven real pairs in the port against the JAX package, on the
CPU: data/manifest (scan, splits, load/write) on a temporary pair tree;
the port's own g++-built TIFF decoder (superresolution_tpu_torch/native/
loader.cpp via data/native_io) against JAX's load_image on 8- and 16-bit
TIFFs (to 1e-6: x/65535 in f32 against f64 then f32); PairedDataset's
items against JAX's and its native get_batch against the per-item path,
with a corrupt file (black tensor) and with PNG pairs (no fast path); a
tiny manifest Trainer with run_test writing its TIFFs, labelled strips
and metrics.txt; frame_and_label_collage byte-equal to JAX's."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from superresolution_tpu.data import manifest as jmanifest
from superresolution_tpu.data.dataset import PairedDataset as JaxPaired
from superresolution_tpu.data.io import load_image as jax_load_image
from superresolution_tpu.utils.collage import (
    frame_and_label_collage as jax_collage,
)
from superresolution_tpu_torch.data import manifest, native_io
from superresolution_tpu_torch.data.dataset import PairedDataset
from superresolution_tpu_torch.data.io import load_image, save_png, save_tiff16
from superresolution_tpu_torch.data.loader import Loader
from superresolution_tpu_torch.infer.evaluate import run_test
from superresolution_tpu_torch.train.trainer import Trainer
from superresolution_tpu_torch.utils.collage import frame_and_label_collage
from superresolution_tpu_torch.utils.config import get_preset


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These CPU tensors are small: intra-op threads gain nothing, and on
    a host loaded by parallel test workers their spin-waits cost several
    times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SRTPU_NO_TB", "1")


def _pairs(root, n, hr=32, lr=8, png=False):
    """n pair_* directories of 16-bit TIFFs (or 8-bit PNGs), plus one
    incomplete directory scan_pairs must skip."""
    for i in range(n):
        d = os.path.join(root, f"pair_{i:03d}")
        rng = np.random.default_rng(i)
        if png:
            save_png(rng.random((hr, hr, 1)), os.path.join(d, "hubble.png"))
            save_png(rng.random((lr, lr, 1)),
                     os.path.join(d, "observatory.png"))
        else:
            save_tiff16(rng.random((hr, hr, 1)),
                        os.path.join(d, "hubble.tiff"))
            save_tiff16(rng.random((lr, lr, 1)),
                        os.path.join(d, "observatory.tiff"))
    os.makedirs(os.path.join(root, "pair_zzz"), exist_ok=True)


@pytest.mark.parametrize("mode", ["split", "overfit"])
def test_manifest_functions_match_jax(tmp_path, mode):
    root = str(tmp_path / "pairs")
    _pairs(root, 12)
    assert manifest.scan_pairs(root) == jmanifest.scan_pairs(root)
    assert len(manifest.scan_pairs(root)) == 12
    got = manifest.prepare_splits(root, str(tmp_path / "port"), mode=mode)
    ref = jmanifest.prepare_splits(root, str(tmp_path / "jax"), mode=mode)
    assert sorted(got) == sorted(ref) == ["test", "train", "val"]
    for k in got:
        assert manifest.load_manifest(got[k]) == jmanifest.load_manifest(
            ref[k])
    entries = manifest.load_manifest(got["train"])
    manifest.write_manifest(entries, str(tmp_path / "w" / "m.json"))
    assert manifest.load_manifest(str(tmp_path / "w" / "m.json")) == entries
    (tmp_path / "bad.json").write_text(json.dumps({"a": 1}))
    with pytest.raises(ValueError, match="not a list"):
        manifest.load_manifest(str(tmp_path / "bad.json"))
    with pytest.raises(FileNotFoundError):
        manifest.prepare_splits(str(tmp_path / "w"), str(tmp_path / "x"))


@pytest.mark.parametrize("bits", [8, 16])
def test_native_decoder_matches_jax_load_image(tmp_path, bits):
    from PIL import Image

    rng = np.random.default_rng(bits)
    a = rng.random((23, 37))
    path = str(tmp_path / "x.tiff")
    if bits == 16:
        save_tiff16(a, path)
    else:
        Image.fromarray((a * 255).astype(np.uint8)).save(path)
    got = native_io.decode_tiff(path)
    ref = jax_load_image(path)
    assert got is not None and got.shape == ref.shape == (23, 37, 1)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, load_image(path), atol=1e-6, rtol=0)
    before = native_io.decode_batch.batches
    batch = native_io.decode_batch([path, path], (23, 37))
    assert native_io.decode_batch.batches == before + 1
    np.testing.assert_array_equal(batch, np.stack([got, got]))
    assert native_io.decode_batch([path], (23, 36)) is None  # wrong size
    (tmp_path / "bad.tiff").write_bytes(b"II*\x00garbage")
    assert native_io.decode_tiff(str(tmp_path / "bad.tiff")) is None
    assert native_io.decode_batch([str(tmp_path / "bad.tiff")],
                                  (23, 37)) is None


def test_native_build_lands_in_the_build_dir():
    assert native_io.get_lib() is not None
    built = [p for p in os.listdir(native_io.BUILD_DIR)
             if p.startswith("libsrloader_") and p.endswith(".so")]
    assert built
    src_dir = os.path.dirname(native_io._SRC)
    assert not [p for p in os.listdir(src_dir) if p.endswith(".so")]


def _manifest(tmp_path, n=4, png=False):
    root = str(tmp_path / "pairs")
    _pairs(root, n, png=png)
    path = str(tmp_path / "m.json")
    if png:
        manifest.write_manifest([
            {"patch_id": f"pair_{i:03d}",
             "hubble_path": os.path.join(root, f"pair_{i:03d}", "hubble.png"),
             "ground_path": os.path.join(root, f"pair_{i:03d}",
                                         "observatory.png")}
            for i in range(n)], path)
    else:
        manifest.write_manifest(manifest.scan_pairs(root), path)
    return path


def test_paired_dataset_matches_jax_and_get_batch_per_item(tmp_path):
    path = _manifest(tmp_path)
    ds, jds = PairedDataset(path, lr_size=8), JaxPaired(path, lr_size=8)
    assert len(ds) == len(jds) == 4
    for i in range(4):
        for k in ("lr", "hr"):
            np.testing.assert_allclose(ds[i][k], jds[i][k], atol=1e-6)
    fast = ds.get_batch([2, 0, 3])
    items = [ds[i] for i in (2, 0, 3)]
    for k in ("lr", "hr"):
        np.testing.assert_array_equal(fast[k],
                                      np.stack([it[k] for it in items]))
    # the Loader takes the fast path and gives the same batches
    before = native_io.decode_batch.batches
    got = list(Loader(ds, 2, shuffle=False, num_workers=1))
    assert native_io.decode_batch.batches == before + 4
    np.testing.assert_array_equal(got[1]["hr"],
                                  np.stack([ds[2]["hr"], ds[3]["hr"]]))


def test_corrupt_file_falls_back_to_black_tensor(tmp_path):
    path = _manifest(tmp_path)
    entries = manifest.load_manifest(path)
    with open(entries[1]["hubble_path"], "wb") as f:
        f.write(b"not a tiff")
    ds = PairedDataset(path, lr_size=8)
    ds[0]  # a good pair sets the shapes of the fallback
    assert ds.get_batch([0, 1]) is None  # any decode failure: no fast path
    loader_batch = next(iter(Loader(ds, 2, shuffle=False, num_workers=1)))
    assert not loader_batch["hr"][1].any() and not loader_batch["lr"][1].any()
    np.testing.assert_array_equal(loader_batch["hr"][0], ds[0]["hr"])
    jds = JaxPaired(path, lr_size=8)
    jds[0]
    for k in ("lr", "hr"):
        np.testing.assert_array_equal(ds[1][k], jds[1][k])


def test_png_pairs_take_the_per_item_path(tmp_path):
    ds = PairedDataset(_manifest(tmp_path, png=True), lr_size=8)
    assert ds.get_batch([0, 1]) is None
    batch = next(iter(Loader(ds, 2, shuffle=False, num_workers=1)))
    np.testing.assert_array_equal(batch["lr"],
                                  np.stack([ds[0]["lr"], ds[1]["lr"]]))


def test_manifest_trainer_and_run_test(tmp_path):
    _pairs(str(tmp_path / "pairs"), 3)
    man = manifest.prepare_splits(str(tmp_path / "pairs"),
                                  str(tmp_path / "splits"), mode="overfit")
    cfg = get_preset("hybrid_astro")
    model = dataclasses.replace(
        cfg.model, kwargs={"features": 8, "num_blocks": 1, "growth": 4},
        refiner_kwargs={"scale": 2, "embed_dim": 8, "depths": (1,),
                        "num_heads": (2,), "window_size": 8})
    data = dataclasses.replace(
        cfg.data, hr_patch=32, batch_size=1, num_workers=1,
        train_manifest=man["train"], val_manifest=man["val"],
        test_manifest=man["test"])
    train = dataclasses.replace(cfg.train, epochs=1, steps_per_epoch=1,
                                precision="fp32", resume=False)
    wd = str(tmp_path / "run")
    with Trainer(cfg.replace(model=model, data=data, train=train), wd,
                 device="cpu") as tr:
        assert isinstance(tr.test_ds, PairedDataset)
        tr.fit()
        res = run_test(tr, labeled=True)
        out = os.path.join(wd, "test_results")
        assert sorted(os.listdir(out)) == [
            "comparison_0000.png", "metrics.txt", "result_0000.tiff"]
        text = open(os.path.join(out, "metrics.txt")).read()
        assert text == (f"PSNR: {res['psnr']:.4f} dB\n"
                        f"SSIM: {res['ssim']:.6f}\n")
        sr = load_image(os.path.join(out, "result_0000.tiff"))
        assert sr.shape == (32, 32, 1)
        # the labelled strip: three 32-wide panels, framed, with a header
        strip = load_image(os.path.join(out, "comparison_0000.png"))
        assert strip.shape == (32 + 48 + 24, 96 + 24, 3)
        run_test(tr, out_dir=str(tmp_path / "plain"))
        assert load_image(str(tmp_path / "plain" /
                              "comparison_0000.png")).shape == (32, 96, 1)


@pytest.mark.parametrize("channels", [1, 3])
def test_collage_byte_equal_to_jax(tmp_path, channels):
    strip = np.random.default_rng(channels).random((24, 72, channels))
    a = frame_and_label_collage(strip, str(tmp_path / "port.png"))
    b = jax_collage(strip, str(tmp_path / "jax.png"),
                    labels=("Input", "Result", "Target"))
    assert filecmp.cmp(a, b, shallow=False)
    a = frame_and_label_collage(strip, str(tmp_path / "port2.png"),
                                labels=("LR", "SR"), panel_widths=[24, 48])
    b = jax_collage(strip, str(tmp_path / "jax2.png"), labels=("LR", "SR"),
                    panel_widths=[24, 48])
    assert filecmp.cmp(a, b, shallow=False)
