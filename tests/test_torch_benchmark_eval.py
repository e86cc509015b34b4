"""The port's data/io and metrics/benchmark_eval (superresolution_tpu_torch/)
against the reference's (superresolution_tpu/data/io.py, metrics/
benchmark_eval.py) on inputs made from a seed with numpy.

data/io: the files either side writes are byte-equal and what either side
loads is equal, for 8-bit gray and RGB, RGBA, 16-bit TIFF, mode 'F' and
NaN / inf input. benchmark_eval: rgb_to_y and shave within 1e-6 (f32
arithmetic), sr_metrics and evaluate_folder within 1e-4 dB PSNR and 1e-5
SSIM (the same f32 metrics; the port's bicubic degradation runs its
matmuls in another order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from superresolution_tpu.data import io as jio
from superresolution_tpu.metrics import benchmark_eval as jbe
from superresolution_tpu_torch.data import io
from superresolution_tpu_torch.metrics import benchmark_eval as be


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed, *shape):
    return np.random.default_rng(seed).random(shape, np.float32)


@pytest.mark.parametrize("shape", [(9, 7), (9, 7, 1), (9, 7, 3)])
def test_save_png_bytes_and_load_match(shape, tmp_path):
    a = _img(1, *shape) * 1.2 - 0.1  # some values outside [0, 1]
    io.save_png(a, str(tmp_path / "port" / "a.png"))
    jio.save_png(a, str(tmp_path / "ref" / "a.png"))
    got = (tmp_path / "port" / "a.png").read_bytes()
    assert got == (tmp_path / "ref" / "a.png").read_bytes()
    path = str(tmp_path / "port" / "a.png")
    np.testing.assert_array_equal(io.load_image(path), jio.load_image(path))


def test_save_tiff16_bytes_and_load_match(tmp_path):
    a = _img(2, 11, 5, 1)
    io.save_tiff16(a, str(tmp_path / "p.tif"))
    jio.save_tiff16(a, str(tmp_path / "r.tif"))
    assert (tmp_path / "p.tif").read_bytes() == \
        (tmp_path / "r.tif").read_bytes()
    got = io.load_image(str(tmp_path / "p.tif"))
    np.testing.assert_array_equal(got, jio.load_image(str(tmp_path /
                                                          "p.tif")))
    assert got.shape == (11, 5, 1)
    with pytest.raises(ValueError, match="single-channel"):
        io.save_tiff16(_img(2, 4, 4, 3), str(tmp_path / "x.tif"))


@pytest.mark.parametrize("kind", ["rgba", "float_nan", "uint16_gray"])
def test_load_image_matches_reference(kind, tmp_path):
    path = str(tmp_path / ("a.png" if kind == "rgba" else "a.tif"))
    rng = np.random.default_rng(3)
    if kind == "rgba":
        Image.fromarray(rng.integers(0, 256, (6, 8, 4), np.uint8),
                        "RGBA").save(path)
    elif kind == "float_nan":
        a = rng.standard_normal((6, 8)).astype(np.float32)
        a[0, 0], a[1, 2], a[3, 3] = np.nan, np.inf, -np.inf
        Image.fromarray(a, "F").save(path)
    else:
        Image.fromarray(rng.integers(0, 65536, (6, 8), np.uint16)).save(path)
    got, ref = io.load_image(path), jio.load_image(path)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert got.min() >= 0 and got.max() <= 1


def test_rgb_to_y_and_shave_match():
    a = _img(4, 2, 10, 12, 3)
    np.testing.assert_allclose(be.rgb_to_y(torch.from_numpy(a)).numpy(),
                               np.asarray(jbe.rgb_to_y(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-6)
    g = _img(5, 10, 12, 1)
    assert torch.equal(be.rgb_to_y(torch.from_numpy(g)), torch.from_numpy(g))
    for border in (0, 3):
        np.testing.assert_array_equal(
            be.shave(torch.from_numpy(a), border).numpy(),
            np.asarray(jbe.shave(jnp.asarray(a), border)))


@pytest.mark.parametrize("scale,y_channel,c", [(2, True, 3), (3, False, 3),
                                               (4, True, 1)])
def test_sr_metrics_match(scale, y_channel, c):
    t = _img(6, 24, 30, c)
    p = np.clip(t + 0.05 * np.random.default_rng(7).standard_normal(
        t.shape).astype(np.float32), 0, 1)
    got = be.sr_metrics(p, t, scale, y_channel)
    ref = jbe.sr_metrics(jnp.asarray(p), jnp.asarray(t), scale, y_channel)
    assert got["psnr"] == pytest.approx(ref["psnr"], abs=1e-4)
    assert got["ssim"] == pytest.approx(ref["ssim"], abs=1e-5)


def _nearest_up(scale):
    def up(lr):
        lr = np.asarray(lr)
        return np.repeat(np.repeat(lr, scale, 0), scale, 1)
    return up


@pytest.mark.parametrize("scale", [2, 3])
def test_evaluate_folder_matches(scale, tmp_path):
    """Three PNGs, one ragged (center-cropped to a multiple of scale),
    upscaled by the same numpy function on both sides."""
    for i, (h, w) in enumerate(((48, 48), (37, 53), (30, 42))):
        io.save_png(_img(10 + i, h, w, 3), str(tmp_path / f"im{i}.png"))
    (tmp_path / "notes.txt").write_text("not an image")
    got = be.evaluate_folder(_nearest_up(scale), str(tmp_path), scale)
    ref = jbe.evaluate_folder(_nearest_up(scale), str(tmp_path), scale)
    assert got["n"] == ref["n"] == 3
    assert got["psnr"] == pytest.approx(ref["psnr"], abs=1e-4)
    assert got["ssim"] == pytest.approx(ref["ssim"], abs=1e-5)


def test_evaluate_folder_takes_a_device_tensor_and_refuses_empty(tmp_path):
    io.save_png(_img(20, 16, 16, 3), str(tmp_path / "a.png"))
    fn = _nearest_up(2)
    as_tensor = be.evaluate_folder(lambda lr: torch.from_numpy(fn(lr)),
                                   str(tmp_path), 2, y_channel=False)
    assert as_tensor == be.evaluate_folder(fn, str(tmp_path), 2,
                                           y_channel=False)
    os.remove(tmp_path / "a.png")
    with pytest.raises(FileNotFoundError):
        be.evaluate_folder(fn, str(tmp_path), 2)
