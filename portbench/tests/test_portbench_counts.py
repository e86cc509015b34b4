"""portbench/counts/ gives PERF.md's kernel-table figures."""

import pytest

from portbench import common
from portbench.counts import b1, esrgan_x4, hab, hybrid_astro, k13, peaks


def test_b1_and_k13_macs_per_pixel():
    assert b1.macs_per_pixel() == 239_616
    assert b1.recompute_macs_per_pixel() == 129_024
    assert k13.macs_per_pixel() == 608_256
    assert k13.own_macs_per_pixel() == 2 * 239_616


def test_b1_bound_at_the_main_path_tile():
    # [24, 376, 256, 64]: 1.119 ms, bound by its operations
    px = 24 * 376 * 256
    assert b1.call_bound_s(px) * 1e3 == pytest.approx(1.119, abs=5e-4)
    assert 2.0 * b1.macs_per_pixel() * px / peaks.BF16_FLOPS == \
        pytest.approx(b1.call_bound_s(px))


def test_hab_macs_per_token():
    assert hab.macs_per_token(96, 192, 64) == 86_016
    # [1024 windows, 64, 96]: 0.0114 ms (operations)
    assert hab.call_bound_s(1024 * 64, 96, 192, 64) * 1e3 == \
        pytest.approx(0.0114, abs=5e-5)


def test_model_flops_of_the_configurations():
    e = common.load_json(common.BENCH_DIR / "configs" / "esrgan_x4.json")
    h = common.load_json(common.BENCH_DIR / "configs" / "hybrid_astro.json")
    # about 74 TFLOP a 2K frame, 1.15 TFLOP a 128^2 patch
    assert 2 * esrgan_x4.macs_per_lr_pixel(e["model"]) * 1080 * 1920 == \
        pytest.approx(74.35e12, rel=1e-3)
    assert 2 * hybrid_astro.macs_per_lr_pixel(h["model"]) * 128 * 128 == \
        pytest.approx(1.149e12, rel=1e-3)
