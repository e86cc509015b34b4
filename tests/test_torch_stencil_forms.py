"""The arithmetic of kernels 17 and B3's CUDA bodies (superresolution_tpu_
torch/utils/stencil_forms.py), on the CPU.

The CUDA bodies run only on the card; these tests hold their
decomposition: kernel 17's chunk-space rows and separable passes with the
integer binomial row and one scale by 1 / norm, against the plain blur
and the reference's anti_checkerboard_pallas in interpret mode (as
tests/test_torch_blur_kernel.py runs it); B3's tap-major split (one GEMM
per input row of a strip, nine shifted f32 partials), against the plain
conv_last and, after B2's plain form, against the reference's
phase_hr_last kernels in interpret mode (as tests/test_torch_phase_tail.py
runs them). Each planted fault's form must miss the bar by 3x.

Tolerances: f32 within 1e-5 of max |plain| (kernel 17's f32 bar: the same
taps summed in another order, the separable passes' extra roundings
included); the blur against the Pallas kernel at test_pallas_blur.py's
rtol 1e-5 / atol 1e-6; B3 through the JAX tail at
tests/test_phase_tail.py's atol 3e-5 / rtol 2e-4; in bf16 within 0.01
(17) and 0.02 (B3) of the plain form in f32, the chip bars."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_tpu.ops.pallas_blur import anti_checkerboard_pallas
from superresolution_tpu.ops.pallas_phase_tail import (
    phase_hr_last as jax_phase_hr_last,
)
from superresolution_tpu.ops.pixel_shuffle import depth_to_space
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops.blur import anti_checkerboard
from superresolution_tpu_torch.ops.phase_tail import (
    conv_last_phase_reference,
    up2_hr_reference,
)
from superresolution_tpu_torch.utils.stencil_forms import (
    blur_separable,
    conv_last_tap_major,
)

MODES = ("light", "balanced", "strong")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _image(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", [(2, 13, 11, 1), (1, 9, 10, 64)])
@pytest.mark.parametrize("mode", MODES)
def test_blur_form_matches_pallas(mode, shape):
    x = _image(shape, len(mode) + shape[-1])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(anti_checkerboard_pallas(jnp.asarray(x), mode,
                                                  th=4), np.float32)
    got = blur_separable(torch.from_numpy(x), mode)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 19, 21, 1), (1, 20, 300, 1),
                                   (2, 9, 7, 64), (1, 11, 5, 3),
                                   (1, 10, 6, 130), (1, 9, 10, 96)])
@pytest.mark.parametrize("mode", MODES)
def test_blur_form_matches_plain(mode, shape):
    """f32 within the bar, and bf16 rounded once; C 130 and C 96 take two
    chunks (the last part padding), C 3 runs straddle pixels."""
    x = torch.from_numpy(_image(shape, shape[1]))
    assert _rel(blur_separable(x, mode), anti_checkerboard(x, mode)) < 1e-5
    xb = x.to(torch.bfloat16)
    got = blur_separable(xb, mode)
    assert got.dtype == torch.bfloat16
    assert _rel(got, anti_checkerboard(xb.float(), mode)) < 0.01


@pytest.mark.parametrize("shape,mode", [((2, 19, 24, 1), "balanced"),
                                        ((1, 12, 10, 64), "strong")])
@pytest.mark.parametrize("fault", ["PLANT_NORM", "PLANT_CORNER"])
def test_blur_planted_faults_miss_by_3x(fault, shape, mode):
    x = torch.from_numpy(_image(shape, 5))
    bad = blur_separable(x, mode, plant=getattr(_build, fault))
    assert _rel(bad, anti_checkerboard(x, mode)) > 3 * 1e-5


def _last_inputs(b, h, w, cin, cout, seed):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(b, h, w, cin, generator=g) * 0.5
    k = torch.randn(3, 3, cin, cout, generator=g) * (2 / (9 * cin)) ** 0.5
    return y, k, torch.randn(cout, generator=g)


@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 5, 9, 64, 3),
                                            (2, 37, 130, 64, 3),
                                            (1, 6, 260, 16, 1),
                                            (1, 7, 12, 24, 4),
                                            (2, 4, 127, 48, 2)])
def test_conv_last_form_matches_plain(b, h, w, cin, cout):
    """f32 within 1e-5 across strips (W 127-260: one to three), and bf16
    inputs rounded once within 0.02."""
    y, k, bias = _last_inputs(b, h, w, cin, cout, w)
    ref = conv_last_phase_reference(y, k, bias)
    assert _rel(conv_last_tap_major(y, k, bias), ref) < 1e-5
    yb, kb = y.to(torch.bfloat16), k.to(torch.bfloat16)
    got = conv_last_tap_major(yb, kb, bias)
    assert got.dtype == torch.bfloat16
    assert _rel(got, conv_last_phase_reference(yb.float(), kb.float(),
                                               bias)) < 0.02


@pytest.mark.parametrize("fault", ["PLANT_ROW_CLAMP", "PLANT_WRONG_NEIGHBOUR",
                                   "PLANT_BIAS_DROPPED"])
def test_conv_last_planted_faults_miss_by_3x(fault):
    """At chip_smoke.py's multi-image check geometry's kind of shape: b 2,
    H and W not multiples of the band (64) or the strip (126)."""
    y, k, bias = _last_inputs(2, 37, 150, 64, 3, 7)
    bad = conv_last_tap_major(y, k, bias, plant=getattr(_build, fault))
    assert _rel(bad, conv_last_phase_reference(y, k, bias)) > 3 * 0.02


def test_conv_last_form_through_phase_hr_last_matches_jax():
    """B2's plain form then B3's split against the JAX phase tail's two
    Pallas kernels (interpret mode) on one set of random weights."""
    rng = np.random.default_rng(11)
    c, h, w = 16, 6, 10
    z1 = np.maximum(rng.standard_normal((2, h, w, 4 * c)), 0).astype(
        np.float32)
    up2_k = (rng.standard_normal((3, 3, c, 4 * c)) * 0.1).astype(np.float32)
    up2_b = (rng.standard_normal(4 * c) * 0.1).astype(np.float32)
    hr_k = (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
    hr_b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    last_k = (rng.standard_normal((3, 3, c, 3)) * 0.1).astype(np.float32)
    last_b = (rng.standard_normal(3) * 0.1).astype(np.float32)

    from superresolution_tpu.infer import folded_tail as jfold
    from superresolution_tpu.infer.phase_tail import permute_up2

    kfp, b2 = permute_up2(jfold.fold_stage2_kernel(up2_k), up2_b)
    ref = depth_to_space(jax_phase_hr_last(
        jnp.asarray(z1), kfp, b2, hr_k, hr_b, last_k, last_b, width=w,
        interpret=True, rb=3), 4)
    t = [torch.from_numpy(a) for a in (up2_k, up2_b, hr_k, hr_b)]
    y = up2_hr_reference(torch.from_numpy(z1), *t)
    got = conv_last_tap_major(y, torch.from_numpy(last_k),
                              torch.from_numpy(last_b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=2e-4)
