"""Kernel 17's op (superresolution_tpu_torch/ops/blur.py
anti_checkerboard_kernel) on the CPU, where it runs its plain form,
against the reference's anti_checkerboard_pallas
(superresolution_tpu/ops/pallas_blur.py) in interpret mode, as
tests/test_pallas_blur.py runs it, on the same numpy-seeded inputs.

Tolerances: f32 within rtol 1e-5 / atol 1e-6 (test_pallas_blur.py's
bar: the same f32 taps summed in another order). In bf16 the port's
plain form sums in its conv's f32 accumulator and rounds once: within
0.004 of max |f32 form| on the same bf16 values (half a bf16 ulp of the
largest output). The reference's kernel sums its k^2 bf16 taps in bf16,
which puts it up to ~0.022 from that f32 form (strong, 49 taps), so the
two are held to each other within 0.03."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_tpu.ops.pallas_blur import anti_checkerboard_pallas
from superresolution_tpu_torch.ops.blur import (
    _MODES,
    anti_checkerboard,
    anti_checkerboard_kernel,
    binomial_kernel,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(x, mode, th, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(anti_checkerboard_pallas(
            jnp.asarray(x, dtype), mode, th=th), np.float32)


@pytest.mark.parametrize("shape,th", [((2, 16, 20, 3), 8),
                                      ((1, 13, 11, 1), 64),
                                      ((1, 8, 9, 64), 4)])
@pytest.mark.parametrize("mode", ["light", "balanced", "strong"])
def test_plain_matches_pallas_f32(mode, shape, th):
    x = np.random.default_rng(len(mode) + shape[1]).random(
        shape, dtype=np.float32)
    ref = _jax(x, mode, th)
    got = anti_checkerboard_kernel(torch.from_numpy(x), mode, th=th)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["light", "balanced", "strong"])
def test_plain_matches_pallas_bf16(mode):
    x = np.random.default_rng(1).random((2, 16, 16, 2), dtype=np.float32)
    ref = _jax(x, mode, 8, jnp.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = anti_checkerboard_kernel(xb, mode)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    f32 = anti_checkerboard_kernel(xb.float(), mode).numpy()
    assert np.max(np.abs(got - f32)) / np.max(np.abs(f32)) < 0.004
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 0.03


def test_th_does_not_change_the_result():
    x = torch.from_numpy(np.random.default_rng(2).random(
        (1, 24, 10, 3), dtype=np.float32))
    outs = [anti_checkerboard_kernel(x, "balanced", th=th)
            for th in (1, 5, 8, 64)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(outs[0].numpy(),
                               _jax(x.numpy(), "balanced", 8), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["none", None])
def test_none_returns_the_input(mode):
    x = torch.rand((1, 8, 8, 1))
    assert anti_checkerboard_kernel(x, mode) is x
    with pltpu.force_tpu_interpret_mode():
        ref = anti_checkerboard_pallas(jnp.asarray(x.numpy()), "none")
    np.testing.assert_array_equal(np.asarray(ref), x.numpy())


def test_unknown_mode_raises_and_cpu_counts_no_launch():
    x = torch.rand((1, 8, 8, 1))
    with pytest.raises(ValueError, match="unknown smoothing mode"):
        anti_checkerboard_kernel(x, "heavy")
    before = anti_checkerboard_kernel.launches
    assert torch.equal(anti_checkerboard_kernel(x, "light"),
                       anti_checkerboard(x, "light"))
    assert anti_checkerboard_kernel.launches == before


def test_modes_are_the_reference_normalizers():
    """light 3x3/16 and balanced 5x5/256 sum to 1; strong 7x7/1600 to
    4096/1600, as the reference's layer does."""
    sums = {m: float(binomial_kernel(*_MODES[m]).sum()) for m in _MODES}
    assert sums["light"] == pytest.approx(1.0)
    assert sums["balanced"] == pytest.approx(1.0)
    assert sums["strong"] == pytest.approx(4096 / 1600)
