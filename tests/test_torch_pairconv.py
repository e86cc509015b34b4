"""Kernel 18's op (superresolution_tpu_torch/ops/pairconv.py) on the CPU,
where it runs its plain form, against the reference's pack_conv3x3
(superresolution_tpu/ops/pallas_pairconv.py) with interpret=True, as
tests/test_pallas_pairconv.py runs it, on the same numpy-seeded inputs.

Tolerances are test_pallas_pairconv.py's: values within 1e-4 (the same
f32 products summed in another order), gradients within 1e-3 of
jax.grad through the reference's custom_vjp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import pallas_pairconv as jpc
from superresolution_tpu_torch.ops import pairconv
from superresolution_tpu_torch.ops.pairconv import (
    pack_conv3x3,
    pack_geometry,
    pack_input,
    unpack_output,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, shape, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.05 * rng.standard_normal((3, 3, shape[-1], n))).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, w, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("c,n,p", [(64, 192, 2), (32, 160, 4), (32, 96, 4),
                                   (64, 64, 2), (32, 160, 2)])
def test_plain_matches_pallas(c, n, p):
    x, w, b = _case(c + n + p, (1, 8, 32, c), n)
    ref = jpc.pack_conv3x3(jpc.pack_input(jnp.asarray(x), p), jnp.asarray(w),
                           jnp.asarray(b), p, 32, "none", True)
    tx, tw, tb = _t(x, w, b)
    got = pack_conv3x3(pack_input(tx, p), tw, tb, p, 32)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(unpack_output(got, p, 32).numpy(),
                               np.asarray(jpc.unpack_output(ref, p, 32)),
                               atol=1e-4, rtol=1e-4)


def test_chained_lrelu_pair_matches_pallas():
    """Two chained packed convs, the first with lrelu: the pad packs the
    first writes are the zeros the second reads."""
    x, w1, b1 = _case(1, (1, 8, 32, 64), 128)
    _, w2, b2 = _case(2, (1, 8, 32, 128), 64)
    y = jpc.pack_conv3x3(jpc.pack_input(jnp.asarray(x), 2), jnp.asarray(w1),
                         jnp.asarray(b1), 2, 32, "lrelu", True)
    ref = jpc.pack_conv3x3(y, jnp.asarray(w2), jnp.asarray(b2), 2, 32,
                           "none", True)
    tx, tw1, tb1, tw2, tb2 = _t(x, w1, b1, w2, b2)
    y1 = pack_conv3x3(pack_input(tx, 2), tw1, tb1, 2, 32, "lrelu")
    got = pack_conv3x3(y1, tw2, tb2, 2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_gradients_match_jax_grad():
    x, w, b = _case(3, (1, 8, 16, 32), 64)

    def loss_jax(xp, w, b):
        y = jpc.pack_conv3x3(xp, w, b, 2, 16, "lrelu", True)
        return jnp.sum(jpc.unpack_output(y, 2, 16) ** 2)

    xp = jpc.pack_input(jnp.asarray(x), 2)
    rx, rw, rb = jax.grad(loss_jax, argnums=(0, 1, 2))(xp, jnp.asarray(w),
                                                        jnp.asarray(b))
    tx, tw, tb = _t(x, w, b)
    txp = pack_input(tx, 2).requires_grad_(True)
    tw.requires_grad_(True)
    tb.requires_grad_(True)
    loss = (unpack_output(pack_conv3x3(txp, tw, tb, 2, 16, "lrelu"), 2,
                          16) ** 2).sum()
    gx, gw, gb = torch.autograd.grad(loss, (txp, tw, tb))
    for got, ref in ((gx, rx), (gw, rw), (gb, rb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3,
                                   rtol=1e-3)
    # the input's pad packs get a zero gradient
    unpacked = gx.reshape(1, 8, -1, 32)
    assert not unpacked[:, :, :2].any() and not unpacked[:, :, 18:].any()


def test_width_not_a_multiple_of_p_raises():
    with pytest.raises(ValueError, match="not a multiple of pack"):
        jpc.pack_geometry(15, 2)
    with pytest.raises(ValueError, match="not a multiple of pack"):
        pack_geometry(15, 2)
    x = torch.zeros((1, 4, pack_geometry(16, 2)[0], 2 * 8))
    with pytest.raises(ValueError, match="not a multiple of pack"):
        pack_conv3x3(x, torch.zeros(3, 3, 8, 8), torch.zeros(8), 2, 15)


def test_row_band_fallback_at_h4():
    """H = 4: the reference drops its row band from 8 to 4; the port has
    no band and takes any H."""
    x, w, b = _case(4, (1, 4, 16, 32), 32)
    ref = jpc.unpack_output(jpc.pack_conv3x3(
        jpc.pack_input(jnp.asarray(x), 2), jnp.asarray(w), jnp.asarray(b),
        2, 16, "none", True), 2, 16)
    tx, tw, tb = _t(x, w, b)
    got = unpack_output(pack_conv3x3(pack_input(tx, 2), tw, tb, 2, 16), 2,
                        16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("width,p", [(16, 2), (30, 2), (48, 4), (256, 2),
                                     (100, 4)])
def test_geometry_and_pad_packs_match_the_reference(width, p):
    assert pack_geometry(width, p) == jpc.pack_geometry(width, p)
    x, w, b = _case(width, (1, 2, width, 4), 8)
    xp = pack_input(torch.from_numpy(x), p)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(jpc.pack_input(jnp.asarray(x), p)))
    y = pack_conv3x3(xp, *_t(w, b), p, width, "lrelu")
    full = y.reshape(1, 2, -1, 8)
    _, pad_l, _ = pack_geometry(width, p)
    assert not full[:, :, :pad_l].any()
    assert not full[:, :, pad_l + width:].any()


def test_cpu_wrapper_counts_no_launch_and_checks_shapes():
    x, w, b = _case(5, (1, 4, 16, 8), 8)
    tx, tw, tb = _t(x, w, b)
    xp = pack_input(tx, 2)
    before = pack_conv3x3.launches
    assert torch.equal(pack_conv3x3(xp, tw, tb, 2, 16),
                       pairconv.pack_conv3x3_reference(xp, tw, tb, 2, 16))
    assert pack_conv3x3.launches == before
    with pytest.raises(ValueError, match="xp"):
        pack_conv3x3(xp[..., :-1], tw, tb, 2, 16)
    with pytest.raises(ValueError, match="act"):
        pack_conv3x3(xp, tw, tb, 2, 16, "gelu")
