"""Kernel 9 (superresolution_tpu_torch/ops/flash_oca.py): the port's
plain version against the JAX package's flash_oca_gathered in interpret
mode, on the same numpy inputs with a nonzero bias, f32 to 1e-4 of
max |ref|; and the geometry rule."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import pallas_flash_oca as joca
from superresolution_tpu_torch.ops import flash_oca


def _case(seed, b=2, h=8, w=12, c=12, nh=3, ws=4, ows=6):
    rng = np.random.default_rng(seed)
    pad = (ows - ws) // 2
    q = rng.standard_normal((b * (h // ws) * (w // ws), ws * ws, c)).astype(
        np.float32)

    def kv_map():  # zero-padded after the dense, as the OCAB pads it
        m = rng.standard_normal((b, h, w, c)).astype(np.float32)
        return np.pad(m, ((0, 0), (pad, pad), (pad, pad), (0, 0)))

    k_map, v_map = kv_map(), kv_map()
    bias = rng.standard_normal((nh, ws * ws, ows * ows)).astype(np.float32)
    return q, k_map, v_map, bias


@pytest.mark.parametrize("geom", [dict(), dict(b=1, h=12, w=8, ws=4, ows=8),
                                  dict(b=1, h=16, w=16, c=12, ws=8, ows=12)])
def test_flash_oca_gathered_matches_jax_kernel(geom):
    ws, ows = geom.get("ws", 4), geom.get("ows", 6)
    q, k_map, v_map, bias = _case(len(geom), **geom)
    ref = joca.flash_oca_gathered(jnp.asarray(q), jnp.asarray(k_map),
                                  jnp.asarray(v_map), jnp.asarray(bias), 3,
                                  ws, ows, True)
    args = [torch.from_numpy(a) for a in (q, k_map, v_map, bias)]
    got = flash_oca.flash_oca_gathered(*args, 3, ws, ows)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
    assert err < 1e-4, err
    # the bias matters at this scale, and the padded keys take part
    no_bias = flash_oca.flash_oca_gathered(
        *args[:3], torch.zeros_like(args[3]), 3, ws, ows)
    assert float((no_bias - got).abs().max()) > 1e-2


def test_oca_gather_supported_equals_jax():
    for ws, ows, h, w in itertools.product((4, 8), (5, 6, 8, 12, 17),
                                           (8, 12, 20), (8, 16)):
        assert (flash_oca.oca_gather_supported(ws, ows, h, w)
                == joca.oca_gather_supported(ws, ows, h, w))


def test_flash_oca_gathered_rejects_bad_shapes():
    q, k_map, v_map, bias = (torch.from_numpy(a) for a in _case(0))
    with pytest.raises(ValueError, match="q"):
        flash_oca.flash_oca_gathered(q[:-1], k_map, v_map, bias, 3, 4, 6)
    with pytest.raises(ValueError, match="bias"):
        flash_oca.flash_oca_gathered(q, k_map, v_map, bias[:2], 3, 4, 6)
    with pytest.raises(ValueError, match="unsupported"):
        flash_oca.flash_oca_gathered(q, k_map[:, :-1, :-1], v_map[:, :-1, :-1],
                                     torch.zeros(3, 16, 25), 3, 4, 5)
