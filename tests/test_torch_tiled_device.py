"""The port's on-device tiled runner
(superresolution_tpu_torch/infer/tiled_device.py) against the JAX
package's make_tiled_infer_staged, with the same trunk/tail functions on
each side: exact for simple maps (edge padding, ragged grids, trunk and
tail chunking), and 1e-4 relative with a small fused RRDBNet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.infer import tiled_device as jtiled
from superresolution_tpu.infer.fused_trunk import (
    make_fused_trunk as jax_make_fused_trunk,
)
from superresolution_tpu.infer.phase_tail import (
    make_phase_tail as jax_make_phase_tail,
)
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu_torch.infer.fused_trunk import make_fused_trunk
from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
from superresolution_tpu_torch.infer.tiled_device import (
    make_tiled_infer_staged,
)
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.rrdbnet import RRDBNet


@pytest.mark.parametrize("h,w,tile,halo,tail_batch,trunk_batch", [
    (37, 29, (16, 12), 3, 4, None),
    (20, 24, 8, 2, 3, 5),
])
def test_tiling_matches_jax(h, w, tile, halo, tail_batch, trunk_batch):
    """Position-dependent maps expose any misplaced tile or halo."""
    img = np.random.default_rng(0).standard_normal((h, w, 2)) \
        .astype(np.float32)

    def j_trunk(x):
        return x * 2.0 + jnp.arange(x.shape[2], dtype=x.dtype)[:, None] * .1

    def j_tail(f):
        return jnp.repeat(jnp.repeat(f, 2, axis=1), 2, axis=2)[..., :1] + 1

    def t_trunk(x):
        return x * 2.0 + torch.arange(x.shape[2], dtype=x.dtype)[:, None] * .1

    def t_tail(f):
        return f.repeat_interleave(2, 1).repeat_interleave(2, 2)[..., :1] + 1

    kw = dict(scale=2, tile=tile, halo=halo, tail_batch=tail_batch, h=h,
              w=w, channels=2, trunk_batch=trunk_batch)
    ref = jtiled.make_tiled_infer_staged(j_trunk, j_tail, **kw)(img)
    got = make_tiled_infer_staged(t_trunk, t_tail, device="cpu", **kw)(img)
    assert got.shape == ref.shape == (2 * h, 2 * w, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    run_trunk, run_tail = make_tiled_infer_staged(
        t_trunk, t_tail, device="cpu", split_stages=True, **kw)
    np.testing.assert_array_equal(run_tail(run_trunk(img)).numpy(),
                                  got.numpy())


def test_tiled_fused_rrdbnet_matches_jax():
    jm = JaxRRDBNet(scale=4, in_channels=3, out_channels=3, features=16,
                    num_blocks=1, growth=8, upsampler="pixelshuffle")
    variables = jm.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    sd = convert.rrdbnet_state_dict_from_jax(variables, num_blocks=1,
                                             features=16, growth=8)
    tm = RRDBNet(scale=4, features=16, num_blocks=1, growth=8,
                 upsampler="pixelshuffle", device="cpu")
    img = np.random.default_rng(1).random((48, 40, 3), np.float32)
    kw = dict(scale=4, tile=(16, 20), halo=4, tail_batch=2, h=48, w=40,
              channels=3)
    ref = jtiled.make_tiled_infer_staged(
        jax_make_fused_trunk(variables, jm, interpret=True),
        jax_make_phase_tail(variables, clip=False, interpret=True), **kw)(img)
    got = make_tiled_infer_staged(
        make_fused_trunk(sd, tm, device="cpu"),
        make_phase_tail(sd, clip=False, device="cpu"), device="cpu",
        **kw)(img)
    assert got.shape == ref.shape == (192, 160, 3)
    ref = np.asarray(ref)
    assert np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref)) < 1e-4


def test_tiled_runner_rejects_wrong_image():
    run = make_tiled_infer_staged(lambda x: x, lambda f: f, scale=1,
                                  tile=4, halo=1, tail_batch=1, h=8, w=8,
                                  channels=1, device="cpu")
    with pytest.raises(ValueError):
        run(torch.zeros(8, 9, 1))
