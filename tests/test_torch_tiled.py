"""The port's tiled inference and public API (superresolution_tpu_torch/
infer/tiled.py, infer/tiled_device.py: make_tiled_infer /
upscale_on_device, api.py) against the JAX package's on the CPU, in f32:
tiled_apply with the same map on each side (crop and hann blends, edge
and zero pads, a ragged tail batch) within 1e-6, and both tilers of
api.upscale over a tiny hybrid whose HAT stage runs kernel 10 (flash
attention; its plain form here, the JAX kernel in interpret mode) within
1e-5 of max |ref|."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superresolution_tpu import api as japi
from superresolution_tpu.infer import tiled as jtiled
from superresolution_tpu.models import HATLite as JaxHATLite
from superresolution_tpu.models import HybridSR as JaxHybridSR
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu_torch import api
from superresolution_tpu_torch.infer import tiled, tiled_device
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.models.hybrid import HybridSR
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from test_torch_hat_lite import jax_variables

S1 = dict(scale=2, in_channels=1, out_channels=1, features=8, num_blocks=1,
          growth=4, upsampler="pixelshuffle")
S2 = dict(scale=2, in_channels=1, out_channels=1, embed_dim=12,
          depths=(2, 2), num_heads=(3, 3), window_size=4, upsample_feat=8,
          flash_attn=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


W3 = np.random.default_rng(7).standard_normal((3, 3, 2, 2)).astype(
    np.float32) * 0.3


def _jax_fn(x):
    """3x3 SAME conv (2 channels) + tanh, then nearest x2: mixes
    neighbours, so a wrong halo or pad shows."""
    y = jax.lax.conv_general_dilated(x, jnp.asarray(W3), (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO",
                                                        "NHWC"))
    return jnp.repeat(jnp.repeat(jnp.tanh(y), 2, 1), 2, 2)


def _torch_fn(x):
    w = torch.from_numpy(W3).permute(3, 2, 0, 1)
    y = torch.tanh(F.conv2d(x.permute(0, 3, 1, 2), w, padding=1))
    return y.repeat_interleave(2, 2).repeat_interleave(2, 3).permute(
        0, 2, 3, 1)


@pytest.mark.parametrize("blend", ["crop", "hann"])
@pytest.mark.parametrize("pad_mode", ["edge", "zero"])
def test_tiled_apply_matches_jax(blend, pad_mode):
    """37 x 29 in 16-tiles: 3 x 2 = 6 tiles in batches of 4 (a ragged,
    zero-padded tail)."""
    img = np.random.default_rng(0).random((37, 29, 2), np.float32)
    kw = dict(tile=16, halo=4, batch=4, blend=blend, pad_mode=pad_mode)
    seen = []

    def fn(x):
        seen.append(tuple(x.shape))
        return _torch_fn(x)

    ref = jtiled.tiled_apply(_jax_fn, img, 2, **kw)
    got = tiled.tiled_apply(fn, img, 2, device="cpu", **kw)
    assert seen == [(4, 24, 24, 2)] * 2
    assert got.shape == (74, 58, 2) and got.dtype == np.float32
    assert _rel(got, ref) < 1e-6
    # an HW image comes back HW
    one = tiled.tiled_apply(lambda x: _torch_fn(x.expand(-1, -1, -1, 2))
                            [..., :1], img[..., 0], 2, device="cpu", **kw)
    assert one.shape == (74, 58)


def test_make_tiled_infer_matches_host_tiler():
    """The on-device runner (edge pad, crop) against the host tiler on the
    same map, and its last batch filled with tile 0."""
    img = np.random.default_rng(1).random((37, 29, 2), np.float32)
    run = tiled_device.make_tiled_infer(_torch_fn, 2, 16, 4, 4, 37, 29, 2,
                                        device="cpu")
    host = tiled.tiled_apply(_torch_fn, img, 2, tile=16, halo=4, batch=4,
                             device="cpu")
    np.testing.assert_array_equal(run(torch.from_numpy(img)).numpy(), host)
    with pytest.raises(ValueError, match="image"):
        run(torch.zeros(36, 29, 2))


@functools.lru_cache(maxsize=None)
def _hybrid():
    jm = JaxHybridSR(stage1=JaxRRDBNet(**S1), stage2=JaxHATLite(**S2),
                     output_size=None, smoothing="balanced")
    variables = jax_variables(jm, (1, 24, 24, 1), seed=3)
    # stage 2's conv_last / 20: the random model's output (|y| up to ~17)
    # then lies mostly inside [0, 1], where the clip does not hide it
    last = variables["params"]["stage2"]["Conv_2"]["Conv_0"]
    last["kernel"] = last["kernel"] / 20
    sd = convert.hybrid_state_dict_from_jax(
        variables, num_blocks=1, features=8, growth=4, depths=S2["depths"])
    tm = HybridSR(RRDBNet(**S1, device="cpu"), HATLite(**S2, device="cpu"),
                  output_size=None, smoothing="balanced")
    return jm, variables, sd, tm


IMG = np.random.default_rng(2).random((20, 28), np.float32)
UP = dict(tile=16, halo=4, batch=4, precision="fp32")


@functools.lru_cache(maxsize=None)
def _jax_upscale():
    """JAX's api.upscale of IMG on its on-device tiler: 2 x 2 tiles in
    one batch of 4, so the host tiler's batches are the same ones."""
    jm, variables, _, _ = _hybrid()
    return np.asarray(japi.upscale(IMG, 4, model=jm, params=variables,
                                   on_device=True, **UP))


@pytest.mark.parametrize("on_device", [False, True])
def test_api_upscale_flash_hybrid_matches_jax(on_device):
    """A 20 x 28 image in 16-tiles with halo 4, x4, f32; both of the
    port's tilers against the JAX API's (one JAX compile serves both)."""
    _, _, sd, tm = _hybrid()
    ref = _jax_upscale()
    got = api.upscale(IMG, 4, model=tm, params=sd, on_device=on_device,
                      device="cpu", **UP)
    got = got.numpy() if on_device else got
    assert got.shape == (80, 112) and ref.shape == got.shape
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert _rel(got, ref) < 1e-5


def test_upscale_on_device_leaves_model_as_is():
    """The weights go in through functional_call in the compute type:
    the module keeps its own f32 parameters, and bf16 runs."""
    _, _, sd, tm = _hybrid()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    img = torch.from_numpy(
        np.random.default_rng(3).random((16, 16, 1), np.float32))
    out = tiled_device.upscale_on_device(img, 4, tm, sd, tile=16, halo=4,
                                         batch=1, device="cpu")
    assert out.shape == (64, 64, 1) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    for k, v in tm.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k])


def test_api_rejects_host_options_on_device():
    for k in ("blend", "pad_mode"):
        with pytest.raises(ValueError, match="host tiler only"):
            api.upscale(np.zeros((8, 8), np.float32), 2, on_device=True,
                        device="cpu", **{k: "crop"})


def test_api_builds_a_registry_model():
    """model=None builds the registry's rrdbnet with the image's channels
    and its random initialization (smoke use only)."""
    out = api.upscale(np.zeros((12, 12, 3), np.float32), 4, tile=8, halo=2,
                      batch=4, device="cpu", features=8, num_blocks=1,
                      growth=4, upsampler="pixelshuffle")
    assert out.shape == (48, 48, 3)
    assert isinstance(api.build_model("rrdbnet", device="cpu", features=8,
                                      num_blocks=1, growth=4), RRDBNet)
