"""The port's prebound deploy models in its tilers: api.upscale over
fused_rrdb_model and fused_hybrid_model (superresolution_tpu_torch/infer/
fused_trunk.py, fused_hat.py; infer/common.PreboundModel), on the host
tiler and the on-device one, against the JAX package's api.upscale over
its PreboundModel of the same fused models, in f32 on the CPU (the port's
kernels run their plain versions, the JAX kernels run in interpret mode).
Tolerance 1e-5 of max |ref|: the same f32 arithmetic in another order."""

import functools

import numpy as np
import pytest
import torch

from superresolution_tpu import api as japi
from superresolution_tpu.infer import fused_hat as jfused_hat
from superresolution_tpu.infer import fused_trunk as jfused_trunk
from superresolution_tpu.models import HATLite as JaxHATLite
from superresolution_tpu.models import HybridSR as JaxHybridSR
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu_torch import api
from superresolution_tpu_torch.infer.common import PreboundModel
from superresolution_tpu_torch.infer.fused_hat import fused_hybrid_model
from superresolution_tpu_torch.infer.fused_trunk import fused_rrdb_model
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.models.hybrid import HybridSR
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from test_torch_hat_lite import jax_variables

TOL = 1e-5
RRDB = dict(scale=4, in_channels=1, out_channels=1, features=8, num_blocks=1,
            growth=4, upsampler="pixelshuffle")
S1 = dict(RRDB, scale=2)
S2 = dict(scale=2, in_channels=1, out_channels=1, embed_dim=12,
          depths=(2, 2), num_heads=(3, 3), window_size=4, upsample_feat=8)
IMG = np.random.default_rng(5).random((20, 28), np.float32)
UP = dict(tile=16, halo=4, batch=4, precision="fp32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fit_last(kernel_tree, by: float) -> None:
    """Scale a conv_last kernel down so that the random model's output
    lies mostly inside [0, 1], where the tilers' clip does not hide it."""
    kernel_tree["kernel"] = kernel_tree["kernel"] / by


@functools.lru_cache(maxsize=None)
def _models(kind: str):
    """(JAX PreboundModel, the port's PreboundModel) of one tiny model
    on the same weights."""
    if kind == "rrdb":
        jm = JaxRRDBNet(**RRDB)
        variables = jax_variables(jm, (1, 8, 8, 1), seed=11)
        _fit_last(variables["params"]["conv_last"]["Conv_0"], 4.0)
        sd = convert.rrdbnet_state_dict_from_jax(variables, num_blocks=1,
                                                 features=8, growth=4)
        jp = jfused_trunk.fused_rrdb_model(variables, jm)
        tp = fused_rrdb_model(sd, RRDBNet(**RRDB, device="cpu"),
                              device="cpu")
        return jp, tp
    jm = JaxHybridSR(stage1=JaxRRDBNet(**S1), stage2=JaxHATLite(**S2),
                     output_size=None, smoothing="balanced")
    variables = jax_variables(jm, (1, 24, 24, 1), seed=12)
    _fit_last(variables["params"]["stage2"]["Conv_2"]["Conv_0"], 20.0)
    sd = convert.hybrid_state_dict_from_jax(
        variables, num_blocks=1, features=8, growth=4, depths=S2["depths"])
    tm = HybridSR(RRDBNet(**S1, device="cpu"), HATLite(**S2, device="cpu"),
                  output_size=None, smoothing="balanced")
    return (jfused_hat.fused_hybrid_model(variables, jm),
            fused_hybrid_model(sd, tm, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_upscale(kind: str) -> np.ndarray:
    """The JAX API on its on-device tiler: 2 x 2 tiles in one batch of 4,
    the same batch the host tiler runs."""
    jp, _ = _models(kind)
    return np.asarray(japi.upscale(IMG, 4, model=jp, params={},
                                   on_device=True, **UP))


@pytest.mark.parametrize("kind", ["rrdb", "hybrid"])
@pytest.mark.parametrize("on_device", [False, True])
def test_api_upscale_over_prebound_matches_jax(kind, on_device):
    _, tp = _models(kind)
    assert isinstance(tp, PreboundModel)
    ref = _jax_upscale(kind)
    got = api.upscale(IMG, 4, model=tp, params={}, on_device=on_device,
                      device="cpu", **UP)
    got = got.numpy() if on_device else got
    assert got.shape == (80, 112) == ref.shape
    assert got.min() >= 0.0 and got.max() <= 1.0
    # the clip leaves most of the frame inside (0, 1)
    assert 0.5 < float(np.mean((ref > 0) & (ref < 1)))
    err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    assert err < TOL, err


def test_prebound_model_ignores_params_and_is_callable():
    """apply(_params, x) and x -> model(x) are the bound function; the
    tilers accept params None for it, as it needs none."""
    _, tp = _models("rrdb")
    x = torch.from_numpy(IMG[None, :8, :8, None].copy())
    with torch.no_grad():
        a = tp.apply({"anything": 1}, x)
        b = tp(x)
    assert a.shape == (1, 32, 32, 1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = api.upscale(IMG[:8, :8], 4, model=tp, params=None, device="cpu",
                      tile=8, halo=2, batch=1, precision="fp32")
    assert out.shape == (32, 32)
