"""The port's RRDBNet (superresolution_tpu_torch/models/rrdbnet.py) equals
the JAX package's model.apply on the same weights, crossed through the
port's weight bridge: trunk, tail and forward, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.models.rrdbnet import FusedDenseBlock as JaxFDB
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.common import Conv
from superresolution_tpu_torch.models.rrdbnet import (
    DenseBlock,
    FusedDenseBlock,
    RRDBNet,
)

TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(seed=0, **kw):
    args = dict(scale=4, in_channels=3, out_channels=3, features=16,
                num_blocks=2, growth=8, upsampler="pixelshuffle")
    args.update(kw)
    jm = JaxRRDBNet(**args)
    variables = jm.init(jax.random.key(seed),
                        jnp.zeros((1, 8, 8, args["in_channels"])))
    sd = convert.rrdbnet_state_dict_from_jax(
        variables, num_blocks=args["num_blocks"],
        features=args["features"], growth=args["growth"])
    tm = RRDBNet(**args, device="cpu")
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    return jm, variables, tm


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("method", ["trunk", "forward"])
def test_rrdbnet_matches_jax_apply(method):
    jm, variables, tm = _pair()
    x = np.random.default_rng(0).standard_normal((2, 12, 10, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        got = getattr(tm, method)(torch.from_numpy(x))
    ref = jm.apply(variables, x, method=None if method == "forward"
                   else method)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_rrdbnet_tail_matches_jax_apply():
    jm, variables, tm = _pair(1)
    f = np.random.default_rng(1).standard_normal((2, 6, 5, 16)) \
        .astype(np.float32)
    with torch.no_grad():
        got = tm.tail(torch.from_numpy(f))
    ref = jm.apply(variables, f, method="tail")
    assert got.shape == (2, 24, 20, 3)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_rrdbnet_pixel_unshuffle_matches_jax():
    jm, variables, tm = _pair(2, scale=2, pixel_unshuffle_input=2,
                              in_channels=1, out_channels=1)
    x = np.random.default_rng(2).standard_normal((1, 12, 16, 1)) \
        .astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    ref = jm.apply(variables, x)
    assert got.shape == (1, 24, 32, 1)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_fused_dense_block_module_matches_jax_and_plain_block():
    c, g = 16, 8
    jb = JaxFDB(features=c, growth=g)
    x = np.random.default_rng(3).standard_normal((1, 9, 7, c)) \
        .astype(np.float32)
    dp = jb.init(jax.random.key(3), x)["params"]
    fdb = FusedDenseBlock(c, g)
    sd = {"px.weight": np.asarray(dp["Conv_0"]["Conv_0"]["kernel"]),
          "px.bias": np.asarray(dp["Conv_0"]["Conv_0"]["bias"])}
    for i in range(1, 5):
        sd[f"proj_y{i}.weight"] = np.asarray(dp[f"proj_y{i}"]["kernel"])
    fdb.load_state_dict({k: torch.from_numpy(
        v.transpose(3, 2, 0, 1).copy() if v.ndim == 4 else v.copy())
        for k, v in sd.items()}, strict=True)
    db = DenseBlock(c, g)
    ks, bs = convert._unfuse_dense(dp, c, g)
    db.load_state_dict({**{f"conv{j + 1}.weight": torch.from_numpy(
        np.ascontiguousarray(ks[j].transpose(3, 2, 0, 1))) for j in range(5)},
        **{f"conv{j + 1}.bias": torch.from_numpy(np.array(bs[j]))
           for j in range(5)}}, strict=True)
    ref = np.asarray(jb.apply({"params": dp}, x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for blk in (fdb, db):
            np.testing.assert_allclose(_np(blk(xt).permute(0, 2, 3, 1)),
                                       ref, **TOL)


def test_msra_init_is_truncated_kaiming():
    conv = Conv(64, 32, init_scale=0.1,
                generator=torch.Generator().manual_seed(0))
    w = conv.weight.detach()
    std = 0.1 * np.sqrt(2.0 / (64 * 9))
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert not conv.bias.detach().any()


def test_rrdbnet_rejects_unported_upsampler():
    with pytest.raises(ValueError, match="upsampler"):
        RRDBNet(features=8, num_blocks=1, growth=4,
                upsampler="bilinear", device="cpu")
