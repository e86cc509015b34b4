"""B1 (superresolution_tpu_torch/ops/dense_trunk.py) and the fused trunk
(infer/fused_trunk.py) of the PyTorch port against the JAX package's
fused_dense_block (Pallas, interpret mode) and make_fused_trunk, on the
same numpy-seeded inputs and weights, in f32 on the CPU (where the op runs
its plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.infer.fused_trunk import (
    make_fused_trunk as jax_make_fused_trunk,
)
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.models.rrdbnet import FusedDenseBlock as JaxFDB
from superresolution_tpu.ops.pallas_dense_trunk import (
    fused_dense_block as jax_fused_dense_block,
    pack,
    proj_weights,
    unpack,
)
from superresolution_tpu_torch.infer.common import hwio
from superresolution_tpu_torch.infer.fused_trunk import make_fused_trunk
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.rrdbnet import DenseBlock, RRDBNet
from superresolution_tpu_torch.ops.dense_trunk import (
    dense_weights,
    fused_dense_block,
)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_fused_dense_block_matches_jax_chained_with_residual():
    c, g, w = 16, 8, 20
    blk = JaxFDB(features=c, growth=g)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, w, c)).astype(np.float32)
    res = rng.standard_normal((1, 16, w, c)).astype(np.float32)
    dp = blk.init(jax.random.key(5), x)["params"]
    jw = proj_weights(dp, dtype=jnp.float32)
    ref1 = jax_fused_dense_block(pack(x), jw, width=w, rb=8, interpret=True)
    ref2 = jax_fused_dense_block(ref1, jw, width=w, rb=8, interpret=True,
                                 residual=pack(res))
    ws = dense_weights(*convert._unfuse_dense(dp, c, g), dtype=torch.float32)
    got1 = fused_dense_block(torch.from_numpy(x), ws)
    got2 = fused_dense_block(got1, ws, residual=torch.from_numpy(res))
    np.testing.assert_allclose(got1.numpy(), np.asarray(unpack(ref1, w)),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got2.numpy(), np.asarray(unpack(ref2, w)),
                               atol=1e-4, rtol=1e-4)


def test_fused_dense_block_workspace_holds_dense_features():
    c, g = 16, 8
    blk = DenseBlock(c, g, generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 12, 10, c)).astype(np.float32))
    convs = [getattr(blk, f"conv{j}") for j in range(1, 6)]
    ws = dense_weights([hwio(cv.weight.detach()) for cv in convs],
                       [torch.randn(cv.out_channels) for cv in convs],
                       dtype=torch.float32)
    for cv, (_, b) in zip(convs, ws):
        cv.bias.data.copy_(b)
    feats = [x.permute(0, 3, 1, 2)]
    with torch.no_grad():
        for cv in convs[:4]:
            feats.append(torch.nn.functional.leaky_relu(
                cv(torch.cat(feats, 1)), 0.2))
        ref = blk(feats[0]).permute(0, 2, 3, 1)
    workspace = torch.full((2, 12, 10, 4 * g), float("nan"))
    got = fused_dense_block(x, ws, workspace=workspace)
    want = torch.cat(feats[1:], 1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(workspace.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_dense_weights_types():
    ks = [np.ones((3, 3, 4 + 2 * j, 2 if j < 4 else 4), np.float32)
          for j in range(5)]
    bs = [np.ones(k.shape[-1], np.float32) for k in ks]
    ws = dense_weights(ks, bs)
    assert all(k.dtype == torch.bfloat16 and b.dtype == torch.float32
               for k, b in ws)
    with pytest.raises(ValueError):
        dense_weights(ks, bs[:4])


def _pair(seed, **kw):
    args = dict(scale=4, in_channels=3, out_channels=3, features=16,
                num_blocks=1, growth=8, upsampler="pixelshuffle")
    args.update(kw)
    jm = JaxRRDBNet(**args)
    variables = jm.init(jax.random.key(seed),
                        jnp.zeros((1, 8, 8, args["in_channels"])))
    sd = convert.rrdbnet_state_dict_from_jax(variables, num_blocks=1,
                                             features=16, growth=8)
    return jm, variables, sd, RRDBNet(**args, device="cpu")


@pytest.mark.parametrize("unshuffle", [1, 2])
def test_fused_trunk_matches_jax(unshuffle):
    kw = {} if unshuffle == 1 else dict(scale=2, pixel_unshuffle_input=2,
                                        in_channels=1, out_channels=1)
    jm, variables, sd, tm = _pair(unshuffle, **kw)
    x = np.random.default_rng(unshuffle).standard_normal(
        (1, 16, 12, tm.in_channels)).astype(np.float32)
    ref = jax_make_fused_trunk(variables, jm, interpret=True)(x)
    got = make_fused_trunk(sd, tm, device="cpu")(torch.from_numpy(x))
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-4
