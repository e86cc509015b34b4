"""The port's fused train apply (superresolution_tpu_torch/train/
fused_apply.py) on a tiny hybrid_astro-shaped HybridSR (RRDBNet x2 with
the JAX default nearest-conv tail, HATLite x2, balanced smoothing),
built by both packages' factories from the same ModelConfig and crossed
through the weight bridge: its value and every parameter gradient
against the JAX make_fused_train_apply (Pallas forward and backward in
interpret mode), in f32 on the CPU, to 1e-4 of each leaf's max. The
JAX gradient tree maps through hybrid_state_dict_from_jax key for key:
the bridge is a re-layout (slices, concats, transposes), so it maps a
cotangent tree exactly as it maps the weights.

Also: remat under functional_call (the train step's bf16 cast) gives the
gradients of the plain forward, and the nearest-conv RRDBNet equals the
JAX model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.models.factory import (
    build_from_config as jax_build,
)
from superresolution_tpu.train.fused_apply import (
    make_fused_train_apply as jax_make_fused_train_apply,
)
from superresolution_tpu.utils.config import ModelConfig as JaxModelConfig
from superresolution_tpu_torch.infer.fused_trunk import make_standard_tail
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.factory import (
    build_from_config,
    total_scale,
)
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.train.fused_apply import (
    make_fused_train_apply,
    supports_fused_train,
)
from superresolution_tpu_torch.utils.config import ModelConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These CPU tensors are small: intra-op threads gain nothing, and on
    a host loaded by parallel test workers their spin-waits cost several
    times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MC = dict(name="rrdbnet", scale=2, in_channels=1, out_channels=1,
          kwargs={"features": 16, "num_blocks": 2, "growth": 8,
                  "remat": True},
          refiner="hat_lite",
          refiner_kwargs={"scale": 2, "embed_dim": 16, "depths": (2, 2),
                          "num_heads": (2, 2), "window_size": 8,
                          "remat": True},
          smoothing="balanced")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


def _pair(seed=0):
    jm = jax_build(JaxModelConfig(**MC), output_size=64)
    variables = jax.jit(jm.init)(jax.random.key(seed),
                                 jnp.zeros((1, 16, 16, 1)))
    tm = build_from_config(ModelConfig(**MC), output_size=64, device="cpu")
    sd = convert.hybrid_state_dict_from_jax(
        variables, num_blocks=2, features=16, growth=8, depths=(2, 2))
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    return jm, variables, tm


def test_fused_apply_value_and_grads_match_jax():
    jm, variables, tm = _pair()
    assert total_scale(ModelConfig(**MC)) == 4
    rng = np.random.default_rng(0)
    x = rng.random((2, 16, 16, 1), dtype=np.float32)
    cot = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    japply = jax_make_fused_train_apply(jm, interpret=True)

    def loss(p):
        y = japply(p, jnp.asarray(x))
        return jnp.sum(y * cot), y

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(variables)
    ref_g = convert.hybrid_state_dict_from_jax(
        jax.tree.map(np.asarray, grads), num_blocks=2, features=16,
        growth=8, depths=(2, 2))

    assert supports_fused_train(tm)
    apply = make_fused_train_apply(tm)
    leaves = {k: p.detach().clone().requires_grad_()
              for k, p in tm.named_parameters()}
    out = apply(leaves, torch.from_numpy(x))
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.shape == (2, 64, 64, 1)
    assert _rel(out.detach(), ref) < 1e-4
    assert set(ref_g) == set(leaves)
    for k, v in leaves.items():
        assert _rel(v.grad, ref_g[k]) < 1e-4, k


def test_fused_apply_gates():
    tm = build_from_config(ModelConfig(**MC), output_size=64, device="cpu")
    assert supports_fused_train(tm.stage1)
    # row packing (seg spacer rows) computes the per-image function
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 16, 16, 1), dtype=np.float32))
    params = {k: p.detach() for k, p in tm.named_parameters()}
    packed = make_fused_train_apply(tm, row_pack=True)(params, x)
    torch.testing.assert_close(packed, make_fused_train_apply(tm)(params, x),
                               atol=1e-5, rtol=1e-5)
    plain = RRDBNet(scale=2, in_channels=1, out_channels=1, features=8,
                    num_blocks=1, growth=4, fused_dense=False, device="cpu")
    assert not supports_fused_train(plain)
    with pytest.raises(ValueError, match="fused"):
        make_fused_train_apply(plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_under_functional_call_matches_plain(dtype):
    """The recompute sees the cast parameters of the call, not the
    module's own: the gradients equal those without remat exactly."""
    tm = build_from_config(ModelConfig(**MC), output_size=32, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    x = torch.rand((1, 8, 8, 1), generator=torch.Generator().manual_seed(2))
    grads = []
    for remat in (True, False):
        tm.stage1.remat = remat
        for layer in tm.stage2.layers:
            layer.remat = remat
        leaves = {k: p.detach().clone().requires_grad_()
                  for k, p in tm.named_parameters()}
        cast = {k: v.to(dtype) for k, v in leaves.items()}
        out = functional_call(tm, cast, (x.to(dtype),))
        g = torch.autograd.grad(out.float().square().sum(),
                                list(leaves.values()))
        grads.append(g)
    for a, b in zip(*grads):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_nearest_conv_rrdbnet_matches_jax():
    args = dict(scale=4, in_channels=3, out_channels=3, features=16,
                num_blocks=1, growth=8, upsampler="nearest_conv")
    jm = JaxRRDBNet(**args)
    variables = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 8, 8, 3)))
    tm = RRDBNet(**args, device="cpu")
    tm.load_state_dict(convert.to_torch(convert.rrdbnet_state_dict_from_jax(
        variables, num_blocks=1, features=16, growth=8)), strict=True)
    x = np.random.default_rng(3).standard_normal((2, 6, 5, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 24, 20, 3)
    assert _rel(got, ref) < 1e-4
    # the deploy path's plain tail takes the nearest-conv tail too
    feat = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 5, 4, 16)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(
            make_standard_tail(tm.state_dict(), tm, device="cpu")(feat),
            tm.tail(feat), atol=1e-5, rtol=1e-5)
