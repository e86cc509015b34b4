"""Kernel 13 (superresolution_tpu_torch/ops/dense_trunk_train.py) against
the JAX package's fused_dense_block_train (Pallas forward and backward in
interpret mode), on the same numpy-seeded inputs, in f32 on the CPU:
dx, each conv's dW and db (the JAX grads mapped through _unfuse_dense)
and dres, with and without a folded residual, at row blocks None and 4.

The CUDA launch sequence of dense_block_backward cannot run here; its
orchestration (the cotangent workspace's channel layout, the flipped
weights, the lrelu' gate, the scale factors and the weight-grad offsets)
is held against autograd on both routes with each launch helper replaced
by a plain torch emulation of what its kernel computes (the direct
route's) or by its GEMM form (utils/chain_grad_forms.py, the tensor-core
route's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superresolution_tpu.models.rrdbnet import FusedDenseBlock as JaxFDB
from superresolution_tpu.ops.pallas_dense_trunk import PAD, pack, unpack
from superresolution_tpu.ops.pallas_dense_trunk_vjp import (
    fused_dense_block_train as jax_fused_dense_block_train,
    proj_weights_traced,
)
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import dense_trunk as dt
from superresolution_tpu_torch.ops import dense_trunk_train as dtt
from superresolution_tpu_torch.ops.dense_trunk import dense_weights
from superresolution_tpu_torch.utils.chain_grad_forms import (
    flip_weights_form,
    grad_conv_form,
)
from superresolution_tpu_torch.utils.dense_tail_forms import dense_conv_form


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These CPU tensors are small: intra-op threads gain nothing, and on
    a host loaded by parallel test workers their spin-waits cost several
    times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C, G = 16, 8


def _inputs(seed, h, w, b=1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, C)) * 0.5).astype(np.float32)
    res = rng.standard_normal((b, h, w, C)).astype(np.float32)
    cot = rng.standard_normal((b, h, w, C)).astype(np.float32)
    dp = JaxFDB(features=C, growth=G).init(jax.random.key(seed), x)["params"]
    return x, res, cot, dp


def _port_grads(x, res, cot, dp, with_res):
    ws = dense_weights(*convert._unfuse_dense(dp, C, G), dtype=torch.float32)
    for k, b in ws:
        k.requires_grad_(True)
        b.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(res).requires_grad_(True) if with_res else None
    out = dtt.fused_dense_block_train(xt, ws, rt)
    (out * torch.from_numpy(cot)).sum().backward()
    return (out.detach(), xt.grad, [(k.grad, b.grad) for k, b in ws],
            None if rt is None else rt.grad)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("rb", [None, 4])
def test_grads_match_jax_fused_train(with_res, rb):
    h, w = 16, 20
    x, res, cot, dp = _inputs(3 + 2 * with_res, h, w)
    xp, resp, cotp = pack(x), pack(res), pack(cot)

    def loss(dp_, xp_, r_):
        ws = proj_weights_traced(dp_, jnp.float32)
        y = jax_fused_dense_block_train(xp_, ws, r_ if with_res else None,
                                        w, rb, True)
        return jnp.sum(y * cotp), y

    (_, yp), (gdp, gxp, gr) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(dp, xp, resp)
    out, dx, dws, dres = _port_grads(x, res, cot, dp, with_res)
    np.testing.assert_allclose(out.numpy(), np.asarray(unpack(yp, w)),
                               atol=1e-4, rtol=1e-4)
    # dx on the real columns (the reference's pad-column cotangents are
    # dropped by pack's transpose in a chain)
    np.testing.assert_allclose(dx.numpy(),
                               np.asarray(gxp)[:, :, PAD:PAD + w],
                               atol=1e-4, rtol=1e-4)
    ks, bs = convert._unfuse_dense(jax.tree.map(np.asarray, gdp), C, G)
    for j, ((dk, db), rk, rbias) in enumerate(zip(dws, ks, bs), 1):
        np.testing.assert_allclose(dk.numpy(), rk, atol=1e-4, rtol=1e-4,
                                   err_msg=f"dW{j}")
        np.testing.assert_allclose(db.numpy(), rbias, atol=1e-4, rtol=1e-4,
                                   err_msg=f"db{j}")
    if with_res:
        np.testing.assert_allclose(dres.numpy(),
                                   np.asarray(unpack(gr, w)), atol=1e-6)


def _emu_conv3x3(in0, cin0, w, bias, out, out_off, cout, *, geom, in1=None,
                 cin1=0, lrelu=False, gelu=False, gate=None,
                 gate_off=0, add=None, add_scale=1.0, xres=None, res=None):
    assert not gelu
    src = [in0[..., :cin0]] + ([in1[..., :cin1]] if cin1 else [])
    v = F.conv2d(torch.cat(src, -1).permute(0, 3, 1, 2),
                 w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        v = v + bias
    if lrelu:
        v = F.leaky_relu(v, 0.2)
    if gate is not None:
        v = torch.where(gate[..., gate_off:gate_off + cout] > 0, v, 0.2 * v)
    if add is not None:
        v = v + add_scale * add
    if xres is not None:
        v = xres + 0.2 * v
    if res is not None:
        v = res + 0.2 * v
    out[..., out_off:out_off + cout] = v


def _emu_wgrad(in0, cin0, in1, cin1, d, d_off, cout, dw, db):
    src = [in0[..., :cin0]] + ([in1[..., :cin1]] if cin1 else [])
    inp = torch.cat(src, -1).permute(0, 3, 1, 2)
    dd = d[..., d_off:d_off + cout].permute(0, 3, 1, 2)
    gw = torch.nn.grad.conv2d_weight(inp, (cout, inp.shape[1], 3, 3), dd,
                                     padding=1)
    dw.copy_(gw.permute(2, 3, 1, 0))
    db.copy_(dd.sum((0, 2, 3)))


def _emu_scale(src, scale, out):
    out[..., :src.shape[-1]] = scale * src


@pytest.mark.parametrize("route", ["direct", "tc"])
@pytest.mark.parametrize("with_res", [False, True])
def test_backward_launch_sequence_matches_autograd(monkeypatch, with_res,
                                                   route):
    """The whole call on either route, picked by forcing
    ops/dense_trunk.uses_tensor_cores: the direct convs' emulations, or
    the tensor-core launches' GEMM forms (B1's recompute, the flipped
    weights in one launch and the transposed convs,
    utils/chain_grad_forms.py; the weight grads' emulation either way)."""
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "conv3x3", _emu_conv3x3)
    monkeypatch.setattr(_build, "dense_conv", dense_conv_form)
    monkeypatch.setattr(_build, "grad_conv", grad_conv_form)
    monkeypatch.setattr(_build, "flip_weights", flip_weights_form)
    monkeypatch.setattr(dt, "uses_tensor_cores",
                        lambda x, c, g: route == "tc")
    monkeypatch.setattr(_build, "wgrad", _emu_wgrad)
    monkeypatch.setattr(_build, "wgrad_tc", _emu_wgrad)
    monkeypatch.setattr(_build, "dense_scale", _emu_scale)
    x, res, cot, dp = _inputs(11 + with_res, 10, 13, b=2)
    _, dx_ref, dws_ref, dres_ref = _port_grads(x, res, cot, dp, with_res)
    ws = dense_weights(*convert._unfuse_dense(dp, C, G), dtype=torch.float32)
    before = dtt.dense_block_backward.launches
    tc = dt.fused_dense_block.tc_launches
    k13_tc = dtt.dense_block_backward.tc_launches
    dx, dws, dres = dtt.dense_block_backward(
        torch.from_numpy(x), ws, torch.from_numpy(res) if with_res else None,
        torch.from_numpy(cot))
    assert dtt.dense_block_backward.launches == before + 1
    assert dt.fused_dense_block.tc_launches == tc + (4 if route == "tc"
                                                     else 0)
    assert dtt.dense_block_backward.tc_launches == k13_tc + (
        route == "tc")
    torch.testing.assert_close(dx, dx_ref, atol=1e-4, rtol=1e-4)
    for (dk, db), (rk, rbias) in zip(dws, dws_ref):
        torch.testing.assert_close(dk, rk, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(db, rbias, atol=1e-4, rtol=1e-4)
    if with_res:
        torch.testing.assert_close(dres, dres_ref)
    else:
        assert dres is None


def test_flipped_weights_layout():
    ws = [(torch.randn(3, 3, C + j * G, G if j < 4 else C),
           torch.zeros(G if j < 4 else C)) for j in range(5)]
    wt = dtt.flipped_weights(ws, 2)  # into y_2: convs 5, 4, 3
    assert wt.shape == (3, 3, C + 2 * G, G)
    k5 = ws[4][0]
    torch.testing.assert_close(wt[0, 2, :C, :],
                               k5[2, 0, C + G:C + 2 * G, :].T)
    torch.testing.assert_close(wt[1, 1, C + G:, :],
                               ws[2][0][1, 1, C + G:C + 2 * G, :].T)
    assert dtt.flipped_weights(ws, 0).shape == (3, 3, 4 * G + C, C)


def test_cuda_backward_raises_on_cpu_tensors():
    x, res, cot, dp = _inputs(0, 4, 4)
    ws = dense_weights(*convert._unfuse_dense(dp, C, G))
    with pytest.raises(ValueError, match="CUDA"):
        dtt.dense_block_backward(torch.from_numpy(x).bfloat16(), ws, None,
                                 torch.from_numpy(cot).bfloat16())


def _dtype_checked(*tensors, dtype=torch.bfloat16, name):
    """_build.require_cuda's type rule without its device rule."""
    for t in tensors:
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")


def _spy(calls: list, name: str, fn):
    """fn, recording (name, the type of its first tensor argument)."""
    def run(*args, **kw):
        t = next(a for a in args if isinstance(a, torch.Tensor))
        calls.append((name, t.dtype))
        return fn(*args, **kw)
    return run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_follows_the_activation_type(monkeypatch, dtype):
    """Unforced routes under require_cuda's type rule: f32 activations
    (precision "fp32") take the conv engine's direct body for B1's
    launches and kernel 13's transposed convs, and the f32 weight grads,
    with no TypeError; bf16 at C and G multiples of 8 still takes the
    tensor cores. Each helper is a torch emulation of its kernel."""
    calls = []
    monkeypatch.setattr(_build, "require_cuda", _dtype_checked)
    for name, fn in (("conv3x3", _emu_conv3x3),
                     ("dense_conv", dense_conv_form),
                     ("grad_conv", grad_conv_form),
                     ("flip_weights", flip_weights_form),
                     ("wgrad", _emu_wgrad), ("wgrad_tc", _emu_wgrad),
                     ("dense_scale", _emu_scale)):
        monkeypatch.setattr(_build, name, _spy(calls, name, fn))
    x, res, cot, dp = _inputs(31, 10, 13, b=2)
    ws = dense_weights(*convert._unfuse_dense(dp, C, G), dtype=dtype)
    xt, rt, dout = (torch.from_numpy(a).to(dtype) for a in (x, res, cot))
    b1 = {k: getattr(dt.fused_dense_block, k)
          for k in ("launches", "tc_launches", "direct_launches")}
    k13 = {k: getattr(dtt.dense_block_backward, k)
           for k in ("tc_launches", "direct_launches")}
    out = torch.empty_like(xt)
    dt.dense_block_launches(xt, ws, rt, torch.empty((2, 10, 13, 4 * G),
                                                   dtype=dtype), out)
    dx, dws, dres = dtt.dense_block_backward(xt, ws, rt, dout)
    names = {n for n, _ in calls}
    assert {t for _, t in calls} == {dtype}
    tc = dtype == torch.bfloat16
    assert names == ({"dense_conv", "grad_conv", "flip_weights", "wgrad_tc",
                      "dense_scale"} if tc else
                     {"dense_conv", "grad_conv", "wgrad", "dense_scale"})
    # B1's five forward launches and the backward's four of the recompute
    assert dt.fused_dense_block.launches == b1["launches"] + 9
    body = "tc_launches" if tc else "direct_launches"
    assert getattr(dt.fused_dense_block, body) == b1[body] + 9
    assert getattr(dtt.dense_block_backward, body) == k13[body] + 1
    if tc:
        return
    out_ref, dx_ref, dws_ref, dres_ref = _port_grads(x, res, cot, dp, True)
    torch.testing.assert_close(out, out_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dx, dx_ref, atol=1e-4, rtol=1e-4)
    for (dk, db), (rk, rbias) in zip(dws, dws_ref):
        assert dk.dtype == torch.float32
        torch.testing.assert_close(dk, rk, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(db, rbias, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dres, dres_ref)
