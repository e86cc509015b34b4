"""Row-packed training (`seg` spacer rows) in the port against the JAX
package, in f32 on the CPU:

  * train/fused_apply.pack_batch_rows / unpack_batch_rows equal the JAX
    ones;
  * the plain `seg` forms of B1 and kernel 13 (ops/dense_trunk.py,
    ops/dense_trunk_train.py) against the JAX fused_dense_block_train(...,
    seg) (Pallas forward and backward in interpret mode) at
    tests/test_dense_vjp.py's size (b 3, h 8, w 12): value, dx, each dW
    and db to 1e-4 (rtol and atol), spacer rows of the value and of dx
    exactly 0;
  * make_fused_train_apply(row_pack=True) on a 2-block, 16-feature
    RRDBNet against the JAX one through the weight bridge, value and
    every gradient to 1e-4 of the leaf's max;
  * B1's and kernel 13's CUDA launch sequences with `seg`, each launch
    helper replaced by a torch emulation of its kernel that honours the
    seg stride and valid rows, against autograd of the plain `seg` form
    (1e-4); a stride off by one, no mask (valid = stride) and a store that
    does not zero the spacer rows each move the result by far more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.models.rrdbnet import FusedDenseBlock as JaxFDB
from superresolution_tpu.ops.pallas_dense_trunk import PAD, pack
from superresolution_tpu.ops.pallas_dense_trunk_vjp import (
    fused_dense_block_train as jax_fused_dense_block_train,
    proj_weights_traced,
)
from superresolution_tpu.train.fused_apply import (
    make_fused_train_apply as jax_make_fused_train_apply,
    pack_batch_rows as jax_pack_batch_rows,
    unpack_batch_rows as jax_unpack_batch_rows,
)
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import dense_trunk as dt
from superresolution_tpu_torch.ops import dense_trunk_train as dtt
from superresolution_tpu_torch.ops.dense_trunk import (
    dense_weights,
    image_rows,
)
from superresolution_tpu_torch.train.fused_apply import (
    make_fused_train_apply,
    pack_batch_rows,
    unpack_batch_rows,
)
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
B, H, W = 3, 8, 12  # tests/test_dense_vjp.py:127's packed geometry
SEG = (H + 1, H)


def _inputs(seed, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, C)) * 0.5).astype(np.float32)
    res = rng.standard_normal((b, h, w, C)).astype(np.float32)
    cot = rng.standard_normal((b, h, w, C)).astype(np.float32)
    dp = JaxFDB(features=C, growth=G).init(jax.random.key(seed), x)["params"]
    return x, res, cot, dp


def _rows(a):
    """[b, h, ...] numpy -> the JAX packed-rows form [1, b*(h+1), ...]."""
    return jnp.pad(a, ((0, 0), (0, 1)) + ((0, 0),) * (a.ndim - 2)).reshape(
        1, a.shape[0] * (a.shape[1] + 1), *a.shape[2:])


@pytest.mark.parametrize("spacer", [1, 2])
def test_pack_unpack_match_jax(spacer):
    x = np.random.default_rng(spacer).standard_normal(
        (3, 5, 7, 4)).astype(np.float32)
    got = pack_batch_rows(torch.from_numpy(x), spacer)
    ref = jax_pack_batch_rows(jnp.asarray(x), spacer)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        unpack_batch_rows(got, 3, 5, spacer).numpy(),
        np.asarray(jax_unpack_batch_rows(ref, 3, 5, spacer)))


def _jax_seg_grads(x, res, cot, dp, with_res):
    """The JAX fused train block on packed rows (per-image packed columns,
    then rows): value, dx per image on the real columns, dp grads."""
    xp, cotp = pack(x), pack(cot)
    resp = pack(res)

    def loss(dp_, xp_, rp_):
        ws = proj_weights_traced(dp_, jnp.float32)
        y = jax_fused_dense_block_train(
            _rows(xp_), ws, _rows(rp_) if with_res else None, W, None, True,
            SEG)
        return jnp.sum(y * _rows(cotp)), y

    (_, y), (gdp, gxp, grp) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(dp, xp, resp)
    y = np.asarray(y).reshape(B, H + 1, -1, C)[:, :H, PAD:PAD + W]
    return y, np.asarray(gxp)[:, :, PAD:PAD + W], gdp, np.asarray(grp)


def _port_seg_grads(x, res, cot, dp, with_res):
    """The port's plain seg form on packed rows, through autograd: the
    packed value, the packed dx, the dW/db pairs and the packed dres."""
    ws = dense_weights(*convert._unfuse_dense(dp, C, G), dtype=torch.float32)
    for k, b in ws:
        k.requires_grad_(True)
        b.requires_grad_(True)
    xt = pack_batch_rows(torch.from_numpy(x)).requires_grad_(True)
    rt = (pack_batch_rows(torch.from_numpy(res)).requires_grad_(True)
          if with_res else None)
    out = dtt.fused_dense_block_train(xt, ws, rt, seg=SEG)
    (out * pack_batch_rows(torch.from_numpy(cot))).sum().backward()
    return (out.detach(), xt.grad, [(k.grad, b.grad) for k, b in ws],
            None if rt is None else rt.grad)


@pytest.mark.parametrize("with_res", [False, True])
def test_seg_block_matches_jax(with_res):
    x, res, cot, dp = _inputs(17 + with_res)
    ref_y, ref_dx, gdp, ref_dr = _jax_seg_grads(x, res, cot, dp, with_res)
    out, dx, dws, dres = _port_seg_grads(x, res, cot, dp, with_res)
    spacer = ~image_rows(out.shape[1], SEG)
    assert int(spacer.sum()) == B
    assert torch.equal(out[:, spacer], torch.zeros_like(out[:, spacer]))
    assert torch.equal(dx[:, spacer], torch.zeros_like(dx[:, spacer]))
    np.testing.assert_allclose(unpack_batch_rows(out, B, H).numpy(), ref_y,
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(unpack_batch_rows(dx, B, H).numpy(), ref_dx,
                               atol=1e-4, rtol=1e-4)
    ks, bs = convert._unfuse_dense(jax.tree.map(np.asarray, gdp), C, G)
    for j, ((dk, db), rk, rbias) in enumerate(zip(dws, ks, bs), 1):
        np.testing.assert_allclose(dk.numpy(), rk, atol=1e-4, rtol=1e-4,
                                   err_msg=f"dW{j}")
        np.testing.assert_allclose(db.numpy(), rbias, atol=1e-4, rtol=1e-4,
                                   err_msg=f"db{j}")
    if with_res:
        np.testing.assert_allclose(unpack_batch_rows(dres, B, H).numpy(),
                                   ref_dr[:, :, PAD:PAD + W], atol=1e-6)
        assert torch.equal(dres[:, spacer], torch.zeros_like(dres[:, spacer]))


def test_fused_apply_row_pack_matches_jax():
    kw = dict(features=16, num_blocks=2, growth=8)
    jm = JaxRRDBNet(scale=2, in_channels=1, out_channels=1, **kw)
    variables = jax.jit(jm.init)(jax.random.key(3),
                                 jnp.zeros((1, 12, 12, 1)))
    tm = RRDBNet(scale=2, in_channels=1, out_channels=1, device="cpu", **kw)
    tm.load_state_dict(convert.to_torch(convert.rrdbnet_state_dict_from_jax(
        variables, **kw)), strict=True)
    rng = np.random.default_rng(3)
    x = rng.random((2, 12, 12, 1), dtype=np.float32)
    cot = rng.standard_normal((2, 24, 24, 1)).astype(np.float32)
    japply = jax_make_fused_train_apply(jm, interpret=True, row_pack=True)

    def loss(p):
        y = japply(p, jnp.asarray(x))
        return jnp.sum(y * cot), y

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(variables)
    ref_g = convert.rrdbnet_state_dict_from_jax(
        jax.tree.map(np.asarray, grads), **kw)
    apply = make_fused_train_apply(tm, row_pack=True)
    leaves = {k: p.detach().clone().requires_grad_()
              for k, p in tm.named_parameters()}
    out = apply(leaves, torch.from_numpy(x))
    (out * torch.from_numpy(cot)).sum().backward()

    def rel(got, want):
        got = got.detach().numpy()
        return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)

    assert out.shape == (2, 24, 24, 1)
    assert rel(out, np.asarray(ref)) < 1e-4
    assert set(ref_g) == set(leaves)
    for k, v in leaves.items():
        assert rel(v.grad, ref_g[k]) < 1e-4, k


# ---- the CUDA launch sequences, each helper emulated in torch ----

def _keep(t, seg):
    """[H, 1, 1] row mask of an NHWC map (all ones without seg)."""
    return image_rows(t.shape[1], seg).to(t.dtype)[:, None, None]


def _emu_conv3x3(in0, cin0, w, bias, out, out_off, cout, *, geom, in1=None,
                 cin1=0, lrelu=False, gelu=False, gate=None,
                 gate_off=0, add=None, add_scale=1.0, xres=None, res=None,
                 seg=None, seg_plant=0):
    """sr_kernels.cu's conv3x3_kernel: spacer rows read as zero and are
    written as 0 (not with seg_plant)."""
    assert not gelu
    src = [in0[..., :cin0]] + ([in1[..., :cin1]] if cin1 else [])
    u = torch.cat(src, -1)
    keep = _keep(u, seg)
    v = F.conv2d((u * keep).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
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
    if not seg_plant:
        v = v * keep
    out[..., out_off:out_off + cout] = v


def _emu_wgrad(in0, cin0, in1, cin1, d, d_off, cout, dw, db, seg=None):
    """train_kernels.cu's wgrad_kernel: spacer rows of both inputs read as
    zero."""
    src = [in0[..., :cin0]] + ([in1[..., :cin1]] if cin1 else [])
    u = torch.cat(src, -1)
    keep = _keep(u, seg)
    inp = (u * keep).permute(0, 3, 1, 2)
    dd = (d[..., d_off:d_off + cout] * keep).permute(0, 3, 1, 2)
    gw = torch.nn.grad.conv2d_weight(inp, (cout, inp.shape[1], 3, 3), dd,
                                     padding=1)
    dw.copy_(gw.permute(2, 3, 1, 0))
    db.copy_(dd.sum((0, 2, 3)))


def _emu_scale(src, scale, out):
    out[..., :src.shape[-1]] = scale * src


def _launch_grads(x, res, cot, dp, with_res, seg, plant=0):
    """B1's launches forward, kernel 13's backward, on packed rows; dp:
    the JAX block's params or the five (kernel, bias) pairs."""
    if isinstance(dp, list):
        ws = dense_weights(*zip(*dp), dtype=torch.float32)
    else:
        ws = dense_weights(*convert._unfuse_dense(dp, C, G),
                           dtype=torch.float32)
    xt = pack_batch_rows(torch.from_numpy(x))
    rt = pack_batch_rows(torch.from_numpy(res)) if with_res else None
    dout = pack_batch_rows(torch.from_numpy(cot))
    out = torch.empty_like(xt)
    y = torch.empty((*xt.shape[:3], 4 * G))
    real = {k: getattr(_build, k) for k in ("conv3x3", "dense_conv")}
    if plant:
        for k, fn in real.items():
            setattr(_build, k,
                    lambda *a, fn=fn, **kw: fn(*a, **kw, seg_plant=plant))
    try:
        dt.dense_block_launches(xt, ws, rt, y, out, seg)
    finally:
        for k, fn in real.items():
            setattr(_build, k, fn)
    dx, dws, dres = dtt.dense_block_backward(xt, ws, rt, dout, seg)
    return out, dx, dws, dres


@pytest.fixture(params=["direct", "tc"])
def route(request, monkeypatch):
    """B1's and kernel 13's launches on the direct convs' emulations or on
    the tensor-core launches' GEMM forms (utils/dense_tail_forms.
    dense_conv_form, utils/chain_grad_forms.grad_conv_form and
    flip_weights_form), picked by forcing ops/dense_trunk.
    uses_tensor_cores."""
    monkeypatch.setattr(_build, "dense_conv", dense_conv_form)
    monkeypatch.setattr(_build, "grad_conv", grad_conv_form)
    monkeypatch.setattr(_build, "flip_weights", flip_weights_form)
    monkeypatch.setattr(dt, "uses_tensor_cores",
                        lambda x, c, g: request.param == "tc")
    return request.param


@pytest.mark.parametrize("with_res", [False, True])
def test_seg_launch_sequence_matches_autograd(monkeypatch, route, with_res):
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "conv3x3", _emu_conv3x3)
    monkeypatch.setattr(_build, "wgrad", _emu_wgrad)
    monkeypatch.setattr(_build, "wgrad_tc", _emu_wgrad)
    monkeypatch.setattr(_build, "dense_scale", _emu_scale)
    x, res, cot, dp = _inputs(23 + with_res)
    out_ref, dx_ref, dws_ref, dres_ref = _port_seg_grads(x, res, cot, dp,
                                                        with_res)
    b1, k13 = dt.fused_dense_block.launches, dtt.dense_block_backward.launches
    tc = dt.fused_dense_block.tc_launches
    out, dx, dws, dres = _launch_grads(x, res, cot, dp, with_res, SEG)
    # B1's five launches, then the backward's recompute of y_1..y_4
    assert dt.fused_dense_block.launches == b1 + 9
    assert dt.fused_dense_block.tc_launches == tc + (9 if route == "tc" else 0)
    assert dtt.dense_block_backward.launches == k13 + 1
    torch.testing.assert_close(out, out_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dx, dx_ref, atol=1e-4, rtol=1e-4)
    spacer = ~image_rows(out.shape[1], SEG)
    assert torch.equal(out[:, spacer], torch.zeros_like(out[:, spacer]))
    assert torch.equal(dx[:, spacer], torch.zeros_like(dx[:, spacer]))
    for (dk, db), (rk, rbias) in zip(dws, dws_ref):
        torch.testing.assert_close(dk, rk, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(db, rbias, atol=1e-4, rtol=1e-4)
    if with_res:
        torch.testing.assert_close(dres, dres_ref)
    else:
        assert dres is None


@pytest.mark.parametrize("fault", ["stride_h", "valid_is_stride",
                                   "spacer_not_zeroed"])
def test_seg_faults_move_the_result(monkeypatch, route, fault):
    """The three faults chip_smoke.py plants in the kernels' seg: each
    moves the packed value or dx by more than 0.06 of its max (3x the
    0.02 bar), with chip_smoke.py's check weights (MSRA x 2 kernels, so
    the convs and not the identity term make up the output) and a small
    residual."""
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "conv3x3", _emu_conv3x3)
    monkeypatch.setattr(_build, "wgrad", _emu_wgrad)
    monkeypatch.setattr(_build, "wgrad_tc", _emu_wgrad)
    monkeypatch.setattr(_build, "dense_scale", _emu_scale)
    x, res, cot, _ = _inputs(29)
    rng = np.random.default_rng(29)
    pairs = []
    for j in range(5):
        cin, cout = C + j * G, G if j < 4 else C
        pairs.append(((rng.standard_normal((3, 3, cin, cout))
                       * 2 * (2 / (9 * cin)) ** 0.5).astype(np.float32),
                      (rng.standard_normal(cout) * 0.1).astype(np.float32)))
    res = res * 0.1
    ref = _launch_grads(x, res, cot, pairs, True, SEG)
    seg, plant = {"stride_h": ((H, H - 1), 0),
                  "valid_is_stride": ((H + 1, H + 1), 0),
                  "spacer_not_zeroed": (SEG, 1)}[fault]
    got = _launch_grads(x, res, cot, pairs, True, seg, plant)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    assert max(rel(got[0], ref[0]), rel(got[1], ref[1])) > 0.06
