"""Kernel 6's and kernel 13's tensor-core launches (superresolution_tpu_torch/
ops/csrc/dense_kernels.cu rrdb_tc_kernel; train_tc_kernels.cu
DenseGradConv, wgrad_tc_kernel, flip_weights_kernel) in their GEMM form
(utils/chain_grad_forms.py), on the CPU.

The CUDA bodies run only on the card; these tests put each launch's GEMM
form in its _build helper's place and run the wrappers' own launch
sequences (ops/dense_trunk.rrdb_launch, ops/dense_trunk_train.
dense_block_backward) on CPU tensors: kernel 6's fifteen stages over its
own buffers against the reference's fused_rrdb in interpret mode, and
kernel 13's flipped weights, gated transposed convs and per-chunk weight
grads against the gradients of the reference's fused_dense_block_train
(Pallas forward and backward in interpret mode); the route rule and
the counts by body; and the faults chip_smoke.py plants in each, which
must miss the bar by 3x.

Tolerances: f32 within 1e-4 of the JAX kernels (the same f32 products
summed in another order; tests/test_torch_trunk_levers.py's and
tests/test_torch_dense_trunk_train.py's bars); bf16 within 0.02 of max
|plain in f32| for a value or dx and 0.03 for dW and db (each launch
rounds once to bf16; chip_smoke.py's bars)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.models.rrdbnet import FusedDenseBlock as JaxFDB
from superresolution_tpu.ops import pallas_dense_trunk as jpd
from superresolution_tpu.ops.pallas_dense_trunk_vjp import (
    fused_dense_block_train as jax_fused_dense_block_train,
    proj_weights_traced,
)
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import dense_trunk as dt
from superresolution_tpu_torch.ops import dense_trunk_train as dtt
from superresolution_tpu_torch.utils import chain_grad_forms as forms
from superresolution_tpu_torch.utils.dense_tail_forms import dense_conv_form
from chip_smoke import (
    CHAIN_FAULTS,
    K13_FAULTS,
    RRDB_TC_FAULTS,
    _planted_launches,
    pinned_dense_block,
)

C, G = 16, 8
TOL, TOL_DW = 0.02, 0.03
# every fault chip_smoke.py plants in kernel 6's tensor-core launch, by
# its _build bit
KERNEL6_FAULTS = {**dict(zip(CHAIN_FAULTS, ("PLANT_NO_RESIDUAL",
                                            "PLANT_SWAP_STAGES"))),
                  **RRDB_TC_FAULTS}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tc_route(monkeypatch):
    """Kernel 6's and kernel 13's launches (and B1's, which the backward's
    recompute runs) routed to the tensor-core GEMM forms on CPU tensors
    of any type."""
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "dense_conv", dense_conv_form)
    monkeypatch.setattr(_build, "rrdb_tc", forms.rrdb_tc_form)
    monkeypatch.setattr(_build, "grad_conv", forms.grad_conv_form)
    monkeypatch.setattr(_build, "flip_weights", forms.flip_weights_form)
    monkeypatch.setattr(_build, "wgrad_tc", forms.wgrad_form)
    monkeypatch.setattr(_build, "dense_scale", _scale_form)
    monkeypatch.setattr(dt, "uses_tensor_cores", lambda x, c, g: True)


def _scale_form(src, scale, out):
    """dense_scale_kernel: one rounding of scale * src."""
    out[..., :src.shape[-1]] = (scale * src.float()).to(out.dtype)


def _rel(got, ref) -> float:
    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    return float((got - ref).abs().max() / ref.abs().max())


def _jax_block(seed, c=C, g=G):
    blk = JaxFDB(features=c, growth=g)
    dp = blk.init(jax.random.key(seed), jnp.zeros((1, 8, 8, c)))["params"]
    return dp, jpd.proj_weights(dp, dtype=jnp.float32)


def _torch_block(dp, c=C, g=G, dtype=torch.float32):
    return dt.dense_weights(*convert._unfuse_dense(dp, c, g), dtype=dtype)


def _check_weights(gen, c=64, g=32, dtype=torch.float32, bias_scale=0.5):
    """chip_smoke.py's dense_check_weights: MSRA x 2 kernels (so the convs,
    not the identity term, make up the output), N(0, bias_scale^2)
    biases."""
    ks, bs = [], []
    for j in range(5):
        cin, cout = c + j * g, g if j < 4 else c
        ks.append(torch.randn(3, 3, cin, cout, generator=gen)
                  * 2 * (2 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=gen) * bias_scale)
    return dt.dense_weights(ks, bs, dtype=dtype)


# ---- kernel 6 ----

def _launch_rrdb(x, weights):
    """Kernel 6's launch through rrdb_launch, counted on the tensor-core
    body; its output."""
    g = weights[0][0].shape[-1]
    ws = torch.full((*x.shape[:3], 4 * g), float("nan"), dtype=x.dtype)
    tmp, out = torch.full_like(x, float("nan")), torch.empty_like(x)
    counts = (dt.fused_rrdb.launches, dt.fused_rrdb.tc_launches,
              dt.fused_rrdb.direct_launches)
    dt.rrdb_launch(x, weights, ws, tmp, out)
    assert (dt.fused_rrdb.launches - counts[0],
            dt.fused_rrdb.tc_launches - counts[1],
            dt.fused_rrdb.direct_launches - counts[2]) == (1, 1, 0)
    return out


def test_rrdb_stages_match_jax(tc_route):
    """f32: the fifteen stages (x -> out -> tmp -> out, the workspace
    shared) against the reference's fused_rrdb in interpret mode, and
    bitwise against three of B1's launch sequences in the same form."""
    h, w = 16, 20
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, h, w, C)) * 0.5).astype(np.float32)
    blocks = [_jax_block(20 + i) for i in range(3)]
    ref = jpd.fused_rrdb(jpd.pack(x), *(jw for _, jw in blocks), width=w,
                         rb=8, interpret=True)
    tws = [_torch_block(dp) for dp, _ in blocks]
    xt = torch.from_numpy(x)
    got = _launch_rrdb(xt, [p for ws in tws for p in ws])
    np.testing.assert_allclose(got.numpy(), np.asarray(jpd.unpack(ref, w)),
                               atol=1e-4, rtol=1e-4)
    y = xt
    for i, ws in enumerate(tws):
        o = torch.empty_like(y)
        dt.dense_block_launches(y, ws, xt if i == 2 else None,
                                torch.empty((*y.shape[:3], 4 * G)), o)
        y = o
    assert torch.equal(got, y)


def test_rrdb_stages_bf16_within_bar(tc_route):
    """bf16 at the models' widths (C 64, g 32) with chip_smoke.py's check
    weights: within 0.02 of the plain version in f32 on the same bf16
    values."""
    gen = torch.Generator().manual_seed(3)
    ws3 = [_check_weights(gen, dtype=torch.bfloat16) for _ in range(3)]
    x = (torch.randn(1, 10, 18, 64, generator=gen) * 0.2).bfloat16()
    got = _launch_rrdb(x, [p for ws in ws3 for p in ws])
    ref = dt.fused_rrdb_reference(
        x.float(), *([(k.float(), b) for k, b in ws] for ws in ws3))
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("fault", [None, *KERNEL6_FAULTS])
def test_rrdb_planted_faults_miss_by_3x(tc_route, fault):
    """chip_smoke.py's phase-16 faults in kernel 6's tensor-core launch
    (the residual dropped, the first two stages swapped, and a stage's
    reads one stage stale, as a skipped barrier or a dropped store wait
    would leave them) at its check weights, each missing the 0.02 bar
    by 3x or more."""
    gen = torch.Generator().manual_seed(11)
    ws3 = [_check_weights(gen, bias_scale=0.1) for _ in range(3)]
    x = torch.randn(1, 12, 20, 64, generator=gen) * 0.2
    flat = [p for ws in ws3 for p in ws]
    ref = dt.fused_rrdb_reference(x, *ws3)
    bit = 0 if fault is None else getattr(_build, KERNEL6_FAULTS[fault])
    out = torch.empty_like(x)
    forms.rrdb_tc_form(x, flat, torch.zeros(1, 12, 20, 128),
                       torch.zeros_like(x), out, plant=bit)
    if fault is None:
        assert _rel(out, ref) < 1e-5
    else:
        assert _rel(out, ref) > 3 * TOL


@pytest.mark.parametrize("dtype,c,g,want", [
    (torch.bfloat16, 64, 32, True), (torch.bfloat16, 16, 8, True),
    (torch.bfloat16, 24, 12, False), (torch.bfloat16, 136, 32, False),
    (torch.float32, 64, 32, False)])
def test_rrdb_route_counts_by_body(monkeypatch, dtype, c, g, want):
    """fused_rrdb's launch takes B1's route rule: the tensor-core launch
    on bf16 with C and g multiples of 8 and C + 4g <= 256, the direct
    chain otherwise, each counted on its body."""
    seen = []
    monkeypatch.setattr(_build, "rrdb_tc", lambda *a, **k: seen.append("tc"))
    monkeypatch.setattr(_build, "rrdb", lambda *a, **k: seen.append("direct"))
    x = torch.empty(1, 2, 2, c, dtype=dtype)
    counts = (dt.fused_rrdb.tc_launches, dt.fused_rrdb.direct_launches)
    dt.rrdb_launch(x, [], torch.empty(1, 2, 2, 4 * g), None, None)
    assert seen == ["tc" if want else "direct"]
    assert (dt.fused_rrdb.tc_launches - counts[0],
            dt.fused_rrdb.direct_launches - counts[1]) == (
                (1, 0) if want else (0, 1))


# ---- kernel 13 ----

def _inputs(seed, h, w, b=1, c=C, g=G):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, c)) * 0.5).astype(np.float32)
    res = rng.standard_normal((b, h, w, c)).astype(np.float32)
    cot = rng.standard_normal((b, h, w, c)).astype(np.float32)
    dp = JaxFDB(features=c, growth=g).init(jax.random.key(seed),
                                           x)["params"]
    return x, res, cot, dp


def _backward(x, ws, res, dout, seg=None):
    """Kernel 13's launch sequence, counted on the tensor-core body."""
    counts = (dtt.dense_block_backward.launches,
              dtt.dense_block_backward.tc_launches,
              dtt.dense_block_backward.direct_launches)
    got = dtt.dense_block_backward(x, ws, res, dout, seg)
    assert (dtt.dense_block_backward.launches - counts[0],
            dtt.dense_block_backward.tc_launches - counts[1],
            dtt.dense_block_backward.direct_launches - counts[2]) == (
                1, 1, 0)
    return got


@pytest.mark.parametrize("with_res", [False, True])
def test_backward_forms_match_jax_fused_train(tc_route, with_res):
    """f32: dx, each dW and db, and dres from the tensor-core launch
    sequence against the gradients of the reference's
    fused_dense_block_train (Pallas forward and backward, interpret
    mode)."""
    h, w = 16, 20
    x, res, cot, dp = _inputs(31 + with_res, h, w)
    xp, resp, cotp = jpd.pack(x), jpd.pack(res), jpd.pack(cot)

    def loss(dp_, xp_, r_):
        y = jax_fused_dense_block_train(
            xp_, proj_weights_traced(dp_, jnp.float32),
            r_ if with_res else None, w, None, True)
        return jnp.sum(y * cotp)

    gdp, gxp, gr = jax.grad(loss, argnums=(0, 1, 2))(dp, xp, resp)
    ws = _torch_block(dp)
    dx, dws, dres = _backward(torch.from_numpy(x), ws,
                              torch.from_numpy(res) if with_res else None,
                              torch.from_numpy(cot))
    np.testing.assert_allclose(dx.numpy(),
                               np.asarray(gxp)[:, :, jpd.PAD:jpd.PAD + w],
                               atol=1e-4, rtol=1e-4)
    ks, bs = convert._unfuse_dense(jax.tree.map(np.asarray, gdp), C, G)
    for j, ((dk, db), rk, rb) in enumerate(zip(dws, ks, bs), 1):
        np.testing.assert_allclose(dk.numpy(), rk, atol=1e-4, rtol=1e-4,
                                   err_msg=f"dW{j}")
        np.testing.assert_allclose(db.numpy(), rb, atol=1e-4, rtol=1e-4,
                                   err_msg=f"db{j}")
    if with_res:
        np.testing.assert_allclose(dres.numpy(),
                                   np.asarray(jpd.unpack(gr, w)), atol=1e-6)


def _autograd(x, ws, res, dout, seg=None, dtype=torch.float32):
    """Autograd through B1's plain (seg) form in f32 on x, ws, res upcast:
    (value, dx, [(dW, db)] * 5)."""
    leaves = [x.detach().float().requires_grad_()] + [
        t.detach().float().requires_grad_() for pair in ws for t in pair]
    rf = None if res is None else res.float()
    wsf = list(zip(leaves[1::2], leaves[2::2]))
    y = dt.fused_dense_block_reference(leaves[0], wsf, rf, seg=seg)
    g = torch.autograd.grad(y, leaves, dout.float())
    return y.detach(), g[0], list(zip(g[1::2], g[2::2]))


@pytest.mark.parametrize("with_res", [False, True])
def test_backward_forms_seg(tc_route, with_res):
    """With seg: the tensor-core sequence against autograd of the plain
    seg form (f32, 1e-4); dx exactly 0 on the spacer rows, though the
    cotangent is not."""
    seg = (9, 8)
    rng = np.random.default_rng(41 + with_res)
    x = torch.from_numpy(rng.standard_normal((1, 27, 10, C)).astype(
        np.float32)) * 0.5
    x[:, 8::9] = 0
    res = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    res[:, 8::9] = 0
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    dp, _ = _jax_block(43)
    ws = _torch_block(dp)
    r = res if with_res else None
    dx, dws, _ = _backward(x, ws, r, dout, seg)
    _, rdx, rws = _autograd(x, ws, r, dout, seg)
    torch.testing.assert_close(dx, rdx, atol=1e-4, rtol=1e-4)
    for (dk, db), (rk, rb) in zip(dws, rws):
        torch.testing.assert_close(dk, rk, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(db, rb, atol=1e-4, rtol=1e-4)
    spacer = ~dt.image_rows(x.shape[1], seg)
    assert torch.equal(dx[:, spacer], torch.zeros_like(dx[:, spacer]))


def _k13_ratio(x, ws, res, dout, fault=None) -> float:
    """The worst of chip_smoke.py's kernel 13 checks (dx at 0.02, each dW
    and db at 0.03; without and with res) as a multiple of its bar, with
    `fault` planted in the GEMM forms as chip_smoke.py plants it."""
    real = {}
    if fault is not None:
        attr, planted = _planted_launches(fault)
        real[attr] = getattr(_build, attr)
        setattr(_build, attr, planted)
    try:
        worst = 0.0
        for r in (None, res):
            dx, dws, _ = _backward(x, ws, r, dout)
            _, rdx, rws = _autograd(x, ws, r, dout)
            pairs = [(dx, rdx, TOL)] + [
                (a, b, TOL_DW) for (dk, db), (rk, rb) in zip(dws, rws)
                for a, b in ((dk, rk), (db, rb))]
            for a, b, tol in pairs:
                worst = max(worst, _rel(a, b) / tol)
        return worst
    finally:
        for k, fn in real.items():
            setattr(_build, k, fn)


@pytest.mark.parametrize("fault", [None, *K13_FAULTS])
def test_k13_planted_faults_miss_by_3x(tc_route, fault):
    """chip_smoke.py's phase-9 faults, re-planted on the tensor-core
    launch helpers, at its check weights (C 64, g 32): clean within the
    bars, each fault missing one by 3x or more."""
    gen = torch.Generator().manual_seed(19)
    ws = _check_weights(gen, bias_scale=0.1)
    x = torch.randn(1, 10, 12, 64, generator=gen) * 0.2
    res = torch.randn(1, 10, 12, 64, generator=gen) * 0.05
    dout = torch.randn(1, 10, 12, 64, generator=gen)
    ratio = _k13_ratio(x, ws, res, dout, fault)
    if fault is None:
        assert ratio < 0.01
    else:
        assert ratio > 3, ratio


def test_k13_bf16_within_bars(tc_route):
    """bf16 at the models' widths: dx within 0.02, dW and db within 0.03
    of autograd in f32 on the same bf16 values through B1's plain version
    with each lrelu' pinned to the kernel's own bf16 y_1..y_4
    (chip_smoke.pinned_dense_block, phase 9's reference: unpinned, a
    pre-activation that rounds to the other side of 0 flips lrelu')."""
    gen = torch.Generator().manual_seed(23)
    ws = _check_weights(gen, dtype=torch.bfloat16, bias_scale=0.1)
    x = (torch.randn(1, 8, 12, 64, generator=gen) * 0.2).bfloat16()
    dout = torch.randn(1, 8, 12, 64, generator=gen).bfloat16()
    dx, dws, _ = _backward(x, ws, None, dout)
    y = torch.empty(1, 8, 12, 128, dtype=torch.bfloat16)
    dt.dense_features(x, ws, y)
    leaves = [x.detach().float().requires_grad_()] + [
        t.detach().float().requires_grad_() for pair in ws for t in pair]
    out = pinned_dense_block(leaves[0], list(zip(leaves[1::2], leaves[2::2])),
                             None, torch.where(y.float() > 0, 1.0, 0.2))
    ref = torch.autograd.grad(out, leaves, dout.float())
    assert _rel(dx, ref[0]) < TOL
    for j, (dk, db) in enumerate(dws):
        assert _rel(dk, ref[1 + 2 * j]) < TOL_DW
        assert _rel(db, ref[2 + 2 * j]) < TOL_DW


def test_flip_weights_form_is_flipped_weights():
    """The one-launch flipped weights, split as flipped_launch splits
    them, equal flipped_weights of each source."""
    ws = [(torch.randn(3, 3, C + j * G, G if j < 4 else C),
           torch.zeros(G if j < 4 else C)) for j in range(5)]
    out = torch.empty(sum(dtt.flip_sizes(C, G)))
    forms.flip_weights_form(ws, out)
    for i, t in zip(dtt.FLIP_SOURCES, out.split(dtt.flip_sizes(C, G))):
        assert torch.equal(t, dtt.flipped_weights(ws, i).reshape(-1)), i


def test_wgrad_form_chunk_order():
    """The weight grad's partials: any chunk count gives the same sums
    within f32 rounding, and one chunk count the same bits twice."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 11, 37, 16)).astype(
        np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 11, 37, 8)).astype(
        np.float32))
    d = torch.from_numpy(rng.standard_normal((2, 11, 37, 40)).astype(
        np.float32))
    outs = []
    for n in (1, 3, 3, 8):
        dw, db = torch.empty(3, 3, 24, 8), torch.empty(8)
        forms.wgrad_form(x, 16, y, 8, d, 32, 8, dw, db, nchunk=n)
        outs.append((dw, db))
    assert torch.equal(outs[1][0], outs[2][0])
    for dw, db in outs[1:]:
        torch.testing.assert_close(dw, outs[0][0], atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(db, outs[0][1], atol=1e-4, rtol=1e-5)
    ref = torch.nn.grad.conv2d_weight(
        torch.cat([x, y], -1).permute(0, 3, 1, 2), (8, 24, 3, 3),
        d[..., 32:].permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
    torch.testing.assert_close(outs[0][0], ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,c,g,want", [
    (torch.bfloat16, 64, 32, True), (torch.bfloat16, 16, 8, True),
    (torch.bfloat16, 12, 8, False), (torch.bfloat16, 128, 40, False),
    (torch.float32, 16, 8, False)])
def test_k13_route_rule(monkeypatch, dtype, c, g, want):
    """Kernel 13 takes B1's route rule: the tensor-core helpers (flipped
    weights in one launch, grad_conv, wgrad_tc) or the direct ones,
    counted by body; f32 activations take the conv engine's direct body
    for the transposed convs (grad_conv in f32) and the f32 wgrad."""
    seen = set()
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "dense_conv", dense_conv_form)
    monkeypatch.setattr(_build, "conv3x3",
                        lambda *a, **k: seen.add("conv3x3"))
    monkeypatch.setattr(_build, "grad_conv",
                        lambda *a, **k: seen.add("grad_conv"))
    monkeypatch.setattr(_build, "flip_weights",
                        lambda *a, **k: seen.add("flip_weights"))
    monkeypatch.setattr(_build, "wgrad", lambda *a, **k: seen.add("wgrad"))
    monkeypatch.setattr(_build, "wgrad_tc",
                        lambda *a, **k: seen.add("wgrad_tc"))
    monkeypatch.setattr(_build, "dense_scale", lambda *a: None)
    monkeypatch.setattr(dt, "dense_features", lambda *a: None)
    monkeypatch.setattr(dtt, "dense_features", lambda *a: None)
    ws = [(torch.zeros(3, 3, c + j * g, g if j < 4 else c, dtype=dtype),
           torch.zeros(g if j < 4 else c)) for j in range(5)]
    x = torch.zeros(1, 2, 3, c, dtype=dtype)
    counts = (dtt.dense_block_backward.tc_launches,
              dtt.dense_block_backward.direct_launches)
    dtt.dense_block_backward(x, ws, None, x)
    direct = ({"grad_conv", "wgrad"} if dtype == torch.float32
              else {"conv3x3", "wgrad"})
    assert seen == ({"flip_weights", "grad_conv", "wgrad_tc"} if want
                    else direct)
    assert (dtt.dense_block_backward.tc_launches - counts[0],
            dtt.dense_block_backward.direct_launches - counts[1]) == (
                (1, 0) if want else (0, 1))
