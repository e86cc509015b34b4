"""B1's and B2's tensor-core launches (superresolution_tpu_torch/ops/csrc/
dense_kernels.cu DenseConv, tail_kernels.cu PhaseUp) in their GEMM form
(utils/dense_tail_forms.py), on the CPU.

The CUDA bodies run only on the card; these tests put each launch's GEMM
form in its _build helper's place and run the wrappers' own launch
sequences (ops/dense_trunk.dense_block_launches, ops/phase_tail.
up2_hr_launches) on CPU tensors: B1's two-source K order, workspace
offsets, `seg` spacers and f32 residual epilogue with one rounding, and
B2's phase-major layouts with conv_up1's and conv_up2's permutations,
against the reference's Pallas kernels in interpret mode (as
tests/test_torch_dense_trunk.py and tests/test_torch_stencil_forms.py
run them) and the port's plain versions; the route rules; and the
faults chip_smoke.py plants in each, which must miss its bar by 3x.

Tolerances: f32 within 1e-4 of the Pallas kernel (the same f32 products
summed in another order; tests/test_torch_dense_trunk.py's bar), B2 + B3
through the JAX tail at tests/test_phase_tail.py's atol 3e-5 / rtol 2e-4;
bf16 within 0.02 of max |plain in f32| (each conv's output rounds once
to bf16; chip_smoke.py's bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superresolution_tpu.models.rrdbnet import FusedDenseBlock as JaxFDB
from superresolution_tpu.ops.pallas_dense_trunk import (
    fused_dense_block as jax_fused_dense_block,
    pack,
    proj_weights,
    unpack,
)
from superresolution_tpu.ops.pallas_phase_tail import (
    phase_hr_last as jax_phase_hr_last,
)
from superresolution_tpu.ops.pixel_shuffle import depth_to_space
from superresolution_tpu_torch.infer import phase_tail as infer_tail
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import dense_trunk as dt
from superresolution_tpu_torch.ops import phase_tail as pt
from superresolution_tpu_torch.ops.pixel_shuffle import (
    depth_to_space as torch_d2s,
)
from superresolution_tpu_torch.utils import dense_tail_forms as forms
from chip_smoke import B1_FAULTS  # (launch, change of dense_conv's args)

TOL = 0.02


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tc_route(monkeypatch):
    """B1's and B2's launches routed to the tensor-core body's GEMM form
    on CPU tensors of any type."""
    monkeypatch.setattr(_build, "dense_conv", forms.dense_conv_form)
    monkeypatch.setattr(_build, "up_conv", forms.up_conv_form)
    monkeypatch.setattr(dt, "uses_tensor_cores", lambda x, c, g: True)
    monkeypatch.setattr(pt, "uses_tensor_cores", lambda z, c: True)


def _rel(got, ref) -> float:
    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    return float((got - ref).abs().max() / ref.abs().max())


def _launch_b1(x, ws, res=None, seg=None):
    """B1's five launches through dense_block_launches; (out, y_1..y_4)."""
    g = ws[0][0].shape[-1]
    y = torch.full((*x.shape[:3], 4 * g), float("nan"), dtype=x.dtype)
    out = torch.empty_like(x)
    counts = (dt.fused_dense_block.launches, dt.fused_dense_block.tc_launches,
              dt.fused_dense_block.direct_launches)
    dt.dense_block_launches(x, ws, res, y, out, seg)
    assert (dt.fused_dense_block.launches - counts[0],
            dt.fused_dense_block.tc_launches - counts[1],
            dt.fused_dense_block.direct_launches - counts[2]) == (5, 5, 0)
    return out, y


def _jax_block(c, g, seed):
    blk = JaxFDB(features=c, growth=g)
    dp = blk.init(jax.random.key(seed), jnp.zeros((1, 8, 8, c)))["params"]
    return dp, proj_weights(dp, dtype=jnp.float32)


@pytest.mark.parametrize("with_res", [False, True])
def test_dense_conv_form_launches_match_jax(tc_route, with_res):
    """f32: B1's launches in the GEMM form (x, then the workspace's first
    j*g channels along K; y_j written at channel j*g) against the
    reference's fused_dense_block, and the workspace against the plain
    version's y_1..y_4."""
    c, g, h, w = 16, 8, 16, 20
    rng = np.random.default_rng(1 + with_res)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    res = rng.standard_normal((2, h, w, c)).astype(np.float32)
    dp, jw = _jax_block(c, g, 3)
    ref = jax_fused_dense_block(
        pack(x), jw, width=w, rb=8, interpret=True,
        residual=pack(res) if with_res else None)
    ws = dt.dense_weights(*convert._unfuse_dense(dp, c, g),
                          dtype=torch.float32)
    rt = torch.from_numpy(res) if with_res else None
    got, y = _launch_b1(torch.from_numpy(x), ws, rt)
    np.testing.assert_allclose(got.numpy(), np.asarray(unpack(ref, w)),
                               atol=1e-4, rtol=1e-4)
    wp = torch.empty_like(y)
    dt.fused_dense_block_reference(torch.from_numpy(x), ws, rt, workspace=wp)
    torch.testing.assert_close(y, wp, atol=1e-5, rtol=1e-5)


def _check_weights(gen, c=64, g=32, dtype=torch.float32):
    """chip_smoke.py's B1 check weights in phase 3: MSRA x 2 kernels (so
    the convs, not the identity term, make up the output), N(0, 0.5^2)
    biases."""
    ks, bs = [], []
    for j in range(5):
        cin, cout = c + j * g, g if j < 4 else c
        ks.append(torch.randn(3, 3, cin, cout, generator=gen)
                  * 2 * (2 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=gen) * 0.5)
    return dt.dense_weights(ks, bs, dtype=dtype)


def test_dense_conv_form_bf16_within_bar(tc_route):
    """bf16 at B1's widths (C 64, g 32): every launch rounds its f32 sums
    and epilogue once; the output and each y_j within 0.02 of the plain
    version in f32 on the same bf16 values."""
    gen = torch.Generator().manual_seed(5)
    ws = _check_weights(gen, dtype=torch.bfloat16)
    xb = (torch.randn(1, 16, 12, 64, generator=gen) * 0.2).bfloat16()
    rb = (torch.randn(1, 16, 12, 64, generator=gen) * 0.05).bfloat16()
    got, y = _launch_b1(xb, ws, rb)
    wp = torch.empty(y.shape)
    ref = dt.fused_dense_block_reference(
        xb.float(), [(k.float(), b) for k, b in ws], rb.float(),
        workspace=wp)
    assert _rel(got, ref) < TOL
    for j in range(4):
        sl = slice(j * 32, (j + 1) * 32)
        assert _rel(y[..., sl], wp[..., sl]) < TOL, j


def test_dense_conv_form_seg_spacers(tc_route):
    """With seg: spacer rows staged as zero and stored as 0, so the packed
    output equals the plain seg form; seg_plant 1 leaves them computed."""
    c, g, seg = 16, 8, (9, 8)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 27, 10, c)).astype(
        np.float32))
    x[:, 8::9] = 0
    res = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    dp, _ = _jax_block(c, g, 11)
    ws = dt.dense_weights(*convert._unfuse_dense(dp, c, g),
                          dtype=torch.float32)
    got, y = _launch_b1(x, ws, res, seg)
    ref = dt.fused_dense_block_reference(x, ws, res, seg=seg)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    spacer = ~dt.image_rows(x.shape[1], seg)
    assert torch.equal(got[:, spacer], torch.zeros_like(got[:, spacer]))
    assert torch.equal(y[:, spacer], torch.zeros_like(y[:, spacer]))
    out = torch.empty_like(x)
    forms.dense_conv_form(x, y, 4 * g, ws[4][0], ws[4][1], out, 0, xres=x,
                          res=res, seg=seg, seg_plant=1)
    assert float(out[:, spacer].abs().max()) > 0


@pytest.mark.parametrize("dtype,c,g,want", [
    (torch.bfloat16, 64, 32, True), (torch.bfloat16, 32, 16, True),
    (torch.bfloat16, 128, 32, True), (torch.bfloat16, 136, 32, False),
    (torch.bfloat16, 12, 8, False), (torch.bfloat16, 16, 4, False),
    (torch.float32, 64, 32, False)])
def test_dense_route_rule(dtype, c, g, want):
    assert dt.uses_tensor_cores(torch.empty(1, dtype=dtype), c, g) is want


def _b1_check_ratio(x, res, ws, fault=None) -> float:
    """The worst of chip_smoke.py's B1 checks (output, conv part, y_1..y_4;
    without and with res) as a multiple of the 0.02 bar."""
    names = ("x", "ws", "cin1", "w", "bias", "out", "out_off")
    count = [0]

    def planted(*args, **kw):
        a = dict(zip(names, args), **kw)
        if fault is not None and count[0] % 5 == B1_FAULTS[fault][0]:
            B1_FAULTS[fault][1](a)
        count[0] += 1
        forms.dense_conv_form(**a)

    real = _build.dense_conv
    _build.dense_conv = planted
    try:
        worst = 0.0
        g = ws[0][0].shape[-1]
        for r in (None, res):
            got, y = _launch_b1(x, ws, r)
            wp = torch.empty(y.shape)
            ref = dt.fused_dense_block_reference(x.float(), ws, r,
                                                 workspace=wp)
            ident, k = (x, 0.2) if r is None else (r + 0.2 * x, 0.04)
            pairs = [(got, ref), ((got - ident) / k, (ref - ident) / k)]
            pairs += [(y[..., j * g:(j + 1) * g], wp[..., j * g:(j + 1) * g])
                      for j in range(4)]
            for a, b in pairs:
                e = _rel(a, b) if bool(torch.isfinite(a).all()) else np.inf
                worst = max(worst, e / TOL)
        return worst
    finally:
        _build.dense_conv = real


@pytest.mark.parametrize("fault", [None, *B1_FAULTS])
def test_b1_planted_faults_miss_by_3x(tc_route, fault):
    """chip_smoke.py's phase-3 check weights (MSRA x 2 kernels, N(0, 0.5^2)
    biases), x N(0, 0.2^2), res N(0, 0.05^2): clean within the bar, each fault
    planted in the GEMM form's launches missing it by 3x or more."""
    gen = torch.Generator().manual_seed(13)
    ws = _check_weights(gen)
    x = torch.randn(1, 12, 20, 64, generator=gen) * 0.2
    res = torch.randn(1, 12, 20, 64, generator=gen) * 0.05
    ratio = _b1_check_ratio(x, res, ws, fault)
    if fault is None:
        assert ratio < 0.01
    else:
        assert ratio > 3, ratio


# ---- B2 ----

def test_phase_major_layouts():
    """to_phase_major puts channel f*4 + p at p*c + f, from_phase_major
    undoes it, and PhaseUp's view of a phase-major map is depth_to_space
    of the channel-layout one (the swapped view is not)."""
    z = torch.randn(2, 3, 5, 4 * 6)
    zp = pt.to_phase_major(z)
    assert torch.equal(zp[..., 2 * 6 + 4], z[..., 4 * 4 + 2])
    assert torch.equal(pt.from_phase_major(zp), z)
    want = torch_d2s(z, 2)
    assert torch.equal(forms.d2s_view(zp), want)
    assert not torch.equal(forms.d2s_view(zp, swap=True), want)
    w, b = torch.randn(3, 3, 6, 24), torch.randn(24)
    wp, bp = pt.phase_major_up2(w, b)
    assert torch.equal(wp, pt.to_phase_major(w))
    assert torch.equal(bp[6 + 1], b[4 + 1])


def _tail_inputs(rng, c, h, w):
    z1 = np.maximum(rng.standard_normal((2, h, w, 4 * c)), 0).astype(
        np.float32)
    shapes = ((3, 3, c, 4 * c), (4 * c,), (3, 3, c, c), (c,), (3, 3, c, 3),
              (3,))
    return z1, [(rng.standard_normal(s) * 0.1).astype(np.float32)
                for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up_conv_form_launches_match_jax(tc_route, dtype):
    """B2's two launches in the GEMM form on the phase-major z1 with
    conv_up2's phase-major operands, then B3's plain form, against the
    JAX phase tail's two Pallas kernels (interpret mode): f32 at the
    reference's bar, bf16 (t and y rounded once each) within 0.02."""
    from superresolution_tpu.infer import folded_tail as jfold
    from superresolution_tpu.infer.phase_tail import permute_up2

    rng = np.random.default_rng(21)
    c, h, w = 16, 6, 10
    z1, (up2_k, up2_b, hr_k, hr_b, last_k, last_b) = _tail_inputs(rng, c, h,
                                                                   w)
    kfp, b2 = permute_up2(jfold.fold_stage2_kernel(up2_k), up2_b)
    ref = np.array(depth_to_space(jax_phase_hr_last(
        jnp.asarray(z1), kfp, b2, hr_k, hr_b, last_k, last_b, width=w,
        interpret=True, rb=3), 4))
    t = [torch.from_numpy(a) for a in (up2_k, up2_b, hr_k, hr_b)]
    wp, bp = pt.phase_major_up2(t[0].to(dtype), t[1])
    z1p = pt.to_phase_major(torch.from_numpy(z1).to(dtype))
    counts = (pt.up2_hr.launches, pt.up2_hr.tc_launches)
    y = pt.up2_hr_launches(z1p, wp, bp, t[2].to(dtype), t[3])
    assert (pt.up2_hr.launches - counts[0],
            pt.up2_hr.tc_launches - counts[1]) == (2, 2)
    got = pt.conv_last_phase_reference(y.float(), torch.from_numpy(last_k),
                                       torch.from_numpy(last_b))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=2e-4)
    else:
        assert _rel(got, ref) < TOL


def test_up2_hr_layouts_agree():
    """up2_hr's plain version takes either layout of z1."""
    rng = np.random.default_rng(4)
    z1, ws = _tail_inputs(rng, 8, 5, 7)
    t = [torch.from_numpy(a) for a in ws[:4]]
    z = torch.from_numpy(z1)
    a = pt.up2_hr(z, *t)
    b = pt.up2_hr(pt.to_phase_major(z), *t, layout="phase")
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        pt.up2_hr(z, *t, layout="nchw")


def test_make_phase_tail_feeds_b2_phase_major(monkeypatch):
    """make_phase_tail permutes conv_up1 once so z1 comes out phase-major
    (lrelu commutes with the permutation), and hands B2 conv_up2's
    phase-major operands."""
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet

    m = RRDBNet(scale=4, in_channels=3, out_channels=3, features=8,
                num_blocks=1, growth=4, upsampler="pixelshuffle",
                device="cpu")
    sd = m.state_dict()
    seen = {}

    def spy(z1, up2_w, up2_b, *rest, layout="channel", up2_phase=None):
        seen.update(z1=z1, layout=layout, up2_phase=up2_phase, up2_w=up2_w,
                    up2_b=up2_b)
        return torch.zeros(z1.shape[0], 4 * z1.shape[1], 4 * z1.shape[2], 3)

    monkeypatch.setattr(infer_tail, "phase_hr_last", spy)
    feat = torch.randn(1, 5, 6, 8)
    infer_tail.make_phase_tail(sd, clip=False, device="cpu")(feat)
    z1 = F.leaky_relu(F.conv2d(feat.permute(0, 3, 1, 2),
                               sd["conv_up1.weight"], sd["conv_up1.bias"],
                               padding=1), 0.2).permute(0, 2, 3, 1)
    assert seen["layout"] == "phase"
    torch.testing.assert_close(seen["z1"], pt.to_phase_major(z1),
                               atol=1e-6, rtol=1e-6)
    wp, bp = seen["up2_phase"]
    assert torch.equal(wp, pt.to_phase_major(seen["up2_w"]))
    assert torch.equal(bp, pt.to_phase_major(seen["up2_b"]))


@pytest.mark.parametrize("dtype,c,want", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 12, False), (torch.bfloat16, 264, False),
    (torch.float32, 64, False)])
def test_up2_route_rule(dtype, c, want):
    assert pt.uses_tensor_cores(torch.empty(1, dtype=dtype), c) is want


@pytest.mark.parametrize("fault", ["PLANT_SWAP_PHASE", "PLANT_CLAMP_EDGE",
                                   "PLANT_BIAS_OFF"])
def test_b2_planted_faults_miss_by_3x(fault):
    """chip_smoke.py's B2 check (MSRA kernels, N(0, 0.5^2) biases, z1 =
    lrelu(N(0, 1)), two images, ragged tiles) with the fault in both
    launches of the GEMM form: misses the 0.02 bar by 3x."""
    gen = torch.Generator().manual_seed(17)
    c, h, w = 64, 9, 11
    z1 = F.leaky_relu(torch.randn(2, h, w, 4 * c, generator=gen), 0.2)
    tw = [torch.randn(3, 3, c, 4 * c, generator=gen) * (2 / (9 * c)) ** 0.5,
          torch.randn(4 * c, generator=gen) * 0.5,
          torch.randn(3, 3, c, c, generator=gen) * (2 / (9 * c)) ** 0.5,
          torch.randn(c, generator=gen) * 0.5]
    ref = pt.up2_hr_reference(z1, *tw)
    wp, bp = pt.phase_major_up2(*tw[:2])
    z1p = pt.to_phase_major(z1)
    plant = getattr(_build, fault)

    def run(p):
        t = torch.empty(2, 2 * h, 2 * w, 4 * c)
        forms.up_conv_form(z1p, wp, bp, t, plant=p)
        y = torch.empty(2, 4 * h, 4 * w, c)
        forms.up_conv_form(t, tw[2], tw[3], y, plant=p)
        return y

    assert _rel(run(0), ref) < 1e-5
    assert _rel(run(plant), ref) > 3 * TOL
