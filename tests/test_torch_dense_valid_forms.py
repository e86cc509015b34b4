"""Kernel 16 on the conv engine's tensor-core body (superresolution_tpu_
torch/ops/csrc/dense_valid_kernels.cu, policy DenseStage) in its GEMM
form (utils/dense_valid_forms.py), on the CPU.

The CUDA body runs only on the card; dense_stage_form repeats one
launch: stage j's region of the padded frame, the im2col window of x
(zero outside the image) and the workspace's y_1..y_{j-1}, times the
stage's K-major weights from ops/dense_valid.pack_stage_weights, f32
sums, finish (lrelu, or x + 0.2 v at stage 5), one rounding. Put in
_build.dense_valid_tc's place, it runs the wrapper's launch sequence
(dense_valid.dense_valid_launches) on CPU tensors, which is held against
the reference's fused_dense_block_pallas in interpret mode
(superresolution_tpu/ops/pallas_dense.py:135) on small, ragged shapes:
widths that are not multiples of the engine's 16-column tiles and
heights not multiples of its 8-row tiles at every stage.

Bars, of max |ref|: 1e-5 in f32 against the Pallas kernel; 0.02 in bf16
against the plain form in f32 on the same bf16 values (chip_smoke.py's
bar for kernel 16); the two faults chip_smoke.py plants in the kernel
must miss that bar by 3x (the intermediates zeroed outside the image
judged on the 5-px border, the residual scale dropped on the whole
image). The workspace starts as NaN, so a stage that read a pixel no
earlier stage wrote would show."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_tpu.models.rrdbnet import FusedDenseBlock as JaxFDB
from superresolution_tpu.ops.pallas_dense import (
    fused_dense_block_pallas,
    pack_fused_weights as jax_pack_fused_weights,
)
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import dense_trunk as dt
from superresolution_tpu_torch.ops import dense_valid as dv
from superresolution_tpu_torch.utils.dense_valid_forms import (
    dense_stage_form,
)

TOL, F32_TOL, MARGIN = 0.02, 1e-5, 3
# (B, H, W, c, g, th): ragged against 8 x 16 tiles at every stage
CASES = [((1, 16, 24, 16), 16, 8, 8), ((2, 8, 21, 16), 16, 8, 4)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, shape, c, g, bias_scale=0.1, init_scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    params = JaxFDB(features=c, growth=g, init_scale=init_scale).init(
        jax.random.key(seed), jnp.asarray(x))["params"]
    params = jax.tree.map(np.array, params)
    b = params["Conv_0"]["Conv_0"]["bias"]
    params["Conv_0"]["Conv_0"]["bias"] = (
        bias_scale * rng.standard_normal(b.shape)).astype(np.float32)
    return x, [np.asarray(m) for m in jax_pack_fused_weights(params, c, g)]


def _msra2(seed, shape, c, g):
    """x N(0, 1) and the projection matrices drawn directly (no JAX
    init): conv j's columns at MSRA x 2 of its fan-in, biases N(0, 0.5^2),
    so the convs make up most of the output and every bias reaches the
    border."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    mats = []
    for i in range(5):  # source i: x, then y_1..y_4; read by convs i+1..5
        rows = 9 * (c if i == 0 else g)
        mats.append(np.concatenate(
            [rng.standard_normal((rows, g if j < 5 else c))
             * 2 * np.sqrt(2 / (9 * (c + (j - 1) * g)))
             for j in range(i + 1, 6)], 1).astype(np.float32))
    bias = (0.5 * rng.standard_normal(4 * g + c)).astype(np.float32)
    return x, [*mats, bias]


def _rel(got, ref) -> float:
    got, ref = (t.float() if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.array(t, np.float32))
                for t in (got, ref))
    assert got.shape == ref.shape
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max())


def _border(t, k=5):
    keep = torch.ones(t.shape[1:3], dtype=torch.bool)
    keep[k:-k, k:-k] = False
    return t[:, keep]


class _Launches:
    """_build's two kernel-16 helpers as emulations that log their calls;
    require_cuda's device rule off."""

    def __init__(self, monkeypatch, plant=0):
        self.calls = []
        monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
        monkeypatch.setattr(_build, "dense_valid_tc", self._tc)
        monkeypatch.setattr(_build, "dense_valid_stage", self._direct)
        self.plant = plant

    def _tc(self, x, ws, out, wk, bias, j, plant=0):
        self.calls.append(("tc", j))
        dense_stage_form(x, ws, out, wk, bias, j, plant | self.plant)

    def _direct(self, x, ws, out, mats, bias, j, plant=0):
        # the direct body computes the same stage from the matrices in
        # place: the emulation reads them through the same gathering
        self.calls.append(("direct", j))
        dense_stage_form(x, ws, out, dv.pack_stage_weights(*mats)[j - 1],
                         bias, j, plant | self.plant)


def _run(x, mats, bias, stages=None):
    """dense_valid_launches on CPU tensors with a NaN workspace."""
    real = torch.empty

    def nan_empty(*shape, **kw):
        t = real(*shape, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    g = (mats[0].shape[1] - x.shape[-1]) // 4
    torch.empty = nan_empty
    try:
        return dv.dense_valid_launches(x, mats, bias, g, stages)
    finally:
        torch.empty = real


def _torch(ms, dtype=torch.float32):
    return [torch.from_numpy(m).to(dtype) for m in ms[:5]], torch.from_numpy(
        ms[5]).float()


@pytest.mark.parametrize("shape,c,g,th", CASES)
def test_stage_form_matches_pallas_f32(monkeypatch, shape, c, g, th):
    """The tensor-core route's five stages (forced for f32) against the
    reference's kernel in interpret mode, over the whole image."""
    x, ms = _case(th + shape[2], shape, c, g)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_dense_block_pallas(
            jnp.asarray(x), *[jnp.asarray(m) for m in ms], th=th))
    launches = _Launches(monkeypatch)
    monkeypatch.setattr(dt, "uses_tensor_cores", lambda *a: True)
    mats, bias = _torch(ms)
    got = _run(torch.from_numpy(x), mats, bias)
    assert launches.calls == [("tc", j) for j in range(1, 6)]
    assert _rel(got, ref) < F32_TOL
    assert _rel(_border(got), _border(torch.from_numpy(np.array(ref)))) < F32_TOL


@pytest.mark.parametrize("shape,c,g,th", CASES)
def test_stage_form_bf16_within_the_bar(monkeypatch, shape, c, g, th):
    """bf16 on the route by itself (c, g multiples of 8), at MSRA x 2 so
    the convs make up most of the output, against the plain form in f32
    on the same bf16 values, whole image and border."""
    x, ms = _msra2(th + shape[2] + 1, shape, c, g)
    _Launches(monkeypatch)
    bf = torch.bfloat16
    mats, bias = _torch(ms, bf)
    xb = torch.from_numpy(x).to(bf)
    got = _run(xb, mats, bias)
    assert got.dtype == bf
    ref = dv.fused_dense_block_valid_reference(
        xb.float(), *[m.float() for m in mats], bias)
    assert _rel(got, ref) < TOL
    assert _rel(_border(got), _border(ref)) < TOL


@pytest.mark.parametrize("fault,judge", [
    (_build.PLANT_SAME, _border), (_build.PLANT_NO_SCALE, lambda t: t)])
def test_planted_faults_miss_by_three_bars(monkeypatch, fault, judge):
    shape, c, g, _ = CASES[0]
    x, ms = _msra2(11, shape, c, g)
    _Launches(monkeypatch, plant=fault)
    bf = torch.bfloat16
    mats, bias = _torch(ms, bf)
    xb = torch.from_numpy(x).to(bf)
    bad = _run(xb, mats, bias)
    ref = dv.fused_dense_block_valid_reference(
        xb.float(), *[m.float() for m in mats], bias)
    assert _rel(judge(bad), judge(ref)) > MARGIN * TOL


def _stage_weight(mats, c, g, j, tap, ci, o):
    """DenseStage::weight (dense_valid_kernels.cu) as the direct body
    reads it: flat indexing into the projection matrices."""
    cols = [4 * g + c, 3 * g + c, 2 * g + c, g + c, c]
    if ci < c:
        return mats[0].reshape(-1)[(tap * c + ci) * cols[0] + (j - 1) * g + o]
    i = (ci - c) // g + 1
    ch = (ci - c) - (i - 1) * g
    return mats[i].reshape(-1)[(tap * g + ch) * cols[i] + (j - 1 - i) * g + o]


@pytest.mark.parametrize("c,g", [(16, 8), (8, 16)])
def test_pack_stage_weights_is_dense_stage_weight(c, g):
    """Every entry of every stage's K-major matrix, row tap * cin_j + ci,
    is the one DenseStage::weight reads for (tap, ci, o), bit for bit."""
    gen = torch.Generator().manual_seed(c * g)
    shapes = [(9 * c, 4 * g + c)] + [(9 * g, (4 - i) * g + c)
                                     for i in range(1, 5)]
    mats = [torch.randn(s, generator=gen).to(torch.bfloat16) for s in shapes]
    stages = dv.pack_stage_weights(*mats)
    for j, wk in enumerate(stages, 1):
        cin, cout = c + (j - 1) * g, g if j < 5 else c
        assert tuple(wk.shape) == (9 * cin, cout)
        assert wk.dtype == torch.bfloat16 and wk.is_contiguous()
        want = torch.stack([
            torch.stack([_stage_weight(mats, c, g, j, tap, ci, o)
                         for o in range(cout)])
            for tap in range(9) for ci in range(cin)])
        assert torch.equal(wk, want)


@pytest.mark.parametrize("dtype,c,g,tc", [
    (torch.bfloat16, 64, 32, True), (torch.bfloat16, 16, 8, True),
    (torch.bfloat16, 96, 40, True), (torch.float32, 64, 32, False),
    (torch.bfloat16, 36, 12, False), (torch.bfloat16, 64, 12, False),
    (torch.bfloat16, 64, 56, False)])
def test_route_rule_is_b1s(monkeypatch, dtype, c, g, tc):
    """B1's rule (dense_trunk.uses_tensor_cores) picks kernel 16's body:
    the first launch of a call goes to that body's helper."""
    x = torch.zeros(1, 2, 2, c, dtype=dtype)
    assert dt.uses_tensor_cores(x, c, g) is tc
    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "dense_valid_tc",
                        lambda *a, **k: calls.append("tc"))
    monkeypatch.setattr(_build, "dense_valid_stage",
                        lambda *a, **k: calls.append("direct"))
    mats = [torch.zeros(9 * c, 4 * g + c, dtype=dtype)] + [
        torch.zeros(9 * g, (4 - i) * g + c, dtype=dtype) for i in range(1, 5)]
    dv.dense_valid_launches(x, mats, torch.zeros(4 * g + c), g)
    assert calls == ["tc" if tc else "direct"] * 5


@pytest.mark.parametrize("dtype,c,g,body", [
    (torch.bfloat16, 16, 8, "tc"), (torch.float32, 16, 8, "direct"),
    (torch.bfloat16, 12, 4, "direct")])
def test_launch_sequence_and_counts(monkeypatch, dtype, c, g, body):
    """Five launches a call on the route's body, each counted on
    `launches` and on that body's count; the result within the bar of the
    plain form in f32."""
    x, ms = _msra2(c + g, (1, 12, 19, c), c, g)
    launches = _Launches(monkeypatch)
    mats, bias = _torch(ms, dtype)
    xt = torch.from_numpy(x).to(dtype)
    op = dv.fused_dense_block_valid
    before = (op.launches, op.tc_launches, op.direct_launches)
    got = _run(xt, mats, bias)
    assert launches.calls == [(body, j) for j in range(1, 6)]
    assert (op.launches, op.tc_launches, op.direct_launches) == (
        before[0] + 5, before[1] + 5 * (body == "tc"),
        before[2] + 5 * (body == "direct"))
    ref = dv.fused_dense_block_valid_reference(
        xt.float(), *[m.float() for m in mats], bias)
    assert _rel(got, ref) < (TOL if dtype == torch.bfloat16 else 1e-4)


def test_stages_packed_once_give_the_same_bits(monkeypatch):
    _Launches(monkeypatch)
    shape, c, g, _ = CASES[0]
    x, ms = _msra2(5, shape, c, g)
    mats, bias = _torch(ms, torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    stages = dv.pack_stage_weights(*mats)
    assert torch.equal(_run(xb, mats, bias, stages), _run(xb, mats, bias))
    with pytest.raises(ValueError, match="pack_stage_weights"):
        _run(xb, mats, bias, stages[:4] + [stages[4][:, :-8]])
