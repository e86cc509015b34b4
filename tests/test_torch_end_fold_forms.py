"""Kernels 4 and 5 on the tensor-core route (superresolution_tpu_torch/ops/
dense_trunk.py prologue_launches, epilogue_launches) in the conv engine's
GEMM forms (utils/dense_tail_forms.py), on the CPU.

The CUDA bodies run only on the card; these tests put the forms of
conv_first on the engine's direct body (first_conv_form) and of B1's and
trunk_conv's DenseConv launches (dense_conv_form, trunk_conv with its
+ head epilogue) in their _build helpers' place and run the kernels' own
launch sequences on CPU tensors: against the reference's
fused_dense_block_prologue / fused_dense_block_epilogue Pallas kernels
in interpret mode (as tests/test_torch_trunk_levers.py runs them) at Cin
3, 4 and 12, C 16, g 8 on a ragged 13 x 20 map; the route rule; the
counts (one call on the kernel's own counter, its launches by body, none
on B1's); and the faults chip_smoke.py plants in them, each of which
must miss the bar by 3x on NaN-filled scratch.

Tolerances, of max |ref|: 1e-5 in f32 against the Pallas kernels (the
same f32 products summed in another order; test_torch_trunk_levers.py's
op bar); 0.02 in bf16 against the plain version in f32 on the same bf16
values (each launch rounds its output once; chip_smoke.py's bar)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import pallas_dense_trunk as jpd
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import dense_trunk as dt
from superresolution_tpu_torch.utils import dense_tail_forms as forms
from chip_smoke import END_FOLD_FAULTS
from test_torch_trunk_levers import C, G, _block, _conv, _randn

TOL, F32_TOL = 0.02, 1e-5
H, W = 13, 20  # ragged against the engine's 8 x 16 tiles


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tc_route(monkeypatch):
    """Kernels 4 and 5 routed to the conv engine's forms on CPU tensors of
    any type."""
    monkeypatch.setattr(_build, "dense_conv", forms.dense_conv_form)
    monkeypatch.setattr(_build, "first_conv", forms.first_conv_form)
    monkeypatch.setattr(dt, "uses_tensor_cores", lambda x, c, g: True)


def _rel(got, ref) -> float:
    got, ref = (t.float() if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.array(t, np.float32))
                for t in (got, ref))
    assert got.shape == ref.shape
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max())


def _nan(*shape, dtype=torch.float32):
    return torch.full(shape, float("nan"), dtype=dtype)


OPS = (dt.fused_dense_block, dt.fused_dense_block_prologue,
       dt.fused_dense_block_epilogue)


def _counts():
    return [(op.launches, op.tc_launches, op.direct_launches) for op in OPS]


def _counted(fn, want: dict):
    """fn() with each op's (launches, tc, direct) moved by want[op name]
    and B1's by nothing."""
    before = _counts()
    fn()
    moved = [tuple(a - b for a, b in zip(x, y))
             for x, y in zip(_counts(), before)]
    assert moved == [want.get(op.__name__, (0, 0, 0)) for op in OPS], moved


def _prologue(x_raw, head_w, weights, plant=0):
    """Kernel 4's launches on NaN-filled scratch: (out, head)."""
    b, h, w, _ = x_raw.shape
    c, dtype = head_w[0].shape[-1], x_raw.dtype
    ws, out, head = (_nan(b, h, w, n, dtype=dtype) for n in (
        4 * weights[0][0].shape[-1], c, c))
    _counted(lambda: dt.prologue_launches(x_raw, head_w, weights, ws, out,
                                          head, plant=plant),
             {"fused_dense_block_prologue": (1, 5, 1)})
    return out, head


def _epilogue(x, weights, res, trunk_w, head, plant=0):
    """Kernel 5's launches on NaN-filled scratch: out."""
    ws = _nan(*x.shape[:3], 4 * weights[0][0].shape[-1], dtype=x.dtype)
    feat, out = _nan(*x.shape, dtype=x.dtype), _nan(*x.shape, dtype=x.dtype)
    _counted(lambda: dt.epilogue_launches(x, weights, res, trunk_w, head,
                                          ws, feat, out, plant=plant),
             {"fused_dense_block_epilogue": (1, 6, 0)})
    return out


@pytest.mark.parametrize("cin", [3, 4, 12])
def test_prologue_launches_match_jax(tc_route, cin):
    """f32: conv_first on the direct body's form at Cin 3 (RGB), 4 and 12
    (after a x2 unshuffle), then B1's five launches on head, against the
    reference's prologue (its raw input zero-padded to 8 channels as its
    packing wants); both outputs."""
    x = _randn(cin, 2, H, W, cin)
    jw, tw = _block(1)
    jhead, thead = _conv(30 + cin, cin, C)
    cin_pad = -(-cin // 8) * 8
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, cin_pad - cin)))
    jout, jh = jpd.fused_dense_block_prologue(jpd.pack(xp), jhead, jw,
                                              width=W, interpret=True)
    out, head = _prologue(torch.from_numpy(x), thead, tw)
    assert _rel(head, jpd.unpack(jh, W)) < F32_TOL
    assert _rel(out, jpd.unpack(jout, W)) < F32_TOL


def test_epilogue_launches_match_jax(tc_route):
    """f32: B1's five launches with the residual into feat, then
    trunk_conv reading feat alone with + head in its epilogue, against
    the reference's epilogue."""
    x, res, head = (_randn(s, 2, H, W, C, scale=0.5) for s in (5, 6, 7))
    jw, tw = _block(2)
    jtrunk, ttrunk = _conv(40, C, C)
    ref = jpd.fused_dense_block_epilogue(
        jpd.pack(x), jw, jpd.pack(res), jtrunk, jpd.pack(head), width=W,
        interpret=True)
    got = _epilogue(torch.from_numpy(x), tw, torch.from_numpy(res), ttrunk,
                    torch.from_numpy(head))
    assert _rel(got, jpd.unpack(ref, W)) < F32_TOL


def _check_weights(gen, cin=3, c=64, g=32, dtype=torch.float32):
    """chip_smoke.py's phase-16 weights: B1's MSRA x 2 kernels with N(0,
    0.1^2) biases (dense_check_weights), conv_first and trunk_conv MSRA x 2
    with N(0, 0.1^2) biases (end_conv_weights)."""
    def conv(cin_, cout):
        return (torch.randn(3, 3, cin_, cout, generator=gen) * 2
                * (2 / (9 * cin_)) ** 0.5,
                torch.randn(cout, generator=gen) * 0.1)

    block = [conv(c + j * g, g if j < 4 else c) for j in range(5)]
    ws = dt.dense_weights(*zip(*block), dtype=dtype)
    head_w, trunk_w = (dt.dense_weights(*zip(conv(n, c)), dtype=dtype)[0]
                       for n in (cin, c))
    return ws, head_w, trunk_w


def _check_inputs(gen, b=1, h=12, w=20, cin=3, c=64, dtype=torch.float32):
    """chip_smoke.py's phase-16 inputs: x_raw N(0, 0.5^2), x N(0, 0.2^2),
    residual N(0, 0.1^2), head N(0, 0.05^2)."""
    return [(torch.randn(b, h, w, n, generator=gen) * s).to(dtype)
            for n, s in ((cin, 0.5), (c, 0.2), (c, 0.1), (c, 0.05))]


def test_end_folds_bf16_within_bar(tc_route):
    """bf16 at the models' widths (C 64, g 32, Cin 3): every launch
    rounds its f32 sums and epilogue once; kernel 4's two outputs and
    kernel 5's within 0.02 of the plain versions in f32 on the same bf16
    values."""
    gen = torch.Generator().manual_seed(3)
    ws, head_w, trunk_w = _check_weights(gen, dtype=torch.bfloat16)
    x_raw, x, res, head = _check_inputs(gen, dtype=torch.bfloat16)
    f32 = [(k.float(), b) for k, b in (*ws, head_w, trunk_w)]
    out, hd = _prologue(x_raw, head_w, ws)
    ref, ref_hd = dt.fused_dense_block_prologue_reference(
        x_raw.float(), f32[5], f32[:5])
    assert _rel(hd, ref_hd) < TOL
    assert _rel(out, ref) < TOL
    got = _epilogue(x, ws, res, trunk_w, head)
    ref = dt.fused_dense_block_epilogue_reference(
        x.float(), f32[:5], res.float(), f32[6], head.float())
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("kernel", ["prologue", "epilogue"])
@pytest.mark.parametrize("dtype,c,g,want", [
    (torch.bfloat16, 64, 32, True), (torch.bfloat16, 16, 8, True),
    (torch.bfloat16, 24, 12, False), (torch.bfloat16, 12, 8, False),
    (torch.float32, 64, 32, False)])
def test_end_fold_route_rule(monkeypatch, kernel, dtype, c, g, want):
    """Kernels 4 and 5 take B1's route rule: bf16 with C and g multiples
    of 8 runs the conv engine (kernel 4: conv_first on the direct body,
    then five tensor-core launches; kernel 5: six tensor-core launches),
    any other shape one launch of conv_chain_kernel; either way one call
    on the kernel's own counter and none on B1's."""
    seen = []
    for name in ("dense_conv", "first_conv", "dense_prologue",
                 "dense_epilogue"):
        monkeypatch.setattr(_build, name,
                            lambda *a, name=name, **k: seen.append(name))
    t = torch.empty(1, 2, 2, c, dtype=dtype)
    ws = torch.empty(1, 2, 2, 4 * g, dtype=dtype)
    blk = [(torch.empty(3, 3, 1, 1), None)] * 5
    if kernel == "prologue":
        engine, by_body = ["first_conv"] + ["dense_conv"] * 5, (5, 1)
        _counted(lambda: dt.prologue_launches(
            torch.empty(1, 2, 2, 3, dtype=dtype), blk[0], blk, ws, t, t),
            {"fused_dense_block_prologue":
             (1, *by_body) if want else (1, 0, 1)})
    else:
        engine, by_body = ["dense_conv"] * 6, (6, 0)
        _counted(lambda: dt.epilogue_launches(t, blk, t, blk[0], t, ws, t,
                                              t),
                 {"fused_dense_block_epilogue":
                  (1, *by_body) if want else (1, 0, 1)})
    assert seen == (engine if want else [f"dense_{kernel}"])


def _fault_ratio(kernel: str, plant: int) -> float:
    """The worst of chip_smoke.py's phase-16 checks of `kernel` (kernel
    4: out and head) on fresh inputs with the fault planted, as a
    multiple of the 0.02 bar."""
    gen = torch.Generator().manual_seed(23)
    ws, head_w, trunk_w = _check_weights(gen)
    x_raw, x, res, head = _check_inputs(gen)
    if kernel == "fused_dense_block_prologue":
        got = _prologue(x_raw, head_w, ws, plant)
        ref = dt.fused_dense_block_prologue_reference(x_raw, head_w, ws)
        return max(_rel(a, b) for a, b in zip(got, ref)) / TOL
    got = _epilogue(x, ws, res, trunk_w, head, plant)
    ref = dt.fused_dense_block_epilogue_reference(x, ws, res, trunk_w, head)
    return _rel(got, ref) / TOL


@pytest.mark.parametrize("kernel,fault", [
    (k, f) for k, faults in END_FOLD_FAULTS.items() for f in [None, *faults]])
def test_end_fold_planted_faults_miss_by_3x(tc_route, kernel, fault):
    """chip_smoke.py's phase-16 weights and inputs: clean within the bar,
    each fault planted in the launch sequence (residual dropped, first
    two launches swapped, conv_first's halo clamped) missing it by 3x or
    more."""
    plant = 0 if fault is None else getattr(
        _build, END_FOLD_FAULTS[kernel][fault])
    ratio = _fault_ratio(kernel, plant)
    if fault is None:
        assert ratio < 0.01
    else:
        assert ratio > 3, ratio
