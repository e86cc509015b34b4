"""The shared conv engine's operands and route rule (superresolution_tpu_
torch/ops/csrc/conv_engine.cuh, driven by ops/subpixel.py for kernel 15
and ops/pairconv.py for kernel 18), on the CPU.

The CUDA bodies cannot run here, so these tests hold what surrounds them:
a plain-torch model of the engine's GEMM form (im2col of the input x the
wrapper's K-major weight matrix + the bias, then the put's address map:
sub-pixel-major columns to HR pixels for kernel 15, pad-pack columns
zeroed for kernel 18) against each op's plain version and against the
reference's Pallas kernels, run as tests/test_torch_subpixel.py and
tests/test_torch_pairconv.py run them (interpret mode; the reference's
XLA form where its row bands take no ragged H); and the route rule that
picks the tensor-core or the direct body.

Tolerances: f32 within 1e-4 (the same f32 products summed in another
order, test_pallas.py's and test_pallas_pairconv.py's bar); the GEMM
form against the op's own plain form in bf16 within 0.02 of max |plain|
(each side rounds once to bf16 after f32 sums; chip_smoke.py's bar)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from superresolution_tpu.ops import depth_to_space
from superresolution_tpu.ops import pallas_pairconv as jpc
from superresolution_tpu.ops.pallas_kernels import fused_conv3x3_depth_to_space
from superresolution_tpu_torch.ops import pairconv, subpixel


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H, W, 9C] with SAME zero padding, column tap*C
    + ci (tap = ky*3 + kx): the engine's K order."""
    h, w = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1))
    cols = [xp[:, :, ky:ky + h, kx:kx + w] for ky in range(3)
            for kx in range(3)]
    return torch.cat(cols, dim=1).permute(0, 2, 3, 1)


def _gemm_subpixel(x, wk, bk, r, c_out):
    """Kernel 15's GEMM form: im2col(x) @ wk + bk in f32, then the put:
    column q = (i*r + j)*C_out + c of LR pixel (y, x) to HR pixel
    (y*r + i, x*r + j), channel c. Returns [B, C_out, H*r, W*r]."""
    b, _, h, w = x.shape
    n = c_out * r * r
    y = _im2col(x.float()) @ wk.float()
    if bk is not None:
        y = y + bk
    y = y[..., :n].to(x.dtype).reshape(b, h, w, r, r, c_out)
    return y.permute(0, 5, 1, 3, 2, 4).reshape(b, c_out, h * r, w * r)


def _gemm_pack(xp, wk, bias, p, width, act):
    """Kernel 18's GEMM form on the unpacked view [B, H, W2*p, c] (pad
    packs read as they lie): im2col @ wk + bias, the optional lrelu, every
    column outside [p, p + width) zeroed, one rounding, packed back."""
    b, h, w2, pc = xp.shape
    n = wk.shape[1]
    x = xp.reshape(b, h, w2 * p, pc // p).permute(0, 3, 1, 2).float()
    y = _im2col(x) @ wk.float() + bias.float()
    if act == "lrelu":
        y = F.leaky_relu(y, 0.2)
    keep = torch.zeros(w2 * p, dtype=torch.bool)
    keep[p:p + width] = True
    y = torch.where(keep[None, None, :, None], y, torch.zeros(()))
    return y.to(xp.dtype).reshape(b, h, w2, p * n)


def _subpixel_inputs(seed, h, w, c_in, c_out, r):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, h, w, c_in)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c_in, c_out * r * r))
         / np.sqrt(9 * c_in)).astype(np.float32)
    b = rng.standard_normal(c_out * r * r).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("h,w", [(8, 11), (13, 7)])
@pytest.mark.parametrize("c_in", [8, 24, 64])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_subpixel_gemm_form_matches_plain_and_pallas(r, c_in, h, w):
    """kmajor_weights' matrix and bias through the GEMM form equal the
    op's plain form and the reference (its Pallas kernel where H is a
    multiple of its row band of 8, its XLA form otherwise), f32."""
    c_out = 2
    x, k, b = _subpixel_inputs(r * 100 + c_in + h, h, w, c_in, c_out, r)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tw = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    tb = torch.from_numpy(b)
    wk, bk = subpixel.kmajor_weights(tw, tb, r, torch.float32)
    n = c_out * r * r
    assert wk.shape == (9 * c_in, -(-n // 8) * 8) and wk.is_contiguous()
    assert bk.dtype == torch.float32 and not wk[:, n:].any()
    got = _gemm_subpixel(tx, wk, bk, r, c_out)
    plain = subpixel.reference_conv3x3_depth_to_space(tx, tw, tb, r)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)
    if h % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            ref = fused_conv3x3_depth_to_space(
                jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), r)
    else:
        import jax
        ref = depth_to_space(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + jnp.asarray(b), r)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r", [2, 4])
def test_subpixel_gemm_form_bf16_and_no_bias(r):
    """The bf16 matrix (and no bias) through the GEMM form against the
    op's plain form on the same bf16 values, within 0.02 of max |plain|."""
    x, k, b = _subpixel_inputs(7 * r, 9, 10, 16, 3, r)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    tw = torch.from_numpy(k).permute(3, 2, 0, 1).to(torch.bfloat16)
    wk, bk = subpixel.kmajor_weights(tw, None, r, torch.bfloat16)
    assert wk.dtype == torch.bfloat16 and bk is None
    got = _gemm_subpixel(tx, wk, None, r, 3).float()
    plain = subpixel.reference_conv3x3_depth_to_space(
        tx.float(), tw.float(), None, r)
    assert float((got - plain).abs().max()) <= 0.02 * float(
        plain.abs().max())


def _pack_case(seed, h, width, c, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, h, width, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, n)) / np.sqrt(9 * c)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("act", ["none", "lrelu"])
@pytest.mark.parametrize("c,n", [(8, 16), (24, 40), (64, 96)])
def test_pack_gemm_form_matches_plain_and_pallas(c, n, act):
    """pairconv.kmajor_weights through the GEMM form, pad packs read as
    they lie and written as 0, equal pack_conv3x3_reference and the
    reference's pack_conv3x3 (interpret=True), p 2, f32."""
    p, width = 2, 22
    x, w, b = _pack_case(c + n, 6, width, c, n)
    xp = pairconv.pack_input(torch.from_numpy(x), p)
    wk = pairconv.kmajor_weights(torch.from_numpy(w), torch.float32)
    assert wk.shape == (9 * c, n) and wk.is_contiguous()
    got = _gemm_pack(xp, wk, torch.from_numpy(b), p, width, act)
    plain = pairconv.pack_conv3x3_reference(
        xp, torch.from_numpy(w), torch.from_numpy(b), p, width, act)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)
    ref = jpc.pack_conv3x3(jpc.pack_input(jnp.asarray(x), p),
                           jnp.asarray(w), jnp.asarray(b), p, width, act,
                           True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_pack_gemm_form_chains_in_bf16():
    """Two chained convs in bf16 (the first with lrelu) through the GEMM
    form: the pad packs the first writes are the zeros the second reads;
    within 0.02 of the plain form on the same bf16 values."""
    p, width = 2, 16
    x, w1, b1 = _pack_case(1, 5, width, 16, 48)
    _, w2, b2 = _pack_case(2, 5, width, 48, 16)
    bf = torch.bfloat16
    xp = pairconv.pack_input(torch.from_numpy(x), p).to(bf)
    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)
    y1 = _gemm_pack(xp, pairconv.kmajor_weights(tw1, bf),
                    torch.from_numpy(b1), p, width, "lrelu")
    got = _gemm_pack(y1, pairconv.kmajor_weights(tw2, bf),
                     torch.from_numpy(b2), p, width, "none").float()
    r1 = pairconv.pack_conv3x3_reference(xp, tw1, torch.from_numpy(b1), p,
                                         width, "lrelu")
    plain = pairconv.pack_conv3x3_reference(r1, tw2, torch.from_numpy(b2),
                                            p, width).float()
    full = got.reshape(1, 5, -1, 16)
    assert not full[:, :, :p].any() and not full[:, :, p + width:].any()
    assert float((got - plain).abs().max()) <= 0.02 * float(
        plain.abs().max())


@pytest.mark.parametrize("case,tc", [
    ("bf16_channels_last", True), ("f32_channels_last", False),
    ("bf16_cin12", False), ("bf16_nchw", False), ("bf16_cin264", False),
    ("bf16_cin256", True)])
def test_subpixel_route_rule(case, tc):
    """uses_tensor_cores: bf16, channels-last, 8 <= C_in <= 256 and C_in
    % 8 == 0 take the tensor-core body; f32, a C_in the 16-byte copies
    cannot take and NCHW take the direct body."""
    cin = {"bf16_cin12": 12, "bf16_cin264": 264, "bf16_cin256": 256}.get(
        case, 64)
    dt = torch.float32 if case.startswith("f32") else torch.bfloat16
    x = torch.zeros((2, cin, 5, 7), dtype=dt)
    if case != "bf16_nchw":
        x = x.contiguous(memory_format=torch.channels_last)
    assert subpixel.uses_tensor_cores(x) is tc


@pytest.mark.parametrize("case,tc", [
    ("bf16", True), ("f32", False), ("bf16_c12", False),
    ("bf16_n20", False), ("bf16_c192", True)])
def test_pack_route_rule(case, tc):
    """uses_tensor_cores: bf16 with c % 8 == 0, n % 8 == 0 and 8 <= c <=
    256 takes the tensor-core body; f32 and other widths the direct
    body."""
    c = {"bf16_c12": 12, "bf16_c192": 192}.get(case, 32)
    n = 20 if case == "bf16_n20" else 64
    dt = torch.float32 if case == "f32" else torch.bfloat16
    xp = torch.zeros((1, 2, 16, 2 * c), dtype=dt)
    assert pairconv.uses_tensor_cores(xp, torch.zeros((3, 3, c, n))) is tc


def test_cpu_calls_count_no_launch_on_either_body():
    """On CPU tensors both ops run their plain forms and no count moves."""
    ops = (subpixel.conv3x3_depth_to_space, pairconv.pack_conv3x3)
    before = [(op.launches, op.tc_launches, op.direct_launches)
              for op in ops]
    x = torch.zeros((1, 8, 4, 4)).contiguous(
        memory_format=torch.channels_last)
    subpixel.conv3x3_depth_to_space(x, torch.zeros((16, 8, 3, 3)),
                                    torch.zeros(16), 2)
    xp = pairconv.pack_input(torch.zeros((1, 4, 16, 8)), 2)
    pairconv.pack_conv3x3(xp, torch.zeros((3, 3, 8, 8)), torch.zeros(8), 2,
                          16)
    assert [(op.launches, op.tc_launches, op.direct_launches)
            for op in ops] == before
