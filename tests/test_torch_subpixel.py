"""Kernel 15's op (superresolution_tpu_torch/ops/subpixel.py) on the CPU,
where it runs its plain form, against the reference's
fused_conv3x3_depth_to_space (superresolution_tpu/ops/pallas_kernels.py)
run in interpret mode as tests/test_pallas.py runs it, and against the
reference's XLA form (conv_general_dilated + depth_to_space) where the
Pallas kernel takes no ragged H. The port takes NCHW / OIHW where the
reference takes NHWC / HWIO.

Tolerances: f32 within 1e-4 (test_pallas.py's bar: the same f32 sums in
another order); bf16 within 0.05 (its bf16 bar: each side rounds its
output to bf16 once, after f32 accumulation); gradients within 1e-5 of
jax.grad of the XLA form (the same f32 arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_tpu.ops import depth_to_space
from superresolution_tpu.ops.pallas_kernels import fused_conv3x3_depth_to_space
from superresolution_tpu_torch.ops import subpixel
from superresolution_tpu_torch.ops.subpixel import (
    conv3x3_depth_to_space,
    reference_conv3x3_depth_to_space,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xla_form(x, w, b, r):
    out = jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return depth_to_space(out + b, r)


def _inputs(seed, bsz, h, w, c_in, c_out, r):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, h, w, c_in)).astype(np.float32)
    k = rng.standard_normal((3, 3, c_in, c_out * r * r)).astype(np.float32)
    b = rng.standard_normal(c_out * r * r).astype(np.float32)
    return x, k, b


def _port(x, k, b, dtype=torch.float32):
    """The port's layouts of the reference's NHWC x and HWIO kernel."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype),
            torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().to(dtype),
            torch.from_numpy(b).to(dtype))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("c_out", [1, 4])
def test_plain_matches_pallas_kernel_f32(r, c_out):
    x, k, b = _inputs(r * 10 + c_out, 2, 16, 24, 8, c_out, r)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_conv3x3_depth_to_space(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), r))
    got = _nhwc(conv3x3_depth_to_space(*_port(x, k, b), r))
    assert got.shape == (2, 16 * r, 24 * r, c_out)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r,c_in,c_out", [(2, 8, 4), (4, 16, 1)])
def test_plain_matches_pallas_kernel_bf16(r, c_in, c_out):
    x, k, b = _inputs(7 + r, 1, 8, 8, c_in, c_out, r)
    bf = jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = fused_conv3x3_depth_to_space(
            jnp.asarray(x).astype(bf), jnp.asarray(k).astype(bf),
            jnp.asarray(b).astype(bf), r)
    assert ref.dtype == bf
    got = conv3x3_depth_to_space(*_port(x, k, b, torch.bfloat16), r)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref, np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("r,h,w", [(3, 13, 11), (2, 5, 9)])
def test_plain_matches_xla_form_ragged(r, h, w):
    """H and W that the Pallas kernel's row bands do not take."""
    x, k, b = _inputs(h * w, 2, h, w, 6, 3, r)
    ref = np.asarray(_xla_form(jnp.asarray(x), jnp.asarray(k),
                               jnp.asarray(b), r))
    got = _nhwc(conv3x3_depth_to_space(*_port(x, k, b), r))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r", [2, 3])
def test_gradients_match_jax_grad(r):
    x, k, b = _inputs(r, 2, 7, 9, 5, 2, r)
    g = np.random.default_rng(99).standard_normal(
        (2, 7 * r, 9 * r, 2)).astype(np.float32)

    def loss(x, k, b):
        return jnp.sum(_xla_form(x, k, b, r) * g)

    jx, jk, jb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    tx, tk, tb = (t.requires_grad_() for t in _port(x, k, b))
    out = conv3x3_depth_to_space(tx, tk, tb, r)
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    for got, ref in ((tx.grad.permute(0, 2, 3, 1), jx),
                     (tk.grad.permute(2, 3, 1, 0), jk), (tb.grad, jb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_cpu_runs_the_plain_form_and_counts_no_launch():
    x, k, b = _inputs(3, 1, 6, 5, 4, 2, 2)
    tx, tk, tb = _port(x, k, b)
    before = conv3x3_depth_to_space.launches
    got = conv3x3_depth_to_space(tx, tk, tb, 2)
    assert conv3x3_depth_to_space.launches == before
    assert torch.equal(got, reference_conv3x3_depth_to_space(tx, tk, tb, 2))
    # a bias-free conv, through the op and its gradient
    tx.requires_grad_()
    conv3x3_depth_to_space(tx, tk, None, 2).sum().backward()
    assert tx.grad is not None and tx.grad.shape == tx.shape


def test_the_kernel_wrapper_takes_only_cuda_tensors():
    x, k, b = _inputs(4, 1, 6, 5, 4, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        subpixel._launch(*_port(x, k, b), 2)
    with pytest.raises(TypeError, match="bf16 or f32"):
        subpixel._launch(*_port(x, k, b, torch.float16), 2)


@pytest.mark.parametrize("case", ["r", "bias", "kernel"])
def test_geometry_errors_name_the_geometry(case):
    x, k, b = _inputs(5, 1, 6, 5, 4, 2, 2)
    tx, tk, tb = _port(x, k, b)
    if case == "r":
        args, match = (tx, tk, tb, 3), "multiple of r"
    elif case == "bias":
        args, match = (tx, tk, tb[:3], 2), "bias"
    else:
        args, match = (tx, tk[:, :, :2], tb, 2), "C_in, 3, 3"
    with pytest.raises(ValueError, match=match):
        conv3x3_depth_to_space(*args)
