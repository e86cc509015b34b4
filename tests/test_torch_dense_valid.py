"""Kernel 16's op (superresolution_tpu_torch/ops/dense_valid.py) on the
CPU, where it runs its plain form, against the reference's
fused_dense_block_pallas (superresolution_tpu/ops/pallas_dense.py) in
interpret mode, as tests/test_pallas_dense.py runs it, on the same
numpy-seeded inputs and weights.

Tolerances: f32 within 1e-4 over the WHOLE image, the 5-px border
included (test_pallas_dense.py's bar; the same f32 sums in another
order); the interior against the port's SAME FusedDenseBlock within
1e-4. In bf16 the port's plain form rounds where the reference's kernel
rounds, with f32 sums, and stays within 0.01 of max |f32 form| on the
same bf16 values.

The reference's bf16 kernel is not faithful off the TPU: its column roll
(_roll_cols) bitcasts bf16 pairs to int32, and outside Mosaic that packs
two adjacent columns, so a roll of 1 moves 2 columns and the side taps
read the wrong pixels. At the model's MSRA x 0.1 init the conv term is
~3% of the output and the two are held to each other at
test_pallas_dense.py's bf16 bar (rtol 0.1, atol 0.15), which cannot see
the convs. So a second case swaps in the f32 branch of that roll (a
plain pltpu.roll, equal to jnp.roll in interpret mode) and, at MSRA x 2
where the convs make up most of the output, holds the conv term
(out - x) / 0.2 of both within 0.02 of its max.
"""

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
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.rrdbnet import DenseBlock, FusedDenseBlock
from superresolution_tpu_torch.ops import dense_valid
from superresolution_tpu_torch.ops.dense_valid import (
    fused_dense_block_valid,
    fused_weights_from_module,
    pack_fused_weights,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, shape, c, g, bias_scale=0.1, init_scale=0.1):
    """x N(0, 1) and a JAX FusedDenseBlock's params with N(0, 0.1^2)
    biases, so every bias reaches the border."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    params = JaxFDB(features=c, growth=g, init_scale=init_scale).init(
        jax.random.key(seed), jnp.asarray(x))["params"]
    params = jax.tree.map(np.array, params)
    b = params["Conv_0"]["Conv_0"]["bias"]
    params["Conv_0"]["Conv_0"]["bias"] = (
        bias_scale * rng.standard_normal(b.shape)).astype(np.float32)
    return x, params


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("shape,c,g,th", [((2, 24, 20, 16), 16, 8, 8),
                                          ((1, 16, 13, 8), 8, 4, 4)])
def test_plain_matches_pallas_whole_image_f32(shape, c, g, th):
    x, params = _case(th, shape, c, g)
    ws = jax_pack_fused_weights(params, c, g)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_dense_block_pallas(
            jnp.asarray(x), *[jnp.asarray(w) for w in ws], th=th))
    got = fused_dense_block_valid(
        torch.from_numpy(x), *[torch.from_numpy(w) for w in ws], th=th)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_plain_matches_pallas_bf16():
    c, g = 16, 8
    x, params = _case(3, (1, 16, 16, c), c, g)
    ws = jax_pack_fused_weights(params, c, g)
    with pltpu.force_tpu_interpret_mode():
        ref = fused_dense_block_pallas(
            jnp.asarray(x, jnp.bfloat16),
            *[jnp.asarray(w, jnp.bfloat16) for w in ws], th=8)
    bf = torch.bfloat16
    tx = torch.from_numpy(x).to(bf)
    tw = [torch.from_numpy(w).to(bf) for w in ws]
    got = fused_dense_block_valid(tx, *tw)
    assert got.dtype == bf
    f32 = fused_dense_block_valid(tx.float(), *[w.float() for w in tw])
    assert _rel(got.float().numpy(), f32.numpy()) < 0.01
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0.1,
                               atol=0.15)


def test_plain_matches_pallas_bf16_conv_term(monkeypatch):
    """At MSRA x 2, against the reference's bf16 kernel with a faithful
    column roll (see the module docstring): the conv term within 0.02,
    and x alone, the block without its convs, far outside it."""
    from superresolution_tpu.ops import pallas_dense

    c, g = 16, 8
    x, params = _case(3, (1, 16, 16, c), c, g, init_scale=2.0)
    ws = jax_pack_fused_weights(params, c, g)
    monkeypatch.setattr(
        pallas_dense, "_roll_cols",
        lambda v, shift: v if shift == 0 else pltpu.roll(v, shift, 1))
    jax.clear_caches()  # no trace made with the packed roll is reused
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(fused_dense_block_pallas(
                jnp.asarray(x, jnp.bfloat16),
                *[jnp.asarray(w, jnp.bfloat16) for w in ws], th=8),
                np.float32)
    finally:
        jax.clear_caches()
    bf = torch.bfloat16
    tx = torch.from_numpy(x).to(bf)
    got = fused_dense_block_valid(
        tx, *[torch.from_numpy(w).to(bf) for w in ws]).float().numpy()
    xb = tx.float().numpy()
    conv_ref = (ref - xb) / 0.2
    assert np.max(np.abs(conv_ref)) > np.max(np.abs(xb))
    assert _rel((got - xb) / 0.2, conv_ref) < 0.02
    assert _rel(np.zeros_like(xb), conv_ref) > 0.5


def test_interior_matches_same_block_and_border_does_not():
    """The port's SAME FusedDenseBlock (models/rrdbnet.py) on the same
    weights: equal within 5 px of nothing but the border, where the
    pad-once chain's intermediates are not zero."""
    c, g = 16, 8
    gen = torch.Generator().manual_seed(0)
    blk = FusedDenseBlock(c, g, init_scale=1.0, generator=gen)
    with torch.no_grad():
        blk.px.bias.copy_(0.1 * torch.randn(blk.px.bias.shape,
                                            generator=gen))
    x = torch.randn((2, 24, 22, c), generator=gen)
    with torch.no_grad():
        same = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    ws = [torch.from_numpy(w) for w in fused_weights_from_module(blk)]
    got = fused_dense_block_valid(x, *ws).numpy()
    np.testing.assert_allclose(got[:, 5:-5, 5:-5], same[:, 5:-5, 5:-5],
                               rtol=1e-4, atol=1e-4)
    border = np.ones(got.shape[1:3], bool)
    border[5:-5, 5:-5] = False
    assert np.max(np.abs(got - same)[:, border]) > 0.05 * np.max(
        np.abs(same))
    # the differences stay within 4 px of the border (y_1 differs outside
    # the image only, and each conv carries it one pixel inwards)
    np.testing.assert_allclose(got[:, 4:-4, 4:-4], same[:, 4:-4, 4:-4],
                               rtol=1e-4, atol=1e-4)


def test_both_weight_routes_give_pack_fused_weights():
    """JAX tree -> pack_fused_weights equals the reference's, and the
    port's FusedDenseBlock and DenseBlock holding those weights give the
    same matrices through fused_weights_from_module."""
    c, g = 16, 8
    _, params = _case(5, (1, 8, 8, c), c, g)
    want = [np.asarray(w) for w in jax_pack_fused_weights(params, c, g)]
    got = pack_fused_weights(params, c, g)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)

    def oihw(k):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(k).transpose(3, 2, 0, 1)))

    fused = FusedDenseBlock(c, g)
    dense = DenseBlock(c, g)
    with torch.no_grad():
        fused.px.weight.copy_(oihw(params["Conv_0"]["Conv_0"]["kernel"]))
        fused.px.bias.copy_(torch.from_numpy(
            params["Conv_0"]["Conv_0"]["bias"]))
        for i in range(1, 5):
            getattr(fused, f"proj_y{i}").weight.copy_(
                oihw(params[f"proj_y{i}"]["kernel"]))
        ks, bs = convert._unfuse_dense(params, c, g)
        for j in range(5):
            conv = getattr(dense, f"conv{j + 1}")
            conv.weight.copy_(oihw(ks[j]))
            conv.bias.copy_(torch.from_numpy(bs[j]))
    for block in (fused, dense):
        for a, b in zip(fused_weights_from_module(block), want, strict=True):
            np.testing.assert_array_equal(a, b)


def test_th_must_divide_h_as_in_the_reference():
    c, g = 8, 4
    x, params = _case(7, (1, 12, 8, c), c, g)
    ws = pack_fused_weights(params, c, g)
    with pytest.raises(ValueError, match="not divisible"):
        with pltpu.force_tpu_interpret_mode():
            fused_dense_block_pallas(jnp.asarray(x),
                                     *[jnp.asarray(w) for w in ws], th=8)
    tw = [torch.from_numpy(w) for w in ws]
    with pytest.raises(ValueError, match="not divisible"):
        fused_dense_block_valid(torch.from_numpy(x), *tw, th=8)
    # any th dividing H gives the same result
    a = fused_dense_block_valid(torch.from_numpy(x), *tw, th=4)
    b = fused_dense_block_valid(torch.from_numpy(x), *tw, th=12)
    assert torch.equal(a, b)


def test_cpu_wrapper_runs_the_plain_form_and_checks_shapes():
    c, g = 8, 4
    x, params = _case(9, (1, 8, 8, c), c, g)
    tw = [torch.from_numpy(w) for w in pack_fused_weights(params, c, g)]
    before = fused_dense_block_valid.launches
    got = fused_dense_block_valid(torch.from_numpy(x), *tw)
    assert fused_dense_block_valid.launches == before
    assert torch.equal(got, dense_valid.fused_dense_block_valid_reference(
        torch.from_numpy(x), *tw))
    with pytest.raises(ValueError, match="matrices"):
        fused_dense_block_valid(torch.from_numpy(x), *tw[:4], tw[4][:, :-1],
                                tw[5])
