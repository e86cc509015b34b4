"""Kernel 10 (superresolution_tpu_torch/ops/window_attention.py:
flash_window_attention and its map form flash_map_attention) on the CPU,
where it runs its plain form, against the JAX package's
flash_window_attention in Pallas interpret mode: self, masked and cross
attention (m 144 and the odd OCAB's 121) in f32 within 1e-5 of max
|ref|, and gradients in q, k, v and bias against jax.vjp within 1e-5;
the map form against the JAX roll, partition, attention, merge and roll
back. Also the wrapper's refusals off the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.models.hat_lite import (
    _shift_region_ids,
    window_merge,
    window_partition,
)
from superresolution_tpu.ops import pallas_attn
from superresolution_tpu_torch.ops.window_attention import (
    flash_map_attention,
    flash_window_attention,
    map_attention_reference,
)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, nb=8, c=32, nh=2, nw_img=4, seed=0):
    """q [nb, 64, C]; k, v [nb, m, C]; bias [nh, 64, m]; region ids for
    'masked'. Logits of a few units, so the softmax is far from uniform."""
    n = 64
    m = {"self": 64, "masked": 64, "cross144": 144, "cross121": 121}[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nb, n, c)).astype(np.float32)
    k = rng.standard_normal((nb, m, c)).astype(np.float32)
    v = rng.standard_normal((nb, m, c)).astype(np.float32)
    bias = rng.standard_normal((nh, n, m)).astype(np.float32)
    ids = (rng.integers(0, 3, (nw_img, n)).astype(np.int32)
           if case == "masked" else None)
    return q, k, v, bias, ids


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _torch(*arrays, grad=False):
    return [None if a is None else
            torch.from_numpy(a).requires_grad_(grad and a.dtype != np.int32)
            for a in arrays]


@pytest.mark.parametrize("case", ["self", "masked", "cross144", "cross121"])
def test_forward_matches_jax_interpret(case):
    q, k, v, bias, ids = _inputs(case)
    ref = pallas_attn.flash_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), 2,
        True, None if ids is None else jnp.asarray(ids))
    before = flash_window_attention.launches
    got = flash_window_attention(*_torch(q, k, v, bias), 2,
                                 *_torch(ids))
    assert flash_window_attention.launches == before  # no launch on a CPU
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("case", ["masked", "cross121"])
def test_gradients_match_jax_vjp(case):
    q, k, v, bias, ids = _inputs(case, nb=4, nw_img=2, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    jids = None if ids is None else jnp.asarray(ids)
    _, vjp = jax.vjp(
        lambda *a: pallas_attn.flash_window_attention(*a, 2, True, jids),
        *map(jnp.asarray, (q, k, v, bias)))
    refs = vjp(jnp.asarray(g))
    leaves = _torch(q, k, v, bias, grad=True)
    out = flash_window_attention(*leaves, 2, *_torch(ids))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for got, ref in zip(grads, refs):
        assert _rel(got.numpy(), ref) < TOL


def test_gradient_only_where_asked():
    """needs_input_grad: a leaf without requires_grad gets None, and the
    others still match the plain form's autograd."""
    q, k, v, bias, _ = _inputs("self", nb=2)
    tq, tk, tv, tb = _torch(q, k, v, bias)
    tq.requires_grad_()
    out = flash_window_attention(tq, tk, tv, tb, 2)
    (dq,) = torch.autograd.grad(out.sum(), [tq])
    assert dq.shape == tq.shape and tk.grad is None


def test_strided_views_read_in_place():
    """q, k, v as the split of one packed [nb, n, 3C] tensor (row stride
    3C), as WindowAttention hands them over."""
    q, k, v, bias, _ = _inputs("self")
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
    tq, tk, tv = qkv.split(32, dim=-1)
    assert tq.stride(1) == 96
    got = flash_window_attention(tq, tk, tv, torch.from_numpy(bias), 2)
    ref = flash_window_attention(*_torch(q, k, v, bias), 2)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_wrapper_raises_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) for the device, and first for a geometry the kernel
    does not take, naming it."""
    m = torch.device("meta")

    def e(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, device=m, dtype=dtype)

    bias = e(6, 64, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_window_attention(e(4, 64, 96), e(4, 64, 96), e(4, 64, 96),
                               bias, 6)
    with pytest.raises(ValueError, match="head dim.*got head dim 8"):
        flash_window_attention(e(4, 64, 48), e(4, 64, 48), e(4, 64, 48),
                               bias, 6)
    with pytest.raises(ValueError, match="m 196"):
        flash_window_attention(e(4, 64, 96), e(4, 196, 96), e(4, 196, 96),
                               e(6, 64, 196, dtype=torch.float32), 6)
    with pytest.raises(ValueError, match="head dim 20, n 64, m 64, C 140"):
        flash_window_attention(e(4, 64, 140), e(4, 64, 140), e(4, 64, 140),
                               e(7, 64, 64, dtype=torch.float32), 7)
    with pytest.raises(ValueError, match="self-attention"):
        flash_window_attention(
            e(4, 64, 96), e(4, 144, 96), e(4, 144, 96),
            e(6, 64, 144, dtype=torch.float32), 6,
            torch.zeros(2, 64, dtype=torch.int32, device=m))


@pytest.mark.parametrize("c,nh", [(16, 1), (64, 4), (112, 7), (128, 8),
                                  (20, 1), (60, 3), (100, 5), (120, 6)])
def test_every_width_reaches_the_kernel(c, nh):
    """Kernel 10 takes in bf16 every width it takes in f32 (head dim 16
    up to C 128, 20 up to C 120), on windows and on the map: off the CPU
    (meta tensors here) such a call gets past the geometry rule to the
    device check; head dim 8 is refused by the rule, naming it."""
    m = torch.device("meta")

    def e(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, device=m, dtype=dtype)

    for n, k in ((64, 64), (64, 144), (256, 576)):
        with pytest.raises(ValueError, match="CUDA"):
            flash_window_attention(e(4, n, c), e(4, k, c), e(4, k, c),
                                   e(nh, n, k, dtype=torch.float32), nh)
    for ws in (8, 16):
        with pytest.raises(ValueError, match="CUDA"):
            flash_map_attention(e(1, 2 * ws, 2 * ws, 3 * c),
                                e(nh, ws * ws, ws * ws, dtype=torch.float32),
                                nh, ws, ws // 2)
    with pytest.raises(ValueError, match="got head dim 8"):
        flash_map_attention(e(1, 16, 16, 3 * 8 * nh),
                            e(nh, 64, 64, dtype=torch.float32), nh, 8)


def _jax_map_attention(qkv, bias, nh, ws, shift):
    """The JAX package's form of the map attention: roll, partition,
    flash_window_attention in interpret mode (with the Swin region ids
    of a shifted map), merge, roll back."""
    b, h, w, c3 = qkv.shape
    x = jnp.asarray(qkv)
    ids = None
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        ids = jnp.asarray(_shift_region_ids(h, w, ws, shift))
    win = window_partition(x, ws)
    c = c3 // 3
    y = pallas_attn.flash_window_attention(
        win[..., :c], win[..., c:2 * c], win[..., 2 * c:], jnp.asarray(bias),
        nh, True, ids)
    y = window_merge(y, ws, (h, w))
    return jnp.roll(y, (shift, shift), axis=(1, 2)) if shift else y


@pytest.mark.parametrize("ws,hd,shifted", [(8, 16, False), (8, 16, True),
                                           (8, 20, True), (16, 16, False),
                                           (16, 20, True)])
def test_map_form_matches_jax_roll_partition(ws, hd, shifted):
    """Kernel 10's map form (flash_map_attention; its plain version on
    the CPU: the roll, partition, attention, merge and roll back) on a
    qkv map [2, 2 ws, 3 ws, 3C] against the JAX package's roll, window
    partition, flash_window_attention in interpret mode, merge and roll
    back, in f32 within 1e-5 of max |ref|."""
    nh, shift = 2, ws // 2 if shifted else 0
    c, n = nh * hd, ws * ws
    rng = np.random.default_rng(ws + hd + shift)
    qkv = rng.standard_normal((2, 2 * ws, 3 * ws, 3 * c)).astype(np.float32)
    bias = rng.standard_normal((nh, n, n)).astype(np.float32)
    ref = _jax_map_attention(qkv, bias, nh, ws, shift)
    before = flash_map_attention.launches
    got = flash_map_attention(torch.from_numpy(qkv), torch.from_numpy(bias),
                              nh, ws, shift)
    assert flash_map_attention.launches == before  # no launch on a CPU
    assert _rel(got.numpy(), ref) < TOL


def test_map_form_gradient_is_plain_autograd():
    """The map form's backward is autograd of its plain version: the
    gradients in qkv and bias equal those of map_attention_reference."""
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((1, 16, 16, 96)).astype(np.float32)
    bias = rng.standard_normal((2, 64, 64)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((1, 16, 16, 32))
                         .astype(np.float32))
    grads = []
    for fn in (flash_map_attention, map_attention_reference):
        leaves = _torch(qkv, bias, grad=True)
        grads.append(torch.autograd.grad(fn(*leaves, 2, 8, 4), leaves, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
