"""Kernel 14's plain version (superresolution_tpu_torch/ops/star_l1.py on
CPU tensors, losses/basic.star_weighted_l1) and the port's CombinedLoss
against the JAX package: star_weighted_l1_pallas in interpret mode, and
the jnp losses. Value and gradient within 1e-5 relative, at a ragged n
(not a multiple of the kernel's block) and at a custom threshold and
weight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_tpu.losses.combined import CombinedLoss as JaxLoss
from superresolution_tpu.ops.pallas_loss import star_weighted_l1_pallas
from superresolution_tpu.utils.config import LossConfig as JaxLossConfig
from superresolution_tpu_torch.losses.combined import CombinedLoss
from superresolution_tpu_torch.ops import star_l1
from superresolution_tpu_torch.utils.config import LossConfig


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    t = rng.random(shape, dtype=np.float32) * 0.04
    p = (t + rng.standard_normal(shape) * 0.01).astype(np.float32)
    return p, t


@pytest.mark.parametrize("shape,thr,w", [
    ((2, 33, 37, 1), 0.02, 500.0),      # 2442 elements: ragged n
    ((1, 64, 64, 1), 0.02, 500.0),
    ((7, 11, 13), 0.01, 10.0),          # custom threshold and weight
])
def test_value_and_grad_match_jax_kernel(shape, thr, w):
    p, t = _pair(sum(shape), shape)
    with pltpu.force_tpu_interpret_mode():
        ref, ref_g = jax.value_and_grad(
            lambda a: star_weighted_l1_pallas(a, jnp.asarray(t), thr, w) * 1.7
        )(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    before = star_l1.star_weighted_l1_cuda.launches
    got = star_l1.star_weighted_l1_cuda(pt, torch.from_numpy(t), thr, w) * 1.7
    got.backward()
    assert star_l1.star_weighted_l1_cuda.launches == before  # plain on CPU
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-12)


def test_threshold_is_strict():
    t = np.full((4,), 0.02, np.float32)
    p = np.zeros((4,), np.float32)
    got = star_l1.star_weighted_l1_cuda(torch.from_numpy(p),
                                        torch.from_numpy(t))
    assert float(got) == pytest.approx(0.02)  # weight 1 at t == thr


def test_autograd_function_raises_off_cuda():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        star_l1.StarWeightedL1.apply(p, p, 0.02, 500.0)


@pytest.mark.parametrize("terms", [
    {"star_l1": 1.0}, {"l1": 1.0, "l2": 0.5},
    {"charbonnier": 1.0, "astro": 0.05, "star_l1_pallas": 0.1}])
def test_combined_loss_matches_jax(terms):
    p, t = _pair(5, (2, 16, 16, 1))
    with pltpu.force_tpu_interpret_mode():  # star_l1_pallas on the CPU
        ref_total, ref_logs = JaxLoss(JaxLossConfig(terms=terms))(
            jnp.asarray(p), jnp.asarray(t))
    total, logs = CombinedLoss(LossConfig(terms=terms))(
        torch.from_numpy(p), torch.from_numpy(t))
    assert set(logs) == set(ref_logs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(ref_logs[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)


def test_combined_loss_terms_not_ported():
    """The perceptual term is VGG19's (losses/perceptual.py; held against
    JAX in test_torch_perceptual.py): zero for identical inputs; the gan
    term is left to the GAN step."""
    x = torch.zeros(1, 4, 4, 1)
    total, logs = CombinedLoss(LossConfig(terms={"perceptual": 1.0}))(x, x)
    assert "perceptual" in logs and float(total) == 0.0
    total, logs = CombinedLoss(LossConfig(terms={"l1": 1.0, "gan": 0.1}))(
        x, x)
    assert "gan" not in logs and float(total) == 0.0


# ---- kernel 14's one-launch forward, as a plain model of its order ----
#
# star_l1_fwd_kernel (ops/csrc/train_kernels.cu): 256 threads a block,
# grid min(ceil(ceil(n / 4) / 256), 1056); thread k of the grid sums the
# terms of its float4 chunks k, k + grid threads, ... (x, y, z, w in
# turn), block 0's first n % 4 threads then add the tail; each block
# reduces its threads (shuffle-down tree in each warp, then its 8 warps
# in order) into part[block]; the last block sums part[] the same way,
# thread k taking k, k + 256, ..., and divides by n. No FMA contraction
# (the kernel's __fmul_rn), so float32 numpy repeats it bit for bit.

THREADS, CAP = 256, 1056


def _blocks(n: int) -> int:
    return max(1, min(-(-(-(-n // 4)) // THREADS), CAP))


def _block_sums(v: np.ndarray) -> np.ndarray:
    """block_sum of each row of v [blocks, 256] float32: each warp's
    shuffle-down tree, then thread 0 adds the 8 warp sums in order."""
    w = v.reshape(v.shape[0], THREADS // 32, 32).copy()
    for off in (16, 8, 4, 2, 1):
        w[..., :32 - off] = w[..., :32 - off] + w[..., off:]
    s = np.zeros(v.shape[0], np.float32)
    for k in range(THREADS // 32):
        s = s + w[:, k, 0]
    return s


def star_fwd_form(p: np.ndarray, t: np.ndarray, thr: float,
                  w: float) -> tuple[np.float32, int]:
    """(the forward's value, its grid's blocks) in the kernel's order."""
    p, t = (np.asarray(a, np.float32).reshape(-1) for a in (p, t))
    n, n4 = p.size, p.size // 4
    d = np.abs(p - t)
    term = np.where(t > np.float32(thr), d * np.float32(w), d)
    blocks = _blocks(n)
    g = blocks * THREADS
    s = np.zeros(g, np.float32)
    chunks = term[:4 * n4].reshape(n4, 4)
    for start in range(0, n4, g):
        rows = chunks[start:start + g]
        for j in range(4):
            s[:len(rows)] = s[:len(rows)] + rows[:, j]
    tail = term[4 * n4:]
    s[:len(tail)] = s[:len(tail)] + tail
    part = _block_sums(s.reshape(blocks, THREADS))
    v = np.zeros(THREADS, np.float32)
    for start in range(0, blocks, THREADS):
        seg = part[start:start + THREADS]
        v[:len(seg)] = v[:len(seg)] + seg
    total = _block_sums(v[None])[0]
    return np.float32(total / np.float32(n)), blocks


@pytest.mark.parametrize("n,blocks", [
    (2442, 3),          # n % 4 == 2: the tail
    (203, 1),           # fewer than one block's 1024 elements
    (1_000_003, 977),   # n % 4 == 3, each thread one float4 chunk
    (1_200_001, 1056),  # the grid at its cap: some threads take two
])
def test_forward_order_matches_jax_kernel(n, blocks):
    p, t = _pair(n, (n,))
    with pltpu.force_tpu_interpret_mode():
        ref = star_weighted_l1_pallas(jnp.asarray(p), jnp.asarray(t), 0.02,
                                      500.0)
    got, grid = star_fwd_form(p, t, 0.02, 500.0)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    assert grid == blocks
    again, _ = star_fwd_form(p, t, 0.02, 500.0)
    assert again.tobytes() == got.tobytes()


def test_passes_counted_per_forward_and_backward(monkeypatch):
    """StarWeightedL1's launch sequence on CPU tensors, each launch helper
    an emulation (the forward's model, the plain gradient): one count for
    the forward's launch, one for the backward's."""
    from superresolution_tpu_torch.ops import _build

    calls = []

    def value(p, t, thr, w, out):
        calls.append("value")
        out[0] = float(star_fwd_form(p.numpy(), t.numpy(), thr, w)[0])

    def grad(p, t, thr, w, g, dp):
        calls.append("grad")
        wt = torch.where(t > thr, torch.tensor(w), torch.tensor(1.0))
        dp.copy_(torch.sign(p - t) * wt * g / p.numel())

    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "star_l1_value", value)
    monkeypatch.setattr(_build, "star_l1_grad", grad)
    p, t = _pair(9, (3, 17, 19, 1))
    with pltpu.force_tpu_interpret_mode():
        ref, ref_g = jax.value_and_grad(
            lambda a: star_weighted_l1_pallas(a, jnp.asarray(t)) * 1.7
        )(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    before = star_l1.star_weighted_l1_cuda.launches
    got = star_l1.StarWeightedL1.apply(pt, torch.from_numpy(t), 0.02, 500.0)
    assert star_l1.star_weighted_l1_cuda.launches == before + 1
    (got * 1.7).backward()
    assert star_l1.star_weighted_l1_cuda.launches == before + 2
    assert calls == ["value", "grad"]
    np.testing.assert_allclose(float(got.detach()) * 1.7, float(ref),
                               rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-12)
