"""Kernel 12 (superresolution_tpu_torch/ops/hab.py: fused_cab_convs_pair)
on the CPU, where the wrapper runs its plain version, against the JAX
package's pair-packed Pallas kernel in interpret mode on the same numpy
inputs, at the reference test's geometries (tests/test_fused_hat.py:247:
H x W x C 8x10x12, 6x16x6, 12x8x12, batch 2), in f32 to the reference's
bar (atol 2e-5, rtol 2e-4). LN and conv biases are nonzero: outside the
image each conv must see zeros, not LN(0) = ln bias or GELU(bias). Also
the odd-width raise, and that a tensor off the CPU never takes the plain
version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import pallas_hab as jhab
from superresolution_tpu_torch.ops.hab import fused_cab_convs_pair

ATOL, RTOL = 2e-5, 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(h, w, c, seed):
    rng = np.random.default_rng(seed)
    mid = c // 3
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    ln_b = (0.5 * rng.standard_normal(c)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, c, mid)) / np.sqrt(9 * c)).astype(
        np.float32)
    b1 = (0.3 * rng.standard_normal(mid)).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, mid, c)) / np.sqrt(9 * mid)).astype(
        np.float32)
    b2 = (0.3 * rng.standard_normal(c)).astype(np.float32)
    hp = {"LayerNorm_0": {"scale": ln_s, "bias": ln_b},
          "ChannelAttentionBlock_0": {
              "Conv_0": {"Conv_0": {"kernel": k1, "bias": b1}},
              "Conv_1": {"Conv_0": {"kernel": k2, "bias": b2}}}}
    return x, hp, [torch.from_numpy(a) for a in (ln_s, ln_b, k1, b1, k2, b2)]


@pytest.mark.parametrize("h,w,c", [(8, 10, 12), (6, 16, 6), (12, 8, 12)])
def test_fused_cab_convs_pair_matches_jax_kernel(h, w, c):
    x, hp, weights = _case(h, w, c, seed=h * w + c)
    ref = jhab.fused_cab_convs_pair(jnp.asarray(x),
                                    jhab.cab_pair_weights(hp, jnp.float32),
                                    interpret=True)
    got = fused_cab_convs_pair(torch.from_numpy(x), weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_fused_cab_convs_pair_needs_an_even_width():
    x, _, weights = _case(8, 7, 12, seed=0)
    with pytest.raises(ValueError, match="even width"):
        fused_cab_convs_pair(torch.from_numpy(x), weights)


def test_fused_cab_convs_pair_off_the_cpu_launches_or_raises():
    m = torch.device("meta")

    def e(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, device=m, dtype=dtype)

    f32 = torch.float32

    def cab(c):
        return [e(c, dtype=f32), e(c, dtype=f32), e(3, 3, c, c // 3),
                e(c // 3, dtype=f32), e(3, 3, c // 3, c), e(c, dtype=f32)]

    with pytest.raises(ValueError, match="CUDA"):
        fused_cab_convs_pair(e(1, 8, 8, 96), cab(96))
    with pytest.raises(ValueError, match="takes"):
        fused_cab_convs_pair(e(1, 8, 8, 12), cab(12))
