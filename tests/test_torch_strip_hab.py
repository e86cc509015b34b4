"""Kernel 11 (superresolution_tpu_torch/ops/hab_strip.py: strip_hab_block)
on the CPU, where the wrapper runs its plain version, against the JAX
package's Pallas strip_hab_block in interpret mode on the same numpy
inputs: the reference test's geometry (tests/test_fused_hat.py:60: b 2,
16 x 24, C 12, 3 heads, window 4, MLP 24) at both shifts and two row
blocks, in f32 to the reference's own bar (atol 2e-5, rtol 2e-4). q/k
weights and the rel-pos bias are large enough that the softmax, and so
the region mask, matter. Also the wrapper's raises, and that a tensor
off the CPU never takes the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import pallas_hab as jhab
from superresolution_tpu.ops import pallas_hab_strip as jstrip
from superresolution_tpu_torch.ops import hab
from superresolution_tpu_torch.ops.hab_strip import (
    strip_hab_block,
    strip_weights,
)

B, H, W, C, NH, WS, MLP = 2, 16, 24, 12, 3, 4, 24
N = WS * WS
ATOL, RTOL = 2e-5, 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed=1):
    """x, cab_y, se and the weights in the reference's layout (wq, wk,
    wv, [1, C] rows) and the port's (HAB_WEIGHTS: wqkv, flat rows)."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x, cab_y = r(B, H, W, C, s=0.5), r(B, H, W, C, s=0.3)
    se = rng.uniform(0.2, 0.9, (B, 1, C)).astype(np.float32)
    jw = {"ln1_s": 1 + r(1, C), "ln1_b": r(1, C), "wq": r(C, C, s=0.6),
          "wk": r(C, C, s=0.6), "wv": r(C, C, s=0.3), "bq": r(1, C),
          "bk": r(1, C), "bv": r(1, C), "rpb": r(NH, N, N, s=1.0),
          "wp": r(C, C, s=0.3), "bp": r(1, C), "ln2_s": 1 + r(1, C),
          "ln2_b": r(1, C), "w1": r(C, MLP, s=0.3), "b1": r(1, MLP),
          "w2": r(MLP, C, s=0.3), "b2": r(1, C)}
    tw = {k: torch.from_numpy(v.reshape(-1) if v.shape[0] == 1 else v)
          for k, v in jw.items() if k[1:] not in ("q", "k", "v")}
    tw["wqkv"] = torch.from_numpy(np.concatenate(
        [jw["wq"], jw["wk"], jw["wv"]], axis=1))
    tw["bqkv"] = torch.from_numpy(np.concatenate(
        [jw["bq"], jw["bk"], jw["bv"]], axis=1).reshape(-1))
    assert set(tw) == set(hab.HAB_WEIGHTS)
    return x, cab_y, se, jw, tw


@pytest.mark.parametrize("rb", [4, 8])
@pytest.mark.parametrize("shift", [0, 2])
def test_strip_hab_block_matches_jax_kernel(shift, rb):
    x, cab_y, se, jw, tw = _case()
    ref = jstrip.strip_hab_block(
        jnp.asarray(x), jnp.asarray(cab_y), jnp.asarray(se),
        {k: jnp.asarray(v) for k, v in jw.items()}, num_heads=NH,
        window_size=WS, shift=shift, interpret=True, rb=rb)
    got = strip_hab_block(torch.from_numpy(x), torch.from_numpy(cab_y),
                          torch.from_numpy(se), tw, num_heads=NH,
                          window_size=WS, shift=shift, rb=rb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_strip_weights_takes_the_reference_stacked_rpb():
    """strip_weights unstacks the reference's [nh*n, n] rel-pos layout
    (block h = rpb[h].T), so the result does not depend on it."""
    x, cab_y, se, jw, tw = _case(2)
    stacked = np.array(jhab._stack_rpb(jnp.asarray(jw["rpb"]), NH, N))
    w2 = dict(tw, rpb=torch.from_numpy(stacked))
    np.testing.assert_array_equal(strip_weights(w2, NH, N)["rpb"].numpy(),
                                  jw["rpb"])
    args = (torch.from_numpy(x), torch.from_numpy(cab_y),
            torch.from_numpy(se))
    kw = dict(num_heads=NH, window_size=WS, shift=WS // 2)
    np.testing.assert_array_equal(strip_hab_block(*args, w2, **kw).numpy(),
                                  strip_hab_block(*args, tw, **kw).numpy())


def test_strip_hab_block_raises():
    x, cab_y, se, _, tw = _case()
    x, cab_y, se = (torch.from_numpy(a) for a in (x, cab_y, se))
    kw = dict(num_heads=NH, window_size=WS)
    with pytest.raises(ValueError, match="shift"):
        strip_hab_block(x, cab_y, se, tw, shift=1, **kw)
    with pytest.raises(ValueError, match="multiples"):
        strip_hab_block(x[:, :14], cab_y[:, :14], se, tw, **kw)
    for rb in (6, 12, 2):  # not a multiple of ws, not dividing H, < ws
        with pytest.raises(ValueError, match="rb"):
            strip_hab_block(x, cab_y, se, tw, rb=rb, **kw)
    with pytest.raises(ValueError, match="se"):
        strip_hab_block(x, cab_y, se[:, 0], tw, **kw)


def test_strip_hab_block_off_the_cpu_launches_or_raises():
    m = torch.device("meta")

    def e(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, device=m, dtype=dtype)

    f32 = torch.float32
    hw = {"ln1_s": e(96, dtype=f32), "ln1_b": e(96, dtype=f32),
          "wqkv": e(96, 288), "bqkv": e(288, dtype=f32),
          "rpb": e(6, 64, 64, dtype=f32), "wp": e(96, 96),
          "bp": e(96, dtype=f32), "ln2_s": e(96, dtype=f32),
          "ln2_b": e(96, dtype=f32), "w1": e(96, 192),
          "b1": e(192, dtype=f32), "w2": e(192, 96), "b2": e(96, dtype=f32)}
    x = e(1, 16, 16, 96)
    with pytest.raises(ValueError, match="CUDA"):
        strip_hab_block(x, x, e(1, 1, 96, dtype=f32), hw, num_heads=6,
                        window_size=8, shift=4)
    with pytest.raises(ValueError, match="takes"):
        strip_hab_block(e(1, 16, 16, 12), e(1, 16, 16, 12),
                        e(1, 1, 12, dtype=f32), hw, num_heads=3,
                        window_size=4)
