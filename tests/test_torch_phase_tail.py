"""B2/B3 (superresolution_tpu_torch/ops/phase_tail.py) and the port's x4
tails (infer/phase_tail.py, infer/folded_tail.py) against the JAX
package's phase tail (Pallas, interpret mode) and folded tail, on the same
numpy-seeded inputs and weights, in f32 on the CPU (where the ops run
their plain versions). Tolerances are tests/test_phase_tail.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.infer import folded_tail as jfold
from superresolution_tpu.infer.phase_tail import (
    make_phase_tail as jax_make_phase_tail,
    permute_up2,
)
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.ops.pallas_phase_tail import (
    phase_hr_last as jax_phase_hr_last,
)
from superresolution_tpu.ops.pixel_shuffle import depth_to_space
from superresolution_tpu_torch.infer.folded_tail import (
    fold_stage2_kernel,
    make_folded_tail,
)
from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.ops.phase_tail import phase_hr_last

TOL = dict(atol=3e-5, rtol=2e-4)


def _params(seed=0):
    model = JaxRRDBNet(scale=4, in_channels=3, out_channels=3, features=16,
                       num_blocks=1, growth=8, upsampler="pixelshuffle")
    variables = model.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    sd = convert.rrdbnet_state_dict_from_jax(variables, num_blocks=1,
                                             features=16, growth=8)
    return variables, sd


def _feat(seed, h, w, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((2, h, w, 16))
            * scale).astype(np.float32)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("h,w,rb", [(8, 12, 4), (12, 20, 3)])
def test_phase_tail_matches_jax(h, w, rb, clip):
    variables, sd = _params()
    feat = _feat(1, h, w, scale=3.0 if clip else 0.3)
    ref = jax_make_phase_tail(variables, clip=clip, rb=rb,
                              interpret=True)(feat)
    got = make_phase_tail(sd, clip=clip, device="cpu")(
        torch.from_numpy(feat))
    assert got.shape == ref.shape == (2, 4 * h, 4 * w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_phase_hr_last_matches_jax_kernels():
    variables, _ = _params(2)
    p = variables["params"]
    up2, hr, last = (p["up"]["Conv_1"]["Conv_0"], p["conv_hr"]["Conv_0"],
                     p["conv_last"]["Conv_0"])
    z1 = np.maximum(_feat(2, 8, 12, 1.0).repeat(4, -1), 0)  # [2,8,12,64]
    kfp, b2 = permute_up2(jfold.fold_stage2_kernel(
        np.asarray(up2["kernel"], np.float32)), np.asarray(up2["bias"]))
    ref = depth_to_space(jax_phase_hr_last(
        jnp.asarray(z1), kfp, b2, hr["kernel"], hr["bias"], last["kernel"],
        last["bias"], width=12, interpret=True, rb=4), 4)
    t = [torch.from_numpy(np.array(a, np.float32)) for a in (
        up2["kernel"], up2["bias"], hr["kernel"], hr["bias"],
        last["kernel"], last["bias"])]
    got = phase_hr_last(torch.from_numpy(z1), *t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_folded_tail_matches_jax():
    variables, sd = _params(3)
    feat = _feat(3, 6, 10)
    ref = jfold.make_folded_tail(variables, clip=False)(feat)
    got = make_folded_tail(sd, clip=False, device="cpu")(
        torch.from_numpy(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fold_stage2_kernel_matches_jax():
    k3 = np.random.default_rng(4).standard_normal((3, 3, 4, 16)) \
        .astype(np.float32)
    np.testing.assert_array_equal(fold_stage2_kernel(k3),
                                  jfold.fold_stage2_kernel(k3))


def test_phase_tail_rejects_other_tails():
    _, sd = _params()
    with pytest.raises(ValueError):
        make_phase_tail({k: v for k, v in sd.items()
                         if not k.startswith("conv_up2")}, device="cpu")
