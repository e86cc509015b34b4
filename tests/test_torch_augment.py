"""The port's paired dihedral augmentation (superresolution_tpu_torch/
data/augment.py) against the JAX package's _apply: all 8 cases exact,
and one shared draw for LR and HR."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.data.augment import _apply as jax_apply
from superresolution_tpu_torch.data.augment import _apply, paired_augment


@pytest.mark.parametrize("hflip,vflip,k",
                         list(itertools.product((0, 1), (0, 1), range(4))))
def test_dihedral_case_matches_jax(hflip, vflip, k):
    x = np.random.default_rng(k).standard_normal((6, 6, 2)).astype(np.float32)
    ref = jax_apply(jnp.asarray(x), jnp.asarray(bool(hflip)),
                    jnp.asarray(bool(vflip)), jnp.asarray(k))
    got = _apply(torch.from_numpy(x), bool(hflip), bool(vflip), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_paired_augment_shares_the_draw():
    hr = torch.arange(16 * 16, dtype=torch.float32).reshape(16, 16, 1)
    lr = hr[::4, ::4]  # the corner of each 4x4 block
    seen = set()
    for seed in range(24):
        a, b = paired_augment(torch.Generator().manual_seed(seed), lr, hr)
        # the LR pixel of each block is still the same corner of its HR
        # block after the shared flip/rotation
        corner = {(0, 0): b[::4, ::4], (0, 1): b[::4, 3::4],
                  (1, 0): b[3::4, ::4], (1, 1): b[3::4, 3::4]}
        assert any(torch.equal(a, c) for c in corner.values())
        seen.add(tuple(a.flatten()[:3].tolist()))
    assert len(seen) == 8  # every dihedral case is drawn
