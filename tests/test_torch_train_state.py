"""The port's optimizer (superresolution_tpu_torch/train/state.py) against
optax as the JAX package builds it (train/state.make_optimizer): global
norm clip, AdamW and the cosine schedule, 5 steps on the same numpy
params and gradients, to 1e-6.

Adam's first steps are about lr * sign(g), so where |g| is tiny a last-
bit difference can flip the step: params are compared to 1e-6 where
|g| > 1e-3 max |g| and within 2 lr elsewhere."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from superresolution_tpu.train.state import make_optimizer as jax_make_opt
from superresolution_tpu.utils.config import TrainConfig as JaxTrainConfig
from superresolution_tpu_torch.train import state as S
from superresolution_tpu_torch.utils.config import TrainConfig


def _tree(rng, scale=1.0):
    return {"a.weight": (rng.standard_normal((4, 3, 3, 3)) * scale)
            .astype(np.float32),
            "a.bias": (rng.standard_normal(4) * scale).astype(np.float32),
            "b.weight": (rng.standard_normal((5, 7)) * scale)
            .astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_five_steps_match_optax(clip):
    cfg = dict(lr=5e-4, lr_min=1e-7, weight_decay=1e-2, grad_clip_norm=clip)
    jtx, jsched = jax_make_opt(JaxTrainConfig(**cfg), total_steps=7)
    tx, sched = S.make_optimizer(TrainConfig(**cfg), total_steps=7)
    rng = np.random.default_rng(0)
    p0 = _tree(rng, 0.1)
    jp = jax.tree.map(jnp.asarray, p0)
    jst = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = tx.init(tp)
    for step in range(5):
        # norms above and below the clip of 1.0 on alternate steps
        g = _tree(rng, 0.3 if step % 2 else 0.02)
        up, jst = jtx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, up)
        tx.update_({k: torch.from_numpy(v) for k, v in g.items()}, tst, tp)
        assert abs(sched(step) - float(jsched(step))) <= 1e-12 + 1e-7 * 5e-4
        gmax = max(np.abs(v).max() for v in g.values())
        for k in p0:
            got, ref = tp[k].numpy(), np.asarray(jp[k])
            big = np.abs(g[k]) > 1e-3 * gmax
            np.testing.assert_allclose(got[big], ref[big], atol=1e-6,
                                       rtol=0, err_msg=f"{k} step {step}")
            assert np.all(np.abs(got - ref) <= 2 * 5e-4)
    assert tst["count"] == 5
    adam = jst[-1][0]  # the chain's adamw: (ScaleByAdamState, ...)
    # the moments to 1e-6 of each tensor's max (the clip scales g by
    # max/|g| where optax divides by |g| and then multiplies: last bits)
    for k in p0:
        for got, ref in ((tst["mu"][k], adam.mu[k]),
                         (tst["nu"][k], adam.nu[k])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max())


def test_schedule_and_clip_semantics():
    sched = S.cosine_decay_schedule(4e-4, 10, alpha=1e-7 / 4e-4)
    ref = optax.cosine_decay_schedule(4e-4, 10, alpha=1e-7 / 4e-4)
    for c in (0, 1, 5, 9, 10, 25):
        assert abs(sched(c) - float(ref(c))) <= 1e-7 * 4e-4
    with pytest.raises(ValueError):
        S.cosine_decay_schedule(1.0, 0)
    # a norm exactly at the bound is clipped (optax keeps only norm < max)
    tx = S.AdamW(lambda c: 0.0, clip_norm=2.0, weight_decay=0.0)
    g = {"w": torch.tensor([1.2, 1.6])}  # norm 2
    p = {"w": torch.zeros(2)}
    st = tx.init(p)
    tx.update_(g, st, p)
    np.testing.assert_allclose(st["mu"]["w"].numpy(), [0.12, 0.16],
                               rtol=1e-6)


def test_train_state_ema_and_step():
    tx, _ = S.make_optimizer(dataclasses.replace(TrainConfig(), lr=1e-3),
                             total_steps=4)
    p = {"w": torch.ones(3)}
    st = S.create_train_state(p, tx, ema=True)
    st.apply_gradients({"w": torch.full((3,), 0.5)}, tx, ema_decay=0.9)
    assert st.step == 1 and st.opt_state["count"] == 1
    np.testing.assert_allclose(st.ema_params["w"].numpy(),
                               0.9 + 0.1 * p["w"].numpy(), rtol=1e-6)
    assert set(st.state_dict()) == {"step", "params", "opt_state",
                                    "ema_params"}
