"""One full train step of the port (superresolution_tpu_torch/train/
steps.py) against the JAX package's make_train_step, on a tiny
hybrid_astro-shaped config (RRDBNet x2 with remat, HATLite x2 with
remat, balanced smoothing, star L1, AdamW with clip and cosine), from
JAX-initialised params bridged across and the same numpy batch, augment
off: the loss, grad_norm and the params after the step.

f32: loss to 1e-5, grad_norm to 1e-4. bf16: the frameworks round the
activations at different points; the loss agrees to 1e-2. The JAX bf16
step on the CPU also sums the bias gradients less exactly: at this
config its grad_norm is 5.4% below the f32 step's, the port's 0.2%
above. So in bf16 grad_norm is held to 1e-2 of the f32 step's (the
port's f32 gradients, which equal JAX's to 1e-4) and to 1e-1 of the JAX
bf16 step's. The first AdamW step moves each param by about lr * sign(g):
params are compared to 1e-6 (f32) where |g| > 1e-3 max |g| (f32) or
where the two frameworks' gradients agree in sign and |g| > 0.1 max |g|
(bf16), and within 2 lr everywhere. In bf16 the bar there is 2e-2 lr:
the step is g_c / (|g_c| + 1e-8) for the clipped g_c = g / grad_norm,
so the two grad_norms move a step where |g_c| is under ~1e-6."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from superresolution_tpu.losses.combined import CombinedLoss as JaxLoss
from superresolution_tpu.models.factory import build_from_config as jax_build
from superresolution_tpu.train.state import (
    create_train_state as jax_create_state,
    make_optimizer as jax_make_opt,
)
from superresolution_tpu.train.steps import (
    make_device_input as jax_input,
    make_train_step as jax_make_step,
)
from superresolution_tpu.utils import config as jcfg
from superresolution_tpu.utils.precision import get_policy as jax_policy
from superresolution_tpu_torch.data.dataset import SyntheticHRDataset
from superresolution_tpu_torch.losses.combined import CombinedLoss
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.factory import build_from_config
from superresolution_tpu_torch.ops.degradation import degrade_bicubic
from superresolution_tpu_torch.train.fused_apply import (
    make_fused_train_apply,
)
from superresolution_tpu_torch.train.state import (
    create_train_state,
    global_norm,
    make_optimizer,
)
from superresolution_tpu_torch.train.steps import (
    make_device_input,
    make_train_step,
)
from superresolution_tpu_torch.utils import config as tcfg
from superresolution_tpu_torch.utils.precision import get_policy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These CPU tensors are small: intra-op threads gain nothing, and on
    a host loaded by parallel test workers their spin-waits cost several
    times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 5e-4


def _configs(mod, precision):
    mc = mod.ModelConfig(
        name="rrdbnet", scale=2, in_channels=1, out_channels=1,
        kwargs={"features": 16, "num_blocks": 2, "growth": 8, "remat": True},
        refiner="hat_lite",
        refiner_kwargs={"scale": 2, "embed_dim": 16, "depths": (2, 2),
                        "num_heads": (2, 2), "window_size": 8,
                        "remat": True},
        smoothing="balanced")
    dc = mod.DataConfig(hr_patch=64, batch_size=2, degradation="none",
                        augment=False)
    tc = mod.TrainConfig(lr=LR, precision=precision)
    return mc, dc, mod.LossConfig(terms={"star_l1": 1.0}), tc


@functools.cache
def _jax_model():
    """The JAX model and its initial variables, shared by every case (the
    model config does not depend on the precision)."""
    jm = jax_build(_configs(jcfg, "fp32")[0], output_size=64)
    return jm, jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 1)))


def _batch():
    ds = SyntheticHRDataset(2, 64, 1, seed=1, lr_scale=4)
    return {k: np.stack([ds[i][k] for i in range(2)]) for k in ("lr", "hr")}


def _grads(tm, lc, tb, policy):
    """The port's gradients of the plain forward's loss on batch tb."""
    leaves = {k: p.detach().clone().requires_grad_()
              for k, p in tm.named_parameters()}
    pred = functional_call(tm, policy.cast_to_compute(leaves),
                           (tb["lr"].to(policy.compute_dtype),))
    loss = CombinedLoss(lc)(pred.float(), tb["hr"])[0]
    return dict(zip(leaves, torch.autograd.grad(loss,
                                                list(leaves.values()))))


@pytest.mark.parametrize("precision,accum,fused", [
    ("fp32", 1, False), ("bf16", 1, True), ("fp32", 2, True)])
def test_train_step_matches_jax(precision, accum, fused):
    batch = _batch()
    # JAX
    mc, dc, lc, tc = _configs(jcfg, precision)
    jm, variables = _jax_model()
    jtx, _ = jax_make_opt(tc, total_steps=10)
    jstate = jax_create_state(variables, jtx)
    jstep = jax.jit(jax_make_step(jm, JaxLoss(lc), jtx,
                                  jax_policy(precision), jax_input(dc, 4),
                                  accum_steps=accum))
    jnew, jlogs = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                        jax.random.key(1))
    ref_p = convert.hybrid_state_dict_from_jax(
        jax.tree.map(np.asarray, jnew.params), num_blocks=2, features=16,
        growth=8, depths=(2, 2))

    # the port, from the same params
    mc, dc, lc, tc = _configs(tcfg, precision)
    tm = build_from_config(mc, output_size=64, device="cpu")
    tm.load_state_dict(convert.to_torch(convert.hybrid_state_dict_from_jax(
        variables, num_blocks=2, features=16, growth=8, depths=(2, 2))),
        strict=True)
    policy = get_policy(precision)
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = _grads(tm, lc, tb, policy)
    tx, _ = make_optimizer(tc, total_steps=10)
    state = create_train_state(params, tx)
    step = make_train_step(tm, CombinedLoss(lc), tx, policy,
                           make_device_input(dc, 4), accum_steps=accum,
                           apply_fn=make_fused_train_apply(tm) if fused
                           else None)
    state, logs = step(state, tb, None)

    f32 = precision == "fp32"
    np.testing.assert_allclose(float(logs["total"]), float(jlogs["total"]),
                               rtol=1e-5 if f32 else 1e-2)
    np.testing.assert_allclose(float(logs["grad_norm"]),
                               float(jlogs["grad_norm"]),
                               rtol=1e-4 if f32 else 1e-1)
    if not f32:
        g32 = _grads(tm, lc, tb, get_policy("fp32"))
        np.testing.assert_allclose(float(logs["grad_norm"]),
                                   float(global_norm(g32)), rtol=1e-2)
    assert state.step == 1
    ref_g = {k: v.numpy() for k, v in grads.items()}
    if not f32:  # the JAX bf16 gradients, for where the signs agree
        jpol = jax_policy(precision)
        jg = jax.jit(jax.grad(lambda p: JaxLoss(_configs(jcfg, precision)[2])(
            jm.apply(jpol.cast_to_compute(p), jnp.asarray(batch["lr"])
                     .astype(jpol.compute_dtype)).astype(jnp.float32),
            jnp.asarray(batch["hr"]))[0]))(variables)
        ref_g = convert.hybrid_state_dict_from_jax(
            jax.tree.map(np.asarray, jg), num_blocks=2, features=16,
            growth=8, depths=(2, 2))
    for k, v in state.params.items():
        got, ref = v.numpy(), ref_p[k]
        g, rg = grads[k].numpy(), ref_g[k]
        gmax = np.abs(g).max()
        sure = (np.abs(g) > 1e-3 * gmax if f32 else
                (np.sign(g) == np.sign(rg)) & (np.abs(g) > 0.1 * gmax))
        np.testing.assert_allclose(got[sure], ref[sure], rtol=0,
                                   atol=1e-6 if f32 else 2e-2 * LR,
                                   err_msg=k)
        assert np.all(np.abs(got - ref) <= 2 * LR), k


def test_device_input_and_accum_errors():
    # bicubic makes LR from the batch's HR: clip(degrade_bicubic(hr))
    dc = dataclasses.replace(tcfg.DataConfig(), degradation="bicubic")
    hr = torch.from_numpy(np.random.default_rng(0).random(
        (2, 16, 16, 1), dtype=np.float32))
    lr, hr_out = make_device_input(dc, 4, augment=False)({"hr": hr}, None)
    torch.testing.assert_close(lr, degrade_bicubic(hr, 4).clamp(0.0, 1.0))
    assert lr.shape == (2, 4, 4, 1) and torch.equal(hr_out, hr)
    fn = make_device_input(dataclasses.replace(dc, degradation="none"), 4)
    with pytest.raises(ValueError, match="real LR"):
        fn({"hr": torch.zeros(1, 8, 8, 1)}, None)
    mc, dc, lc, tc = _configs(tcfg, "fp32")
    tm = build_from_config(mc, output_size=64, device="cpu")
    tx, _ = make_optimizer(tc, 10)
    step = make_train_step(tm, CombinedLoss(lc), tx, get_policy("fp32"),
                           make_device_input(dc, 4), accum_steps=2)
    state = create_train_state({k: p.detach() for k, p in
                                tm.named_parameters()}, tx)
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    b3 = {k: torch.cat([v, v[:1]]) for k, v in b.items()}
    with pytest.raises(ValueError, match="not divisible"):
        step(state, b3, None)
