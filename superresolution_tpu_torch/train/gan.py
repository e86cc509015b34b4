"""ESRGAN-style adversarial training step.

Counterpart of superresolution_tpu/train/gan.py:23-115. The generator's
loss is the pixel loss (the CombinedLoss: l1 / charbonnier, perceptual,
...) + gan_weight * adv_on * relativistic-G; the discriminator trains on
relativistic-D. One step, in the reference's order:

  1. one input_fn draw, shared by D and G;
  2. D's loss and gradients over the k micro-batches, the generator's
     pred from a no-grad forward (gen_apply_fn, e.g. the fused train
     apply, when set; recomputed here rather than kept from G's pass, so
     no micro-batch's generator graph outlives its own backward);
  3. D's update, or, before gan_start_step, no update at all: the whole
     D state (params, AdamW moments, count, step) holds at its init, as
     the reference's select does (weight decay would otherwise move it);
  4. G's loss and gradients over the micro-batches against the updated
     D, the real logits without gradient and no D gradient computed;
     then G's update (with EMA when ema_decay is set).

Forwards run torch.func.functional_call on policy.cast_to_compute of
the f32 masters, the losses on f32, and gradients and logs are averaged
over the k micro-batches, all as train/steps.py does (its
micro_batches and accumulate); logs stay on the card.
Before gan_start_step D's loss is still computed and logged (without its
gradient, which the reference computes and discards) and G's adversarial
term is logged with weight 0 (no backward through D).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from superresolution_tpu_torch.losses.gan import (
    relativistic_gan_d_loss,
    relativistic_gan_g_loss,
)
from superresolution_tpu_torch.train.state import TrainState
from superresolution_tpu_torch.train.steps import accumulate, micro_batches
from superresolution_tpu_torch.utils.precision import Policy


def make_gan_steps(gen_model, disc_model, pixel_loss_fn, gen_tx, disc_tx,
                   policy: Policy, input_fn: Callable, gan_weight: float,
                   ema_decay: float | None = None, gan_start_step: int = 0,
                   accum_steps: int = 1,
                   gen_apply_fn: Callable | None = None) -> Callable:
    """-> gan_train_step(g_state, d_state, batch, generator) -> (g_state,
    d_state, logs); both states are updated in place. gen_apply_fn(params,
    lr) -> pred replaces the plain generator forward (same math)."""

    def gen_forward(g_params, lr):
        params_c = policy.cast_to_compute(g_params)
        lr_c = lr.to(policy.compute_dtype)
        if gen_apply_fn is not None:
            return gen_apply_fn(params_c, lr_c)
        return functional_call(gen_model, params_c, (lr_c,))

    def disc_forward(d_params, img):
        return functional_call(disc_model, policy.cast_to_compute(d_params),
                               (img.to(policy.compute_dtype),)).float()

    def d_grads(d_params, g_params, lr, hr, with_grad: bool):
        with torch.no_grad():
            pred = gen_forward(g_params, lr).float()
        hrf = hr.float()
        leaves = {k: v.detach().requires_grad_(with_grad)
                  for k, v in d_params.items()}
        with torch.set_grad_enabled(with_grad):
            loss = relativistic_gan_d_loss(disc_forward(leaves, hrf),
                                           disc_forward(leaves, pred))
        grads = (dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))) if with_grad else {})
        return grads, {"d_loss": loss.detach()}

    def g_grads(g_params, d_params, adv_on: bool, lr, hr):
        leaves = {k: v.detach().requires_grad_() for k, v in g_params.items()}
        with torch.enable_grad():
            pred = gen_forward(leaves, lr).float()
            hrf = hr.float()
            pixel, logs = pixel_loss_fn(pred, hrf)
            with torch.no_grad():
                real_logits = disc_forward(d_params, hrf)
            with torch.set_grad_enabled(adv_on):
                fake_logits = disc_forward(d_params,
                                           pred if adv_on else pred.detach())
            g_adv = relativistic_gan_g_loss(real_logits, fake_logits)
            total = pixel + gan_weight * float(adv_on) * g_adv
            grads = torch.autograd.grad(total, list(leaves.values()))
        logs = {k: v.detach() for k, v in logs.items()}
        logs.update(g_adv=g_adv.detach(), g_total=total.detach())
        return dict(zip(leaves, grads)), logs

    def gan_train_step(g_state: TrainState, d_state: TrainState, batch: dict,
                       generator: torch.Generator | None):
        lr, hr = input_fn(batch, generator)
        micro = micro_batches(lr, hr, accum_steps)
        adv_on = g_state.step >= gan_start_step
        d_g, d_logs = accumulate(
            lambda a, b: d_grads(d_state.params, g_state.params, a, b,
                                 adv_on), micro)
        if adv_on:
            d_state.apply_gradients(d_g, disc_tx)
        del d_g
        g_g, g_logs = accumulate(
            lambda a, b: g_grads(g_state.params, d_state.params, adv_on,
                                 a, b), micro)
        g_state.apply_gradients(g_g, gen_tx, ema_decay)
        logs = {**d_logs, **g_logs, "adv_on": torch.tensor(
            float(adv_on), dtype=torch.float32, device=lr.device)}
        return g_state, d_state, logs

    return gan_train_step
