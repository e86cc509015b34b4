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

With a `mesh` the step is data-parallel as train/steps.py's is
(parallel/data.py): each data rank takes its share of every micro-batch,
the relativistic losses see the whole micro-batch's logits (each rank's
block live), and D's and G's gradients and the logs are summed over the
data ranks before each update.
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
from superresolution_tpu_torch.train.steps import (
    accumulate,
    micro_batches,
    split_micro,
)
from superresolution_tpu_torch.utils.precision import Policy


def make_gan_steps(gen_model, disc_model, pixel_loss_fn, gen_tx, disc_tx,
                   policy: Policy, input_fn: Callable, gan_weight: float,
                   ema_decay: float | None = None, gan_start_step: int = 0,
                   accum_steps: int = 1,
                   gen_apply_fn: Callable | None = None,
                   mesh=None) -> Callable:
    """-> gan_train_step(g_state, d_state, batch, generator) -> (g_state,
    d_state, logs); both states are updated in place. gen_apply_fn(params,
    lr) -> pred replaces the plain generator forward (same math). With
    `mesh` (parallel/mesh.Mesh) the step is data-parallel."""

    def gen_forward(g_params, lr):
        params_c = policy.cast_to_compute(g_params)
        lr_c = lr.to(policy.compute_dtype)
        if gen_apply_fn is not None:
            return gen_apply_fn(params_c, lr_c)
        return functional_call(gen_model, params_c, (lr_c,))

    def disc_forward(d_params, img):
        return functional_call(disc_model, policy.cast_to_compute(d_params),
                               (img.to(policy.compute_dtype),)).float()

    def d_grads(split, d_params, g_params, lr, hr, with_grad: bool):
        with torch.no_grad():
            pred = gen_forward(g_params, lr).float()
        hrf = hr.float()
        leaves = {k: v.detach().requires_grad_(with_grad)
                  for k, v in d_params.items()}
        with torch.set_grad_enabled(with_grad):
            real, w = split.gather(disc_forward(leaves, hrf))
            fake, _ = split.gather(disc_forward(leaves, pred))
            loss = relativistic_gan_d_loss(real, fake)
        grads = (dict(zip(leaves, torch.autograd.grad(
            loss * w, list(leaves.values())))) if with_grad else {})
        return grads, {"d_loss": loss.detach() * split.weight}

    def g_grads(split, g_params, d_params, adv_on: bool, lr, hr):
        leaves = {k: v.detach().requires_grad_() for k, v in g_params.items()}
        with torch.enable_grad():
            pred = gen_forward(leaves, lr).float()
            hrf = hr.float()
            pixel, logs = pixel_loss_fn(pred, hrf)
            with torch.no_grad():
                real_logits, _ = split.gather(disc_forward(d_params, hrf))
            with torch.set_grad_enabled(adv_on):
                fake_logits, w = split.gather(disc_forward(
                    d_params, pred if adv_on else pred.detach()))
            g_adv = relativistic_gan_g_loss(real_logits, fake_logits)
            # the pixel terms are means over this rank's block, the
            # adversarial one a share of the whole micro-batch's
            total = (pixel * split.weight
                     + gan_weight * float(adv_on) * g_adv * w)
            grads = torch.autograd.grad(total, list(leaves.values()))
        sw = split.weight
        logs = {k: v.detach() * sw for k, v in logs.items()}
        logs.update(g_adv=g_adv.detach() * sw,
                    g_total=(pixel.detach() + gan_weight * float(adv_on)
                             * g_adv.detach()) * sw)
        return dict(zip(leaves, grads)), logs

    def gan_train_step(g_state: TrainState, d_state: TrainState, batch: dict,
                       generator: torch.Generator | None):
        lr, hr = input_fn(batch, generator)
        micro, split = split_micro(micro_batches(lr, hr, accum_steps), mesh)
        adv_on = g_state.step >= gan_start_step
        d_g, d_logs = accumulate(
            lambda a, b: d_grads(split, d_state.params, g_state.params, a, b,
                                 adv_on), micro)
        d_g, d_logs = split.reduce(d_g), split.reduce(d_logs)
        if adv_on:
            d_state.apply_gradients(d_g, disc_tx)
        del d_g
        g_g, g_logs = accumulate(
            lambda a, b: g_grads(split, g_state.params, d_state.params,
                                 adv_on, a, b), micro)
        g_g, g_logs = split.reduce(g_g), split.reduce(g_logs)
        g_state.apply_gradients(g_g, gen_tx, ema_decay)
        logs = {**d_logs, **g_logs, "adv_on": torch.tensor(
            float(adv_on), dtype=torch.float32, device=lr.device)}
        return g_state, d_state, logs

    return gan_train_step
