"""Train and eval steps: the device input stage (degradation,
augmentation), gradient accumulation, the bf16 policy.

Counterpart of superresolution_tpu/train/steps.py. The forward runs
torch.func.functional_call(model, policy.cast_to_compute(params), lr)
(or `apply_fn`, e.g. train/fused_apply.py's, on the same cast params),
the loss on pred.float(), and autograd takes the gradient to the f32
masters through the cast. Accumulation sums the micro-batch gradients
and logs and scales them by 1/k, as the reference's scan does. Nothing
in a step reads a value back to the host: the logs stay on the card.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from superresolution_tpu_torch.data.augment import paired_augment
from superresolution_tpu_torch.metrics.psnr_ssim import psnr, ssim
from superresolution_tpu_torch.ops.degradation import (
    MODES,
    degradation_pipeline,
)
from superresolution_tpu_torch.train.state import TrainState, global_norm
from superresolution_tpu_torch.utils.config import DataConfig
from superresolution_tpu_torch.utils.precision import Policy


def make_device_input(data_cfg: DataConfig, scale: int,
                      augment: bool | None = None) -> Callable:
    """-> input_fn(batch, generator) -> (lr, hr) on the batch's device.
    A batch's own `lr` (real pairs) wins whatever the mode; otherwise LR
    is made from `hr` by ops/degradation.degradation_pipeline under
    data_cfg.degradation, each image with its own draws from `generator`
    (then the augmentation draws, per pair)."""
    do_augment = data_cfg.augment if augment is None else augment
    mode = data_cfg.degradation
    if mode not in MODES:
        raise ValueError(f"unknown degradation mode {mode!r}")

    def input_fn(batch: dict, generator: torch.Generator | None):
        hr = batch["hr"]
        if "lr" in batch:
            lr = batch["lr"]
        elif mode == "none":
            raise ValueError("degradation 'none' requires real LR data")
        else:
            lr = degradation_pipeline(
                generator, hr, scale, mode, blur_sigma=data_cfg.blur_sigma,
                noise_sigma=data_cfg.noise_sigma,
                jpeg_quality=data_cfg.jpeg_quality)
        if do_augment:
            pairs = [paired_augment(generator, a, b) for a, b in zip(lr, hr)]
            lr = torch.stack([a for a, _ in pairs])
            hr = torch.stack([b for _, b in pairs])
        return lr, hr

    return input_fn


def micro_batches(lr: torch.Tensor, hr: torch.Tensor, accum_steps: int
                  ) -> list:
    """The k micro-batches of ONE batch, k = min(accum_steps, batch) (more
    of them than samples would leave empty ones, so k is clamped as in
    the reference); raises when k does not divide the batch."""
    b = lr.shape[0]
    k = max(1, min(accum_steps, b))
    if b % k:
        raise ValueError(
            f"batch {b} is not divisible by accum_steps {k}: {b % k} "
            "samples per step would be silently dropped — pick "
            "accum_steps that divides the batch")
    m = b // k
    return [(lr[i * m:(i + 1) * m], hr[i * m:(i + 1) * m])
            for i in range(k)]


def accumulate(grad_fn: Callable, micro: list) -> tuple[dict, dict]:
    """The mean (grads, logs) of grad_fn(lr, hr) over the micro-batches,
    summed as they come (one micro-batch's graph alive at a time) and
    scaled by 1/k, as the reference's scan does."""
    grads, logs = grad_fn(*micro[0])
    for lr, hr in micro[1:]:
        g, lg = grad_fn(lr, hr)
        grads = {n: grads[n] + g[n] for n in grads}
        logs = {n: logs[n] + lg[n] for n in logs}
    if len(micro) > 1:
        inv = 1.0 / len(micro)
        grads = {n: v * inv for n, v in grads.items()}
        logs = {n: v * inv for n, v in logs.items()}
    return grads, logs


def make_train_step(model, loss_fn, tx, policy: Policy, input_fn: Callable,
                    accum_steps: int = 1, ema_decay: float | None = None,
                    apply_fn: Callable | None = None) -> Callable:
    """-> train_step(state, batch, generator) -> (state, logs); the state
    is updated in place. apply_fn(params, lr) -> pred replaces the plain
    forward (same math)."""
    def apply(p, x):
        if apply_fn is not None:
            return apply_fn(p, x)
        return functional_call(model, p, (x,))

    def grad_fn(params, lr, hr):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            pred = apply(policy.cast_to_compute(leaves),
                         lr.to(policy.compute_dtype))
            total, logs = loss_fn(pred.float(), hr.float())
            grads = torch.autograd.grad(total, list(leaves.values()))
        return (dict(zip(leaves, grads)),
                {k: v.detach() for k, v in logs.items()})

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None):
        lr, hr = input_fn(batch, generator)
        grads, logs = accumulate(lambda a, b: grad_fn(state.params, a, b),
                                 micro_batches(lr, hr, accum_steps))
        logs["grad_norm"] = global_norm(grads)
        state.apply_gradients(grads, tx, ema_decay)
        return state, logs

    return train_step


def make_eval_step(model, policy: Policy, input_fn: Callable | None = None,
                   use_ema: bool = False) -> Callable:
    """-> eval_step(state, batch, generator) -> metrics dict (f32): the
    plain model's forward, PSNR/SSIM sums masked by the loader's `_valid`
    (padded rows count for nothing), their means, and pred / lr / hr."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict,
                  generator: torch.Generator | None = None):
        if input_fn is not None:
            lr, hr = input_fn(batch, generator)
        else:
            lr, hr = batch["lr"], batch["hr"]
        params = (state.ema_params if use_ema and state.ema_params
                  is not None else state.params)
        pred = functional_call(model, policy.cast_to_compute(params),
                               (lr.to(policy.compute_dtype),))
        pred = pred.float().clamp(0.0, 1.0)
        hrf = hr.float()
        valid = batch.get("_valid")
        valid = (torch.ones(hrf.shape[0], device=hrf.device) if valid is None
                 else valid.float())
        psnr_i = psnr(pred, hrf)
        ssim_i = ssim(pred, hrf.clamp(0.0, 1.0))
        n = valid.sum()
        return {"psnr_sum": (psnr_i * valid).sum(),
                "ssim_sum": (ssim_i * valid).sum(), "n": n,
                "psnr": (psnr_i * valid).sum() / n.clamp(min=1.0),
                "ssim": (ssim_i * valid).sum() / n.clamp(min=1.0),
                "pred": pred, "lr": lr, "hr": hrf}

    return eval_step
