"""Train state and optimizer: global-norm clip, AdamW, cosine decay.

Counterpart of superresolution_tpu/train/state.py, with optax's
arithmetic written out (optax 0.2: clip_by_global_norm, scale_by_adam,
add_decayed_weights, scale_by_learning_rate, cosine_decay_schedule):

    clip:  g <- (g / |g|) * max_norm unless |g| < max_norm  (no epsilon;
           torch.nn.utils.clip_grad_norm_ adds 1e-6, so it is not this)
    adam:  mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
           u  <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + 1e-8),
           t = count + 1, the bias corrections in f32
    decay: u <- u + weight_decay * p      (every parameter)
    step:  p <- p - lr(count) * u,  lr = cosine_decay(lr, steps, lr_min/lr)
           at the count before the increment

The parameters, moments and EMA are name -> f32 tensor dicts, updated in
place with torch._foreach ops (a few multi-tensor launches per step
instead of one per tensor); `count` and `step` are host ints, so a step
reads nothing back from the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from superresolution_tpu_torch.utils.config import TrainConfig

Tree = dict[str, torch.Tensor]


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1), in f32 like the
    reference's."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return float(f32(init_value) * ((f32(1) - f32(alpha)) * cos
                                        + f32(alpha)))

    return schedule


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the card: the
    norm of the per-leaf norms (a few multi-tensor launches)."""
    norms = torch._foreach_norm([t.float() for t in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclass
class AdamW:
    """clip_by_global_norm (when clip_norm > 0) then optax.adamw."""

    schedule: object
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    clip_norm: float = 0.0

    def init(self, params: Tree) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update_(self, grads: Tree, opt_state: dict, params: Tree) -> None:
        """One step, in place on params and opt_state."""
        names = list(params)
        g = [grads[k] for k in names]
        if self.clip_norm and self.clip_norm > 0:
            norm = global_norm(grads)
            scale = torch.where(norm < self.clip_norm,
                                torch.ones_like(norm), self.clip_norm / norm)
            g = torch._foreach_mul(g, scale)
        mu = [opt_state["mu"][k] for k in names]
        nu = [opt_state["nu"][k] for k in names]
        p = [params[k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        count = opt_state["count"]
        t = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_add_(p, u, alpha=-self.schedule(count))
        opt_state["count"] = count + 1


def make_optimizer(cfg: TrainConfig, total_steps: int,
                   lr: float | None = None):
    """-> (optimizer, schedule), as the reference's make_optimizer."""
    base_lr = lr if lr is not None else cfg.lr
    schedule = cosine_decay_schedule(base_lr, max(1, total_steps),
                                     alpha=cfg.lr_min / base_lr)
    return AdamW(schedule, b1=cfg.betas[0], b2=cfg.betas[1],
                 weight_decay=cfg.weight_decay,
                 clip_norm=cfg.grad_clip_norm), schedule


@dataclass
class TrainState:
    step: int
    params: Tree
    opt_state: dict
    ema_params: Tree | None = None

    def apply_gradients(self, grads: Tree, tx: AdamW,
                        ema_decay: float | None = None) -> "TrainState":
        """One optimizer step, in place; returns self."""
        tx.update_(grads, self.opt_state, self.params)
        if self.ema_params is not None and ema_decay is not None:
            names = list(self.params)
            ema = [self.ema_params[k] for k in names]
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, [self.params[k].float() for k in names],
                                alpha=1.0 - ema_decay)
        self.step += 1
        return self

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.params,
                "opt_state": self.opt_state, "ema_params": self.ema_params}


def create_train_state(params: Tree, tx: AdamW,
                       ema: bool = False) -> TrainState:
    return TrainState(
        step=0, params=params, opt_state=tx.init(params),
        ema_params={k: v.detach().float().clone() for k, v in params.items()}
        if ema else None)
