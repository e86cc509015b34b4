"""The reference's training step: the hybrid's forward and backward in
float32, the star-weighted L1, global-norm clipping, AdamW and its
cosine schedule, written out from their definitions (optax's
arithmetic, which the configuration states), and the pairs' augmentation
replayed from the same generator state the program's step was given.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import models as R
from portbench.reference.ops import F32, Precision


def _rot90(x: torch.Tensor, k: int) -> torch.Tensor:
    if k == 0:
        return x
    if k == 1:
        return x.transpose(0, 1).flip(0)
    if k == 2:
        return x.flip((0, 1))
    return x.transpose(0, 1).flip(1)


def augment(gen_state: torch.Tensor, lr: torch.Tensor, hr: torch.Tensor):
    """Each HWC pair in batch order: a 50% horizontal flip, a 50% vertical
    flip, then k x 90 degrees, k uniform in 0..3, one draw per pair from a
    CPU generator in this order (hflip and vflip as one draw of two bits,
    then k)."""
    gen = torch.Generator()
    gen.set_state(gen_state)
    outs = []
    for a, b in zip(lr, hr):
        hflip, vflip = torch.randint(0, 2, (2,), generator=gen).tolist()
        k = int(torch.randint(0, 4, (), generator=gen))

        def apply(x):
            if hflip:
                x = x.flip(1)
            if vflip:
                x = x.flip(0)
            return _rot90(x, k)

        outs.append((apply(a), apply(b)))
    return (torch.stack([a for a, _ in outs]),
            torch.stack([b for _, b in outs]))


def star_l1(pred, target, threshold: float, weight: float) -> torch.Tensor:
    w = torch.where(target > threshold, weight, 1.0)
    return ((pred - target).abs() * w).mean()


def cosine_lr(t: dict, total_steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(lr, total_steps, alpha=lr_min / lr) at
    `count`, in float32."""
    f32 = np.float32
    c = f32(min(count, total_steps))
    cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(total_steps)))
    alpha = f32(t["lr_min"] / t["lr"])
    return float(f32(t["lr"]) * ((f32(1) - alpha) * cos + alpha))


def norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(v.double().square().sum() for v in tree.values()))


class Steps:
    """Reference steps from weights p (copied, in float32, or float64 for a
    witness), each over a batch (lr, hr, generator state): the pairs the
    program's loader handed its step, as the benchmark made them."""

    def __init__(self, cfg: dict, p: dict, total_steps: int,
                 pr: Precision = F32, half_batch: bool = False,
                 dtype: torch.dtype = torch.float32):
        self.cfg, self.t = cfg["model"], cfg["train"]
        self.dtype = dtype
        self.p = {k: v.detach().to(dtype).clone() for k, v in p.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count, self.total = 0, total_steps
        self.pr, self.half_batch = pr, half_batch

    def grads(self, lr: torch.Tensor, hr: torch.Tensor):
        """(mean loss, mean gradient) over the batch, one sample at a time
        (the loss is a mean over equal-sized images, so the batch's
        gradient is the mean of the samples')."""
        t = self.t
        n = lr.shape[0] // 2 if self.half_batch else lr.shape[0]
        leaves = {k: v.requires_grad_() for k, v in self.p.items()}
        g = {k: torch.zeros_like(v) for k, v in self.p.items()}
        total = 0.0
        for i in range(n):
            with torch.enable_grad():
                pred = R.hybrid(leaves, self.cfg, lr[i:i + 1],
                                t["hr_patch"], self.pr, checkpoint=True)
                loss = star_l1(pred, hr[i:i + 1], t["star_threshold"],
                               t["star_weight"]) / n
                gi = torch.autograd.grad(loss, list(leaves.values()))
            for k, v in zip(leaves, gi):
                g[k] += v
            total += float(loss.detach())
        for v in leaves.values():
            v.requires_grad_(False)
        return total, g

    def step(self, lr, hr, gen_state) -> tuple[float, dict, dict]:
        """One step; returns (loss, the gradient, the gradient after
        clipping: what AdamW took)."""
        t = self.t
        lr, hr = augment(gen_state, lr.to(self.dtype), hr.to(self.dtype))
        loss, g = self.grads(lr, hr)
        raw, gn = g, float(norm(g))
        if t["grad_clip_norm"] > 0 and gn >= t["grad_clip_norm"]:
            g = {k: v * (t["grad_clip_norm"] / gn) for k, v in g.items()}
        b1, b2 = t["betas"]
        tt = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** tt)
        bc2 = float(np.float32(1) - np.float32(b2) ** tt)
        step_lr = cosine_lr(t, self.total, self.count)
        for k, p in self.p.items():
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g[k]
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g[k] * g[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8)
            self.p[k] = p - step_lr * (u + t["weight_decay"] * p)
        self.count += 1
        return loss, raw, g


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def angle(prog: dict, ref: dict, skip=()) -> float:
    """The angle, in radians, between the program's tree and the
    reference's, each flattened over its leaves (those not in skip): the
    direction, which leaf norms do not see, and which products rounded
    below the stated precision turn."""
    keys = [k for k in ref if k not in skip]
    a = torch.cat([prog[k].detach().double().reshape(-1).cpu()
                   for k in keys])
    b = torch.cat([ref[k].detach().double().reshape(-1).cpu()
                   for k in keys])
    a, b = a / a.norm().clamp(min=1e-300), b / b.norm().clamp(min=1e-300)
    # 2 asin(|a - b| / 2): exact for small angles, where acos of the
    # cosine loses its digits
    return float(2.0 * torch.asin(((a - b).norm() / 2).clamp(max=1.0)))


def sign_share(prog: dict, ref: dict, skip=()) -> float:
    """The share of the elements (of the leaves not in skip, where the
    reference's is not 0) whose sign differs between the program's tree
    and the reference's: for a first gradient, the share of weights that
    AdamW's first step, which moves each weight by about the learning
    rate against its gradient's sign, moves the other way. Every element
    counts alike, so the many small gradients that one sample or another
    decides weigh as much as the few large ones all samples share."""
    diff = total = 0
    for k in ref:
        if k in skip:
            continue
        a = prog[k].detach().reshape(-1).cpu()
        b = ref[k].detach().reshape(-1).cpu()
        nz = b != 0
        diff += int((torch.sign(a[nz]) != torch.sign(b[nz])).sum())
        total += int(nz.sum())
    return diff / max(total, 1)


def leaf_gap(prog: dict, ref: dict, skip=()) -> float:
    """The largest gap between a leaf's norm in the program and in the
    reference, over the larger of that leaf's reference norm and the
    median leaf's."""
    med = float(np.median([v for k, v in ref.items() if k not in skip]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in ref if k not in skip)


def median_gap(prog: dict, ref: dict, skip=()) -> float:
    """The median over leaves of |program's norm - reference's| over the
    reference's norm: a number steady from seed to seed, where the worst
    leaf swings with one small leaf's rounding."""
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], 1e-30)
                            for k in ref if k not in skip]))


def worst_leaves(prog: dict, ref: dict, skip=(), n: int = 5) -> list:
    """The n leaves with the largest gap (leaf_gap's measure), with both
    norms and the median leaf's: what a reading that is not rounding is
    looked into by."""
    med = float(np.median([v for k, v in ref.items() if k not in skip]))
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k,
                    prog[k], ref[k]) for k in ref if k not in skip),
                  reverse=True)
    return [(k, g, p, r, med) for g, k, p, r in gaps[:n]]


def flat_leaves(ref_g: dict) -> set:
    """Leaves whose reference gradient is nought to rounding (under a
    thousandth of the median leaf's norm): Adam moves them by round-off
    alone, so their change is not compared."""
    med = float(np.median(list(ref_g.values())))
    return {k for k, v in ref_g.items() if v < 1e-3 * med}
