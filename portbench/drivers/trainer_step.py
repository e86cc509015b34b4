"""The Trainer's own step over its own loader, as Trainer.fit's inner
loop runs it: train/trainer.Trainer built from the configuration on a
manifest of 16-bit TIFF pairs the benchmark writes in set-up (the
native batch decoder, the shuffle, the prefetch to the card), stage 1
on kernels B1 and 13 (the fused train apply), stage 2 by plain autograd
with remat, kernel 14's loss, clipping and AdamW. One unit is one
optimizer step; steps are not synchronised one by one (the card runs
behind the host, as in fit), the window ends when the card is done.

Set-up runs the first three steps through the same call and feed, and
keeps what the check compares: each step's loss, the first gradient as
AdamW got it (its first moment after one step over 1 - beta1) and the
change of the weights over the three steps. The reference is given the
pairs as the benchmark made them (each rounded to 16 bits as the TIFFs
hold it), found in the pool by the batch's LR images: the loader's
decoding, pairing and order are checked with the step.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from portbench.drivers import base
from portbench.reference import train as RT
from portbench.reference.ops import F32
from portbench.traffic import generate

CHECK_STEPS = 3


def to16(a: np.ndarray) -> np.ndarray:
    """An image in [0, 1] as the 16-bit TIFF stores it."""
    return (np.clip(a, 0.0, 1.0) * 65535.0).astype(np.uint16)


def pool16(pairs: list) -> tuple[torch.Tensor, torch.Tensor]:
    """The pairs as the TIFFs hold them, in float32: ([N, h, w, 1] LR,
    [N, H, W, 1] HR)."""
    return tuple(torch.from_numpy(np.stack(
        [to16(p[i]).astype(np.float32) / np.float32(65535.0)
         for p in pairs])) for i in (0, 1))


def write_pairs(pairs: list, root: str) -> str:
    """Each (lr, hr) pair as two 16-bit TIFFs (the ETL's output format)
    under root/pair_NNNNN/, and the manifest listing them."""
    from PIL import Image

    entries = []
    for i, (lr, hr) in enumerate(pairs):
        d = os.path.join(root, f"pair_{i:05d}")
        os.makedirs(d, exist_ok=True)
        paths = {}
        for key, arr, fname in (("hubble_path", hr, "hubble.tiff"),
                                ("ground_path", lr, "observatory.tiff")):
            Image.fromarray(to16(arr[..., 0])).save(os.path.join(d, fname))
            paths[key] = os.path.join(d, fname)
        entries.append({"patch_id": f"pair_{i:05d}", **paths})
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(entries, f)
    return path


class Driver(base.Driver):
    sync_each = False
    training = True

    def setup(self) -> None:
        from superresolution_tpu_torch.runtime import setup_kernel_cache
        from superresolution_tpu_torch.train.trainer import Trainer
        from superresolution_tpu_torch.utils.config import (
            Config, DataConfig, LossConfig, MeshConfig, TrainConfig)

        ctx, dev = self.ctx, self.device
        setup_kernel_cache(dev)
        self.cfg = ctx.config
        t = self.cfg["train"]
        self.tmp = tempfile.TemporaryDirectory(prefix="portbench_")
        pairs = generate.star_pairs(ctx.traffic, self.subseed("inputs"))
        manifest = write_pairs(pairs, self.tmp.name)
        self.pool_lr, self.pool_hr = pool16(pairs)
        self.train_seed = self.subseed("train") % 2 ** 31
        config = Config(
            name="hybrid_astro",
            model=base.port_hybrid_config(self.cfg, remat=t["remat"]),
            data=DataConfig(train_manifest=manifest, val_manifest=manifest,
                            hr_patch=t["hr_patch"], degradation="none",
                            augment=True, batch_size=t["batch_size"],
                            num_workers=t["num_workers"]),
            loss=LossConfig(terms={"star_l1": 1.0},
                            star_threshold=t["star_threshold"],
                            star_weight=t["star_weight"]),
            train=TrainConfig(epochs=t["epochs"], lr=t["lr"],
                              lr_min=t["lr_min"],
                              weight_decay=t["weight_decay"],
                              betas=tuple(t["betas"]),
                              grad_clip_norm=t["grad_clip_norm"],
                              accum_steps=t["accum_steps"],
                              precision=t["precision"],
                              seed=self.train_seed, resume=False),
            mesh=MeshConfig(data=1))
        self.trainer = tr = Trainer(config, workdir=os.path.join(
            self.tmp.name, "work"), device=dev)
        self.total_steps = t["epochs"] * tr.steps_per_epoch
        self.w0 = base.hybrid_weights(self, self.cfg["model"], pairs[0][0],
                                      torch.float32)
        if set(self.w0) != set(tr.state.params):
            raise ValueError("the benchmark's parameter list and the "
                             "Trainer's differ: "
                             f"{sorted(set(self.w0) ^ set(tr.state.params))[:8]}")
        with torch.no_grad():
            for k, v in self.w0.items():
                tr.state.params[k].copy_(v)
        self.batch_size = tr.batch_size
        self.it = self._batches()
        self.wait_s, self.wait_n = 0.0, 0
        # the first steps: the warm-up, and what the check compares
        self.batches, self.losses, self.decode_err = [], [], 0.0
        for s in range(CHECK_STEPS):
            batch = next(self.it)
            gen = self._gen(s)
            self.batches.append((self._identify(batch), gen.get_state()))
            logs = self._step(batch, gen)
            self.losses.append(logs["total"].detach().clone())
            if s == 0:
                b1 = tr.tx.b1
                self.g1 = {k: (v / (1 - b1)).float().cpu()
                           for k, v in tr.state.opt_state["mu"].items()}
        self.delta = {k: (tr.state.params[k] - self.w0[k]).float().cpu()
                      for k in self.w0}
        self.losses = [float(v) for v in self.losses]

    def _identify(self, batch) -> list[int]:
        """The pool index of each pair of a batch, by its LR image (the
        nearest of the pool's); the largest distance of either image of a
        pair from the pool's is kept for standard error."""
        lr = batch["lr"].float().cpu()
        d = (lr[:, None] - self.pool_lr[None]).abs().flatten(2).amax(-1)
        idx = d.argmin(1)
        hr = (batch["hr"].float().cpu() - self.pool_hr[idx]).abs().amax()
        self.decode_err = max(self.decode_err, float(d.min(1).values.max()),
                              float(hr))
        return idx.tolist()

    def _gen(self, step: int) -> torch.Generator:
        from superresolution_tpu_torch.train.trainer import _step_generator

        return _step_generator(self.train_seed, step)

    def _step(self, batch, gen) -> dict:
        tr = self.trainer
        tr.state, logs = tr._train_step(tr.state, batch, gen)
        return logs

    def _batches(self):
        """Fit's feed: the loader's epoch through prefetch_to_device,
        epoch after epoch."""
        from superresolution_tpu_torch.data.loader import prefetch_to_device

        tr = self.trainer
        epoch = 0
        while True:
            tr.train_loader.set_epoch(epoch)
            n = 0
            for batch in prefetch_to_device(tr.train_loader,
                                            size=tr.cfg.data.prefetch,
                                            device=self.device):
                yield batch
                n += 1
                if n >= tr.steps_per_epoch:
                    break
            epoch += 1

    def run_unit(self, i: int):
        with self.ctx.span("fetch"):
            t0 = time.perf_counter()
            batch = next(self.it)
            self.wait_s += time.perf_counter() - t0
            self.wait_n += 1
        with self.ctx.span("step"):
            logs = self._step(batch, self._gen(self.trainer.state.step))
        return float(self.batch_size), None, torch.isfinite(logs["total"])

    def model_flops(self) -> float:
        from portbench.counts import hybrid_astro

        lr_side = self.cfg["train"]["hr_patch"] // (
            self.cfg["model"]["stage1"]["scale"]
            * self.cfg["model"]["stage2"]["upscale"])
        return 3 * 2.0 * hybrid_astro.macs_per_lr_pixel(
            self.cfg["model"]) * lr_side ** 2 * self.batch_size

    def model_pixels(self) -> int:
        """The batch's LR pixels."""
        m = self.cfg["model"]
        lr_side = self.cfg["train"]["hr_patch"] // (
            m["stage1"]["scale"] * m["stage2"]["upscale"])
        return self.batch_size * lr_side ** 2

    def after_trace(self) -> None:
        if self.wait_n:
            self.ctx.extra["data_wait_ms"] = 1e3 * self.wait_s / self.wait_n

    def finish(self) -> None:
        self.it = None
        self.trainer = None
        super().finish()
        self.tmp.cleanup()

    def reference_steps(self, pr=F32, half_batch: bool = False,
                        dtype: torch.dtype = torch.float32):
        """(losses, the first gradient, the weights' change) of the
        reference's steps over the same pairs and generator states, the
        pairs taken from the benchmark's own pool."""
        ref = RT.Steps(self.cfg, self.w0, self.total_steps, pr, half_batch,
                       dtype)
        losses, g1 = [], None
        for idx, state in self.batches:
            loss, _, g = ref.step(self.pool_lr[idx].to(self.device),
                                  self.pool_hr[idx].to(self.device), state)
            losses.append(loss)
            if g1 is None:
                g1 = g
        delta = {k: ref.p[k] - self.w0[k] for k in self.w0}
        return losses, g1, delta

    def gaps(self, prog, ref) -> dict:
        """loss1_gap: the first step's loss; grad_gap: the first gradient's
        leaf norms, delta_gap: the weights' change over the steps, each
        the median leaf's relative gap; grad_angle and delta_angle: the
        angle between the two sides' first gradients and changes, over
        all leaves; grad_sign: the share of the first gradient's elements
        whose sign differs. Leaves whose reference gradient is nought to
        rounding are left out of the change. The cell's limits say which
        are compared; the others (and grad_worst, delta_worst: the worst
        leaf's gap, leaf_gap's measure) are read by calibrate.py. The
        worst leaves, every step's loss and the decoding's largest error
        go to standard error, where a reading is looked into."""
        (pl, pg, pd), (rl, rg, rd) = prog, ref
        gn, rgn = RT.leaf_norms(pg), RT.leaf_norms(rg)
        dn, rdn = RT.leaf_norms(pd), RT.leaf_norms(rd)
        skip = RT.flat_leaves(rgn)
        print(json.dumps({"losses": [pl, rl],
                          "decode_err": self.decode_err,
                          "grad_worst": RT.worst_leaves(gn, rgn),
                          "delta_worst": RT.worst_leaves(dn, rdn, skip),
                          "flat_leaves": sorted(skip)}), file=sys.stderr)
        return {"loss1_gap": abs(pl[0] - rl[0]) / abs(rl[0]),
                "grad_gap": RT.median_gap(gn, rgn),
                "delta_gap": RT.median_gap(dn, rdn, skip),
                "grad_angle": RT.angle(pg, rg),
                "delta_angle": RT.angle(pd, rd, skip),
                "grad_sign": RT.sign_share(pg, rg, skip),
                "grad_worst": RT.leaf_gap(gn, rgn),
                "delta_worst": RT.leaf_gap(dn, rdn, skip)}

    def check(self, records: list) -> dict:
        return self.gaps((self.losses, self.g1, self.delta),
                         self.reference_steps())
