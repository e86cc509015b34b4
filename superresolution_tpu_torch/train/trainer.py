"""Trainer: the end-to-end training run on one device.

Counterpart of superresolution_tpu/train/trainer.py for one device:
config -> data (a JSON manifest of real pairs, else the synthetic set),
model, loss, optimizer, steps; the epoch loop with validation every
`eval_every` epochs, best-PSNR/last checkpoints saved asynchronously
with resume, preview strips every `preview_every` epochs, and JSONL
(and TensorBoard, if present) logs. The fused train apply
(train/fused_apply.py: B1 forward and kernel 13 backward under every
dense block) is on under the reference's gate (trainer.py:157-188) with
"on the TPU" read as "on CUDA": fused_trunk=None turns it on for LR
patches of FUSED_TRUNK_AUTO_MIN_PATCH and more, and below that, where
the batch is row-packed (seg spacer rows), under SRTPU_PACKED_TRAIN;
True forces it.

Not ported yet, and raising NotImplementedError: multi-device meshes
(mesh.data or mesh.pipe > 1) and GAN terms.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from superresolution_tpu_torch.data.dataset import (
    PairedDataset,
    SyntheticHRDataset,
)
from superresolution_tpu_torch.data.io import save_png
from superresolution_tpu_torch.data.loader import Loader, prefetch_to_device
from superresolution_tpu_torch.losses.combined import CombinedLoss
from superresolution_tpu_torch.metrics.psnr_ssim import Metrics
from superresolution_tpu_torch.models.factory import (
    build_from_config,
    total_scale,
)
from superresolution_tpu_torch.ops.resize import resize_nearest
from superresolution_tpu_torch.runtime import resolve_device
from superresolution_tpu_torch.train.checkpoint import CheckpointManager
from superresolution_tpu_torch.train.fused_apply import (
    make_fused_train_apply,
    supports_fused_train,
)
from superresolution_tpu_torch.train.logging import MetricsLogger
from superresolution_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from superresolution_tpu_torch.train.steps import (
    make_device_input,
    make_eval_step,
    make_train_step,
)
from superresolution_tpu_torch.utils.config import Config
from superresolution_tpu_torch.utils.precision import get_policy

# Smallest LR patch at which fused_trunk=None turns the fused train path
# on: the reference's measured crossover on the TPU (trainer.py:52),
# kept as the gate; the port's own crossover on the H100 is not measured
FUSED_TRUNK_AUTO_MIN_PATCH = 96


def _step_generator(seed: int, step: int) -> torch.Generator:
    """The augmentation draws of one step: a function of (seed, step)
    alone, so a resumed run draws as an unbroken one would."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


class Trainer:
    def __init__(self, config: Config, workdir: str | None = None,
                 device: str | torch.device | None = None):
        self.cfg = config
        self.device = resolve_device(device)
        self.workdir = workdir or os.path.join("outputs", config.name)
        os.makedirs(self.workdir, exist_ok=True)
        if config.mesh.data > 1 or config.mesh.pipe > 1 \
                or config.mesh.spatial > 1:
            raise NotImplementedError(
                "multi-device training (mesh.data / mesh.pipe / "
                "mesh.spatial > 1) needs the parallel/ port, which is not "
                "ported yet (ROADMAP item A6)")
        self.is_gan = "gan" in config.loss.terms
        if self.is_gan:
            raise NotImplementedError(
                "GAN training (train/gan.py, models/discriminator.py) comes "
                "with the GAN/perceptual training slice")
        self.policy = get_policy(config.train.precision)
        self.scale = total_scale(config.model)

        # --- data ---
        dc = config.data
        self.train_ds, self.val_ds = self._build_datasets()
        bs = max(1, dc.batch_size)
        if len(self.train_ds) < bs:  # shrink to the dataset
            bs = len(self.train_ds)
        self.batch_size = bs
        self.train_loader = Loader(self.train_ds, bs, shuffle=True,
                                   seed=config.train.seed,
                                   num_workers=dc.num_workers)
        # every val image enters PSNR/SSIM; padded rows are masked out
        self.val_loader = Loader(self.val_ds, min(bs, len(self.val_ds)),
                                 shuffle=False, num_workers=dc.num_workers,
                                 drop_last=False, pad_to_batch=True)

        # --- model / loss / optimizer ---
        output_size = dc.hr_patch if config.model.refiner else None
        self.model = build_from_config(
            config.model, output_size=output_size, device=self.device,
            generator=torch.Generator().manual_seed(config.train.seed))
        self.loss_fn = CombinedLoss(config.loss)
        steps_per_epoch = max(1, len(self.train_loader))
        if config.train.steps_per_epoch is not None:
            steps_per_epoch = min(steps_per_epoch,
                                  max(1, config.train.steps_per_epoch))
        self.steps_per_epoch = steps_per_epoch
        total_steps = config.train.epochs * steps_per_epoch
        self.tx, self.schedule = make_optimizer(config.train, total_steps)
        # the masters share the module's storage, so the module always
        # holds the trained weights
        params = {k: p.detach() for k, p in self.model.named_parameters()}
        self.state = create_train_state(
            params, self.tx, ema=config.train.ema_decay is not None)
        self.input_fn = make_device_input(dc, self.scale)
        self.eval_input_fn = make_device_input(dc, self.scale, augment=False)

        lr_patch = dc.hr_patch // self.scale
        self.fused_apply = None
        if config.train.fused_trunk is not False:
            accum = max(1, min(config.train.accum_steps, self.batch_size))
            micro = self.batch_size // accum  # images per apply call
            on_cuda = self.device.type == "cuda"
            big_patch = lr_patch >= FUSED_TRUNK_AUTO_MIN_PATCH
            # below the patch gate the batch rides the trunk row-packed
            # (one tall map, seg spacer rows); auto takes that form only
            # under SRTPU_PACKED_TRAIN, as the reference does
            row_pack = not big_patch and micro > 1
            auto = (config.train.fused_trunk is None and on_cuda
                    and big_patch)
            if config.train.fused_trunk is None and row_pack and on_cuda:
                auto = bool(os.environ.get("SRTPU_PACKED_TRAIN"))
            if ((config.train.fused_trunk or auto)
                    and supports_fused_train(self.model)):
                self.fused_apply = make_fused_train_apply(self.model,
                                                          row_pack=row_pack)
        self._train_step = make_train_step(
            self.model, self.loss_fn, self.tx, self.policy, self.input_fn,
            accum_steps=config.train.accum_steps,
            ema_decay=config.train.ema_decay, apply_fn=self.fused_apply)
        self._eval_step = make_eval_step(
            self.model, self.policy, self.eval_input_fn,
            use_ema=config.train.ema_decay is not None)

        # --- checkpoints / logs ---
        model_cfg = dict(dataclasses.asdict(config.model),
                         output_size=output_size)
        self.ckpt = CheckpointManager(
            os.path.join(self.workdir, "checkpoints"),
            keep=config.train.keep_checkpoints, model_config=model_cfg)
        self.logger = MetricsLogger(os.path.join(self.workdir, "logs"))
        self.start_epoch = 0
        if config.train.resume:
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                for name, v in restored.params.items():
                    self.state.params[name].copy_(v)
                restored.params = self.state.params
                self.state = restored
                self.start_epoch = self.state.step // steps_per_epoch

    @property
    def test_ds(self):
        """The test split for run_test: the test manifest when configured
        (the reference evaluates test.json), else the validation set."""
        dc = self.cfg.data
        if dc.test_manifest:
            lr_size = (dc.hr_patch // self.scale
                       if dc.degradation == "none" else None)
            return PairedDataset(dc.test_manifest, dc.base_path,
                                 lr_size=lr_size)
        return self.val_ds

    def _build_datasets(self):
        dc = self.cfg.data
        if dc.train_manifest:
            lr_size = (dc.hr_patch // self.scale
                       if dc.degradation == "none" else None)
            if dc.degradation != "none":
                logging.getLogger(__name__).info(
                    "manifest provides real LR pairs; the configured"
                    " degradation %r is unused (real LR always wins —"
                    " train/steps.py::make_device_input)", dc.degradation)
            train = PairedDataset(dc.train_manifest, dc.base_path,
                                  lr_size=lr_size)
            val = PairedDataset(dc.val_manifest or dc.train_manifest,
                                dc.base_path, lr_size=lr_size)
            return train, val
        c = self.cfg.model.in_channels
        n = dc.synthetic_len or 64
        # degradation 'none' means real LR: with no manifest the
        # synthetic set emits a co-registered synthetic-telescope LR
        lr_scale = self.scale if dc.degradation == "none" else None
        train = SyntheticHRDataset(n, dc.hr_patch, c, seed=1,
                                   lr_scale=lr_scale)
        val = SyntheticHRDataset(max(4, n // 8), dc.hr_patch, c, seed=2,
                                 lr_scale=lr_scale)
        return train, val

    def fit(self, epochs: int | None = None) -> dict:
        cfg = self.cfg.train
        epochs = epochs if epochs is not None else cfg.epochs
        best = {"psnr": float("-inf"), "ssim": 0.0}
        t_start = time.time()
        step = self.state.step
        for epoch in range(self.start_epoch, epochs):
            self.train_loader.set_epoch(epoch)
            epoch_logs, nb = None, 0
            t_epoch = time.time()
            for batch in prefetch_to_device(self.train_loader,
                                            size=self.cfg.data.prefetch,
                                            device=self.device):
                with torch.autograd.set_detect_anomaly(cfg.debug_nans):
                    self.state, logs = self._train_step(
                        self.state, batch, _step_generator(cfg.seed, step))
                step += 1
                nb += 1
                # on the card: summed without a sync, read once per epoch
                epoch_logs = logs if epoch_logs is None else {
                    k: epoch_logs[k] + v for k, v in logs.items()}
                if nb >= self.steps_per_epoch:
                    break
            if epoch_logs is not None:
                mean_logs = {k: float(v) / nb for k, v in epoch_logs.items()}
                # the float() above waited for the card: an honest wall
                wall = max(time.time() - t_epoch, 1e-9)
                mean_logs["lr"] = self.schedule(step)
                mean_logs["samples_per_sec"] = nb * self.batch_size / wall
                self.logger.scalars(step, mean_logs, prefix="train/")
            if (epoch + 1) % cfg.eval_every == 0 or epoch == epochs - 1:
                val = self.evaluate()
                self.logger.scalars(step, val, prefix="val/")
                # async: the disk write overlaps the next epoch
                if self.ckpt.save(self.state, step, psnr=val["psnr"],
                                  block=False):
                    best = dict(val)
            # previews follow their own cadence (nested in the eval
            # branch they would fall due at the LCM of the two)
            if (epoch + 1) % cfg.preview_every == 0:
                self._save_preview(epoch)
        self.ckpt.wait()  # commit the last async save before returning
        return {"best": best, "epochs": epochs,
                "wall_s": time.time() - t_start,
                "final_step": self.state.step}

    def evaluate(self) -> dict:
        m = Metrics()
        sums = None
        for i, batch in enumerate(prefetch_to_device(
                self.val_loader, size=self.cfg.data.prefetch,
                device=self.device)):
            out = self._eval_step(self.state, batch,
                                  _step_generator(self.cfg.train.seed,
                                                  2 ** 30 + i))
            cur = (out["psnr_sum"], out["ssim_sum"], out["n"])
            # summed on the card; one read at the end
            sums = cur if sums is None else tuple(
                a + b for a, b in zip(sums, cur))
        if sums is not None:
            m.update_sums(*(float(v) for v in sums))
        return m.compute()

    def _save_preview(self, epoch: int) -> None:
        """The [LR-nearest-up | SR | HR] strip of the first validation
        sample to previews/epoch_NNNNN.png (the reference's
        scripts/Modello_supporto.py:187-190); one sample read directly,
        through the eval step's input stage (a synthetic bicubic sample
        carries no LR, so the stage degrades it)."""
        batch = {k: torch.from_numpy(np.asarray(v)[None]).to(self.device)
                 for k, v in self.val_ds[0].items()}
        out = self._eval_step(self.state, batch,
                              _step_generator(self.cfg.train.seed,
                                              2 ** 31 - 1))
        hr0 = out["hr"][0]
        lr_up = resize_nearest(out["lr"][0].float(), tuple(hr0.shape[:2]))
        strip = torch.cat([lr_up, out["pred"][0], hr0], 1).cpu().numpy()
        path = os.path.join(self.workdir, "previews",
                            f"epoch_{epoch + 1:05d}.png")
        save_png(strip, path)
        self.logger.image(self.state.step, "preview", strip)

    def finalize(self, probe=None) -> str:
        """Promote the best weights (else the last) to final_weights/,
        checked by `probe` if given (train/checkpoint.params_probe)."""
        return self.ckpt.finalize(os.path.join(self.workdir,
                                               "final_weights"), probe=probe)

    def close(self) -> None:
        """Wait out any in-flight async checkpoint save and close the
        logs."""
        self.ckpt.wait()
        self.logger.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
