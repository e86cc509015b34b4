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

A `gan` term makes it a GAN run (trainer.py:190-209 there): a
VGGStyleDiscriminator on the HR patch, its own AdamW (disc_lr or lr),
the step of train/gan.py with the fused apply as the generator's
forward under the same gate, and D's state saved beside G's under
checkpoints_disc/ and restored on resume.

A multi-process run (trainer.py:64-147, 161-185 there) takes its mesh
from config.mesh over the initialized process group (parallel/mesh.py),
or the one passed in. mesh.data > 1: the global batch is rounded to a
multiple of the data ranks (the too-small error kept), every rank loads
it whole and takes its share of each micro-batch in the step, and the
gradients (G's and D's) and logs are summed over the data ranks before
each update (parallel/data.py); the validation batch is padded to a
multiple of the data ranks and its PSNR/SSIM sums are over all of them.
mesh.pipe > 1: the RRDB trunk body runs pipelined over the pipe ranks
(parallel/pipeline.make_pipeline_forward), with the reference's
refusals (GAN training; an arch that is not an RRDBNet with
scan_blocks; a per-step batch that pipe_microbatches does not divide).
Checkpoints, previews and logs are written by rank 0 only.
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
from superresolution_tpu_torch.models.discriminator import (
    VGGStyleDiscriminator,
)
from superresolution_tpu_torch.models.factory import (
    build_from_config,
    total_scale,
)
from superresolution_tpu_torch.ops.resize import resize_nearest
from superresolution_tpu_torch.parallel.mesh import create_mesh
from superresolution_tpu_torch.runtime import resolve_device
from superresolution_tpu_torch.train.checkpoint import CheckpointManager
from superresolution_tpu_torch.train.fused_apply import (
    make_fused_train_apply,
    supports_fused_train,
)
from superresolution_tpu_torch.train.gan import make_gan_steps
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


def _restore_into(mgr: CheckpointManager, state):
    """The manager's last saved state, its params copied into `state`'s
    tensors (which a module's parameters share), or None."""
    restored = mgr.restore(state)
    if restored is None:
        return None
    for name, v in restored.params.items():
        state.params[name].copy_(v)
    restored.params = state.params
    return restored


class _NullLogger:
    """The logger of a rank other than 0: it writes nothing."""

    def scalars(self, *args, **kwargs) -> None:
        pass

    def image(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(self, config: Config, workdir: str | None = None,
                 device: str | torch.device | None = None, mesh=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.workdir = workdir or os.path.join("outputs", config.name)
        self.mesh = mesh if mesh is not None else create_mesh(config.mesh)
        if self.mesh.coords is None:
            raise ValueError(
                f"rank {self.mesh.rank} lies outside the "
                f"{self.mesh.sizes[0]}x{self.mesh.sizes[1]} mesh; start "
                f"{self.mesh.size} processes")
        self.is_main = self.mesh.rank == 0
        os.makedirs(self.workdir, exist_ok=True)
        self.is_gan = "gan" in config.loss.terms
        self.policy = get_policy(config.train.precision)
        self.scale = total_scale(config.model)

        # --- data ---
        dc = config.data
        self.train_ds, self.val_ds = self._build_datasets()
        bs = dc.batch_size
        ndata = self.mesh.shape["data"]
        bs = max(ndata, (bs // ndata) * ndata)
        if len(self.train_ds) < bs:  # smart shrink (trainer.py:80-85 there)
            bs = max(ndata, (len(self.train_ds) // ndata) * ndata)
        self.batch_size = bs
        if bs < ndata or len(self.train_ds) < ndata:
            raise ValueError(
                f"dataset ({len(self.train_ds)}) / batch ({dc.batch_size}) too"
                f" small for the {ndata}-way data mesh; shrink mesh.data")
        self.train_loader = Loader(self.train_ds, bs, shuffle=True,
                                   seed=config.train.seed,
                                   num_workers=dc.num_workers)
        # every val image enters PSNR/SSIM; padded rows are masked out
        val_bs = max(ndata, (min(bs, len(self.val_ds)) // ndata) * ndata)
        self.val_loader = Loader(self.val_ds, val_bs,
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
        # the pipelined trunk (mesh.pipe > 1): same math, the body's
        # blocks over the pipe ranks
        pp_apply = None
        npipe = self.mesh.shape.get("pipe", 1)
        if npipe > 1:
            from superresolution_tpu_torch.models.rrdbnet import RRDBNet
            from superresolution_tpu_torch.parallel.pipeline import (
                make_pipeline_forward,
            )

            if self.is_gan:
                raise ValueError(
                    "mesh.pipe > 1 does not support GAN training")
            if not isinstance(self.model, RRDBNet) or \
                    not self.model.scan_blocks:
                raise ValueError(
                    "mesh.pipe > 1 requires an RRDBNet arch with"
                    " scan_blocks (the pipelined trunk body)")
            n_micro = config.mesh.pipe_microbatches or npipe
            accum = max(1, min(config.train.accum_steps, self.batch_size))
            per_call = self.batch_size // accum
            if per_call % n_micro:
                raise ValueError(
                    f"per-step batch {per_call} not divisible by"
                    f" pipe_microbatches {n_micro}")
            pp_apply = make_pipeline_forward(self.mesh, self.model, n_micro)
        self.fused_apply = None
        if npipe == 1 and config.train.fused_trunk is not False:
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
        if self.is_gan:
            self.disc = VGGStyleDiscriminator(
                in_channels=config.model.out_channels,
                input_size=dc.hr_patch, device=self.device,
                generator=torch.Generator().manual_seed(
                    config.train.seed + 1))
            self.d_tx, _ = make_optimizer(
                config.train, total_steps,
                lr=config.train.disc_lr or config.train.lr)
            self.d_state = create_train_state(
                {k: p.detach() for k, p in self.disc.named_parameters()},
                self.d_tx)
            self._gan_step = make_gan_steps(
                self.model, self.disc, self.loss_fn, self.tx, self.d_tx,
                self.policy, self.input_fn,
                gan_weight=config.loss.terms.get("gan", 0.005),
                ema_decay=config.train.ema_decay,
                gan_start_step=config.train.gan_start_step,
                accum_steps=config.train.accum_steps,
                gen_apply_fn=self.fused_apply, mesh=self.mesh)
        else:
            # under pipe the pipelined forward spreads the batch itself and
            # hands every rank the whole gradient: no data split here
            self._train_step = make_train_step(
                self.model, self.loss_fn, self.tx, self.policy,
                self.input_fn, accum_steps=config.train.accum_steps,
                ema_decay=config.train.ema_decay,
                apply_fn=pp_apply or self.fused_apply,
                mesh=None if pp_apply else self.mesh)
        use_ema = config.train.ema_decay is not None
        self._eval_step = make_eval_step(
            self.model, self.policy, self.eval_input_fn, use_ema=use_ema,
            mesh=self.mesh)
        self._preview_step = make_eval_step(
            self.model, self.policy, self.eval_input_fn, use_ema=use_ema)

        # --- checkpoints / logs (written by rank 0) ---
        model_cfg = dict(dataclasses.asdict(config.model),
                         output_size=output_size)
        self.ckpt = CheckpointManager(
            os.path.join(self.workdir, "checkpoints"),
            keep=config.train.keep_checkpoints,
            model_config=model_cfg if self.is_main else None)
        self.logger = (MetricsLogger(os.path.join(self.workdir, "logs"))
                       if self.is_main else _NullLogger())
        # GAN: D's state (params and moments) resumes too, or a trained G
        # would meet a fresh random D
        self.d_ckpt = (CheckpointManager(
            os.path.join(self.workdir, "checkpoints_disc"),
            keep=config.train.keep_checkpoints) if self.is_gan else None)
        self.start_epoch = 0
        if config.train.resume:
            restored = _restore_into(self.ckpt, self.state)
            if restored is not None:
                self.state = restored
                self.start_epoch = self.state.step // steps_per_epoch
                if self.d_ckpt is not None:
                    d_restored = _restore_into(self.d_ckpt, self.d_state)
                    if d_restored is not None:
                        self.d_state = d_restored
                    else:
                        logging.getLogger(__name__).warning(
                            "resuming GAN generator without a saved"
                            " discriminator state (fresh D)")

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
                gen = _step_generator(cfg.seed, step)
                with torch.autograd.set_detect_anomaly(cfg.debug_nans):
                    if self.is_gan:
                        self.state, self.d_state, logs = self._gan_step(
                            self.state, self.d_state, batch, gen)
                    else:
                        self.state, logs = self._train_step(self.state,
                                                            batch, gen)
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
                if not self.is_main:
                    if val["psnr"] > best["psnr"]:
                        best = dict(val)
                # async: the disk write overlaps the next epoch
                elif self.ckpt.save(self.state, step, psnr=val["psnr"],
                                    block=False):
                    best = dict(val)
                if self.d_ckpt is not None and self.is_main:
                    self.d_ckpt.save(self.d_state, step, block=False)
            # previews follow their own cadence (nested in the eval
            # branch they would fall due at the LCM of the two)
            if (epoch + 1) % cfg.preview_every == 0 and self.is_main:
                self._save_preview(epoch)
        self._wait_saves()  # commit the last async saves
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
        out = self._preview_step(self.state, batch,
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

    def _wait_saves(self) -> None:
        """Wait out any in-flight async save of G's and D's managers."""
        self.ckpt.wait()
        if self.d_ckpt is not None:
            self.d_ckpt.wait()

    def close(self) -> None:
        """Wait out any in-flight async checkpoint save and close the
        logs."""
        self._wait_saves()
        self.logger.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
