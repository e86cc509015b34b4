"""Config system: typed dataclasses and the named presets.

The port's own copy of superresolution_tpu/utils/config.py (the port
imports nothing of the JAX package): the same fields, defaults and
presets, so get_preset(name) reads the same in both packages. Comments
that name XLA, lax.scan or the TPU describe the reference's use of a
field; the port reads each field as its trainer says.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Which SR generator to build and its hyperparameters.

    `name` selects from the model registry (superresolution_tpu.models).
    `kwargs` are forwarded to the model constructor.
    """

    name: str = "edsr"
    scale: int = 4
    in_channels: int = 1
    out_channels: int = 1
    kwargs: dict[str, Any] = field(default_factory=dict)
    # Optional second-stage refiner (the reference's RRDB->HAT hybrid pattern,
    # reference: src/architecture.py:30-82). None disables stage 2.
    refiner: str | None = None
    refiner_kwargs: dict[str, Any] = field(default_factory=dict)
    # Anti-checkerboard smoothing slots: None | 'light' | 'balanced' | 'strong'
    # (reference: src/architecture.py:9-27).
    smoothing: str | None = None


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline: where patches come from and how LR is made."""

    # Manifest-driven paired data (reference contract: scripts/Modello_2.py:38-52)
    train_manifest: str | None = None
    val_manifest: str | None = None
    test_manifest: str | None = None
    base_path: str = ""
    # Patch geometry. HR patch is (hr_patch, hr_patch); LR is hr_patch/scale.
    hr_patch: int = 128
    # Synthetic degradation (new capability; the reference uses real telescope
    # LR only — SURVEY.md section 2 "Degradation / LR-synthesis model").
    degradation: str = "bicubic"  # 'bicubic' | 'blur_bicubic' | 'bsr_light' | 'none'
    blur_sigma: tuple[float, float] = (0.2, 2.0)
    noise_sigma: tuple[float, float] = (0.0, 10.0)  # in 8-bit units
    jpeg_quality: tuple[int, int] = (60, 95)
    augment: bool = True
    batch_size: int = 16
    prefetch: int = 2
    num_workers: int = 4
    # If set, generate a synthetic dataset of this many procedural images
    # (starfields / gradients) so every preset is runnable with zero downloads.
    synthetic_len: int | None = None


@dataclass(frozen=True)
class LossConfig:
    """Weighted sum of named loss terms.

    Mirrors the reference's two generations of losses:
      - star-weighted L1 (threshold 0.02, weight 500; reference src/losses.py:13-17)
      - Charbonnier + perceptual + astro (reference Backup/src/losses.py:17-71)
      - plus relativistic GAN for the ESRGAN preset.
    """

    terms: dict[str, float] = field(default_factory=lambda: {"l1": 1.0})
    star_threshold: float = 0.02
    star_weight: float = 500.0
    charbonnier_eps: float = 1e-6
    astro_weight_scale: float = 5.0
    # torchvision vgg19.features[:18] == relu3_4 (reference Backup/src/losses.py:28)
    # (term weights — gan, perceptual, ... — live in `terms`, nowhere else)
    perceptual_layers: tuple[str, ...] = ("relu3_4",)


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 150
    # cap on train batches per epoch (None => one pass over the dataset);
    # also the total_steps denominator for the cosine schedule
    steps_per_epoch: int | None = None
    lr: float = 4e-4
    lr_min: float = 1e-7  # cosine floor (reference: scripts/Modello_supporto.py:108)
    weight_decay: float = 1e-2
    betas: tuple[float, float] = (0.9, 0.999)
    grad_clip_norm: float = 1.0  # reference: scripts/Modello_supporto.py:138
    accum_steps: int = 1  # micro-batch accumulation via lax.scan
    eval_every: int = 5  # epochs (reference LOG_INTERVAL)
    preview_every: int = 20  # epochs (reference IMAGE_INTERVAL)
    keep_checkpoints: int = 3
    resume: bool = True
    seed: int = 42
    # Precision policy name: 'bf16' (params fp32 / compute bf16 — the AMP
    # analog of reference scripts/Modello_supporto.py:113) or 'fp32'.
    precision: str = "bf16"
    ema_decay: float | None = None
    # GAN training (ESRGAN preset)
    disc_lr: float | None = None
    gan_start_step: int = 0
    # debug mode: NaN checks (jax_debug_nans in the reference;
    # torch.autograd anomaly detection in the port)
    debug_nans: bool = False
    # fused dense-block kernels in the TRAINING step (forward +
    # backward, train/fused_apply.py). None = auto: on when running on
    # the accelerator (the TPU; CUDA in the port) and the model is an
    # RRDB-family arch the rewrite supports; True forces it (interpret
    # mode / the plain versions on the CPU), False disables.
    fused_trunk: bool | None = None


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. Axes with size 1 are collapsed.

    data: batch sharding (DP), the primary axis (the TPU-native analog of the
    reference's nn.DataParallel, scripts/Modello_supporto.py:103-105).
    spatial: optional image-space sharding for single-image multi-chip
    inference with halo exchange (context-parallel analog).
    """

    data: int = -1  # -1 => all devices
    spatial: int = 1
    # pipeline stages for the RRDB trunk body (parallel/pipeline.py):
    # stage weights shard over a 'pipe' mesh axis, microbatches ride a
    # ppermute ring. Requires an RRDBNet arch with scan_blocks and
    # spatial == 1; incompatible with GAN training.
    pipe: int = 1
    # microbatches per step for pipe > 1 (0 => pipe; bubble fraction is
    # (pipe-1)/(microbatches+pipe-1), so more microbatches = fuller pipe)
    pipe_microbatches: int = 0


@dataclass(frozen=True)
class Config:
    name: str = "custom"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _preset_srcnn_x2() -> Config:
    """BASELINE config 1: SRCNN ×2 (3-layer conv) on Set5, CPU-runnable."""
    return Config(
        name="srcnn_x2",
        model=ModelConfig(name="srcnn", scale=2, in_channels=1, out_channels=1),
        data=DataConfig(hr_patch=96, batch_size=16, degradation="bicubic",
                        synthetic_len=64),
        loss=LossConfig(terms={"l1": 1.0}),
        train=TrainConfig(epochs=10, lr=1e-3, precision="fp32"),
    )


def _preset_espcn_x4() -> Config:
    """BASELINE config 2: ESPCN ×4 with sub-pixel PixelShuffle upsample."""
    return Config(
        name="espcn_x4",
        model=ModelConfig(name="espcn", scale=4, in_channels=1, out_channels=1),
        data=DataConfig(hr_patch=128, batch_size=32, synthetic_len=256),
        loss=LossConfig(terms={"l1": 1.0}),
        train=TrainConfig(epochs=50, lr=1e-3),
    )


def _preset_fsrcnn_x4() -> Config:
    """BASELINE config 2 (alt): FSRCNN ×4."""
    return Config(
        name="fsrcnn_x4",
        model=ModelConfig(name="fsrcnn", scale=4, in_channels=1, out_channels=1),
        data=DataConfig(hr_patch=128, batch_size=32, synthetic_len=256),
        loss=LossConfig(terms={"l1": 1.0}),
        train=TrainConfig(epochs=50, lr=1e-3),
    )


def _preset_edsr_baseline() -> Config:
    """BASELINE config 3: EDSR-baseline (16 resblocks, 64 feats) DIV2K, L1."""
    return Config(
        name="edsr_baseline_x4",
        model=ModelConfig(
            name="edsr", scale=4, in_channels=3, out_channels=3,
            kwargs={"num_blocks": 16, "features": 64, "res_scale": 1.0},
        ),
        data=DataConfig(hr_patch=192, batch_size=16, synthetic_len=800),
        loss=LossConfig(terms={"l1": 1.0}),
        train=TrainConfig(epochs=300, lr=1e-4, grad_clip_norm=0.0),
    )


def _preset_esrgan_tiled() -> Config:
    """BASELINE config 4: ESRGAN RRDB generator ×4 tiled inference on 2K images."""
    return Config(
        name="esrgan_x4_tiled",
        model=ModelConfig(
            name="rrdbnet", scale=4, in_channels=3, out_channels=3,
            kwargs={"features": 64, "num_blocks": 23, "growth": 32},
        ),
        data=DataConfig(hr_patch=192, batch_size=8, synthetic_len=100),
        loss=LossConfig(terms={"l1": 1.0}),
        train=TrainConfig(epochs=100, lr=2e-4),
    )


def _preset_esrgan_gan() -> Config:
    """BASELINE config 5: full ESRGAN GAN training (RRDB + disc + perceptual)."""
    return Config(
        name="esrgan_gan",
        model=ModelConfig(
            name="rrdbnet", scale=4, in_channels=3, out_channels=3,
            kwargs={"features": 64, "num_blocks": 23, "growth": 32},
        ),
        data=DataConfig(hr_patch=128, batch_size=16, synthetic_len=800),
        loss=LossConfig(
            terms={"l1": 0.01, "perceptual": 1.0, "gan": 0.005},
        ),
        # pixel-only warmup then adversarial (the ESRGAN two-phase
        # schedule; the reference pretrains a PSNR model separately)
        train=TrainConfig(epochs=200, lr=1e-4, disc_lr=1e-4,
                          gan_start_step=1000),
    )


def _preset_hybrid_astro() -> Config:
    """The reference's own workload: two-stage RRDB->attention hybrid on
    128->512 astronomical patch pairs with star-weighted L1.

    Parity targets: reference src/architecture.py:30-82 (model),
    src/losses.py:5-20 (loss), scripts/Modello_supporto.py:29-32 (train).
    """
    return Config(
        name="hybrid_astro",
        model=ModelConfig(
            name="rrdbnet", scale=2, in_channels=1, out_channels=1,
            # remat: O(1) activation memory per trunk — training this
            # model at 512^2 outputs does not fit 16 GB HBM without it
            kwargs={"features": 64, "num_blocks": 23, "growth": 32,
                    "remat": True},
            refiner="hat_lite",
            refiner_kwargs={
                "scale": 2, "embed_dim": 96, "depths": (6, 6, 6, 6),
                "num_heads": (6, 6, 6, 6), "window_size": 8,
                "remat": True,
            },
            smoothing="balanced",
        ),
        data=DataConfig(hr_patch=512, batch_size=4, degradation="none",
                        synthetic_len=32),
        loss=LossConfig(terms={"star_l1": 1.0}),
        train=TrainConfig(epochs=1000, lr=5e-4, accum_steps=1, eval_every=5),
    )


def _preset_hybrid_astro_prod() -> Config:
    """The reference Backup 'H200 production' variant: Charbonnier + perceptual
    + astro loss, batch 3 x accum 20 (reference Backup/scripts/Modello_supporto.py:26-29,
    Backup/src/losses.py:17-71)."""
    base = _preset_hybrid_astro()
    return base.replace(
        name="hybrid_astro_prod",
        loss=LossConfig(terms={"charbonnier": 1.0, "perceptual": 0.05, "astro": 0.05}),
        train=TrainConfig(epochs=150, lr=4e-4, accum_steps=20, eval_every=1),
        # reference: per-step batch 3 x ACCUM 20 over LOADER batches =
        # effective 60; our accumulation splits ONE batch into micros,
        # so the equivalent spec is batch 60 / accum 20 (micro-batch 3)
        data=dataclasses.replace(base.data, batch_size=60),
    )


def _preset_hybrid_astro_h200() -> Config:
    """The reference Backup 'H200' architecture variant: HAT embed 120,
    6 groups of depth 6, window 16 (reference
    Backup/src/architecture.py:48-68) with the Backup production training
    config."""
    base = _preset_hybrid_astro_prod()
    return base.replace(
        name="hybrid_astro_h200",
        model=dataclasses.replace(
            base.model,
            refiner_kwargs={
                "scale": 2, "embed_dim": 120, "depths": (6,) * 6,
                "num_heads": (6,) * 6, "window_size": 16,
                # the base preset's remat is what fits 512^2 training in
                # HBM; this larger variant needs it even more
                "remat": True,
            }),
    )


presets: dict[str, Any] = {}


def _register_presets() -> None:
    for fn in (
        _preset_srcnn_x2, _preset_espcn_x4, _preset_fsrcnn_x4,
        _preset_edsr_baseline, _preset_esrgan_tiled, _preset_esrgan_gan,
        _preset_hybrid_astro, _preset_hybrid_astro_prod,
        _preset_hybrid_astro_h200,
    ):
        cfg = fn()
        presets[cfg.name] = cfg


_register_presets()


def get_preset(name: str, **overrides) -> Config:
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; have {sorted(presets)}")
    cfg = presets[name]
    return cfg.replace(**overrides) if overrides else cfg
