"""The port's Trainer (superresolution_tpu_torch/train/trainer.py) on the
CPU at a tiny hybrid_astro-shaped config: fit runs, evaluates to a finite
PSNR, keeps best/last checkpoints, finalizes and resumes; the parts not
ported yet raise, and those ported since run."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from superresolution_tpu_torch.data.dataset import PairedDataset
from superresolution_tpu_torch.data.io import save_tiff16
from superresolution_tpu_torch.data.manifest import prepare_splits
from superresolution_tpu_torch.train.checkpoint import CheckpointManager
from superresolution_tpu_torch.train.trainer import Trainer
from superresolution_tpu_torch.utils.config import get_preset


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These CPU tensors are small: intra-op threads gain nothing, and on
    a host loaded by parallel test workers their spin-waits cost several
    times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SRTPU_NO_TB", "1")


def _cfg(**train):
    cfg = get_preset("hybrid_astro")
    model = dataclasses.replace(
        cfg.model,
        kwargs={"features": 16, "num_blocks": 1, "growth": 8, "remat": True},
        refiner_kwargs={"scale": 2, "embed_dim": 16, "depths": (2, 2),
                        "num_heads": (2, 2), "window_size": 8,
                        "remat": True})
    data = dataclasses.replace(cfg.data, hr_patch=64, batch_size=2,
                               synthetic_len=4, num_workers=1)
    # f32: bf16 convs are slow on the CPU; the train step's tests hold bf16
    tc = dict(epochs=2, steps_per_epoch=1, eval_every=1, keep_checkpoints=1,
              precision="fp32")
    tc.update(train)
    return cfg.replace(model=model, data=data,
                       train=dataclasses.replace(cfg.train, **tc))


def test_fit_checkpoints_finalize_and_resume(tmp_path):
    wd = str(tmp_path)
    with Trainer(_cfg(), wd, device="cpu") as tr:
        assert tr.scale == 4 and tr.batch_size == 2
        assert tr.fused_apply is None  # auto: on CUDA only
        out = tr.fit()
        assert out["final_step"] == 2 and np.isfinite(out["best"]["psnr"])
        ck = os.path.join(wd, "checkpoints")
        meta = json.load(open(os.path.join(ck, "meta.json")))
        assert meta["last_step"] == 2
        assert sorted(CheckpointManager(ck).all_steps()) == sorted(
            {meta["best_step"], 2})
        cfg = json.load(open(os.path.join(ck, "model_config.json")))
        assert cfg["output_size"] == 64 and cfg["refiner"] == "hat_lite"
        best = tr.finalize()
        assert os.path.exists(os.path.join(best, "state.pt"))
        assert os.path.exists(os.path.join(wd, "final_weights",
                                           "model_config.json"))
        params = {k: v.clone() for k, v in tr.state.params.items()}
        lines = open(os.path.join(wd, "logs", "metrics.jsonl")).read()
        assert "train/star_l1" in lines and "val/psnr" in lines
    # resume: the restored state is the saved one, and training goes on
    with Trainer(_cfg(epochs=3), wd, device="cpu") as tr:
        assert tr.state.step == 2 and tr.start_epoch == 2
        assert tr.state.opt_state["count"] == 2
        for k, v in params.items():
            torch.testing.assert_close(tr.state.params[k], v)
            # the module holds the restored weights too
            torch.testing.assert_close(
                dict(tr.model.named_parameters())[k].detach(), v)
        assert tr.fit()["final_step"] == 3


def test_fused_trunk_forced_on_cpu_trains(tmp_path):
    # micro-batch 1 (accum 2): per-image fused blocks, no row packing
    cfg = _cfg(epochs=1, fused_trunk=True, accum_steps=2)
    with Trainer(cfg, str(tmp_path), device="cpu") as tr:
        assert tr.fused_apply is not None
        assert np.isfinite(tr.fit()["best"]["psnr"])


def test_fp32_fused_step_takes_the_f32_route(tmp_path, monkeypatch):
    """precision fp32 with the fused trunk: every dense block's backward
    runs kernel 13's launch sequence (forced here on CPU tensors, each
    _build helper a torch emulation of its kernel, require_cuda's type
    rule kept), on the f32 route (the conv engine's direct body and the
    f32 weight grads), with no TypeError and no launch on the tensor
    cores."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt
    from superresolution_tpu_torch.train import fused_apply
    from superresolution_tpu_torch.utils.chain_grad_forms import (
        grad_conv_form, wgrad_form)
    from superresolution_tpu_torch.utils.dense_tail_forms import (
        dense_conv_form)

    def checked(*tensors, dtype=torch.bfloat16, name):
        for t in tensors:
            if t is not None and t.dtype != dtype:
                raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")

    def scale(src, s, out):
        out[..., :src.shape[-1]] = s * src

    def launched(x, weights, residual=None, seg=None):
        return dtt.DenseBlockTrain.apply(x, residual, seg,
                                         *(t for p in weights for t in p))

    monkeypatch.setattr(_build, "require_cuda", checked)
    monkeypatch.setattr(_build, "dense_conv", dense_conv_form)
    monkeypatch.setattr(_build, "grad_conv", grad_conv_form)
    monkeypatch.setattr(_build, "wgrad", wgrad_form)
    monkeypatch.setattr(_build, "dense_scale", scale)
    monkeypatch.setattr(fused_apply, "fused_dense_block_train", launched)
    cfg = _cfg(epochs=1, fused_trunk=True, accum_steps=2)
    k13 = {k: getattr(dtt.dense_block_backward, k)
           for k in ("launches", "tc_launches", "direct_launches")}
    tc = dt.fused_dense_block.tc_launches
    with Trainer(cfg, str(tmp_path), device="cpu") as tr:
        assert tr.fused_apply is not None
        assert np.isfinite(tr.fit()["best"]["psnr"])
    # 3 dense blocks a micro-batch, 2 micro-batches a step, 1 step
    calls = dtt.dense_block_backward.launches - k13["launches"]
    assert calls == 6
    assert dtt.dense_block_backward.direct_launches == \
        k13["direct_launches"] + calls
    assert dtt.dense_block_backward.tc_launches == k13["tc_launches"]
    assert dt.fused_dense_block.tc_launches == tc


def test_unported_parts_raise(tmp_path):
    """Meshes still raise; GAN terms (a discriminator and the GAN step),
    manifests, bicubic degradation, previews and row-packed batches now
    run."""
    base = _cfg()
    with pytest.raises(NotImplementedError):
        Trainer(base.replace(mesh=dataclasses.replace(base.mesh, data=2)),
                str(tmp_path), device="cpu")
    gan = base.replace(loss=dataclasses.replace(
        base.loss, terms={"l1": 1.0, "gan": 0.005}))
    with Trainer(gan, str(tmp_path / "g"), device="cpu") as tr:
        assert tr.is_gan and tr.d_ckpt is not None
    # a manifest of real pairs: PairedDataset splits
    for i in range(2):
        pair = tmp_path / "pairs" / f"pair_{i}"
        rng = np.random.default_rng(i)
        save_tiff16(rng.random((64, 64, 1)), str(pair / "hubble.tiff"))
        save_tiff16(rng.random((16, 16, 1)), str(pair / "observatory.tiff"))
    man = prepare_splits(str(tmp_path / "pairs"), str(tmp_path / "splits"),
                         mode="overfit")
    cfg = base.replace(data=dataclasses.replace(
        base.data, train_manifest=man["train"], val_manifest=man["val"]))
    with Trainer(cfg, str(tmp_path / "m"), device="cpu") as tr:
        assert isinstance(tr.train_ds, PairedDataset)
        assert tr.train_ds[0]["lr"].shape == (16, 16, 1)
        assert tr.test_ds is tr.val_ds
    # bicubic: LR made from HR on the device
    cfg = base.replace(data=dataclasses.replace(base.data,
                                                degradation="bicubic"))
    with Trainer(cfg, str(tmp_path / "b"), device="cpu") as tr:
        lr, _ = tr.eval_input_fn({"hr": torch.rand(1, 64, 64, 1)}, None)
        assert lr.shape == (1, 16, 16, 1)
    # a preview due at epoch 2
    wd = tmp_path / "p"
    with Trainer(_cfg(preview_every=2, resume=False), str(wd),
                 device="cpu") as tr:
        assert np.isfinite(tr.fit()["best"]["psnr"])
    assert sorted(os.listdir(wd / "previews")) == ["epoch_00002.png"]
    # LR 16 with 2 images: row-packed through the seg form
    with Trainer(_cfg(fused_trunk=True), str(tmp_path / "s"),
                 device="cpu") as tr:
        assert tr.fused_apply is not None
        assert np.isfinite(tr.fit()["best"]["psnr"])
