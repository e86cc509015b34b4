"""The port's Trainer at the reference's defaults, on the CPU at tiny
widths: every preset (srcnn_x2, espcn_x4, fsrcnn_x4, edsr_baseline_x4,
esrgan_x4_tiled row-packed, hybrid_astro; esrgan_gan with its
discriminator and perceptual term, hybrid_astro_prod and
hybrid_astro_h200 with theirs) fits 2 epochs with its own data, loss and
loop settings, a preview due each epoch and an async checkpoint (and
D's beside it on the GAN preset); the preview strip's
three panels are the eval step's nearest-upsampled LR, SR and HR (8-bit,
exactly). Then the checkpoint extras against the JAX package's
contracts: save(block=False) snapshots before it returns, wait,
restore_best, and finalize(probe=params_probe(...)) passing a path the
saved tree holds and raising KeyError, with the JAX probe's message, for
one it lacks."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from superresolution_tpu_torch.ops.resize import resize_nearest
from superresolution_tpu_torch.train.checkpoint import (
    CheckpointManager,
    params_probe,
)
from superresolution_tpu_torch.train.state import TrainState
from superresolution_tpu_torch.train.trainer import Trainer, _step_generator
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


# the presets' own configs, cut to tiny widths (the models' depth and
# width kwargs) and patches; everything else is the preset's
TINY = {
    "srcnn_x2": ({}, 32),
    "espcn_x4": ({}, 32),
    "fsrcnn_x4": ({}, 32),
    "edsr_baseline_x4": ({"num_blocks": 1, "features": 8, "res_scale": 1.0},
                         32),
    "esrgan_x4_tiled": ({"features": 8, "num_blocks": 1, "growth": 4}, 32),
    "hybrid_astro": ({"features": 8, "num_blocks": 1, "growth": 4,
                      "remat": True}, 64),
    "esrgan_gan": ({"features": 8, "num_blocks": 1, "growth": 4}, 32),
    "hybrid_astro_prod": ({"features": 8, "num_blocks": 1, "growth": 4,
                           "remat": True}, 64),
    "hybrid_astro_h200": ({"features": 8, "num_blocks": 1, "growth": 4,
                           "remat": True}, 64),
}


def _tiny(name, **train):
    kw, patch = TINY[name]
    cfg = get_preset(name)
    mc = dataclasses.replace(cfg.model, kwargs=kw or cfg.model.kwargs)
    if cfg.model.refiner:
        mc = dataclasses.replace(mc, refiner_kwargs={
            "scale": 2, "embed_dim": 8, "depths": (1,), "num_heads": (2,),
            "window_size": 8})
    data = dataclasses.replace(cfg.data, hr_patch=patch, batch_size=2,
                               synthetic_len=4, num_workers=1)
    # f32: bf16 convs are slow on the CPU
    tc = dict(epochs=2, steps_per_epoch=1, eval_every=1, preview_every=1,
              precision="fp32", resume=False)
    tc.update(train)
    return cfg.replace(model=mc, data=data,
                       train=dataclasses.replace(cfg.train, **tc))


@pytest.mark.parametrize("name", sorted(TINY))
def test_preset_fits_with_previews_and_async_checkpoints(tmp_path, name):
    # esrgan's LR 8 with 2 images: the row-packed (seg) trunk, forced on
    cfg = _tiny(name, fused_trunk=True if name == "esrgan_x4_tiled"
                else None)
    wd = str(tmp_path)
    with Trainer(cfg, wd, device="cpu") as tr:
        assert (tr.fused_apply is not None) == (name == "esrgan_x4_tiled")
        out = tr.fit()
        assert out["final_step"] == 2 and np.isfinite(out["best"]["psnr"])
        assert sorted(os.listdir(os.path.join(wd, "previews"))) == [
            "epoch_00001.png", "epoch_00002.png"]
        ck = CheckpointManager(os.path.join(wd, "checkpoints"))
        assert ck.meta["last_step"] == 2 and 2 in ck.all_steps()
        assert tr.is_gan == (name == "esrgan_gan")
        if tr.is_gan:
            dk = CheckpointManager(os.path.join(wd, "checkpoints_disc"))
            assert dk.meta["last_step"] == 2 and 2 in dk.all_steps()
        # the last preview: the eval step on val_ds[0] at the final state
        batch = {k: torch.from_numpy(np.asarray(v)[None])
                 for k, v in tr.val_ds[0].items()}
        ev = tr._eval_step(tr.state, batch,
                           _step_generator(cfg.train.seed, 2 ** 31 - 1))
    hr0, sr = ev["hr"][0], ev["pred"][0]
    lr_up = resize_nearest(ev["lr"][0].float(), tuple(hr0.shape[:2]))
    png = np.asarray(Image.open(os.path.join(wd, "previews",
                                             "epoch_00002.png")))
    w = hr0.shape[1]
    c = cfg.model.out_channels
    png = png.reshape(hr0.shape[0], 3 * w, c)
    for i, panel in enumerate((lr_up, sr, hr0)):
        want = (np.clip(panel.numpy(), 0, 1) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(png[:, i * w:(i + 1) * w], want,
                                      err_msg=f"{name} panel {i}")


def _state(v: float) -> TrainState:
    return TrainState(step=int(v), params={"w": torch.full((3, 2), v),
                                           "b": torch.full((2,), -v)},
                      opt_state={"count": torch.tensor(int(v))})


def test_async_save_snapshots_before_it_returns(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=3)
    st = _state(1.0)
    ck.save(st, 1, psnr=20.0, block=False)
    st.params["w"].add_(100.0)  # the next step's in-place update
    ck.wait()
    got = ck.restore(_state(0.0), step=1)
    assert torch.equal(got.params["w"], torch.full((3, 2), 1.0))
    assert ck.all_steps() == [1] and ck.meta["last_step"] == 1


def test_restore_best_and_finalize_with_probe(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"), keep=2,
                           model_config={"name": "srcnn"})
    for step, psnr in ((1, 20.0), (2, 25.0), (3, 22.0)):
        ck.save(_state(float(step)), step, psnr=psnr, block=False)
    # a new save waits for the one in flight; restore waits too
    assert ck.meta["best_step"] == 2 and ck.meta["last_step"] == 3
    best = ck.restore_best(_state(0.0))
    assert best.step == 2 and torch.equal(best.params["b"],
                                          torch.full((2,), -2.0))
    assert ck.restore(_state(0.0)).step == 3
    dst = ck.finalize(str(tmp_path / "final"), probe=params_probe("params/w"))
    assert os.path.exists(os.path.join(dst, "state.pt"))
    assert os.path.exists(tmp_path / "final" / "model_config.json")
    with pytest.raises(KeyError, match="finalized checkpoint missing "
                                       "'params/missing'"):
        ck.finalize(str(tmp_path / "final"),
                    probe=params_probe("params/missing"))


def test_restore_best_without_a_best_is_the_last(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(_state(4.0), 4, block=False)
    got = ck.restore_best(_state(0.0))
    assert got.step == 4


def test_params_probe_contract_matches_jax(tmp_path):
    """The JAX package's params_probe on its orbax checkpoint and the
    port's on its state.pt take the same '/'-joined path into the saved
    tree: both pass a present path and raise the same KeyError for an
    absent one."""
    import jax.numpy as jnp

    from superresolution_tpu.train.checkpoint import (
        CheckpointManager as JaxCheckpointManager,
        params_probe as jax_params_probe,
    )

    jck = JaxCheckpointManager(str(tmp_path / "jax"))
    jck.save({"step": jnp.int32(1), "params": {"w": jnp.ones((3, 2))}}, 1)
    jdst = jck.finalize(str(tmp_path / "jax_final"))
    ck = CheckpointManager(str(tmp_path / "port"))
    ck.save(_state(1.0), 1)
    dst = ck.finalize(str(tmp_path / "port_final"))
    for probe, path in ((jax_params_probe, jdst), (params_probe, dst)):
        probe("params/w")(path)
        with pytest.raises(KeyError) as e:
            probe("params/nope")(path)
        assert "finalized checkpoint missing 'params/nope'" in str(e.value)
