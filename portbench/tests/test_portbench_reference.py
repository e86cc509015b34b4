"""The frozen reference agrees with the port's plain CPU models, tilers
and optimizer at a tiny size, from the same state dict and inputs."""

import numpy as np
import pytest
import torch

from portbench.reference import models as R
from portbench.reference import train as RT
from portbench.reference.compare import tiled
from portbench.traffic import generate, starfield
from portbench.weights import make_weights

S1 = dict(num_in_ch=1, num_out_ch=1, num_feat=8, num_block=2, num_grow_ch=4,
          scale=2, upsampler="nearest_conv")
HAT = dict(in_chans=1, embed_dim=12, depths=[2, 2], num_heads=[2, 2],
           window_size=4, mlp_ratio=2.0, compress_ratio=3, squeeze_factor=30,
           conv_scale=0.01, overlap_ratio=0.5, upscale=2)
HYB = dict(stage1=S1, stage2=HAT, smoothing="balanced")


def port_rrdbnet(m):
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet

    return RRDBNet(scale=m["scale"], in_channels=m["num_in_ch"],
                   out_channels=m["num_out_ch"], features=m["num_feat"],
                   num_blocks=m["num_block"], growth=m["num_grow_ch"],
                   upsampler=m["upsampler"], device="cpu")


def port_hybrid(output_size=None):
    from superresolution_tpu_torch.models.hat_lite import HATLite
    from superresolution_tpu_torch.models.hybrid import HybridSR

    return HybridSR(port_rrdbnet(S1), HATLite(
        scale=2, in_channels=1, out_channels=1, embed_dim=12, depths=(2, 2),
        num_heads=(2, 2), window_size=4, device="cpu"),
        output_size=output_size, smoothing="balanced")


@pytest.mark.parametrize("upsampler,scale", [("pixelshuffle", 4),
                                             ("nearest_conv", 2)])
def test_rrdbnet(upsampler, scale):
    m = dict(S1, num_in_ch=3, num_out_ch=3, scale=scale, upsampler=upsampler)
    p = make_weights(R.rrdbnet_specs(m), 3,
                     {"out_gain": 0.1, "out_bias": 0.5}, torch.float32, "cpu")
    model = port_rrdbnet(m)
    model.load_state_dict(p, strict=True)
    x = torch.rand(2, 12, 16, 3)
    with torch.no_grad():
        torch.testing.assert_close(R.rrdbnet(p, m, x), model(x),
                                   rtol=1e-5, atol=1e-5)


def test_hybrid():
    p = make_weights(R.hybrid_specs(HYB), 4, {"out_gain": {"stage1": 0.3, "stage2": 0.1},
                      "out_bias": 0.1}, torch.float32, "cpu")
    model = port_hybrid()
    model.load_state_dict(p, strict=True)
    x = torch.from_numpy(starfield.star_field(np.random.default_rng(0),
                                              8))[None]
    with torch.no_grad():
        torch.testing.assert_close(R.hybrid(p, HYB, x, None), model(x),
                                   rtol=1e-5, atol=1e-5)


def test_starfield_is_the_ports_generator():
    from superresolution_tpu_torch.data.dataset import (
        make_synthetic_image, synthesize_observed_lr)

    seed, index = 3, 5
    rng = np.random.default_rng(np.uint32(seed * 1_000_003 + index))
    np.testing.assert_array_equal(starfield.star_field(rng, 64),
                                  make_synthetic_image(index, 64, 1, seed))
    hr = make_synthetic_image(1, 64, 1, 0)
    np.testing.assert_array_equal(
        starfield.observed_lr(hr, 4, np.random.default_rng(7)),
        synthesize_observed_lr(hr, 4, np.random.default_rng(7)))


@pytest.mark.parametrize("tile,halo,batch", [((6, 8), 2, 3), (8, 3, 2)])
def test_tiler_matches_the_ports_on_device_tilers(tile, halo, batch):
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer, make_tiled_infer_staged)

    def fn(t):  # a shift-variant map, so misplaced tiles show
        return torch.nn.functional.interpolate(
            (t * torch.arange(t.shape[2]).float()[None, None, :, None])
            .permute(0, 3, 1, 2), scale_factor=2).permute(0, 2, 3, 1)

    img = torch.rand(13, 17, 1)
    ref = tiled(fn, img, 2, tile, halo, batch)
    if isinstance(tile, int):
        got = make_tiled_infer(fn, 2, tile, halo, batch, 13, 17, 1,
                               device="cpu")(img)
    else:
        got = make_tiled_infer_staged(lambda t: t, fn, 2, tile, halo, batch,
                                      13, 17, 1, device="cpu")(img)
    torch.testing.assert_close(ref, got, rtol=0, atol=0)


def test_photo_frames_are_seeded():
    t = dict(height=10, width=14, channels=3, octaves=[[4, 0.6], [2, 0.4]],
             pool=2)
    a = generate.photo_frames(t, 9, "cpu")
    b = generate.photo_frames(t, 9, "cpu")
    assert torch.equal(a[1], b[1]) and not torch.equal(a[0], a[1])
    assert a[0].shape == (10, 14, 3)


def test_training_step_matches_the_ports_f32_step():
    """One reference step (augmentation, star L1, clip, AdamW) against the
    port's plain step at f32 on the same weights, batch and generator."""
    from superresolution_tpu_torch.losses.combined import CombinedLoss
    from superresolution_tpu_torch.train.state import (create_train_state,
                                                       make_optimizer)
    from superresolution_tpu_torch.train.steps import (make_device_input,
                                                       make_train_step)
    from superresolution_tpu_torch.utils.config import (DataConfig,
                                                        LossConfig,
                                                        TrainConfig)
    from superresolution_tpu_torch.utils.precision import FP32_POLICY

    t = dict(hr_patch=32, star_threshold=0.02, star_weight=500.0, lr=5e-4,
             lr_min=1e-7, weight_decay=0.01, betas=[0.9, 0.999],
             grad_clip_norm=1.0)
    cfg = {"model": HYB, "train": t}
    p = make_weights(R.hybrid_specs(HYB), 5, {"out_gain": {"stage1": 0.3, "stage2": 0.1},
                      "out_bias": 0.1}, torch.float32, "cpu")
    model = port_hybrid(output_size=32)
    model.load_state_dict(p, strict=True)
    tc = TrainConfig(lr=t["lr"], lr_min=t["lr_min"],
                     weight_decay=t["weight_decay"], grad_clip_norm=1.0)
    tx, _ = make_optimizer(tc, 100)
    state = create_train_state({k: v.detach() for k, v in
                                model.named_parameters()}, tx)
    step = make_train_step(
        model, CombinedLoss(LossConfig(terms={"star_l1": 1.0})), tx,
        FP32_POLICY, make_device_input(DataConfig(degradation="none",
                                                  hr_patch=32), 4))
    pairs = generate.star_pairs(dict(size=32, scale=4, pool=2), 11)
    lr = torch.stack([torch.from_numpy(a) for a, _ in pairs])
    hr = torch.stack([torch.from_numpy(b) for _, b in pairs])
    gen = torch.Generator().manual_seed(77)
    gstate = gen.get_state()
    ref = RT.Steps(cfg, p, 100)
    loss_r, g, _ = ref.step(lr, hr, gstate)
    state, logs = step(state, {"lr": lr, "hr": hr}, gen)
    assert float(logs["total"]) == pytest.approx(loss_r, rel=1e-5)
    assert float(logs["grad_norm"]) == pytest.approx(float(RT.norm(g)),
                                                     rel=1e-4)
    # AdamW's first step divides each gradient by its own magnitude, so
    # where |g| is near eps (1e-8) the order of the two sides' f32 sums
    # moves the step: compare the weights to a tenth of one step
    for k, v in ref.p.items():
        torch.testing.assert_close(state.params[k], v, rtol=0,
                                   atol=0.1 * t["lr"])
