"""The quality anchor on the committed checkpoint, on the CPU in f32.

assets/quality/port/params.npz (tools/export_params_npz.py's export of
assets/quality/final_weights/best) must equal the orbax restore bit for
bit; the port loads it (train/checkpoint.load_params_for_inference), and
its plain RRDBNet on the 8 bicubic-degraded synthetic images must match
the JAX model's apply within 1e-5 and score the JAX CPU figures: PSNR
25.6021 dB and bicubic 23.5988 dB, each within 0.001 dB."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.data.dataset import SyntheticHRDataset as JaxData
from superresolution_tpu.models.factory import get_model as jax_get_model
from superresolution_tpu.ops.degradation import (
    degrade_bicubic as jax_degrade,
)
from superresolution_tpu.train.checkpoint import (
    load_params_for_inference as jax_load,
)
from superresolution_tpu_torch.data.dataset import SyntheticHRDataset
from superresolution_tpu_torch.metrics.psnr_ssim import psnr
from superresolution_tpu_torch.models.factory import get_model
from superresolution_tpu_torch.ops.degradation import degrade_bicubic
from superresolution_tpu_torch.ops.resize import resize_bicubic
from superresolution_tpu_torch.train.checkpoint import (
    load_params_for_inference,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "assets", "quality", "port")
JAX_DIR = os.path.join(ROOT, "assets", "quality", "final_weights", "best")
PSNR_F32, BICUBIC = 25.6021, 23.5988   # the JAX package, f32, CPU


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


def test_committed_npz_equals_orbax_restore():
    params, cfg = jax_load(JAX_DIR, with_config=True)
    ref = _flatten(params.get("params", params))
    with np.load(os.path.join(PORT_DIR, "params.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref) and len(got) == 30
    for k in ref:
        assert ref[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])
    _, port_cfg = load_params_for_inference(PORT_DIR, with_config=True,
                                            device="cpu")
    assert port_cfg == cfg


def _model(cfg):
    return get_model(cfg["name"], scale=cfg["scale"],
                     in_channels=cfg["in_channels"],
                     out_channels=cfg["out_channels"], device="cpu",
                     **cfg["kwargs"])


def test_port_model_matches_jax_and_scores_the_anchor():
    sd, cfg = load_params_for_inference(PORT_DIR, with_config=True,
                                        device="cpu")
    assert sum(v.numel() for v in sd.values()) == 1_811_651
    model = _model(cfg).eval()
    model.load_state_dict(sd, strict=True)
    scale = cfg["scale"]
    ds = SyntheticHRDataset(8, 128, cfg["out_channels"], seed=2)
    hr = torch.stack([torch.from_numpy(ds[i]["hr"]) for i in range(8)])
    lr = degrade_bicubic(hr, scale)
    with torch.no_grad():
        sr = model(lr)

    jparams = jax_load(JAX_DIR)
    jm = jax_get_model(cfg["name"], scale=scale,
                       in_channels=cfg["in_channels"],
                       out_channels=cfg["out_channels"], **cfg["kwargs"])
    jds = JaxData(8, 128, cfg["out_channels"], seed=2)
    jhr = jnp.stack([jnp.asarray(jds[i]["hr"]) for i in range(8)])
    np.testing.assert_array_equal(hr.numpy(), np.asarray(jhr))
    jlr = jax.vmap(lambda im: jax_degrade(im, scale))(jhr)
    ref = np.asarray(jax.jit(jm.apply)(
        {"params": jparams.get("params", jparams)}, jlr))
    assert np.max(np.abs(sr.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))

    p = float(psnr(sr.clamp(0, 1), hr).mean())
    up = resize_bicubic(lr, (128, 128)).clamp(0, 1)
    pb = float(psnr(up, hr).mean())
    assert abs(p - PSNR_F32) <= 1e-3, p
    assert abs(pb - BICUBIC) <= 1e-3, pb
