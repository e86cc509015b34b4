"""The port's SRCNN, ESPCN, FSRCNN and EDSR (superresolution_tpu_torch/
models/) against the reference's flax models (superresolution_tpu/
models/) on the same weights, bridged by models/convert.py, in f32 on
the CPU: the models alone, through build_from_config for the four
presets, through load_params_for_inference from a params.npz and
model_config.json, and through api.upscale on both tilers.

Inputs and perturbed biases and PReLU slopes are made from a seed with
numpy. Tolerance: max |port - reference| within 2e-5 of max |reference|
(the same f32 arithmetic in another order; SRCNN's bicubic and EDSR's
16-block trunk add a few roundings). Each conversion also carries every
JAX leaf exactly once and loads strictly."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu import api as japi
from superresolution_tpu.models import get_model as jax_get_model
from superresolution_tpu.models.factory import (
    build_from_config as jax_build_from_config,
)
from superresolution_tpu.utils.config import get_preset as jax_get_preset
from superresolution_tpu_torch import api
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.factory import (
    build_from_config,
    get_model,
    total_scale,
)
from superresolution_tpu_torch.train.checkpoint import (
    load_params_for_inference,
    state_dict_from_jax_tree,
)
from superresolution_tpu_torch.utils.config import ModelConfig, get_preset

TOL = 2e-5
EDSR_SMALL = dict(features=16, num_blocks=2)
BRIDGES = {"srcnn": convert.srcnn_state_dict_from_jax,
           "espcn": convert.espcn_state_dict_from_jax,
           "fsrcnn": convert.fsrcnn_state_dict_from_jax,
           "edsr": convert.edsr_state_dict_from_jax}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    """Nonzero biases and PReLU slopes, so the bridge's mapping of each
    shows; kernels keep their MSRA init."""
    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias":
            return jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype)
        if name == "negative_slope":
            return jnp.asarray(rng.uniform(0.0, 0.3, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_model(name, seed, lr_hw=(6, 7), **kw):
    model = jax_get_model(name, **kw)
    c = kw.get("in_channels", 1)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, *lr_hw, c)))
    return model, _perturb(params, np.random.default_rng(seed))


def _check_bridge(params, sd) -> None:
    """Every JAX leaf value carried over exactly once: the same multiset
    of values (the bridge transposes kernels and unstacks scanned
    blocks)."""
    def values(leaves):
        return np.sort(np.concatenate(
            [np.asarray(a, np.float64).ravel() for a in leaves]))

    np.testing.assert_array_equal(
        values(sd.values()), values(jax.tree_util.tree_leaves(params)))


def _port_model(name, sd, **kw) -> torch.nn.Module:
    model = get_model(name, device="cpu", **kw)
    model.load_state_dict(convert.to_torch(sd), strict=True)
    return model.eval()


def _close(got, ref, tol=TOL) -> None:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _run_both(name, params, jmodel, port, x):
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, ref)
    return ref


@pytest.mark.parametrize("name,kw", [
    ("srcnn", dict(scale=2)),
    ("espcn", dict(scale=4)),
    ("espcn", dict(scale=3, in_channels=3, out_channels=3)),
    ("fsrcnn", dict(scale=4)),
    ("fsrcnn", dict(scale=2, d=24, s=8, m=2)),
])
def test_small_models_match_jax(name, kw):
    jmodel, params = _jax_model(name, 1, **kw)
    sd = BRIDGES[name](params)
    _check_bridge(params, sd)
    port = _port_model(name, sd, **kw)
    c = kw.get("in_channels", 1)
    x = np.random.default_rng(2).random((2, 9, 11, c), np.float32)
    _run_both(name, params, jmodel, port, x)


def test_fsrcnn_prelu_slopes_start_at_flax_default():
    model = get_model("fsrcnn", device="cpu")
    slopes = [p for n, p in model.named_parameters() if "prelu" in n]
    assert len(slopes) == 7
    assert all(p.shape == (1,) and float(p.detach()) == pytest.approx(0.01)
               for p in slopes)


@pytest.mark.parametrize("scan,c,scale", [
    (True, 3, 4), (False, 3, 4), (True, 1, 4), (False, 1, 2), (True, 3, 3),
    (False, 3, 8), (True, 1, 8), (True, 3, 2)])
def test_edsr_matches_jax(scan, c, scale):
    kw = dict(EDSR_SMALL, scale=scale, in_channels=c, out_channels=c,
              scan_blocks=scan)
    jmodel, params = _jax_model("edsr", scale, **kw)
    assert ("res_blocks" in params["params"]) == scan
    sd = convert.edsr_state_dict_from_jax(params)
    _check_bridge(params, sd)
    port = _port_model("edsr", sd, **kw)
    x = np.random.default_rng(scale).random((2, 6, 7, c), np.float32)
    _run_both("edsr", params, jmodel, port, x)


def test_edsr_mean_and_res_scale_follow_the_input_dtype():
    """bf16 input: the mean shift and res_scale in bf16, as the
    reference's jnp.asarray(..., x.dtype); the output stays bf16."""
    kw = dict(EDSR_SMALL, res_scale=0.1)
    jmodel, params = _jax_model("edsr", 5, **kw)
    port = _port_model("edsr", convert.edsr_state_dict_from_jax(params),
                       **kw).to(torch.bfloat16)
    x = np.random.default_rng(5).random((1, 6, 7, 3), np.float32)
    bf_params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    ref = np.asarray(jmodel.apply(bf_params,
                                  jnp.asarray(x).astype(jnp.bfloat16)),
                     np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # bf16 convs round at other places in the two frameworks
    _close(got.float().numpy(), ref, tol=0.03)


@pytest.mark.parametrize("preset", ["srcnn_x2", "espcn_x4", "fsrcnn_x4",
                                    "edsr_baseline_x4"])
def test_build_from_config_presets(preset):
    mc = get_preset(preset).model
    jmc = jax_get_preset(preset).model
    model = build_from_config(mc, device="cpu")
    assert type(model).__name__ == type(jax_build_from_config(jmc)).__name__
    assert total_scale(mc) == mc.scale
    jmodel = jax_build_from_config(jmc)
    c = mc.in_channels
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                           jnp.zeros((1, 8, 8, c))),
                      np.random.default_rng(3))
    sd = state_dict_from_jax_tree(params, {"name": mc.name,
                                           "kwargs": mc.kwargs})
    model.load_state_dict(convert.to_torch(sd), strict=True)
    x = np.random.default_rng(4).random((1, 8, 9, c), np.float32)
    _run_both(mc.name, params, jmodel, model.eval(), x)


def _export(tmp_path, params, cfg) -> None:
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(
                params["params"])}
    np.savez(tmp_path / "params.npz", **flat)
    (tmp_path / "model_config.json").write_text(json.dumps(cfg))


@pytest.mark.parametrize("name,kw", [
    ("edsr", dict(EDSR_SMALL, scan_blocks=True)),
    ("edsr", dict(EDSR_SMALL, scan_blocks=False)),
    ("espcn", {}), ("fsrcnn", dict(m=2)), ("srcnn", {})])
def test_load_params_for_inference_reads_an_exported_npz(name, kw, tmp_path):
    """The sequence of cmd_eval_folder: load_params_for_inference(
    with_config=True), build_from_config, total_scale."""
    c, scale = (3, 4) if name == "edsr" else (1, 2)
    jmodel, params = _jax_model(name, 6, scale=scale, in_channels=c,
                                out_channels=c, **kw)
    _export(tmp_path, params, {"name": name, "scale": scale,
                               "in_channels": c, "out_channels": c,
                               "kwargs": kw})
    sd, cfg = load_params_for_inference(str(tmp_path), with_config=True,
                                        device="cpu")
    mc = ModelConfig(**cfg)
    model = build_from_config(mc, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert total_scale(mc) == scale
    x = np.random.default_rng(7).random((1, 7, 6, c), np.float32)
    _run_both(name, params, jmodel, model.eval(), x)


@pytest.mark.parametrize("name,c", [("edsr", 3), ("espcn", 1)])
@pytest.mark.parametrize("on_device", [False, True])
def test_api_upscale_matches_jax(name, c, on_device):
    """api.upscale with the model by registry name, built through the
    factory on the port's tilers, against the reference's host tiler with
    the same weights at precision fp32."""
    kw = EDSR_SMALL if name == "edsr" else {}
    _, params = _jax_model(name, 8, scale=4, in_channels=c, out_channels=c,
                           **kw)
    sd = convert.to_torch(BRIDGES[name](params))
    img = np.random.default_rng(9).random((20, 28, c), np.float32)
    up = dict(tile=16, halo=4, batch=4, precision="fp32")
    ref = japi.upscale(img, 4, model=name, params=params, **up, **kw)
    got = api.upscale(img, 4, model=name, params=sd, device="cpu",
                      on_device=on_device, **up, **kw)
    got = got.numpy() if on_device else got
    assert got.shape == (80, 112, c)
    _close(got, ref)
