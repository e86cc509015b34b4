"""The port's HATLite and HybridSR (superresolution_tpu_torch/models/
hat_lite.py, hybrid.py) and their numpy helpers against the JAX package:
the index tables, region ids and unfold exactly; the models' forwards on
bridged weights in f32 to 1e-4 of max |ref|, with the plain attention and
with kernel 10 (flash_attn / flash_oca, its plain form on the CPU against
the JAX kernel in interpret mode), and HybridSR's bicubic resize to
output_size. Small geometry (embed 12, depths (2, 2), 3 heads, window
4)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.models import HATLite as JaxHATLite
from superresolution_tpu.models import HybridSR as JaxHybridSR
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.models import hat_lite as jhat
from superresolution_tpu.ops.unfold import (
    extract_overlapping_windows as jax_unfold,
)
from superresolution_tpu_torch.models import convert, hat_lite
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.models.hybrid import HybridSR
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.ops.unfold import extract_overlapping_windows

KW = dict(scale=2, in_channels=1, out_channels=1, embed_dim=12,
          depths=(2, 2), num_heads=(3, 3), window_size=4)
TOL = 1e-4


def _close(got: np.ndarray, ref: np.ndarray, tol: float = TOL) -> None:
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < tol, err


@pytest.mark.parametrize("ws", [4, 8])
def test_relative_position_index_equals_jax(ws):
    np.testing.assert_array_equal(hat_lite.relative_position_index(ws),
                                  jhat._relative_position_index(ws))
    ows = int(ws * 1.5)
    np.testing.assert_array_equal(
        hat_lite.relative_position_index_oca(ws, ows),
        jhat._relative_position_index_oca(ws, ows))


@pytest.mark.parametrize("h,w,ws", [(16, 16, 4), (12, 20, 4), (32, 24, 8)])
def test_shift_region_ids_equal_jax(h, w, ws):
    np.testing.assert_array_equal(
        hat_lite.shift_region_ids(h, w, ws, ws // 2),
        jhat._shift_region_ids(h, w, ws, ws // 2))


@pytest.mark.parametrize("h,w,ws,ows", [(12, 16, 4, 6), (16, 8, 8, 12),
                                        (8, 12, 4, 5)])
def test_unfold_and_windows_equal_jax(h, w, ws, ows):
    """Bitwise: the gather and the window partition / merge only move
    data. ows 5 is the odd extent (asymmetric tail pad)."""
    rng = np.random.default_rng(0)
    kv = rng.standard_normal((2, h + ows - ws, w + ows - ws, 6)).astype(
        np.float32)
    ref = np.asarray(jax_unfold(jnp.asarray(kv), ws, ows, h // ws, w // ws))
    got = extract_overlapping_windows(torch.from_numpy(kv), ws, ows,
                                      h // ws, w // ws).numpy()
    np.testing.assert_array_equal(got, ref)
    x = rng.standard_normal((2, h, w, 6)).astype(np.float32)
    wins = np.asarray(jhat.window_partition(jnp.asarray(x), ws))
    got_w = hat_lite.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got_w.numpy(), wins)
    np.testing.assert_array_equal(
        hat_lite.window_merge(got_w, ws, (h, w)).numpy(), x)


def jax_variables(model, shape, seed=0):
    """model.init (jitted: about half the time of the eager init), then
    every bias and rel-pos table drawn N(0, 0.1) and every LayerNorm
    scale 1 + N(0, 0.1) from numpy, so the checks cover those paths
    (the init leaves them 0 or 1)."""
    variables = jax.jit(model.init)(jax.random.key(seed), jnp.zeros(shape))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        a = np.asarray(leaf)
        if name in ("bias", "rel_pos_bias", "rel_pos_bias_oca"):
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        if name == "scale":
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, variables)


@functools.lru_cache(maxsize=None)
def _hat_pair(compat, seed=0, shape=(2, 12, 16, 1)):
    jm = JaxHATLite(**KW, hat_compat=compat, upsample_feat=8)
    variables = jax_variables(jm, shape, seed)
    sd = convert.hat_state_dict_from_jax(variables, depths=KW["depths"],
                                         hat_compat=compat)
    tm = HATLite(**KW, hat_compat=compat, upsample_feat=8, device="cpu")
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    return jm, variables, sd, tm.eval()


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 16, 1), (1, 10, 13, 1)])
def test_hat_lite_matches_jax_apply(compat, shape):
    """(1, 10, 13) is not a multiple of the window: edge pad + crop."""
    jm, variables, _, tm = _hat_pair(compat)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 1)
    _close(got, ref)


@pytest.mark.parametrize("flash_attn,flash_oca",
                         [(True, None), (True, False), (False, True)])
def test_hat_lite_flash_matches_jax_apply(flash_attn, flash_oca):
    """flash_oca None follows flash_attn, as in the JAX model."""
    _, variables, sd, _ = _hat_pair(False)
    kw = dict(KW, upsample_feat=8, flash_attn=flash_attn, flash_oca=flash_oca)
    tm = HATLite(**kw, device="cpu")
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    assert tm.layers[0].overlap_attn.flash == (flash_attn if flash_oca is None
                                               else flash_oca)
    x = np.random.default_rng(3).standard_normal((2, 12, 16, 1)).astype(
        np.float32)
    ref = np.asarray(jax.jit(JaxHATLite(**kw).apply)(variables,
                                                     jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, ref)


@pytest.mark.parametrize("geom", [
    dict(embed_dim=12, depths=(2, 2), num_heads=(3, 3), window_size=4),
    dict(embed_dim=32, depths=(2,), num_heads=(2,), window_size=8)])
def test_hat_lite_flash_habs_take_the_map_form(monkeypatch, geom):
    """Under flash_attn every HAB's self-attention goes through kernel
    10's map form (one flash_map_attention call a HAB, with the block's
    shift; no window_partition but the OCABs' queries), and the model
    still matches the JAX one's apply with flash attention (head dims 4
    and 16, windows 4 and 8, shifted and unshifted blocks)."""
    kw = dict(scale=2, in_channels=1, out_channels=1, upsample_feat=8,
              flash_attn=True, **geom)
    shape = (1, 2 * geom["window_size"], 3 * geom["window_size"], 1)
    jm = JaxHATLite(**kw)
    variables = jax_variables(jm, shape, 4)
    sd = convert.hat_state_dict_from_jax(variables, depths=geom["depths"],
                                         hat_compat=False)
    tm = HATLite(**kw, device="cpu")
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    calls, parts = [], []
    real_map, real_part = hat_lite.flash_map_attention, \
        hat_lite.window_partition

    def spy_map(qkv, bias, nh, ws, shift):
        calls.append(shift)
        return real_map(qkv, bias, nh, ws, shift)

    def spy_part(x, ws):
        parts.append(ws)
        return real_part(x, ws)

    monkeypatch.setattr(hat_lite, "flash_map_attention", spy_map)
    monkeypatch.setattr(hat_lite, "window_partition", spy_part)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, ref)
    ws = geom["window_size"]
    assert calls == [0, ws // 2] * (sum(geom["depths"]) // 2)
    assert len(parts) == len(geom["depths"])  # the OCABs' queries


@functools.lru_cache(maxsize=None)
def _hybrid_pair(seed=0):
    s1 = dict(scale=2, in_channels=1, out_channels=1, features=16,
              num_blocks=1, growth=8, upsampler="pixelshuffle")
    jm = JaxHybridSR(stage1=JaxRRDBNet(**s1),
                     stage2=JaxHATLite(**KW, upsample_feat=8),
                     output_size=32, smoothing="balanced")
    variables = jax_variables(jm, (1, 8, 8, 1), seed)
    sd = convert.hybrid_state_dict_from_jax(
        variables, num_blocks=1, features=16, growth=8, depths=KW["depths"])
    tm = HybridSR(RRDBNet(**s1, device="cpu"),
                  HATLite(**KW, upsample_feat=8, device="cpu"),
                  output_size=32, smoothing="balanced")
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    return jm, variables, sd, tm.eval()


def test_hybrid_matches_jax_apply():
    jm, variables, _, tm = _hybrid_pair()
    x = np.random.default_rng(2).random((2, 8, 8, 1), np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, 1)
    _close(got, ref)


def test_hybrid_resize_and_flash_are_not_ported():
    """Both are ported now: a stage output (32) that is not output_size
    (40) is resized as the JAX model resizes it (bicubic a=-0.75, no
    antialias), and HATLite takes the flash flags (the models are checked
    in test_hat_lite_flash_matches_jax_apply)."""
    jm, variables, _, tm = _hybrid_pair()
    x = np.random.default_rng(4).random((1, 8, 8, 1), np.float32)
    ref = np.asarray(jax.jit(jm.clone(output_size=40).apply)(
        variables, jnp.asarray(x)))
    tm40 = HybridSR(tm.stage1, tm.stage2, output_size=40,
                    smoothing="balanced")
    with torch.no_grad():
        got = tm40(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 40, 40, 1)
    _close(got, ref)
    for kw in ({"flash_attn": True}, {"flash_oca": True}):
        assert HATLite(**KW, **kw, device="cpu").layers[0].overlap_attn.flash
