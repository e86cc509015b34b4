"""The fused HAT's deploy levers in the port (superresolution_tpu_torch/
infer/fused_hat.py, infer/lane_pad.py and the c_real LayerNorm divisor of
ops/hab.py) against the JAX package on the CPU, where the port's kernel
wrappers run their plain versions and the JAX Pallas kernels run in
interpret mode, on the same numpy inputs, in f32 to the reference tests'
bar (atol 2e-5, rtol 2e-4; the pad transform exactly):
  * c_real in layer_norm, kernel 7 (fused_cab_convs) and kernel 8
    (fused_hab_block) against the reference's _ln, fused_cab_convs and
    fused_hab_block_inference, on lane-padded inputs (C 12 in 16 lanes, 3
    heads of 4 in 4), whose pad lanes must come out exactly zero;
  * pad_hat_params against the reference's padded tree through
    hat_state_dict_from_jax, bit for bit, hat_compat off and on, and
    lane_pad_supported's truth table;
  * make_fused_hat under SRTPU_STRIP_HAB (and SRTPU_STRIP_RB),
    SRTPU_LANE_PAD with SRTPU_LANE_PAD_TO 16 (compat off and on) and the
    unsupported 18, SRTPU_XLA_CAB, and strip with lane pad (the strip
    lever applies only unpadded), against the JAX make_fused_hat under
    the same environment, with the port's kernel calls recorded;
  * fused_hybrid_model under the strip and lane-pad levers against the
    JAX one at a cut depth."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.infer import fused_hat as jfused
from superresolution_tpu.infer import lane_pad as jlane
from superresolution_tpu.models import HATLite as JaxHATLite
from superresolution_tpu.models import HybridSR as JaxHybridSR
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.ops import pallas_hab as jhab
from superresolution_tpu_torch.infer import fused_hat
from superresolution_tpu_torch.infer.lane_pad import (
    lane_pad_supported,
    pad_hat_params,
)
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.models.hybrid import HybridSR
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.ops import hab
from test_torch_fused_hat import S1, _hat
from test_torch_hat_lite import KW, jax_variables

ATOL, RTOL = 2e-5, 2e-4
C, CP, NH, NHP = 12, 16, 3, 4  # 3 heads of 4 lanes padded to 4 heads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _padded(rng, *shape, s=1.0, pad_axes=(-1,)):
    """N(0, s^2) on the real C channels of each axis in pad_axes, zeros
    in the lanes past C up to CP."""
    a = (rng.standard_normal(shape) * s).astype(np.float32)
    for ax in pad_axes:
        idx = [slice(None)] * a.ndim
        idx[ax] = slice(C, None)
        a[tuple(idx)] = 0
    return a


@pytest.mark.parametrize("c_real", [None, C])
def test_layer_norm_c_real_matches_jax(c_real):
    rng = np.random.default_rng(0)
    x = _padded(rng, 4, 5, CP)
    s, b = 1 + _padded(rng, CP, s=0.1), _padded(rng, CP, s=0.5)
    s[C:] = 0
    ref = jfused._ln(jnp.asarray(x), {"scale": s, "bias": b}, c_real)
    got = hab.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                         torch.from_numpy(b), c_real)
    _close(got.numpy(), ref)
    if c_real:
        assert not got[..., C:].any()


def test_fused_cab_convs_c_real_matches_jax_kernel():
    rng = np.random.default_rng(1)
    mid = C // 3
    x = _padded(rng, 2, 8, 10, CP)
    ln_s = 1 + _padded(rng, CP, s=0.1)
    ln_s[C:] = 0
    ln_b = _padded(rng, CP, s=0.5)
    k1 = _padded(rng, 3, 3, CP, mid, s=(9 * C) ** -0.5, pad_axes=(2,))
    b1 = (0.3 * rng.standard_normal(mid)).astype(np.float32)
    k2 = _padded(rng, 3, 3, mid, CP, s=(9 * mid) ** -0.5)
    b2 = _padded(rng, CP, s=0.3)
    hp = {"LayerNorm_0": {"scale": ln_s, "bias": ln_b},
          "ChannelAttentionBlock_0": {
              "Conv_0": {"Conv_0": {"kernel": k1, "bias": b1}},
              "Conv_1": {"Conv_0": {"kernel": k2, "bias": b2}}}}
    ref = jhab.fused_cab_convs(jnp.asarray(x),
                               jhab.cab_weights(hp, jnp.float32),
                               interpret=True, c_real=C)
    got = hab.fused_cab_convs(torch.from_numpy(x), [
        torch.from_numpy(a) for a in (ln_s, ln_b, k1, b1, k2, b2)], c_real=C)
    _close(got.numpy(), ref)
    assert not got[..., C:].any()


@pytest.mark.parametrize("masked", [False, True])
def test_fused_hab_block_c_real_matches_jax_kernel(masked):
    """Kernel 8 at C 12 in 16 lanes with a fourth, zero head: the pad
    head attends uniformly over zero values and adds exactly zero."""
    rng = np.random.default_rng(2)
    nb, n, mlp = 8, 16, 24

    def r(*shape, s=0.1, pad=(-1,)):
        return _padded(rng, *shape, s=s, pad_axes=pad)

    x, cab = r(nb, n, CP, s=1.0), r(nb, n, CP, s=0.3)
    jw = {"ln1_s": 1 + r(1, CP), "ln1_b": r(1, CP),
          "wq": r(CP, CP, s=0.6, pad=(0, 1)),
          "wk": r(CP, CP, s=0.6, pad=(0, 1)),
          "wv": r(CP, CP, s=0.3, pad=(0, 1)), "bq": r(1, CP),
          "bk": r(1, CP), "bv": r(1, CP), "rpb": r(NHP, n, n, s=1.0, pad=()),
          "wp": r(CP, CP, s=0.3, pad=(0, 1)), "bp": r(1, CP),
          "ln2_s": 1 + r(1, CP), "ln2_b": r(1, CP),
          "w1": r(CP, mlp, s=0.3, pad=(0,)), "b1": r(1, mlp, pad=()),
          "w2": r(mlp, CP, s=0.3), "b2": r(1, CP)}
    for k in ("ln1_s", "ln2_s"):
        jw[k][:, C:] = 0
    jw["rpb"][NH:] = 0
    ids = rng.integers(0, 3, (4, n)).astype(np.int32) if masked else None
    ref = jhab.fused_hab_block_inference(
        jnp.asarray(x), jnp.asarray(cab), NHP, True,
        {k: jnp.asarray(v) for k, v in jw.items()},
        None if ids is None else jnp.asarray(ids), c_real=C)
    tw = {k: torch.from_numpy(v.reshape(-1) if v.shape[0] == 1 else v)
          for k, v in jw.items() if k[1:] not in ("q", "k", "v")}
    tw["wqkv"] = torch.from_numpy(np.concatenate(
        [jw["wq"], jw["wk"], jw["wv"]], axis=1))
    tw["bqkv"] = torch.from_numpy(np.concatenate(
        [jw["bq"], jw["bk"], jw["bv"]], axis=1).reshape(-1))
    got = hab.fused_hab_block(torch.from_numpy(x), torch.from_numpy(cab),
                              NHP, tw,
                              None if ids is None else torch.from_numpy(ids),
                              c_real=C)
    _close(got.numpy(), ref)
    assert not got[..., C:].any()


@pytest.mark.parametrize("compat", [False, True])
def test_pad_hat_params_equals_the_reference_padded_tree(compat):
    jm, variables, sd, tm = _hat(compat)
    tree, nhp = jlane.pad_hat_params(variables["params"], jm, CP)
    want = convert.hat_state_dict_from_jax(tree, depths=KW["depths"],
                                           hat_compat=compat)
    got, got_nhp = pad_hat_params(sd, tm, CP)
    assert got_nhp == nhp == NHP
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_lane_pad_supported_matches_the_reference():
    for c, nh, c_pad in itertools.product((12, 16, 96, 120, 128),
                                          (3, 4, 5, 6, 8), (16, 18, 128)):
        assert (lane_pad_supported(c, nh, c_pad)
                == jlane.lane_pad_supported(c, nh, c_pad)), (c, nh, c_pad)
    assert lane_pad_supported(96, 6) and not lane_pad_supported(120, 6)
    with pytest.raises(ValueError, match="unsupported"):
        pad_hat_params(_hat(False)[2], _hat(False)[3], 18)


STRIP = {"SRTPU_STRIP_HAB": "1"}
PAD16 = {"SRTPU_LANE_PAD": "1", "SRTPU_LANE_PAD_TO": "16"}
LEVERS = {
    "strip": (False, STRIP),
    "strip_rb4": (False, {**STRIP, "SRTPU_STRIP_RB": "4"}),
    "lane_pad": (False, PAD16),
    "lane_pad_compat": (True, PAD16),
    "lane_pad_unsupported": (False, {"SRTPU_LANE_PAD": "1",
                                     "SRTPU_LANE_PAD_TO": "18"}),
    "xla_cab": (False, {"SRTPU_XLA_CAB": "1"}),
    "strip_with_lane_pad": (False, {**STRIP, **PAD16}),
}


def _record(monkeypatch) -> list:
    """Record the port's HAB kernel calls: (name, C of x, c_real)."""
    calls = []
    for name in ("fused_cab_convs", "fused_hab_block", "strip_hab_block"):
        real = getattr(fused_hat, name)

        def rec(x, *a, _n=name, _r=real, **k):
            calls.append((_n, x.shape[-1], k.get("c_real",
                                                 a[4] if len(a) > 4
                                                 else None)))
            return _r(x, *a, **k)

        monkeypatch.setattr(fused_hat, name, rec)
    return calls


@pytest.mark.parametrize("lever", list(LEVERS))
def test_make_fused_hat_levers_match_jax(lever, monkeypatch):
    compat, env = LEVERS[lever]
    jm, variables, sd, tm = _hat(compat)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = _record(monkeypatch)
    x = np.random.default_rng(8).standard_normal((2, 12, 16, 1)).astype(
        np.float32)
    ref = jfused.make_fused_hat(variables, jm)(jnp.asarray(x))
    got = fused_hat.make_fused_hat(sd, tm, device="cpu")(torch.from_numpy(x))
    _close(got.numpy(), ref)
    n_hab = sum(KW["depths"])
    padded = lever in ("lane_pad", "lane_pad_compat", "strip_with_lane_pad")
    strip = lever in ("strip", "strip_rb4")
    cab = [] if lever == "xla_cab" else [
        ("fused_cab_convs", CP if padded else C, C if padded else None)]
    body = ([("strip_hab_block", C, None)] if strip else
            [("fused_hab_block", CP if padded else C, C if padded else None)])
    assert calls == (cab + body) * n_hab


@functools.lru_cache(maxsize=None)
def _hybrid():
    jm = JaxHybridSR(stage1=JaxRRDBNet(**S1),
                     stage2=JaxHATLite(**KW, upsample_feat=8),
                     output_size=32, smoothing="balanced")
    variables = jax_variables(jm, (1, 8, 8, 1), seed=9)
    sd = convert.hybrid_state_dict_from_jax(
        variables, num_blocks=1, features=16, growth=8, depths=KW["depths"])
    tm = HybridSR(RRDBNet(**S1, device="cpu"),
                  HATLite(**KW, upsample_feat=8, device="cpu"),
                  output_size=32, smoothing="balanced")
    return jm, variables, sd, tm


@pytest.mark.parametrize("lever", ["strip", "lane_pad"])
def test_fused_hybrid_model_levers_match_jax(lever, monkeypatch):
    for k, v in LEVERS[lever][1].items():
        monkeypatch.setenv(k, v)
    jm, variables, sd, tm = _hybrid()
    x = np.random.default_rng(10).random((2, 8, 8, 1), np.float32)
    ref = jfused.fused_hybrid_model(variables, jm).apply(None,
                                                         jnp.asarray(x))
    got = fused_hat.fused_hybrid_model(sd, tm, device="cpu")(
        torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 1)
    _close(got.numpy(), ref)
