"""The port's deploy-time HAT and hybrid (superresolution_tpu_torch/
infer/fused_hat.py) against the JAX package's fused paths on the CPU,
where the kernels run their plain versions and the JAX kernels run in
interpret mode: f32, to 1e-4 of max |ref|, on each of the OCAB's three
attention paths (kernel 9, kernel 10, plain). Also the device rules of
the entry points and wrappers."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.infer import fused_hat as jfused
from superresolution_tpu.models import HATLite as JaxHATLite
from superresolution_tpu.models import HybridSR as JaxHybridSR
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu_torch.infer.fused_hat import (
    fused_hybrid_model,
    make_fused_hat,
)
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.models.hybrid import HybridSR
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.ops.flash_oca import flash_oca_gathered
from superresolution_tpu_torch.ops.hab import (
    fused_cab_convs,
    fused_hab_block,
)
from test_torch_hat_lite import KW, jax_variables

TOL = 1e-4
S1 = dict(scale=2, in_channels=1, out_channels=1, features=16, num_blocks=1,
          growth=8, upsampler="pixelshuffle")


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < tol, err


@functools.lru_cache(maxsize=None)
def _hat(compat, overlap=0.5):
    kw = dict(KW, hat_compat=compat, upsample_feat=8, overlap_ratio=overlap)
    jm = JaxHATLite(**kw)
    variables = jax_variables(jm, (2, 12, 16, 1), seed=int(compat))
    sd = convert.hat_state_dict_from_jax(variables, depths=KW["depths"],
                                         hat_compat=compat)
    return jm, variables, sd, HATLite(**kw, device="cpu")


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 16, 1), (1, 10, 13, 1)])
def test_make_fused_hat_matches_jax(compat, shape):
    jm, variables, sd, tm = _hat(compat)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = jfused.make_fused_hat(variables, jm)(jnp.asarray(x))
    got = make_fused_hat(sd, tm, device="cpu")(torch.from_numpy(x))
    _close(got.numpy(), ref)


def test_make_fused_hat_odd_overlap_matches_jax():
    """ows - ws odd (overlap 0.25 -> ows 5): the gathered kernel does not
    cover it; both take flash_window_attention (kernel 10, its plain form
    on the CPU)."""
    jm, variables, sd, tm = _hat(False, 0.25)
    x = np.random.default_rng(4).standard_normal((1, 12, 16, 1)).astype(
        np.float32)
    ref = jfused.make_fused_hat(variables, jm)(jnp.asarray(x))
    _close(make_fused_hat(sd, tm, device="cpu")(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("env", [{"SRTPU_GATHER_OCA": "0"},
                                 {"SRTPU_GATHER_OCA": ""},
                                 {"SRTPU_EINSUM_OCA": "1"}])
def test_make_fused_hat_oca_paths_match_jax(env, monkeypatch):
    """SRTPU_GATHER_OCA '0' or '' turns kernel 9 off for kernel 10 on
    the gathered windows; SRTPU_EINSUM_OCA takes the plain attention.
    The port reads the environment when it builds the stage, the
    reference at the call."""
    from superresolution_tpu_torch.infer import fused_hat

    jm, variables, sd, tm = _hat(True)
    x = np.random.default_rng(6).standard_normal((1, 12, 16, 1)).astype(
        np.float32)
    calls = []
    for name in ("flash_window_attention", "reference_window_attention"):
        real = getattr(fused_hat, name)
        monkeypatch.setattr(fused_hat, name, lambda *a, _n=name, _r=real,
                            **k: calls.append(_n) or _r(*a, **k))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    apply = make_fused_hat(sd, tm, device="cpu")
    ref = jfused.make_fused_hat(variables, jm)(jnp.asarray(x))
    _close(apply(torch.from_numpy(x)).numpy(), ref)
    path = ("reference_window_attention" if "SRTPU_EINSUM_OCA" in env
            else "flash_window_attention")
    assert calls == [path] * len(KW["depths"])


def test_fused_hybrid_model_matches_jax():
    jm = JaxHybridSR(stage1=JaxRRDBNet(**S1),
                     stage2=JaxHATLite(**KW, upsample_feat=8),
                     output_size=32, smoothing="balanced")
    variables = jax_variables(jm, (1, 8, 8, 1), seed=7)
    sd = convert.hybrid_state_dict_from_jax(
        variables, num_blocks=1, features=16, growth=8, depths=KW["depths"])
    tm = HybridSR(RRDBNet(**S1, device="cpu"),
                  HATLite(**KW, upsample_feat=8, device="cpu"),
                  output_size=32, smoothing="balanced")
    x = np.random.default_rng(5).random((2, 8, 8, 1), np.float32)
    ref = jfused.fused_hybrid_model(variables, jm).apply(None,
                                                         jnp.asarray(x))
    got = fused_hybrid_model(sd, tm, device="cpu")(torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 1)
    _close(got.numpy(), ref)
    with pytest.raises(ValueError, match="HATLite"):
        fused_hybrid_model(sd, HybridSR(tm.stage1, None), device="cpu")


def test_entry_points_need_a_gpu_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    _, _, sd, tm = _hat(False)
    hybrid = HybridSR(RRDBNet(**S1, device="cpu"),
                      HATLite(**KW, upsample_feat=8, device="cpu"),
                      output_size=32)
    hsd = hybrid.state_dict()
    entries = [
        lambda d: HATLite(**KW, device=d),
        lambda d: make_fused_hat(sd, tm, device=d),
        lambda d: fused_hybrid_model(hsd, hybrid, device=d),
    ]
    for entry in entries:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(None)
        entry("cpu")


def test_kernel_wrappers_raise_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is never taken for it."""
    m = torch.device("meta")

    def e(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, device=m, dtype=dtype)

    f32 = torch.float32
    cab = [e(96, dtype=f32), e(96, dtype=f32), e(3, 3, 96, 32),
           e(32, dtype=f32), e(3, 3, 32, 96), e(96, dtype=f32)]
    with pytest.raises(ValueError, match="CUDA"):
        fused_cab_convs(e(1, 8, 8, 96), cab)
    hw = {"ln1_s": e(96, dtype=f32), "ln1_b": e(96, dtype=f32),
          "wqkv": e(96, 288), "bqkv": e(288, dtype=f32),
          "rpb": e(6, 64, 64, dtype=f32), "wp": e(96, 96),
          "bp": e(96, dtype=f32), "ln2_s": e(96, dtype=f32),
          "ln2_b": e(96, dtype=f32), "w1": e(96, 192),
          "b1": e(192, dtype=f32), "w2": e(192, 96), "b2": e(96, dtype=f32)}
    with pytest.raises(ValueError, match="CUDA"):
        fused_hab_block(e(4, 64, 96), e(4, 64, 96), 6, hw)
    with pytest.raises(ValueError, match="takes"):
        fused_hab_block(e(4, 16, 12), e(4, 16, 12), 3, hw)
    with pytest.raises(ValueError, match="CUDA"):
        flash_oca_gathered(e(4, 64, 96), e(1, 20, 20, 96),
                           e(1, 20, 20, 96), e(6, 64, 144, dtype=f32), 6, 8,
                           12)
    with pytest.raises(ValueError, match="takes"):
        flash_oca_gathered(e(4, 64, 48), e(1, 20, 20, 48),
                           e(1, 20, 20, 48), e(3, 64, 144, dtype=f32), 3, 8,
                           12)
