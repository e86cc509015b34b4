"""The port's deploy-time HAT (superresolution_tpu_torch/infer/fused_hat.py:
make_fused_hat) and its flash HATLite at the reference's other
geometries, on the CPU where kernels 7-10 run their plain versions,
against the JAX HATLite.apply on its einsum path (flash_oca=False), in
f32 to 1e-4 of max |ref| (the reference's own fused-vs-apply bar is
2e-4 relative; here the same f32 arithmetic in another order):
  * window 16 (embed 12, 3 heads: tests/test_fused_hat.py:230), where
    the OCAB (ows 24) takes kernel 9;
  * the hybrid_astro_h200 shape class: window 16 and head dim 20;
  * window 8 at overlap 0.25 (ows 10), where kernel 9 covers the even
    overlap."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.models import HATLite as JaxHATLite
from superresolution_tpu_torch.infer.fused_hat import make_fused_hat
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.ops.flash_oca import oca_gather_supported
from test_torch_hat_lite import jax_variables

TOL = 1e-4
GEOMS = {
    "ws16": (dict(embed_dim=12, depths=(2, 2), num_heads=(3, 3),
                  window_size=16), (1, 32, 32, 1)),
    "h200_head_dim_20": (dict(embed_dim=40, depths=(2,), num_heads=(2,),
                              window_size=16), (1, 32, 32, 1)),
    "ws8_ows10": (dict(embed_dim=12, depths=(2,), num_heads=(3,),
                       window_size=8, overlap_ratio=0.25), (1, 16, 24, 1)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(name):
    kw, shape = GEOMS[name]
    kw = dict(kw, scale=2, in_channels=1, out_channels=1, upsample_feat=8)
    jm = JaxHATLite(**kw, flash_oca=False)
    variables = jax_variables(jm, shape, seed=len(name))
    sd = convert.hat_state_dict_from_jax(variables, depths=kw["depths"])
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    return kw, sd, x, ref


def _rel(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_make_fused_hat_matches_jax_apply(name):
    kw, sd, x, ref = _case(name)
    ws = kw["window_size"]
    ows = int(ws * (1 + kw.get("overlap_ratio", 0.5)))
    # every case takes kernel 9 for its OCAB (the gathered form)
    assert oca_gather_supported(ws, ows, *x.shape[1:3])
    tm = HATLite(**kw, device="cpu")
    got = make_fused_hat(sd, tm, device="cpu")(torch.from_numpy(x))
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_flash_hat_lite_matches_jax_apply(name):
    """HATLite(flash_attn=True): every window attention and OCAB through
    kernel 10's wrapper (n 256 / m 576 at window 16)."""
    kw, sd, x, ref = _case(name)
    tm = HATLite(**kw, flash_attn=True, device="cpu")
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert _rel(got, ref) < TOL
