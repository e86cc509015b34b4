"""The port's VGG19 perceptual loss (superresolution_tpu_torch/losses/
perceptual.py) and the CombinedLoss terms that use it, against the JAX
package on the CPU.

The weights are JAX's own init of its VGG19Features, written by
models/convert.vgg19_npz_from_jax in torchvision's layout and loaded by
both packages through SRTPU_VGG19_NPZ (monkeypatched, with both
packages' network caches cleared around each test). Features and
perceptual_loss within 1e-5 relative, its gradient against jax.grad;
zero for identical inputs; has_pretrained_vgg with and without the npz;
CombinedLoss with hybrid_astro_prod's and esrgan_gan's terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.losses import perceptual as jperc
from superresolution_tpu.losses.combined import CombinedLoss as JaxLoss
from superresolution_tpu.utils import config as jcfg
from superresolution_tpu_torch.losses import perceptual as tperc
from superresolution_tpu_torch.losses.combined import CombinedLoss
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.utils import config as tcfg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These CPU tensors are small: intra-op threads gain nothing, and on
    a host loaded by parallel test workers their spin-waits cost several
    times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_npz(monkeypatch):
    monkeypatch.delenv("SRTPU_VGG19_NPZ", raising=False)
    jperc._load_cached.cache_clear()
    tperc._load_cached.cache_clear()
    yield
    jperc._load_cached.cache_clear()
    tperc._load_cached.cache_clear()


@pytest.fixture
def jax_vgg_npz(tmp_path, no_npz, monkeypatch):
    """JAX's random VGG19 (to conv5_4) as an npz both packages load."""
    _, params, pretrained = jperc._load_cached("conv5_4", True)
    assert not pretrained
    path = str(tmp_path / "vgg19.npz")
    convert.vgg19_npz_from_jax(jax.tree.map(np.asarray, params), path)
    monkeypatch.setenv("SRTPU_VGG19_NPZ", path)
    jperc._load_cached.cache_clear()
    tperc._load_cached.cache_clear()
    return path


def _img(c, seed, n=2, s=32):
    return np.random.default_rng(seed).random((n, s, s, c),
                                              dtype=np.float32) * 1.2 - 0.1


TAPS = [("relu3_4", False), ("conv5_4", True)]


@pytest.mark.parametrize("tap,pre", TAPS)
@pytest.mark.parametrize("c", [1, 3])
def test_features_match_jax(jax_vgg_npz, tap, pre, c):
    x = _img(c, 1)
    jm, jp, _ = jperc._load_cached(tap, pre)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    net = tperc.vgg19_features(tap, pre, "cpu")
    got = net(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    if not pre:
        assert got.min() >= 0.0  # post-ReLU
    else:
        assert got.min() < 0.0  # the tap before its ReLU


@pytest.mark.parametrize("tap,pre", TAPS)
@pytest.mark.parametrize("c", [1, 3])
def test_perceptual_loss_and_grad_match_jax(jax_vgg_npz, tap, pre, c):
    p, t = _img(c, 2), _img(c, 3)
    jv, jg = jax.value_and_grad(
        lambda a: jperc.perceptual_loss(a, jnp.asarray(t), tap, pre))(
        jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    tv = tperc.perceptual_loss(tp, tt, tap, pre)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tp.grad.numpy(), jg,
                               atol=1e-5 * np.abs(jg).max())
    assert tt.grad is None or float(tt.grad.abs().max()) == 0.0


def test_perceptual_loss_is_zero_for_identical_inputs(no_npz):
    x = torch.from_numpy(_img(3, 4))
    assert float(tperc.perceptual_loss(x, x.clone())) == 0.0


def test_has_pretrained_vgg(jax_vgg_npz, monkeypatch):
    assert tperc.has_pretrained_vgg()
    assert jperc.has_pretrained_vgg()
    monkeypatch.delenv("SRTPU_VGG19_NPZ")
    tperc._load_cached.cache_clear()
    jperc._load_cached.cache_clear()
    assert not tperc.has_pretrained_vgg()
    assert not jperc.has_pretrained_vgg()


def test_network_is_frozen_cached_and_laid_out_as_torchvision(no_npz):
    net = tperc.vgg19_features("relu3_4", False, "cpu")
    assert net is tperc.vgg19_features("relu3_4", False, torch.device("cpu"))
    assert not any(p.requires_grad for p in net.parameters())
    # torchvision's vgg19.features[:18]: 8 convs, ReLUs, two pools
    assert len(net.features) == 18
    keys = [k for k in net.state_dict() if k.endswith(".weight")]
    assert keys[0] == "features.0.weight" and keys[-1] == "features.16.weight"
    assert len(tperc.vgg19_features("conv5_4", True, "cpu").features) == 35
    with pytest.raises(ValueError, match="unknown tap"):
        tperc.VGG19Features("relu6_1")


def test_random_init_is_the_ports_fixed_seed_draw(no_npz):
    """No npz: lecun-normal kernels from torch.Generator().manual_seed(0)
    and zero biases, the same every build (its values are the port's
    own, not JAX's key(0) draw)."""
    a = tperc.VGG19Features("relu3_4",
                            generator=torch.Generator().manual_seed(0))
    net = tperc.vgg19_features("relu3_4", False, "cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    w = net.features[2].weight
    fan_in = 64 * 9
    assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert float(net.features[2].bias.abs().max()) == 0.0


@pytest.mark.parametrize("preset", ["hybrid_astro_prod", "esrgan_gan"])
def test_combined_loss_matches_jax(jax_vgg_npz, preset):
    c = tcfg.get_preset(preset).model.out_channels
    p, t = _img(c, 5, s=32), np.clip(_img(c, 6, s=32), 0, 1)
    jv, jlogs = JaxLoss(jcfg.get_preset(preset).loss)(jnp.asarray(p),
                                                      jnp.asarray(t))
    tv, tlogs = CombinedLoss(tcfg.get_preset(preset).loss)(
        torch.from_numpy(p), torch.from_numpy(t))
    assert sorted(tlogs) == sorted(jlogs)
    assert "perceptual" in tlogs
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)
