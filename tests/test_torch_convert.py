"""The port's weight bridge (superresolution_tpu_torch/models/convert.py):
JAX RRDBNet trees, scan-stacked or plain, fused or plain dense blocks ->
the BasicSR-keyed state dict the port's RRDBNet loads with strict=True.
Every mapping is a transpose, slice or concat, so equality is exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.models import convert as jconvert
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.rrdbnet import RRDBNet

KW = dict(scale=4, in_channels=3, out_channels=3, features=16, num_blocks=2,
          growth=8, upsampler="pixelshuffle")


def _scan_tree(seed=0):
    model = JaxRRDBNet(**KW)
    return model.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))


def _sd(tree):
    return convert.rrdbnet_state_dict_from_jax(tree, num_blocks=2,
                                               features=16, growth=8)


def _assert_sd_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_fuse_unfuse_round_trip_and_match_jax():
    rng = np.random.default_rng(0)
    c, g = 16, 8
    ks = [rng.standard_normal((3, 3, c + j * g, g if j < 4 else c))
          .astype(np.float32) for j in range(5)]
    bs = [rng.standard_normal(g if j < 4 else c).astype(np.float32)
          for j in range(5)]
    fused = convert._fuse_dense(ks, bs, c, g)
    jfused = jconvert._fuse_dense(ks, bs, c, g)
    for leaf in ("proj_y1", "proj_y2", "proj_y3", "proj_y4"):
        np.testing.assert_array_equal(fused[leaf]["kernel"],
                                      jfused[leaf]["kernel"])
    ks2, bs2 = convert._unfuse_dense(fused, c, g)
    jks, jbs = jconvert._unfuse_dense(jfused, c, g)
    for j in range(5):
        np.testing.assert_array_equal(ks2[j], ks[j])
        np.testing.assert_array_equal(bs2[j], bs[j])
        np.testing.assert_array_equal(ks2[j], jks[j])
        np.testing.assert_array_equal(bs2[j], jbs[j])


def test_scan_stacked_and_plain_trees_give_one_state_dict():
    tree = _scan_tree()
    sd = _sd(tree)
    # the same weights re-laid out by the JAX package as a plain
    # (per-block) tree, fused and unfused
    for fused in (True, False):
        plain = jconvert.import_rrdbnet_numpy(
            sd, num_blocks=2, features=16, growth=8, scan_blocks=False,
            fused_dense=fused)
        _assert_sd_equal(_sd(plain), sd)
    # and the JAX package's own export of the plain unfused tree
    plain = jconvert.import_rrdbnet_numpy(
        sd, num_blocks=2, features=16, growth=8, scan_blocks=False,
        fused_dense=False)
    _assert_sd_equal(jconvert.export_rrdbnet_numpy(
        plain, num_blocks=2, features=16, growth=8), sd)


def test_unstack_trees_splits_leading_axis():
    tree = {"a": {"k": np.arange(6).reshape(3, 2)}, "b": np.arange(3)}
    parts = convert._unstack_trees(tree, 3)
    assert len(parts) == 3
    np.testing.assert_array_equal(parts[1]["a"]["k"], [2, 3])
    assert parts[2]["b"] == 2


def test_state_dict_loads_strict_into_port_model():
    sd = _sd(_scan_tree(1))
    model = RRDBNet(**KW, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == sd[k].shape, k
    model.load_state_dict(convert.to_torch(sd), strict=True)
    np.testing.assert_array_equal(
        model.conv_last.weight.detach().numpy(), sd["conv_last.weight"])


def test_state_dict_is_oihw():
    tree = _scan_tree(2)
    sd = _sd(tree)
    k = np.asarray(tree["params"]["conv_first"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(sd["conv_first.weight"],
                                  k.transpose(3, 2, 0, 1))
    with pytest.raises(KeyError):
        convert.rrdbnet_state_dict_from_jax({"params": {}}, num_blocks=1,
                                            features=16, growth=8)


# ---- HATLite / HybridSR ----------------------------------------------------

HAT_KW = dict(scale=2, in_channels=3, out_channels=3, embed_dim=12,
              depths=(2, 2), num_heads=(3, 3), window_size=4,
              upsample_feat=8)
# the keys only hat_compat models carry
COMPAT_ONLY = ("patch_embed.norm.", "norm.", "conv_before_upsample.0.")


@functools.lru_cache(maxsize=None)
def _hybrid_tree(compat, seed=0):
    from superresolution_tpu.models import HATLite as JaxHATLite
    from superresolution_tpu.models import HybridSR as JaxHybridSR

    model = JaxHybridSR(
        stage1=JaxRRDBNet(**KW), stage2=JaxHATLite(**HAT_KW,
                                                   hat_compat=compat))
    return jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))


def _hybrid_sd(tree, compat):
    return convert.hybrid_state_dict_from_jax(
        tree, num_blocks=2, features=16, growth=8, depths=(2, 2),
        hat_compat=compat)


def test_hybrid_state_dict_equals_jax_export():
    """hat_compat: the keys and values of the JAX package's own export
    (export_hybrid_numpy), stage 1 and stage 2."""
    tree = _hybrid_tree(True)
    ref = jconvert.export_hybrid_numpy(tree, num_blocks=2, features=16,
                                       growth=8, embed_dim=12, depths=(2, 2))
    _assert_sd_equal(_hybrid_sd(tree, True), ref)


def test_hat_state_dict_without_compat_drops_compat_keys():
    tree = _hybrid_tree(False)
    sd = _hybrid_sd(tree, False)
    ref = jconvert.export_hybrid_numpy(
        _hybrid_tree(True), num_blocks=2, features=16, growth=8,
        embed_dim=12, depths=(2, 2))
    want = {k for k in ref
            if not k.startswith(tuple(f"stage2.{p}" for p in COMPAT_ONLY))
            and not k.endswith("overlap_attn.relative_position_bias_table")}
    assert set(sd) == want
    # and they load strictly into the port's models
    from superresolution_tpu_torch.models.hat_lite import HATLite

    for compat, tree_ in ((False, tree), (True, _hybrid_tree(True))):
        s2 = convert.hat_state_dict_from_jax(
            tree_["params"]["stage2"], depths=(2, 2), hat_compat=compat)
        HATLite(**HAT_KW, hat_compat=compat, device="cpu").load_state_dict(
            convert.to_torch(s2), strict=True)


def test_hat_state_dict_rejects_odd_depths():
    """Odd depths convert now (tests/test_torch_convert_layouts.py); a
    depth the tree's groups do not hold is still rejected."""
    tree = _hybrid_tree(False)["params"]["stage2"]
    with pytest.raises(ValueError, match="HAB blocks"):
        convert.hat_state_dict_from_jax(tree, depths=(3, 3))
