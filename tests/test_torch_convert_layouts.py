"""The HATLite weight bridge (superresolution_tpu_torch/models/convert.py:
hat_state_dict_from_jax) on every tree layout the JAX HATLite writes
(superresolution_tpu/models/hat_lite.py): the scan-stacked groups with an
odd tail block, a single group, unscanned groups and blocks, and groups
of unequal depth; also load_params_for_inference on an exported npz of
such a tree. Each conversion carries every JAX leaf over exactly once
(the same multiset of values), loads strictly into the port's HATLite,
and that model is within 1e-5 of max |ref| of the JAX model.apply in f32
(the same arithmetic in another order)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.models import HATLite as JaxHATLite
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.train.checkpoint import (
    load_params_for_inference,
)
from test_torch_hat_lite import jax_variables

TOL = 1e-5
BASE = dict(scale=2, in_channels=1, out_channels=1, embed_dim=12,
            window_size=4, upsample_feat=8)
LAYOUTS = {
    # scanned groups, each a scanned HAB pair plus an odd tail HABlock_0
    "scan_odd_depth": dict(depths=(3, 3), num_heads=(3, 3)),
    # one group: ResidualGroup_0 unstacked, its pair scanned
    "one_group": dict(depths=(2,), num_heads=(3,)),
    # scan_blocks=False: ResidualGroup_{i} of HABlock_{k}
    "unscanned": dict(depths=(2, 2), num_heads=(3, 3), scan_blocks=False),
    # unequal groups: per-group trees, depth 1 has no pair at all
    "ragged_groups": dict(depths=(1, 3), num_heads=(3, 3)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _tree(layout: str, remat: bool = False):
    kw = dict(BASE, **LAYOUTS[layout], remat=remat)
    jm = JaxHATLite(**kw)
    return jm, jax_variables(jm, (1, 8, 8, 1), seed=len(layout))


def _values(arrays) -> np.ndarray:
    return np.sort(np.concatenate([np.asarray(a, np.float32).ravel()
                                   for a in arrays]))


def _port_model(layout: str, sd) -> HATLite:
    kw = dict(BASE, **LAYOUTS[layout])
    tm = HATLite(**kw, device="cpu")
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    return tm.eval()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_layout_converts_and_matches_jax_apply(layout):
    jm, variables = _tree(layout)
    p = variables["params"]
    if layout == "scan_odd_depth":
        grp = p["groups"]["ResidualGroup_0"]
        assert "hab_pairs" in grp and "HABlock_0" in grp
    elif layout == "unscanned":
        assert "HABlock_1" in p["ResidualGroup_1"]
    else:
        assert "ResidualGroup_0" in p and "groups" not in p
    sd = convert.hat_state_dict_from_jax(variables,
                                         depths=LAYOUTS[layout]["depths"])
    # every leaf once: no OCA rel-pos table without hat_compat
    leaves = [a for path, a in jax.tree_util.tree_leaves_with_path(p)
              if getattr(path[-1], "key", "") != "rel_pos_bias_oca"]
    np.testing.assert_array_equal(_values(sd.values()), _values(leaves))
    tm = _port_model(layout, sd)
    x = np.random.default_rng(7).standard_normal((1, 8, 8, 1)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 16, 16, 1)
    err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    assert err < TOL, err


def test_scanned_and_unscanned_trees_give_one_state_dict():
    """The scanned (2, 2) tree laid out by hand as the unscanned model's
    ResidualGroup_{i} / HABlock_{k} tree (its structure checked against
    that model's own init) converts to the same state dict."""
    jm = JaxHATLite(**BASE, depths=(2, 2), num_heads=(3, 3))
    scanned = jax_variables(jm, (1, 8, 8, 1), seed=3)["params"]
    grps = scanned["groups"]["ResidualGroup_0"]
    plain = {k: v for k, v in scanned.items() if k != "groups"}
    for i in range(2):
        g = jax.tree_util.tree_map(lambda a, i=i: np.asarray(a)[i], grps)
        pair = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                      g.pop("hab_pairs"))
        plain[f"ResidualGroup_{i}"] = {**g, **pair}
    unscanned = JaxHATLite(**BASE, depths=(2, 2), num_heads=(3, 3),
                           scan_blocks=False)
    want = jax.eval_shape(unscanned.init, jax.random.key(0),
                          jnp.zeros((1, 8, 8, 1)))["params"]
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(plain))
    a = convert.hat_state_dict_from_jax(scanned, depths=(2, 2))
    b = convert.hat_state_dict_from_jax(plain, depths=(2, 2))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_remat_tree_names_its_ocab_after_the_wrapper():
    """remat=True renames the OCAB CheckpointOverlappingCrossAttention_0;
    the odd-depth scanned tree still converts to the same weights."""
    _, variables = _tree("scan_odd_depth", remat=True)
    assert "CheckpointOverlappingCrossAttention_0" in (
        variables["params"]["groups"]["ResidualGroup_0"])
    sd = convert.hat_state_dict_from_jax(variables, depths=(3, 3))
    _port_model("scan_odd_depth", sd)


@pytest.mark.parametrize("layout", ["scan_odd_depth", "unscanned"])
def test_load_params_for_inference_reads_an_exported_npz(layout, tmp_path):
    """A params.npz of the tree ('/'-joined keys) and its model_config
    load through the port's inference loader as the bridge converts."""
    _, variables = _tree(layout)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(
                variables["params"])}
    np.savez(tmp_path / "params.npz", **flat)
    kwargs = {k: (list(v) if isinstance(v, tuple) else v)
              for k, v in dict(BASE, **LAYOUTS[layout]).items()
              if k not in ("scale", "in_channels", "out_channels")}
    (tmp_path / "model_config.json").write_text(json.dumps(
        {"name": "hat_lite", "scale": 2, "in_channels": 1,
         "out_channels": 1, "kwargs": kwargs}))
    sd = load_params_for_inference(str(tmp_path), device="cpu")
    want = convert.hat_state_dict_from_jax(variables,
                                           depths=LAYOUTS[layout]["depths"])
    assert sd.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
