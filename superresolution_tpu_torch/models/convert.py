"""Weight bridge: the JAX package's RRDBNet parameter tree (as numpy) ->
this port's BasicSR-keyed state dict.

Counterpart of superresolution_tpu/models/convert.py:32-141,300-328,
with its own copies of _fuse_dense, _unfuse_dense and the tree
(un)stacking helpers (numpy only; the port imports nothing of the JAX
package). Every mapping is a transpose, slice or concat, so the bridge
is exact.

The JAX tree comes in two layouts:
  * scan-stacked (scan_blocks=True): params['body']['RRDB_0'] holds
    FusedDenseBlock_{k} (or DenseBlock_{k}) leaves with a leading
    [num_blocks] axis;
  * plain (scan_blocks=False): params['body_blocks_{i}'] per block.
Its kernels are HWIO; the state dict's are OIHW.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def _fuse_dense(ks: list[np.ndarray], bs: list[np.ndarray], c: int, g: int):
    """The 5 plain dense-block convs (HWIO) -> the FusedDenseBlock
    projection layout (models/rrdbnet.py)."""

    def seg(k, j):
        lo = c + (j - 1) * g if j else 0
        hi = lo + (g if j else c)
        return k[:, :, lo:hi, :]

    return {
        "Conv_0": {"Conv_0": {
            "kernel": np.concatenate([seg(ks[i], 0) for i in range(5)], -1),
            "bias": np.concatenate(bs, -1)}},
        "proj_y1": {"kernel": np.concatenate(
            [seg(ks[i], 1) for i in range(1, 5)], -1)},
        "proj_y2": {"kernel": np.concatenate(
            [seg(ks[i], 2) for i in range(2, 5)], -1)},
        "proj_y3": {"kernel": np.concatenate(
            [seg(ks[i], 3) for i in range(3, 5)], -1)},
        "proj_y4": {"kernel": seg(ks[4], 4)},
    }


def _unfuse_dense(fd: Mapping, c: int, g: int):
    """Inverse of _fuse_dense: FusedDenseBlock params -> the 5 plain
    dense-block (kernel HWIO, bias) lists."""
    px = np.asarray(fd["Conv_0"]["Conv_0"]["kernel"])
    pb = np.asarray(fd["Conv_0"]["Conv_0"]["bias"])
    p1 = np.asarray(fd["proj_y1"]["kernel"])
    p2 = np.asarray(fd["proj_y2"]["kernel"])
    p3 = np.asarray(fd["proj_y3"]["kernel"])
    p4 = np.asarray(fd["proj_y4"]["kernel"])
    ks = [
        px[..., 0:g],
        np.concatenate([px[..., g:2 * g], p1[..., 0:g]], axis=2),
        np.concatenate([px[..., 2 * g:3 * g], p1[..., g:2 * g],
                        p2[..., 0:g]], axis=2),
        np.concatenate([px[..., 3 * g:4 * g], p1[..., 2 * g:3 * g],
                        p2[..., g:2 * g], p3[..., 0:g]], axis=2),
        np.concatenate([px[..., 4 * g:], p1[..., 3 * g:], p2[..., 2 * g:],
                        p3[..., g:], p4], axis=2),
    ]
    bs = [pb[0:g], pb[g:2 * g], pb[2 * g:3 * g], pb[3 * g:4 * g], pb[4 * g:]]
    return ks, bs


def _unstack_trees(tree, n: int) -> list:
    """Split a scan-stacked tree's leading axis into n trees."""
    if isinstance(tree, Mapping):
        subs = {k: _unstack_trees(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in tree} for i in range(n)]
    return [np.asarray(tree)[i] for i in range(n)]


def _dense_convs(blk: Mapping, k: int, c: int, g: int):
    """(kernels HWIO, biases) of dense block k of one RRDB subtree."""
    if f"FusedDenseBlock_{k}" in blk:
        return _unfuse_dense(blk[f"FusedDenseBlock_{k}"], c, g)
    db = blk[f"DenseBlock_{k}"]
    return ([np.asarray(db[f"Conv_{j}"]["Conv_0"]["kernel"])
             for j in range(5)],
            [np.asarray(db[f"Conv_{j}"]["Conv_0"]["bias"])
             for j in range(5)])


def rrdbnet_state_dict_from_jax(params: Mapping, *, num_blocks: int,
                                features: int, growth: int
                                ) -> dict[str, np.ndarray]:
    """JAX RRDBNet(upsampler='pixelshuffle') tree -> numpy state dict
    (OIHW) with the port's RRDBNet keys. Accepts {'params': ...} or the
    bare tree, scan-stacked or plain, fused or plain dense blocks."""
    p = params["params"] if "params" in params else params
    c, g = features, growth
    sd: dict[str, np.ndarray] = {}

    def put(name, node):
        sd[f"{name}.weight"] = np.ascontiguousarray(
            _hwio_to_oihw(np.asarray(node["kernel"])))
        sd[f"{name}.bias"] = np.asarray(node["bias"])

    put("conv_first", p["conv_first"]["Conv_0"])
    if "body" in p:
        blocks = _unstack_trees(p["body"]["RRDB_0"], num_blocks)
    else:
        blocks = [p[f"body_blocks_{i}"] for i in range(num_blocks)]
    for i, blk in enumerate(blocks):
        for k in range(3):
            ks, bs = _dense_convs(blk, k, c, g)
            for j in range(5):
                put(f"body.{i}.rdb{k + 1}.conv{j + 1}",
                    {"kernel": ks[j], "bias": bs[j]})
    put("conv_body", p["trunk_conv"]["Conv_0"])
    n = 0
    while f"Conv_{n}" in p["up"]:
        put(f"conv_up{n + 1}", p["up"][f"Conv_{n}"]["Conv_0"])
        n += 1
    put("conv_hr", p["conv_hr"]["Conv_0"])
    put("conv_last", p["conv_last"]["Conv_0"])
    return sd


def to_torch(sd: Mapping[str, np.ndarray],
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """numpy state dict -> torch tensors (CPU) for load_state_dict."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in sd.items()}
