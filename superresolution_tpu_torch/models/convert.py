"""Weight bridge: the JAX package's parameter trees (as numpy) -> this
port's state dicts: RRDBNet and EDSR BasicSR-keyed, HATLite HAT-keyed,
HybridSR as both stages, SRCNN, ESPCN, FSRCNN and the GAN discriminator
under the names their port modules give, and the perceptual loss's
VGG19 in torchvision's layout.

Counterpart of superresolution_tpu/models/convert.py:32-141,157-257,
300-425, with its own copies of _fuse_dense, _unfuse_dense and the tree
(un)stacking helpers (numpy only; the port imports nothing of the JAX
package). Every mapping is a transpose, slice or concat, so the bridge
is exact.

An RRDBNet tree comes in two layouts:
  * scan-stacked (scan_blocks=True): params['body']['RRDB_0'] holds
    FusedDenseBlock_{k} (or DenseBlock_{k}) leaves with a leading
    [num_blocks] axis;
  * plain (scan_blocks=False): params['body_blocks_{i}'] per block.
A HATLite tree comes in every layout superresolution_tpu/models/
hat_lite.py writes (hat_state_dict_from_jax reads them all).
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


def _put_conv(sd: dict, name: str, node: Mapping) -> None:
    """A JAX Conv module ({'Conv_0': {kernel HWIO, bias}}) -> OIHW."""
    sd[f"{name}.weight"] = np.ascontiguousarray(
        _hwio_to_oihw(np.asarray(node["Conv_0"]["kernel"])))
    sd[f"{name}.bias"] = np.asarray(node["Conv_0"]["bias"])


def _put_linear(sd: dict, name: str, node: Mapping) -> None:
    """A flax Dense ([in, out] kernel) -> a torch Linear ([out, in])."""
    sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
    sd[f"{name}.bias"] = np.asarray(node["bias"])


def _put_ln(sd: dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = np.asarray(node["scale"])
    sd[f"{name}.bias"] = np.asarray(node["bias"])


def _put_hab(sd: dict, pre: str, hb: Mapping) -> None:
    """One JAX HABlock subtree -> HAT's blocks.{i} keys."""
    _put_ln(sd, f"{pre}.norm1", hb["LayerNorm_0"])
    _put_ln(sd, f"{pre}.norm2", hb["LayerNorm_1"])
    wa = hb["WindowAttention_0"]
    _put_linear(sd, f"{pre}.attn.qkv", wa["Dense_0"])
    _put_linear(sd, f"{pre}.attn.proj", wa["Dense_1"])
    sd[f"{pre}.attn.relative_position_bias_table"] = np.asarray(
        wa["rel_pos_bias"])
    cab = hb["ChannelAttentionBlock_0"]
    _put_conv(sd, f"{pre}.conv_block.cab.0", cab["Conv_0"])
    _put_conv(sd, f"{pre}.conv_block.cab.2", cab["Conv_1"])
    for j, dense in ((1, "Dense_0"), (3, "Dense_1")):
        # squeeze-excite Dense [in, out] <-> 1x1 conv [out, in, 1, 1]
        sd[f"{pre}.conv_block.cab.3.attention.{j}.weight"] = \
            np.ascontiguousarray(np.asarray(cab[dense]["kernel"]).T
                                 [:, :, None, None])
        sd[f"{pre}.conv_block.cab.3.attention.{j}.bias"] = np.asarray(
            cab[dense]["bias"])
    _put_linear(sd, f"{pre}.mlp.fc1", hb["Dense_0"])
    _put_linear(sd, f"{pre}.mlp.fc2", hb["Dense_1"])


def _put_ocab(sd: dict, pre: str, oc: Mapping, use_rpb: bool) -> None:
    """One JAX OverlappingCrossAttention subtree -> HAT's overlap_attn
    keys; qkv packs the q dense (Dense_1) first, then kv (Dense_0)."""
    _put_ln(sd, f"{pre}.norm1", oc["LayerNorm_0"])
    _put_ln(sd, f"{pre}.norm2", oc["LayerNorm_1"])
    sd[f"{pre}.qkv.weight"] = np.ascontiguousarray(np.concatenate(
        [np.asarray(oc["Dense_1"]["kernel"]).T,
         np.asarray(oc["Dense_0"]["kernel"]).T], axis=0))
    sd[f"{pre}.qkv.bias"] = np.concatenate(
        [np.asarray(oc["Dense_1"]["bias"]), np.asarray(oc["Dense_0"]["bias"])])
    if use_rpb:
        sd[f"{pre}.relative_position_bias_table"] = np.asarray(
            oc["rel_pos_bias_oca"])
    _put_linear(sd, f"{pre}.proj", oc["Dense_2"])
    _put_linear(sd, f"{pre}.mlp.fc1", oc["Dense_3"])
    _put_linear(sd, f"{pre}.mlp.fc2", oc["Dense_4"])


def _hat_groups(p: Mapping, n_groups: int) -> list:
    """The ResidualGroup subtrees of a JAX HATLite tree, in order: the
    scan-stacked groups.ResidualGroup_0 (uniform groups, scan_blocks,
    more than one group) or one ResidualGroup_{i} per group."""
    if "groups" in p:
        return _unstack_trees(p["groups"]["ResidualGroup_0"], n_groups)
    return [p[f"ResidualGroup_{i}"] for i in range(n_groups)]


def _group_habs(grp: Mapping, depth: int) -> list:
    """One group's HABlock subtrees in block order: the scanned hab_pairs
    (HABlock_0 / HABlock_1 of each pair, a leading [pairs] axis) first,
    then the unscanned HABlock_{k}: an odd tail after the pairs, or every
    block of an unscanned group."""
    habs = []
    if "hab_pairs" in grp:
        for pair in _unstack_trees(grp["hab_pairs"], depth // 2):
            habs += [pair["HABlock_0"], pair["HABlock_1"]]
    k = 0
    while f"HABlock_{k}" in grp:
        habs.append(grp[f"HABlock_{k}"])
        k += 1
    if len(habs) != depth:
        raise ValueError(f"the tree's group holds {len(habs)} HAB blocks, "
                         f"depth {depth} expected")
    return habs


def hat_state_dict_from_jax(params: Mapping, *, depths: tuple[int, ...],
                            hat_compat: bool = False
                            ) -> dict[str, np.ndarray]:
    """JAX HATLite tree -> numpy state dict with the port's HATLite (HAT)
    keys. The layout is read from the tree's keys: scan-stacked or
    per-group ResidualGroups, each with scanned HAB pairs, an odd tail or
    unscanned blocks (_hat_groups, _group_habs). With hat_compat the keys
    are export_hybrid_numpy's stage2.* keys without the prefix."""
    p = params["params"] if "params" in params else params
    sd: dict[str, np.ndarray] = {}
    _put_conv(sd, "conv_first", p["Conv_0"])
    if hat_compat:
        _put_ln(sd, "patch_embed.norm", p["norm_embed"])
    for gi, grp in enumerate(_hat_groups(p, len(depths))):
        for i, hb in enumerate(_group_habs(grp, depths[gi])):
            _put_hab(sd, f"layers.{gi}.residual_group.blocks.{i}", hb)
        # under remat=True flax names the OCAB's module after nn.remat's
        # wrapper class
        oc = grp.get("OverlappingCrossAttention_0",
                     grp.get("CheckpointOverlappingCrossAttention_0"))
        _put_ocab(sd, f"layers.{gi}.overlap_attn", oc, hat_compat)
        _put_conv(sd, f"layers.{gi}.conv", grp["Conv_0"])
    if hat_compat:
        _put_ln(sd, "norm", p["norm_body"])
        _put_conv(sd, "conv_before_upsample.0", p["conv_before_upsample"])
    _put_conv(sd, "conv_after_body", p["Conv_1"])
    up = p["PixelShuffleUpsampler_0"]
    j = 0
    while f"Conv_{j}" in up:
        _put_conv(sd, f"upsample.{2 * j}", up[f"Conv_{j}"])
        j += 1
    _put_conv(sd, "conv_last", p["Conv_2"])
    return sd


def hybrid_state_dict_from_jax(params: Mapping, *, num_blocks: int,
                               features: int, growth: int,
                               depths: tuple[int, ...],
                               hat_compat: bool = False
                               ) -> dict[str, np.ndarray]:
    """JAX HybridSR(RRDBNet(pixelshuffle), HATLite) tree -> numpy state
    dict with stage1.* (BasicSR) and stage2.* (HAT) keys, the layout of
    the reference ecosystem's hybrid checkpoints."""
    p = params["params"] if "params" in params else params
    s1 = rrdbnet_state_dict_from_jax(p["stage1"], num_blocks=num_blocks,
                                     features=features, growth=growth)
    s2 = hat_state_dict_from_jax(p["stage2"], depths=depths,
                                 hat_compat=hat_compat)
    return {**{f"stage1.{k}": v for k, v in s1.items()},
            **{f"stage2.{k}": v for k, v in s2.items()}}


def edsr_state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX EDSR tree -> numpy state dict with the port's (BasicSR) EDSR
    keys. Reads both layouts: scan-stacked (res_blocks/ResBlock_0 with a
    leading [num_blocks] axis) and one ResBlock_{i} subtree per block."""
    p = params["params"] if "params" in params else params
    sd: dict[str, np.ndarray] = {}
    _put_conv(sd, "conv_first", p["Conv_0"])
    if "res_blocks" in p:
        stacked = p["res_blocks"]["ResBlock_0"]
        n = np.asarray(stacked["Conv_0"]["Conv_0"]["bias"]).shape[0]
        blocks = _unstack_trees(stacked, n)
    else:
        n = sum(1 for k in p if k.startswith("ResBlock_"))
        blocks = [p[f"ResBlock_{i}"] for i in range(n)]
    for i, blk in enumerate(blocks):
        _put_conv(sd, f"body.{i}.conv1", blk["Conv_0"])
        _put_conv(sd, f"body.{i}.conv2", blk["Conv_1"])
    _put_conv(sd, "conv_after_body", p["Conv_1"])
    up = p.get("PixelShuffleUpsampler_0", {})
    j = 0
    while f"Conv_{j}" in up:
        _put_conv(sd, f"upsample.{2 * j}", up[f"Conv_{j}"])
        j += 1
    _put_conv(sd, "conv_last", p["Conv_2"])
    return sd


def _plain_convs_state_dict(params: Mapping, names: tuple[str, ...]
                            ) -> dict[str, np.ndarray]:
    """Conv_{k} of a JAX tree -> the port's names[k]."""
    p = params["params"] if "params" in params else params
    sd: dict[str, np.ndarray] = {}
    for k, name in enumerate(names):
        _put_conv(sd, name, p[f"Conv_{k}"])
    return sd


def espcn_state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX ESPCN tree -> numpy state dict (conv1, conv2, conv3)."""
    return _plain_convs_state_dict(params, ("conv1", "conv2", "conv3"))


def srcnn_state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX SRCNN tree -> numpy state dict (conv1, conv2, conv3)."""
    return _plain_convs_state_dict(params, ("conv1", "conv2", "conv3"))


def fsrcnn_state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX FSRCNN tree -> numpy state dict: Conv_0..Conv_{m+3} and the
    PReLUs p_feat, p_shrink, p_map{i}, p_expand (one negative_slope each)
    -> conv_feat, conv_shrink, conv_map.{i}, conv_expand, conv_last and
    prelu_* ([1] weights)."""
    p = params["params"] if "params" in params else params
    m = sum(1 for k in p if k.startswith("p_map"))
    names = ("conv_feat", "conv_shrink",
             *(f"conv_map.{i}" for i in range(m)), "conv_expand", "conv_last")
    sd = _plain_convs_state_dict(p, names)
    for src, dst in (("p_feat", "prelu_feat"), ("p_shrink", "prelu_shrink"),
                     *((f"p_map{i}", f"prelu_map.{i}") for i in range(m)),
                     ("p_expand", "prelu_expand")):
        sd[f"{dst}.weight"] = np.asarray(
            p[src]["negative_slope"], np.float32).reshape(1)
    return sd


def discriminator_state_dict_from_jax(params: Mapping
                                     ) -> dict[str, np.ndarray]:
    """JAX VGGStyleDiscriminator tree -> numpy state dict: Conv_{i} ->
    blocks.{i}.conv (a bias on block 0 only), GroupNorm_{i-1} ->
    blocks.{i}.norm, Dense_0 / Dense_1 -> fc1 / fc2. The Dense kernels
    are a plain transpose: the port flattens in flax's NHWC order."""
    p = params["params"] if "params" in params else params
    n = sum(1 for k in p if k.startswith("Conv_"))
    sd: dict[str, np.ndarray] = {}
    for i in range(n):
        conv = p[f"Conv_{i}"]
        sd[f"blocks.{i}.conv.weight"] = np.ascontiguousarray(
            _hwio_to_oihw(np.asarray(conv["kernel"])))
        if "bias" in conv:
            sd[f"blocks.{i}.conv.bias"] = np.asarray(conv["bias"])
        if i:
            _put_ln(sd, f"blocks.{i}.norm", p[f"GroupNorm_{i - 1}"])
    _put_linear(sd, "fc1", p["Dense_0"])
    _put_linear(sd, "fc2", p["Dense_1"])
    return sd


def vgg19_npz_from_jax(params: Mapping, path: str | None = None
                       ) -> dict[str, np.ndarray]:
    """JAX VGG19Features tree (conv1_1 ...) -> torchvision's layout
    (features.N.weight OIHW, features.N.bias), the layout the port's
    SRTPU_VGG19_NPZ loader reads; written to `path` as an npz if given."""
    from superresolution_tpu_torch.losses.perceptual import TORCH_IDX

    p = params["params"] if "params" in params else params
    out: dict[str, np.ndarray] = {}
    for name, node in p.items():
        idx = TORCH_IDX[name]
        out[f"features.{idx}.weight"] = np.ascontiguousarray(
            _hwio_to_oihw(np.asarray(node["kernel"], np.float32)))
        out[f"features.{idx}.bias"] = np.asarray(node["bias"], np.float32)
    if path is not None:
        np.savez(path, **out)
    return out


def _count_upsample_convs(sd: Mapping, prefix: str) -> int:
    j = 0
    while f"{prefix}upsample.{2 * j}.weight" in sd:
        j += 1
    return j


def _upsample_scale(sd: Mapping, prefix: str) -> int:
    """Total scale of a HAT / BasicSR Upsample Sequential: each stage's
    factor is sqrt(out / in) of its conv (x3 is one conv at 9x)."""
    total = 1
    for j in range(_count_upsample_convs(sd, prefix)):
        w = np.asarray(sd[f"{prefix}upsample.{2 * j}.weight"])
        total *= int(round((w.shape[0] / w.shape[1]) ** 0.5))
    return total


def _max_index(sd: Mapping, prefix: str, pos: int) -> int:
    return 1 + max(int(k.split(".")[pos]) for k in sd
                   if k.startswith(prefix))


def _hat_config(sd: Mapping, pre: str) -> dict:
    """HATLite(hat_compat) kwargs read off a HAT state dict's shapes."""
    rpb = np.asarray(sd[f"{pre}layers.0.residual_group.blocks.0"
                        ".attn.relative_position_bias_table"])
    n_groups = _max_index(sd, f"{pre}layers.", pre.count(".") + 1)
    depth = _max_index(sd, f"{pre}layers.0.residual_group.blocks.",
                       pre.count(".") + 4)
    return {"embed_dim": np.asarray(sd[f"{pre}conv_first.weight"]).shape[0],
            "depths": (depth,) * n_groups,
            "num_heads": (rpb.shape[1],) * n_groups,
            "window_size": (int(round(rpb.shape[0] ** 0.5)) + 1) // 2,
            "hat_compat": True,
            "upsample_feat": np.asarray(
                sd[f"{pre}conv_before_upsample.0.weight"]).shape[0]}


def detect_reference_config(sd: Mapping) -> dict:
    """The model_config (utils.config.ModelConfig fields) of a
    reference-ecosystem state dict, read off its keys and shapes as
    superresolution_tpu/models/convert.py:428-527 reads them: the
    reference hybrid (stage1.* BasicSR RRDBNet x2 on a pixel-unshuffled
    input + stage2.* HAT), a bare HAT, or a BasicSR ESRGAN RRDBNet (scale
    4 // u for a conv_first of in * u^2 channels). The port's modules keep
    these key names, so the weights load as they are."""
    if any(k.startswith("stage1.") for k in sd):
        cf = np.asarray(sd["stage1.conv_first.weight"])
        kw = _hat_config(sd, "stage2.")
        return {
            "name": "rrdbnet", "scale": 2, "in_channels": cf.shape[1] // 4,
            "out_channels": np.asarray(
                sd["stage1.conv_last.weight"]).shape[0],
            "kwargs": {"features": cf.shape[0],
                       "num_blocks": _max_index(sd, "stage1.body.", 2),
                       "growth": np.asarray(
                           sd["stage1.body.0.rdb1.conv1.weight"]).shape[0],
                       "upsampler": "nearest_conv",
                       "pixel_unshuffle_input": 2},
            "refiner": "hat_lite",
            "refiner_kwargs": {"scale": _upsample_scale(sd, "stage2."),
                               **kw},
            "smoothing": "balanced"}
    if any(k.startswith("layers.") and ".residual_group." in k for k in sd):
        return {"name": "hat_lite", "scale": _upsample_scale(sd, ""),
                "in_channels": np.asarray(
                    sd["conv_first.weight"]).shape[1],
                "out_channels": np.asarray(sd["conv_last.weight"]).shape[0],
                "kwargs": _hat_config(sd, ""), "refiner": None,
                "refiner_kwargs": {}, "smoothing": None}
    cf = np.asarray(sd["conv_first.weight"])
    # in * u^2 -> (in, u): RGB and grayscale widths are unambiguous
    u = {12: 2, 48: 4, 4: 2, 16: 4}.get(cf.shape[1], 1)
    kwargs = {"features": cf.shape[0],
              "num_blocks": _max_index(sd, "body.", 1),
              "growth": np.asarray(sd["body.0.rdb1.conv1.weight"]).shape[0],
              "upsampler": "nearest_conv"}
    if u > 1:
        kwargs["pixel_unshuffle_input"] = u
    return {"name": "rrdbnet", "scale": 4 // u,
            "in_channels": cf.shape[1] // (u * u),
            "out_channels": np.asarray(sd["conv_last.weight"]).shape[0],
            "kwargs": kwargs, "refiner": None, "refiner_kwargs": {},
            "smoothing": None}


def to_torch(sd: Mapping[str, np.ndarray],
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """numpy state dict -> torch tensors (CPU) for load_state_dict."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in sd.items()}
