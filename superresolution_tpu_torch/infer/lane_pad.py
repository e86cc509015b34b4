"""Pad-to-full-lane deploy transform for the fused HAT stage.

Counterpart of superresolution_tpu/infer/lane_pad.py, over the port's
HAT-keyed state dict (models/hat_lite.py) in place of the flax tree.
Under SRTPU_LANE_PAD (infer/fused_hat.make_fused_hat) the whole HAT stage
computes at c_pad channels (128 by default, SRTPU_LANE_PAD_TO otherwise)
while remaining exactly the C-channel model:

  * every dense and conv gains zero input rows and zero output columns,
    so the lanes past C of every activation stay zero (zero filters in,
    zero contributions out);
  * packed projections are padded section by section: the HAB's
    attn.qkv and the OCAB's qkv, both q | k | v here (the reference's
    OCAB keeps q in Dense_1 and k | v in Dense_0), so each section starts
    at a multiple of c_pad;
  * heads go from nh to c_pad // head_dim with zero rel-pos-bias columns
    in both tables: a pad head attends uniformly over zero values and
    adds zero;
  * LayerNorm scale and bias gain zero lanes, and the LNs divide their
    sums by the real C (c_real in ops/hab.layer_norm and kernels 7, 8);
  * the first conv that reads the body's output leaves the padded space:
    conv_before_upsample.0 under hat_compat, else the first upsample conv
    (conv_last at scale 1), padded on its input rows only.

The MLP hidden widths stay (192 at embed 96). The reference pads because
96-lane tensors move at ~75% of the 128-lane rate on its chip; on the
card the pad makes kernels 7-9 run at C 128 with 8 heads.
"""

from __future__ import annotations

from typing import Mapping

import torch

from superresolution_tpu_torch.models.common import pixel_shuffle_stages

__all__ = ["lane_pad_supported", "pad_hat_params"]


def _pad(t: torch.Tensor, dim: int, to: int) -> torch.Tensor:
    """t zero-padded at the end of `dim` to length `to`."""
    cur = t.shape[dim]
    if cur > to:
        raise ValueError(f"cannot pad dim {cur} down to {to}")
    if cur == to:
        return t
    shape = list(t.shape)
    shape[dim] = to - cur
    return torch.cat([t, t.new_zeros(shape)], dim)


def lane_pad_supported(c: int, nh: int, c_pad: int = 128) -> bool:
    """True when the pad to c_pad applies: an embed below c_pad whose head
    dim divides c_pad (the pad heads must tile it exactly)."""
    return c < c_pad and c % nh == 0 and c_pad % (c // nh) == 0


def pad_hat_params(params: Mapping, model, c_pad: int = 128
                   ) -> tuple[dict[str, torch.Tensor], int]:
    """HAT-keyed state dict of `model` (the port's HATLite, uniform heads)
    -> (the zero-padded state dict computing at c_pad channels, the
    padded head count). Values may be tensors or numpy arrays; the result
    holds tensors, each on its input's device. Raises ValueError where
    lane_pad_supported does not hold."""
    p = {k: v if isinstance(v, torch.Tensor) else torch.tensor(v)
         for k, v in params.items()}
    c = p["conv_first.weight"].shape[0]
    nh = model.num_heads[0]
    if len(set(model.num_heads)) != 1 or not lane_pad_supported(c, nh,
                                                                c_pad):
        raise ValueError(f"lane pad unsupported: C={c}, heads "
                         f"{model.num_heads}, c_pad={c_pad}")
    nhp = c_pad // (c // nh)
    out = dict(p)

    def lin(name, c_in=False, c_out=False):
        """A Linear [out, in] or conv [out, in, kh, kw] and its bias."""
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        if c_in:
            w = _pad(w, 1, c_pad)
        if c_out:
            w, b = _pad(w, 0, c_pad), _pad(b, 0, c_pad)
        out[f"{name}.weight"], out[f"{name}.bias"] = w, b

    def ln(name):
        for k in ("weight", "bias"):
            out[f"{name}.{k}"] = _pad(p[f"{name}.{k}"], 0, c_pad)

    def qkv(name):
        """q | k | v, each section padded to c_pad rows, then the input
        columns."""
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        if w.shape[0] != 3 * c:
            raise ValueError(f"packed {name}: {w.shape[0]} != 3*{c}")
        out[f"{name}.weight"] = _pad(torch.cat(
            [_pad(s, 0, c_pad) for s in w.split(c, 0)], 0), 1, c_pad)
        out[f"{name}.bias"] = torch.cat(
            [_pad(s, 0, c_pad) for s in b.split(c, 0)], 0)

    def table(name):
        out[name] = _pad(p[name], 1, nhp)

    lin("conv_first", c_out=True)
    lin("conv_after_body", c_in=True, c_out=True)
    if model.hat_compat:
        ln("patch_embed.norm")
        ln("norm")
        lin("conv_before_upsample.0", c_in=True)
    elif pixel_shuffle_stages(model.scale):
        lin("upsample.0", c_in=True)
    else:
        lin("conv_last", c_in=True)
    for g, depth in enumerate(model.depths):
        for i in range(depth):
            pre = f"layers.{g}.residual_group.blocks.{i}"
            ln(f"{pre}.norm1")
            ln(f"{pre}.norm2")
            qkv(f"{pre}.attn.qkv")
            lin(f"{pre}.attn.proj", c_in=True, c_out=True)
            table(f"{pre}.attn.relative_position_bias_table")
            lin(f"{pre}.mlp.fc1", c_in=True)
            lin(f"{pre}.mlp.fc2", c_out=True)
            lin(f"{pre}.conv_block.cab.0", c_in=True)
            lin(f"{pre}.conv_block.cab.2", c_out=True)
            # the SE tail: a pad lane's scale is sigmoid(0) = 0.5 on a
            # zero activation
            lin(f"{pre}.conv_block.cab.3.attention.1", c_in=True)
            lin(f"{pre}.conv_block.cab.3.attention.3", c_out=True)
        pre = f"layers.{g}.overlap_attn"
        ln(f"{pre}.norm1")
        ln(f"{pre}.norm2")
        qkv(f"{pre}.qkv")
        lin(f"{pre}.proj", c_in=True, c_out=True)
        lin(f"{pre}.mlp.fc1", c_in=True)
        lin(f"{pre}.mlp.fc2", c_out=True)
        if f"{pre}.relative_position_bias_table" in p:
            table(f"{pre}.relative_position_bias_table")
        lin(f"layers.{g}.conv", c_in=True, c_out=True)
    return out, nhp
