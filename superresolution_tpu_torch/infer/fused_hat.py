"""Deploy-time HATLite and HybridSR through the hand-written kernels.

Counterpart of superresolution_tpu/infer/fused_hat.py. Every HAB runs its
CAB conv stack as kernel 7 (ops/hab.fused_cab_convs) and its window body
as kernel 8 (ops/hab.fused_hab_block). Every group-end OCAB takes one of
the reference's three attention paths, read from the environment at each
call as the reference reads it at trace time:
  * kernel 9 (ops/flash_oca.flash_oca_gathered), fed the padded key and
    value maps, where oca_gather_supported holds (an even ows - ws) and
    SRTPU_GATHER_OCA is not "" or "0";
  * else, unless SRTPU_EINSUM_OCA is set, kernel 10
    (ops/window_attention.flash_window_attention) on the key and value
    windows gathered by ops/unfold.extract_overlapping_windows;
  * with SRTPU_EINSUM_OCA set, the plain attention with f32 logits.
The rest is plain PyTorch, as the reference leaves it to XLA: the
squeeze-excite tail, rolls and window partitions, the OCAB's dense layers
and MLP, and the convs. fused_hybrid_model runs stage 1 through
infer/fused_trunk.fused_rrdb_model (B1) and resizes to output_size as the
reference does.

Weights come from the port's HAT-keyed state dict (models/convert.py
bridges the JAX trees) and are cast per input dtype, as the reference
casts its params at the call: bf16 on the card, f32 in the CPU tests.

The reference's three deploy levers, all off by default, are read from
the environment where the reference reads them:
  * SRTPU_LANE_PAD (with SRTPU_LANE_PAD_TO, default 128), once in
    make_fused_hat: where infer/lane_pad.lane_pad_supported holds, the
    weights are zero-padded to that many channels (pad_hat_params) and
    the stage runs there, kernels 7-9 at C 128 with 8 heads for embed 96,
    every LayerNorm dividing by the real C (c_real); elsewhere (C 120 at
    head dim 20, say) the model runs unpadded, as the reference's does;
  * SRTPU_STRIP_HAB (with SRTPU_STRIP_RB), at each HAB call and only
    unpadded: kernel 7, the squeeze-excite vector from its output (f32,
    conv_scale folded in), then kernel 11 (ops/hab_strip.strip_hab_block)
    on the spatial maps, with no roll, partition or merge around it;
  * SRTPU_XLA_CAB, at each HAB call: the plain CAB (LN, convs, GELU, SE)
    in PyTorch in place of kernel 7.
"""

from __future__ import annotations

import os
from typing import Mapping

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.infer.common import (
    PreboundModel,
    param_conv,
    state_tensors,
)
from superresolution_tpu_torch.infer.fused_trunk import fused_rrdb_model
from superresolution_tpu_torch.infer.lane_pad import (
    lane_pad_supported,
    pad_hat_params,
)
from superresolution_tpu_torch.models.common import pixel_shuffle_stages
from superresolution_tpu_torch.models.hat_lite import (
    HATLite,
    relative_position_index_oca,
    shift_region_ids,
    window_merge,
    window_partition,
)
from superresolution_tpu_torch.models.hybrid import resize_to_output
from superresolution_tpu_torch.ops.blur import anti_checkerboard
from superresolution_tpu_torch.ops.flash_oca import (
    bias_fragments,
    flash_oca_gathered,
    oca_gather_supported,
)
from superresolution_tpu_torch.ops.hab import (
    cab_weights,
    fused_cab_convs,
    fused_hab_block,
    hab_weights,
    layer_norm,
)
from superresolution_tpu_torch.ops.hab_strip import strip_hab_block
from superresolution_tpu_torch.ops.pixel_shuffle import depth_to_space
from superresolution_tpu_torch.ops.unfold import extract_overlapping_windows
from superresolution_tpu_torch.ops.window_attention import (
    flash_window_attention,
    reference_window_attention,
)
from superresolution_tpu_torch.runtime import resolve_device


def _ln(x: torch.Tensor, p: Mapping, name: str,
        c_real: int | None = None) -> torch.Tensor:
    return layer_norm(x, p[f"{name}.weight"], p[f"{name}.bias"], c_real)


def _dense(x: torch.Tensor, p: Mapping, name: str) -> torch.Tensor:
    """A Linear (or 1x1 conv) of the state dict on the last axis, with
    f32 accumulation and f32 bias, in x's dtype (the reference's
    _dense)."""
    w = p[f"{name}.weight"]
    w = w.reshape(w.shape[0], -1)
    return (x.float() @ w.to(x.dtype).float().t()
            + p[f"{name}.bias"].float()).to(x.dtype)


def _se(y: torch.Tensor, p: Mapping, pre: str) -> torch.Tensor:
    """The CAB's squeeze-excite vector [B,1,1,C] of its pre-SE output y,
    in y's dtype."""
    s = y.float().mean((1, 2), keepdim=True).to(y.dtype)
    s = torch.relu(_dense(s, p, f"{pre}.conv_block.cab.3.attention.1"))
    return torch.sigmoid(_dense(s, p, f"{pre}.conv_block.cab.3.attention.3"))


def _cab_plain(x: torch.Tensor, p: Mapping, pre: str,
               c_real: int | None) -> torch.Tensor:
    """The CAB in plain PyTorch (SRTPU_XLA_CAB): LN, conv, exact GELU,
    conv, squeeze-excite."""
    y = _ln(x, p, f"{pre}.norm1", c_real)
    y = F.gelu(param_conv(y, p, f"{pre}.conv_block.cab.0"))
    y = param_conv(y, p, f"{pre}.conv_block.cab.2")
    return y * _se(y, p, pre)


def _hab(x: torch.Tensor, p: Mapping, pre: str, weights, *, shift: int,
         ws: int, nh: int, conv_scale: float, ids: torch.Tensor | None,
         c_real: int | None = None) -> torch.Tensor:
    """One HABlock: the CAB branch (kernel 7 + SE, or the plain CAB
    under SRTPU_XLA_CAB), then the window body (kernel 8) on the rolled,
    partitioned x and cab; or, under SRTPU_STRIP_HAB on an unpadded
    stage, kernel 7 and kernel 11 on the maps."""
    b, h, w, c = x.shape
    cw, hw = weights
    if os.environ.get("SRTPU_STRIP_HAB") and c_real is None:
        y_cab = fused_cab_convs(x, cw)
        se = (_se(y_cab, p, pre).float() * conv_scale).reshape(b, 1, c)
        rb = os.environ.get("SRTPU_STRIP_RB")
        return strip_hab_block(x, y_cab, se, hw, num_heads=nh,
                               window_size=ws, shift=shift,
                               rb=int(rb) if rb else None)
    if os.environ.get("SRTPU_XLA_CAB"):
        cab = _cab_plain(x, p, pre, c_real)
    else:
        y = fused_cab_convs(x, cw, c_real=c_real)
        cab = y * _se(y, p, pre)
    cab = cab * torch.tensor(conv_scale, dtype=x.dtype)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        cab = torch.roll(cab, (-shift, -shift), dims=(1, 2))
    out = fused_hab_block(window_partition(x, ws).contiguous(),
                          window_partition(cab, ws).contiguous(), nh, hw,
                          ids, c_real)
    out = window_merge(out, ws, (h, w))
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out.contiguous()


def _ocab(x: torch.Tensor, p: Mapping, pre: str, *, ws: int, ows: int,
          nh: int, bias: torch.Tensor, fragments: torch.Tensor,
          c_real: int | None = None) -> torch.Tensor:
    """OverlappingCrossAttention: LN, q and kv denses, the kv maps
    zero-padded after the dense (asymmetric tail pad for odd ows - ws),
    attention through kernel 9 (the bias re-laid once, as `fragments`),
    kernel 10 or the plain form (see the module docstring), proj, MLP."""
    _, h, w, c = x.shape
    pad = (ows - ws) // 2
    y = _ln(x, p, f"{pre}.norm1", c_real)
    qkv = _dense(y, p, f"{pre}.qkv")  # q | k | v, as HAT packs them
    q = window_partition(qkv[..., :c], ws).contiguous()
    kv = F.pad(qkv[..., c:], (0, 0, pad, ows - ws - pad, pad, ows - ws - pad))
    einsum = bool(os.environ.get("SRTPU_EINSUM_OCA"))
    if (not einsum
            and os.environ.get("SRTPU_GATHER_OCA", "1") not in ("", "0")
            and oca_gather_supported(ws, ows, h, w)):
        k_map, v_map = (kv[..., i * c:(i + 1) * c].contiguous()
                        for i in (0, 1))
        out = flash_oca_gathered(q, k_map, v_map, bias, nh, ws, ows,
                                 fragments=fragments)
    else:
        k, v = extract_overlapping_windows(kv, ws, ows, h // ws,
                                           w // ws).split(c, dim=-1)
        out = (reference_window_attention(q, k, v, bias, nh) if einsum
               else flash_window_attention(q, k, v, bias, nh))
    x = x + window_merge(_dense(out, p, f"{pre}.proj"), ws, (h, w))
    z = F.gelu(_dense(_ln(x, p, f"{pre}.norm2", c_real), p,
                      f"{pre}.mlp.fc1"))
    return x + _dense(z, p, f"{pre}.mlp.fc2")


def make_fused_hat(params: Mapping, model: HATLite,
                   device: str | torch.device | None = None):
    """-> apply_fn(x [B,H,W,Cin]) -> [B,H*scale,W*scale,Cout], equal to
    `model` (the port's HATLite, which gives the configuration) applied
    with the weights of `params`, a HAT-keyed state dict, with its HABs
    and OCABs through kernels 7-10. Sides that are not multiples of the
    window are edge-padded and the output cropped, as in the model.
    Under SRTPU_LANE_PAD the weights are lane-padded here, once (see the
    module docstring)."""
    dev = resolve_device(device)
    p = state_tensors(params, dev)
    ws, scale = model.window_size, model.scale
    ows = int(ws * (1 + model.overlap_ratio))
    n = ws * ws
    heads, c_real = model.num_heads, None
    if os.environ.get("SRTPU_LANE_PAD"):
        c_model = p["conv_first.weight"].shape[0]
        c_pad = int(os.environ.get("SRTPU_LANE_PAD_TO", "128"))
        if len(set(heads)) == 1 and lane_pad_supported(c_model, heads[0],
                                                       c_pad):
            p, nhp = pad_hat_params(p, model, c_pad)
            heads, c_real = (nhp,) * len(heads), c_model
    c_q = p["conv_first.weight"].shape[0]  # the attention's channels
    layers = []
    for g, (depth, nh) in enumerate(zip(model.depths, heads)):
        blocks = [f"layers.{g}.residual_group.blocks.{i}"
                  for i in range(depth)]
        pre = f"layers.{g}.overlap_attn"
        if model.hat_compat:
            idx = torch.as_tensor(relative_position_index_oca(ws, ows),
                                  device=dev).long().reshape(-1)
            bias = p[f"{pre}.relative_position_bias_table"][idx].reshape(
                n, ows * ows, nh).permute(2, 0, 1).float().contiguous()
        else:
            bias = torch.zeros((nh, n, ows * ows), device=dev)
        # kernel 9's order of the bias, made once here for every frame
        frag = bias_fragments(bias, float(c_q // nh) ** -0.5)
        layers.append((g, blocks, nh, (bias, frag)))
    cast: dict = {}
    ids_at: dict = {}

    def weights(dtype: torch.dtype):
        """Kernel weights of every HAB, cast to `dtype` once."""
        if dtype not in cast:
            cast[dtype] = {
                pre: (cab_weights(p, pre, dtype),
                      hab_weights(p, pre, nh, ws, dtype))
                for _, blocks, nh, _ in layers for pre in blocks}
        return cast[dtype]

    def region_ids(h: int, w: int) -> torch.Tensor:
        if (h, w) not in ids_at:
            ids_at[h, w] = torch.as_tensor(
                shift_region_ids(h, w, ws, ws // 2), device=dev)
        return ids_at[h, w]

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        _, h0, w0, _ = x.shape
        ph, pw = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
        if ph or pw:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                      mode="replicate").permute(0, 2, 3, 1)
        wts = weights(x.dtype)
        ids = region_ids(h0 + ph, w0 + pw)
        feat = param_conv(x, p, "conv_first")
        y = (_ln(feat, p, "patch_embed.norm", c_real) if model.hat_compat
             else feat)
        for g, blocks, nh, (bias, frag) in layers:
            y0 = y
            for i, pre in enumerate(blocks):
                shift = 0 if i % 2 == 0 else ws // 2
                y = _hab(y, p, pre, wts[pre], shift=shift, ws=ws, nh=nh,
                         conv_scale=model.conv_scale,
                         ids=ids if shift else None, c_real=c_real)
            y = _ocab(y, p, f"layers.{g}.overlap_attn", ws=ws, ows=ows,
                      nh=nh, bias=bias, fragments=frag, c_real=c_real)
            y = y0 + param_conv(y, p, f"layers.{g}.conv")
        if model.hat_compat:
            y = _ln(y, p, "norm", c_real)
        y = param_conv(y, p, "conv_after_body") + feat
        if model.hat_compat:
            y = F.leaky_relu(param_conv(y, p, "conv_before_upsample.0"),
                             0.01)
        for j, r in enumerate(pixel_shuffle_stages(scale)):
            y = depth_to_space(param_conv(y, p, f"upsample.{2 * j}"), r)
        y = param_conv(y, p, "conv_last")
        return y[:, :h0 * scale, :w0 * scale]

    return apply_fn


def _stage(params: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def fused_hybrid_model(params: Mapping, model,
                       device: str | torch.device | None = None):
    """HybridSR (the port's; stage 2 a HATLite) -> a PreboundModel of x
    with the HybridSR forward: stage 1 through fused_rrdb_model (B1 + its tail),
    smooth, stage 2 through make_fused_hat (kernels 7-10), smooth, the
    bicubic resize to output_size where the stage output differs from
    it, and the light smooth. `params` holds stage1.* and stage2.* keys
    (convert.hybrid_state_dict_from_jax)."""
    if not isinstance(model.stage2, HATLite):
        raise ValueError("fused hybrid requires a HATLite stage 2")
    s1 = fused_rrdb_model(_stage(params, "stage1."), model.stage1,
                          device=device)
    s2 = make_fused_hat(_stage(params, "stage2."), model.stage2,
                        device=device)
    smoothing = model.smoothing

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        y = anti_checkerboard(s1(x), smoothing)
        y = resize_to_output(anti_checkerboard(s2(y), smoothing),
                             model.output_size)
        return anti_checkerboard(y, "light" if smoothing else None)

    return PreboundModel(apply_fn)
