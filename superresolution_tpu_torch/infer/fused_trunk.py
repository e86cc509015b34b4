"""Deploy-time RRDB trunk through the hand-written dense-block kernels.

Counterpart of superresolution_tpu/infer/fused_trunk.py. By default
conv_first and trunk_conv stay plain convs (XLA's in the reference) and
the 23x3 dense blocks run as ops/dense_trunk.fused_dense_block (B1), the
RRDB residual folded into every third block's epilogue. The reference's
two levers, off by default there too:
  * chain_rrdb: each RRDB is one launch of kernel 6 (fused_rrdb);
    conv_first and trunk_conv stay plain convs;
  * fold_ends: RRDB 0 starts with kernel 4 (conv_first folded into its
    first block) and the last RRDB ends with kernel 5 (its third block,
    trunk_conv and the global residual), so no plain conv is left; the
    middle RRDBs run as by default. Forced off under chain_rrdb and with
    fewer than 2 RRDBs, as in the reference.
The dense-block kernels are kept in bf16, as the reference's proj_weights
keeps them; the convs around them run in the input's dtype, and as
kernels 4 and 5 their kernels keep the params' dtype on the CPU (the
reference's end folds keep it) and are bf16 on the card (the kernels'
type).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.infer.common import (
    PreboundModel,
    hwio,
    param_conv,
    state_tensors,
)
from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
from superresolution_tpu_torch.ops.dense_trunk import (
    dense_weights,
    fused_dense_block,
    fused_dense_block_epilogue,
    fused_dense_block_prologue,
    fused_rrdb,
)
from superresolution_tpu_torch.ops.pixel_shuffle import (
    depth_to_space,
    space_to_depth,
)
from superresolution_tpu_torch.runtime import resolve_device


def make_fused_trunk(params: Mapping, model, chain_rrdb: bool = False,
                     fold_ends: bool = False,
                     device: str | torch.device | None = None):
    """-> trunk_fn(x [B,H,W,Cin]) equal to model.trunk(x) on the weights
    of `params` (a BasicSR-keyed state dict; `model` is the port's
    RRDBNet and gives the configuration), through B1 and, under the
    levers, kernels 4-6 (see the module docstring)."""
    dev = resolve_device(device)
    p = state_tensors(params, dev)
    blocks = []
    for i in range(model.num_blocks):
        rrdb = []
        for k in range(1, 4):
            pre = f"body.{i}.rdb{k}"
            rrdb.append(dense_weights(
                [hwio(p[f"{pre}.conv{j}.weight"]) for j in range(1, 6)],
                [p[f"{pre}.conv{j}.bias"] for j in range(1, 6)],
                device=dev))
        blocks.append(rrdb)
    unshuffle = model.pixel_unshuffle_input
    if chain_rrdb or model.num_blocks < 2:
        fold_ends = False
    if fold_ends:
        end_dtype = (torch.bfloat16 if dev.type == "cuda"
                     else p["conv_first.weight"].dtype)
        head_w, trunk_w = (dense_weights([hwio(p[f"{n}.weight"])],
                                         [p[f"{n}.bias"]], dtype=end_dtype,
                                         device=dev)[0]
                           for n in ("conv_first", "conv_body"))

    def trunk_fn(x: torch.Tensor) -> torch.Tensor:
        if unshuffle > 1:
            x = space_to_depth(x, unshuffle).contiguous()
        if fold_ends:
            (w0, w1, w2), last = blocks[0], blocks[-1]
            # RRDB 0: conv_first rides its first block
            y, head = fused_dense_block_prologue(x, head_w, w0)
            y = fused_dense_block(y, w1)
            x = fused_dense_block(y, w2, residual=head)
            for w0, w1, w2 in blocks[1:-1]:
                y = fused_dense_block(fused_dense_block(x, w0), w1)
                x = fused_dense_block(y, w2, residual=x)
            # the last RRDB: trunk_conv and the global residual ride its
            # third block
            y = fused_dense_block(fused_dense_block(x, last[0]), last[1])
            return fused_dense_block_epilogue(y, last[2], x, trunk_w, head)
        x = head = param_conv(x, p, "conv_first")
        for w0, w1, w2 in blocks:
            if chain_rrdb:
                x = fused_rrdb(x, w0, w1, w2)
                continue
            y = fused_dense_block(x, w0)
            y = fused_dense_block(y, w1)
            # the RRDB residual rides the third block's epilogue
            x = fused_dense_block(y, w2, residual=x)
        return param_conv(x, p, "conv_body") + head

    return trunk_fn


def make_standard_tail(params: Mapping, model,
                       device: str | torch.device | None = None):
    """tail_fn(feat [B,H,W,C]) -> [B,sH,sW,out]: the model's own tail
    (conv_up{n} + pixel shuffle + lrelu per stage, or nearest x2 +
    conv_up{n} + lrelu, then conv_hr + lrelu, conv_last) as plain convs
    on the weights of `params`, unclipped."""
    dev = resolve_device(device)
    p = state_tensors(params, dev)
    nearest = model.upsampler == "nearest_conv"

    def tail_fn(feat: torch.Tensor) -> torch.Tensor:
        y = feat
        for n, r in enumerate(model.up_stages, 1):
            if nearest:
                y = y.repeat_interleave(2, 1).repeat_interleave(2, 2)
                y = F.leaky_relu(param_conv(y, p, f"conv_up{n}"), 0.2)
                continue
            y = F.leaky_relu(depth_to_space(param_conv(y, p, f"conv_up{n}"),
                                            r), 0.2)
        y = F.leaky_relu(param_conv(y, p, "conv_hr"), 0.2)
        return param_conv(y, p, "conv_last")

    return tail_fn


def fused_rrdb_model(params: Mapping, model,
                     device: str | torch.device | None = None):
    """RRDBNet -> a PreboundModel of x [B,H,W,Cin] -> [B,sH,sW,out]: the
    fused trunk, then the B2/B3 phase tail when the tail is x4
    pixelshuffle, else the model's standard tail as plain convs; both
    unclipped, as the model's own tail."""
    trunk = make_fused_trunk(params, model, device=device)
    if (model.upsampler == "pixelshuffle"
            and tuple(model.up_stages) == (2, 2)):
        tail = make_phase_tail(params, clip=False, device=device)
    else:
        tail = make_standard_tail(params, model, device=device)

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        return tail(trunk(x))

    return PreboundModel(apply_fn)
