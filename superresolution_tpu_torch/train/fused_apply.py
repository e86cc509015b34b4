"""The training forward with the RRDB trunk on kernel 13's op.

Counterpart of superresolution_tpu/train/fused_apply.py:34-148: a pure
function of the live (compute-type) parameters, differentiable in them
and in x, equal to the model's forward. Every dense block runs
ops/dense_trunk_train.fused_dense_block_train (B1 forward, kernel 13
backward on the card); the third block of each RRDB folds the RRDB
residual in. The weights reach the op from the parameter dict through
differentiable torch ops (OIHW -> HWIO); each bias reaches it as f32,
cast from the compute type, as proj_weights_traced sees a bias that
cast_to_compute already rounded.

For a HybridSR over an RRDBNet, stage 1 runs fused and the blur /
HATLite / blur / 'light' blur after it are the plain modules, as the
reference replays them. With `row_pack`, a batch of more than one image
runs the trunk as one tall map (pack_batch_rows: one zero spacer row
after each image) with every dense block's `seg` = (h + 1, h), as the
reference's row-packed training does (fused_apply.py:61-103 there).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from superresolution_tpu_torch.infer.common import conv_nhwc, hwio
from superresolution_tpu_torch.models.hybrid import HybridSR, resize_to_output
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.ops.blur import anti_checkerboard
from superresolution_tpu_torch.ops.dense_trunk_train import (
    fused_dense_block_train,
)
from superresolution_tpu_torch.ops.pixel_shuffle import space_to_depth

Params = Mapping[str, torch.Tensor]


def supports_fused_train(model: nn.Module) -> bool:
    """True when make_fused_train_apply can handle this model."""
    if isinstance(model, HybridSR):
        return supports_fused_train(model.stage1)
    return (isinstance(model, RRDBNet) and model.scan_blocks
            and model.fused_dense)


class _Tail(nn.Module):
    """An RRDBNet's tail as a module's forward, so functional_call can run
    it on the given parameters."""

    def __init__(self, model: RRDBNet):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.tail(x)


def _sub(params: Params, prefix: str) -> dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def pack_batch_rows(x: torch.Tensor, spacer: int = 1) -> torch.Tensor:
    """[B, H, W, C] -> [1, B*(H+spacer), W, C]: the batch stacked along H
    with `spacer` zero rows after each image (the kernels' `seg` mask
    then gives each image exact SAME padding)."""
    b, h, w, c = x.shape
    return F.pad(x, (0, 0, 0, 0, 0, spacer)).reshape(1, b * (h + spacer),
                                                     w, c)


def unpack_batch_rows(xp: torch.Tensor, b: int, h: int,
                      spacer: int = 1) -> torch.Tensor:
    """Inverse of pack_batch_rows (drops the spacer rows)."""
    return xp.reshape(b, h + spacer, *xp.shape[2:])[:, :h]


def _make_rrdb_apply(model: RRDBNet, row_pack: bool = False) -> Callable:
    tail = _Tail(model)

    def apply(p: Params, x: torch.Tensor) -> torch.Tensor:
        if model.pixel_unshuffle_input > 1:
            x = space_to_depth(x, model.pixel_unshuffle_input)
        x = head = conv_nhwc(x, p["conv_first.weight"], p["conv_first.bias"])
        b, h = x.shape[0], x.shape[1]
        seg = None
        if row_pack and b > 1:
            seg = (h + 1, h)
            x = pack_batch_rows(x)
        for i in range(model.num_blocks):
            ws = [[(hwio(p[f"body.{i}.rdb{k}.conv{j}.weight"]),
                    p[f"body.{i}.rdb{k}.conv{j}.bias"].float())
                   for j in range(1, 6)] for k in range(1, 4)]
            y = fused_dense_block_train(x, ws[0], seg=seg)
            y = fused_dense_block_train(y, ws[1], seg=seg)
            x = fused_dense_block_train(y, ws[2], residual=x, seg=seg)
        if seg is not None:
            x = unpack_batch_rows(x, b, h)
        feat = conv_nhwc(x, p["conv_body.weight"], p["conv_body.bias"]) + head
        return functional_call(tail, {f"model.{k}": v for k, v in p.items()
                                      if not k.startswith("body.")}, (feat,))

    return apply


def make_fused_train_apply(model: nn.Module, row_pack: bool = False
                           ) -> Callable:
    """-> apply(params, x), equal to functional_call(model, params, x)
    with the RRDB trunk on kernel 13's op; `params` is the model's
    name -> tensor dict (e.g. Policy.cast_to_compute of the masters).
    row_pack: stack a batch of more than one image along H, one spacer
    row apiece, through the blocks' `seg`."""
    if not supports_fused_train(model):
        raise ValueError("the fused train apply requires an RRDBNet (or a "
                         "HybridSR over one) with scan_blocks and "
                         "fused_dense")
    if not isinstance(model, HybridSR):
        return _make_rrdb_apply(model, row_pack)
    stage1 = _make_rrdb_apply(model.stage1, row_pack)

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        x = stage1(_sub(params, "stage1."), x)
        if model.smoothing:
            x = anti_checkerboard(x, model.smoothing)
        if model.stage2 is not None:
            x = functional_call(model.stage2, _sub(params, "stage2."), (x,))
            if model.smoothing:
                x = anti_checkerboard(x, model.smoothing)
        x = resize_to_output(x, model.output_size)
        if model.smoothing:
            x = anti_checkerboard(x, "light")
        return x

    return apply
