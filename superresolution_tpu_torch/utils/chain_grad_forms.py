"""Plain-torch models of kernel 6's and kernel 13's tensor-core launches,
in their GEMM order.

The CUDA bodies run only on the card, so these forms hold, on the CPU,
what each launch computes and in which order (ops/csrc/dense_kernels.cu
rrdb_tc_kernel, ops/csrc/train_tc_kernels.cu DenseGradConv,
wgrad_tc_kernel and flip_weights_kernel):
  - kernel 6: the fifteen stages in order, each one of B1's launches in
    its GEMM form (utils/dense_tail_forms.dense_conv_form) over the
    kernel's own buffers (b1 in `out`, b2 in `tmp`, the workspace shared);
  - a transposed conv: im2col of D's channel prefix times the flipped
    K-major weights, summed in f32, then the lrelu' gate or the + s_id *
    dout epilogue in f32 and one rounding;
  - a weight grad: per pixel tile (8 x 16, row-major over B x tile rows x
    tile columns) the f32 GEMM of the tile's shifted input windows and
    its cotangent, chunk k holding tiles k, k + nchunk, ..., the chunks'
    partials summed in order and dW rounded once.
Each takes the arguments of its _build launch helper, so a test can put
it in the helper's place and run the wrappers' own launch sequences
(ops/dense_trunk.rrdb_launch, ops/dense_trunk_train.dense_block_backward)
on CPU tensors, planted faults included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops.dense_trunk_train import (
    FLIP_SOURCES,
    flipped_weights,
)
from superresolution_tpu_torch.utils.dense_tail_forms import (
    dense_conv_form,
    im2col,
    image_row_mask,
)

# the planted faults of kernel 6 (_build.PLANT_NO_RESIDUAL,
# PLANT_SWAP_STAGES, PLANT_NO_BARRIER)
NO_RESIDUAL, SWAP_STAGES, NO_BARRIER = 1, 2, 4

WG_TH, WG_TW, WG_CI = 8, 16, 32  # wgrad_tc_kernel's pixel tile, CI
SMS, WG_BLOCKS_PER_SM = 132, 2


def rrdb_stages(x, weights, ws, tmp, out, plant: int = 0) -> list:
    """Kernel 6's fifteen stages in launch order, each a dict of
    dense_conv_form's arguments, with the planted faults that change the
    stages (the last residual dropped, the first two swapped)."""
    g = ws.shape[-1] // 4
    stages = []
    for blk, (src, dst, res) in enumerate(((x, out, None), (out, tmp, None),
                                           (tmp, out, x))):
        for j in range(5):
            k, b = weights[5 * blk + j]
            last = j == 4
            stages.append(dict(
                x=src, ws=ws, cin1=j * g, w=k, bias=b,
                out=dst if last else ws, out_off=0 if last else j * g,
                lrelu=not last, xres=src if last else None,
                res=res if last else None))
    if plant & NO_RESIDUAL:
        stages[-1]["res"] = None
    if plant & SWAP_STAGES:
        stages[0], stages[1] = stages[1], stages[0]
    return stages


def rrdb_tc_form(x, weights, ws, tmp, out, plant: int = 0) -> None:
    """One launch of _build.rrdb_tc: the stages in order, one after
    another (the grid barrier between them). With NO_BARRIER each stage
    reads the buffers as the stage before the last one left them: the
    stores of the stage just before have not landed, the worst a missing
    barrier allows."""
    stages = rrdb_stages(x, weights, ws, tmp, out, plant)
    if not plant & NO_BARRIER:
        for st in stages:
            dense_conv_form(**st)
        return
    live = (ws, tmp, out)
    prev = [t.clone() for t in live]  # the state before the last stage
    for st in stages:
        snap = {id(t): p for t, p in zip(live, prev)}
        prev = [t.clone() for t in live]
        reads = {k: snap.get(id(st[k]), st[k])
                 for k in ("x", "ws", "xres", "res") if st[k] is not None}
        dense_conv_form(**{**st, **reads})


def grad_conv_form(d, n_in, wk, out, out_off, *, gate=None, gate_off=0,
                   add=None, add_scale=1.0, seg=None, seg_plant=0) -> None:
    """One launch of _build.grad_conv (DenseGradConv): im2col of d's first
    n_in channels (spacer rows read as zero) times wk read as [9 * n_in,
    n], f32 sums, the lrelu' gate, + add_scale * add, spacer rows 0 (not
    with seg_plant), one rounding into out[..., out_off:out_off + n]."""
    n = wk.shape[-1]
    keep = image_row_mask(d.shape[1], seg)
    v = im2col(d[..., :n_in].float() * keep) @ wk.float().reshape(-1, n)
    if gate is not None:
        v = torch.where(gate[..., gate_off:gate_off + n].float() > 0, v,
                        0.2 * v)
    if add is not None:
        v = v + add_scale * add.float()
    if not seg_plant:
        v = v * keep
    out[..., out_off:out_off + n] = v.to(out.dtype)


def flip_weights_form(weights, out) -> None:
    """One launch of _build.flip_weights: every source's flipped weights,
    sources 4, 3, 2, 1, 0, flattened one after another."""
    out.copy_(torch.cat([flipped_weights(weights, i).reshape(-1)
                         for i in FLIP_SOURCES]).to(out.dtype))


def wgrad_chunks(b: int, h: int, w: int, cin: int, cout: int) -> int:
    """train_wgrad_tc_chunks on a card of SMS SMs."""
    co = 32 if cout <= 32 else 64
    tiles = b * -(-h // WG_TH) * -(-w // WG_TW)
    per = -(-cin // WG_CI) * -(-cout // co)
    return max(1, min(tiles, -(-(WG_BLOCKS_PER_SM * SMS) // per)))


def _tiles(t: torch.Tensor) -> torch.Tensor:
    """[B, H, W, K] -> [ntiles, WG_TH * WG_TW, K], the map zero-padded to
    whole tiles, tiles row-major over B x tile rows x tile columns."""
    b, h, w, k = t.shape
    th, tw = -(-h // WG_TH), -(-w // WG_TW)
    t = F.pad(t, (0, 0, 0, tw * WG_TW - w, 0, th * WG_TH - h))
    t = t.reshape(b, th, WG_TH, tw, WG_TW, k).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b * th * tw, WG_TH * WG_TW, k)


def wgrad_form(in0, cin0, in1, cin1, d, d_off, cout, dw, db, seg=None,
               nchunk: int | None = None) -> None:
    """One call of _build.wgrad_tc in wgrad_tc_kernel's order: per tile the
    f32 product of the shifted input windows (im2col, spacer rows and the
    halo zero) and the cotangent's spacer-masked tile; chunk k sums tiles
    k, k + nchunk, ... in order, and the chunks' partials are summed in
    order; dW rounded once to dw's type, db kept in f32."""
    src = [in0[..., :cin0]] + ([in1[..., :cin1]] if cin1 else [])
    u = torch.cat(src, -1).float()
    b, h, w, cin = u.shape
    keep = image_row_mask(h, seg)
    a = _tiles(im2col(u * keep))                              # [T, 128, 9cin]
    dd = _tiles(d[..., d_off:d_off + cout].float() * keep)    # [T, 128, cout]
    per_tile = a.transpose(1, 2) @ dd                         # [T, 9cin, cout]
    n = nchunk or wgrad_chunks(b, h, w, cin, cout)
    parts = [per_tile[k::n].sum(0) for k in range(n)]
    bparts = [dd[k::n].sum((0, 1)) for k in range(n)]
    acc, bacc = parts[0].clone(), bparts[0].clone()
    for p, q in zip(parts[1:], bparts[1:]):
        acc += p
        bacc += q
    dw.copy_(acc.reshape(dw.shape).to(dw.dtype))
    if db is not None:
        db.copy_(bacc)
