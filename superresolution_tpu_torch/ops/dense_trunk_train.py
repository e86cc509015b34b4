"""Kernel 13: the RRDB dense block with a hand-written CUDA backward.

Replaces superresolution_tpu/ops/pallas_dense_trunk_vjp.py:
fused_dense_block_train (the custom_vjp whose backward is _bwd_kernel).
The forward is B1 (ops/dense_trunk.fused_dense_block) unchanged, and only
x, the weights and the residual are kept for the backward, as in the
reference's _fwd. The backward takes dout and returns dx, each conv's dW
(HWIO, summed in f32 and cast to the weight's type) and db (f32), and
dres = dout. Its math is _bwd_kernel's in the port's BasicSR layout,
where conv_j reads [x, y_1..y_{j-1}]:

    s_acc = 0.2 * 0.2 with a folded residual, else 0.2
    s_id  = 0.2 with a folded residual, else 1
    dpre5 = bf16(s_acc * dout)
    dpre_i = bf16(lrelu'(y_i) * sum_{j > i} convT_j(dpre_j)[y_i])  i = 4..1
    dx    = sum_j convT_j(dpre_j)[x] + s_id * dout
    dW_j  = sum_p in_j[p + tap] (x) dpre_j[p],  db_j = sum_p dpre_j[p]

Each dy_i sums every later conv's contribution in f32 before the lrelu'
select and the one bf16 rounding, where _bwd_kernel rounds. lrelu'
selects on y_i > 0, which is pre_i > 0 since y_i = lrelu(pre_i) with a
positive slope, so the recompute needs only B1's y_1..y_4.

On the card one call is a fixed sequence of launches plus B1's first
four convs for the recompute (counted as B1's). The per-source
transposed convs read a prefix of one cotangent workspace D = [dpre5 |
dpre4 | ... | dpre1]: source i's conv takes every later conv's cotangent
at once, with weights flipped in dy and dx and channels transposed
(`flipped_weights`). Each reads its input through a zero halo, so every
cotangent is exact at the image border by construction; the reference's
projection layout, PAD=8 columns, masks and roll-convs do not carry
over. The weight grads are per-chunk f32 partials summed by a second
launch in a fixed order. uses_tensor_cores (B1's route rule) picks the
body: at the models' widths (bf16, C and g multiples of 8, C + 4g <=
256) the flipped weights are one launch, the five transposed convs run
the conv engine's tensor-core body under DenseGradConv and the weight
grads wgrad_tc_kernel (csrc/train_tc_kernels.cu, bf16 mma.sync, f32
sums), 17 launches of its own; f32 activations (precision "fp32") run
the transposed convs on the engine's direct body under DenseGradConv
and train_kernels.cu's wgrad_kernel, both in f32 (f32 FFMA), 16
launches; other bf16 shapes run sr_kernels.cu's direct conv and
wgrad_kernel, 16 launches.

Bound on the H100 at hybrid_astro's [4,128,128,64] (c 64, g 32): the
transposed convs and the weight grads each do the forward's 239,616 MACs
per pixel and the recompute of y_1..y_4 (convs 1-4) 129,024, so 608,256
in all, 8.0e10 FLOP a call, 0.081 ms at 989 TFLOP/s; bound by
operations.

With `seg` (a batch-packed x, ops/dense_trunk.py) every launch masks
the spacer rows as B1's do: each conv and transposed conv reads them as
zero and writes them as 0, and the weight grads read them as zero in
both inputs, so dx and every cotangent are exactly 0 there (the
reference's _mask_flat) and dres is dout with its spacer rows zeroed,
the gradient of an output whose spacer rows are 0.

`dense_block_backward.launches` counts calls of the backward (one per
call, 69 per hybrid_astro step), its `seg_launches` those with seg, and
`tc_launches` / `direct_launches` those by body.
The plain version is autograd through
ops/dense_trunk.fused_dense_block_reference; CPU tensors run it.
"""

from __future__ import annotations

import torch

from superresolution_tpu_torch.ops import _build, dense_trunk
from superresolution_tpu_torch.ops.dense_trunk import (
    DenseWeights,
    Seg,
    check_seg,
    dense_features,
    fused_dense_block,
    fused_dense_block_reference,
    image_rows,
    seg_kw,
)


def fused_dense_block_train_reference(x: torch.Tensor, weights: DenseWeights,
                                      residual: torch.Tensor | None = None,
                                      seg: Seg | None = None
                                      ) -> torch.Tensor:
    """The plain version: autograd differentiates it."""
    return fused_dense_block_reference(x, weights, residual, seg=seg)


def flipped_weights(weights: DenseWeights, src: int) -> torch.Tensor:
    """Weights of the transposed conv into source `src` (0: x, i: y_i):
    [3, 3, cout_5 + cout_4 + ... + cout_{src+1}, n_src], the blocks in
    D's channel order (conv 5 first), each W_j flipped in dy and dx with
    its channels transposed, restricted to the channels conv_j reads
    from the source."""
    c = weights[4][0].shape[-1]
    g = weights[0][0].shape[-1]
    lo, hi = (0, c) if src == 0 else (c + (src - 1) * g, c + src * g)
    return torch.cat([weights[j - 1][0].flip(0, 1)[:, :, lo:hi, :]
                      .transpose(2, 3) for j in range(5, src, -1)],
                     2).contiguous()


# The transposed convs' sources in D's order of writing: y_4 .. y_1, x.
FLIP_SOURCES = (4, 3, 2, 1, 0)


def flip_sizes(c: int, g: int) -> list[int]:
    """Elements of each source's flipped weights [3, 3, n_in, n_src], in
    FLIP_SOURCES order."""
    return [9 * (c + (4 - i) * g) * (g if i else c) for i in FLIP_SOURCES]


def flipped_launch(weights: DenseWeights) -> dict:
    """Every source's flipped weights from one launch (_build.flip_weights)
    into one buffer: {source: [3, 3, n_in, n_src] view}."""
    c = weights[4][0].shape[-1]
    g = weights[0][0].shape[-1]
    sizes = flip_sizes(c, g)
    k = weights[0][0]
    buf = torch.empty(sum(sizes), dtype=k.dtype, device=k.device)
    _build.flip_weights(weights, buf)
    return {i: t.view(3, 3, c + (4 - i) * g, g if i else c)
            for i, t in zip(FLIP_SOURCES, buf.split(sizes))}


def dense_block_backward(x: torch.Tensor, weights: DenseWeights,
                         residual: torch.Tensor | None, dout: torch.Tensor,
                         seg: Seg | None = None):
    """Kernel 13 on CUDA tensors (bf16 or f32 activations and kernels of
    one type, f32 biases) -> (dx, [(dW_j, db_j)] * 5, dres or None).
    Raises on others. seg: (stride, valid) of a batch-packed x, or
    None."""
    check_seg(seg)
    b, h, w, c = x.shape
    g = weights[0][0].shape[-1]
    _build.require_cuda(
        x, residual, dout, *(k for k, _ in weights),
        dtype=_build.activation_dtype(x, "dense_block_backward"),
        name="dense_block_backward")
    _build.require_cuda(*(bb for _, bb in weights), dtype=torch.float32,
                        name="dense_block_backward")
    if dout.shape != x.shape or (residual is not None
                                 and residual.shape != x.shape):
        raise ValueError("dense_block_backward: dout / residual shape != "
                         f"x shape {tuple(x.shape)}")
    for j, (k, bb) in enumerate(weights):
        want = (3, 3, c + j * g, g if j < 4 else c)
        if tuple(k.shape) != want or tuple(bb.shape) != (want[3],):
            raise ValueError(f"dense_block_backward: conv{j + 1} kernel "
                             f"{tuple(k.shape)}, expected {want}")
    s_acc, s_id = (0.2 * 0.2, 0.2) if residual is not None else (0.2, 1.0)
    geom, kw = (b, h, w), seg_kw(seg)
    tc = dense_trunk.uses_tensor_cores(x, c, g)  # B1's route rule
    y = torch.empty((b, h, w, 4 * g), dtype=x.dtype, device=x.device)
    dense_features(x, weights, y, seg)
    d = torch.empty((b, h, w, 4 * g + c), dtype=x.dtype, device=x.device)
    _build.dense_scale(dout, s_acc, d)
    dx = torch.empty_like(x)
    if tc or x.dtype == torch.float32:  # the engine: tensor cores or f32
        wt = (flipped_launch(weights) if tc else
              {i: flipped_weights(weights, i) for i in FLIP_SOURCES})
        for i in (4, 3, 2, 1):
            n_in = c + (4 - i) * g
            _build.grad_conv(d, n_in, wt[i], d, n_in, gate=y,
                             gate_off=(i - 1) * g, **kw)
        _build.grad_conv(d, 4 * g + c, wt[0], dx, 0, add=dout,
                         add_scale=s_id, **kw)
    else:
        for i in (4, 3, 2, 1):
            n_in = c + (4 - i) * g
            _build.conv3x3(d, n_in, flipped_weights(weights, i), None, d,
                           n_in, g, geom=geom, gate=y, gate_off=(i - 1) * g,
                           **kw)
        _build.conv3x3(d, 4 * g + c, flipped_weights(weights, 0), None, dx,
                       0, c, geom=geom, add=dout, add_scale=s_id, **kw)
    grads = []
    for j, (k, bb) in enumerate(weights, 1):
        dk = torch.empty_like(k)
        db = torch.empty_like(bb)
        d_off = 0 if j == 5 else c + (4 - j) * g
        (_build.wgrad_tc if tc else _build.wgrad)(
            x, c, y if j > 1 else None, (j - 1) * g, d, d_off, k.shape[-1],
            dk, db, **kw)
        grads.append((dk, db))
    dense_block_backward.launches += 1
    dense_block_backward.seg_launches += seg is not None
    if tc:
        dense_block_backward.tc_launches += 1
    else:
        dense_block_backward.direct_launches += 1
    dres = None
    if residual is not None:
        dres = dout if seg is None else dout * image_rows(
            h, seg, dout.device).to(dout.dtype)[:, None, None]
    return dx, grads, dres


dense_block_backward.launches = 0
dense_block_backward.seg_launches = 0  # those of them with seg
dense_block_backward.tc_launches = 0   # by body
dense_block_backward.direct_launches = 0


class DenseBlockTrain(torch.autograd.Function):
    """B1 forward, kernel 13 backward; CUDA tensors only."""

    @staticmethod
    def forward(ctx, x, residual, seg, *flat):
        weights = list(zip(flat[0::2], flat[1::2]))
        out = fused_dense_block(x, weights, residual, seg=seg)
        ctx.save_for_backward(x, residual, *flat)
        ctx.seg = seg
        return out

    @staticmethod
    def backward(ctx, dout):
        x, residual, *flat = ctx.saved_tensors
        weights = list(zip(flat[0::2], flat[1::2]))
        dx, grads, dres = dense_block_backward(
            x, weights, residual, dout.to(x.dtype).contiguous(), ctx.seg)
        return (dx, dres, None, *(t for pair in grads for t in pair))


def fused_dense_block_train(x: torch.Tensor, weights: DenseWeights,
                            residual: torch.Tensor | None = None,
                            seg: Seg | None = None) -> torch.Tensor:
    """The differentiable dense block: gradients reach x, every weight
    and the residual. CPU tensors run the plain version; CUDA tensors
    launch B1 forward and kernel 13 backward, or raise. seg: (stride,
    valid) of a batch-packed x (train/fused_apply.pack_batch_rows), or
    None."""
    if x.device.type == "cpu":
        return fused_dense_block_train_reference(x, weights, residual, seg)
    return DenseBlockTrain.apply(x, residual, seg,
                                 *(t for pair in weights for t in pair))
