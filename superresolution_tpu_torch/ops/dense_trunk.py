"""B1: one RRDB dense block as a hand-written CUDA op.

Replaces superresolution_tpu/ops/pallas_dense_trunk.py:fused_dense_block
(the roll-conv Pallas kernel). What it computes, on NHWC x [B,H,W,c]:

    y_j = lrelu(conv_j([x, y_1..y_{j-1}]) + b_j)    j = 1..4, g channels
    out = x + 0.2 * (conv_5([x, y_1..y_4]) + b_5)
    out = residual + 0.2 * out                       (optional)

with SAME zero padding at every conv. On the card this is five launches
of the shared conv in csrc/sr_kernels.cu over one [B,H,W,4g] workspace:
conv_j reads x and the first (j-1)*g workspace channels and writes its g
channels after them; conv_5 applies both residual epilogues. Each conv
reads its input through a zero-filled halo, so the padding is exact by
construction (the trap pallas_dense_trunk.py:19-27 records for a single
border mask cannot arise).

Bound on the H100 at the main-path shape x [24,376,256,64] bf16: 239,616
MACs per pixel, 1.11 TFLOP per call -> 1.12 ms at 989 TFLOP/s, against
0.27 ms for its ~0.9 GB of x, residual and output; bound by operations.
The simple kernel runs on the CUDA cores (see sr_kernels.cu for what it
leaves on the table).

Weights: five (kernel [3,3,cin_j,cout_j] HWIO, bias [cout_j] f32) pairs
(dense_weights), from a BasicSR-keyed state dict or from the JAX
package's projection-layout params through models/convert._unfuse_dense.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build

DenseWeights = list[tuple[torch.Tensor, torch.Tensor]]


def dense_weights(kernels, biases, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str | None = None) -> DenseWeights:
    """Five HWIO kernels and their biases (numpy arrays or tensors) ->
    the op's weight list: kernels in `dtype` (bf16, the deploy type, by
    default), biases in f32."""
    def tensor(a):
        return a if isinstance(a, torch.Tensor) else torch.tensor(
            np.asarray(a))

    return [(tensor(k).to(device=device, dtype=dtype).contiguous(),
             tensor(b).to(device=device, dtype=torch.float32).contiguous())
            for k, b in zip(kernels, biases, strict=True)]


def fused_dense_block_reference(x: torch.Tensor, weights: DenseWeights,
                                residual: torch.Tensor | None = None,
                                workspace: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of B1 (F.conv2d per conv), NHWC in and out.
    A `workspace` [B,H,W,4g] receives y_1..y_4, as the kernel's does."""
    xc = x.permute(0, 3, 1, 2)
    feats = [xc]
    for j, (w, b) in enumerate(weights):
        y = F.conv2d(torch.cat(feats, 1), w.permute(3, 2, 0, 1).to(x.dtype),
                     b.to(x.dtype), padding=1)
        if j < 4:
            feats.append(F.leaky_relu(y, 0.2))
    if workspace is not None:
        workspace.copy_(torch.cat(feats[1:], 1).permute(0, 2, 3, 1))
    out = xc + y * 0.2
    if residual is not None:
        out = residual.permute(0, 3, 1, 2) + out * 0.2
    return out.permute(0, 2, 3, 1).contiguous()


def fused_dense_block(x: torch.Tensor, weights: DenseWeights,
                      residual: torch.Tensor | None = None,
                      workspace: torch.Tensor | None = None) -> torch.Tensor:
    """B1. CPU tensors run the plain version; CUDA tensors launch the
    kernel (bf16 activations and kernels, f32 biases) or raise. The
    kernel writes y_1..y_4 into `workspace` [B,H,W,4g] when one is given
    (so a check can read them), else into a fresh one."""
    if x.device.type == "cpu":
        return fused_dense_block_reference(x, weights, residual, workspace)
    if len(weights) != 5:
        raise ValueError(f"expected 5 (kernel, bias) pairs, got {len(weights)}")
    b, h, w, c = x.shape
    g = weights[0][0].shape[-1]
    _build.require_cuda(x, residual, workspace, *(k for k, _ in weights),
                        name="fused_dense_block")
    _build.require_cuda(*(bb for _, bb in weights), dtype=torch.float32,
                        name="fused_dense_block")
    for j, (k, bb) in enumerate(weights):
        want = (3, 3, c + j * g, g if j < 4 else c)
        if tuple(k.shape) != want or tuple(bb.shape) != (want[3],):
            raise ValueError(f"fused_dense_block: conv{j + 1} kernel "
                             f"{tuple(k.shape)} / bias {tuple(bb.shape)}, "
                             f"expected {want}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError("fused_dense_block: residual shape "
                         f"{tuple(residual.shape)} != {tuple(x.shape)}")
    ws = workspace
    if ws is None:
        ws = torch.empty((b, h, w, 4 * g), dtype=x.dtype, device=x.device)
    elif ws.shape != (b, h, w, 4 * g):
        raise ValueError("fused_dense_block: workspace shape "
                         f"{tuple(ws.shape)} != {(b, h, w, 4 * g)}")
    out = torch.empty_like(x)
    dense_features(x, weights, ws)
    k, bb = weights[4]
    _build.conv3x3(x, c, k, bb, out, 0, c, geom=(b, h, w), in1=ws,
                   cin1=4 * g, xres=x, res=residual)
    fused_dense_block.launches += 1
    return out


fused_dense_block.launches = 0


def dense_features(x: torch.Tensor, weights: DenseWeights,
                   workspace: torch.Tensor) -> None:
    """B1's first four launches: y_1..y_4 into `workspace` [B,H,W,4g],
    each counted in fused_dense_block.launches. The dense block's
    backward (ops/dense_trunk_train.py) recomputes them with it; callers
    have validated the CUDA tensors."""
    b, h, w, c = x.shape
    g = weights[0][0].shape[-1]
    for j, (k, bb) in enumerate(weights[:4]):
        _build.conv3x3(x, c, k, bb, workspace, j * g, g, geom=(b, h, w),
                       in1=workspace, cin1=j * g, lrelu=True)
        fused_dense_block.launches += 1
