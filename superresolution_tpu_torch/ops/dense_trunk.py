"""B1 and kernels 4-6: the RRDB trunk's dense blocks as hand-written CUDA
ops.

B1, one dense block.

Replaces superresolution_tpu/ops/pallas_dense_trunk.py:fused_dense_block
(the roll-conv Pallas kernel). What it computes, on NHWC x [B,H,W,c]:

    y_j = lrelu(conv_j([x, y_1..y_{j-1}]) + b_j)    j = 1..4, g channels
    out = x + 0.2 * (conv_5([x, y_1..y_4]) + b_5)
    out = residual + 0.2 * out                       (optional)

with SAME zero padding at every conv. With `seg` = (stride, valid) the
input is batch-packed (train/fused_apply.pack_batch_rows: images stacked
along H, `stride` rows apiece, the last stride - valid of them zero
spacers), as the reference's seg option (pallas_dense_trunk.py
_roll_conv3): at every conv a spacer row reads as zero padding and is
written as exactly 0, so each image sees exact SAME padding and one
spacer row suffices for the whole cascade. On the card this is five launches
over one [B,H,W,4g] workspace: conv_j reads x and the first (j-1)*g
workspace channels and writes its g channels after them; conv_5 applies
both residual epilogues. Each conv reads its input through a zero-filled
halo, so the padding is exact by construction (the trap
pallas_dense_trunk.py:19-27 records for a single border mask cannot
arise). uses_tensor_cores is the route rule: bf16 with C and g multiples
of 8 and C + 4g <= 256 (every model's 64 / 32) runs the conv engine's
tensor-core body under the DenseConv policy (csrc/dense_kernels.cu, a
bf16 implicit GEMM on mma.sync); f32 activations (precision "fp32") the
engine's direct body under the same policy (f32 FFMA, no rounding); any
other bf16 shape the direct conv of csrc/sr_kernels.cu (f32 FFMA on the
CUDA cores). All compute the same function (f32 sums, bias and
epilogue, one rounding), and each launch counts on `launches` and on its
body's count (`tc_launches`, `direct_launches`: the two direct forms).

Bound on the H100 at the main-path shape x [24,376,256,64] bf16: 239,616
MACs per pixel, 1.11 TFLOP per call -> 1.12 ms at 989 TFLOP/s, against
0.27 ms for its ~0.9 GB of x, residual and output; bound by operations.

Kernels 4-6, the levers of the trunk (infer/fused_trunk.make_fused_trunk
fold_ends / chain_rrdb):
  4 fused_dense_block_prologue (replaces ops/pallas_dense_trunk.py:
    fused_dense_block_prologue): head = conv_first(x_raw), out = B1(head);
  5 fused_dense_block_epilogue (replaces fused_dense_block_epilogue):
    trunk_conv(residual + 0.2 * B1(x)) + head;
  6 fused_rrdb (replaces fused_rrdb / _rrdb_kernel): one whole RRDB,
    x + 0.2 * B1(B1(B1(x))).
All three take B1's route rule. On the tensor-core route kernel 4 is six
launches of the conv engine (prologue_launches): conv_first on its direct
body (csrc/dense_kernels.cu dense_first_conv: x_raw's Cin of 3, 4, 12 or
48 channels are not the 16-byte runs the tensor-core body stages), then
B1's five tensor-core launches on head; kernel 5 is six tensor-core
launches (epilogue_launches): B1's five with the residual, then
trunk_conv as DenseConv reading their output alone, its epilogue adding
head. Kernel 6 is rrdb_tc_kernel (csrc/dense_kernels.cu), persistent
blocks that walk B1's fifteen launches as stages through the conv
engine's tile body under B1's DenseConv policy, so it computes exactly
what three B1 calls do. Other shapes run each kernel as ONE cooperative
launch of conv_chain_kernel (csrc/sr_kernels.cu, f32 FFMA): its conv
stages in order, each over the whole tensor, separated by grid-wide
barriers. `launches` counts calls; `tc_launches` and `direct_launches`
count each call's launches by body (conv_chain_kernel's as direct), and
kernels 4 and 5's inner B1 launches count there, not on B1's counts.
SAME zero padding at every conv, f32 accumulation, lrelu 0.2 and the
x0.2 residuals in the reference's order. Bounds at the main-path shape
(operations, 989 TFLOP/s): kernel 6 does 3 x 239,616 MACs per pixel,
3.36 ms at [24,376,256,64]; kernel 4 B1's plus 9 * Cin * 64 (1,728 at
Cin 3), kernel 5 B1's plus 36,864.

Weights: five (kernel [3,3,cin_j,cout_j] HWIO, bias [cout_j] f32) pairs
(dense_weights), from a BasicSR-keyed state dict or from the JAX
package's projection-layout params through models/convert._unfuse_dense;
a conv around the blocks is one such pair.
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


Seg = tuple[int, int]

# The tensor-core body stages C + 4g channels of each input pixel.
TC_MAX_CIN = 256


def uses_tensor_cores(x: torch.Tensor, c: int, g: int) -> bool:
    """The route rule: B1's five convs run the conv engine's tensor-core
    body when x is bf16, C and g are multiples of 8 (every staged run of
    8 channels is 16 bytes from one source) and C + 4g <= TC_MAX_CIN;
    every other shape runs the direct conv. It routes by shape alone."""
    return (x.dtype == torch.bfloat16 and c % 8 == 0 and g % 8 == 0
            and c + 4 * g <= TC_MAX_CIN)


def on_engine(x: torch.Tensor, c: int, g: int) -> bool:
    """True where B1's launch goes to the conv engine (dense_kernels.cu
    dense_conv): its tensor-core body (uses_tensor_cores) or, for f32
    activations, its direct body; False for sr_kernels.cu's conv3x3
    (bf16 shapes off the route rule)."""
    return x.dtype == torch.float32 or uses_tensor_cores(x, c, g)


def image_rows(h: int, seg: Seg | None,
               device: torch.device | str | None = None) -> torch.Tensor:
    """[h] bool: True on the image rows of an H = h map packed with `seg`
    = (stride, valid) (row y is an image row when y % stride < valid);
    all True without seg."""
    y = torch.arange(h, device=device)
    if seg is None:
        return torch.ones(h, dtype=torch.bool, device=device)
    return y % seg[0] < seg[1]


def check_seg(seg: Seg | None) -> None:
    if seg is not None and not (len(seg) == 2 and seg[0] >= 1
                                and 1 <= seg[1] <= seg[0]):
        raise ValueError(f"seg must be (stride, valid) with 1 <= valid <= "
                         f"stride, got {seg}")


def fused_dense_block_reference(x: torch.Tensor, weights: DenseWeights,
                                residual: torch.Tensor | None = None,
                                workspace: torch.Tensor | None = None,
                                seg: Seg | None = None) -> torch.Tensor:
    """Plain PyTorch version of B1 (F.conv2d per conv), NHWC in and out.
    A `workspace` [B,H,W,4g] receives y_1..y_4, as the kernel's does.
    With `seg`, the masked per-stage chain: the input and every y_j are
    zeroed on spacer rows before a conv reads them, and the output is
    zeroed there."""
    check_seg(seg)
    xc = x.permute(0, 3, 1, 2)
    keep = None
    if seg is not None:
        keep = image_rows(x.shape[1], seg, x.device).to(x.dtype)[:, None]
    feats = [xc if keep is None else xc * keep]
    for j, (w, b) in enumerate(weights):
        y = F.conv2d(torch.cat(feats, 1), w.permute(3, 2, 0, 1).to(x.dtype),
                     b.to(x.dtype), padding=1)
        if j < 4:
            a = F.leaky_relu(y, 0.2)
            feats.append(a if keep is None else a * keep)
    if workspace is not None:
        workspace.copy_(torch.cat(feats[1:], 1).permute(0, 2, 3, 1))
    out = xc + y * 0.2
    if residual is not None:
        out = residual.permute(0, 3, 1, 2) + out * 0.2
    if keep is not None:
        out = out * keep
    return out.permute(0, 2, 3, 1).contiguous()


def fused_dense_block(x: torch.Tensor, weights: DenseWeights,
                      residual: torch.Tensor | None = None,
                      workspace: torch.Tensor | None = None,
                      seg: Seg | None = None) -> torch.Tensor:
    """B1. CPU tensors run the plain version; CUDA tensors launch the
    kernel (bf16 or f32 activations and kernels of one type, f32 biases;
    the body uses_tensor_cores and the type pick) or raise. The
    kernel writes y_1..y_4 into `workspace` [B,H,W,4g] when one is given
    (so a check can read them), else into a fresh one. seg: (stride,
    valid) of a batch-packed x, or None."""
    if x.device.type == "cpu":
        return fused_dense_block_reference(x, weights, residual, workspace,
                                           seg)
    check_seg(seg)
    if len(weights) != 5:
        raise ValueError(f"expected 5 (kernel, bias) pairs, got {len(weights)}")
    b, h, w, c = x.shape
    g = weights[0][0].shape[-1]
    _build.require_cuda(x, residual, workspace, *(k for k, _ in weights),
                        dtype=_build.activation_dtype(x, "fused_dense_block"),
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
    dense_block_launches(x, weights, residual, ws, out, seg)
    return out


fused_dense_block.launches = 0
fused_dense_block.seg_launches = 0  # those of them with seg
fused_dense_block.tc_launches = 0   # by body
fused_dense_block.direct_launches = 0


def dense_block_launches(x: torch.Tensor, weights: DenseWeights,
                         residual: torch.Tensor | None,
                         workspace: torch.Tensor, out: torch.Tensor,
                         seg: Seg | None = None) -> None:
    """B1's five launches into `workspace` and `out`, each counted in
    fused_dense_block.launches, its body's count (and, with seg, in its
    seg_launches); callers have validated the CUDA tensors."""
    b, h, w, c = x.shape
    dense_features(x, weights, workspace, seg)
    k, bb = weights[4]
    n_ws = workspace.shape[-1]
    g = weights[0][0].shape[-1]
    tc = uses_tensor_cores(x, c, g)
    if on_engine(x, c, g):
        _dense_conv(engine_steps(x, weights, residual, workspace, out,
                                 seg)[4])
    else:
        _build.conv3x3(x, c, k, bb, out, 0, c, geom=(b, h, w),
                       in1=workspace, cin1=n_ws, xres=x, res=residual,
                       **seg_kw(seg))
    _count(tc, seg)


def _count(tc: bool, seg: Seg | None) -> None:
    fused_dense_block.launches += 1
    fused_dense_block.seg_launches += seg is not None
    if tc:
        fused_dense_block.tc_launches += 1
    else:
        fused_dense_block.direct_launches += 1


def seg_kw(seg: Seg | None) -> dict:
    """The launch helpers' seg keyword, given only for packed maps."""
    return {} if seg is None else {"seg": tuple(seg)}


def engine_steps(x: torch.Tensor, weights: DenseWeights,
                 residual: torch.Tensor | None, workspace: torch.Tensor,
                 out: torch.Tensor | None,
                 seg: Seg | None = None) -> list[dict]:
    """B1's five launches on the conv engine (csrc/dense_kernels.cu
    DenseConv), as _build.dense_conv's keyword arguments: conv_j (j < 4)
    reads x and the workspace's first j*g channels and writes y_j =
    lrelu(v) at workspace channel j*g; conv_5 reads x and all 4g and
    writes x + 0.2 v, then residual + 0.2 that, into out."""
    g = workspace.shape[-1] // 4
    steps = [dict(x=x, ws=workspace, cin1=j * g, w=k, bias=bb,
                  out=workspace, out_off=j * g, lrelu=True, **seg_kw(seg))
             for j, (k, bb) in enumerate(weights[:4])]
    k, bb = weights[4]
    steps.append(dict(x=x, ws=workspace, cin1=4 * g, w=k, bias=bb, out=out,
                      out_off=0, xres=x, res=residual, **seg_kw(seg)))
    return steps


def _dense_conv(step: dict) -> None:
    """_build.dense_conv on one of engine_steps' launches, its leading
    arguments positional as the helper's signature has them."""
    kw = dict(step)
    args = [kw.pop(k) for k in ("x", "ws", "cin1", "w", "bias", "out",
                                "out_off")]
    _build.dense_conv(*args, **kw)


def dense_features(x: torch.Tensor, weights: DenseWeights,
                   workspace: torch.Tensor, seg: Seg | None = None) -> None:
    """B1's first four launches: y_1..y_4 into `workspace` [B,H,W,4g],
    each counted in fused_dense_block.launches and its body's count. The
    dense block's backward (ops/dense_trunk_train.py) recomputes them with
    it; callers have validated the CUDA tensors."""
    b, h, w, c = x.shape
    g = weights[0][0].shape[-1]
    tc = uses_tensor_cores(x, c, g)
    engine = on_engine(x, c, g)
    steps = engine_steps(x, weights, None, workspace, None, seg)
    for j, (k, bb) in enumerate(weights[:4]):
        if engine:
            _dense_conv(steps[j])
        else:
            _build.conv3x3(x, c, k, bb, workspace, j * g, g, geom=(b, h, w),
                           in1=workspace, cin1=j * g, lrelu=True,
                           **seg_kw(seg))
        _count(tc, seg)


def _conv(x: torch.Tensor, w: tuple[torch.Tensor, torch.Tensor]
          ) -> torch.Tensor:
    """3x3 SAME conv of NHWC x with an HWIO (kernel, bias) pair, in x's
    dtype."""
    k, b = w
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(x.dtype),
                 b.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _check_pair(name: str, w, cin: int, cout: int) -> None:
    k, b = w
    if tuple(k.shape) != (3, 3, cin, cout) or tuple(b.shape) != (cout,):
        raise ValueError(f"{name}: conv kernel {tuple(k.shape)} / bias "
                         f"{tuple(b.shape)}, expected {(3, 3, cin, cout)}")


def _check_block(name: str, x: torch.Tensor, weights: DenseWeights) -> int:
    """Validate one dense block's weights for x; returns the growth g."""
    if len(weights) != 5:
        raise ValueError(f"{name}: expected 5 (kernel, bias) pairs, got "
                         f"{len(weights)}")
    c = x.shape[-1]
    g = weights[0][0].shape[-1]
    for j, w in enumerate(weights):
        _check_pair(f"{name} conv{j + 1}", w, c + j * g, g if j < 4 else c)
    return g


def _require(name: str, acts, pairs) -> None:
    _build.require_cuda(*acts, *(k for k, _ in pairs), name=name)
    _build.require_cuda(*(b for _, b in pairs), dtype=torch.float32,
                        name=name)


def fused_dense_block_prologue_reference(x_raw: torch.Tensor, head_w,
                                         weights: DenseWeights):
    """Plain PyTorch version of kernel 4: (B1(head), head) with head =
    conv_first(x_raw)."""
    head = _conv(x_raw, head_w)
    return fused_dense_block_reference(head, weights), head


def fused_dense_block_prologue(x_raw: torch.Tensor, head_w,
                               weights: DenseWeights):
    """Kernel 4 on x_raw [B,H,W,Cin] (the trunk's raw input after any
    pixel unshuffle): -> (out, head), both [B,H,W,C]. head_w: conv_first's
    (kernel [3,3,Cin,C], bias); weights: dense block 0's. CPU tensors run
    the plain version; CUDA tensors launch the kernel (bf16 activations
    and kernels, f32 biases; the route uses_tensor_cores picks) or
    raise."""
    if x_raw.device.type == "cpu":
        return fused_dense_block_prologue_reference(x_raw, head_w, weights)
    b, h, w, cin = x_raw.shape
    c = head_w[0].shape[-1]
    _check_pair("fused_dense_block_prologue conv_first", head_w, cin, c)
    head = torch.empty((b, h, w, c), dtype=x_raw.dtype, device=x_raw.device)
    g = _check_block("fused_dense_block_prologue", head, weights)
    _require("fused_dense_block_prologue", [x_raw], [head_w, *weights])
    out = torch.empty_like(head)
    ws = torch.empty((b, h, w, 4 * g), dtype=x_raw.dtype,
                     device=x_raw.device)
    prologue_launches(x_raw, head_w, weights, ws, out, head)
    return out, head


fused_dense_block_prologue.launches = 0         # calls
fused_dense_block_prologue.tc_launches = 0      # engine launches by body
fused_dense_block_prologue.direct_launches = 0  # (and conv_chain_kernel)


def _run(op, steps: list[tuple[str, dict]]) -> None:
    """Launches each (_build helper, keyword arguments) step in order,
    counting dense_conv's on op.tc_launches and first_conv's on
    op.direct_launches."""
    for helper, kw in steps:
        if helper == "dense_conv":
            _dense_conv(kw)
            op.tc_launches += 1
        else:
            getattr(_build, helper)(**kw)
            op.direct_launches += 1


def _plant(steps: list[tuple[str, dict]], plant: int, drop: str) -> None:
    """The faults a check plants in a launch sequence (_build's bits):
    PLANT_NO_RESIDUAL drops the last launch's `drop` term,
    PLANT_SWAP_STAGES swaps the first two launches."""
    if plant & _build.PLANT_NO_RESIDUAL:
        steps[-1][1][drop] = None
    if plant & _build.PLANT_SWAP_STAGES:
        steps[0], steps[1] = steps[1], steps[0]


def prologue_launches(x_raw: torch.Tensor, head_w, weights: DenseWeights,
                      ws: torch.Tensor, out: torch.Tensor,
                      head: torch.Tensor, plant: int = 0) -> None:
    """Kernel 4's launches into `head` and `out`, counted once in
    fused_dense_block_prologue.launches and, by body, in its tc_launches
    / direct_launches (never in B1's counts); callers have validated the
    CUDA tensors. On the route uses_tensor_cores(head) takes: conv_first
    on the conv engine's direct body (_build.first_conv: x_raw's Cin
    channels are not 16-byte runs), then B1's five tensor-core launches
    on head. Elsewhere one launch of conv_chain_kernel
    (_build.dense_prologue). plant: 0 in use (see _plant and
    _build.PLANT_HALO_CLAMPED)."""
    op = fused_dense_block_prologue
    c, g = head.shape[-1], ws.shape[-1] // 4
    if uses_tensor_cores(x_raw, c, g):
        k, bb = head_w
        steps = [("first_conv", dict(
            x_raw=x_raw, w=k, bias=bb, out=head,
            plant=plant & _build.PLANT_HALO_CLAMPED))]
        steps += [("dense_conv", st)
                  for st in engine_steps(head, weights, None, ws, out)]
        _plant(steps, plant, "xres")
        _run(op, steps)
    else:
        _build.dense_prologue(x_raw, head_w, weights, ws, out, head, plant)
        op.direct_launches += 1
    op.launches += 1


def fused_dense_block_epilogue_reference(x: torch.Tensor,
                                         weights: DenseWeights,
                                         residual: torch.Tensor, trunk_w,
                                         head: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 5: trunk_conv(B1(x, residual)) +
    head."""
    return _conv(fused_dense_block_reference(x, weights, residual),
                 trunk_w) + head


def fused_dense_block_epilogue(x: torch.Tensor, weights: DenseWeights,
                               residual: torch.Tensor, trunk_w,
                               head: torch.Tensor) -> torch.Tensor:
    """Kernel 5 on x, residual, head [B,H,W,C]: trunk_conv(residual + 0.2
    * block(x)) + head, the last RRDB's third block, its residual, the
    trunk conv and the global residual. CPU tensors run the plain
    version; CUDA tensors launch the kernel (the route uses_tensor_cores
    picks) or raise."""
    if x.device.type == "cpu":
        return fused_dense_block_epilogue_reference(x, weights, residual,
                                                    trunk_w, head)
    b, h, w, c = x.shape
    g = _check_block("fused_dense_block_epilogue", x, weights)
    _check_pair("fused_dense_block_epilogue trunk_conv", trunk_w, c, c)
    if residual.shape != x.shape or head.shape != x.shape:
        raise ValueError("fused_dense_block_epilogue: residual "
                         f"{tuple(residual.shape)} / head "
                         f"{tuple(head.shape)} != x {tuple(x.shape)}")
    _require("fused_dense_block_epilogue", [x, residual, head],
             [*weights, trunk_w])
    ws = torch.empty((b, h, w, 4 * g), dtype=x.dtype, device=x.device)
    feat, out = torch.empty_like(x), torch.empty_like(x)
    epilogue_launches(x, weights, residual, trunk_w, head, ws, feat, out)
    return out


fused_dense_block_epilogue.launches = 0         # calls
fused_dense_block_epilogue.tc_launches = 0      # engine launches by body
fused_dense_block_epilogue.direct_launches = 0  # (and conv_chain_kernel)


def epilogue_launches(x: torch.Tensor, weights: DenseWeights,
                      residual: torch.Tensor, trunk_w, head: torch.Tensor,
                      ws: torch.Tensor, feat: torch.Tensor,
                      out: torch.Tensor, plant: int = 0) -> None:
    """Kernel 5's launches into `feat` (the block's output) and `out`,
    counted once in fused_dense_block_epilogue.launches and, by body, in
    its tc_launches / direct_launches (never in B1's counts); callers have
    validated the CUDA tensors. On the route uses_tensor_cores(x) takes:
    B1's five tensor-core launches with the residual into feat, then
    trunk_conv as one more (DenseConv reading feat alone, its epilogue
    adding head). Elsewhere one launch of conv_chain_kernel
    (_build.dense_epilogue). plant: 0 in use (see _plant)."""
    op = fused_dense_block_epilogue
    if uses_tensor_cores(x, x.shape[-1], ws.shape[-1] // 4):
        k, bb = trunk_w
        steps = [("dense_conv", st)
                 for st in engine_steps(x, weights, residual, ws, feat)]
        steps.append(("dense_conv", dict(x=feat, ws=None, cin1=0, w=k,
                                         bias=bb, out=out, out_off=0,
                                         add=head)))
        _plant(steps, plant, "add")
        _run(op, steps)
    else:
        _build.dense_epilogue(x, weights, residual, trunk_w, head, ws, feat,
                              out, plant)
        op.direct_launches += 1
    op.launches += 1


def fused_rrdb_reference(x: torch.Tensor, w0: DenseWeights,
                         w1: DenseWeights, w2: DenseWeights) -> torch.Tensor:
    """Plain PyTorch version of kernel 6: three B1s, the RRDB residual in
    the third."""
    y = fused_dense_block_reference(x, w0)
    y = fused_dense_block_reference(y, w1)
    return fused_dense_block_reference(y, w2, residual=x)


def fused_rrdb(x: torch.Tensor, w0: DenseWeights, w1: DenseWeights,
               w2: DenseWeights) -> torch.Tensor:
    """Kernel 6 on x [B,H,W,C]: x + 0.2 * B1(B1(B1(x))) with the three
    blocks' weights. CPU tensors run the plain version; CUDA tensors
    launch the kernel (the body uses_tensor_cores picks) or raise."""
    if x.device.type == "cpu":
        return fused_rrdb_reference(x, w0, w1, w2)
    g = {_check_block(f"fused_rrdb block {i}", x, ws)
         for i, ws in enumerate((w0, w1, w2))}
    if len(g) != 1:
        raise ValueError(f"fused_rrdb: blocks of growths {sorted(g)}")
    g = g.pop()
    b, h, w, c = x.shape
    _require("fused_rrdb", [x], [*w0, *w1, *w2])
    ws = torch.empty((b, h, w, 4 * g), dtype=x.dtype, device=x.device)
    tmp, out = torch.empty_like(x), torch.empty_like(x)
    rrdb_launch(x, [*w0, *w1, *w2], ws, tmp, out)
    return out


fused_rrdb.launches = 0
fused_rrdb.tc_launches = 0   # by body
fused_rrdb.direct_launches = 0


def rrdb_launch(x: torch.Tensor, weights: DenseWeights, ws: torch.Tensor,
                tmp: torch.Tensor, out: torch.Tensor) -> None:
    """Kernel 6's one launch into `out` on the body uses_tensor_cores
    picks, counted in fused_rrdb.launches and its body's count; callers
    have validated the CUDA tensors."""
    tc = uses_tensor_cores(x, x.shape[-1], ws.shape[-1] // 4)
    (_build.rrdb_tc if tc else _build.rrdb)(x, weights, ws, tmp, out)
    fused_rrdb.launches += 1
    if tc:
        fused_rrdb.tc_launches += 1
    else:
        fused_rrdb.direct_launches += 1
