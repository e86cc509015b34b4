"""Kernel 16: the pad-once fused dense block.

Counterpart of superresolution_tpu/ops/pallas_dense.py
(fused_dense_block_pallas, pack_fused_weights), which no path of the
reference runs. One FusedDenseBlock (models/rrdbnet.py: five chained 3x3
convs with dense connectivity in the projection layout, LeakyReLU 0.2,
residual x + 0.2 * acc) on x [B, H, W, c] zero-padded by 5 ONCE, its
convs chained VALID. That equals the SAME block (B1,
ops/dense_trunk.fused_dense_block) except within 5 px of the border:
outside the image the intermediate maps hold lrelu(bias + ...), not
zero, so the two are different functions there and neither may stand in
for the other.

Weights are the reference's tap-major matrices: wx [9c, 4g+c] (x's
contributions to all five convs), w_i [9g, (4-i)g+c] (y_i's to the
convs after it), bias [4g+c] (every conv's, riding wx), from
pack_fused_weights (a JAX FusedDenseBlock subtree, as numpy) or
fused_weights_from_module (the port's FusedDenseBlock or DenseBlock).

On CUDA tensors: five launches of the shared conv engine under the
DenseStage policy (csrc/dense_valid_kernels.cu), stage j over the padded
frame's region 2 rows and 2 columns narrower than stage j-1's, y_1..y_4
in a [B, H+8, W+8, 4g] workspace; f32 sums, each y_j and the output
rounded once to x's type. Two bodies, by B1's route rule
(dense_trunk.uses_tensor_cores): bf16 with c and g multiples of 8 and
c + 4g <= 256 takes the tensor-core body (mma.sync implicit GEMMs on
each stage's K-major weights, gathered from the projection matrices by
pack_stage_weights); f32 and the other bf16 shapes take the direct body
(f32 FFMA, the matrices read in place). `launches` counts the CUDA
launches (five a call), `tc_launches` and `direct_launches` those of each
body. On CPU tensors: the plain form, which rounds where the reference's
kernel rounds (pallas_dense.py:100-123).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build, dense_trunk

PAD = 5  # one zero pad covering the five convs


def pack_fused_weights(params, c: int, g: int):
    """A FusedDenseBlock param subtree (HWIO kernels, the JAX layout) ->
    (wx, w1, w2, w3, w4, bias) as numpy, the matrices tap-major
    [9*C_in, C_out]."""
    def to_mat(k):
        k = np.asarray(k)
        return k.reshape(9 * k.shape[2], k.shape[3])

    mats = (to_mat(params["Conv_0"]["Conv_0"]["kernel"]),
            *(to_mat(params[f"proj_y{i}"]["kernel"]) for i in range(1, 5)))
    bias = np.asarray(params["Conv_0"]["Conv_0"]["bias"])
    want = [(9 * c, 4 * g + c), *((9 * g, (4 - i) * g + c)
                                  for i in range(1, 5))]
    if [m.shape for m in mats] != want or bias.shape != (4 * g + c,):
        raise ValueError(f"pack_fused_weights: matrices "
                         f"{[m.shape for m in mats]}, bias {bias.shape}; "
                         f"expected {want}, {(4 * g + c,)} for c {c}, g {g}")
    return (*mats, bias)


def fused_weights_from_module(block):
    """The same (wx, w1..w4, bias) from the port's own modules: a
    models/rrdbnet.FusedDenseBlock (its px and proj_y{i} convs), or a
    DenseBlock (conv1..conv5), mapped through models/convert._fuse_dense."""
    from superresolution_tpu_torch.models.convert import _fuse_dense

    def hwio(w):
        return w.detach().float().cpu().numpy().transpose(2, 3, 1, 0)

    if hasattr(block, "px"):
        c, g = block.features, block.growth
        tree = {"Conv_0": {"Conv_0": {
            "kernel": hwio(block.px.weight),
            "bias": block.px.bias.detach().float().cpu().numpy()}}}
        for i in range(1, 5):
            tree[f"proj_y{i}"] = {"kernel": hwio(
                getattr(block, f"proj_y{i}").weight)}
    else:
        convs = [getattr(block, f"conv{j}") for j in range(1, 6)]
        c, g = convs[4].out_channels, convs[0].out_channels
        tree = _fuse_dense([hwio(m.weight) for m in convs],
                           [m.bias.detach().float().cpu().numpy()
                            for m in convs], c, g)
    return pack_fused_weights(tree, c, g)


def _growth(x: torch.Tensor, wx: torch.Tensor) -> int:
    c = x.shape[-1]
    g, rem = divmod(wx.shape[-1] - c, 4)
    if g < 1 or rem:
        raise ValueError(f"fused_dense_block_valid: wx {tuple(wx.shape)} is "
                         f"not [9*{c}, 4g+{c}]")
    return g


def _check(x, mats, bias, th) -> int:
    if x.ndim != 4:
        raise ValueError(f"fused_dense_block_valid: NHWC x expected, got "
                         f"shape {tuple(x.shape)}")
    if th < 1 or x.shape[1] % th:
        raise ValueError(f"H={x.shape[1]} not divisible by th={th}")
    c = x.shape[-1]
    g = _growth(x, mats[0])
    want = [(9 * c, 4 * g + c), *((9 * g, (4 - i) * g + c)
                                  for i in range(1, 5))]
    got = [tuple(m.shape) for m in mats]
    if got != want or tuple(bias.shape) != (4 * g + c,):
        raise ValueError(f"fused_dense_block_valid: matrices {got}, bias "
                         f"{tuple(bias.shape)}; expected {want}, "
                         f"{(4 * g + c,)}")
    return g


def _valid_conv(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 conv of NHWC v by the tap-major [9*cin, cout] m, in f32."""
    cin = v.shape[-1]
    k = m.reshape(3, 3, cin, -1).permute(3, 2, 0, 1)
    return F.conv2d(v.permute(0, 3, 1, 2).float(),
                    k.float()).permute(0, 2, 3, 1)


def fused_dense_block_valid_reference(x: torch.Tensor, wx, w1, w2, w3, w4,
                                      bias) -> torch.Tensor:
    """The plain form: pad by 5 once, five F.conv2d(padding=0) stages in
    the projection layout, each stage's f32 sum cast to x's type and the
    dense sums, lrelu and residual in x's type, where the reference's
    kernel casts. Returns [B, H, W, c]."""
    dt = x.dtype
    g = _growth(x, wx)
    mats = [m.to(dt) for m in (wx, w1, w2, w3, w4)]
    xp = F.pad(x, (0, 0, PAD, PAD, PAD, PAD))
    ps = [(_valid_conv(xp, mats[0]) + bias.float()).to(dt)]
    for i in range(1, 5):
        # y_i = lrelu(sum over the stages before it of their slice for
        # conv i+1), each stage cropped to the narrowest region
        pre = sum(ps[k][:, i - 1 - k:ps[k].shape[1] - (i - 1 - k),
                        i - 1 - k:ps[k].shape[2] - (i - 1 - k),
                        (i - 1 - k) * g:(i - k) * g]
                  for k in range(i))
        ps.append(_valid_conv(F.leaky_relu(pre, 0.2), mats[i]).to(dt))
    acc = sum(ps[k][:, 4 - k:ps[k].shape[1] - (4 - k),
                    4 - k:ps[k].shape[2] - (4 - k), (4 - k) * g:]
              for k in range(5))
    return (x + torch.tensor(0.2, dtype=dt, device=x.device) * acc).to(dt)


def pack_stage_weights(wx, w1, w2, w3, w4) -> list[torch.Tensor]:
    """The five projection matrices -> each stage's weights K-major, as
    the tensor-core body reads them: stage j's [9 * (c + (j-1)g),
    cout_j] (cout_j = g for j < 5, c for j = 5), row tap * cin_j + ci,
    its input channels x's c then y_1..y_{j-1}'s g each. Conv_j's
    columns are (j-1)g.. of wx and (j-1-i)g.. of w_i, as the direct
    body reads them in place. Plain indexing: nothing is rounded, the
    matrices keep their type."""
    c = wx.shape[0] // 9
    g = (wx.shape[1] - c) // 4
    mats = (wx, w1, w2, w3, w4)
    stages = []
    for j in range(1, 6):
        n = g if j < 5 else c
        parts = [wx.reshape(9, c, -1)[:, :, (j - 1) * g:(j - 1) * g + n]]
        for i in range(1, j):
            m = mats[i].reshape(9, g, -1)
            parts.append(m[:, :, (j - 1 - i) * g:(j - 1 - i) * g + n])
        stages.append(torch.cat(parts, 1).reshape(-1, n).contiguous())
    return stages


def fused_dense_block_valid(x: torch.Tensor, wx, w1, w2, w3, w4, bias,
                            th: int = 8, *,
                            stages: list[torch.Tensor] | None = None
                            ) -> torch.Tensor:
    """Kernel 16: the pad-once FusedDenseBlock of x [B, H, W, c] (f32 or
    bf16). Raises ValueError when H % th != 0, as the reference does; th
    changes nothing else. CPU tensors run the plain form; CUDA tensors
    launch the kernel (five stages) or raise. The matrices are cast to
    x's type, the bias to f32. `stages`: pack_stage_weights of the
    matrices in x's type, made once by a caller that calls again; without
    it a call on the tensor-core route packs them itself. Given, the
    stages override wx..w4 on the tensor-core route: only their shapes
    are checked, so a caller that changes the matrices packs again (the
    direct route reads the matrices and ignores the stages)."""
    mats = (wx, w1, w2, w3, w4)
    g = _check(x, mats, bias, th)
    if x.device.type == "cpu":
        return fused_dense_block_valid_reference(x, *mats, bias)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_dense_block_valid: the kernel takes bf16 or "
                        f"f32, got {x.dtype}")
    x = x.contiguous()
    mats = [m.to(x.dtype).contiguous() for m in mats]
    bk = bias.float().contiguous()
    _build.require_cuda(x, *mats, dtype=x.dtype,
                        name="fused_dense_block_valid")
    _build.require_cuda(bk, dtype=torch.float32,
                        name="fused_dense_block_valid")
    return dense_valid_launches(x, mats, bk, g, stages)


def dense_valid_launches(x: torch.Tensor, mats, bias: torch.Tensor, g: int,
                         stages: list[torch.Tensor] | None = None
                         ) -> torch.Tensor:
    """Kernel 16's five launches by the route rule, counted: on the
    tensor-core body with the stages' K-major weights (packed here when
    not given), else on the direct body with the matrices. Callers have
    validated x, mats and bias (fused_dense_block_valid)."""
    b, h, w, c = x.shape
    ws = torch.empty((b, h + 8, w + 8, 4 * g), dtype=x.dtype,
                     device=x.device)
    out = torch.empty_like(x)
    op = fused_dense_block_valid
    if not dense_trunk.uses_tensor_cores(x, c, g):
        for j in range(1, 6):
            _build.dense_valid_stage(x, ws, out, mats, bias, j)
            op.launches += 1
            op.direct_launches += 1
        return out
    if stages is None:
        stages = pack_stage_weights(*mats)
    want = [(9 * (c + (j - 1) * g), g if j < 5 else c) for j in range(1, 6)]
    if [tuple(s.shape) for s in stages] != want:
        raise ValueError(f"fused_dense_block_valid: stages "
                         f"{[tuple(s.shape) for s in stages]}, expected "
                         f"{want} (pack_stage_weights)")
    _build.require_cuda(*stages, dtype=x.dtype, name="fused_dense_block_valid")
    for j in range(1, 6):
        _build.dense_valid_tc(x, ws, out, stages[j - 1], bias, j)
        op.launches += 1
        op.tc_launches += 1
    return out


fused_dense_block_valid.launches = 0         # CUDA launches, five a call
fused_dense_block_valid.tc_launches = 0      # by body
fused_dense_block_valid.direct_launches = 0
