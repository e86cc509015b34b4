"""Kernels 7 and 8: the HAT stage's CAB conv stack and HAB block body as
hand-written CUDA ops.

Kernel 7, fused_cab_convs, replaces superresolution_tpu/ops/pallas_hab.py:
fused_cab_convs (_cab_kernel). On NHWC x [B,H,W,C] it computes the CAB's
conv stack before its squeeze-excite:

    y   = LN(x)                      f32 statistics over C (divided by
                                     c_real on a lane-padded map), bf16
    hid = GELU(conv3x3(y) + b1)      C -> C/3, exact erf, stored bf16
    out = conv3x3(hid) + b2          C/3 -> C

with SAME zero padding on y and on hid (not on x: outside the image
conv1 sees 0, not LN(0) = ln bias). Two bodies, by the route rule
(uses_tensor_cores): bf16 x with C and the hidden width multiples of 8
(C <= 128, hidden <= 64) takes one launch of cab_tc_kernel
(csrc/cab_kernels.cu), which keeps LN(x) and the hidden map of a tile
and its halo in shared memory and runs both convs as implicit GEMMs on
the tensor cores, reading the conv kernels packed once in fragment
order (cab_mma_weights); every other width takes three launches:
layernorm_kernel (csrc/hat_kernels.cu) and two of the shared
conv3x3_kernel (csrc/sr_kernels.cu), the first with the GELU epilogue,
each conv reading its input through a zero halo. `launches` counts
calls; `tc_launches` and `direct_launches` the CUDA launches of each
body.

Kernel 8, fused_hab_block, replaces ops/pallas_hab.py: fused_hab_block /
fused_hab_block_inference (_fused_fwd_impl, _kernel, _body). On windows
x, cab [nb, n, C] (cab already scaled by conv_scale, in x's roll and
partition layout):

    y  = LN1(x); q, k, v = y Wqkv + bqkv
    a  = per head softmax(q k^T hd^-1/2 + rpb[h] (+ -1e9 off-region)) v
    x1 = x + (a Wp + bp) + cab
    out = x1 + (GELU(LN2(x1) W1 + b1) W2 + b2)

one launch of hab_kernel, one thread block per window, at each
geometry of HAB_GEOMETRIES, with its four GEMMs on the tensor cores
(mma.sync on the dense kernels packed once in fragment order: pack_mma,
mma_weights) and its attention on the shared online softmax of
csrc/flash_tc.cuh. Window b uses region_ids[b % nW_img]. Both
LNs divide their sums by c_real where it is given: the lane-padded
deploy map (infer/lane_pad.py) keeps zeros in the lanes past the model's
channels, so only the divisor differs (the reference's _ln(..., c_real),
fused_hab_block_inference). The kernels round to bf16 where the
reference rounds; the plain versions here repeat that rounding, with
f32 accumulation, and serve the CPU path and the checks on the card.

Kernel 12, fused_cab_convs_pair, replaces ops/pallas_hab.py:
fused_cab_convs_pair (_cab_pair_kernel): kernel 7's function with the LN
divided by C, for an even W. The reference's pair view and its
pair-packed tap matrices (cab_pair_weights) fill the TPU's MXU; mma.sync
needs neither, so kernel 12 is one launch of kernel 7's tensor-core body
(cab_tc_kernel) on kernel 7's weights packed once (cab_weights or
cab_mma_weights), at the shapes of kernel 7's route rule only, counted on
its own `launches`. Like the reference's, it has no caller on any path.

Bounds on the H100 (see csrc/hat_kernels.cu): the CAB (kernels 7 and
12) does 55,296 MACs per pixel for 384 bytes of x and out, the HAB
86,016 MACs per token for 576 bytes of x, cab and out. Both sit at the
bf16 ridge: the CAB is bound by bytes and the HAB by operations, each by
a few percent. The one-launch CAB body (kernels 7 and 12) and kernel 8
run their products on the tensor cores; kernel 7's three-launch body
runs on the CUDA cores in f32, so operations bound it.

Weights: cab_weights and hab_weights read the port's HAT-keyed state
dict (models/hat_lite.py), as the reference's cab_weights and
fused_hat._wa_weights read the flax tree, and pack the dense and conv
kernels for the tensor-core bodies once (cab_mma_weights,
mma_weights).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.infer.common import hwio
from superresolution_tpu_torch.models.hat_lite import relative_position_index
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops._build import HAB_DENSE, HAB_WEIGHTS
from superresolution_tpu_torch.ops.window_attention import (
    reference_window_attention,
)

EPS = 1e-5
# the geometries kernel 8 is instantiated for: (C, heads, tokens n, MLP
# hidden) of 8x8 and 16x16 windows at embed 96, of hybrid_astro_h200's
# embed 120 (head dim 20), and of embed 96 lane-padded to 128 (8 heads of
# 16, the MLP hidden unpadded: infer/lane_pad.py)
HAB_GEOMETRIES = ((96, 6, 64, 192), (96, 6, 256, 192), (120, 6, 256, 240),
                  (128, 8, 64, 192))
# the widest C and hidden width kernel 7's tensor-core body takes (its LN
# runs a pixel on a half-warp of 8 channels a lane; conv1 keeps hidden / 8
# fragments a warp)
CAB_TC_MAX_C, CAB_TC_MAX_MID = 128, 64

__all__ = ["HAB_WEIGHTS", "cab_mma_weights",
           "cab_weights", "fused_cab_convs", "fused_cab_convs_pair",
           "fused_cab_convs_pair_reference", "fused_cab_convs_reference",
           "fused_hab_block", "hab_body_reference", "hab_weights",
           "layer_norm"]


def layer_norm(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
               c_real: int | None = None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics (mean of squares
    minus squared mean, as the reference), returned in x's dtype. With
    c_real (a lane-padded x whose lanes past c_real are zero) the sums
    run over every lane and are divided by c_real."""
    xf = x.float()
    if c_real is None or c_real == xf.shape[-1]:
        mu = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    else:
        inv = 1.0 / c_real
        mu = xf.sum(-1, keepdim=True) * inv
        var = (xf * xf).sum(-1, keepdim=True) * inv - mu * mu
    return ((xf - mu) * torch.rsqrt(var + EPS) * s.float()
            + b.float()).to(x.dtype)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def cab_weights(params: Mapping[str, torch.Tensor], pre: str,
                dtype: torch.dtype = torch.bfloat16) -> list[torch.Tensor]:
    """HAB `pre` (layers.{g}.residual_group.blocks.{i}) of a HAT-keyed
    state dict -> [ln_s, ln_b, k1, b1, k2, b2]: HWIO kernels in `dtype`,
    LN parameters and biases in f32; then, where the tensor-core body can
    take the widths, k1 and k2 packed for it (cab_mma_weights)."""
    cab = f"{pre}.conv_block.cab"
    return cab_mma_weights([
        _f32(params[f"{pre}.norm1.weight"]),
        _f32(params[f"{pre}.norm1.bias"]),
        hwio(params[f"{cab}.0.weight"].detach()).to(dtype),
        _f32(params[f"{cab}.0.bias"]),
        hwio(params[f"{cab}.2.weight"].detach()).to(dtype),
        _f32(params[f"{cab}.2.bias"])])


def pack_conv_mma(k: torch.Tensor) -> torch.Tensor:
    """A 3x3 HWIO kernel k [3, 3, ci, co] (co a multiple of 8) in the
    tensor-core body's fragment order, each tap's ci zero-padded to a
    multiple of 16 (so a k-step never spans two taps): pack_mma of the
    K-major [9 * ci16, co], [9 * ci16 / 16, co / 8, 32, 4]."""
    ci = k.shape[2]
    cp = -(-ci // 16) * 16
    kp = F.pad(k, (0, 0, 0, cp - ci))
    return pack_mma(kp.reshape(9 * cp, k.shape[3]))


def cab_mma_weights(weights: list[torch.Tensor]) -> list[torch.Tensor]:
    """Kernel 7's weights [ln_s, ln_b, k1, b1, k2, b2] with k1 and k2
    packed for its tensor-core body (pack_conv_mma) appended, replacing
    any packing present; the six alone where the widths are not multiples
    of 8 (no launch of that body takes them). cab_weights calls it once;
    a caller that builds or changes k1 or k2 itself calls it again."""
    w = list(weights[:6])
    c, mid = w[2].shape[2], w[2].shape[3]
    if c % 8 or mid % 8:
        return w
    return w + [pack_conv_mma(w[2]), pack_conv_mma(w[4])]


def uses_tensor_cores(x: torch.Tensor, mid: int) -> bool:
    """Kernel 7's route rule: bf16 x with C and the hidden width `mid`
    multiples of 8 (every staged run of 8 channels is 16 bytes), C <=
    CAB_TC_MAX_C and mid <= CAB_TC_MAX_MID takes the one-launch
    tensor-core body; every other shape the three launches."""
    c = x.shape[-1]
    return (x.dtype == torch.bfloat16 and c % 8 == 0 and mid % 8 == 0
            and c <= CAB_TC_MAX_C and mid <= CAB_TC_MAX_MID)


def _conv_f32(x: torch.Tensor, k: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of NHWC x with an HWIO kernel, in f32."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 k.float().permute(3, 2, 0, 1), b.float(), padding=1)
    return y.permute(0, 2, 3, 1)


def fused_cab_convs_reference(x: torch.Tensor, weights: list[torch.Tensor],
                              hidden: torch.Tensor | None = None,
                              c_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel 7: LN -> conv -> GELU -> conv in
    f32, rounded to x's dtype after LN, after GELU and at the output. A
    `hidden` [B,H,W,C/3] receives the GELU map, as the kernel's does."""
    ln_s, ln_b, k1, b1, k2, b2 = weights[:6]
    dt = x.dtype
    y = layer_norm(x, ln_s, ln_b, c_real)
    hid = F.gelu(_conv_f32(y, k1, b1)).to(dt)
    if hidden is not None:
        hidden.copy_(hid)
    return _conv_f32(hid, k2, b2).to(dt).contiguous()


def _check_cab_weights(name: str, x: torch.Tensor,
                       weights: list[torch.Tensor]) -> int:
    """Raise unless `weights` fit x's C and lie on x's CUDA device in
    the kernels' types; returns the hidden width."""
    ln_s, ln_b, k1, b1, k2, b2 = weights[:6]
    c = x.shape[-1]
    mid = k1.shape[-1]
    if (tuple(k1.shape) != (3, 3, c, mid) or tuple(k2.shape) != (3, 3, mid, c)
            or ln_s.shape != (c,) or ln_b.shape != (c,)
            or b1.shape != (mid,) or b2.shape != (c,)):
        raise ValueError(f"{name}: weight shapes "
                         f"{[tuple(t.shape) for t in weights]} do not fit "
                         f"C={c}")
    _build.require_cuda(x, k1, k2, name=name)
    _build.require_cuda(ln_s, ln_b, b1, b2, dtype=torch.float32, name=name)
    return mid


def fused_cab_convs(x: torch.Tensor, weights: list[torch.Tensor],
                    hidden: torch.Tensor | None = None,
                    c_real: int | None = None) -> torch.Tensor:
    """Kernel 7. CPU tensors run the plain version; CUDA tensors launch
    the kernels (bf16 x and kernels, f32 LN parameters and biases) or
    raise: one launch of the tensor-core body where uses_tensor_cores
    holds (weights packed by cab_weights or cab_mma_weights), else three
    (cab_launches). The GELU hidden map goes into `hidden` [B,H,W,C/3]
    when one is given (so a check can read it). c_real: the LN's divisor
    on a lane-padded x (default C)."""
    if x.device.type == "cpu":
        return fused_cab_convs_reference(x, weights, hidden, c_real)
    b, h, w, c = x.shape
    mid = _check_cab_weights("fused_cab_convs", x, weights)
    if c_real is not None and not 0 < c_real <= c:
        raise ValueError(f"fused_cab_convs: c_real {c_real} not in 1..{c}")
    _build.require_cuda(hidden, name="fused_cab_convs")
    if hidden is not None and hidden.shape != (b, h, w, mid):
        raise ValueError("fused_cab_convs: hidden shape "
                         f"{tuple(hidden.shape)} != {(b, h, w, mid)}")
    out = torch.empty_like(x)
    cab_launches(x, weights, out, hidden, c_real)
    return out


def _check_packed(name: str, weights: list[torch.Tensor]) -> None:
    """Raise unless k1 and k2 come packed for the tensor-core body
    (cab_weights or cab_mma_weights) as CUDA bf16 tensors."""
    k1, k2 = weights[2], weights[4]
    if len(weights) != 8 or any(
            tuple(packed.shape) != (9 * -(-k.shape[2] // 16),
                                    k.shape[3] // 8, 32, 4)
            for packed, k in zip(weights[6:], (k1, k2))):
        raise ValueError(f"{name}: k1, k2 not packed for the tensor-core "
                         "body (cab_weights or cab_mma_weights)")
    _build.require_cuda(*weights[6:], name=name)


def cab_launches(x: torch.Tensor, weights: list[torch.Tensor],
                 out: torch.Tensor, hidden: torch.Tensor | None = None,
                 c_real: int | None = None) -> None:
    """Kernel 7's launches into `out` by the route rule, counted: one
    call on fused_cab_convs.launches, its CUDA launches on the body's
    count. Callers have validated x, weights and hidden (fused_cab_convs);
    the packing is checked here."""
    ln_s, ln_b, k1, b1, k2, b2 = weights[:6]
    b, h, w, c = x.shape
    mid = k1.shape[-1]
    if uses_tensor_cores(x, mid):
        _check_packed("fused_cab_convs", weights)
        _build.cab_tc(x, weights, out, hidden, c_real)
        fused_cab_convs.launches += 1
        fused_cab_convs.tc_launches += 1
        return
    if hidden is None:
        hidden = torch.empty((b, h, w, mid), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    _build.layernorm(x, ln_s, ln_b, y, c_real)
    _build.conv3x3(y, c, k1, b1, hidden, 0, mid, geom=(b, h, w), gelu=True)
    _build.conv3x3(hidden, mid, k2, b2, out, 0, c, geom=(b, h, w))
    fused_cab_convs.launches += 1
    fused_cab_convs.direct_launches += 3


fused_cab_convs.launches = 0         # calls
fused_cab_convs.tc_launches = 0      # CUDA launches by body
fused_cab_convs.direct_launches = 0


def fused_cab_convs_pair_reference(x: torch.Tensor,
                                   weights: list[torch.Tensor]
                                   ) -> torch.Tensor:
    """Plain PyTorch version of kernel 12: kernel 7's function
    (fused_cab_convs_reference), which the pair kernel computes too."""
    return fused_cab_convs_reference(x, weights)


def fused_cab_convs_pair(x: torch.Tensor,
                         weights: list[torch.Tensor]) -> torch.Tensor:
    """Kernel 12 on x [B,H,W,C] with an even W (the reference's rule),
    weights as kernel 7's (cab_weights). CPU tensors run the plain
    version; CUDA tensors launch kernel 7's tensor-core body once with
    the LN divided by C (bf16 x and kernels, f32 LN parameters and
    biases, k1 and k2 packed) or raise: off kernel 7's route rule
    (uses_tensor_cores) there is no other body. Counts its own launches,
    not kernel 7's."""
    if x.shape[2] % 2:
        raise ValueError(f"fused_cab_convs_pair: needs an even width, got "
                         f"{x.shape[2]}")
    if x.device.type == "cpu":
        return fused_cab_convs_pair_reference(x, weights)
    return cab_pair_launch(x, weights)


def cab_pair_launch(x: torch.Tensor,
                    weights: list[torch.Tensor]) -> torch.Tensor:
    """Kernel 12's one launch, counted on fused_cab_convs_pair.launches
    alone; raises off kernel 7's route rule, for weights that do not fit
    x or lie off its device, or without the packing."""
    mid = weights[2].shape[-1]
    if not uses_tensor_cores(x, mid):
        raise ValueError(
            f"fused_cab_convs_pair: the kernel takes the shapes of kernel "
            f"7's route rule (bf16 x, C and the hidden width multiples of "
            f"8, C <= {CAB_TC_MAX_C}, hidden <= {CAB_TC_MAX_MID}), got "
            f"{x.dtype} C={x.shape[-1]}, hidden {mid}")
    _check_cab_weights("fused_cab_convs_pair", x, weights)
    _check_packed("fused_cab_convs_pair", weights)
    out = torch.empty_like(x)
    _build.cab_tc(x, weights, out)
    fused_cab_convs_pair.launches += 1
    return out


fused_cab_convs_pair.launches = 0


def hab_weights(params: Mapping[str, torch.Tensor], pre: str,
                num_heads: int, window_size: int,
                dtype: torch.dtype = torch.bfloat16
                ) -> dict[str, torch.Tensor]:
    """HAB `pre` of a HAT-keyed state dict -> the kernel's weights by
    HAB_WEIGHTS: dense kernels [in, out] in `dtype` (wqkv's columns q | k
    | v), the gathered rel-pos bias rpb [nh, n, n], LN parameters and
    biases in f32; and the dense kernels packed once for the tensor-core
    body (mma_weights), which kernels 8 and 11 read."""
    n = window_size * window_size
    table = params[f"{pre}.attn.relative_position_bias_table"]
    idx = torch.as_tensor(relative_position_index(window_size),
                          device=table.device).long().reshape(-1)
    rpb = table[idx].reshape(n, n, num_heads).permute(2, 0, 1)

    def dense_t(name):
        return params[f"{pre}.{name}.weight"].detach().t().to(
            dtype).contiguous()

    return mma_weights({
        "ln1_s": _f32(params[f"{pre}.norm1.weight"]),
        "ln1_b": _f32(params[f"{pre}.norm1.bias"]),
        "wqkv": dense_t("attn.qkv"),
        "bqkv": _f32(params[f"{pre}.attn.qkv.bias"]),
        "rpb": _f32(rpb),
        "wp": dense_t("attn.proj"),
        "bp": _f32(params[f"{pre}.attn.proj.bias"]),
        "ln2_s": _f32(params[f"{pre}.norm2.weight"]),
        "ln2_b": _f32(params[f"{pre}.norm2.bias"]),
        "w1": dense_t("mlp.fc1"), "b1": _f32(params[f"{pre}.mlp.fc1.bias"]),
        "w2": dense_t("mlp.fc2"), "b2": _f32(params[f"{pre}.mlp.fc2.bias"]),
    })


def pack_mma(w: torch.Tensor) -> torch.Tensor:
    """A dense kernel w [K, N] (N a multiple of 8) in the tensor-core
    body's fragment order: [ceil(K / 16), N / 8, 32, 4] in w's dtype, K
    zero-padded to a multiple of 16; entry [ks, j, 4 g + t] holds the
    mma.sync B fragment of k-step ks and 8-column fragment j for lane
    4 g + t: w[16 ks + 2 t + e, 8 j + g] (e = 0, 1), then w[16 ks + 8 +
    2 t + e, 8 j + g]."""
    k, n = w.shape
    kp = -(-k // 16) * 16
    wp = F.pad(w, (0, 0, 0, kp - k))
    # rows 16 ks + 8 half + 2 t + e, columns 8 j + g -> [ks, j, g, t, half, e]
    return (wp.reshape(kp // 16, 2, 4, 2, n // 8, 8)
            .permute(0, 4, 5, 2, 1, 3).contiguous()
            .reshape(kp // 16, n // 8, 32, 4))


def mma_weights(weights: Mapping[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
    """Kernel 8's weights (by HAB_WEIGHTS) with each dense kernel packed
    for the tensor-core body (pack_mma, under its name + "_mma"; any
    packing present is replaced); unchanged where a kernel's output width
    is not a multiple of 8 (no instance of the kernel takes those).
    hab_weights calls it once; a caller that builds or changes the dense
    kernels itself calls it again."""
    w = dict(weights)
    if any(w[k].shape[-1] % 8 for k in HAB_DENSE):
        return w
    for k in HAB_DENSE:
        w[k + "_mma"] = pack_mma(w[k])
    return w


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] + b with f32 accumulation, in x's dtype."""
    return (x.float() @ w.float() + b.float()).to(x.dtype)


def hab_body_reference(x_wins: torch.Tensor, cab_wins: torch.Tensor,
                       weights: Mapping[str, torch.Tensor], num_heads: int,
                       region_ids: torch.Tensor | None = None,
                       c_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel 8 (the reference's
    reference_hab_body, with fused_hab_block_inference's c_real): f32
    accumulation and softmax, rounded to x's dtype where the reference
    rounds."""
    w = weights
    c = x_wins.shape[-1]
    y = layer_norm(x_wins, w["ln1_s"], w["ln1_b"], c_real)
    q, k, v = _dense(y, w["wqkv"], w["bqkv"]).split(c, dim=-1)
    attn = reference_window_attention(q, k, v, w["rpb"], num_heads,
                                      region_ids=region_ids)
    x1 = x_wins + _dense(attn, w["wp"], w["bp"]) + cab_wins
    z = layer_norm(x1, w["ln2_s"], w["ln2_b"], c_real)
    hid = F.gelu(z.float() @ w["w1"].float() + w["b1"].float()).to(z.dtype)
    return x1 + _dense(hid, w["w2"], w["b2"])


def fused_hab_block(x_wins: torch.Tensor, cab_wins: torch.Tensor,
                    num_heads: int, weights: Mapping[str, torch.Tensor],
                    region_ids: torch.Tensor | None = None,
                    c_real: int | None = None) -> torch.Tensor:
    """Kernel 8 on x_wins, cab_wins [nb, n, C]; region_ids [nW_img, n]
    int32 Swin labels or None; c_real the LNs' divisor on lane-padded
    windows (default C). CPU tensors run the plain version; CUDA tensors
    launch the kernel ((C, heads, n, MLP) in HAB_GEOMETRIES; bf16
    activations and dense kernels, f32 rest) or raise."""
    nb, n, c = x_wins.shape
    if cab_wins.shape != x_wins.shape:
        raise ValueError(f"fused_hab_block: cab {tuple(cab_wins.shape)} != "
                         f"x {tuple(x_wins.shape)}")
    if region_ids is not None and (region_ids.shape[-1] != n
                                   or nb % region_ids.shape[0]):
        raise ValueError(f"fused_hab_block: region ids "
                         f"{tuple(region_ids.shape)} do not tile {nb} "
                         f"windows of {n}")
    if x_wins.device.type == "cpu":
        return hab_body_reference(x_wins, cab_wins, weights, num_heads,
                                  region_ids, c_real)
    check_hab_weights("fused_hab_block", weights, c, num_heads, n,
                      HAB_GEOMETRIES)
    if c_real is not None and not 0 < c_real <= c:
        raise ValueError(f"fused_hab_block: c_real {c_real} not in 1..{c}")
    _build.require_cuda(x_wins, cab_wins, name="fused_hab_block")
    if region_ids is not None:
        _build.require_cuda(region_ids, dtype=torch.int32,
                            name="fused_hab_block")
    out = torch.empty_like(x_wins)
    _build.hab_block(x_wins, cab_wins, weights, num_heads, region_ids, out,
                     c_real)
    fused_hab_block.launches += 1
    return out


fused_hab_block.launches = 0


def check_hab_weights(name: str, weights: Mapping[str, torch.Tensor], c: int,
                      num_heads: int, n: int, geometries: tuple) -> None:
    """Raise unless (c, num_heads, n, MLP) is one of `geometries`, every
    weight of HAB_WEIGHTS has its shape, each dense kernel's packing
    (mma_weights) is there with its shape, and all lie on the card in the
    kernels' types (kernels 8 and 11)."""
    mlp = weights["w1"].shape[-1]
    if (c, num_heads, n, mlp) not in geometries:
        raise ValueError(f"{name}: the kernel takes (C, heads, n, mlp) in "
                         f"{geometries}, got {(c, num_heads, n, mlp)}")
    want = {"ln1_s": (c,), "ln1_b": (c,), "wqkv": (c, 3 * c),
            "bqkv": (3 * c,), "rpb": (num_heads, n, n), "wp": (c, c),
            "bp": (c,), "ln2_s": (c,), "ln2_b": (c,), "w1": (c, mlp),
            "b1": (mlp,), "w2": (mlp, c), "b2": (c,)}
    for k in HAB_WEIGHTS:
        if tuple(weights[k].shape) != want[k]:
            raise ValueError(f"{name}: {k} {tuple(weights[k].shape)} != "
                             f"{want[k]}")
    _build.require_cuda(*(weights[k] for k in HAB_DENSE), name=name)
    _build.require_cuda(*(weights[k] for k in HAB_WEIGHTS
                          if k not in HAB_DENSE),
                        dtype=torch.float32, name=name)
    for k in HAB_DENSE:  # the kernels read the packings (mma_weights)
        packed = weights.get(k + "_mma")
        kk, nn = weights[k].shape
        if packed is None:
            raise ValueError(f"{name}: no {k}_mma: the weights are packed "
                             f"for the kernel by hab_weights or mma_weights")
        if tuple(packed.shape) != (-(-kk // 16), nn // 8, 32, 4):
            raise ValueError(f"{name}: {k}_mma {tuple(packed.shape)} is not "
                             f"{k}'s packing")
        _build.require_cuda(packed, name=name)
