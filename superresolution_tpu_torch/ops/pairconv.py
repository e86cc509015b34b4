"""Kernel 18: the pack-GEMM 3x3 conv on W-packed operands.

Counterpart of superresolution_tpu/ops/pallas_pairconv.py (pack_conv3x3,
pack_geometry, pack_input, unpack_output), which no path of the
reference runs. The packed layout is part of the op's contract: x [B, H,
W, c] becomes [B, H, W2, p*c], p adjacent pixels to a pack, one zero pack
on the left and zero packs on the right up to a 16-aligned W2; an op's
output keeps its pad packs at 0, so calls chain without unpacking.

On CUDA tensors pack_conv3x3 launches the PackConv policy of the shared
conv engine (csrc/conv_engine.cuh, csrc/pack_kernels.cu), in its
tensor-core body (a bf16 implicit GEMM) or its direct f32 body as
uses_tensor_cores says; each launch counts on `launches` and on the
body's own count (`tc_launches`, `direct_launches`). It reads the packed
input as it lies,
pad packs included (as the TPU kernel's taps do), rows outside the image
as zero, accumulates in f32, adds the f32 bias, applies the optional
LeakyReLU(0.2), writes 0 to every pad pack and rounds once to xp's type.
On CPU tensors it runs the plain form, unpack -> F.conv2d (SAME) ->
pack, which equals the kernel whenever the input's pad packs are zero,
as pack_input and the op itself leave them. Its gradient is autograd of
that plain form, as the reference's custom_vjp takes the XLA form's vjp;
a pad pack of the input gets a zero gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build

_ACTS = ("none", "lrelu")


def pack_geometry(width: int, p: int) -> tuple[int, int, int]:
    """-> (w2 packs, pad_l, pad_r): one zero pack on the left, zero
    packs on the right up to a multiple of 16 packs. Raises when width
    is not a multiple of p."""
    if width % p:
        raise ValueError(f"width {width} not a multiple of pack {p}")
    w2 = -(-(width // p + 2) // 16) * 16
    pad_l = p
    return w2, pad_l, w2 * p - width - pad_l


def pack_input(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B,H,W,c] -> packed [B,H,W2,p*c] with zeroed pad packs."""
    b, h, w, c = x.shape
    w2, pad_l, pad_r = pack_geometry(w, p)
    return F.pad(x, (0, 0, pad_l, pad_r)).reshape(b, h, w2, p * c)


def unpack_output(y: torch.Tensor, p: int, width: int) -> torch.Tensor:
    """packed [B,H,W2,p*n] -> [B,H,width,n]."""
    b, h, w2, pn = y.shape
    _, pad_l, _ = pack_geometry(width, p)
    return y.reshape(b, h, w2 * p, pn // p)[:, :, pad_l:pad_l + width]


def pack_conv3x3_reference(xp: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor, p: int, width: int,
                           act: str = "none") -> torch.Tensor:
    """The plain form of the reference's _ref_packed: unpack, a SAME conv
    in f32 (w HWIO [3,3,c,n]), + bias, the optional lrelu, one rounding
    to xp's type, pack."""
    x = unpack_output(xp, p, width)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.to(xp.dtype).permute(3, 2, 0, 1).float(), padding=1)
    y = y.permute(0, 2, 3, 1) + bias.float()
    if act == "lrelu":
        y = F.leaky_relu(y, 0.2)
    return pack_input(y.to(xp.dtype), p)


def _check(xp, w, bias, p, width, act) -> None:
    w2, _, _ = pack_geometry(width, p)
    if act not in _ACTS:
        raise ValueError(f"pack_conv3x3: act must be one of {_ACTS}, got "
                         f"{act!r}")
    if w.ndim != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"pack_conv3x3: w [3, 3, c, n] expected, got "
                         f"{tuple(w.shape)}")
    c, n = w.shape[2], w.shape[3]
    if xp.ndim != 4 or tuple(xp.shape[2:]) != (w2, p * c):
        raise ValueError(f"pack_conv3x3: xp [B, H, {w2}, {p * c}] expected "
                         f"for width {width}, p {p}, c {c}, got "
                         f"{tuple(xp.shape)}")
    if tuple(bias.shape) != (n,):
        raise ValueError(f"pack_conv3x3: bias {tuple(bias.shape)} for {n} "
                         f"output channels")


# The tensor-core body stages c channels of each input pixel.
TC_MAX_CIN = 256


def uses_tensor_cores(xp: torch.Tensor, w: torch.Tensor) -> bool:
    """The route rule: kernel 18 runs its tensor-core body when xp is bf16
    and 16-byte aligned with 8 <= c <= TC_MAX_CIN, c % 8 == 0 and n % 8
    == 0 (w [3, 3, c, n]), so that every input and output pixel is a
    16-byte aligned run of channels; f32 and every other shape run the
    direct body. Both bodies compute the same function."""
    c, n = w.shape[2], w.shape[3]
    return (xp.dtype == torch.bfloat16 and c % 8 == 0 and n % 8 == 0
            and 8 <= c <= TC_MAX_CIN and xp.data_ptr() % 16 == 0)


def kmajor_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The engine's K-major weights [9c, n] in `dtype`: HWIO [3, 3, c, n]
    already is that matrix, row (ky*3 + kx)*c + ci."""
    return w.to(dtype).reshape(9 * w.shape[2], w.shape[3]).contiguous()


def _launch(xp, w, bias, p, width, act) -> torch.Tensor:
    """Kernel 18 on CUDA tensors, in the body uses_tensor_cores picks, or
    an error naming what it does not take."""
    if xp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"pack_conv3x3: the kernel takes bf16 or f32, got "
                        f"{xp.dtype}")
    xp = xp.contiguous()
    wk = kmajor_weights(w, xp.dtype)
    bk = bias.float().contiguous()
    _build.require_cuda(xp, wk, dtype=xp.dtype, name="pack_conv3x3")
    _build.require_cuda(bk, dtype=torch.float32, name="pack_conv3x3")
    b, h, w2, _ = xp.shape
    out = torch.empty((b, h, w2, p * w.shape[3]), dtype=xp.dtype,
                      device=xp.device)
    tc = uses_tensor_cores(xp, w)
    _build.pack_conv(xp, wk, bk, out, p, width, act == "lrelu", tc)
    pack_conv3x3.launches += 1
    if tc:
        pack_conv3x3.tc_launches += 1
    else:
        pack_conv3x3.direct_launches += 1
    return out


class _PackConv3x3(torch.autograd.Function):
    """Forward: kernel 18 on CUDA tensors, the plain form on CPU ones.
    Backward: autograd of the plain form on the saved inputs."""

    @staticmethod
    def forward(ctx, xp, w, bias, p, width, act):
        ctx.save_for_backward(xp, w, bias)
        ctx.cfg = (p, width, act)
        if xp.device.type == "cpu":
            return pack_conv3x3_reference(xp, w, bias, p, width, act)
        return _launch(xp, w, bias, p, width, act)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = pack_conv3x3_reference(*leaves, *ctx.cfg)
            wrt = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def pack_conv3x3(xp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 p: int, width: int, act: str = "none") -> torch.Tensor:
    """Kernel 18: SAME conv3x3 (+ bias, optional fused lrelu) on PACKED
    operands. xp [B, H, W2, p*c] (from pack_input or a previous call; bf16
    or f32 on the card), w [3, 3, c, n] HWIO, bias [n]. Returns packed
    [B, H, W2, p*n] in xp's type, its pad packs 0. Differentiable in xp,
    w and bias."""
    _check(xp, w, bias, p, width, act)
    return _PackConv3x3.apply(xp, w, bias, p, width, act)


pack_conv3x3.launches = 0
pack_conv3x3.tc_launches = 0
pack_conv3x3.direct_launches = 0
