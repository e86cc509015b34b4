"""Kernel 15: a 3x3 SAME conv to C_out*r^2 channels and the pixel shuffle
in one pass, the sub-pixel head of ESPCN and of EDSR's upsampler stages.

Counterpart of superresolution_tpu/ops/pallas_kernels.py
(fused_conv3x3_depth_to_space), which the reference kept off its TPU
path because Mosaic refused its in-kernel relayout; on the card the
shuffle is the kernel's store address (ops/csrc/subpixel_kernels.cu),
so the C_out*r^2 map is never written. The kernel is the Subpixel policy
of the shared conv engine (ops/csrc/conv_engine.cuh), which has two
bodies: a bf16 implicit GEMM on the tensor cores and a direct f32 one.
uses_tensor_cores is the rule that picks between them, and each launch
counts on `launches` and on the body's own count (`tc_launches`,
`direct_launches`).

The op takes the layout the port's models hold at their heads: x
[B, C_in, H, W] (NCHW order, any strides; the convs before it hand it
over channels-last), w the conv's OIHW [C_out*r^2, C_in, 3, 3], bias
[C_out*r^2]. It returns [B, C_out, H*r, W*r], channels-last in memory,
in x's dtype (f32 accumulation), exactly F.pixel_shuffle(F.conv2d(x, w,
b, padding=1), r) in torch.PixelShuffle's channel order. CPU tensors run
that plain form; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build


def reference_conv3x3_depth_to_space(x: torch.Tensor, w: torch.Tensor,
                                     b: torch.Tensor | None,
                                     r: int) -> torch.Tensor:
    """The plain form: F.conv2d (SAME) then F.pixel_shuffle."""
    return F.pixel_shuffle(F.conv2d(x, w, b, padding=1), r)


def _check_geometry(x, w, b, r) -> None:
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(
            f"conv3x3_depth_to_space: x [B, C_in, H, W] and w [C_out*r^2, "
            f"C_in, 3, 3] expected, got x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}")
    if r < 1 or w.shape[0] % (r * r):
        raise ValueError(f"conv3x3_depth_to_space: {w.shape[0]} output "
                         f"channels are not a multiple of r^2 = {r * r}")
    if b is not None and tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"conv3x3_depth_to_space: bias {tuple(b.shape)} "
                         f"for {w.shape[0]} output channels")


# The tensor-core body stages C_in channels of each input pixel.
TC_MAX_CIN = 256


def uses_tensor_cores(x: torch.Tensor) -> bool:
    """The route rule: kernel 15 runs its tensor-core body when x is bf16,
    channels-last in memory (the layout the port's convs hand over) with
    8 <= C_in <= TC_MAX_CIN and C_in % 8 == 0, so that every pixel is a
    16-byte aligned run of channels; f32 and every other shape and layout
    (an NCHW x, a C_in the 16-byte copies cannot take) run the direct
    body. Both bodies compute the same function."""
    cin = x.shape[1]
    return (x.dtype == torch.bfloat16 and cin % 8 == 0
            and 8 <= cin <= TC_MAX_CIN
            and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0)


def kmajor_weights(w: torch.Tensor, b: torch.Tensor | None, r: int,
                   dtype: torch.dtype) -> tuple:
    """The engine's operands from the conv's OIHW w [C_out*r^2, C_in, 3,
    3] and bias [C_out*r^2]: wk [9*C_in, ldw] in `dtype`, row tap*C_in +
    ci (tap = ky*3 + kx), column q = s*C_out + c (sub-pixel-major; o =
    c*r^2 + s in the conv's order), zero past C_out*r^2 up to ldw, a
    multiple of 8; and the bias in the same column order, f32 [ldw] (or
    None)."""
    n, cin = w.shape[:2]
    c_out = n // (r * r)
    ldw = -(-n // 8) * 8
    # one copy each: reshape of the permuted view, a cast into a new
    # contiguous tensor; a pad only where N is not a multiple of 8
    wk = (w.to(dtype).reshape(c_out, r * r, cin, 3, 3)
          .permute(3, 4, 2, 1, 0).reshape(9 * cin, n))
    if ldw != n:
        wk = F.pad(wk, (0, ldw - n))
    if b is None:
        return wk, None
    bk = b.reshape(c_out, r * r).t().to(
        torch.float32, memory_format=torch.contiguous_format).reshape(n)
    return wk, bk if ldw == n else F.pad(bk, (0, ldw - n))


def _launch(x, w, b, r) -> torch.Tensor:
    """Kernel 15 on CUDA tensors, in the body uses_tensor_cores picks, or
    an error naming what it does not take."""
    bsz, _, h, wd = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_depth_to_space: the kernel takes bf16 or "
                        f"f32, got {x.dtype}")
    for t in (x, w, b):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv3x3_depth_to_space: expected tensors on "
                             f"{x.device}, got {t.device}")
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_depth_to_space: expected CUDA tensors, "
                         f"got {x.device}")
    # the bias rounds to x's type first, as the op's plain form adds it
    wk, bk = kmajor_weights(w, None if b is None else b.to(x.dtype), r,
                            x.dtype)
    c_out = w.shape[0] // (r * r)
    out = torch.empty((bsz, h * r, wd * r, c_out), dtype=x.dtype,
                      device=x.device)
    tc = uses_tensor_cores(x)
    _build.conv3x3_d2s(x, wk, bk, r, out, tc)
    conv3x3_depth_to_space.launches += 1
    if tc:
        conv3x3_depth_to_space.tc_launches += 1
    else:
        conv3x3_depth_to_space.direct_launches += 1
    return out.permute(0, 3, 1, 2)


class _ConvDepthToSpace(torch.autograd.Function):
    """Forward: kernel 15 on CUDA tensors, the plain form on CPU ones.
    Backward: autograd of the plain form on the saved inputs, as the
    reference's pack_conv3x3 takes the XLA conv as its VJP."""

    @staticmethod
    def forward(ctx, x, w, b, r):
        ctx.save_for_backward(x, w, b)
        ctx.r = r
        if x.device.type == "cpu":
            return reference_conv3x3_depth_to_space(x, w, b, r)
        return _launch(x, w, b, r)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            out = reference_conv3x3_depth_to_space(*leaves, ctx.r)
            wrt = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return (*(next(grads) if n else None for n in need), None)


def conv3x3_depth_to_space(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor | None, r: int) -> torch.Tensor:
    """Kernel 15: pixel_shuffle(conv3x3_SAME(x, w) + b, r). x [B, C_in,
    H, W] (bf16 or f32 on the card, any strides), w [C_out*r^2, C_in, 3,
    3], b [C_out*r^2] or None (both cast to x's dtype). Returns [B,
    C_out, H*r, W*r] in x's dtype, channels-last in memory on the card.
    Differentiable in x, w and b."""
    _check_geometry(x, w, b, r)
    return _ConvDepthToSpace.apply(x, w, b, r)


conv3x3_depth_to_space.launches = 0
conv3x3_depth_to_space.tc_launches = 0
conv3x3_depth_to_space.direct_launches = 0
