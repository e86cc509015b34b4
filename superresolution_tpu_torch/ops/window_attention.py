"""Windowed multi-head attention on packed [nb, n, C] windows: the plain
form, and kernel 10 (flash_window_attention) as a hand-written CUDA op.

Counterpart of superresolution_tpu/ops/pallas_attn.py:
reference_window_attention and flash_window_attention (_flash_fwd_impl,
_flash_bwd). Logits and softmax in f32 (or `acc_dtype` in the plain
form), probabilities cast to the input dtype before the product with v,
as the reference does. The plain form serves the HAT model's attention
and the plain versions of kernels 8, 9 and 10.

Kernel 10 runs on the card as one launch of attn_kernel
(csrc/attn_kernels.cu), one thread block per window and head, with an
online softmax over the keys; the [nb, nh, n, m] logits never leave the
block. Its backward, like the reference's
custom_vjp, is autograd of the plain form on the saved inputs: the TPU
kernel has no backward kernel either.

Bound on the H100: 2 * 2 * n * m * hd FLOP per window and head against
(2n + 2m) * C * 2 bytes in bf16, 12 to 48 FLOP/B, so bound by bytes
(see the source for what this first form reaches).
"""

from __future__ import annotations

import torch

from superresolution_tpu_torch.ops import _build

NEG = -1e9

# what the hand kernel takes: head dim -> widest C; (queries, keys) per
# window: 8x8 windows against themselves and the OCAB's 10x10, 11x11 and
# 12x12 key windows, 16x16 windows against themselves and 24x24
ATTN_MAX_C = {16: 128, 20: 120}
ATTN_NM = ((64, 64), (64, 100), (64, 121), (64, 144), (256, 256),
           (256, 576))

__all__ = ["flash_window_attention", "reference_window_attention",
           "region_mask"]


def region_mask(region_ids: torch.Tensor) -> torch.Tensor:
    """[nW_img, n] Swin region ids -> additive [nW_img, n, n] f32 mask:
    0 where two positions share a region, -1e9 elsewhere."""
    same = region_ids[:, :, None] == region_ids[:, None, :]
    return torch.where(same, 0.0, NEG).to(torch.float32)


def reference_window_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor | None,
                               num_heads: int | None = None,
                               region_ids: torch.Tensor | None = None,
                               acc_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """q [nb, n, C], k/v [nb, m, C] (m == n for self-attention, m > n for
    OCAB cross-attention), bias [nh, n, m] f32 or None (then num_heads
    names nh), region_ids [nW_img, n] int or None; window b uses
    region_ids[b % nW_img]. Returns [nb, n, C] in q's dtype."""
    nb, n, c = q.shape
    m = k.shape[1]
    nh = bias.shape[0] if bias is not None else num_heads
    hd = c // nh
    qh = q.reshape(nb, n, nh, hd).transpose(1, 2)
    kh = k.reshape(nb, m, nh, hd).transpose(1, 2)
    vh = v.reshape(nb, m, nh, hd).transpose(1, 2)
    attn = (qh.to(acc_dtype) @ kh.to(acc_dtype).transpose(-1, -2)
            ) * torch.tensor(hd ** -0.5, dtype=acc_dtype)
    if bias is not None:
        attn = attn + bias.to(acc_dtype)
    if region_ids is not None:
        nw = region_ids.shape[0]
        attn = (attn.reshape(nb // nw, nw, nh, n, m)
                + region_mask(region_ids)[None, :, None].to(acc_dtype)
                ).reshape(nb, nh, n, m)
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return (attn @ vh).transpose(1, 2).reshape(nb, n, c)


def _check_geometry(q, k, v, bias, num_heads, region_ids) -> None:
    nb, n, c = q.shape
    m = k.shape[1]
    if c % num_heads:
        raise ValueError(f"flash_window_attention: C={c} not divisible by "
                         f"num_heads={num_heads}")
    if k.shape != (nb, m, c) or v.shape != k.shape:
        raise ValueError(f"flash_window_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if tuple(bias.shape) != (num_heads, n, m):
        raise ValueError(f"flash_window_attention: bias {tuple(bias.shape)}"
                         f" != {(num_heads, n, m)}")
    if region_ids is not None:
        if m != n:
            raise ValueError("flash_window_attention: region_ids only "
                             "supported for self-attention")
        if region_ids.shape[1] != n or nb % region_ids.shape[0]:
            raise ValueError(f"flash_window_attention: nb={nb} not a "
                             f"multiple of nW_img={region_ids.shape[0]}")


def _launch(q, k, v, bias, num_heads, region_ids) -> torch.Tensor:
    """Kernel 10 on CUDA tensors, or a ValueError naming what it does not
    take."""
    nb, n, c = q.shape
    m = k.shape[1]
    hd = c // num_heads
    if hd not in ATTN_MAX_C or (n, m) not in ATTN_NM or c > ATTN_MAX_C[hd]:
        raise ValueError(
            f"flash_window_attention: the kernel takes head dim and widest "
            f"C in {ATTN_MAX_C}, (n, m) in {ATTN_NM}; got head dim {hd}, "
            f"n {n}, m {m}, C {c}")
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"flash_window_attention: expected CUDA "
                             f"tensors, got {t.device}")
        if t.dtype != q.dtype or q.dtype not in (torch.bfloat16,
                                                 torch.float32):
            raise TypeError("flash_window_attention: q, k, v must share "
                            f"bf16 or f32, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if t.stride(2) != 1:
            raise ValueError("flash_window_attention: q, k, v need a unit "
                             "channel stride")
    # 4-element loads where every row start (and so every head's first
    # column, head dims being multiples of 4) is 4-element aligned
    vec = all(t.data_ptr() % (4 * t.element_size()) == 0
              and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
              for t in (q, k, v))
    ids = None if region_ids is None else region_ids.to(
        q.device, torch.int32).contiguous()
    bias = bias.to(q.device, torch.float32).contiguous()
    out = torch.empty((nb, n, c), dtype=q.dtype, device=q.device)
    _build.window_attention(q, k, v, bias, ids, num_heads, float(hd) ** -0.5,
                            vec, out)
    flash_window_attention.launches += 1
    return out


class _FlashWindowAttention(torch.autograd.Function):
    """Forward: kernel 10 on CUDA tensors, the plain form on CPU ones.
    Backward: autograd of the plain form (f32 logits) on the saved
    inputs, as the reference's _flash_bwd."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, region_ids):
        ctx.save_for_backward(q, k, v, bias)
        ctx.num_heads, ctx.region_ids = num_heads, region_ids
        if q.device.type == "cpu":
            return reference_window_attention(q, k, v, bias, num_heads,
                                              region_ids)
        return _launch(q, k, v, bias, num_heads, region_ids)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(r) for t, r in
                      zip(saved, need)]
            out = reference_window_attention(*leaves, ctx.num_heads,
                                             ctx.region_ids)
            wrt = [t for t, r in zip(leaves, need) if r]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return (*(next(grads) if r else None for r in need), None, None)


def flash_window_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: torch.Tensor,
                           num_heads: int,
                           region_ids: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Kernel 10. q [nb, n, C], k/v [nb, m, C] (bf16 or f32; strided
    views such as the split of a packed qkv projection are read in
    place), bias [nh, n, m] (f32 in the kernel), region_ids [nW_img, n]
    int or None (self-attention only; window b uses region_ids[b %
    nW_img]). Returns [nb, n, C] in q's dtype. CPU tensors run the plain
    form; CUDA tensors launch the kernel (head dim 16 with C <= 128 or 20
    with C <= 120; (n, m) in ATTN_NM) or raise. Differentiable in q, k, v
    and bias."""
    _check_geometry(q, k, v, bias, num_heads, region_ids)
    return _FlashWindowAttention.apply(q, k, v, bias, num_heads, region_ids)


flash_window_attention.launches = 0
