"""Windowed multi-head attention: the plain form, and kernel 10
(flash_window_attention on packed [nb, n, C] windows, flash_map_attention
on the HAB's qkv map) as hand-written CUDA ops.

Counterpart of superresolution_tpu/ops/pallas_attn.py:
reference_window_attention and flash_window_attention (_flash_fwd_impl,
_flash_bwd). Logits and softmax in f32 (or `acc_dtype` in the plain
form), probabilities cast to the input dtype before the product with v,
as the reference does. The plain form serves the HAT model's attention
and the plain versions of kernels 8, 9 and 10.

Kernel 10 in bf16 is one launch of FlashAttention-2 on the tensor cores
(csrc/flash_tc.cuh, kernel 9's body generalised over how it addresses its
keys; csrc/attn_tc_kernels.cu): mma.sync with f32 sums, the bias re-laid
into the accumulators' layout (flash_oca.bias_fragments) and the Swin
mask added there. Two forms: over windows (q, k, v [nb, *, C] strided
views, read in place), and over the map, where q, k and v come straight
from the qkv map [B, H, W, 3C] with the Swin shift as index arithmetic
and each output token goes back to its pixel, so the HAB's roll,
window partition, merge and roll back are never written
(models/hat_lite.HABlock under flash_attn). In f32 kernel 10 runs the
CUDA-core form attn_kernel (csrc/attn_kernels.cu, the exact check; the
map form then partitions
around it). Its backward, like the reference's custom_vjp, is autograd
of the plain form on the saved inputs: the TPU kernel has no backward
kernel either.

Bound on the H100: 2 * 2 * n * m * hd FLOP per window and head against
(2n + 2m) * C * 2 bytes in bf16, 12 to 48 FLOP/B, so bound by bytes
(see the sources for what each form reaches).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build

NEG = -1e9

# what the hand kernel takes, in bf16 (the tensor cores) and f32 (the
# CUDA-core form) alike: head dim -> widest C; (queries, keys) per window:
# 8x8 windows against themselves and the OCAB's 10x10, 11x11 and 12x12
# key windows, 16x16 windows against themselves and 24x24; the map form
# their self-attention (n == m, ws 8 or 16)
ATTN_MAX_C = {16: 128, 20: 120}
ATTN_NM = ((64, 64), (64, 100), (64, 121), (64, 144), (256, 256),
           (256, 576))

__all__ = ["bias_fragments", "flash_map_attention", "flash_window_attention",
           "map_attention_reference", "reference_window_attention",
           "region_mask", "shift_region_ids", "window_merge",
           "window_partition"]


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nH*nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_merge(x: torch.Tensor, ws: int, hw: tuple[int, int]
                 ) -> torch.Tensor:
    """[B*nH*nW, ws*ws, C] -> [B,H,W,C]."""
    h, w = hw
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@lru_cache(maxsize=None)
def shift_region_ids(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Swin shift region labels per window: [nWindows, ws*ws] int32. Two
    positions may attend iff their labels match."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(win.reshape(-1, ws * ws))


def bias_fragments(bias: torch.Tensor, scale: float) -> torch.Tensor:
    """bias [nh, n, m] / scale in the order the accumulator fragments of
    kernels 9 and 10 read it, flat f32: for head h, query tile qt (16
    rows), key tile kn (8 keys) and lane l = 4 g + t, four floats: rows
    16 qt + g and 16 qt + g + 8, each at keys 8 kn + 2 t and + 1 (zero
    past m). The kernel starts its q k^T sums from these and multiplies
    by scale. A model makes kernel 9's once with its biases
    (infer/fused_hat); kernel 10 makes its own at each call."""
    nh, n, m = bias.shape
    mp = -(-m // 8) * 8
    b = F.pad(bias.float() / scale, (0, mp - m))
    # [h, qt, half, g, kn, t, e] -> [h, qt, kn, g, t, half, e]
    return (b.reshape(nh, n // 16, 2, 8, mp // 8, 4, 2)
            .permute(0, 1, 4, 3, 5, 2, 6).contiguous().reshape(-1))


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


def _require_geometry(hd: int, n: int, m: int, c: int) -> None:
    """A ValueError naming what kernel 10 does not take."""
    if hd not in ATTN_MAX_C or (n, m) not in ATTN_NM or c > ATTN_MAX_C[hd]:
        raise ValueError(
            f"flash_window_attention: the kernel takes head dim and widest "
            f"C in {ATTN_MAX_C}, (n, m) in {ATTN_NM}; got head dim {hd}, n "
            f"{n}, m {m}, C {c}")


def _launch(q, k, v, bias, num_heads, region_ids) -> torch.Tensor:
    """Kernel 10 on CUDA tensors, or a ValueError naming what it does not
    take."""
    nb, n, c = q.shape
    m = k.shape[1]
    hd = c // num_heads
    _require_geometry(hd, n, m, c)
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
    ids = None if region_ids is None else region_ids.to(
        q.device, torch.int32).contiguous()
    out = torch.empty((nb, n, c), dtype=q.dtype, device=q.device)
    scale = float(hd) ** -0.5
    if q.dtype == torch.bfloat16:
        # the tensor cores' copies move 16 bytes (head dim 16) or 8 (20)
        # from every row, and k and v share one pair of strides: a view
        # whose rows are not so aligned, or a k and v laid out apart, is
        # copied contiguous first
        unit = 8 if hd == 16 else 4
        q, k, v = (t if t.data_ptr() % (2 * unit) == 0
                   and t.stride(0) % unit == 0 and t.stride(1) % unit == 0
                   else t.contiguous() for t in (q, k, v))
        if k.stride() != v.stride():
            k, v = k.contiguous(), v.contiguous()
        _build.window_attention_tc(
            q, k, v, bias_fragments(bias.to(q.device), scale), ids,
            num_heads, scale, out)
        flash_window_attention.tc_launches += 1
    else:
        # 4-element loads where every row start (and so every head's first
        # column, head dims being multiples of 4) is 4-element aligned
        vec = all(t.data_ptr() % (4 * t.element_size()) == 0
                  and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
                  for t in (q, k, v))
        _build.window_attention(q, k, v, bias.to(q.device,
                                                 torch.float32).contiguous(),
                                ids, num_heads, scale, vec, out)
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
    """Kernel 10 over windows. q [nb, n, C], k/v [nb, m, C] (bf16 or f32;
    strided views such as the split of a packed qkv projection are read
    in place), bias [nh, n, m] (f32 in the kernel), region_ids [nW_img,
    n] int or None (self-attention only; window b uses region_ids[b %
    nW_img]). Returns [nb, n, C] in q's dtype. CPU tensors run the plain
    form; CUDA tensors launch the kernel ((n, m) in ATTN_NM, head dim 16
    with C <= 128 or 20 with C <= 120; bf16 on the tensor cores, f32 on
    the CUDA cores) or raise. Differentiable in q, k, v and bias."""
    _check_geometry(q, k, v, bias, num_heads, region_ids)
    return _FlashWindowAttention.apply(q, k, v, bias, num_heads, region_ids)


flash_window_attention.launches = 0
flash_window_attention.tc_launches = 0  # those on the tensor cores


def _on_windows(qkv: torch.Tensor, ws: int, shift: int, attend
                ) -> torch.Tensor:
    """attend(q, k, v, region_ids) on the ws x ws windows of the qkv map
    [B, H, W, 3C] rolled by -shift (with the Swin region ids of a
    shifted map), merged and rolled back: [B, H, W, C]."""
    b, h, w, c3 = qkv.shape
    ids = None
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), dims=(1, 2))
        ids = torch.as_tensor(shift_region_ids(h, w, ws, shift),
                              device=qkv.device)
    q, k, v = window_partition(qkv, ws).split(c3 // 3, dim=-1)
    y = window_merge(attend(q, k, v, ids), ws, (h, w))
    return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y


def map_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                            num_heads: int, ws: int, shift: int,
                            acc_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain version of the map form: roll the qkv map [B, H, W, 3C] by
    -shift, window_partition, reference_window_attention (the Swin
    region ids of a shifted map), window_merge, roll back. Returns [B, H,
    W, C] in qkv's dtype."""
    return _on_windows(qkv, ws, shift, lambda q, k, v, ids:
                       reference_window_attention(q, k, v, bias, num_heads,
                                                  ids, acc_dtype))


def _map_launch(qkv, bias, num_heads, ws, shift) -> torch.Tensor:
    """Kernel 10's map form on CUDA tensors: bf16 on the tensor cores
    (one launch); f32 the CUDA-core form between the plain roll,
    partition and merge."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    _require_geometry(c // num_heads, ws * ws, ws * ws, c)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_map_attention: expected a CUDA tensor, got "
                         f"{qkv.device}")
    if qkv.dtype == torch.float32:
        return _on_windows(qkv, ws, shift, lambda q, k, v, ids:
                           _launch(q, k, v, bias, num_heads, ids))
    _build.require_cuda(qkv, name="flash_map_attention")
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    scale = float(c // num_heads) ** -0.5
    _build.map_attention(qkv, bias_fragments(bias.to(qkv.device), scale),
                         num_heads, ws, shift, out)
    flash_window_attention.launches += 1
    flash_window_attention.tc_launches += 1
    flash_map_attention.launches += 1
    return out


class _FlashMapAttention(torch.autograd.Function):
    """Forward: kernel 10's map form on CUDA tensors, the plain version on
    CPU ones. Backward: autograd of the plain version (f32 logits) on the
    saved inputs."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, ws, shift):
        ctx.save_for_backward(qkv, bias)
        ctx.geom = (num_heads, ws, shift)
        if qkv.device.type == "cpu":
            return map_attention_reference(qkv, bias, num_heads, ws, shift)
        return _map_launch(qkv, bias, num_heads, ws, shift)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(r) for t, r in
                      zip(saved, need)]
            out = map_attention_reference(*leaves, *ctx.geom)
            wrt = [t for t, r in zip(leaves, need) if r]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return (*(next(grads) if r else None for r in need), None, None,
                None)


def flash_map_attention(qkv: torch.Tensor, bias: torch.Tensor,
                        num_heads: int, ws: int, shift: int = 0
                        ) -> torch.Tensor:
    """Kernel 10 over the map: the ws x ws window self-attention of the
    qkv map [B, H, W, 3C] (q | k | v on the channels) rolled by -shift,
    with the Swin mask when shift > 0, the result rolled back: [B, H, W,
    C] in qkv's dtype, as map_attention_reference. bias [nh, ws^2, ws^2].
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (ws 8 or 16, the widths of flash_window_attention) or raise. Counted in flash_window_attention's
    launches (and tc_launches), and in its own. Differentiable in qkv and
    bias."""
    b, h, w, c3 = qkv.shape
    if c3 % 3 or (c3 // 3) % num_heads or h % ws or w % ws \
            or not 0 <= shift < ws:
        raise ValueError(f"flash_map_attention: qkv {tuple(qkv.shape)}, "
                         f"heads {num_heads}, ws {ws}, shift {shift}")
    if tuple(bias.shape) != (num_heads, ws * ws, ws * ws):
        raise ValueError(f"flash_map_attention: bias {tuple(bias.shape)} "
                         f"!= {(num_heads, ws * ws, ws * ws)}")
    return _FlashMapAttention.apply(qkv, bias, num_heads, ws, shift)


flash_map_attention.launches = 0
