"""Plain-torch model of kernel 9's arithmetic (ops/csrc/flash_tc.cuh
flash_kernel over the padded maps, built by oca_kernels.cu), the CPU
stand-in for the kernel, which runs only on the card.

  oca_tiled       the kernel's order: each window's keys gathered from the
                  padded maps pixel by pixel (map row stride wp), each
                  head's columns zero-padded to HDP (16, or 24 at head dim
                  20, as the kernel stages them), the keys taken in tiles
                  of kt (the last one short); per tile the logits in log2
                  units, s = (q k^T + bias / scale) scale log2 e in f32 (the
                  sums start from the bias / scale), the tile's row max m,
                  the running sum and output rescaled by 2^(m_old - m), p
                  = 2^(s - m), the sum of p in f32 and p rounded to the
                  input type (bf16 on the card) before its product with v;
                  the output divided by the row sum last.
                  Takes the kernel's `plant` bits (ops/_build.PLANT_PAD_
                  MASKED, _NO_RESCALE, _ROW_STRIDE), so the tests can show
                  how far each planted fault moves the output.
The kernel reads the bias / scale re-laid by ops/flash_oca.
bias_fragments; this model reads it as it lies.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build

KT = 32          # keys a tile (oca_kernels.cu KT)
LOG2E = 1.4426950408889634


def head_layout(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., C] -> [..., heads, HDP]: each head's hd columns zero-padded to
    a multiple of 8, as the kernel stages q, k and v."""
    hd = t.shape[-1] // num_heads
    hdp = -(-hd // 8) * 8
    return F.pad(t.reshape(*t.shape[:-1], num_heads, hd), (0, hdp - hd))


def gathered_keys(k_map: torch.Tensor, ws: int, ows: int,
                  plant: int = 0) -> torch.Tensor:
    """[B, hp, wp, C] -> [B * nh_w * nw_w, ows^2, C]: key j of window (img,
    wr, wc) is pixel (img hp + wr ws + j // ows) rs + wc ws + j % ows of
    the flattened map, rs = wp (wp - 1 under PLANT_ROW_STRIDE)."""
    b, hp, wp, c = k_map.shape
    nh_w, nw_w = (hp - (ows - ws)) // ws, (wp - (ows - ws)) // ws
    rs = wp - 1 if plant & _build.PLANT_ROW_STRIDE else wp
    j = torch.arange(ows * ows)
    img = torch.arange(b).view(b, 1, 1, 1)
    wr = torch.arange(nh_w).view(1, nh_w, 1, 1)
    wc = torch.arange(nw_w).view(1, 1, nw_w, 1)
    idx = (img * hp + wr * ws + j // ows) * rs + wc * ws + j % ows
    return k_map.reshape(b * hp * wp, c)[idx.reshape(-1)].reshape(
        b * nh_w * nw_w, ows * ows, c)


def padded_keys(hp: int, wp: int, b: int, ws: int, ows: int) -> torch.Tensor:
    """[B * nh_w * nw_w, ows^2] bool: the keys in the maps' zero padding."""
    nh_w, nw_w = (hp - (ows - ws)) // ws, (wp - (ows - ws)) // ws
    pad = (ows - ws) // 2
    j = torch.arange(ows * ows)
    y = torch.arange(nh_w).view(nh_w, 1, 1) * ws + j // ows
    x = torch.arange(nw_w).view(1, nw_w, 1) * ws + j % ows
    out = (y < pad) | (y >= hp - pad) | (x < pad) | (x >= wp - pad)
    return out.reshape(1, nh_w * nw_w, ows * ows).expand(b, -1, -1).reshape(
        b * nh_w * nw_w, ows * ows)


def oca_tiled(q: torch.Tensor, k_map: torch.Tensor, v_map: torch.Tensor,
              bias: torch.Tensor, num_heads: int, ws: int, ows: int,
              kt: int = KT, plant: int = 0) -> torch.Tensor:
    """Kernel 9's arithmetic: q [nb, ws^2, C], maps [B, hp, wp, C], bias
    [nh, ws^2, ows^2] f32 -> [nb, ws^2, C] in q's dtype."""
    b, hp, wp, c = k_map.shape
    hd = c // num_heads
    scale = float(hd) ** -0.5
    qh = head_layout(q, num_heads).float().transpose(1, 2)   # [nb,nh,n,p]
    kh, vh = (head_layout(gathered_keys(m, ws, ows, plant), num_heads)
              .float().transpose(1, 2) for m in (k_map, v_map))
    neg = torch.tensor(-math.inf)
    m_keys = ows * ows
    if plant & _build.PLANT_PAD_MASKED:
        mask = padded_keys(hp, wp, b, ws, ows)[:, None, None, :]
    nb, _, n, hdp = qh.shape
    mx = torch.full((nb, num_heads, n, 1), -math.inf)
    total = torch.zeros((nb, num_heads, n, 1))
    o = torch.zeros((nb, num_heads, n, hdp))
    for j0 in range(0, m_keys, kt):
        j1 = min(j0 + kt, m_keys)
        s = (bias[:, :, j0:j1].float() / scale
             + qh @ kh[..., j0:j1, :].transpose(-1, -2)) * (scale * LOG2E)
        if plant & _build.PLANT_PAD_MASKED:
            s = torch.where(mask[..., j0:j1], neg, s)
        mn = torch.maximum(mx, s.amax(-1, keepdim=True))
        mref = torch.where(mn == -math.inf, torch.zeros(()), mn)
        corr = torch.exp2(mx - mref)
        mx = mn
        total = total * corr
        if not plant & _build.PLANT_NO_RESCALE:
            o = o * corr
        p = torch.exp2(s - mref)
        total = total + p.sum(-1, keepdim=True)
        o = o + p.to(q.dtype).float() @ vh[..., j0:j1, :]
    out = (o / total)[..., :hd]                               # [nb,nh,n,hd]
    return out.transpose(1, 2).reshape(nb, n, c).to(q.dtype)

