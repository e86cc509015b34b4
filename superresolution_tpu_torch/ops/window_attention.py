"""Plain windowed multi-head attention on packed [nb, n, C] windows.

Counterpart of superresolution_tpu/ops/pallas_attn.py:
reference_window_attention (the plain form only; the flash kernel of
that file is not ported yet). Logits and softmax in f32 (or `acc_dtype`),
probabilities cast to the input dtype before the product with v, as the
reference does. Serves the HAT model's attention and the plain versions
of kernels 8 and 9.
"""

from __future__ import annotations

import torch

NEG = -1e9


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
