"""Kernel 9: the OCAB's overlapping cross-attention with the key/value
gather inside the kernel, as a hand-written CUDA op.

Replaces superresolution_tpu/ops/pallas_flash_oca.py: flash_oca_gathered
(_fwd_impl, _kernel). For each ws x ws query window (wr, wc) of q
[B*nH*nW, ws*ws, C], attention over the ows x ows patch of the padded
key and value maps [B, H+(ows-ws), W+(ows-ws), C] whose corner is at
(wr*ws, wc*ws), token order di*ows + dj:

    out = per head softmax(q k^T hd^-1/2 + bias[h]) v

The maps are zero-padded after the kv dense, so the padded keys are
zero vectors whose logits are the bias alone; they take part in the
softmax and are not masked. On the card this is one launch of
flash_tc.cuh's body (csrc/oca_kernels.cu; kernel 10 shares it):
FlashAttention-2 on the tensor cores (mma.sync), one block for 64
queries of a window and all heads, the window's key and value patch
streamed from the maps through a ring of key tiles in shared memory, so
the gathered [nb, ows*ows, C] tensor of the plain version is never
written.

Bound on the H100: 2 * ows^2 * C MACs per query token (27,648 at C 96
and ows 12), for 4C bytes of q and out plus one read of the two maps:
bound by bytes at the bf16 tensor rate. The kernel also takes one
exponential and one f32 bias value from L2 per logit (see the source).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops.unfold import extract_overlapping_windows
from superresolution_tpu_torch.ops.window_attention import (
    bias_fragments,
    reference_window_attention,
)

# the geometries kernel 9 is instantiated for: (C, heads, ws, ows) at
# overlap 0.5 and 0.25 of 8x8 windows, at 16x16 windows (embed 96 and
# hybrid_astro_h200's 120), and at embed 96 lane-padded to 128 (8 heads
# of 16: infer/lane_pad.py)
OCA_GEOMETRIES = ((96, 6, 8, 12), (96, 6, 8, 10), (96, 6, 16, 24),
                  (120, 6, 16, 24), (128, 8, 8, 12))

__all__ = ["bias_fragments", "flash_oca_gathered",
           "flash_oca_gathered_reference", "oca_gather_supported"]


def oca_gather_supported(ws: int, ows: int, h: int, w: int) -> bool:
    """The geometries the gathered form covers (the reference's rule):
    an even overlap extent no wider than a window, and a map that tiles
    into whole windows."""
    return (ws < ows <= 2 * ws and (ows - ws) % 2 == 0
            and h % ws == 0 and w % ws == 0)


def _grid(q: torch.Tensor, k_map: torch.Tensor, ws: int, ows: int):
    b, hp, wp, c = k_map.shape
    h, w = hp - (ows - ws), wp - (ows - ws)
    nh_w, nw_w = h // ws, w // ws
    if q.shape != (b * nh_w * nw_w, ws * ws, c):
        raise ValueError(f"flash_oca_gathered: q {tuple(q.shape)} != "
                         f"{(b * nh_w * nw_w, ws * ws, c)}")
    if not oca_gather_supported(ws, ows, h, w):
        raise ValueError(f"flash_oca_gathered: unsupported geometry ws={ws} "
                         f"ows={ows} map {h}x{w}")
    return b, nh_w, nw_w


def flash_oca_gathered_reference(q: torch.Tensor, k_map: torch.Tensor,
                                 v_map: torch.Tensor, bias: torch.Tensor,
                                 num_heads: int, ws: int, ows: int
                                 ) -> torch.Tensor:
    """Plain PyTorch version of kernel 9: the unfold gather, then window
    attention with f32 logits and softmax."""
    b, hp, wp, _ = k_map.shape
    nh_w, nw_w = (hp - (ows - ws)) // ws, (wp - (ows - ws)) // ws
    kw = extract_overlapping_windows(k_map, ws, ows, nh_w, nw_w)
    vw = extract_overlapping_windows(v_map, ws, ows, nh_w, nw_w)
    return reference_window_attention(q, kw, vw, bias, num_heads)


def flash_oca_gathered(q: torch.Tensor, k_map: torch.Tensor,
                       v_map: torch.Tensor, bias: torch.Tensor,
                       num_heads: int, ws: int, ows: int, *,
                       fragments: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Kernel 9. q [B*nH*nW, ws*ws, C]; k_map, v_map [B, H+(ows-ws),
    W+(ows-ws), C]; bias [nh, ws*ws, ows*ows] f32 (zeros when the model
    has no OCA rel-pos table). Returns [B*nH*nW, ws*ws, C] in q's dtype.
    CPU tensors run the plain version; CUDA tensors launch the kernel
    ((C, heads, ws, ows) in OCA_GEOMETRIES; bf16 q and maps) or raise.
    fragments: bias_fragments(bias, hd^-1/2), for a caller that made
    them once with the bias; None re-lays the bias at this call."""
    grid = _grid(q, k_map, ws, ows)
    if v_map.shape != k_map.shape:
        raise ValueError(f"flash_oca_gathered: v_map {tuple(v_map.shape)} "
                         f"!= k_map {tuple(k_map.shape)}")
    if tuple(bias.shape) != (num_heads, ws * ws, ows * ows):
        raise ValueError(f"flash_oca_gathered: bias {tuple(bias.shape)} != "
                         f"{(num_heads, ws * ws, ows * ows)}")
    if q.device.type == "cpu":
        return flash_oca_gathered_reference(q, k_map, v_map, bias,
                                            num_heads, ws, ows)
    if (q.shape[-1], num_heads, ws, ows) not in OCA_GEOMETRIES:
        raise ValueError(f"flash_oca_gathered: the kernel takes (C, heads, "
                         f"ws, ows) in {OCA_GEOMETRIES}, got "
                         f"{(q.shape[-1], num_heads, ws, ows)}")
    scale = float(q.shape[-1] // num_heads) ** -0.5
    if fragments is None:
        fragments = bias_fragments(bias, scale)
    elif fragments.numel() != num_heads * ws * ws * -(-ows * ows // 8) * 8:
        raise ValueError(f"flash_oca_gathered: {fragments.numel()} bias "
                         f"fragments for a bias {tuple(bias.shape)}")
    _build.require_cuda(q, k_map, v_map, name="flash_oca_gathered")
    _build.require_cuda(bias, fragments, dtype=torch.float32,
                        name="flash_oca_gathered")
    out = torch.empty_like(q)
    _build.oca(q, k_map, v_map, fragments, num_heads, ws, ows, grid, out)
    flash_oca_gathered.launches += 1
    return out


flash_oca_gathered.launches = 0
