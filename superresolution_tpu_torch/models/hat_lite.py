"""HATLite, the windowed-attention refiner of the hybrid, in eager PyTorch.

Counterpart of superresolution_tpu/models/hat_lite.py. Parameter names
follow HAT (conv_first, layers.{g}.residual_group.blocks.{i}.{norm1,
attn.qkv, attn.proj, attn.relative_position_bias_table, conv_block.cab.*,
norm2, mlp.fc1, mlp.fc2}, layers.{g}.overlap_attn.*, layers.{g}.conv,
conv_after_body, upsample.{2j}, conv_last; with hat_compat also
patch_embed.norm, norm, conv_before_upsample.0 and the OCAB's
relative_position_bias_table), so models/convert.py's bridged JAX trees
and the reference ecosystem's stage2.* keys load with strict=True.

The public forward takes and returns NHWC; blocks run NHWC (LayerNorm and
Linear on the channel axis), convs NCHW. The attention is the plain form
(ops/window_attention.py), with f32 logits unless attn_f32=False; with
flash_attn (window attention) and flash_oca (the group-end OCAB, which
follows flash_attn when None) it is kernel 10, whose logits are always
f32: a HAB's self-attention through its map form
(ops/window_attention.flash_map_attention: the qkv linear on the LN map,
the attention read from that map with the shift as addressing, the proj
linear on the output map, so no roll, partition or merge), the OCAB's
through flash_window_attention on its windows. The deploy path (infer/fused_hat.py) does not run these modules: it
runs kernels 7-10 on the same weights.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from superresolution_tpu_torch.models.common import (
    Conv,
    pixel_shuffle_stages,
    remat,
)
from superresolution_tpu_torch.ops.unfold import extract_overlapping_windows
from superresolution_tpu_torch.ops.window_attention import (
    flash_map_attention,
    flash_window_attention,
    reference_window_attention,
    shift_region_ids,
    window_merge,
    window_partition,
)
from superresolution_tpu_torch.runtime import resolve_device


@lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """Swin relative-position index table [n, n] for a ws x ws window."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


@lru_cache(maxsize=None)
def relative_position_index_oca(ws: int, wse: int) -> np.ndarray:
    """Index [ws^2, wse^2] between a ws-window of queries and the enlarged
    wse-window of keys (HAT's rpi_oca); table size (ws + wse - 1)^2."""
    def grid(n):
        return np.stack(np.meshgrid(np.arange(n), np.arange(n),
                                    indexing="ij")).reshape(2, -1)

    rel = grid(wse)[:, None, :] - grid(ws)[:, :, None]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (ws + wse - 1) + rel[..., 1]).astype(np.int32)


def _trunc_normal_(t: torch.Tensor, std: float,
                   generator: torch.Generator | None) -> torch.Tensor:
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def _linear(cin: int, cout: int, generator) -> nn.Linear:
    """Dense layer with the JAX package's init: LeCun truncated normal
    kernel, zero bias."""
    lin = nn.Linear(cin, cout, device="cpu")
    _trunc_normal_(lin.weight, math.sqrt(1.0 / cin) / 0.87962566103423978,
                   generator)
    nn.init.zeros_(lin.bias)
    return lin


def _conv1x1(cin: int, cout: int, generator) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, 1, device="cpu")
    _trunc_normal_(conv.weight, math.sqrt(1.0 / cin) / 0.87962566103423978,
                   generator)
    nn.init.zeros_(conv.bias)
    return conv


def _nchw(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW module to an NHWC tensor."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 attn_f32: bool = True, flash: bool = False,
                 generator=None):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.attn_f32, self.flash = attn_f32, flash
        self.qkv = _linear(dim, 3 * dim, generator)
        self.relative_position_bias_table = nn.Parameter(_trunc_normal_(
            torch.empty((2 * window_size - 1) ** 2, num_heads), 0.02,
            generator))
        self.proj = _linear(dim, dim, generator)

    def bias(self) -> torch.Tensor:
        """The relative-position bias [heads, n, n] of a window."""
        n = self.window_size ** 2
        idx = torch.as_tensor(relative_position_index(self.window_size),
                              device=self.relative_position_bias_table.device
                              ).long()
        return self.relative_position_bias_table[idx.reshape(-1)].reshape(
            n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor,
                region_ids: torch.Tensor | None) -> torch.Tensor:
        """x [nB, n, C] windows; region_ids [nW, n] Swin shift labels or
        None for unshifted blocks."""
        c = x.shape[2]
        q, k, v = self.qkv(x).split(c, dim=-1)
        bias = self.bias()
        if self.flash:
            out = flash_window_attention(q, k, v, bias, self.num_heads,
                                         region_ids)
        else:
            out = reference_window_attention(
                q, k, v, bias, region_ids=region_ids,
                acc_dtype=torch.float32 if self.attn_f32 else x.dtype)
        return self.proj(out)


class ChannelAttention(nn.Module):
    """Squeeze-excite: x * sigmoid(conv(relu(conv(mean_hw(x)))))."""

    def __init__(self, dim: int, squeeze: int, generator=None):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), _conv1x1(dim, squeeze, generator),
            nn.ReLU(), _conv1x1(squeeze, dim, generator), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.attention(x)


class CAB(nn.Module):
    """HAT's channel-attention block (NCHW): conv -> GELU -> conv -> SE."""

    def __init__(self, dim: int, compress_ratio: int = 3,
                 squeeze_factor: int = 30, generator=None):
        super().__init__()
        mid = dim // compress_ratio
        self.cab = nn.Sequential(
            Conv(dim, mid, generator=generator), nn.GELU(),
            Conv(mid, dim, generator=generator),
            ChannelAttention(dim, max(1, dim // squeeze_factor), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cab(x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, generator=None):
        super().__init__()
        self.fc1 = _linear(dim, hidden, generator)
        self.act = nn.GELU()
        self.fc2 = _linear(hidden, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class HABlock(nn.Module):
    """Hybrid attention block: (shifted) W-MSA + conv_scale * CAB, then
    MLP, pre-norm. NHWC."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: float = 2.0,
                 conv_scale: float = 0.01, attn_f32: bool = True,
                 flash_attn: bool = False, generator=None):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.conv_scale = conv_scale
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device="cpu")
        self.conv_block = CAB(dim, generator=generator)
        self.attn = WindowAttention(dim, num_heads, window_size, attn_f32,
                                    flash_attn, generator)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device="cpu")
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator)

    def attend_windows(self, y: torch.Tensor) -> torch.Tensor:
        """The (shifted) window attention of the LN map y: roll, window
        partition, self.attn on the windows, merge, roll back."""
        _, h, w, _ = y.shape
        ws, s = self.window_size, self.shift
        ids = None
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            ids = torch.as_tensor(shift_region_ids(h, w, ws, s),
                                  device=y.device)
        y = window_merge(self.attn(window_partition(y, ws), ids), ws, (h, w))
        return torch.roll(y, (s, s), dims=(1, 2)) if s else y

    def attend_map(self, y: torch.Tensor) -> torch.Tensor:
        """The same on kernel 10's map form: the qkv and proj linears are
        per pixel, so they commute with the partition, and the attention
        reads q, k, v from the qkv map with the shift as addressing (no
        roll, partition or merge written)."""
        a = self.attn
        return a.proj(flash_map_attention(a.qkv(y), a.bias(), a.num_heads,
                                          self.window_size, self.shift))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        cab = _nchw(self.conv_block, y)
        y = self.attend_map(y) if self.attn.flash else self.attend_windows(y)
        x = x + y + torch.tensor(self.conv_scale, dtype=x.dtype) * cab
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    """HAT's overlapping cross-attention block: queries from ws-windows,
    keys/values from the (1 + overlap) * ws windows around them, gathered
    from the zero-padded kv map (asymmetric tail pad for odd ows - ws, as
    the JAX model defines it). qkv packs q first, then k, v. NHWC."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 overlap_ratio: float = 0.5, use_rpb: bool = False,
                 attn_f32: bool = True, flash: bool = False,
                 generator=None):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.ows = int(window_size * (1 + overlap_ratio))
        self.use_rpb, self.attn_f32, self.flash = use_rpb, attn_f32, flash
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device="cpu")
        self.qkv = _linear(dim, 3 * dim, generator)
        if use_rpb:
            self.relative_position_bias_table = nn.Parameter(
                _trunc_normal_(torch.empty(
                    (window_size + self.ows - 1) ** 2, num_heads), 0.02,
                    generator))
        self.proj = _linear(dim, dim, generator)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device="cpu")
        self.mlp = Mlp(dim, dim * 2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, c = x.shape
        ws, ows, nh = self.window_size, self.ows, self.num_heads
        pad = (ows - ws) // 2
        qkv = self.qkv(self.norm1(x))
        q = window_partition(qkv[..., :c], ws)
        kv = F.pad(qkv[..., c:], (0, 0, pad, ows - ws - pad,
                                  pad, ows - ws - pad))
        k, v = extract_overlapping_windows(kv, ws, ows, h // ws,
                                           w // ws).split(c, dim=-1)
        bias = None
        if self.use_rpb:
            idx = torch.as_tensor(relative_position_index_oca(ws, ows),
                                  device=x.device).long()
            bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(
                ws * ws, ows * ows, nh).permute(2, 0, 1)
        if self.flash:
            if bias is None:
                bias = torch.zeros((nh, ws * ws, ows * ows),
                                   device=x.device)
            out = flash_window_attention(q, k, v, bias, nh)
        else:
            out = reference_window_attention(
                q, k, v, bias, num_heads=nh,
                acc_dtype=torch.float32 if self.attn_f32 else x.dtype)
        x = x + window_merge(self.proj(out), ws, (h, w))
        return x + self.mlp(self.norm2(x))


class _Blocks(nn.Module):
    """Holds `blocks`, so the keys read residual_group.blocks.{i} as in
    HAT."""

    def __init__(self, blocks: list[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class ResidualGroup(nn.Module):
    """depth HABs (even ones unshifted, odd ones shifted by ws/2), the
    group-end OCAB and a conv, around a residual. NHWC. With remat, each
    HAB pair (the reference's scan unit, when scan_blocks and depth >= 2)
    and the OCAB recompute their activations in the backward; an odd
    last HAB does not, as in the reference."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float = 2.0,
                 conv_scale: float = 0.01, overlap_ratio: float = 0.5,
                 oca_rpb: bool = False, attn_f32: bool = True,
                 remat: bool = False, scan_blocks: bool = True,
                 flash_attn: bool = False, flash_oca: bool = False,
                 generator=None):
        super().__init__()
        self.remat = remat
        self.pairs = depth // 2 if scan_blocks and depth >= 2 else 0
        self.residual_group = _Blocks([
            HABlock(dim, num_heads, window_size,
                    0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                    conv_scale, attn_f32, flash_attn, generator)
            for i in range(depth)])
        self.overlap_attn = OCAB(dim, num_heads, window_size, overlap_ratio,
                                 oca_rpb, attn_f32, flash_oca, generator)
        self.conv = Conv(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        blocks = self.residual_group.blocks
        for i, blk in enumerate(blocks):
            if self.remat and i < 2 * self.pairs:
                if i % 2 == 0:
                    y = remat(nn.Sequential(blk, blocks[i + 1]), y)
            else:
                y = blk(y)
        y = (remat(self.overlap_attn, y) if self.remat
             else self.overlap_attn(y))
        return x + _nchw(self.conv, y)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5, device="cpu")


class HATLite(nn.Module):
    """The JAX HATLite's fields and forward. scan_blocks names the JAX
    tree's layout (models/convert.py reads it) and, as there, makes HAB
    pairs the remat unit; remat recomputes each pair's and each OCAB's
    activations in the backward (ResidualGroup). flash_attn runs every
    window attention, and flash_oca (None: follow flash_attn) every OCAB,
    through kernel 10. Parameters are made on the
    CPU from `generator` (MSRA convs, LeCun
    dense layers, zero biases, unit LayerNorms, N(0, 0.02) rel-pos tables
    truncated at 2 sigma) and moved to `device` (default cuda; raises
    without a GPU unless device='cpu')."""

    def __init__(self, scale: int = 2, in_channels: int = 1,
                 out_channels: int = 1, embed_dim: int = 96,
                 depths: tuple[int, ...] = (6, 6, 6, 6),
                 num_heads: tuple[int, ...] = (6, 6, 6, 6),
                 window_size: int = 8, mlp_ratio: float = 2.0,
                 conv_scale: float = 0.01, overlap_ratio: float = 0.5,
                 scan_blocks: bool = True, hat_compat: bool = False,
                 upsample_feat: int = 64, attn_f32: bool = True,
                 remat: bool = False, flash_attn: bool = False,
                 flash_oca: bool | None = None,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.scale, self.window_size = scale, window_size
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.embed_dim, self.in_channels = embed_dim, in_channels
        self.out_channels, self.mlp_ratio = out_channels, mlp_ratio
        self.conv_scale, self.overlap_ratio = conv_scale, overlap_ratio
        self.scan_blocks, self.hat_compat = scan_blocks, hat_compat
        self.upsample_feat, self.attn_f32 = upsample_feat, attn_f32
        self.flash_attn, self.flash_oca = flash_attn, flash_oca
        self.remat = remat
        gen = generator
        foca = flash_attn if flash_oca is None else flash_oca
        c = embed_dim
        self.conv_first = Conv(in_channels, c, generator=gen)
        if hat_compat:
            self.patch_embed = _PatchEmbed(c)
        self.layers = nn.ModuleList([
            ResidualGroup(c, d, nh, window_size, mlp_ratio, conv_scale,
                          overlap_ratio, hat_compat, attn_f32, remat,
                          scan_blocks, flash_attn, foca, gen)
            for d, nh in zip(depths, num_heads)])
        if hat_compat:
            self.norm = nn.LayerNorm(c, eps=1e-5, device="cpu")
        self.conv_after_body = Conv(c, c, generator=gen)
        feat = c
        if hat_compat:
            feat = upsample_feat
            self.conv_before_upsample = nn.Sequential(
                Conv(c, feat, generator=gen), nn.LeakyReLU(0.01))
        ups = []
        for r in pixel_shuffle_stages(scale):
            ups += [Conv(feat, feat * r * r, generator=gen),
                    nn.PixelShuffle(r)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = Conv(feat, out_channels, generator=gen)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, in] -> [B, H*scale, W*scale, out]. Sides that are not
        multiples of the window are edge-padded, and the output cropped."""
        _, h, w, _ = x.shape
        ws = self.window_size
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = x.permute(0, 3, 1, 2)
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="replicate")
        feat = self.conv_first(x).permute(0, 2, 3, 1)
        y = feat
        if self.hat_compat:
            y = self.patch_embed.norm(y)
        for layer in self.layers:
            y = layer(y)
        if self.hat_compat:
            y = self.norm(y)
        y = (self.conv_after_body(y.permute(0, 3, 1, 2))
             + feat.permute(0, 3, 1, 2))
        if self.hat_compat:
            y = self.conv_before_upsample(y)
        y = self.conv_last(self.upsample(y)).permute(0, 2, 3, 1)
        return y[:, :h * self.scale, :w * self.scale]
