"""The two models of the benchmark's configurations as plain functions of
a state dict: ESRGAN's RRDBNet (Wang et al. 2018, BasicSR's `RRDBNet`
and key names) and the hybrid of GDev96/SuperResolution (an RRDBNet
stage, a binomial blur, a HATLite stage after Chen et al. 2023's HAT
with HAT's key names, a blur, the light blur).

`specs(...)` lists each parameter's name, shape and init rule; the
benchmark draws the values from its seed (portbench/weights.py), and the
port and these functions read the same dict. Everything runs in float32
unless `pr` rounds the operands of the products (ops.Precision).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.ops import (
    F32,
    Precision,
    binomial_blur,
    conv,
    conv_nhwc,
    layer_norm,
    linear,
    lrelu,
)

# ---- parameter lists -------------------------------------------------


def _conv_spec(name, cin, cout, k=3, scale=1.0, bias=True):
    out = [(f"{name}.weight", (cout, cin, k, k), ("msra", scale))]
    if bias:
        out.append((f"{name}.bias", (cout,), ("bias",)))
    return out


def _linear_spec(name, cin, cout):
    return [(f"{name}.weight", (cout, cin), ("lecun",)),
            (f"{name}.bias", (cout,), ("bias",))]


def _ln_spec(name, c):
    return [(f"{name}.weight", (c,), ("ones",)),
            (f"{name}.bias", (c,), ("bias",))]


def rrdbnet_specs(m: dict) -> list:
    """RRDBNet: conv_first, num_block RRDBs of three 5-conv dense blocks
    (init scaled by 0.1, as BasicSR's default_init_weights), conv_body,
    the upsampler's convs, conv_hr and conv_last ('out' init: the output
    layer, see weights.py)."""
    c, g = m["num_feat"], m["num_grow_ch"]
    out = _conv_spec("conv_first", m["num_in_ch"], c)
    for i in range(m["num_block"]):
        for k in range(1, 4):
            for j in range(1, 6):
                out += _conv_spec(f"body.{i}.rdb{k}.conv{j}",
                                  c + (j - 1) * g, g if j < 5 else c,
                                  scale=0.1)
    out += _conv_spec("conv_body", c, c)
    for n, r in enumerate(up_stages(m), 1):
        cout = c if m["upsampler"] == "nearest_conv" else c * r * r
        out += _conv_spec(f"conv_up{n}", c, cout)
    out += _conv_spec("conv_hr", c, c)
    w, b = _conv_spec("conv_last", c, m["num_out_ch"])
    return out + [(w[0], w[1], ("out",)), (b[0], b[1], ("out_bias",))]


def hat_specs(h: dict) -> list:
    c, ws = h["embed_dim"], h["window_size"]
    mlp = int(c * h["mlp_ratio"])
    out = _conv_spec("conv_first", h["in_chans"], c)
    for gi, (depth, nh) in enumerate(zip(h["depths"], h["num_heads"])):
        pre = f"layers.{gi}"
        for i in range(depth):
            b = f"{pre}.residual_group.blocks.{i}"
            mid, sq = c // h["compress_ratio"], max(1, c // h["squeeze_factor"])
            out += _ln_spec(f"{b}.norm1", c)
            out += _conv_spec(f"{b}.conv_block.cab.0", c, mid)
            out += _conv_spec(f"{b}.conv_block.cab.2", mid, c)
            out += _conv_spec(f"{b}.conv_block.cab.3.attention.1", c, sq, k=1)
            out += _conv_spec(f"{b}.conv_block.cab.3.attention.3", sq, c, k=1)
            out += _linear_spec(f"{b}.attn.qkv", c, 3 * c)
            out.append((f"{b}.attn.relative_position_bias_table",
                        ((2 * ws - 1) ** 2, nh), ("normal", 0.02)))
            out += _linear_spec(f"{b}.attn.proj", c, c)
            out += _ln_spec(f"{b}.norm2", c)
            out += _linear_spec(f"{b}.mlp.fc1", c, mlp)
            out += _linear_spec(f"{b}.mlp.fc2", mlp, c)
        o = f"{pre}.overlap_attn"
        out += _ln_spec(f"{o}.norm1", c)
        out += _linear_spec(f"{o}.qkv", c, 3 * c)
        out += _linear_spec(f"{o}.proj", c, c)
        out += _ln_spec(f"{o}.norm2", c)
        out += _linear_spec(f"{o}.mlp.fc1", c, 2 * c)
        out += _linear_spec(f"{o}.mlp.fc2", 2 * c, c)
        out += _conv_spec(f"{pre}.conv", c, c)
    out += _conv_spec("conv_after_body", c, c)
    for j, r in enumerate(_shuffle_stages(h["upscale"])):
        out += _conv_spec(f"upsample.{2 * j}", c, c * r * r)
    w, b = _conv_spec("conv_last", c, h["in_chans"])
    return out + [(w[0], w[1], ("out",)), (b[0], b[1], ("out_bias",))]


def hybrid_specs(cfg: dict) -> list:
    return ([(f"stage1.{n}", s, i) for n, s, i in rrdbnet_specs(
                cfg["stage1"])]
            + [(f"stage2.{n}", s, i) for n, s, i in hat_specs(
                cfg["stage2"])])


def sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


# ---- RRDBNet ----------------------------------------------------------


def _shuffle_stages(scale: int) -> tuple:
    return {1: (), 2: (2,), 3: (3,), 4: (2, 2), 8: (2, 2, 2)}[scale]


def up_stages(m: dict) -> tuple:
    if m["upsampler"] == "nearest_conv":
        return (2,) * (m["scale"].bit_length() - 1)
    return _shuffle_stages(m["scale"])


def dense_block(p: dict, pre: str, x: torch.Tensor, pr: Precision
                ) -> torch.Tensor:
    feats = [x]
    for j in range(1, 5):
        feats.append(lrelu(conv(torch.cat(feats, 1), p, f"{pre}.conv{j}",
                                pr)))
    return x + conv(torch.cat(feats, 1), p, f"{pre}.conv5", pr) * 0.2


def rrdb(p: dict, i: int, x: torch.Tensor, pr: Precision) -> torch.Tensor:
    y = x
    for k in range(1, 4):
        y = dense_block(p, f"body.{i}.rdb{k}", y, pr)
    return x + y * 0.2


def rrdbnet_trunk(p: dict, m: dict, x: torch.Tensor, pr: Precision = F32,
                  checkpoint: bool = False) -> torch.Tensor:
    """NHWC input -> NCHW LR features (conv_first, the RRDBs, conv_body
    plus the head)."""
    x = head = conv(x.permute(0, 3, 1, 2), p, "conv_first", pr)
    for i in range(m["num_block"]):
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(
                rrdb, p, i, x, pr, use_reentrant=False)
        else:
            x = rrdb(p, i, x, pr)
    return conv(x, p, "conv_body", pr) + head


def rrdbnet_tail(p: dict, m: dict, x: torch.Tensor, pr: Precision = F32
                 ) -> torch.Tensor:
    """NCHW LR features -> NHWC output, unclipped."""
    for n, r in enumerate(up_stages(m), 1):
        if m["upsampler"] == "nearest_conv":
            x = lrelu(conv(F.interpolate(x, scale_factor=2, mode="nearest"),
                           p, f"conv_up{n}", pr))
        else:
            x = lrelu(F.pixel_shuffle(conv(x, p, f"conv_up{n}", pr), r))
    x = conv(lrelu(conv(x, p, "conv_hr", pr)), p, "conv_last", pr)
    return x.permute(0, 2, 3, 1)


def rrdbnet(p: dict, m: dict, x: torch.Tensor, pr: Precision = F32,
            checkpoint: bool = False) -> torch.Tensor:
    return rrdbnet_tail(p, m, rrdbnet_trunk(p, m, x, pr, checkpoint), pr)


# ---- HATLite ----------------------------------------------------------

NEG = -1e9


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nH*nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_merge(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@lru_cache(maxsize=None)
def shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Swin's additive mask [nW, n, n] of a shifted window pass: 0 where
    two positions lie in the same region of the rolled map, NEG
    elsewhere."""
    img = np.zeros((h, w), np.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    ids = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    ids = ids.reshape(-1, ws * ws)
    return np.where(ids[:, :, None] == ids[:, None, :], 0.0,
                    NEG).astype(np.float32)


def attention(q, k, v, nh: int, bias, mask, pr: Precision) -> torch.Tensor:
    """Multi-head softmax attention of windows: q [nb, n, C], k, v
    [nb, m, C]; bias [nh, n, m] or None; mask [nW, n, m] (window b takes
    mask[b % nW]) or None. Logits and softmax in float32."""
    nb, n, c = q.shape
    m, hd = k.shape[1], c // nh
    qh = pr.q(q).reshape(nb, n, nh, hd).transpose(1, 2)
    kh = pr.q(k).reshape(nb, m, nh, hd).transpose(1, 2)
    vh = pr.q(v).reshape(nb, m, nh, hd).transpose(1, 2)
    a = (qh @ kh.transpose(-1, -2)) * hd ** -0.5
    if bias is not None:
        a = a + bias
    if mask is not None:
        nw = mask.shape[0]
        a = (a.reshape(nb // nw, nw, nh, n, m) + mask[None, :, None]
             ).reshape(nb, nh, n, m)
    a = pr.q(torch.softmax(a, dim=-1))
    return (a @ vh).transpose(1, 2).reshape(nb, n, c)


def _cab(p: dict, pre: str, y: torch.Tensor, pr: Precision) -> torch.Tensor:
    """conv -> GELU -> conv -> squeeze-excite, NHWC in and out."""
    t = y.permute(0, 3, 1, 2)
    t = conv(F.gelu(conv(t, p, f"{pre}.0", pr)), p, f"{pre}.2", pr)
    s = t.mean((2, 3), keepdim=True)
    s = torch.sigmoid(conv(torch.relu(conv(s, p, f"{pre}.3.attention.1",
                                            pr)),
                           p, f"{pre}.3.attention.3", pr))
    return (t * s).permute(0, 2, 3, 1)


def _mlp(p: dict, pre: str, x: torch.Tensor, pr: Precision) -> torch.Tensor:
    return linear(F.gelu(linear(x, p, f"{pre}.fc1", pr)), p, f"{pre}.fc2", pr)


def hab(p: dict, pre: str, x: torch.Tensor, nh: int, ws: int, shift: int,
        conv_scale: float, pr: Precision) -> torch.Tensor:
    _, h, w, c = x.shape
    y = layer_norm(x, p, f"{pre}.norm1")
    cab = _cab(p, f"{pre}.conv_block.cab", y, pr)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    q, k, v = linear(window_partition(y, ws), p, f"{pre}.attn.qkv",
                     pr).split(c, dim=-1)
    n = ws * ws
    idx = torch.as_tensor(relative_position_index(ws), device=x.device)
    bias = p[f"{pre}.attn.relative_position_bias_table"][idx.reshape(-1)]
    bias = bias.reshape(n, n, nh).permute(2, 0, 1)
    mask = (torch.as_tensor(shift_mask(h, w, ws, shift), device=x.device)
            if shift else None)
    a = linear(attention(q, k, v, nh, bias, mask, pr), p,
               f"{pre}.attn.proj", pr)
    a = window_merge(a, ws, h, w)
    if shift:
        a = torch.roll(a, (shift, shift), dims=(1, 2))
    x = x + a + conv_scale * cab
    return x + _mlp(p, f"{pre}.mlp", layer_norm(x, p, f"{pre}.norm2"), pr)


def ocab(p: dict, pre: str, x: torch.Tensor, nh: int, ws: int, ows: int,
         pr: Precision) -> torch.Tensor:
    """HAT's overlapping cross-attention: queries from ws-windows, keys
    and values from the ows-windows around them in the zero-padded map
    (the odd remainder of ows - ws padded at the tail), no bias."""
    b, h, w, c = x.shape
    pad = (ows - ws) // 2
    qkv = linear(layer_norm(x, p, f"{pre}.norm1"), p, f"{pre}.qkv", pr)
    q = window_partition(qkv[..., :c], ws)
    kv = F.pad(qkv[..., c:], (0, 0, pad, ows - ws - pad, pad,
                              ows - ws - pad))
    win = kv.unfold(1, ows, ws).unfold(2, ows, ws)[:, :h // ws, :w // ws]
    win = win.permute(0, 1, 2, 4, 5, 3).reshape(-1, ows * ows, 2 * c)
    k, v = win.split(c, dim=-1)
    out = linear(attention(q, k, v, nh, None, None, pr), p, f"{pre}.proj",
                 pr)
    x = x + window_merge(out, ws, h, w)
    return x + _mlp(p, f"{pre}.mlp", layer_norm(x, p, f"{pre}.norm2"), pr)


def _group(p, gi, y, depth, nh, hc, pr):
    ws = hc["window_size"]
    ows = int(ws * (1 + hc["overlap_ratio"]))
    pre = f"layers.{gi}"
    x = y
    for i in range(depth):
        y = hab(p, f"{pre}.residual_group.blocks.{i}", y, nh, ws,
                0 if i % 2 == 0 else ws // 2, hc["conv_scale"], pr)
    y = ocab(p, f"{pre}.overlap_attn", y, nh, ws, ows, pr)
    return x + conv_nhwc(y, p, f"{pre}.conv", pr)


def hatlite(p: dict, hc: dict, x: torch.Tensor, pr: Precision = F32,
            checkpoint: bool = False) -> torch.Tensor:
    """NHWC [B, H, W, in] -> [B, H*s, W*s, in]; sides that are not
    multiples of the window are edge-padded and the output cropped."""
    _, h, w, _ = x.shape
    ws = hc["window_size"]
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    t = x.permute(0, 3, 1, 2)
    if ph or pw:
        t = F.pad(t, (0, pw, 0, ph), mode="replicate")
    feat = conv(t, p, "conv_first", pr).permute(0, 2, 3, 1)
    y = feat
    for gi, (depth, nh) in enumerate(zip(hc["depths"], hc["num_heads"])):
        if checkpoint:
            y = torch.utils.checkpoint.checkpoint(
                _group, p, gi, y, depth, nh, hc, pr, use_reentrant=False)
        else:
            y = _group(p, gi, y, depth, nh, hc, pr)
    t = (conv(y.permute(0, 3, 1, 2), p, "conv_after_body", pr)
         + feat.permute(0, 3, 1, 2))
    for j, r in enumerate(_shuffle_stages(hc["upscale"])):
        t = F.pixel_shuffle(conv(t, p, f"upsample.{2 * j}", pr), r)
    t = conv(t, p, "conv_last", pr).permute(0, 2, 3, 1)
    s = hc["upscale"]
    return t[:, :h * s, :w * s]


def hybrid(p: dict, cfg: dict, x: torch.Tensor, output_size: int | None,
           pr: Precision = F32, checkpoint: bool = False) -> torch.Tensor:
    """The hybrid's forward on NHWC x: stage 1, blur, stage 2, blur, the
    light blur. The benchmark's cells never resize: the stage output
    already has output_size (or output_size is None)."""
    sm = cfg["smoothing"]
    y = binomial_blur(rrdbnet(sub(p, "stage1."), cfg["stage1"], x, pr,
                              checkpoint), sm)
    y = binomial_blur(hatlite(sub(p, "stage2."), cfg["stage2"], y, pr,
                              checkpoint), sm)
    if output_size and y.shape[1] != output_size:
        raise ValueError(f"the reference does not resize ({y.shape[1]} -> "
                         f"{output_size})")
    return binomial_blur(y, "light" if sm else None)
