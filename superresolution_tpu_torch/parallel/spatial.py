"""Spatial (image-space) sharding: one image's rows over the 'spatial'
ranks.

Counterpart of superresolution_tpu/parallel/spatial.py: each rank takes
its block of rows, receives `halo` boundary rows from each neighbour
(_HaloExchange, a torch.autograd.Function whose backward sends the
halos' gradients back to the ranks they came from, as the transpose of
the reference's ppermute does), runs the SR net on the padded block and
crops the halo from its upscaled output. The global top and bottom edges
are 'replicate' for inference (the tiled-inference border) and 'zero'
for the training objective (device-count-invariant). Exact away from the
border whenever the net's half receptive field is at most `halo`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce_sum,
    exchange,
    sum_grad_over,
)


class _HaloExchange(torch.autograd.Function):
    """blk [B, h, W, C] -> (the `halo` rows above it, the `halo` rows
    below it) from the neighbouring ranks; zeros at the global edges."""

    @staticmethod
    def forward(ctx, blk: torch.Tensor, halo: int, mesh: Mesh):
        ranks = mesh.axis_ranks("spatial")
        i, n = mesh.coord("spatial"), len(ranks)
        edge = blk[:, :halo]
        sends, recvs = [], []
        if i > 0:
            sends.append((blk[:, :halo], ranks[i - 1]))
            recvs.append((edge, ranks[i - 1]))
        if i < n - 1:
            sends.append((blk[:, -halo:], ranks[i + 1]))
            recvs.append((edge, ranks[i + 1]))
        got = exchange(sends, recvs, mesh.group("spatial"))
        above = got.pop(0) if i > 0 else torch.zeros_like(edge)
        below = got.pop(0) if i < n - 1 else torch.zeros_like(edge)
        ctx.halo, ctx.mesh, ctx.shape = halo, mesh, blk.shape
        return above, below

    @staticmethod
    def backward(ctx, g_above, g_below):
        mesh, halo = ctx.mesh, ctx.halo
        ranks = mesh.axis_ranks("spatial")
        i, n = mesh.coord("spatial"), len(ranks)
        grad = g_above.new_zeros(ctx.shape)
        like = grad[:, :halo]
        sends, recvs = [], []
        if i > 0:  # my top rows were the upper rank's `below`
            sends.append((g_above, ranks[i - 1]))
            recvs.append((like, ranks[i - 1]))
        if i < n - 1:  # my bottom rows were the lower rank's `above`
            sends.append((g_below, ranks[i + 1]))
            recvs.append((like, ranks[i + 1]))
        got = exchange(sends, recvs, mesh.group("spatial"))
        if i > 0:
            grad[:, :halo] += got.pop(0)
        if i < n - 1:
            grad[:, -halo:] += got.pop(0)
        return grad, None, None


def _halo_exchange(blk: torch.Tensor, halo: int, mesh: Mesh,
                   edge_mode: str) -> torch.Tensor:
    """This rank's row block padded with its neighbours' `halo` boundary
    rows; the global top/bottom edges by edge_mode, 'replicate'
    (inference) or 'zero' (training)."""
    above, below = _HaloExchange.apply(blk, halo, mesh)
    i, n = mesh.coord("spatial"), mesh.shape["spatial"]
    if i == 0:
        above = (blk[:, :1].expand(-1, halo, -1, -1)
                 if edge_mode == "replicate" else torch.zeros_like(above))
    if i == n - 1:
        below = (blk[:, -1:].expand(-1, halo, -1, -1)
                 if edge_mode == "replicate" else torch.zeros_like(below))
    return torch.cat([above, blk, below], dim=1)


def _check(h: int, n: int, halo: int) -> None:
    if h % n:
        raise ValueError(f"H={h} not divisible by spatial axis size {n}")
    if h // n < halo:
        raise ValueError(f"block height {h // n} < halo {halo}")


def spatial_shard_apply(mesh: Mesh, fn, img: torch.Tensor, halo: int,
                        scale: int) -> torch.Tensor:
    """Apply `fn` (NHWC -> NHWC, x`scale`) to `img` [B, H, W, C] (the same
    on every rank) with its rows sharded over the 'spatial' ranks and the
    halos exchanged; every rank returns the whole upscaled image. H must
    divide over the axis, and each block be at least `halo` rows."""
    n = mesh.shape["spatial"]
    if n == 1:
        return fn(img)
    _check(img.shape[1], n, halo)
    rows = img.shape[1] // n
    i = mesh.coord("spatial")
    padded = _halo_exchange(img[:, i * rows:(i + 1) * rows], halo, mesh,
                            "replicate")
    out = fn(padded)
    out = out[:, halo * scale: out.shape[1] - halo * scale]
    return torch.cat(all_gather(out, mesh.group("spatial")), dim=1)


def make_spatial_loss(mesh: Mesh, apply_fn, loss_sum_fn, halo: int,
                      scale: int):
    """Spatial-parallel training objective: loss_fn(params, lr, hr), lr and
    hr the same on every rank, the image rows sharded over 'spatial'.

    Each rank runs apply_fn(params, block) on its halo-padded row block
    (the global top/bottom halos ZERO rows) and loss_sum_fn(pred, hr)
    (the SUM of per-element losses) on its rows; the loss is the sum over
    ranks over hr.numel(), the same value on every rank, and equal to
    the unsharded forward on the halo-zero-padded image, cropped. Only
    this rank's term carries its gradient (a loss written as
    all_reduce(local) / denom would, on the backward of every rank,
    count each gradient once per rank); the parameters' (and lr's)
    gradients are summed over the ranks in the backward, so
    torch.autograd.grad of the loss gives every rank the whole gradient,
    as jax.value_and_grad of the reference's loss does.
    """
    n = mesh.shape["spatial"]

    def loss_fn(params: dict, lr: torch.Tensor, hr: torch.Tensor):
        h = lr.shape[1]
        denom = float(hr.numel())
        if n == 1:
            # the same objective as the sharded path (zero-halo pad, crop)
            x = F.pad(lr, (0, 0, 0, 0, halo, halo))
            out = apply_fn(params, x)
            out = out[:, halo * scale: out.shape[1] - halo * scale]
            return loss_sum_fn(out, hr) / denom
        _check(h, n, halo)
        group = mesh.group("spatial")
        params = sum_grad_over(params, group)
        if lr.requires_grad:
            lr = sum_grad_over({"lr": lr}, group)["lr"]
        i, rows, hrows = mesh.coord("spatial"), h // n, hr.shape[1] // n
        padded = _halo_exchange(lr[:, i * rows:(i + 1) * rows], halo, mesh,
                                "zero")
        out = apply_fn(params, padded)
        out = out[:, halo * scale: out.shape[1] - halo * scale]
        local = loss_sum_fn(out, hr[:, i * hrows:(i + 1) * hrows])
        total = all_reduce_sum(local.detach(), group)
        return (total + (local - local.detach())) / denom

    return loss_fn
