"""Pipeline parallelism: model stages over the mesh's 'pipe' ranks.

Counterpart of superresolution_tpu/parallel/pipeline.py. The reference
gets its pipeline from autodiff through a ppermute ring inside one SPMD
program; torch's send/recv are not differentiable, so the port writes
the GPipe schedule itself (`_Pipeline`, a torch.autograd.Function):

  * forward: stage s (pipe rank s) takes microbatch t from stage s-1
    (stage 0 from x), runs its blocks on it, keeps the graph, and sends
    the result on; the last stage's outputs are broadcast to every pipe
    rank, so each holds the whole [M, mb, ...] as the reference's psum
    leaves it;
  * backward: the last stage starts from its own copy of the output's
    gradient (every rank's is the same: what runs downstream is
    replicated), and each stage backpropagates microbatch t through its
    kept graph and sends the input's gradient to stage s-1; stage 0's
    input gradient is broadcast to every pipe rank, and every stage's
    parameter gradients (zero for the stages a rank does not run) are
    summed over the pipe ranks, so every rank ends with the whole
    gradient of every input, as jax.grad gives it.

With batch_axis ('data'), each data rank runs its rows of every
microbatch and the outputs, input gradients and parameter gradients are
gathered or summed over the data ranks the same way. The result is the
sequential loop's, to f.p. reassociation.

Stage s holds blocks [s * slots, min((s + 1) * slots, n_items)) with
slots = ceil(n_items / n_stages), as split_scan_params lays them out; the
reference's zero-padded slots exist only to keep one SPMD program, so
the port runs no pad slot (split_scan_params is kept, with its mask).
Stage weights are stored replicated on every rank, as there. The RRDB
trunk's blocks run through kernel 13's op (B1 forward, kernel 13
backward on the card; train/fused_apply.rrdb_block) when the model
takes it, and HATLite's residual groups as the module runs them.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.func import functional_call

from superresolution_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce_flat,
    broadcast,
    exchange,
)


def _data_rows(mesh: Mesh, batch_axis: str | None, mb: int):
    """(rows of each microbatch this rank runs, the data group or None)."""
    if batch_axis is None or mesh.shape.get(batch_axis, 1) == 1:
        return slice(None), None
    nd = mesh.shape[batch_axis]
    if mb % nd:
        raise ValueError(f"microbatch {mb} does not divide over the "
                         f"{nd}-way '{batch_axis}' axis")
    k, r = mb // nd, mesh.coord(batch_axis)
    return slice(r * k, (r + 1) * k), mesh.group(batch_axis)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec: dict, x: torch.Tensor, *flat):
        mesh, axis = spec["mesh"], spec["axis"]
        ranks = mesh.axis_ranks(axis)
        n, s = len(ranks), mesh.coord(axis)
        group = mesh.group(axis)
        rows, dgroup = _data_rows(mesh, spec["batch_axis"], x.shape[1])
        lo, hi = spec["bounds"][s]
        own = [t.detach().requires_grad_(t.requires_grad)
               for t in flat[lo:hi]]
        params = dict(zip(spec["names"][s], own))
        xs = x[:, rows]
        kept, outs = [], []
        with torch.enable_grad():
            for t in range(xs.shape[0]):
                if s == 0:
                    u = xs[t].detach()
                else:
                    u = exchange([], [(xs[t], ranks[s - 1])], group)[0]
                u.requires_grad_()
                y = spec["stage_fn"](params, u)
                kept.append((u, y))
                if s < n - 1:
                    exchange([(y, ranks[s + 1])], [], group)
                else:
                    outs.append(y.detach())
        out = torch.stack(outs) if outs else torch.empty_like(xs)
        out = broadcast(out, ranks[-1], group)
        if dgroup is not None:
            out = torch.cat(all_gather(out, dgroup), dim=1)
        ctx.spec, ctx.kept, ctx.own, ctx.rows = spec, kept, own, rows
        ctx.dgroup, ctx.likes = dgroup, [(t.shape, t.dtype) for t in flat]
        ctx.x_like = xs
        return out

    @staticmethod
    def backward(ctx, grad_out):
        spec = ctx.spec
        mesh, axis = spec["mesh"], spec["axis"]
        ranks = mesh.axis_ranks(axis)
        n, s = len(ranks), mesh.coord(axis)
        group = mesh.group(axis)
        g_local = grad_out[:, ctx.rows]
        own_grads = [None] * len(ctx.own)
        gx = [None] * len(ctx.kept)
        for t in reversed(range(len(ctx.kept))):
            u, y = ctx.kept[t]
            if s == n - 1:
                gy = g_local[t]
            else:
                gy = exchange([], [(y, ranks[s + 1])], group)[0]
            if y is u:  # a stage without blocks
                grads = [gy] + [None] * len(ctx.own)
            else:
                grads = torch.autograd.grad(
                    y, [u] + [p for p in ctx.own if p.requires_grad], gy,
                    allow_unused=True)
                it = iter(grads[1:])
                grads = [grads[0]] + [next(it) if p.requires_grad else None
                                      for p in ctx.own]
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    own_grads[i] = g if own_grads[i] is None \
                        else own_grads[i] + g
            if s > 0:
                exchange([(grads[0], ranks[s - 1])], [], group)
            else:
                gx[t] = grads[0]
        ctx.kept = None
        x_like = ctx.x_like
        gx = (torch.stack(gx) if s == 0
              else torch.empty_like(x_like))
        gx = broadcast(gx, ranks[0], group)
        if ctx.dgroup is not None:
            gx = torch.cat(all_gather(gx, ctx.dgroup), dim=1)
        lo, _ = spec["bounds"][s]
        flat = []
        for i, (shape, dtype) in enumerate(ctx.likes):
            j = i - lo
            g = own_grads[j] if 0 <= j < len(own_grads) else None
            flat.append(g if g is not None else torch.zeros(
                shape, dtype=dtype, device=grad_out.device))
        flat = all_reduce_flat(flat, group)
        if ctx.dgroup is not None:
            flat = all_reduce_flat(flat, ctx.dgroup)
        return (None, gx, *flat)


def pipeline_apply(mesh: Mesh, stage_fn: Callable, stage_params: list,
                   x: torch.Tensor, *, axis: str = "pipe",
                   batch_axis: str | None = None) -> torch.Tensor:
    """Apply P sequential stages to M microbatches, pipelined over `axis`.

    stage_fn(params, u) -> v: ONE stage, shape- and dtype-preserving.
    stage_params: P dicts of tensors (stage s's on pipe rank s), every
        rank holding all of them (the reference's replicated storage).
    x: [M, mb, ...] microbatches, the same on every rank. With batch_axis
        (e.g. 'data'), each rank of that axis runs its rows of every
        microbatch (mb must divide over it).

    Returns [M, mb, ...] on every rank: for each microbatch,
    stage_{P-1}(...stage_0(mb)); differentiable in x and in every stage's
    tensors, each rank receiving the whole gradients.
    """
    n = mesh.shape[axis]
    if len(stage_params) != n:
        raise ValueError(
            f"stage_params has {len(stage_params)} stages for a {n}-device"
            f" '{axis}' axis")
    if n == 1:
        return torch.stack([stage_fn(stage_params[0], u) for u in x])
    names, flat, bounds = [], [], []
    for sp in stage_params:
        bounds.append((len(flat), len(flat) + len(sp)))
        names.append(list(sp))
        flat.extend(sp.values())
    spec = {"mesh": mesh, "axis": axis, "batch_axis": batch_axis,
            "stage_fn": stage_fn, "names": names, "bounds": bounds}
    return _Pipeline.apply(spec, x, *flat)


def stage_ranges(num_items: int, n_stages: int) -> list[range]:
    """The items of each stage: [s * slots, min((s + 1) * slots, n))."""
    slots = math.ceil(num_items / n_stages)
    return [range(min(s * slots, num_items),
                  min((s + 1) * slots, num_items)) for s in range(n_stages)]


def split_scan_params(stacked: dict, num_items: int, n_stages: int):
    """Re-slice stacked tensors [num_items, ...] into per-stage groups:
    (blocks with leaves [n_stages, slots, ...], zero-padded past
    num_items; valid [n_stages, slots] bool), the reference's layout."""
    slots = math.ceil(num_items / n_stages)
    pad = n_stages * slots - num_items

    def resplit(leaf):
        if leaf.shape[0] != num_items:
            raise ValueError(
                f"leaf leading axis {leaf.shape[0]} != {num_items}")
        if pad:
            leaf = torch.cat([leaf, leaf.new_zeros((pad,) + leaf.shape[1:])])
        return leaf.reshape((n_stages, slots) + tuple(leaf.shape[1:]))

    blocks = {k: resplit(v) for k, v in stacked.items()}
    valid = (torch.arange(n_stages * slots) < num_items).reshape(
        n_stages, slots)
    return blocks, valid


def _sub(params: dict, prefix: str) -> dict:
    return {k: v for k, v in params.items() if k.startswith(prefix)}


def _indices(sp: dict, prefix: str) -> list[int]:
    """The block indices i of the `prefix.i.` entries of a stage's dict."""
    return sorted({int(k.split(".")[1]) for k in sp if k.startswith(prefix)})


def _rrdb_stages(model, params: dict, n: int):
    """(stage_fn, stage_params) of an RRDBNet's body over n stages, NHWC;
    the RRDBs through kernel 13's op when the model takes it, else the
    plain blocks."""
    from superresolution_tpu_torch.train.fused_apply import (
        rrdb_block,
        supports_fused_train,
    )

    fused = supports_fused_train(model)
    stage_params = [{k: v for i in r for k, v in
                     _sub(params, f"body.{i}.").items()}
                    for r in stage_ranges(model.num_blocks, n)]

    def stage_fn(sp: dict, u: torch.Tensor) -> torch.Tensor:
        for i in _indices(sp, "body."):
            if fused:
                u = rrdb_block(sp, i, u)
            else:
                p = {k[len(f"body.{i}."):]: v
                     for k, v in _sub(sp, f"body.{i}.").items()}
                u = functional_call(model.body[i], p,
                                    (u.permute(0, 3, 1, 2),)
                                    ).permute(0, 2, 3, 1)
        return u

    return stage_fn, stage_params


def make_pipeline_forward(mesh: Mesh, model, n_micro: int, *,
                          axis: str = "pipe") -> Callable:
    """Pipeline-parallel RRDBNet forward: fwd(params, lr) -> pred, params
    the model's name -> tensor dict. The body's RRDBs run pipelined over
    `axis`; conv_first, trunk_conv and the tail run replicated. The
    per-sample math is the plain forward's, so pred and every gradient
    match it (a drop-in apply_fn for train/steps.make_train_step). With
    a data axis of more than one rank and mb % ndata == 0, each
    microbatch is also split over 'data'."""
    from superresolution_tpu_torch.train.fused_apply import (
        rrdb_head,
        rrdb_tail,
    )

    n = mesh.shape[axis]
    ndata = mesh.shape.get("data", 1)
    tail = rrdb_tail(model)

    def fwd(params: dict, lr: torch.Tensor) -> torch.Tensor:
        b = lr.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        head = rrdb_head(model, params, lr)
        stage_fn, stage_params = _rrdb_stages(model, params, n)
        mb = b // n_micro
        micro = head.reshape((n_micro, mb) + tuple(head.shape[1:]))
        batch_axis = "data" if ndata > 1 and mb % ndata == 0 else None
        out = pipeline_apply(mesh, stage_fn, stage_params, micro,
                             axis=axis, batch_axis=batch_axis)
        return tail(params, out.reshape(head.shape), head)

    return fwd


def make_pipeline_loss(mesh: Mesh, model, loss_sum_fn: Callable,
                       n_micro: int, *, axis: str = "pipe") -> Callable:
    """Pipeline-parallel training objective: loss_fn(params, lr, hr) =
    loss_sum_fn(pred, hr) / hr.numel() over make_pipeline_forward, the
    same value on every rank; torch.autograd.grad of it gives every rank
    the whole gradient (loss_sum_fn returns the SUM of per-element
    losses, as make_spatial_loss's does)."""
    fwd = make_pipeline_forward(mesh, model, n_micro, axis=axis)

    def loss_fn(params, lr, hr):
        return loss_sum_fn(fwd(params, lr), hr) / hr.numel()

    return loss_fn


def make_hat_group_pipeline(mesh: Mesh, model, params: dict, *,
                            axis: str = "pipe") -> Callable:
    """Pipeline a HATLite's residual groups over `axis`: -> fn(x
    [M, mb, H, W, C]) -> [M, mb, H, W, C], equal to running every group
    in turn (the embed conv, body norm and upsampler stay outside).
    Groups must be uniform (one depth and head count), as there."""
    n = mesh.shape[axis]
    n_groups = len(model.depths)
    if len(set(model.depths)) != 1 or len(set(model.num_heads)) != 1:
        raise ValueError("group pipeline requires uniform groups")
    ranges = stage_ranges(n_groups, n)
    stage_params = [{k: v for g in r for k, v in
                     _sub(params, f"layers.{g}.").items()} for r in ranges]

    def stage_fn(sp: dict, u: torch.Tensor) -> torch.Tensor:
        for g in _indices(sp, "layers."):
            p = {k[len(f"layers.{g}."):]: v
                 for k, v in _sub(sp, f"layers.{g}.").items()}
            u = functional_call(model.layers[g], p, (u,))
        return u

    def apply(x_microbatches: torch.Tensor) -> torch.Tensor:
        return pipeline_apply(mesh, stage_fn, stage_params, x_microbatches,
                              axis=axis)

    return apply


def make_trunk_pipeline(mesh: Mesh, model, params: dict, *,
                        axis: str = "pipe", dtype=None) -> Callable:
    """Pipeline an RRDBNet's body over `axis`: -> fn(x [M, mb, H, W, C])
    -> [M, mb, H, W, C], equal to running every RRDB in turn (conv_first,
    trunk_conv and the tail stay outside). params: the model's state
    dict, cast to `dtype` if given."""
    n = mesh.shape[axis]
    body = {k: (v.to(dtype) if dtype is not None else v)
            for k, v in params.items() if k.startswith("body.")}
    stage_fn, stage_params = _rrdb_stages(model, body, n)

    def apply(x_microbatches: torch.Tensor) -> torch.Tensor:
        return pipeline_apply(mesh, stage_fn, stage_params, x_microbatches,
                              axis=axis)

    return apply
