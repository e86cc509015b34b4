"""The device mesh over torch.distributed ranks, and its collectives.

Counterpart of superresolution_tpu/parallel/mesh.py. The reference runs
one SPMD program over a jax.sharding.Mesh inside one process; the port
runs one process per device (NCCL on the GPU, gloo on the CPU), started
by torchrun or torch.multiprocessing (parallel/launch.py), and the Mesh
is the ranks' layout: the named axis sizes, 'data' x 'spatial' or
'data' x 'pipe' as the reference's create_mesh makes them, rank
d * n_second + s at coordinate (d, s), and one process group per axis
through this rank. Without an initialized process group the world is
one process. The backend is the one the caller initialized the process
group with; nothing here picks another.

The collectives take a group of None as "this axis has one rank" (they
return their input). A CUDA tensor on a gloo group crosses through host
memory (gloo's send/recv and all_gather take CPU tensors only; the
compute stays on the card); NCCL moves CUDA tensors directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from superresolution_tpu_torch.utils.config import MeshConfig


@dataclass
class Mesh:
    """A 2-D layout of the world's ranks: axis_names[0] is 'data', the
    second 'spatial' or 'pipe'. Ranks at or past `size` lie outside the
    mesh (coords None), as the reference leaves devices past data *
    second unused."""

    axis_names: tuple[str, str]
    sizes: tuple[int, int]
    rank: int = 0
    groups: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return self.sizes[0] * self.sizes[1]

    @property
    def coords(self) -> dict[str, int] | None:
        if self.rank >= self.size:
            return None
        return dict(zip(self.axis_names, divmod(self.rank, self.sizes[1])))

    def coord(self, axis: str) -> int:
        c = self.coords
        if c is None:
            raise ValueError(f"rank {self.rank} lies outside the mesh "
                             f"{self.sizes[0]}x{self.sizes[1]}")
        return c[axis]

    def axis_ranks(self, axis: str, rank: int | None = None) -> list[int]:
        """The world ranks along `axis` through `rank` (default this one),
        in coordinate order."""
        d, s = divmod(self.rank if rank is None else rank, self.sizes[1])
        if axis == self.axis_names[0]:
            return [i * self.sizes[1] + s for i in range(self.sizes[0])]
        return [d * self.sizes[1] + j for j in range(self.sizes[1])]

    def group(self, axis: str):
        """The process group along `axis` through this rank, or None when
        the axis has one rank (or there is no process group)."""
        return self.groups.get(axis)


def _axis_groups(axis_names, sizes, rank: int, world: int) -> dict:
    """One process group per axis through `rank`. Every rank creates every
    group of more than one rank, in the same order (dist.new_group is
    collective over the world); a group that is the whole world is the
    world's own."""
    groups = {}
    if not dist.is_initialized():
        return groups
    probe = Mesh(tuple(axis_names), tuple(sizes), rank)
    for axis in axis_names:
        seen = []
        for r in range(probe.size):
            ranks = probe.axis_ranks(axis, r)
            if len(ranks) < 2 or ranks in seen:
                continue
            seen.append(ranks)
            g = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
            if rank in ranks:
                groups[axis] = g
    return groups


def create_mesh(config: MeshConfig | None = None) -> Mesh:
    """The mesh of config over this process group's world (one process
    when none is initialized), with the reference's validation: pipe and
    spatial are exclusive, and a mesh needs at most the world's ranks."""
    cfg = config or MeshConfig()
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    spatial = max(1, cfg.spatial)
    pipe = max(1, getattr(cfg, "pipe", 1))
    if pipe > 1:
        if spatial > 1:
            raise ValueError("mesh.pipe and mesh.spatial are exclusive")
        data = cfg.data if cfg.data > 0 else n // pipe
        if data < 1 or data * pipe > n:
            raise ValueError(
                f"mesh {max(data, 1)}x{pipe} needs"
                f" {max(data, 1) * pipe} devices, have {n}")
        names, sizes = ("data", "pipe"), (data, pipe)
    else:
        data = cfg.data if cfg.data > 0 else n // spatial
        if data < 1 or data * spatial > n:
            raise ValueError(
                f"mesh {max(data, 1)}x{spatial} needs"
                f" {max(data, 1) * spatial} devices, have {n}")
        names, sizes = ("data", "spatial"), (data, spatial)
    return Mesh(names, sizes, rank, _axis_groups(names, sizes, rank, n))


def batch_sharding(mesh: Mesh):
    """-> shard(x): this rank's rows of x's leading (batch) axis along
    'data' (the reference's NamedSharding(mesh, P('data')))."""
    n = mesh.shape["data"]

    def shard(x):
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide over the "
                             f"{n}-way data axis")
        k = x.shape[0] // n
        r = mesh.coord("data")
        return x[r * k:(r + 1) * k]

    return shard


def replicated_sharding(mesh: Mesh):
    """-> the identity: every rank holds the whole array (P())."""
    return lambda x: x


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every array of a batch dict (or of one array)
    along 'data'."""
    s = batch_sharding(mesh)
    if isinstance(batch, dict):
        return {k: s(v) for k, v in batch.items()}
    return s(batch)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """t as it crosses a gloo group from the card: on the host, bf16 as
    f32 (exactly; gloo's reductions have no bf16)."""
    if not host:
        return t
    t = t.cpu()
    return t.float() if t.dtype == torch.bfloat16 else t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks (a new tensor; t unchanged)."""
    return all_reduce_flat([t], group)[0]


def all_reduce_flat(tensors: list, group) -> list:
    """all_reduce_sum of each tensor, as one flat collective per dtype."""
    if group is None:
        return list(tensors)
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        host = _via_host(flat, group)
        buf = _wire(flat, host)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        flat = buf.to(flat.device, flat.dtype) if host else buf
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def all_gather(t: torch.Tensor, group) -> list:
    """The group's ranks' t (same shape on every rank), in rank order."""
    if group is None:
        return [t]
    src = t.detach().contiguous()
    host = _via_host(src, group)
    src = _wire(src, host)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device, t.dtype) for p in parts] if host else parts


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """The group's rank `src`'s t (a world rank) on every rank of it."""
    if group is None:
        return t
    buf = t.detach().contiguous().clone()
    host = _via_host(buf, group)
    buf = _wire(buf, host)
    dist.broadcast(buf, src=src, group=group)
    return buf.to(t.device, t.dtype) if host else buf


def exchange(sends: list, recvs: list, group) -> list:
    """Point-to-point transfers in one batch: sends is [(tensor, world
    rank)], recvs [(shape/like tensor, world rank)]; returns the received
    tensors, in recvs' order, on the device of their like tensors."""
    host = any(_via_host(t, group) for t, _ in sends + recvs)
    ops, bufs = [], []
    for like, peer in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else like.device)
        buf = _wire(buf, host)
        bufs.append((buf, like))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, _wire(t.detach().contiguous(),
                                                 host), peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(like.device, like.dtype) if host else b
            for b, like in bufs]


class SumGradOver(torch.autograd.Function):
    """Identity on the tensors forward; their gradients summed over the
    group backward. A replicated parameter that each rank uses on its own
    share of the work gets the whole gradient on every rank this way (the
    transpose of the reference's replicated in_spec under shard_map)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        full = [g if g is not None else torch.zeros(s, dtype=d, device=v)
                for g, (s, d, v) in zip(grads, ctx.likes)]
        return (None, *all_reduce_flat(full, ctx.group))


def sum_grad_over(params: dict, group) -> dict:
    """params with SumGradOver applied (the dict unchanged for None)."""
    if group is None:
        return params
    names = list(params)
    return dict(zip(names, SumGradOver.apply(group, *params.values())))
