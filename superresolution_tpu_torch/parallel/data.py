"""Data parallelism for the port's train and eval steps.

Counterpart of the reference's batch sharding inside its jitted steps
(train/steps.py under a 'data' mesh, train/fused_apply.py:151
make_fused_train_apply_dp): there GSPMD splits each micro-batch over
'data' and inserts the gradient all-reduce. Here every rank of the data
axis holds the whole global batch (so the input stage's per-image draws
are the single-device run's), takes its share of each micro-batch, and
the step sums the ranks' weighted gradients and logs with one
all-reduce. The step is then the single-device step:

  * a micro-batch of m rows that divides over the n data ranks is split
    in n contiguous blocks, each rank's loss weighted 1/n (every loss
    term is a mean over equal-sized blocks);
  * one that does not divide runs whole on every rank, weighted 1/n
    too (the reference's replicated layout for such a batch);
  * a term that couples the batch's samples (the relativistic GAN
    losses' mean logits) sees the whole micro-batch's logits: `gather`
    returns them with this rank's block live, and the term is not
    weighted (its gradient is already a share of the whole).
"""

from __future__ import annotations

import torch

from superresolution_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce_flat,
    batch_sharding,
    replicated_sharding,
)


class DataSplit:
    """This rank's share of an m-row micro-batch on the mesh's data
    axis (the whole micro-batch, weight 1, without a mesh): take(x) is
    the mesh's batch_sharding where m divides over the data ranks, else
    its replicated_sharding."""

    def __init__(self, mesh: Mesh | None, m: int):
        n = mesh.shape["data"] if mesh is not None else 1
        self.group = mesh.group("data") if mesh is not None else None
        self.sharded = n > 1 and m % n == 0
        self.rank = mesh.coord("data") if self.sharded else 0
        self.take = (batch_sharding(mesh) if self.sharded
                     else replicated_sharding(mesh))
        self.weight = 1.0 / n

    def gather(self, local: torch.Tensor) -> tuple[torch.Tensor, float]:
        """(the micro-batch's [m, ...] from every rank's block, this
        rank's block live; the weight of a term computed on it)."""
        if not self.sharded:
            return local, self.weight
        parts = all_gather(local, self.group)
        parts[self.rank] = local
        return torch.cat(parts), 1.0

    def reduce(self, tree: dict) -> dict:
        """The sum over the data ranks of each tensor of a dict."""
        names = list(tree)
        return dict(zip(names, all_reduce_flat(list(tree.values()),
                                               self.group)))
